"""paligemma-3b [vlm] — SigLIP stub + gemma decoder, MQA [arXiv:2407.07726]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    source="arXiv:2407.07726 (PaliGemma); LM: 18L d=2048 8H kv=1 d_ff=16384 vocab=257216",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,               # MQA
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    pos_kind="rope",
    tie_embeddings=True,
    frontend="vision",
    num_prefix_tokens=256,        # 224px/14 SigLIP patches, projected
    layer_kinds=("attn",),
    max_position=8192,
)
