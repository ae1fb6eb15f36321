"""grok-1-314b [moe] — 8 experts top-2 [hf:xai-org/grok-1]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    source="hf:xai-org/grok-1: 64L d=6144 48H kv=8 d_ff=32768 vocab=131072, 8e top-2",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    mlp_kind="geglu",             # grok MoE MLPs are gated (3-matrix GeGLU)
    norm_kind="rmsnorm",
    pos_kind="rope",
    num_experts=8,
    num_experts_per_tok=2,
    moe_every=1,
    layer_kinds=("attn",),
    max_position=8192,
)
