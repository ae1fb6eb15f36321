"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    arch_type="dense",
    source="arXiv:2412.08905 (Phi-4); mini: 32L d=3072 24H kv=8 d_ff=8192 vocab=200064",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    pos_kind="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    layer_kinds=("attn",),
    max_position=131_072,
)
