"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family, 0.6B dims]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    arch_type="dense",
    source="hf:Qwen/Qwen3 family; 0.6B: 28L d=1024 16H kv=8 d_ff=3072 vocab=151936",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,                 # qwen3 decouples head_dim from d_model/H
    d_ff=3072,
    vocab_size=151_936,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    pos_kind="rope",
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    layer_kinds=("attn",),
    max_position=40_960,
)
