"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B family, 110B dims]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    arch_type="dense",
    source="hf:Qwen/Qwen1.5 family; 110B: 80L d=8192 64H kv=8 d_ff=49152 vocab=152064",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49_152,
    vocab_size=152_064,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    pos_kind="rope",
    rope_theta=1_000_000.0,
    qkv_bias=True,
    layer_kinds=("attn",),
    max_position=32_768,
)
