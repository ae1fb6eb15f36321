"""rwkv6-1.6b (Finch) [ssm] — attn-free, data-dependent decay [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    arch_type="ssm",
    source="arXiv:2404.05892 (RWKV-6 Finch); 1.6B: 24L d=2048 d_ff=7168 vocab=65536",
    num_layers=24,
    d_model=2048,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    d_ff=7168,
    vocab_size=65_536,
    mlp_kind="gelu",              # rwkv channel-mix (squared relu in paper; gelu-class)
    norm_kind="layernorm",
    pos_kind="none",
    layer_kinds=("rwkv6",),
    rwkv_head_dim=64,
    max_position=1_048_576,       # recurrence: unbounded context
)
