"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7, MoE 16e top-2 [arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    source=(
        "arXiv:2403.19887 (Jamba) / Jamba-1.5-Large: 72L d=8192 64H kv=8 "
        "d_ff=24576 vocab=65536, MoE 16e top-2, attn:mamba 1:7, MoE every 2"
    ),
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    mlp_kind="swiglu",
    norm_kind="rmsnorm",
    pos_kind="none",              # jamba: no explicit positional encoding
    # 1 attention layer per 8 (index 4 of each period, as in the paper):
    layer_kinds=(
        "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
    ),
    num_experts=16,
    num_experts_per_tok=2,
    moe_every=2,
    moe_offset=1,
    ssm_state_dim=16,
    ssm_conv_width=4,
    ssm_expand=2,
    max_position=262_144,
)
