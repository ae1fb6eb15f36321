"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    source="hf:databricks/dbrx-base: 40L d=6144 48H kv=8 d_ff=10752 vocab=100352, 16e top-4",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10_752,
    vocab_size=100_352,
    mlp_kind="swiglu",
    norm_kind="layernorm",
    pos_kind="rope",
    rope_theta=500_000.0,
    num_experts=16,
    num_experts_per_tok=4,
    moe_every=1,
    layer_kinds=("attn",),
    max_position=32_768,
)
