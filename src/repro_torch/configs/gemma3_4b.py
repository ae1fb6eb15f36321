"""gemma3-4b [dense] — 5:1 local:global attention, 128k [hf:google/gemma-3 family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    source="hf:google/gemma-3 family; 4B: 34L d=2560 8H kv=4 d_ff=10240 vocab=262144",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10_240,
    vocab_size=262_144,
    mlp_kind="geglu",
    norm_kind="rmsnorm",
    pos_kind="rope",
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,      # gemma3: local layers keep the 10k base
    qk_norm=True,
    tie_embeddings=True,
    # 5 sliding-window layers then 1 global, repeated:
    layer_kinds=(
        "attn_local", "attn_local", "attn_local", "attn_local", "attn_local",
        "attn",
    ),
    sliding_window=1024,
    max_position=131_072,
)
