"""whisper-tiny [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    source="arXiv:2212.04356 (Whisper); tiny: 4L d=384 6H d_ff=1536 vocab=51865",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    mlp_kind="gelu",
    norm_kind="layernorm",
    pos_kind="learned",
    qkv_bias=True,
    is_encoder_decoder=True,
    encoder_layers=4,
    encoder_frames=1500,          # 30 s audio -> 1500 frames after conv stub
    frontend="audio",
    max_position=448,
    layer_kinds=("attn",),
)
