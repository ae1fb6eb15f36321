"""Modality-frontend stubs, the port of ``repro.models.frontend``.

whisper-tiny (``frontend="audio"``) and paligemma-3b (``"vision"``)
specify the transformer only: the mel-spectrogram with its convolutions
and the SigLIP vision tower are not built.  The model takes their output
instead, as ``batch["embeds"]`` (B, N, W): N = ``frontend_tokens(cfg)``
rows of width W = ``embed_dim(cfg)``.  Audio frames are already at the
encoder's width; vision patches go through the learned projector (1152,
d_model), which belongs to the language model's parameters.

``fake_embeds`` draws stand-in embeddings from a ``torch.Generator``:
the reference draws them with ``jax.random``, whose numbers the port
does not reproduce, so tests that compare the two packages feed both the
same numpy embeddings.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec, torch_dtype

# SigLIP-so400m patch-embedding width (PaliGemma's tower output).
VISION_WIDTH = 1152


def frontend_schema(cfg: ModelConfig):
    if cfg.frontend == "vision":
        return {"projector": ParamSpec((VISION_WIDTH, cfg.d_model),
                                       (None, "d_model"), scale_dim=-2)}
    return {}


def embed_dim(cfg: ModelConfig) -> int:
    """Width of the stubbed frontend output fed to the model."""
    if cfg.frontend == "vision":
        return VISION_WIDTH
    return cfg.d_model          # audio stub: already at encoder width


def frontend_tokens(cfg: ModelConfig) -> int:
    if cfg.frontend == "vision":
        return cfg.num_prefix_tokens
    if cfg.frontend == "audio":
        return cfg.encoder_frames
    return 0


def fake_embeds(cfg: ModelConfig, batch: int, dtype, seed: int = 0,
                device="cuda"):
    """Standard-normal (batch, frontend_tokens, embed_dim) embeddings in
    ``dtype`` (a torch dtype or a config name), drawn on ``device`` from a
    generator seeded with ``seed``."""
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    shape = (batch, frontend_tokens(cfg), embed_dim(cfg))
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


def project(params, cfg: ModelConfig, embeds):
    """Map stubbed frontend embeddings into model space: vision patches
    through the projector, in the wider of the two dtypes (as jnp.einsum
    promotes), audio frames as they are."""
    if cfg.frontend == "vision":
        w = params["projector"]
        dt = torch.promote_types(embeds.dtype, w.dtype)
        return torch.einsum("bnv,vd->bnd", embeds.to(dt), w.to(dt))
    return embeds
