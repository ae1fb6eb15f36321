"""Shared layer library: rmsnorm and layernorm, RoPE, the gated MLPs
(swiglu, geglu), embeddings, the next-token cross-entropy.

Plain functions on tensors with the arithmetic of ``repro.models.layers``:
norms and RoPE compute in float32 and cast back to the input dtype;
products run in the parameters' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec, at_least_f32

# ---------------------------------------------------------------- norms


def norm_schema(cfg: ModelConfig):
    d = cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {"scale": ParamSpec((d,), init="ones"),
                "bias": ParamSpec((d,), init="zeros")}
    if cfg.norm_kind != "rmsnorm":
        raise ValueError(f"norm_kind {cfg.norm_kind!r} is not ported yet")
    return {"scale": ParamSpec((d,), init="ones")}


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = at_least_f32(x)
    ms = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * at_least_f32(scale)).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    x32 = at_least_f32(x)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * at_least_f32(scale) + at_least_f32(bias)).to(x.dtype)


def norm_apply(p, x, kind: str, eps: float = 1e-6):
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"], eps)
    if kind != "rmsnorm":
        raise ValueError(f"norm_kind {kind!r} is not ported yet")
    return rms_norm(x, p["scale"], eps)


# ---------------------------------------------------------------- RoPE


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (...,) int -> (..., head_dim/2) float32 angles."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    return positions.float()[..., None] * freqs


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    ang = rope_angles(positions, x.shape[-1], theta)   # (B?, S, hd/2)
    cos = torch.cos(ang)[..., None, :]                  # (B?, S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(at_least_f32(x), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------- MLP


GATED_MLPS = ("swiglu", "geglu")


def mlp_schema(cfg: ModelConfig):
    if cfg.mlp_kind not in GATED_MLPS:
        raise ValueError(f"mlp_kind {cfg.mlp_kind!r} is not ported yet")
    d, f = cfg.d_model, cfg.d_ff
    return {
        "up": ParamSpec((d, f), scale_dim=-2),
        "down": ParamSpec((f, d), scale_dim=-2),
        "gate": ParamSpec((d, f), scale_dim=-2),
    }


def mlp_apply(p, x, kind: str):
    """Gated MLP: act(x @ gate) * (x @ up) @ down, act = silu (swiglu) or
    gelu (geglu).  geglu takes gelu's tanh form, as ``jax.nn.gelu``'s
    default (``approximate=True``) in the reference; the erf form moves
    logits by ~1e-3."""
    if kind not in GATED_MLPS:
        raise ValueError(f"mlp_kind {kind!r} is not ported yet")
    g = x @ p["gate"]
    g = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
    return (g * (x @ p["up"])) @ p["down"]


# ---------------------------------------------------------------- embeddings


def embed_schema(cfg: ModelConfig):
    if cfg.pos_kind == "learned":
        raise ValueError("learned positions are not ported yet")
    s = {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model), init="embed")}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size), scale_dim=-2)
    return s


def embed_apply(p, tokens):
    return p["tokens"][tokens.long()]


def unembed_apply(p, cfg: ModelConfig, x):
    if cfg.tie_embeddings:
        return x @ p["tokens"].T
    return x @ p["unembed"]


# ---------------------------------------------------------------- loss


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross-entropy in float32, as logsumexp minus the
    gold logit.  labels: int (B,S); ``mask`` (B,S) weights each position
    (the mean over ``max(sum(mask), 1)``)."""
    logits = at_least_f32(logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
