"""Shared layer library: rmsnorm and layernorm, RoPE, the MLPs (gated
swiglu and geglu, plain gelu), embeddings with learned positions, the
next-token cross-entropy.

Plain functions on tensors with the arithmetic of ``repro.models.layers``:
norms and RoPE compute in float32 and cast back to the input dtype;
products run in the parameters' dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec, at_least_f32
from repro_torch.models.sharding import active_rules, global_offset, shard

# ---------------------------------------------------------------- norms


def norm_schema(cfg: ModelConfig):
    d = cfg.d_model
    if cfg.norm_kind == "layernorm":
        return {"scale": ParamSpec((d,), ("d_model",), init="ones"),
                "bias": ParamSpec((d,), ("d_model",), init="zeros")}
    if cfg.norm_kind != "rmsnorm":
        raise ValueError(f"norm_kind {cfg.norm_kind!r} is not ported yet")
    return {"scale": ParamSpec((d,), ("d_model",), init="ones")}


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
MLP_KINDS = GATED_MLPS + ("gelu",)


def mlp_schema(cfg: ModelConfig):
    if cfg.mlp_kind not in MLP_KINDS:
        raise ValueError(f"mlp_kind {cfg.mlp_kind!r} is not ported yet")
    d, f = cfg.d_model, cfg.d_ff
    s = {
        "up": ParamSpec((d, f), ("d_model", "d_ff"), scale_dim=-2),
        "down": ParamSpec((f, d), ("d_ff", "d_model"), scale_dim=-2),
    }
    if cfg.mlp_kind in GATED_MLPS:
        s["gate"] = ParamSpec((d, f), ("d_model", "d_ff"), scale_dim=-2)
    return s


def mlp_apply(p, x, kind: str):
    """Gated MLP: act(x @ gate) * (x @ up) @ down, act = silu (swiglu) or
    gelu (geglu); plain (gelu, whisper's): gelu(x @ up) @ down.  gelu
    takes its tanh form, as ``jax.nn.gelu``'s default
    (``approximate=True``) in the reference; the erf form moves logits by
    ~1e-3."""
    if kind not in MLP_KINDS:
        raise ValueError(f"mlp_kind {kind!r} is not ported yet")
    up = shard(x @ p["up"], "batch", "seq", "d_ff")
    if kind == "gelu":
        h = F.gelu(up, approximate="tanh")
    else:
        g = x @ p["gate"]
        g = F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * up
    return shard(h @ p["down"], "batch", "seq", "d_model")


# ---------------------------------------------------------------- embeddings


def embed_schema(cfg: ModelConfig):
    # "embed_d" (not "d_model"): the embeddings stay vocab-sharded only,
    # as in the reference
    s = {"tokens": ParamSpec((cfg.vocab_size, cfg.d_model),
                             ("vocab", "embed_d"), init="embed")}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed_d", "vocab"), scale_dim=-2)
    if cfg.pos_kind == "learned":
        s["positions"] = ParamSpec((cfg.max_position, cfg.d_model),
                                   (None, "embed_d"),
                                   init="embed")
    return s


def embed_apply(p, cfg: ModelConfig, tokens, positions=None):
    """Token rows; with learned positions (``cfg.pos_kind == "learned"``)
    plus the rows of ``positions`` (broadcast against tokens' (B,S); the
    caller clips them below ``max_position``), cast to the tokens'
    dtype."""
    x = _rows(p["tokens"], tokens)
    if cfg.pos_kind == "learned":
        if positions is None:
            raise ValueError("learned positions need their positions")
        x = x + _rows(p["positions"], positions).to(x.dtype)
    return shard(x, "batch", "seq", "d_model")


def _rows(table, idx):
    """``table[idx]``.  Under sharding rules an embedding lookup, whose
    sharding strategy keeps a split vocabulary split and makes the
    table's gradient a pending sum over the batch's devices."""
    if active_rules() is None:
        return table[idx.long()]
    return F.embedding(idx.long(), table)


def unembed_apply(p, cfg: ModelConfig, x):
    w = p["tokens"].T if cfg.tie_embeddings else p["unembed"]
    return shard(x @ w, "batch", "seq", "vocab")


# ---------------------------------------------------------------- loss


def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross-entropy in float32, as logsumexp minus the
    gold logit.  labels: int (B,S); ``mask`` (B,S) weights each position
    (the mean over ``max(sum(mask), 1)``)."""
    logits = at_least_f32(logits)
    nll = _logsumexp(logits) - _gold_logit(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _logsumexp(logits):
    """logsumexp over the last axis.  Under sharding rules it is written
    as max, then sum of exp (each a partial result the devices reduce),
    so a split vocabulary is never gathered."""
    if active_rules() is None:
        return torch.logsumexp(logits, dim=-1)
    rows = ("batch", "seq", None)
    m = shard(torch.amax(logits, dim=-1, keepdim=True), *rows).detach()
    z = shard(torch.sum(torch.exp(logits - m), dim=-1, keepdim=True), *rows)
    return (m + torch.log(z))[..., 0]


def _gold_logit(logits, labels):
    """logits (B,S,V) at ``labels`` (B,S).  Under sharding rules with the
    vocabulary split, each device picks the labels inside its slice (0
    elsewhere) and the pieces sum, as XLA's sharded gather does."""
    if active_rules() is None:
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    vocab = Shard(logits.dim() - 1)
    if not isinstance(logits, DTensor) or vocab not in logits.placements:
        return torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    off = global_offset(logits, logits.dim() - 1)

    def pick(lo, la):
        n = lo.shape[-1]
        idx = la.long() - off
        ok = (idx >= 0) & (idx < n)
        g = torch.gather(lo, -1, torch.clamp(idx, 0, n - 1)[..., None])
        return torch.where(ok, g[..., 0], 0.0)

    pl = logits.placements
    return shard(local_map(
        pick, out_placements=([Partial() if p == vocab else p for p in pl],),
        in_placements=(pl, [Replicate() if p == vocab else p for p in pl]),
        device_mesh=logits.device_mesh, redistribute_inputs=True)(
            logits, labels), "batch", "seq")
