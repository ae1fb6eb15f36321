"""Mixture-of-Experts MLP: top-k router and capacity-slot dispatch.

The port of ``repro.models.moe``.  Per dispatch row, each of the S tokens
picks its top-k experts; the (S*k) (token, expert) pairs are numbered
within each expert in flattened (token, rank) order by a one-hot cumsum,
and a pair whose number reaches the expert's capacity is dropped (its
combine weight is 0), exactly as Switch/GShard with a capacity factor.
Capacity is computed from the row's padded length S, so a ragged
dispatch padded to a bucket drops what the reference drops at that
bucket.  Padding lanes sit after every valid lane in that order and can
never take a valid token's place.

Casts follow the reference: the router product, softmax, top-k and the
gates' renormalisation run in float32 (the router weights are float32
whatever the model dtype); the gates are rounded to the activation dtype
for the combine; the experts compute in the model dtype.  The expert
products are ``torch.einsum`` over the (B, E, C) slot tensor, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec, at_least_f32
from repro_torch.models.sharding import local, shard

EXPERT_KINDS = ("swiglu", "geglu", "gelu")


def moe_schema(cfg: ModelConfig):
    if cfg.mlp_kind not in EXPERT_KINDS:
        raise ValueError(f"mlp_kind {cfg.mlp_kind!r} is not an expert kind "
                         f"({EXPERT_KINDS})")
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {
        "router": ParamSpec((d, e), ("d_model", "experts"), scale_dim=-2,
                            dtype="float32"),
        "up": ParamSpec((e, d, f), ("experts", "d_model", "expert_ff"),
                        scale_dim=-2),
        "down": ParamSpec((e, f, d), ("experts", "expert_ff", "d_model"),
                          scale_dim=-2),
    }
    if cfg.mlp_kind in ("swiglu", "geglu"):
        s["gate"] = ParamSpec((e, d, f),
                              ("experts", "d_model", "expert_ff"),
                              scale_dim=-2)
    return s


def capacity_for(cfg: ModelConfig, seq: int) -> int:
    ideal = seq * cfg.num_experts_per_tok / cfg.num_experts
    cap = int(ideal * cfg.moe_capacity_factor) + 1
    return min(max(cap, cfg.num_experts_per_tok), seq)


def _experts(p, kind: str, xe):
    """xe (B,E,C,D) -> (B,E,C,D) through each expert's MLP; gelu takes
    the tanh form, as ``jax.nn.gelu``'s default."""
    up = torch.einsum("becd,edf->becf", xe, p["up"])
    if kind == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", xe, p["gate"])) * up
    elif kind == "geglu":
        h = F.gelu(torch.einsum("becd,edf->becf", xe, p["gate"]),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.einsum("becf,efd->becd", h, p["down"])


def route(p, cfg: ModelConfig, x):
    """The router, in float32: x (B,S,D) -> (probs (B,S,E), gates
    (B,S,K) renormalised over the top k, expert ids (B,S,K))."""
    logits = at_least_f32(x) @ at_least_f32(p["router"])      # (B,S,E)
    # each token's top k over every expert's logit, on each device's
    # tokens under sharding
    tokens = ("batch", "seq", None)
    return local(functools.partial(_top_k, k=cfg.num_experts_per_tok),
                 (tokens,), (tokens,) * 3)(logits)


def _top_k(logits, *, k: int):
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _dispatch(expert_idx, *, e: int, cap: int):
    """expert ids (B,S,K) -> (slot table (B, E*cap) of source tokens,
    its valid mask, each (token, rank) pair's slot (B, S*K), whether the
    pair is kept (B, S*K)).  Pairs are numbered within each expert in the
    row's flattened (S*K) order by a one-hot cumsum; a pair whose number
    reaches ``cap`` is dropped."""
    b, s, k = expert_idx.shape
    flat_e = expert_idx.reshape(b, s * k)
    oh = F.one_hot(flat_e, e)                                 # (B,S*K,E)
    pos_in_e = (torch.cumsum(oh, dim=1) * oh).sum(-1) - 1
    keep = pos_in_e < cap
    slot_flat = flat_e * cap + torch.where(keep, pos_in_e, 0)

    # slot table (expert, slot) -> source token; dropped pairs write the
    # spare last column, cut off after (empty slots read token 0 with
    # combine weight 0)
    device = expert_idx.device
    token_of_pair = (torch.arange(s * k, device=device) // k).expand(b, -1)
    dest = torch.where(keep, slot_flat, e * cap)
    table = torch.zeros(b, e * cap + 1, dtype=torch.long, device=device)
    table.scatter_(1, dest, token_of_pair)
    valid = torch.zeros(b, e * cap + 1, dtype=torch.bool, device=device)
    valid.scatter_(1, dest, True)
    return table[:, :e * cap], valid[:, :e * cap], slot_flat, keep


def moe_apply(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (y (B,S,D), Switch load-balance loss, a float32
    scalar)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity_for(cfg, s)
    probs, gate_vals, expert_idx = route(p, cfg, x)

    # Switch aux loss: E * sum_e(fraction routed top-1 to e * mean prob e)
    frac = F.one_hot(expert_idx[..., 0], e).to(probs.dtype).mean(
        dim=(0, 1))
    aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))

    # each row's dispatch tables, on each device's rows under sharding
    rows = ("batch", None)
    table, valid, slot_flat, keep = local(
        functools.partial(_dispatch, e=e, cap=cap), (("batch", None, None),),
        (rows,) * 4)(expert_idx)

    xe = torch.gather(x, 1, table[..., None].expand(b, e * cap, d))
    xe = (xe * valid[..., None].to(xe.dtype)).reshape(b, e, cap, d)
    xe = shard(xe, "batch", "experts", None, "d_model")
    ye = shard(_experts(p, cfg.mlp_kind, xe),
               "batch", "experts", None, "d_model").reshape(b, e * cap, d)

    # combine: each pair's expert output, weighted by its gate
    gate_flat = (gate_vals.reshape(b, s * k) * keep).to(ye.dtype)
    contrib = torch.gather(ye, 1, slot_flat[..., None].expand(b, s * k, d))
    contrib = contrib * gate_flat[..., None]
    return shard(contrib.reshape(b, s, k, d).sum(dim=2),
                 "batch", "seq", "d_model"), aux
