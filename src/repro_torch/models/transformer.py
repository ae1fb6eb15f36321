"""Layer blocks and period-stacked stacks: the cacheless forward
(``stack_apply``, what the speculative draft runs), the slot path
(whole-prompt prefill, one-token decode against slot caches) and the
paged path.

Parameters, pools and caches keep the reference's layout
(``repro.models.transformer``): ``{"periods": {"slot{j}": leaves with a
leading n_periods axis}, "rem": {"layer{j}": leaves}}`` with
``P = lcm(len(layer_kinds), moe_every)`` slots per period.  Where the
reference scans over the period axis, the port runs a Python loop and
indexes that axis; indexing gives views, so a pool written in place by
layer i is the stacked pool's slice i.

Ported so far: layer kinds ``"attn"`` and ``"attn_local"`` (dense MLP;
the local kind masks to ``cfg.sliding_window`` and takes the local RoPE
base) on every path, and ``"rwkv6"`` (time-mix + channel-mix, recurrent
state as the cache) on the slot path and in the cacheless forward.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (mlp_apply, mlp_schema, norm_apply,
                                       norm_schema)
from repro_torch.models.module import stack_specs

# ------------------------------------------------------------------ periods


def period_len(cfg: ModelConfig) -> int:
    k = len(cfg.layer_kinds)
    m = cfg.moe_every if cfg.num_experts else 1
    return math.lcm(k, m)


def layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """-> (P, n_periods, n_rem)."""
    p = period_len(cfg)
    return p, cfg.num_layers // p, cfg.num_layers % p


def slot_sig(cfg: ModelConfig, j: int) -> Tuple[str, bool]:
    """(kind, is_moe) for in-period slot j (== for absolute layer j)."""
    kind = cfg.layer_kinds[j % len(cfg.layer_kinds)]
    return kind, cfg.layer_is_moe(j)


PORTED_KINDS = ("attn", "attn_local", "rwkv6")


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless every layer is a dense ``"attn"``, ``"attn_local"``
    or ``"rwkv6"`` layer."""
    for i in range(cfg.num_layers):
        kind, moe = slot_sig(cfg, i)
        if kind not in PORTED_KINDS or moe:
            raise ValueError(f"{cfg.name}: layer {i} is {kind!r}"
                             f"{' (MoE)' if moe else ''}; repro_torch ports "
                             "dense 'attn', 'attn_local' and 'rwkv6' layers "
                             "only so far")


def layer_kinds(cfg: ModelConfig) -> list:
    """Each layer's kind, in stack order (that of ``layer_views``)."""
    return [slot_sig(cfg, i)[0] for i in range(cfg.num_layers)]


def layer_views(cfg: ModelConfig, tree) -> list:
    """Per-layer nodes of a tree in the stack layout (parameters, pools
    or caches), in stack order: period slots indexed on their leading
    axis (views), then the remainder layers."""
    p, n_per, n_rem = layout(cfg)
    views = [_index(tree["periods"][f"slot{j}"], i)
             for i in range(n_per) for j in range(p)]
    return views + [tree["rem"][f"layer{j}"] for j in range(n_rem)]


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------ blocks


def block_schema(cfg: ModelConfig, kind: str, moe: bool):
    if kind not in PORTED_KINDS or moe:
        raise ValueError(f"layer kind {kind!r} (moe={moe}) is not ported yet")
    s = {"norm1": norm_schema(cfg), "norm2": norm_schema(cfg)}
    if kind == "rwkv6":
        s["mix"] = rwkv_mod.rwkv_schema(cfg)
        s["ffn"] = rwkv_mod.channel_mix_schema(cfg)
    else:
        s["mix"] = attn.attn_schema(cfg)
        s["ffn"] = mlp_schema(cfg)
    return s


def stack_schema(cfg: ModelConfig):
    p, n_per, n_rem = layout(cfg)
    periods = {
        f"slot{j}": block_schema(cfg, *slot_sig(cfg, j)) for j in range(p)
    }
    s: Dict[str, Any] = {"periods": stack_specs(periods, n_per) if n_per else {}}
    s["rem"] = {
        f"layer{j}": block_schema(cfg, *slot_sig(cfg, n_per * p + j))
        for j in range(n_rem)
    }
    return s


def _to_layout(cfg: ModelConfig, per_layer: list):
    """Per-layer trees in stack order -> the stack layout, period slots
    stacked on a new leading n_periods axis (copies)."""
    p, n_per, n_rem = layout(cfg)
    periods = {f"slot{j}": {k: torch.stack([c[k] for c in
                                            per_layer[j:n_per * p:p]])
                            for k in per_layer[j]}
               for j in range(p)} if n_per else {}
    rem = {f"layer{j}": per_layer[n_per * p + j] for j in range(n_rem)}
    return {"periods": periods, "rem": rem}


# ------------------------------------------------------------ slot path


def _rwkv_block(p, cfg: ModelConfig, x, state):
    """rwkv6 layer body from ``state``: time-mix, then the channel-mix in
    place of the MLP.  -> (x, new state {"s", "x_tm", "x_cm"})."""
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    y, part = rwkv_mod.rwkv_time_mix(p["mix"], cfg, h, state)
    x = x + y
    h2 = norm_apply(p["norm2"], x, cfg.norm_kind)
    y2, x_cm = rwkv_mod.channel_mix(p["ffn"], cfg, h2, state["x_cm"])
    return x + y2, {"s": part["s"], "x_tm": part["x_tm"], "x_cm": x_cm}


def block_apply(p, cfg: ModelConfig, x, positions, *, kind: str):
    """Cacheless forward of one layer at contiguous ``positions`` (S,):
    attention through ``attn_apply``'s kernel branch (rwkv6: its state
    from zeros).  -> x."""
    if kind == "rwkv6":
        return _rwkv_block(p, cfg, x, rwkv_mod.init_state(
            cfg, x.shape[0], x.dtype, x.device))[0]
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    x = x + attn.attn_apply(p["mix"], cfg, h, positions, kind=kind,
                            allow_kernel=True)
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + mlp_apply(p["ffn"], h, cfg.mlp_kind)


def stack_apply(params, cfg: ModelConfig, x, positions):
    """Cacheless forward of the whole stack.  -> x."""
    for p, kind in zip(layer_views(cfg, params), layer_kinds(cfg)):
        x = block_apply(p, cfg, x, positions, kind=kind)
    return x


def block_prefill(p, cfg: ModelConfig, x, positions, *, kind: str,
                  cache_max: int):
    """Whole-prompt forward of one layer + its decode cache (rwkv6: its
    state after the prompt, from zeros).  -> (x, cache)."""
    if kind == "rwkv6":
        return _rwkv_block(p, cfg, x, rwkv_mod.init_state(
            cfg, x.shape[0], x.dtype, x.device))
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    y, cache = attn.attn_prefill(p["mix"], cfg, h, positions, kind=kind,
                                 cache_max=cache_max)
    x = x + y
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + mlp_apply(p["ffn"], h, cfg.mlp_kind), cache


def block_decode(p, cfg: ModelConfig, x, cache, pos, *, kind: str):
    """One-token step of one layer; its cache is written in place.
    x (B,1,D), pos (B,).  -> (x, cache)."""
    if kind == "rwkv6":
        x, new = _rwkv_block(p, cfg, x, cache)
        for key, leaf in new.items():
            cache[key].copy_(leaf)
        return x, cache
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    y, cache = attn.attn_decode(p["mix"], cfg, h, cache, pos, kind=kind)
    x = x + y
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + mlp_apply(p["ffn"], h, cfg.mlp_kind), cache


def stack_prefill(params, cfg: ModelConfig, x, positions, *, cache_max: int):
    """-> (x, caches), caches in the stack layout."""
    caches = []
    for p, kind in zip(layer_views(cfg, params), layer_kinds(cfg)):
        x, c = block_prefill(p, cfg, x, positions, kind=kind,
                             cache_max=cache_max)
        caches.append(c)
    return x, _to_layout(cfg, caches)


def stack_decode(params, cfg: ModelConfig, x, caches, pos):
    """-> (x, caches).  Each layer's cache (a view into the stacked
    leaves) is written in place; the caches are returned."""
    for p, cache, kind in zip(layer_views(cfg, params),
                              layer_views(cfg, caches), layer_kinds(cfg)):
        x, _ = block_decode(p, cfg, x, cache, pos, kind=kind)
    return x, caches


def stack_cache_init(cfg: ModelConfig, batch: int, cache_max: int, dtype,
                     device):
    """Zero slot caches for the whole stack (attention strips with every
    pos lane -1, rwkv6 states of zeros), in the layout of the
    reference's ``stack_cache_abstract``."""
    def one(kind):
        if kind == "rwkv6":
            return rwkv_mod.init_state(cfg, batch, dtype, device)
        return attn.init_cache(cfg, kind, batch, cache_max, dtype, device)

    return _to_layout(cfg, [one(kind) for kind in layer_kinds(cfg)])


# ------------------------------------------------------------ paged path


def block_decode_paged(p, cfg: ModelConfig, x, pool, block_table, pos, active,
                       *, kind: str):
    """One-token step of one layer against its block-paged pool (written
    in place).  -> x."""
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    x = x + attn.attn_decode_paged(p["mix"], cfg, h, pool, block_table, pos,
                                   active, kind=kind)
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + mlp_apply(p["ffn"], h, cfg.mlp_kind)


def stack_decode_paged(params, cfg: ModelConfig, x, pools, block_table, pos,
                       active):
    """-> (x, pools).  The block table is shared by every layer (one
    allocation per request covers the whole stack — each layer owns its
    own physical pool, indexed by the same table).  Pools are written in
    place and returned."""
    for p, pool, kind in zip(layer_views(cfg, params),
                             layer_views(cfg, pools), layer_kinds(cfg)):
        x = block_decode_paged(p, cfg, x, pool, block_table, pos, active,
                               kind=kind)
    return x, pools


def block_prefill_paged(p, cfg: ModelConfig, x, positions, pool, block_table,
                        start_pos, *, kind: str, seq_len=None):
    """Suffix-chunk prefill for one layer: each row attends to its cached
    prefix (through ``block_table``) plus the chunk itself, and emits the
    chunk's cache for the engine to scatter.  -> (x, cache)."""
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    y, cache = attn.attn_prefill_paged(p["mix"], cfg, h, positions, pool,
                                       block_table, start_pos, kind=kind,
                                       seq_len=seq_len)
    x = x + y
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + mlp_apply(p["ffn"], h, cfg.mlp_kind), cache


def stack_prefill_paged(params, cfg: ModelConfig, x, positions, pools,
                        block_table, start_pos, seq_len=None):
    """-> (x, caches), caches in the pool layout: period slots stacked on
    a leading n_periods axis, remainder layers by name."""
    caches = []
    for p, pool, kind in zip(layer_views(cfg, params),
                             layer_views(cfg, pools), layer_kinds(cfg)):
        x, c = block_prefill_paged(p, cfg, x, positions, pool, block_table,
                                   start_pos, kind=kind, seq_len=seq_len)
        caches.append(c)
    return x, _to_layout(cfg, caches)


def stack_pool_init(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype, device):
    """Zero block pools for the whole stack (pos lanes -1), in the cache
    layout: period-stacked leaves lead with ``n_periods``.  Every layer's
    pool has full ``block_size`` blocks, window layers too: as in the
    reference, their window is kept by the mask, not by a ring."""
    return _to_layout(cfg, [attn.paged_pool_init(cfg, num_blocks,
                                                 block_size, dtype, device)
                            for _ in range(cfg.num_layers)])
