"""Layer blocks and period-stacked stacks: the training forward
(``stack_apply_train``, differentiable, with the MoE router loss), the
cacheless inference forward (``stack_apply``, through the kernels: what
the speculative draft runs), the slot path (whole-prompt prefill,
one-token decode against slot caches) and the paged path.

Parameters, pools and caches keep the reference's layout
(``repro.models.transformer``): ``{"periods": {"slot{j}": leaves with a
leading n_periods axis}, "rem": {"layer{j}": leaves}}`` with
``P = lcm(len(layer_kinds), moe_every)`` slots per period.  Where the
reference scans over the period axis, the port runs a Python loop and
indexes that axis; indexing gives views, so a pool written in place by
layer i is the stacked pool's slice i.

Every layer kind of the reference's decoder-only stacks is ported on
every path: ``"attn"`` and ``"attn_local"`` (the local kind masks to
``cfg.sliding_window`` and takes the local RoPE base), ``"mamba"`` and
``"rwkv6"`` (recurrent state as the slot cache, per-request state slots
beside the paged pool), each with a dense MLP or an MoE FFN (rwkv6's
channel-mix takes the FFN's place).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mlp_apply, mlp_schema, norm_apply,
                                       norm_schema)
from repro_torch.models.module import ParamSpec, stack_specs

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


RECURRENT_KINDS = ("mamba", "rwkv6")


def layer_kinds(cfg: ModelConfig) -> list:
    """Each layer's kind, in stack order (that of ``layer_views``)."""
    return [slot_sig(cfg, i)[0] for i in range(cfg.num_layers)]


def layer_sigs(cfg: ModelConfig) -> list:
    """Each layer's (kind, is_moe), in stack order."""
    return [slot_sig(cfg, i) for i in range(cfg.num_layers)]


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
    s: Dict[str, Any] = {"norm1": norm_schema(cfg), "norm2": norm_schema(cfg)}
    if kind in ("attn", "attn_local"):
        s["mix"] = attn.attn_schema(cfg)
    elif kind == "mamba":
        s["mix"] = ssm_mod.ssm_schema(cfg)
    elif kind == "rwkv6":
        s["mix"] = rwkv_mod.rwkv_schema(cfg)
        s["ffn"] = rwkv_mod.channel_mix_schema(cfg)
        return s
    else:
        raise ValueError(f"layer kind {kind!r} is not ported")
    s["ffn"] = moe_mod.moe_schema(cfg) if moe else mlp_schema(cfg)
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


# ------------------------------------------- the cacheless inference forward


def _ffn(p, cfg: ModelConfig, x, moe: bool):
    """The block's FFN: the MoE (its router loss dropped: inference
    only) or the dense MLP."""
    if moe:
        return moe_mod.moe_apply(p["ffn"], cfg, x)[0]
    return mlp_apply(p["ffn"], x, cfg.mlp_kind)


def _init_state(cfg: ModelConfig, kind: str, batch: int, dtype, device):
    mod = ssm_mod if kind == "mamba" else rwkv_mod
    return mod.init_state(cfg, batch, dtype, device)


def _recurrent_fwd(p, cfg: ModelConfig, x, st, *, kind: str, moe: bool,
                   seq_len=None):
    """A mamba or rwkv6 layer's body from the state ``st`` (rwkv6: the
    time-mix, then the channel-mix in place of the FFN).  -> (x, new
    state)."""
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    if kind == "mamba":
        y, new_st = ssm_mod.ssm_forward(p["mix"], cfg, h, st,
                                        seq_len=seq_len)
        x = x + y
        h = norm_apply(p["norm2"], x, cfg.norm_kind)
        return x + _ffn(p, cfg, h, moe), new_st
    y, part = rwkv_mod.rwkv_time_mix(p["mix"], cfg, h, st, seq_len=seq_len)
    x = x + y
    h2 = norm_apply(p["norm2"], x, cfg.norm_kind)
    y2, x_cm = rwkv_mod.channel_mix(p["ffn"], cfg, h2, st["x_cm"],
                                    seq_len=seq_len)
    return x + y2, {"s": part["s"], "x_tm": part["x_tm"], "x_cm": x_cm}


def block_apply(p, cfg: ModelConfig, x, positions, *, kind: str,
                moe: bool = False, bidir_prefix: int = 0):
    """Cacheless inference forward of one layer at contiguous
    ``positions`` (S,): attention through ``attn_apply``'s kernel branch
    (mamba, rwkv6: their state from zeros), the MoE's router loss
    dropped.  ``block_apply_train`` is the training block.  -> x."""
    if kind in RECURRENT_KINDS:
        st = _init_state(cfg, kind, x.shape[0], x.dtype, x.device)
        return _recurrent_fwd(p, cfg, x, st, kind=kind, moe=moe)[0]
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    x = x + attn.attn_apply(p["mix"], cfg, h, positions, kind=kind,
                            bidir_prefix=bidir_prefix, allow_kernel=True)
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + _ffn(p, cfg, h, moe)


def stack_apply(params, cfg: ModelConfig, x, positions, *,
                bidir_prefix: int = 0):
    """Cacheless inference forward of the whole stack, through the
    kernels (the draft model's; paligemma's, its first ``bidir_prefix``
    positions seen by every query).  -> x."""
    for p, (kind, moe) in zip(layer_views(cfg, params), layer_sigs(cfg)):
        x = block_apply(p, cfg, x, positions, kind=kind, moe=moe,
                        bidir_prefix=bidir_prefix)
    return x


# ------------------------------------------------------------ training


def _ffn_train(p, cfg: ModelConfig, x, moe: bool):
    """The block's FFN -> (y, router loss: the MoE's, or a float32 0)."""
    if moe:
        return moe_mod.moe_apply(p["ffn"], cfg, x)
    return (mlp_apply(p["ffn"], x, cfg.mlp_kind),
            torch.zeros((), dtype=torch.float32, device=x.device))


def block_apply_train(p, cfg: ModelConfig, x, positions, *, kind: str,
                      moe: bool = False, bidir_prefix: int = 0):
    """The reference's training block (``block_apply``): attention
    through ``attn_apply``'s q-chunked branch, mamba through
    ``ssm_apply``, rwkv6's time-mix and channel-mix from zero states.
    -> (x, router loss, float32)."""
    if kind == "rwkv6":
        st = _init_state(cfg, kind, x.shape[0], x.dtype, x.device)
        x = _recurrent_fwd(p, cfg, x, st, kind=kind, moe=moe)[0]
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    if kind == "mamba":
        y = ssm_mod.ssm_apply(p["mix"], cfg, h)
    else:
        y = attn.attn_apply(p["mix"], cfg, h, positions, kind=kind,
                            bidir_prefix=bidir_prefix)
    x = x + y
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    y, aux = _ffn_train(p, cfg, h, moe)
    return x + y, aux


def stack_apply_train(params, cfg: ModelConfig, x, positions, *,
                      bidir_prefix: int = 0, remat: bool = True):
    """The reference's training stack (``stack_apply``): every layer's
    ``block_apply_train``, the router losses summed in float32.
    ``remat`` recomputes each period of P layers in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` on
    its scanned period body), so only the residual entering each period
    is kept; the remainder layers run as they are, as in the reference.
    Gradients do not depend on it.  -> (x, router loss)."""
    p, n_per, n_rem = layout(cfg)
    sigs = [slot_sig(cfg, j) for j in range(p)]

    def period(x, period_params):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j, (kind, moe) in enumerate(sigs):
            x, a = block_apply_train(period_params[f"slot{j}"], cfg, x,
                                     positions, kind=kind, moe=moe,
                                     bidir_prefix=bidir_prefix)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_per):
        pp = _index(params["periods"], i)
        if remat and torch.is_grad_enabled():
            # the forward draws no random numbers: no RNG state to keep
            x, a = checkpoint(period, x, pp, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = period(x, pp)
        aux = aux + a
    for j in range(n_rem):
        kind, moe = slot_sig(cfg, n_per * p + j)
        x, a = block_apply_train(params["rem"][f"layer{j}"], cfg, x,
                                 positions, kind=kind, moe=moe,
                                 bidir_prefix=bidir_prefix)
        aux = aux + a
    return x, aux


# ------------------------------------------------------------ slot path


def block_prefill(p, cfg: ModelConfig, x, positions, *, kind: str,
                  cache_max: int, moe: bool = False, bidir_prefix: int = 0):
    """Whole-prompt forward of one layer + its decode cache (mamba,
    rwkv6: the state after the prompt, from zeros); attention's first
    ``bidir_prefix`` keys seen by every query.  -> (x, cache)."""
    if kind in RECURRENT_KINDS:
        st = _init_state(cfg, kind, x.shape[0], x.dtype, x.device)
        return _recurrent_fwd(p, cfg, x, st, kind=kind, moe=moe)
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    y, cache = attn.attn_prefill(p["mix"], cfg, h, positions, kind=kind,
                                 cache_max=cache_max,
                                 bidir_prefix=bidir_prefix)
    x = x + y
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + _ffn(p, cfg, h, moe), cache


def block_decode(p, cfg: ModelConfig, x, cache, pos, *, kind: str,
                 moe: bool = False):
    """One-token step of one layer; its cache is written in place.
    x (B,1,D), pos (B,).  -> (x, cache)."""
    if kind in RECURRENT_KINDS:
        x, new = _recurrent_fwd(p, cfg, x, cache, kind=kind, moe=moe)
        for key, leaf in new.items():
            cache[key].copy_(leaf)
        return x, cache
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    y, cache = attn.attn_decode(p["mix"], cfg, h, cache, pos, kind=kind)
    x = x + y
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + _ffn(p, cfg, h, moe), cache


def stack_prefill(params, cfg: ModelConfig, x, positions, *, cache_max: int,
                  bidir_prefix: int = 0):
    """-> (x, caches), caches in the stack layout."""
    caches = []
    for p, (kind, moe) in zip(layer_views(cfg, params), layer_sigs(cfg)):
        x, c = block_prefill(p, cfg, x, positions, kind=kind, moe=moe,
                             cache_max=cache_max, bidir_prefix=bidir_prefix)
        caches.append(c)
    return x, _to_layout(cfg, caches)


def stack_decode(params, cfg: ModelConfig, x, caches, pos):
    """-> (x, caches).  Each layer's cache (a view into the stacked
    leaves) is written in place; the caches are returned."""
    for p, cache, (kind, moe) in zip(layer_views(cfg, params),
                                     layer_views(cfg, caches),
                                     layer_sigs(cfg)):
        x, _ = block_decode(p, cfg, x, cache, pos, kind=kind, moe=moe)
    return x, caches


def stack_cache_init(cfg: ModelConfig, batch: int, cache_max: int, dtype,
                     device):
    """Zero slot caches for the whole stack (attention strips with every
    pos lane -1, mamba and rwkv6 states of zeros), in the layout of the
    reference's ``stack_cache_abstract``."""
    def one(kind):
        if kind in RECURRENT_KINDS:
            return _init_state(cfg, kind, batch, dtype, device)
        return attn.init_cache(cfg, kind, batch, cache_max, dtype, device)

    return _to_layout(cfg, [one(kind) for kind in layer_kinds(cfg)])


# ------------------------------------------------------------ paged path


def _state_read(pool, rows, start_pos, batch: int):
    """Gather each dispatch row's recurrent state from its slot of a
    state pool (``rows`` (B,); a copy).  Rows whose chunk starts at
    position 0 read zeros instead: that covers fresh admissions and
    preempt-resume re-prefills with no host-side slot reset."""
    sp = torch.as_tensor(start_pos, device=rows.device).expand(batch)
    fresh = sp == 0

    def read(leaf):
        v = leaf[rows]
        m = fresh.reshape((batch,) + (1,) * (v.dim() - 1))
        return torch.where(m, torch.zeros_like(v), v)

    return {k: read(v) for k, v in pool.items()}


def block_decode_paged(p, cfg: ModelConfig, x, pool, block_table, pos, active,
                       *, kind: str, moe: bool = False):
    """One-token step of one layer against its pool (written in place):
    attention layers read and write the block-paged KV pool, recurrent
    layers the state slots, where dispatch row i is slot i (the state
    pool's extra last row is the trash slot of padded prefill rows) and
    inactive rows keep their state.  -> x."""
    if kind in RECURRENT_KINDS:
        b = x.shape[0]
        st = {k: v[:b] for k, v in pool.items()}
        x, new = _recurrent_fwd(p, cfg, x, st, kind=kind, moe=moe)
        for key, leaf in st.items():
            keep = active.reshape((b,) + (1,) * (leaf.dim() - 1))
            leaf.copy_(torch.where(keep, new[key].to(leaf.dtype), leaf))
        return x
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    x = x + attn.attn_decode_paged(p["mix"], cfg, h, pool, block_table, pos,
                                   active, kind=kind)
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + _ffn(p, cfg, h, moe)


def stack_decode_paged(params, cfg: ModelConfig, x, pools, block_table, pos,
                       active):
    """-> (x, pools).  The block table is shared by every layer (one
    allocation per request covers the whole stack — each layer owns its
    own physical pool, indexed by the same table).  Pools are written in
    place and returned."""
    for p, pool, (kind, moe) in zip(layer_views(cfg, params),
                                    layer_views(cfg, pools),
                                    layer_sigs(cfg)):
        x = block_decode_paged(p, cfg, x, pool, block_table, pos, active,
                               kind=kind, moe=moe)
    return x, pools


def block_prefill_paged(p, cfg: ModelConfig, x, positions, pool, block_table,
                        start_pos, *, kind: str, moe: bool = False,
                        seq_len=None, state_rows=None):
    """Suffix-chunk prefill for one layer: each row attends to its cached
    prefix (through ``block_table``) plus the chunk itself, and emits the
    chunk's cache for the engine to scatter.  Recurrent layers carry
    their chunk-entry state in slots instead: ``state_rows`` (B,) maps
    each dispatch row to its slot (None: row i is slot i), and the
    emitted "cache" is the chunk-exit state.  -> (x, cache)."""
    if kind in RECURRENT_KINDS:
        b = x.shape[0]
        rows = (torch.arange(b, device=x.device) if state_rows is None
                else state_rows.long())
        st = _state_read(pool, rows, start_pos, b)
        return _recurrent_fwd(p, cfg, x, st, kind=kind, moe=moe,
                              seq_len=seq_len)
    h = norm_apply(p["norm1"], x, cfg.norm_kind)
    y, cache = attn.attn_prefill_paged(p["mix"], cfg, h, positions, pool,
                                       block_table, start_pos, kind=kind,
                                       seq_len=seq_len)
    x = x + y
    h = norm_apply(p["norm2"], x, cfg.norm_kind)
    return x + _ffn(p, cfg, h, moe), cache


def stack_prefill_paged(params, cfg: ModelConfig, x, positions, pools,
                        block_table, start_pos, seq_len=None,
                        state_rows=None):
    """-> (x, caches), caches in the pool layout: period slots stacked on
    a leading n_periods axis, remainder layers by name; a recurrent
    layer's is its chunk-exit state (B, ...)."""
    caches = []
    for p, pool, (kind, moe) in zip(layer_views(cfg, params),
                                    layer_views(cfg, pools),
                                    layer_sigs(cfg)):
        x, c = block_prefill_paged(p, cfg, x, positions, pool, block_table,
                                   start_pos, kind=kind, moe=moe,
                                   seq_len=seq_len, state_rows=state_rows)
        caches.append(c)
    return x, _to_layout(cfg, caches)


def stack_pool_init(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype, device, state_batch: int = 1):
    """Zero pools for the whole stack (pos lanes -1), in the cache
    layout: period-stacked leaves lead with ``n_periods``.  Every
    attention layer's pool has full ``block_size`` blocks, window layers
    too: as in the reference, their window is kept by the mask, not by a
    ring.  Recurrent layers get ``state_batch`` fixed-size state slots
    instead of blocks (the engine passes max_batch + 1: one slot per
    engine row and a trash slot for padded dispatch rows)."""
    def one(kind):
        if kind in RECURRENT_KINDS:
            return _init_state(cfg, kind, state_batch, dtype, device)
        return attn.paged_pool_init(cfg, num_blocks, block_size, dtype,
                                    device)

    return _to_layout(cfg, [one(kind) for kind in layer_kinds(cfg)])


# ------------------------------------------------------------------ enc-dec
# whisper-tiny: 4 + 4 layers, unrolled as in the reference.  Parameters
# ``{"encoder": {"layer{i}"}, "enc_pos", "enc_norm", "decoder":
# {"layer{i}"}}``; decoder caches ``{"layer{i}": {"self": slot cache,
# "xk", "xv": (B, F, KV, hd)}}``.  ``train=True`` runs the reference's
# differentiable formulation (attention in ``attn_apply``'s q-chunked
# branch, ``cross_apply``); inference runs every attention through
# ``ops.flash_attention``: the encoder's non-causal self-attention, the
# decoder's causal one and its cross-attention (``cross_attend``).


def encoder_layer_schema(cfg: ModelConfig):
    return {
        "norm1": norm_schema(cfg),
        "attn": attn.attn_schema(cfg),
        "norm2": norm_schema(cfg),
        "ffn": mlp_schema(cfg),
    }


def decoder_layer_schema(cfg: ModelConfig):
    return {
        "norm1": norm_schema(cfg),
        "attn": attn.attn_schema(cfg),
        "norm_x": norm_schema(cfg),
        "cross": attn.attn_schema(cfg, cross=True),
        "norm2": norm_schema(cfg),
        "ffn": mlp_schema(cfg),
    }


def encdec_schema(cfg: ModelConfig):
    return {
        "encoder": {f"layer{i}": encoder_layer_schema(cfg)
                    for i in range(cfg.encoder_layers)},
        "enc_pos": ParamSpec((cfg.encoder_frames, cfg.d_model), init="embed"),
        "enc_norm": norm_schema(cfg),
        "decoder": {f"layer{i}": decoder_layer_schema(cfg)
                    for i in range(cfg.num_layers)},
    }


def encoder_apply(params, cfg: ModelConfig, frames, *, train: bool = False):
    """``params`` is the whole encdec tree; frames (B, F, D) from the
    stubbed audio frontend -> the encoder output (B, F, D): learned frame
    positions added, non-causal self-attention, ``enc_norm`` last."""
    x = frames + params["enc_pos"][None].to(frames.dtype)
    pos = torch.arange(frames.shape[1], dtype=torch.int32,
                       device=frames.device)
    for i in range(cfg.encoder_layers):
        p = params["encoder"][f"layer{i}"]
        h = norm_apply(p["norm1"], x, cfg.norm_kind)
        x = x + attn.attn_apply(p["attn"], cfg, h, pos, causal=False,
                                allow_kernel=not train)
        h = norm_apply(p["norm2"], x, cfg.norm_kind)
        x = x + mlp_apply(p["ffn"], h, cfg.mlp_kind)
    return norm_apply(params["enc_norm"], x, cfg.norm_kind)


def decoder_apply(params, cfg: ModelConfig, x, positions, enc_out, *,
                  train: bool = False):
    """Full-sequence decoder over x (B,S,D) at ``positions`` (S,) against
    the encoder output, no cache (``params``: the decoder tree)."""
    cross = attn.cross_apply if train else attn.cross_attend
    for i in range(cfg.num_layers):
        p = params[f"layer{i}"]
        h = norm_apply(p["norm1"], x, cfg.norm_kind)
        x = x + attn.attn_apply(p["attn"], cfg, h, positions,
                                allow_kernel=not train)
        h = norm_apply(p["norm_x"], x, cfg.norm_kind)
        x = x + cross(p["cross"], cfg, h, *attn.cross_kv(p["cross"], enc_out))
        h = norm_apply(p["norm2"], x, cfg.norm_kind)
        x = x + mlp_apply(p["ffn"], h, cfg.mlp_kind)
    return x


def decoder_prefill(params, cfg: ModelConfig, x, positions, enc_out,
                    cache_max: int):
    """Whole-prompt decoder forward + caches: each layer's self-attention
    slot cache of ``cache_max`` lanes and its cross K/V, computed once
    from the encoder output.  -> (x, caches)."""
    caches = {}
    for i in range(cfg.num_layers):
        p = params[f"layer{i}"]
        h = norm_apply(p["norm1"], x, cfg.norm_kind)
        y, c = attn.attn_prefill(p["attn"], cfg, h, positions, kind="attn",
                                 cache_max=cache_max)
        x = x + y
        h = norm_apply(p["norm_x"], x, cfg.norm_kind)
        k, v = attn.cross_kv(p["cross"], enc_out)
        x = x + attn.cross_attend(p["cross"], cfg, h, k, v)
        h = norm_apply(p["norm2"], x, cfg.norm_kind)
        x = x + mlp_apply(p["ffn"], h, cfg.mlp_kind)
        caches[f"layer{i}"] = {"self": c, "xk": k, "xv": v}
    return x, caches


def decoder_decode(params, cfg: ModelConfig, x, caches, pos):
    """One-token decoder step: x (B,1,D), pos (B,).  Each layer's
    self-attention cache is written in place (``attn_decode``); the cross
    K/V are read.  -> (x, caches)."""
    for i in range(cfg.num_layers):
        p = params[f"layer{i}"]
        c = caches[f"layer{i}"]
        h = norm_apply(p["norm1"], x, cfg.norm_kind)
        y, _ = attn.attn_decode(p["attn"], cfg, h, c["self"], pos,
                                kind="attn")
        x = x + y
        h = norm_apply(p["norm_x"], x, cfg.norm_kind)
        x = x + attn.cross_attend(p["cross"], cfg, h, c["xk"], c["xv"])
        h = norm_apply(p["norm2"], x, cfg.norm_kind)
        x = x + mlp_apply(p["ffn"], h, cfg.mlp_kind)
    return x, caches


def decoder_cache_init(cfg: ModelConfig, batch: int, cache_max: int, dtype,
                       device):
    """Zero decoder caches (self-attention pos lanes -1, cross K/V of
    ``encoder_frames`` rows), in the layout of the reference's
    ``Model.cache_abstract``."""
    shape = (batch, cfg.encoder_frames, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {f"layer{i}": {
        "self": attn.init_cache(cfg, "attn", batch, cache_max, dtype, device),
        "xk": torch.zeros(shape, dtype=dtype, device=device),
        "xv": torch.zeros(shape, dtype=dtype, device=device)}
        for i in range(cfg.num_layers)}
