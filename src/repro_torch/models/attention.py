"""Attention: GQA, RoPE, qk-norm; full-sequence attention for training
and inference, the slot cache and the block-paged pool.

The port of ``repro.models.attention``.  ``attn_apply`` is the
full-sequence layer: its kernel branch (``allow_kernel=True``, the
draft model's and the reference's inference forward, a prefix-LM's and
an encoder's too) runs ``ops.flash_attention``; its q-chunked branch
(training) is the reference's differentiable formulation in plain
PyTorch, with no kernel, as in the reference.  Cross-attention (whisper)
keeps the encoder's K/V: ``cross_apply`` is the reference's plain
formulation (training), ``cross_attend`` the same through
``ops.flash_attention(causal=False)`` (inference).  Two cache shapes:

* the slot cache of one layer (``init_cache``): ``{"k", "v": (B, C, KV,
  hd), "pos": (B, C) int32}``, one strip of ``C`` lanes per slot, filled
  by ``attn_prefill`` (whole prompt) and ``attn_decode`` (one token,
  ring position ``pos % C``);
* the paged pool of one layer (``paged_pool_init``): ``{"k", "v": (NB,
  bs, KV, hd), "pos": (NB, bs) int32}``.  Physical block 0 is the null
  block: its ``pos`` lanes stay -1 and block tables pad with 0, so reads
  through padding never pass the mask.

With ``cfg.kv_cache_quant`` both hold ``k``/``v`` as int8 with a float32
absmax scale per (lane, KV head) in ``k_s``/``v_s`` (``(B, C, KV)``,
``(NB, bs, KV)``), as the reference's.  Writes quantize in plain
PyTorch (``_quantize_kv``); every read of an int8 strip or pool goes
through the int8 entries of ``kernels/ops.py``, whose CUDA kernels
dequantize as they load (the reference dequantizes the gathered table
with jnp first), so no model-dtype copy of the cache is made.

``pos`` holds the absolute position of each lane (-1 = invalid).  Where
the reference rebuilds a cache or pool with ``.at[].set`` or
``dynamic_update_slice``, the port writes the tensors in place; each
such place says so.
"""
from __future__ import annotations

import contextvars
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import dequantize_kv as _dequantize_kv  # noqa: F401
from repro_torch.models.layers import apply_rope, rms_norm
from repro_torch.models.module import ParamSpec, at_least_f32

NEG_INF = -2.0 ** 30  # large-negative that survives bf16

# q-chunk override: forces the chunk length of ``attn_apply``'s q-chunked
# branch (the reference's roofline lowering forces one chunk); a
# contextvar, so model code stays signature-stable
_Q_CHUNK_OVERRIDE: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("q_chunk_override", default=None)

# ------------------------------------------------------------------ schema


def attn_schema(cfg: ModelConfig, cross: bool = False):
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    s = {
        "wq": ParamSpec((d, cfg.num_heads, hd), scale_dim=-3),
        "wk": ParamSpec((d, cfg.num_kv_heads, hd), scale_dim=-3),
        "wv": ParamSpec((d, cfg.num_kv_heads, hd), scale_dim=-3),
        "wo": ParamSpec((cfg.num_heads, hd, d), scale_dim=-2),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamSpec((cfg.num_heads, hd), init="zeros")
        s["bk"] = ParamSpec((cfg.num_kv_heads, hd), init="zeros")
        s["bv"] = ParamSpec((cfg.num_kv_heads, hd), init="zeros")
    if cfg.qk_norm and not cross:
        s["q_norm"] = ParamSpec((hd,), init="ones")
        s["k_norm"] = ParamSpec((hd,), init="ones")
    return s


# ------------------------------------------------------------------ helpers


def _theta_for(cfg: ModelConfig, kind: str) -> float:
    """Per-kind RoPE base: gemma3's local layers keep the 10k base while
    global layers use the long-context 1M base."""
    if kind == "attn_local" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _project_qkv(p, cfg: ModelConfig, x, positions, rope: bool,
                 kind: str = "attn"):
    """x (B,S,D) -> q (B,S,H,hd), k/v (B,S,KV,hd); RoPE at ``positions``."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if cfg.qk_norm and "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if rope:
        theta = _theta_for(cfg, kind)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _out_proj(out, wo):
    """out (..., H, hd) @ wo (H, hd, D) -> (..., D)."""
    h, hd, d = wo.shape
    return out.reshape(*out.shape[:-2], h * hd) @ wo.reshape(h * hd, d)


def _bcast_pos(positions, b, s):
    positions = torch.as_tensor(positions, dtype=torch.int32)
    if positions.dim() == 1:
        positions = positions[None, :].expand(b, s)
    return positions.contiguous()


# ------------------------------------------------------------- full-seq


def _flash_attend(p, cfg: ModelConfig, q, k, v, *, kind: str = "attn",
                  causal: bool = True, prefix: int = 0):
    """q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> y (B,Sq,D) through
    ``ops.flash_attention`` (the CUDA kernel on the card, its plain
    version on the CPU): causal self-attention, its first ``prefix``
    keys seen by every query (prefix-LM), or ``causal=False`` (the
    encoder, cross-attention).  The kernel reads the ``(B,H,S,hd)``
    transposed views through their strides and writes its output in q's
    layout, so neither direction copies on the card."""
    window = cfg.sliding_window if kind == "attn_local" else 0
    out = kernel_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     window=window, prefix=prefix)
    return _out_proj(out.transpose(1, 2), p["wo"])


def _repeat_kv(k, h: int):
    """(B,S,KV,hd) -> (B,S,H,hd), each KV head repeated for its group."""
    kv = k.shape[2]
    if kv != h:
        k = torch.repeat_interleave(k, h // kv, dim=2)
    return k


def _scores(q, k_rep):
    """q (B,Sq,H,hd), k_rep (B,Sk,H,hd) -> (B,H,Sq,Sk), in their dtype."""
    return torch.einsum("bqhd,bshd->bhqs", q, k_rep)


def _attn_out(probs, v_rep):
    """probs (B,H,Sq,Sk), v_rep (B,Sk,H,hd) -> (B,Sq,H,hd)."""
    return torch.einsum("bhqs,bshd->bqhd", probs, v_rep)


def _softmax(scores, mask):
    """float32 softmax over the last axis, masked lanes at ``NEG_INF``;
    the max is held out of the gradient (``stop_gradient`` in the
    reference)."""
    scores = torch.where(mask, at_least_f32(scores), NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True).detach()
    e = torch.exp(scores - m)
    z = torch.sum(e, dim=-1, keepdim=True)
    return e / torch.clamp(z, min=1e-30)


def _chunk_attend(qi, pi, kpos, k_rep, v_rep, *, scale: float, causal: bool,
                  bidir_prefix: int, window: int):
    """One query chunk of the q-chunked branch: qi (B,qc,H,hd) at
    positions pi (B,qc) against every key -> (B,qc,H,hd)."""
    sc = _scores(qi, k_rep) * scale
    kp = kpos[:, None, None, :]
    qp = pi[:, None, :, None]
    if causal:
        mask = (qp >= kp) & (kp >= 0)
        if bidir_prefix:
            mask = mask | ((kp >= 0) & (kp < bidir_prefix) & (qp >= 0))
    else:
        mask = kp >= 0
    if window:
        mask = mask & (qp - kp < window)
    probs = _softmax(sc, mask).to(v_rep.dtype)
    return _attn_out(probs, v_rep)


def attn_apply(p, cfg: ModelConfig, x, positions, *, kind: str = "attn",
               causal: bool = True, kv_override=None, q_chunk: int = 1024,
               bidir_prefix: int = 0, allow_kernel: bool = False):
    """Full-sequence attention.  -> y (B,S,D).

    kind: "attn" (global) or "attn_local" (sliding window of
    ``cfg.sliding_window``).  ``kv_override=(k, v, kv_positions)``
    switches to cross-attention (no causal mask, no RoPE on the kv side
    here).  ``bidir_prefix``: the first N positions attend
    bidirectionally (prefix-LM).

    ``allow_kernel=True`` with self-attention at (S,) positions takes
    the reference's kernel branch, through ``ops.flash_attention``
    (inference only: the kernel has no backward); a bidirectional prefix
    goes to the kernel as its ``prefix`` (the reference keeps prefix-LM
    attention off its kernel, on the q-chunked branch: the same mask).  Everything else runs the reference's q-chunked branch,
    in plain PyTorch under autograd: the queries in ``ceil(S / q_chunk)``
    equal chunks (padded query lanes at position -1), scores in the model
    dtype against every key, the masked float32 ``_softmax``, the
    probabilities cast to v's dtype for the value product.  Each chunk
    is recomputed in the backward pass
    (``torch.utils.checkpoint.checkpoint``, the reference's
    ``jax.checkpoint`` on its chunk body), so the (S, S) scores are never
    kept for the backward.  The reference's own training path takes this
    branch: its kernels have no VJP."""
    hd = cfg.resolved_head_dim
    rope = cfg.pos_kind == "rope"
    positions = torch.as_tensor(positions, dtype=torch.int32,
                                device=x.device)
    if kv_override is None:
        q, k, v = _project_qkv(p, cfg, x, positions, rope, kind)
        kv_pos = positions
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
        if cfg.qkv_bias:
            q = q + p["bq"]
        k, v, kv_pos = kv_override
        causal = False
    window = cfg.sliding_window if kind == "attn_local" else 0

    if allow_kernel and kv_override is None and positions.dim() == 1:
        return _flash_attend(p, cfg, q, k, v, kind=kind, causal=causal,
                             prefix=bidir_prefix)

    b, s, h, _ = q.shape
    q_chunk = _Q_CHUNK_OVERRIDE.get() or q_chunk
    nchunk = max(1, -(-s // q_chunk))
    q_chunk = -(-s // nchunk)
    pad = nchunk * q_chunk - s
    qpos = _bcast_pos(positions, b, s)
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        qpos = F.pad(qpos, (0, pad), value=-1)
    kpos = _bcast_pos(torch.as_tensor(kv_pos, device=x.device), b,
                      k.shape[1])
    k_rep, v_rep = _repeat_kv(k, h), _repeat_kv(v, h)
    body = functools.partial(_chunk_attend, scale=1.0 / math.sqrt(hd),
                             causal=causal, bidir_prefix=bidir_prefix,
                             window=window)
    outs = []
    for i in range(nchunk):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        pi = qpos[:, i * q_chunk:(i + 1) * q_chunk]
        if torch.is_grad_enabled():
            # the forward draws no random numbers: no RNG state to keep
            outs.append(checkpoint(body, qi, pi, kpos, k_rep, v_rep,
                                   use_reentrant=False,
                                   preserve_rng_state=False))
        else:
            outs.append(body(qi, pi, kpos, k_rep, v_rep))
    out = torch.cat(outs, dim=1)[:, :s]
    return _out_proj(out, p["wo"])


# ------------------------------------------------------------- slot cache


def cache_len_for(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if kind == "attn_local" and cfg.sliding_window:
        return min(cfg.sliding_window, max_len)
    return max_len


def _quantize_kv(t):
    """(..., hd) -> (int8 values, float32 absmax scale (...)), as the
    reference: round half to even of ``t / scale``, a true division."""
    t32 = t.float()
    a = t32.abs().amax(-1, keepdim=True)
    scale = torch.clamp(a, min=1e-8) / 127.0
    q = torch.clamp(torch.round(t32 / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0]


def _kv_leaves(cfg: ModelConfig, lead, kv: int, hd: int, dtype, device):
    """Zero ``k``/``v`` leaves of shape ``lead + (KV, hd)``: the model
    dtype, or int8 with float32 scales ``k_s``/``v_s`` of ``lead + (KV,)``
    under ``kv_cache_quant``."""
    if not cfg.kv_cache_quant:
        return {n: torch.zeros(lead + (kv, hd), dtype=dtype, device=device)
                for n in ("k", "v")}
    out = {n: torch.zeros(lead + (kv, hd), dtype=torch.int8, device=device)
           for n in ("k", "v")}
    out.update({n: torch.zeros(lead + (kv,), dtype=torch.float32,
                               device=device) for n in ("k_s", "v_s")})
    return out


def _quantized_entries(k, v):
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    return {"k": kq, "v": vq, "k_s": ks, "v_s": vs}


def init_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
               device):
    """Zero slot cache for one attention layer, every pos lane -1."""
    c = cache_len_for(cfg, kind, max_len)
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    return {"pos": torch.full((batch, c), -1, dtype=torch.int32,
                              device=device),
            **_kv_leaves(cfg, (batch, c), kv, hd, dtype, device)}


def attn_prefill(p, cfg: ModelConfig, x, positions, *, kind: str,
                 cache_max: int, bidir_prefix: int = 0):
    """Whole-prompt forward at positions (S,) + cache construction.
    -> (y (B,S,D), cache with ``cache_len_for`` lanes).

    The reference projects q/k/v twice (once inside ``attn_apply``, once
    for the cache); the port projects once and feeds both.  Lanes past
    the prompt carry pos -1; a prompt of at least ``clen`` tokens keeps
    its last ``clen`` positions, ring-aligned so lane j holds the
    position p with p % clen == j.  ``bidir_prefix``: every query sees
    the prompt's first N keys (prefix-LM), the kernel's ``prefix``.  Under ``kv_cache_quant`` the cache
    holds the prompt quantized (the scales roll with it), while ``y``
    attends the fresh full-precision K/V, as the reference's."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions, cfg.pos_kind == "rope",
                           kind)
    y = _flash_attend(p, cfg, q, k, v, kind=kind, prefix=bidir_prefix)
    clen = cache_len_for(cfg, kind, cache_max)
    entries = {"k": k, "v": v, "pos": _bcast_pos(positions, b, s)}
    if cfg.kv_cache_quant:
        entries.update(_quantized_entries(k, v))
    if s >= clen:
        # element i holds position take + i, which belongs at lane
        # (take + i) % clen
        take = s - clen
        roll = (take % clen) if clen else 0
        return y, {kk: torch.roll(vv[:, take:], roll, dims=1)
                   for kk, vv in entries.items()}
    cache = init_cache(cfg, kind, b, cache_max, k.dtype, x.device)
    for kk, vv in entries.items():
        cache[kk][:, :s] = vv
    return y, cache


def attn_decode(p, cfg: ModelConfig, x, cache, pos, *, kind: str):
    """One-token decode.  x (B,1,D), pos (B,) int32 absolute position of
    the new token.  Writes the token's K/V and position into lane ``pos
    % C`` of each row's strip, in place (the reference returns a rebuilt
    cache).  -> (y (B,1,D), cache).

    The read is ``ops.paged_prefill`` with one query lane: the same mask
    (``kpos >= 0 and kpos <= pos``, plus the window band), float32
    scores and probabilities cast to the value dtype as the reference's
    slot read, and the CUDA kernel on the card.  An int8 strip (the new
    token quantized into it first, as the reference) is read by
    ``ops.paged_prefill_int8`` as a prefix of the whole strip and no
    chunk keys."""
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None],
                                   cfg.pos_kind == "rope", kind)
    rows = torch.arange(x.shape[0], device=x.device)
    lane = (pos % cache["k"].shape[1]).long()
    if cfg.kv_cache_quant:
        new = _quantized_entries(k_new[:, 0], v_new[:, 0])
    else:
        new = {"k": k_new[:, 0].to(cache["k"].dtype),
               "v": v_new[:, 0].to(cache["v"].dtype)}
    for name, val in new.items():
        cache[name][rows, lane] = val
    pos = pos.to(torch.int32)
    cache["pos"][rows, lane] = pos
    window = cfg.sliding_window if kind == "attn_local" else 0
    qpos = pos[:, None].contiguous()
    if cfg.kv_cache_quant:
        b, _, kv, hd = cache["k"].shape
        none = q.new_empty((b, 0, kv, hd))
        out = kernel_ops.paged_prefill_int8(
            q.contiguous(), cache["k"], cache["v"], cache["k_s"],
            cache["v_s"], cache["pos"], none, none,
            qpos.new_empty((b, 0)), qpos, window=window)
    else:
        out = kernel_ops.paged_prefill(q.contiguous(), cache["k"],
                                       cache["v"], cache["pos"], qpos,
                                       window=window)
    return _out_proj(out, p["wo"]), cache


# ------------------------------------------------------------- paged cache


def paged_pool_init(cfg: ModelConfig, num_blocks: int, block_size: int,
                    dtype, device):
    """Zero pool for one attention layer (pos lanes -1)."""
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    return {**_kv_leaves(cfg, (num_blocks, block_size), kv, hd, dtype,
                         device),
            "pos": torch.full((num_blocks, block_size), -1,
                              dtype=torch.int32, device=device)}


def attn_decode_paged(p, cfg: ModelConfig, x, pool, block_table, pos, active,
                      *, kind: str):
    """One-token decode against a block-paged KV pool.

    x (B,1,D); ``pool`` is the *shared* layer pool; ``block_table`` (B, nb)
    int32 maps each request's logical blocks to physical ids (0-padded);
    ``pos`` (B,) absolute position of the new token; ``active`` (B,)
    bool — inactive rows write ``pos = -1`` into the null block so their
    lanes never validate.  Writes the new token's K/V into ``pool`` in
    place and returns y (B,1,D).

    The read goes through ``ops.paged_attention``: the CUDA kernel on the
    card, its plain version on the CPU.  Inactive rows read zeros, which
    the engine discards.  An int8 pool takes the token quantized and is
    read by ``ops.paged_attention_int8``, which dequantizes as it loads.
    """
    rope = cfg.pos_kind == "rope"
    q, k_new, v_new = _project_qkv(p, cfg, x, pos[:, None], rope, kind)
    bs = pool["pos"].shape[1]

    # scatter the new token's kv into (physical block, in-block offset),
    # in place (the reference rebuilds the pool with .at[].set).  Active
    # rows own disjoint blocks; inactive rows all target the null block
    # and write pos=-1 (their k/v payloads race, but a -1 lane is masked
    # regardless of payload).
    posl = pos.long()
    phys = torch.gather(block_table.long(), 1, (posl // bs)[:, None])[:, 0]
    off = posl % bs
    if cfg.kv_cache_quant:
        new = _quantized_entries(k_new[:, 0], v_new[:, 0])
    else:
        new = {"k": k_new[:, 0].to(pool["k"].dtype),
               "v": v_new[:, 0].to(pool["v"].dtype)}
    for name, val in new.items():
        pool[name][phys, off] = val
    pool["pos"][phys, off] = torch.where(active, pos.int(), -1)

    window = cfg.sliding_window if kind == "attn_local" else 0
    args = (block_table, pos.int().contiguous())
    if cfg.kv_cache_quant:
        out = kernel_ops.paged_attention_int8(
            q[:, 0].contiguous(), pool["k"], pool["v"], pool["k_s"],
            pool["v_s"], pool["pos"], *args, window=window)
    else:
        out = kernel_ops.paged_attention(
            q[:, 0].contiguous(), pool["k"], pool["v"], pool["pos"], *args,
            window=window)
    return _out_proj(out, p["wo"])[:, None]


def attn_prefill_paged(p, cfg: ModelConfig, x, positions, pool, block_table,
                       start_pos, *, kind: str = "attn", seq_len=None):
    """Padding-masked position-offset prefill against a block-paged pool
    — the one paged prefill entry (fresh prompts, preempt-resume and
    prefix-cache suffixes all route here).

    x (B,S,D) holds a ragged batch of uncached suffix chunks, one row per
    request, row i's first token at absolute position ``start_pos``
    (scalar, or (B,) per-row cursors); ``positions`` are ``start_pos +
    [0..S)``, shaped (S,) or (B,S).  The prefix KV (earlier chunks,
    prefix-cache blocks, or both) is read from ``pool`` through
    ``block_table`` (B, nb).  Pool lanes at positions ``>= start_pos``
    (per row) are invalid, as are ``pos = -1`` lanes: that one guard
    covers a copy-on-write block's diverged donor tail and a chunked
    prefill's not-yet-written own-block lanes.

    ``seq_len`` (B,) int32 is the valid suffix length when ``x`` is
    right-padded to a length bucket (None = all S valid): padded lanes
    are masked as keys and carry ``pos`` -1 in the returned cache; their
    query rows produce garbage the caller discards.

    Returns (y (B,S,D), chunk cache ``{"k", "v": (B,S,KV,hd), "pos":
    (B,S)}``) for the engine to scatter into the pool.  The pool itself
    is not written.

    An int8 pool: the gathered prefix stays int8 (bytes and scales) and
    ``ops.paged_prefill_int8`` reads it beside the chunk's fresh
    full-precision K/V, dequantizing as it loads, so the reference's
    ``concat(dequant(prefix), chunk)`` is never built; the chunk cache
    comes back quantized (``k``, ``v`` int8, ``k_s``, ``v_s``).
    """
    rope = cfg.pos_kind == "rope"
    hd = cfg.resolved_head_dim
    kv = cfg.num_kv_heads
    b, s, _ = x.shape
    window = cfg.sliding_window if kind == "attn_local" else 0
    q, k, v = _project_qkv(p, cfg, x, positions, rope, kind)

    bs = pool["pos"].shape[-1]
    nb = block_table.shape[1]
    bt = block_table.long()
    ppos = pool["pos"][bt].reshape(b, nb * bs)
    # per-row cursor guard: lanes at/past the row's start are invalid
    # (diverged COW tails AND own-block lanes a later chunk will write)
    sp = torch.as_tensor(start_pos, dtype=torch.int32,
                         device=x.device).reshape(-1, 1)   # (B,1) | (1,1)
    ppos = torch.where(ppos < sp, ppos, -1)

    qpos = _bcast_pos(positions, b, s)             # (B,S) absolute
    if seq_len is not None:
        lanes = torch.arange(s, dtype=torch.int32, device=x.device)
        lane_valid = lanes[None, :] < seq_len.to(torch.int32)[:, None]
        kpos_suffix = torch.where(lane_valid, qpos, -1)   # pad keys never win
    else:
        kpos_suffix = qpos
    kpos_suffix = kpos_suffix.to(torch.int32)
    if cfg.kv_cache_quant:
        pk, pv = (pool[n][bt].reshape(b, nb * bs, kv, hd) for n in "kv")
        ps_k, ps_v = (pool[n][bt].reshape(b, nb * bs, kv)
                      for n in ("k_s", "v_s"))
        out = kernel_ops.paged_prefill_int8(
            q.contiguous(), pk, pv, ps_k, ps_v, ppos,
            k.contiguous(), v.contiguous(), kpos_suffix, qpos,
            window=window)
        return _out_proj(out, p["wo"]), {
            **_quantized_entries(k, v), "pos": kpos_suffix}
    pk = pool["k"][bt].to(k.dtype).reshape(b, nb * bs, kv, hd)
    pv = pool["v"][bt].to(v.dtype).reshape(b, nb * bs, kv, hd)
    k_all = torch.cat([pk, k], dim=1)
    v_all = torch.cat([pv, v], dim=1)
    kpos_all = torch.cat([ppos, kpos_suffix], dim=1).to(torch.int32)

    out = kernel_ops.paged_prefill(q.contiguous(), k_all, v_all, kpos_all,
                                   qpos, window=window)
    y = _out_proj(out, p["wo"])

    return y, {"k": k, "v": v, "pos": kpos_suffix}


# ------------------------------------------------------------- cross-attn
# Whisper's decoder attends the encoder output.  The encoder K/V are
# computed once (at prefill) and kept in the cache as "xk"/"xv".


def cross_kv(p, enc_out):
    """enc_out (B,F,D) -> k, v (B,F,KV,hd).  As in the reference, the
    schema's ``bk``/``bv`` leaves are not added."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return k, v


def _cross_q(p, cfg: ModelConfig, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    return q


def cross_apply(p, cfg: ModelConfig, x, k, v):
    """The reference's cross-attention, in plain PyTorch under autograd
    (training): x (B,S,D) against precomputed k/v (B,F,KV,hd), no mask,
    no RoPE, ``bq`` added; scores in the model dtype, the float32
    ``_softmax``, probabilities cast to v's dtype.  -> (B,S,D)."""
    hd = cfg.resolved_head_dim
    q = _cross_q(p, cfg, x)
    h = q.shape[2]
    k_rep, v_rep = _repeat_kv(k, h), _repeat_kv(v, h)
    sc = _scores(q, k_rep) / math.sqrt(hd)
    probs = _softmax(sc, torch.ones((), dtype=torch.bool, device=x.device))
    return _out_proj(_attn_out(probs.to(v.dtype), v_rep), p["wo"])


def cross_attend(p, cfg: ModelConfig, x, k, v):
    """``cross_apply`` for inference: the same attention through
    ``ops.flash_attention(causal=False)`` over the (B,KV,F,hd) transposed
    views of the cross cache (no copies on the card), Sq = S at prefill
    and 1 at decode.  -> (B,S,D)."""
    return _flash_attend(p, cfg, _cross_q(p, cfg, x), k, v, causal=False)
