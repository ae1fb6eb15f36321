"""Ragged chunked-prefill attention as a hand-written CUDA kernel.

Replaces ``repro/kernels/ops.py:paged_prefill``, which has no Pallas
kernel (both of its arms run the reference): the attention of every
default serving-engine step.  Source: ``csrc/paged_prefill.cuh`` (the
launcher; the bf16 tiles in ``attention_paged_wgmma.cuh`` and
``attention_mma.cuh``) with its C entries in ``csrc/paged_prefill.cu``
and, for an int8 prefix, ``csrc/paged_prefill_int8.cu`` (compiled
apart); semantics: ``ref.paged_prefill_ref``.

Two ways in.  ``paged_prefill_pool`` (and ``paged_prefill_pool_int8``)
serve the paged engine: the prefix is read straight out of the block
pool through the dispatch's block table, key ``j < nb * bs`` of row
``b`` at pool row ``(block_table[b, j // bs], j % bs)``, its position -1
unless below the row's cursor ``start_pos[b]``; the chunk's fresh K/V
follow as a second, contiguous segment.  So no gathered copy of the pool
and no concatenation is made: the plain versions
``ref.paged_prefill_pool_ref`` / ``paged_prefill_pool_int8_ref`` build
both, and the kernel equals them over those keys bit for bit (same
shape, plan and dtype): the tiles are those of the concatenated keys,
and a tile is skipped from the guarded positions it reads through the
table, as over gathered keys.  ``paged_prefill`` (and
``paged_prefill_int8``) take keys already contiguous: the slot decode's
strip, and the tests.

Bound on an H100: bytes at decode and small-chunk sizes (q, the chunk's
k and v, the prefix rows some query sees and the positions read once,
the output written once, over 3.35 TB/s); a chunk of a few hundred
tokens per row crosses into the operation bound.

Design: one CTA per (row, KV head, tile of query lanes, piece of the key
lanes) serves that head group's query vectors, walks 64-key tiles with
an online softmax, and skips tiles no query of the tile can see
(null-block padding, future keys).  bfloat16 runs on the tensor cores
in one of two tiles, chosen by the query rows a CTA serves (``tq * g``,
``warp_keys_tile``): more than ``WARP_KEYS_ROWS`` (chunks and verify
windows) take the Hopper tile (``csrc/attention_paged_wgmma.cuh``: a
producer warpgroup looks each tile's keys up through the table, tests
their positions and copies the live tiles' rows with 16-byte cp.async
into a ring of swizzled K/V slots under mbarriers; a consumer warpgroup
runs Q.K^T and P.V on wgmma with P rounded once to bf16, the softmax in
registers); up to 16 (decode: S = 1) keep the kWarpKeys mma.sync tile
(``csrc/attention_mma.cuh``: the four warps split each tile's keys,
where a wgmma M of 64 would waste 48 rows).  The key lanes are split by
``attention_split.plan``, with each tile's makespan constants, where
the grid would leave SMs idle (decode steps: 8 rows x 8 KV heads, or 4
slots x 8); head_dim 16, 32, 64, 128 or 256 and 16-byte aligned
operands, or it raises.  float32 keeps the CUDA-core tile
(``attention_tile.cuh``; at head_dim 256 a tile of 64 query vectors
takes 206,080 bytes of shared memory, within the 232,448 a CTA may
use).  Query lanes with no visible key come out 0, where the plain
version averages every key; the engine discards such lanes (padding),
so comparisons hold valid lanes only.

``paged_prefill_pool_int8`` serves the int8 KV cache: its keys come in
two segments, the int8 pool's rows with their float32 scales and the
chunk's own K/V in the model dtype (the reference attends the chunk's
fresh keys), so neither a dequantized copy of the prefix nor the
concatenation is made (``paged_prefill_int8``: an int8 strip, the slot
decode's).  A 64-key tile may straddle the boundary (the prefix is a
multiple of the block size, not of 64 keys).  The Hopper tile's producer
copies a prefix key's int8 chunk into the bf16 slot it will fill and
converts it there (int8 times its scale in float32, rounded to bf16)
before the consumer sees the slot; the decode tile stages int8 rows
double-buffered and converts each row once inside its own barriers; the
float32 tile converts as it loads.  Each launch equals, bit for bit,
the bf16 launch over the dequantized keys.  Bound: bytes, at half the
prefix's bytes of the float launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import attention_split as split
from repro_torch.kernels.build import CudaKernel, refuse_autograd
from repro_torch.kernels.paged_attention import DTYPE_CODE, MAX_SMEM

ROWS_PER_CTA = 64           # query vectors (lanes x group heads) per CTA
WARP_KEYS_ROWS = 16         # bf16: up to this many a CTA, the decode tile
# bf16 launches of the four entries by the tile they ran: the kWarpKeys
# mma.sync tile ("mma") or the Hopper tile ("wgmma"); grown where a launch
# is made, beside the entries' own counts, and reset by the caller
TILE_LAUNCHES = {"mma": 0, "wgmma": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "paged_prefill", "paged_prefill_launch",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _I, _I, _P, _P, _P],
    "paged_prefill_smem_bytes", [_I, _I, _I, _I, _I])
# the int8 prefix's entry (csrc/paged_prefill_int8.cu, the same
# launcher): the prefix's int8 k, v,
# float32 scales and kpos before the chunk's k, v, kpos; Lp before Lc
KERNEL_INT8 = CudaKernel(
    "paged_prefill_int8", "paged_prefill_int8_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P],
    "paged_prefill_int8_smem_bytes", [_I, _I, _I, _I, _I])
# the engine's entries, reading the prefix from the block pool: k_pool,
# v_pool (int8: and their scales), pos_pool, block_table, the cursors
# (a pointer, or null and one cursor for every row), nb, bs, then the
# chunk as in KERNEL
KERNEL_POOL = CudaKernel(
    "paged_prefill", "paged_prefill_pool_launch",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
     _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P],
    "paged_prefill_smem_bytes", [_I, _I, _I, _I, _I])
KERNEL_POOL_INT8 = CudaKernel(
    "paged_prefill_int8", "paged_prefill_pool_int8_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
     _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P],
    "paged_prefill_int8_smem_bytes", [_I, _I, _I, _I, _I])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_prefill kernel: {msg}")


def paged_prefill(q, k, v, kpos, qpos, *, window: int = 0):
    """q (B,S,H,hd), k/v (B,L,KV,hd), kpos (B,L) int32, qpos (B,S) int32
    -> (B,S,H,hd), on the card."""
    refuse_autograd("paged_prefill", q=q, k=k, v=v)
    _check(q.is_cuda, "q must be a CUDA tensor (CPU tensors take "
           "ops.paged_prefill's plain version)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _operands(q, qpos, (k, v, kpos))
    return _launch(KERNEL, q, qpos, (k, v, kpos), (), (k.shape[1],), 0,
                   window)


def paged_prefill_int8(q, k_prefix, v_prefix, k_scale, v_scale, kpos_prefix,
                       k, v, kpos, qpos, *, window: int = 0):
    """Two key segments, on the card: the gathered int8 prefix k/v_prefix
    (B,Lp,KV,hd) with float32 scales (B,Lp,KV) and kpos_prefix (B,Lp),
    then the chunk's k/v (B,Lc,KV,hd) in q's dtype with kpos (B,Lc) (Lc
    may be 0: a slot decode reads its whole int8 strip as the prefix).
    Keys are lanes [0, Lp) of the prefix, then the chunk's, as the plain
    version's ``concat(dequant(prefix), chunk)``; a prefix key or value
    is dequantized as it is loaded (int8 times its scale in float32,
    rounded to q's dtype) and used as the float kernel uses a key, so the
    result equals, bit for bit, ``paged_prefill`` over the concatenated
    dequantized keys (same shape, plan and dtype)."""
    refuse_autograd("paged_prefill", q=q, k=k, v=v)
    _check(q.is_cuda, "q must be a CUDA tensor (CPU tensors take "
           "ops.paged_prefill_int8's plain version)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q and the chunk's k and v must share one dtype")
    _check(k_prefix.dtype == torch.int8 and v_prefix.dtype == torch.int8,
           "the prefix k and v must be int8")
    _check(k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
           "the prefix scales must be float32")
    b, s, h, kv, hd = _operands(q, qpos, (k, v, kpos),
                                (k_prefix, v_prefix, kpos_prefix))
    lp, lc = k_prefix.shape[1], k.shape[1]
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(t.device == q.device and t.is_contiguous(),
               f"{name} must be contiguous on {q.device}")
        _check(tuple(t.shape) == (b, lp, kv), f"{name} must be (B,Lp,KV)")
    if q.dtype == torch.bfloat16 and lp:
        split.check_int8_operands(_check, k_prefix=k_prefix,
                                  v_prefix=v_prefix)
    lead = [_ptr(t, q) for t in (k_prefix, v_prefix, k_scale, v_scale,
                                 kpos_prefix)]
    return _launch(KERNEL_INT8, q, qpos, (k, v, kpos), lead, (lp, lc), lp,
                   window)


def paged_prefill_pool(q, k_pool, v_pool, pos_pool, block_table, start_pos,
                       k, v, kpos, qpos, *, window: int = 0):
    """The paged engine's attention, on the card: q (B,S,H,hd) against
    the prefix read from the pool k_pool / v_pool (NB,bs,KV,hd) in q's
    dtype with positions pos_pool (NB,bs) int32 through block_table
    (B,nb) int32 (key ``j`` of row ``b`` at pool row ``(block_table[b, j
    // bs], j % bs)``, its position -1 unless below ``start_pos``: a
    Python int, or (B,) int32 per-row cursors), then the chunk's k/v
    (B,Lc,KV,hd) with kpos (B,Lc) -> (B,S,H,hd).  Equals, bit for bit,
    ``paged_prefill`` over the gathered, guarded and concatenated keys
    (``ref.paged_prefill_pool_ref`` builds them)."""
    refuse_autograd("paged_prefill", q=q, k=k, v=v, k_pool=k_pool,
                    v_pool=v_pool)
    _check(q.is_cuda, "q must be a CUDA tensor (CPU tensors take "
           "ops.paged_prefill_pool's plain version)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q and the chunk's k and v must share one dtype")
    _check(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
           f"k_pool and v_pool must be q's dtype {q.dtype} (an int8 pool "
           "is read by paged_prefill_pool_int8)")
    kv = _operands(q, qpos, (k, v, kpos))[3]
    lead, lp = _pool_args(q, kv, (k_pool, v_pool), (), pos_pool,
                          block_table, start_pos)
    if q.dtype == torch.bfloat16 and lp:
        split.check_mma_operands(_check, q.shape[3], k_pool=k_pool,
                                 v_pool=v_pool)
    return _launch(KERNEL_POOL, q, qpos, (k, v, kpos), lead, (k.shape[1],),
                   lp, window)


def paged_prefill_pool_int8(q, k_pool, v_pool, k_scale_pool, v_scale_pool,
                            pos_pool, block_table, start_pos, k, v, kpos,
                            qpos, *, window: int = 0):
    """``paged_prefill_pool`` over the int8 pool k_pool / v_pool
    (NB,bs,KV,hd) with float32 scales (NB,bs,KV), each prefix key or
    value dequantized to q's dtype as it is loaded: equals, bit for bit,
    ``paged_prefill`` over the gathered, dequantized, guarded and
    concatenated keys."""
    refuse_autograd("paged_prefill", q=q, k=k, v=v)
    _check(q.is_cuda, "q must be a CUDA tensor (CPU tensors take "
           "ops.paged_prefill_pool_int8's plain version)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q and the chunk's k and v must share one dtype")
    _check(k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8,
           "k_pool and v_pool must be int8")
    _check(k_scale_pool.dtype == torch.float32
           and v_scale_pool.dtype == torch.float32,
           "the pool's scales must be float32")
    kv = _operands(q, qpos, (k, v, kpos))[3]
    lead, lp = _pool_args(q, kv, (k_pool, v_pool),
                          (k_scale_pool, v_scale_pool), pos_pool,
                          block_table, start_pos)
    if q.dtype == torch.bfloat16 and lp:
        split.check_int8_operands(_check, k_pool=k_pool, v_pool=v_pool)
    return _launch(KERNEL_POOL_INT8, q, qpos, (k, v, kpos), lead,
                   (k.shape[1],), lp, window)


def _ptr(t, q) -> int:
    """An operand's address; an empty one is never read: q's address."""
    return t.data_ptr() if t.numel() else q.data_ptr()


def _pool_args(q, kv, pools, scales, pos_pool, block_table, start_pos):
    """Check a pool prefix (k/v pools (NB,bs,KV,hd) of the chunk's ``kv``
    heads, their scales (NB,bs,KV), pos_pool (NB,bs), block_table (B,nb),
    start_pos an int or (B,) int32), else raise; -> (its C arguments, Lp
    = nb * bs)."""
    dev = q.device
    b, hd = q.shape[0], q.shape[3]
    named = [("k_pool", pools[0]), ("v_pool", pools[1])]
    named += list(zip(("k_scale_pool", "v_scale_pool"), scales))
    named += [("pos_pool", pos_pool), ("block_table", block_table)]
    for name, t in named:
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    k_pool, v_pool = pools
    _check(k_pool.dim() == 4 and v_pool.shape == k_pool.shape,
           "k_pool/v_pool must be (NB,bs,KV,hd)")
    n_blocks, bs = k_pool.shape[:2]
    _check(tuple(k_pool.shape[2:]) == (kv, hd),
           f"the pool's (KV, hd) {tuple(k_pool.shape[2:])} != the chunk's "
           f"{(kv, hd)}")
    for name, t in zip(("k_scale_pool", "v_scale_pool"), scales):
        _check(tuple(t.shape) == (n_blocks, bs, kv),
               f"{name} must be (NB,bs,KV)")
    _check(bs >= 1, "the pool's blocks must hold a lane at least")
    _check(pos_pool.dtype == torch.int32
           and tuple(pos_pool.shape) == (n_blocks, bs),
           "pos_pool must be (NB,bs) int32")
    _check(block_table.dtype == torch.int32 and block_table.dim() == 2
           and block_table.shape[0] == b, "block_table must be (B,nb) int32")
    nb = block_table.shape[1]
    if isinstance(start_pos, torch.Tensor):
        _check(start_pos.device == dev and start_pos.dtype == torch.int32
               and tuple(start_pos.shape) == (b,)
               and start_pos.is_contiguous(),
               f"start_pos must be a Python int or a contiguous (B,) int32 "
               f"tensor on {dev}")
        start = (start_pos.data_ptr(), 0)
    else:
        _check(isinstance(start_pos, int)
               and -2 ** 31 <= start_pos < 2 ** 31,
               "start_pos must be a Python int or a (B,) int32 tensor")
        start = (None, start_pos)
    lead = [_ptr(t, q) for t in (*pools, *scales, pos_pool, block_table)]
    return lead + [*start, nb, bs], nb * bs


def _operands(q, qpos, *segments):
    """Check q, qpos and each key segment (k, v, kpos), else raise;
    -> (B, S, H, KV, hd)."""
    dev = q.device
    named = [("q", q), ("qpos", qpos)] + [
        (f"{n}{'' if i == 0 else '_prefix'}", t)
        for i, seg in enumerate(segments)
        for n, t in zip(("k", "v", "kpos"), seg)]
    for name, t in named:
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dtype in DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(q.dim() == 4, "q (B,S,H,hd)")
    b, s, h, hd = q.shape
    _check(qpos.dtype == torch.int32 and tuple(qpos.shape) == (b, s),
           "qpos must be (B,S) int32")
    kv = segments[0][0].shape[2] if segments[0][0].dim() == 4 else 0
    for k, v, kpos in segments:
        _check(k.dim() == 4 and v.shape == k.shape and k.shape[0] == b
               and k.shape[2] == kv, "k/v must be (B,L,KV,hd)")
        _check(k.shape[3] == hd, f"head_dim {k.shape[3]} of k != {hd} of q")
        _check(kpos.dtype == torch.int32
               and tuple(kpos.shape) == (b, k.shape[1]),
               "kpos must be (B,L) int32")
    _check(kv >= 1 and h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    _check(h // kv <= ROWS_PER_CTA, f"group of {h // kv} heads per KV head")
    _check(s >= 1, "needs at least one query lane")
    return b, s, h, kv, hd


def _launch(kernel, q, qpos, chunk, lead, sizes, lp, window):
    """Plan and launch ``kernel``: ``lead`` the C arguments of its prefix
    (none for ``paged_prefill``), then the chunk segment (k, v, kpos),
    qpos, out, B, S, ``sizes`` (the prefix's and the chunk's key counts,
    or the chunk's alone), the rest; the split is planned over ``lp``
    prefix keys and the chunk's."""
    dev = q.device
    b, s, h, hd = q.shape
    kv = chunk[0].shape[2]
    lc = chunk[0].shape[1]
    # query lanes per CTA: up to ROWS_PER_CTA query vectors, never more
    # lanes than the chunk has (fused decode rows are S = 1)
    tq = min(ROWS_PER_CTA // (h // kv), s)
    out = torch.empty_like(q)
    tiles_per_piece = n_pieces = 0      # float32: never split
    scratch = ()
    if q.dtype == torch.bfloat16:
        ops16 = dict(q=q, out=out)
        if lc:
            ops16.update(k=chunk[0], v=chunk[1])
        split.check_mma_operands(_check, hd, **ops16)
        pl = plan(b, s, lp + lc, h, kv, split.sm_count(dev))
        tiles_per_piece, n_pieces = pl.tiles_per_piece, pl.n_pieces
        scratch = split.scratch(pl, b * kv, tq * (h // kv), hd, dev)
    smem = kernel.smem_bytes(DTYPE_CODE[q.dtype], h, kv, hd, tq)
    _check(smem <= MAX_SMEM, f"needs {smem} bytes of shared memory")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        kernel.launch(DTYPE_CODE[q.dtype], q.data_ptr(), *lead,
                      *(_ptr(t, q) for t in chunk), qpos.data_ptr(),
                      out.data_ptr(), b, s, *sizes, h, kv, hd, tq,
                      int(window), 1.0 / math.sqrt(hd), tiles_per_piece,
                      n_pieces, *split.pointers(scratch), stream)
    if q.dtype == torch.bfloat16:
        TILE_LAUNCHES["mma" if warp_keys_tile(s, h, kv) else "wgmma"] += 1
    return out


def warp_keys_tile(s, h, kv) -> bool:
    """Whether a bf16 launch of ``s`` query lanes at ``h`` / ``kv`` heads
    runs the kWarpKeys mma.sync tile (at most ``WARP_KEYS_ROWS`` query
    rows a CTA: the decode shapes) rather than the Hopper tile
    (``csrc/paged_prefill.cuh``'s ``warp_keys_tile``)."""
    return min(ROWS_PER_CTA // (h // kv), s) * (h // kv) <= WARP_KEYS_ROWS


def plan(b, s, l, h, kv, sms) -> split.Plan:
    """The key-range split of a bf16 launch on a card of ``sms`` SMs,
    with the makespan constants of the tile the launch runs."""
    tq = min(ROWS_PER_CTA // (h // kv), s)
    ranges = split.paged_key_ranges(s, l, tq)
    if warp_keys_tile(s, h, kv):
        return split.plan(ranges, b * kv, sms)
    return split.plan(ranges, b * kv, sms, fixed=split.PAGED_FIXED_TILES,
                      combine=split.PAGED_COMBINE_TILES,
                      ctas_per_sm=split.PAGED_CTAS_PER_SM)
