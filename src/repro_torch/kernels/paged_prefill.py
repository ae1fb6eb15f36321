"""Ragged chunked-prefill attention as a hand-written CUDA kernel.

Replaces ``repro/kernels/ops.py:paged_prefill``, which has no Pallas
kernel (both of its arms run the reference): the attention of every
default serving-engine step.  Source: ``csrc/paged_prefill.cu``;
semantics: ``ref.paged_prefill_ref``, over the keys the caller has
already assembled (gathered prefix, then the chunk).

Bound on an H100: bytes at decode and small-chunk sizes (q, k, v and
the positions read once, the output written once, over 3.35 TB/s); a
chunk of a few hundred tokens per row crosses into the operation bound.

Design: one CTA per (row, KV head, tile of query lanes, piece of the key
lanes) serves that head group's query vectors, walks key tiles with an
online softmax, and skips tiles no query of the tile can see (null-block
padding, future keys).  bfloat16 runs on the tensor cores
(``csrc/attention_mma.cuh``: mma.sync with float32 sums, 64-key K/V tiles
in shared memory, the softmax in registers; with 16 rows
or fewer the four warps split each tile's keys); the key lanes are split
by ``attention_split.plan`` where the grid would leave SMs idle (decode
steps: 8 rows x 8 KV heads, or 4 slots x 8); head_dim 16, 32, 64, 128
or 256 (at 256 Q stays in shared memory) and 16-byte aligned operands,
or it raises.  float32 keeps the CUDA-core tile (``attention_tile.cuh``;
at head_dim 256 a tile of 64 query vectors takes 206,080 bytes of
shared memory, within the 232,448 a CTA may use).  Query lanes with no visible key come out
0, where the plain version averages every key; the engine discards such
lanes (padding), so comparisons hold valid lanes only.

``paged_prefill_int8`` serves the int8 KV cache: its keys come in two
segments, the gathered int8 prefix with its float32 scales and the
chunk's own K/V in the model dtype (the reference attends the chunk's
fresh keys), so neither a dequantized copy of the prefix nor the
concatenation is made.  The tile loader picks a key's segment by its
index (a 64-key tile may straddle the boundary: the prefix is a
multiple of the block size, not of 64 keys).  The bf16 tile stages a
tile's int8 rows and scales in shared memory with 16-byte copies,
double-buffered (the next tile's rows land while this one's Q.K^T and
softmax run), and converts each prefix row once into the bf16 tile
inside the two barriers a tile the bf16 launch has; the float32 tile
converts as it loads.  Bound: bytes,
at half the prefix's bytes of the float launch.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import attention_split as split
from repro_torch.kernels.build import CudaKernel, refuse_autograd
from repro_torch.kernels.paged_attention import DTYPE_CODE, MAX_SMEM

ROWS_PER_CTA = 64           # query vectors (lanes x group heads) per CTA

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "paged_prefill", "paged_prefill_launch",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _I, _I, _P, _P, _P],
    "paged_prefill_smem_bytes", [_I, _I, _I, _I, _I])
# the int8-prefix entry of the same library: the prefix's int8 k, v,
# float32 scales and kpos before the chunk's k, v, kpos; Lp before Lc
KERNEL_INT8 = CudaKernel(
    "paged_prefill", "paged_prefill_int8_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
     _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P],
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
    b, s, h, kv, hd = _operands(q, qpos, (k, v, kpos))
    l = k.shape[1]
    return _launch(KERNEL, q, qpos, (k, v, kpos), (), b, s, 0, l, h, kv, hd,
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
    return _launch(KERNEL_INT8, q, qpos, (k, v, kpos),
                   (k_prefix, v_prefix, k_scale, v_scale, kpos_prefix),
                   b, s, lp, lc, h, kv, hd, window)


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


def _launch(kernel, q, qpos, chunk, prefix, b, s, lp, lc, h, kv, hd,
            window):
    """Plan and launch ``kernel`` over the chunk segment (k, v, kpos) and,
    for the int8 entry, the prefix (k, v, k_scale, v_scale, kpos)."""
    dev = q.device
    # query lanes per CTA: up to ROWS_PER_CTA query vectors, never more
    # lanes than the chunk has (fused decode rows are S = 1)
    tq = min(ROWS_PER_CTA // (h // kv), s)
    out = torch.empty_like(q)
    tiles_per_piece = n_pieces = 0      # float32: never split
    scratch = ()
    quant = bool(prefix)
    if q.dtype == torch.bfloat16:
        ops16 = dict(q=q, out=out)
        if lc:
            ops16.update(k=chunk[0], v=chunk[1])
        split.check_mma_operands(_check, hd, **ops16)
        if quant and lp:
            split.check_int8_operands(_check, k_prefix=prefix[0],
                                      v_prefix=prefix[1])
        pl = plan(b, s, lp + lc, h, kv, split.sm_count(dev))
        tiles_per_piece, n_pieces = pl.tiles_per_piece, pl.n_pieces
        scratch = split.scratch(pl, b * kv, tq * (h // kv), hd, dev)
    smem = kernel.smem_bytes(DTYPE_CODE[q.dtype], h, kv, hd, tq)
    _check(smem <= MAX_SMEM, f"needs {smem} bytes of shared memory")
    # an empty segment is never read: hand the kernel q's address for it
    ptrs = [t.data_ptr() if t.numel() else q.data_ptr()
            for t in (*prefix, *chunk)]
    sizes = (lp, lc) if quant else (lc,)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        kernel.launch(DTYPE_CODE[q.dtype], q.data_ptr(), *ptrs,
                      qpos.data_ptr(), out.data_ptr(), b, s, *sizes, h, kv,
                      hd, tq, int(window), 1.0 / math.sqrt(hd),
                      tiles_per_piece, n_pieces, *split.pointers(scratch),
                      stream)
    return out


def plan(b, s, l, h, kv, sms) -> split.Plan:
    """The key-range split of a bf16 launch on a card of ``sms`` SMs."""
    tq = min(ROWS_PER_CTA // (h // kv), s)
    return split.plan(split.paged_key_ranges(s, l, tq), b * kv, sms)
