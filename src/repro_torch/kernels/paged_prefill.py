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


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_prefill kernel: {msg}")


def paged_prefill(q, k, v, kpos, qpos, *, window: int = 0):
    """q (B,S,H,hd), k/v (B,L,KV,hd), kpos (B,L) int32, qpos (B,S) int32
    -> (B,S,H,hd), on the card."""
    refuse_autograd("paged_prefill", q=q, k=k, v=v)
    _check(q.is_cuda, "q must be a CUDA tensor (CPU tensors take "
           "ops.paged_prefill's plain version)")
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("kpos", kpos),
                    ("qpos", qpos)):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.dtype in DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _check(kpos.dtype == torch.int32 and qpos.dtype == torch.int32,
           "kpos and qpos must be int32")
    _check(q.dim() == 4 and k.dim() == 4, "q (B,S,H,hd), k/v (B,L,KV,hd)")
    b, s, h, hd = q.shape
    _, l, kv, hd_k = k.shape
    _check(v.shape == k.shape and k.shape[0] == b, "k/v must be (B,L,KV,hd)")
    _check(hd_k == hd, f"head_dim {hd_k} of k != {hd} of q")
    _check(kv >= 1 and h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    _check(h // kv <= ROWS_PER_CTA, f"group of {h // kv} heads per KV head")
    _check(tuple(kpos.shape) == (b, l), "kpos must be (B,L)")
    _check(tuple(qpos.shape) == (b, s), "qpos must be (B,S)")
    _check(s >= 1, "needs at least one query lane")
    # query lanes per CTA: up to ROWS_PER_CTA query vectors, never more
    # lanes than the chunk has (fused decode rows are S = 1)
    tq = min(ROWS_PER_CTA // (h // kv), s)
    out = torch.empty_like(q)
    tiles_per_piece = n_pieces = 0      # float32: never split
    scratch = ()
    if q.dtype == torch.bfloat16:
        split.check_mma_operands(_check, hd, q=q, k=k, v=v, out=out)
        pl = plan(b, s, l, h, kv, split.sm_count(dev))
        tiles_per_piece, n_pieces = pl.tiles_per_piece, pl.n_pieces
        scratch = split.scratch(pl, b * kv, tq * (h // kv), hd, dev)
    smem = KERNEL.smem_bytes(DTYPE_CODE[q.dtype], h, kv, hd, tq)
    _check(smem <= MAX_SMEM, f"needs {smem} bytes of shared memory")
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), kpos.data_ptr(), qpos.data_ptr(),
                      out.data_ptr(), b, s, l, h, kv, hd, tq, int(window),
                      1.0 / math.sqrt(hd), tiles_per_piece, n_pieces,
                      *split.pointers(scratch), stream)
    return out


def plan(b, s, l, h, kv, sms) -> split.Plan:
    """The key-range split of a bf16 launch on a card of ``sms`` SMs."""
    tq = min(ROWS_PER_CTA // (h // kv), s)
    return split.plan(split.paged_key_ranges(s, l, tq), b * kv, sms)
