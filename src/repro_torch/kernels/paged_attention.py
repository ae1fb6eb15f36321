"""Paged-attention decode as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention``): one-token decode against a block-paged KV pool,
read through each request's block table with an online softmax, GQA,
windows, and zeros for rows with no visible key.  Source:
``csrc/paged_attention.cuh`` (the kernel) with its C entries in
``csrc/paged_attention.cu`` and, for int8 pools,
``csrc/paged_attention_int8.cu`` (compiled apart); semantics:
``ref.paged_attention_ref``.

Bound on an H100: bytes.  A decode step reads each live K/V block once
and does about one float32 FMA per byte of it, far below the ~295
operations per byte at which the tensor cores would bound it; the least
time is the live K/V bytes over 3.35 TB/s.

Design: one CTA of 4 warps per (request, KV head, piece of the block
table) serves the head's H / KV query heads, so a K/V block is read once
per group.  The CTA reads its piece's kpos lanes first and fetches only
chunks of 16 keys with a visible lane, each warp its own chunks through
a two-stage ``cp.async`` ring of 16-byte copies; scores, the online
softmax and the value sum stay in float32 registers.  ``plan`` cuts the
table into pieces where (request, KV head) pairs alone would leave SMs
idle; a split launch runs the pieces of a (request, KV head) as one
thread-block cluster, which merges their float32 partial states over
distributed shared memory (the combine pass; plain version
``ref.attention_combine_ref``).  head_dim 16, 32, 64, 128 or 256 (at
float32 and 256 a lane holds two 16-byte slices of a key and the ring
has one stage), up to 8 query heads per KV head, 16-byte aligned
operands, or it raises.

``paged_attention_int8`` reads an int8 pool (the int8 KV cache) with a
float32 scale per (block, lane, KV head): the same kernel with int8
rings, 16-byte copies of 16 int8 elements and each chunk's 16 scales
beside them; a lane reads its int8 slice of a key or value in one 8-byte
load where the float kernel reads its slice and dequantizes it exactly
as the reference's ``_dequantize_kv`` (int8 times its scale in float32,
rounded to the model dtype) with no conversion instruction: int8 ->
float32 by a byte permute and a subtraction, bf16 rounded two at a time
and widened back as the float kernel unpacks bf16; from there it is
used as the float kernel uses it.  It halves the bytes a decode step
streams.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.kernels import attention_split as split
from repro_torch.kernels.build import CudaKernel, refuse_autograd

MAX_SMEM = 232_448          # bytes of shared memory one CTA may use (H100)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)   # head dims the kernel compiles
MAX_GROUP = 8                   # query heads per KV head it compiles for
MAX_PIECES = 8                  # pieces of a table: a portable cluster

# The planner's makespan model (``attention_split.makespan``) in the time
# one CTA takes to stream one block of one KV head: a CTA's set-up (table
# and kpos reads, the first copy's latency) and write-out, the cluster's
# merge in a split launch, and the CTAs an SM runs at the speed of one
# alone; fit by ``chip_smoke.py:fit_planner`` to an H100's timings of
# this kernel over forced piece lengths (PERF.md).
FIXED_BLOCKS = 15.0
COMBINE_BLOCKS = 11.0
CTAS_PER_SM = 1.5

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "paged_attention", "paged_attention_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _I, _I, _P],
    "paged_attention_smem_bytes", [_I, _I, _I, _I, _I])
# the int8 pools' entry (csrc/paged_attention_int8.cu, the same kernel):
# two scale pointers more
KERNEL_INT8 = CudaKernel(
    "paged_attention_int8", "paged_attention_int8_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _I, _I, _P],
    "paged_attention_int8_smem_bytes", [_I, _I, _I, _I, _I])


@dataclasses.dataclass(frozen=True)
class Plan:
    blocks_per_piece: int
    n_pieces: int

    @property
    def split(self) -> bool:
        return self.n_pieces > 1

    def ctas(self, b: int, kv: int) -> int:
        return b * kv * self.n_pieces


def piece_blocks(nb: int, blocks_per_piece: int, j: int) -> Tuple[int, int]:
    """Logical blocks [lo, hi) of the table that piece ``j`` reads (the
    kernel's ``p_lo``/``p_hi``)."""
    lo = j * blocks_per_piece
    return lo, min(lo + blocks_per_piece, nb)


def plan(b: int, kv: int, nb: int, sms: int) -> Plan:
    """Blocks per piece for ``b`` requests of ``kv`` KV heads over tables
    of ``nb`` blocks on a card of ``sms`` SMs: whole tables where the
    (request, KV head) pairs fill the card; else, in at most
    ``MAX_PIECES`` pieces (one cluster), the piece length that minimises
    the makespan model (ties: fewer pieces) among those whose grid holds
    a CTA for every SM, or among all where none does."""
    nb = max(nb, 1)
    if b * kv >= sms or nb == 1:
        return Plan(nb, 1)
    lengths = range(-(-nb // MAX_PIECES), nb + 1)
    full = [c for c in lengths if b * kv * -(-nb // c) >= sms]
    c = min(full or lengths, key=lambda n: (split.makespan(
        [nb], n, b * kv, sms, fixed=FIXED_BLOCKS, combine=COMBINE_BLOCKS,
        ctas_per_sm=CTAS_PER_SM), -n))
    return Plan(c, -(-nb // c))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def _operands(q, k_pool, v_pool, kpos_pool, block_table, pos, pool_dtype,
              **scales):
    """Check what the kernel takes, else raise; -> (B, H, KV, hd, bs,
    nb)."""
    refuse_autograd("paged_attention", q=q, k_pool=k_pool, v_pool=v_pool)
    _check(q.is_cuda, "q must be a CUDA tensor (CPU tensors take "
           "ops.paged_attention's plain version)")
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("kpos_pool", kpos_pool), ("block_table", block_table),
                    ("pos", pos), *scales.items()):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.is_contiguous(), "q must be contiguous")
    _check(q.dtype in DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k_pool.dtype == pool_dtype and v_pool.dtype == pool_dtype,
           f"k_pool and v_pool must be {pool_dtype} (q is {q.dtype})")
    for name, t in (("kpos_pool", kpos_pool), ("block_table", block_table),
                    ("pos", pos)):
        _check(t.dtype == torch.int32, f"{name} must be int32")
    _check(q.dim() == 3 and k_pool.dim() == 4, "q (B,H,hd), pools (NB,bs,KV,hd)")
    b, h, hd = q.shape
    nbk, bs, kv, hd_k = k_pool.shape
    _check(v_pool.shape == k_pool.shape, "k_pool and v_pool shapes differ")
    for name, t in scales.items():
        _check(t.dtype == torch.float32, f"{name} must be float32")
        _check(tuple(t.shape) == (nbk, bs, kv), f"{name} must be (NB,bs,KV)")
    _check(hd_k == hd, f"head_dim {hd_k} of the pool != {hd} of q")
    _check(hd in HEAD_DIMS, f"head_dim {hd} (the kernel compiles "
           f"{', '.join(map(str, HEAD_DIMS))})")
    _check(kv >= 1 and h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    _check(h // kv <= MAX_GROUP, f"group of {h // kv} query heads per KV "
           f"head (at most {MAX_GROUP})")
    _check(tuple(kpos_pool.shape) == (nbk, bs), "kpos_pool must be (NB,bs)")
    _check(block_table.dim() == 2 and block_table.shape[0] == b,
           "block_table must be (B,nb)")
    _check(tuple(pos.shape) == (b,), "pos must be (B,)")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        _check(t.data_ptr() % 16 == 0,
               f"{name} must start on a 16-byte boundary")
    return b, h, kv, hd, bs, block_table.shape[1]


def _launch(kernel, q, pools, kpos_pool, block_table, pos, window, shape):
    """Plan and launch ``kernel`` (the float or the int8 entry) with the
    pool pointers ``pools``; -> out (B,H,hd)."""
    b, h, kv, hd, bs, nb = shape
    out = torch.empty_like(q)
    if b == 0 or nb == 0:               # no row, or no key to read
        return out.zero_()
    dev = q.device
    smem = kernel.smem_bytes(DTYPE_CODE[q.dtype], h, kv, hd, bs)
    _check(0 < smem <= MAX_SMEM, f"needs {smem} bytes of shared memory")
    pl = plan(b, kv, nb, split.sm_count(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        kernel.launch(DTYPE_CODE[q.dtype], q.data_ptr(),
                      *(t.data_ptr() for t in pools), kpos_pool.data_ptr(),
                      block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                      b, h, kv, hd, bs, nb, int(window),
                      1.0 / math.sqrt(hd), pl.blocks_per_piece, pl.n_pieces,
                      stream)
    return out


def paged_attention(q, k_pool, v_pool, kpos_pool, block_table, pos, *,
                    window: int = 0):
    """q (B,H,hd), k/v pools (NB,bs,KV,hd), kpos_pool (NB,bs) int32,
    block_table (B,nb) int32 (0-padded), pos (B,) int32 -> (B,H,hd), on
    the card.  All-invalid rows return zeros."""
    shape = _operands(q, k_pool, v_pool, kpos_pool, block_table, pos,
                      q.dtype)
    return _launch(KERNEL, q, (k_pool, v_pool), kpos_pool, block_table, pos,
                   window, shape)


def paged_attention_int8(q, k_pool, v_pool, k_scale, v_scale, kpos_pool,
                         block_table, pos, *, window: int = 0):
    """``paged_attention`` over int8 pools (NB,bs,KV,hd) with float32
    scales k_scale / v_scale (NB,bs,KV), on the card: each key and value
    is dequantized as it is read, ``(q * scale)`` in float32 rounded to
    q's dtype (``ref.paged_attention_int8_ref``), then used as the float
    kernel uses a pool element, so the result equals, bit for bit, the
    float kernel's over the dequantized pools."""
    shape = _operands(q, k_pool, v_pool, kpos_pool, block_table, pos,
                      torch.int8, k_scale=k_scale, v_scale=v_scale)
    return _launch(KERNEL_INT8, q, (k_pool, v_pool, k_scale, v_scale),
                   kpos_pool, block_table, pos, window, shape)
