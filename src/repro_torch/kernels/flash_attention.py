"""Whole-prompt attention as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention``): blockwise online-softmax attention, causal,
sliding-window or non-causal, GQA, fully masked key blocks skipped.  It
carries every layer of every slot-engine admission (``attn_prefill``).
Source: ``csrc/flash_attention.cu``; semantics:
``ref.flash_attention_ref``.

Bound on an H100: operations from a few hundred prompt tokens on (a
causal prefill does 4 * hd flops per visible (query head, key), ~S^2/2
keys, against ~S bytes read); bytes below that.

Design: one CTA per (batch row, KV head, tile of query positions, piece
of its key range) serves the head group's H / KV query heads, so a K/V
tile is read once per group, and walks only the keys its queries can
see.  bfloat16 runs on the tensor cores (``csrc/attention_mma.cuh``:
mma.sync with float32 sums, K/V tiles of 64 keys copied into
shared memory, the online softmax in registers), heaviest query tiles
first, key ranges split by ``attention_split.plan`` where the grid
would leave SMs idle; head_dim 16, 32, 64, 128 or 256 (at 256 Q stays
in shared memory, read a fragment at a time, so the accumulator keeps
its registers), 16-byte aligned operands, strides a multiple of 8
elements, or it raises.  float32 keeps the CUDA-core tile
(``attention_tile.cuh``): on the tensor cores float32 means TF32; its
shared memory (q, k padded to hd + 1, v, scores, acc, float32) holds a
tile of at most 64 query vectors at head_dim 256 (206,080 bytes of
232,448), and the wrapper refuses a shape that needs more.  Operands are read through element strides, so the model's
``(B,S,H,hd) -> (B,H,S,hd)`` transposed views go in without copies, and
the output takes q's layout.  Queries that see no key (only when
``Sq > Sk`` with a window) come out 0, where the plain version averages
every key.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import attention_split as split
from repro_torch.kernels.build import CudaKernel, refuse_autograd
from repro_torch.kernels.paged_attention import DTYPE_CODE, MAX_SMEM

ROWS_PER_CTA = 64   # query vectors (positions x group heads) per CTA: at
                    # qwen3-0.6b's group of 2, 32 positions, so a 512-token
                    # prompt gives 16 x 8 KV heads = 128 CTAs, split
                    # further by the planner

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "flash_attention", "flash_attention_launch",
    [_I, _I, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _I, _I, _I,
     _I, _I, _I, _I, _I, ctypes.c_float, _I, _I, _P, _P, _P],
    "flash_attention_smem_bytes", [_I, _I, _I, _I, _I])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,H,Sq,hd), k/v (B,KV,Sk,hd) -> (B,H,Sq,hd), on the card.
    Any strides with head_dim contiguous; the output has q's layout."""
    refuse_autograd("flash_attention", q=q, k=k, v=v)
    _check(q.is_cuda, "q must be a CUDA tensor (CPU tensors take "
           "ops.flash_attention's plain version)")
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
    _check(q.dtype in DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k.dtype == q.dtype and v.dtype == q.dtype,
           "q, k and v must share one dtype")
    _check(q.dim() == 4 and k.dim() == 4, "q (B,H,Sq,hd), k/v (B,KV,Sk,hd)")
    b, h, sq, hd = q.shape
    _, kv, sk, hd_k = k.shape
    _check(v.shape == k.shape and k.shape[0] == b, "k/v must be (B,KV,Sk,hd)")
    _check(hd_k == hd, f"head_dim {hd_k} of k != {hd} of q")
    _check(kv >= 1 and h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    _check(h // kv <= ROWS_PER_CTA, f"group of {h // kv} heads per KV head")
    _check(sq >= 1 and sk >= 1, "needs at least one query and one key")
    _check(window >= 0, f"window={window}")
    out = torch.empty_like(q)        # q's strides when q is dense
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check(t.stride(-1) == 1, f"{name} must have head_dim contiguous")
    tq = min(ROWS_PER_CTA // (h // kv), sq)
    tiles_per_piece = n_pieces = 0      # float32: never split
    scratch = ()
    if q.dtype == torch.bfloat16:
        split.check_mma_operands(_check, hd, q=q, k=k, v=v, out=out)
        pl = plan(b, h, kv, sq, sk, causal, window, split.sm_count(dev))
        tiles_per_piece, n_pieces = pl.tiles_per_piece, pl.n_pieces
        scratch = split.scratch(pl, b * kv, tq * (h // kv), hd, dev)
    smem = KERNEL.smem_bytes(DTYPE_CODE[q.dtype], h, kv, hd, tq)
    _check(smem <= MAX_SMEM, f"needs {smem} bytes of shared memory")
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, out) for i in range(3)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(DTYPE_CODE[q.dtype], int(bool(causal)), q.data_ptr(),
                      k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
                      b, h, kv, sq, sk, hd, tq, int(window),
                      1.0 / math.sqrt(hd), tiles_per_piece, n_pieces,
                      *split.pointers(scratch), stream)
    return out


def plan(b, h, kv, sq, sk, causal, window, sms) -> split.Plan:
    """The key-range split of a bf16 launch on a card of ``sms`` SMs."""
    tq = min(ROWS_PER_CTA // (h // kv), sq)
    return split.plan(split.flash_key_ranges(sq, sk, tq, causal, window),
                      b * kv, sms)
