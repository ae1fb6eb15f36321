"""Paged-attention decode as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/paged_attention.py``
(``paged_attention``): one-token decode against a block-paged KV pool,
read through each request's block table with an online softmax, GQA,
and zeros for rows with no visible key.  Source:
``csrc/paged_attention.cu``; semantics: ``ref.paged_attention_ref``.

Bound on an H100: bytes.  A decode step reads each live K/V block once
and does 4 * hd flops per (query head, key), far below the ~295 flops
per byte at which the tensor cores would bound it; the least time is
the live K/V bytes over 3.35 TB/s.

Design: one CTA per (request, KV head) serves the head's H / KV query
heads, so a K/V block is read once per group; the CTA walks its own
block-table row in a loop, skips blocks with no visible lane, stages
K/V in shared memory as float32 and accumulates in float32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import CudaKernel

MAX_SMEM = 232_448          # bytes of shared memory one CTA may use (H100)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "paged_attention", "paged_attention_launch",
    [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _P],
    "paged_attention_smem_bytes", [_I, _I, _I, _I])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention(q, k_pool, v_pool, kpos_pool, block_table, pos, *,
                    window: int = 0):
    """q (B,H,hd), k/v pools (NB,bs,KV,hd), kpos_pool (NB,bs) int32,
    block_table (B,nb) int32 (0-padded), pos (B,) int32 -> (B,H,hd), on
    the card.  All-invalid rows return zeros."""
    _check(q.is_cuda, "q must be a CUDA tensor (CPU tensors take "
           "ops.paged_attention's plain version)")
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("kpos_pool", kpos_pool), ("block_table", block_table),
                    ("pos", pos)):
        _check(t.device == dev, f"{name} is on {t.device}, q on {dev}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(q.is_contiguous(), "q must be contiguous")
    _check(q.dtype in DTYPE_CODE, f"dtype {q.dtype} (float32 or bfloat16)")
    _check(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
           "q, k_pool and v_pool must share one dtype")
    for name, t in (("kpos_pool", kpos_pool), ("block_table", block_table),
                    ("pos", pos)):
        _check(t.dtype == torch.int32, f"{name} must be int32")
    _check(q.dim() == 3 and k_pool.dim() == 4, "q (B,H,hd), pools (NB,bs,KV,hd)")
    b, h, hd = q.shape
    nbk, bs, kv, hd_k = k_pool.shape
    _check(v_pool.shape == k_pool.shape, "k_pool and v_pool shapes differ")
    _check(hd_k == hd, f"head_dim {hd_k} of the pool != {hd} of q")
    _check(kv >= 1 and h % kv == 0, f"H={h} is not a multiple of KV={kv}")
    _check(tuple(kpos_pool.shape) == (nbk, bs), "kpos_pool must be (NB,bs)")
    _check(block_table.dim() == 2 and block_table.shape[0] == b,
           "block_table must be (B,nb)")
    _check(tuple(pos.shape) == (b,), "pos must be (B,)")
    smem = KERNEL.smem_bytes(h, kv, hd, bs)
    _check(smem <= MAX_SMEM, f"needs {smem} bytes of shared memory")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(),
                      v_pool.data_ptr(), kpos_pool.data_ptr(),
                      block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
                      b, h, kv, hd, bs, block_table.shape[1], int(window),
                      1.0 / math.sqrt(hd), stream)
    return out
