"""The WKV6 recurrence as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv6_scan.py``
(``rwkv6_scan``): per (batch row, head), ``o_t[j] = sum_i r_t[i] (S[i,j]
+ u[i] k_t[i] v_t[j])`` and ``S <- diag(w_t) S + k_t (x) v_t`` from the
state ``s0``.  It carries every rwkv6 layer of the slot engine's
whole-prompt prefill (S = prompt length, one row) and of its decode
step (S = 1, one row per slot).  Source: ``csrc/rwkv6_scan.cu``;
semantics: ``ref.rwkv6_scan_ref``.

Bound on an H100: bytes, at both of the path's shapes (the inputs and the
state read and written once; the source note counts them).

Design: one CTA of 8 warps per (batch row, head, block of 16 value
columns), so a prompt row gets 128 CTAs and a 4-slot decode step 512;
16 threads share a column of the float32 state, 4 rows each in
registers for the whole sequence, and sum each step's output by a
reduce-scatter every 16 steps.  Inputs are staged 32 steps at a time
with 16-byte ``cp.async`` copies, the next chunk in flight while the
current one runs; the state slice is read and written 16 bytes a thread.
Any S >= 1 and any head_dim <= 64; operands are read through element
strides, so the model's ``(B,S,H,hd) -> (B,H,S,hd)`` transposed views go
in without copies, and the output takes r's layout.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, refuse_autograd

MAX_HEAD_DIM = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "rwkv6_scan", "rwkv6_scan_launch",
    [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.POINTER(ctypes.c_longlong), _I,
     _I, _I, _I, _P])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan kernel: {msg}")


def rwkv6_scan(r, k, v, w, u, s0=None):
    """r/k/v/w (B,H,S,hd) float32 (w = decay in (0,1)), u (H,hd), s0
    (B,H,hd,hd) or None (zeros), on the card.  -> (out (B,H,S,hd) in r's
    layout, s_final (B,H,hd,hd) float32)."""
    refuse_autograd("rwkv6_scan", r=r, k=k, v=v, w=w, u=u, s0=s0)
    _check(r.is_cuda, "r must be a CUDA tensor (CPU tensors take "
           "ops.rwkv6_scan's plain version)")
    _check(r.dim() == 4, "r/k/v/w must be (B,H,S,hd)")
    b, h, s, hd = r.shape
    if s0 is None:
        s0 = torch.zeros(b, h, hd, hd, dtype=torch.float32, device=r.device)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0)):
        _check(t.device == r.device, f"{name} is on {t.device}, r on "
               f"{r.device}")
        _check(t.dtype == torch.float32, f"{name} is {t.dtype} (float32 "
               "only)")
    for name, t in (("k", k), ("v", v), ("w", w)):
        _check(t.shape == r.shape, f"{name} {tuple(t.shape)} != r "
               f"{tuple(r.shape)}")
    _check(1 <= hd <= MAX_HEAD_DIM, f"head_dim {hd} (1..{MAX_HEAD_DIM})")
    _check(s >= 1 and b >= 1 and h >= 1, f"empty shape {tuple(r.shape)}")
    _check(u.shape == (h, hd) and u.is_contiguous(),
           f"u must be contiguous (H,hd) = {(h, hd)}")
    _check(s0.shape == (b, h, hd, hd) and s0.is_contiguous(),
           f"s0 must be contiguous (B,H,hd,hd) = {(b, h, hd, hd)}")
    out = torch.empty_like(r)        # r's strides when r is dense
    s_final = torch.empty_like(s0)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("out", out)):
        _check(t.stride(-1) == 1, f"{name} must have head_dim contiguous")
    strides = (ctypes.c_longlong * 15)(
        *(t.stride(i) for t in (r, k, v, w, out) for i in range(3)))
    dev = r.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                      u.data_ptr(), s0.data_ptr(), out.data_ptr(),
                      s_final.data_ptr(), strides, b, h, s, hd, stream)
    return out, s_final
