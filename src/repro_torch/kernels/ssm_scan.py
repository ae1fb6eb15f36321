"""Mamba's selective scan as a hand-written CUDA kernel for Hopper.

The reference runs the recurrence as a ``jax.lax.scan`` outside any
Pallas kernel (``repro/models/ssm.py:ssm_forward``); here it is one
launch per mamba layer and dispatch: per (batch row, channel),
``h <- exp(dt a) h + (dt x) B`` and ``y = h . C`` from the state ``h0``.
It carries every mamba layer of both engines: ragged chunks and decode
steps of the paged engine, whole prompts and decode steps of the slot
engine.  Source: ``csrc/ssm_scan.cu``; semantics: ``ref.ssm_scan_ref``.

Bound on an H100: bytes, at both of the path's shapes (dt, x and y
stream once; the state is read and written once; the source note counts
them).

Design: one thread per (row, channel) with its 16 states in registers
for the whole sequence, 128 channels a CTA, each step's B and C staged
in shared memory for the CTA 32 steps at a time.  The kernel takes no
sequence length: the masked route sets ``dt`` to 0 past a row's valid
lanes, which carries its state through exactly.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, refuse_autograd

STATE_DIM = 16

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("ssm_scan", "ssm_scan_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssm_scan kernel: {msg}")


def ssm_scan(dt, bm, cm, x, a, h0):
    """dt / x (B,S,di), bm / cm (B,S,N), a (di,N), h0 (B,di,N), all
    contiguous float32 on the card, N = 16.  -> (y (B,S,di), h_final
    (B,di,N)) float32."""
    refuse_autograd("ssm_scan", dt=dt, bm=bm, cm=cm, x=x, a=a, h0=h0)
    _check(dt.is_cuda, "dt must be a CUDA tensor (CPU tensors take "
           "ops.ssm_scan's plain version)")
    _check(dt.dim() == 3, "dt must be (B,S,di)")
    b, s, di = dt.shape
    n = a.shape[-1]
    _check(n == STATE_DIM, f"state size {n} (the kernel takes "
           f"{STATE_DIM})")
    want = {"dt": (b, s, di), "x": (b, s, di), "bm": (b, s, n),
            "cm": (b, s, n), "a": (di, n), "h0": (b, di, n)}
    for name, t in (("dt", dt), ("bm", bm), ("cm", cm), ("x", x), ("a", a),
                    ("h0", h0)):
        _check(t.device == dt.device, f"{name} is on {t.device}, dt on "
               f"{dt.device}")
        _check(t.dtype == torch.float32, f"{name} is {t.dtype} (float32 "
               "only)")
        _check(tuple(t.shape) == want[name], f"{name} {tuple(t.shape)} != "
               f"{want[name]}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(1 <= b <= 65535 and s >= 1 and di >= 1,
           f"shape {(b, s, di)} (1..65,535 rows, S >= 1)")
    y = torch.empty_like(dt)
    h_final = torch.empty_like(h0)
    dev = dt.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                      x.data_ptr(), a.data_ptr(), h0.data_ptr(),
                      y.data_ptr(), h_final.data_ptr(), b, s, di, n, stream)
    return y, h_final
