"""Valid 2-D convolution as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/conv2d.py`` (``conv2d``):
x (B,H,W,Cin) NHWC against w (KH,KW,Cin,Cout) HWIO, valid padding,
stride 1, summed in float32 and stored in x's dtype.  It carries the
conv layer of the digit CNN on every forward pass of the Stratus
pipeline.  Source: ``csrc/conv2d.cu``; semantics: ``ref.conv2d_ref``.

Bound on an H100: bytes.  At the paper's shape each image writes 28x the
bytes it reads (32 output channels of one input channel), and the
operations per byte are far below the float32 ridge.

Design: one CTA per band of output rows (a whole image at the paper's
shape and evaluation's batch), one thread per output element of a row,
output channels fastest; the whole filter and the band's input rows are
staged in shared memory as float32.  Nothing is
padded; operands must be contiguous.  A filter (plus KH input rows) larger
than one CTA's shared memory is refused, with no fallback (the TPU kernel
also holds the whole filter in VMEM).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel

MAX_SMEM = 232_448          # bytes of shared memory one CTA may use (H100)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("conv2d", "conv2d_launch",
                    [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"conv2d kernel: {msg}")


def conv2d(x, w):
    """x (B,H,W,Cin) x w (KH,KW,Cin,Cout) -> (B,H-KH+1,W-KW+1,Cout) in
    x's dtype, valid, stride 1, on the card."""
    _check(x.is_cuda, "x must be a CUDA tensor (CPU tensors take "
           "ops.conv2d's plain version)")
    _check(w.device == x.device, f"w is on {w.device}, x on {x.device}")
    _check(x.dtype in DTYPE_CODE, f"dtype {x.dtype} (float32 or bfloat16)")
    _check(w.dtype == x.dtype, f"w is {w.dtype}, x {x.dtype}")
    _check(x.dim() == 4 and w.dim() == 4,
           "x must be (B,H,W,Cin) and w (KH,KW,Cin,Cout)")
    _check(x.is_contiguous() and w.is_contiguous(),
           "x and w must be contiguous")
    b, h, wd, cin = x.shape
    kh, kw, cin_w, cout = w.shape
    _check(cin_w == cin, f"w has {cin_w} input channels, x {cin}")
    _check(min(b, cin, cout, kh, kw) >= 1,
           f"empty shape x {tuple(x.shape)} w {tuple(w.shape)}")
    _check(kh <= h and kw <= wd, f"filter {kh}x{kw} larger than the "
           f"{h}x{wd} image")
    smem = (kh * kw * cin * cout + kh * wd * cin) * 4
    _check(smem <= MAX_SMEM, f"the filter and {kh} input rows need {smem} "
           f"bytes of shared memory as float32; one CTA may use {MAX_SMEM}")
    out = torch.empty(b, h - kh + 1, wd - kw + 1, cout, dtype=x.dtype,
                      device=x.device)
    dev = x.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                      out.data_ptr(), b, h, wd, cin, kh, kw, cout, stream)
    return out
