"""The filter gradient of the valid 2-D convolution, as a hand-written
CUDA kernel for Hopper.

x (B,H,W,Cin) NHWC and dy (B,H-KH+1,W-KW+1,Cout) -> dw (KH,KW,Cin,Cout)
= the sum over images and output pixels of ``x[b, y+i, x'+j, ci] *
dy[b, y, x', co]``, summed in float32 and stored in x's dtype.  It
carries the conv layer's weight gradient on every backward pass of the
digit CNN's training (``ops.conv2d``'s autograd Function).  The TPU side
has no kernel for it (``pallas_call``): the reference trains through
``lax.conv`` and its transpose (``repro/models/cnn.py:37-46``).  Source:
``csrc/conv2d_wgrad.cu``; semantics: ``ref.conv2d_wgrad_ref``.

Bound on an H100: bytes.  dy is the large operand (at the paper's B=64,
5.5 MB against 0.2 MB of images and 1.2 KB of filter gradient), and the
operations per byte are far below the float32 ridge.

Design, simple first: pass 1 runs ``ctas`` CTAs, each over a contiguous
range of (image, output row) pairs (``Plan.cta_rows``), staging
``group`` pairs at a time (their KH input rows and their dy row, as
float32) in shared memory; each thread accumulates ``per`` of the
KH*KW*Cin*Cout outputs in registers and the CTA writes one float32
partial of them to a workspace.  Pass 2 sums the partials in a fixed
order.  No atomics, so two launches on the same inputs give the same
bits.  ``plan`` is pure Python over the shapes and the SM count, so the
CPU tests reach it; the launcher validates it.  Nothing is padded;
operands must be contiguous; a filter gradient of more than
``MAX_THREADS * MAX_PER`` outputs, or a pair past one CTA's shared
memory, is refused, with no fallback.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import attention_split
from repro_torch.kernels.build import CudaKernel, refuse_autograd

MAX_SMEM = 232_448          # bytes of shared memory one CTA may use (H100)
MAX_THREADS = 512           # pass 1's launch bound
MAX_PER = 8                 # outputs one thread accumulates (registers)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CTAS_PER_SM = 2             # pass-1 CTAs (partials) per SM
GROUP = 8                   # (image, output row) pairs staged at once

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("conv2d_wgrad", "conv2d_wgrad_launch",
                    [_I, _P, _P, _P, _P] + [_I] * 7   # dtype, x, dy, part,
                                                      # dw, shape
                    + [_I] * 5 + [_P])                # the plan, stream


@dataclasses.dataclass(frozen=True)
class Plan:
    """Pass 1: ``ctas`` CTAs of ``threads``, CTA c over the pairs
    ``cta_rows(c)`` of the ``rows`` = B x H' (image, output row) pairs,
    ``group`` pairs staged at a time in ``smem_bytes`` of shared memory;
    thread t accumulates outputs t, t + threads, ... (``per`` of them).
    Pass 2 sums the ``ctas`` partials."""
    rows: int
    ctas: int
    group: int
    threads: int
    per: int
    smem_bytes: int

    def cta_rows(self, cta: int) -> range:
        return range(cta * self.rows // self.ctas,
                     (cta + 1) * self.rows // self.ctas)


def pair_bytes(w: int, cin: int, kh: int, kw: int, cout: int) -> int:
    """Shared memory of one staged pair: its KH input rows and its dy row,
    as float32."""
    return 4 * (kh * w * cin + (w - kw + 1) * cout)


def plan(b: int, h: int, w: int, cin: int, kh: int, kw: int, cout: int,
         sms: int, *, ctas_per_sm: int = CTAS_PER_SM,
         group: int = GROUP) -> Plan:
    """The launch plan for x (b,h,w,cin), dy (b,h-kh+1,w-kw+1,cout) on a
    card of ``sms`` SMs: at most ``ctas_per_sm`` CTAs an SM and one pair a
    CTA at least; up to ``group`` pairs staged at once, no more than a CTA
    takes, and fewer while they exceed ``MAX_SMEM``.  The plan's ``per``
    may exceed ``MAX_PER`` and its ``smem_bytes`` ``MAX_SMEM``;
    ``launch_plan`` refuses both."""
    rows = b * (h - kh + 1)
    nout = kh * kw * cin * cout
    threads = min(MAX_THREADS, -(-nout // 32) * 32)
    ctas = max(1, min(rows, ctas_per_sm * sms))
    per_pair = pair_bytes(w, cin, kh, kw, cout)
    g = max(1, min(group, -(-rows // ctas)))
    while g > 1 and g * per_pair > MAX_SMEM:
        g -= 1
    return Plan(rows=rows, ctas=ctas, group=g, threads=threads,
                per=-(-nout // threads), smem_bytes=g * per_pair)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"conv2d_wgrad kernel: {msg}")


def launch_plan(x_shape, kh: int, kw: int, cout: int, sms: int) -> Plan:
    """``plan`` for these shapes; raises where a thread would hold more
    than ``MAX_PER`` outputs or one pair exceeds a CTA's shared memory."""
    b, h, w, cin = x_shape
    pl = plan(b, h, w, cin, kh, kw, cout, sms)
    _check(pl.per <= MAX_PER, f"a {kh}x{kw}x{cin}x{cout} filter gradient "
           f"has {kh * kw * cin * cout} outputs; at most "
           f"{MAX_THREADS * MAX_PER}")
    _check(pl.smem_bytes <= MAX_SMEM, f"one (image, output row) pair needs "
           f"{pl.smem_bytes} bytes of shared memory; one CTA may use "
           f"{MAX_SMEM}")
    _check(pl.rows < 2 ** 31, f"{pl.rows} (image, output row) pairs")
    return pl


def conv2d_wgrad(x, dy, kh: int, kw: int):
    """x (B,H,W,Cin), dy (B,H-KH+1,W-KW+1,Cout) -> dw (KH,KW,Cin,Cout) in
    x's dtype, summed in float32, on the card."""
    refuse_autograd("conv2d_wgrad", x=x, dy=dy)
    _check(x.is_cuda, "x must be a CUDA tensor (CPU tensors take "
           "ops.conv2d_wgrad's plain version)")
    _check(dy.device == x.device, f"dy is on {dy.device}, x on {x.device}")
    _check(x.dtype in DTYPE_CODE, f"dtype {x.dtype} (float32 or bfloat16)")
    _check(dy.dtype == x.dtype, f"dy is {dy.dtype}, x {x.dtype}")
    _check(x.dim() == 4 and dy.dim() == 4,
           "x must be (B,H,W,Cin) and dy (B,H',W',Cout)")
    _check(x.is_contiguous() and dy.is_contiguous(),
           "x and dy must be contiguous")
    b, h, wd, cin = x.shape
    cout = dy.shape[3]
    _check(min(b, cin, cout, kh, kw) >= 1,
           f"empty shape x {tuple(x.shape)} dy {tuple(dy.shape)} filter "
           f"{kh}x{kw}")
    _check(kh <= h and kw <= wd, f"filter {kh}x{kw} larger than the "
           f"{h}x{wd} image")
    _check(tuple(dy.shape[:3]) == (b, h - kh + 1, wd - kw + 1),
           f"dy {tuple(dy.shape)} is not the {kh}x{kw} valid output of x "
           f"{tuple(x.shape)}")
    dev = x.device
    pl = launch_plan(x.shape, kh, kw, cout, attention_split.sm_count(dev))
    part = torch.empty(pl.ctas, kh * kw * cin * cout, dtype=torch.float32,
                       device=dev)
    dw = torch.empty(kh, kw, cin, cout, dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(),
                      part.data_ptr(), dw.data_ptr(), b, h, wd, cin, kh, kw,
                      cout, pl.ctas, pl.group, pl.threads, pl.per,
                      pl.smem_bytes, stream)
    return dw
