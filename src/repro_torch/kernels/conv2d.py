"""Valid 2-D convolution as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``repro/kernels/conv2d.py`` (``conv2d``):
x (B,H,W,Cin) NHWC against w (KH,KW,Cin,Cout) HWIO, valid padding,
stride 1, summed in float32 and stored in x's dtype.  It carries the
conv layer of the digit CNN on every forward pass of the Stratus
pipeline.  Source: ``csrc/conv2d.cu``; semantics: ``ref.conv2d_ref``.

Bound on an H100: bytes.  At the paper's shape each image writes 28x the
bytes it reads (32 output channels of one input channel), and the
operations per byte are far below the float32 ridge.

Design: persistent CTAs walk work items, each a band of output rows of
one image; one thread computes four output channels of a pixel and
stores them as one vector.  A ring of shared-memory slots holds the
input rows of the CTA's next items, each slot filled by one 1-D bulk
copy that completes on an mbarrier, so loads run ahead of compute while
earlier items' stores drain.  ``plan`` is the launch plan, pure Python
over the shapes and the SM count so the CPU tests reach it; the launcher
validates it and computes nothing of its own.  A plan whose filter and
ring exceed one CTA's shared memory is refused, with no fallback (the
TPU kernel also holds the whole filter in VMEM).  Nothing is padded;
operands must be contiguous.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Tuple

import torch

from repro_torch.kernels import attention_split
from repro_torch.kernels.build import CudaKernel, refuse_autograd

MAX_SMEM = 232_448          # bytes of shared memory one CTA may use (H100)
MAX_THREADS = 512           # the kernel's launch bound
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
BAR_BYTES = 64              # the ring's mbarriers, at the base of shared
                            # memory (room for 8 slots)
DESC_BYTES = 8 * 16         # then a 16-byte descriptor per slot
STAGES = 8                  # ring slots: items whose rows are in flight
CTAS_PER_SM = 4             # persistent CTAs launched per SM
ITEM_ROWS = 1.0             # an item's fixed cost, in output-row times

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("conv2d", "conv2d_launch",
                    [_I, _P, _P, _P] + [_I] * 7      # dtype, x, w, out, shape
                    + [_I] * 8 + [_P])               # the plan, stream


@dataclasses.dataclass(frozen=True)
class Plan:
    """A launch: ``items`` = B x ``bands`` work items, walked by ``ctas``
    persistent CTAs of ``threads`` (CTA c takes items c, c + ctas, ...).
    Item i is band i % bands of image i // bands: ``band_rows`` output
    rows (the image's last band may hold fewer).  Shared memory: the
    mbarriers, the slots' descriptors, the filter as float32, then
    ``stages`` slots of ``slot`` bytes for the items' input rows."""
    band_rows: int
    bands: int
    items: int
    ctas: int
    threads: int
    stages: int
    slot: int
    smem_bytes: int

    def cta_items(self, cta: int) -> range:
        return range(cta, self.items, self.ctas)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def slot_bytes(elements: int, esize: int) -> int:
    """Bytes of a slot for ``elements`` contiguous elements of ``esize``
    bytes copied as whole 16-byte chunks: a window that starts anywhere
    on an element boundary sits at its own offset within its first
    chunk."""
    return _round16(elements * esize + 16 - esize)


def smem_bytes(kh: int, kw: int, cin: int, cout: int, stages: int,
               slot: int) -> int:
    """The layout's total: barriers, descriptors, filter (float32), the
    ring."""
    return (BAR_BYTES + DESC_BYTES + _round16(kh * kw * cin * cout * 4)
            + stages * slot)


def makespan(b: int, ho: int, rows: int, ctas_max: int) -> float:
    """The plan's model of a launch, in output-row times of one CTA: the
    most items a CTA walks, each its rows plus ``ITEM_ROWS``."""
    items = b * -(-ho // rows)
    return -(-items // min(items, ctas_max)) * (rows + ITEM_ROWS)


def plan(b: int, h: int, w: int, cin: int, kh: int, kw: int, cout: int,
         esize: int, sms: int, *, band_rows: int = 0,
         ctas_per_sm: int = CTAS_PER_SM, stages: int = STAGES) -> Plan:
    """The launch plan for x (b,h,w,cin) of ``esize``-byte elements and w
    (kh,kw,cin,cout) on a card of ``sms`` SMs.

    Band rows (``band_rows`` > 0 forces them): among the heights that cut
    an image's rows into even bands, the one of least ``makespan`` (ties:
    more rows); then fewer while the ring exceeds ``MAX_SMEM``, then
    fewer slots.  The plan's ``smem_bytes`` may exceed ``MAX_SMEM``;
    ``conv2d`` refuses it."""
    ho, wo = h - kh + 1, w - kw + 1
    ctas_max = max(1, ctas_per_sm * sms)

    def layout(r, st):
        slot = slot_bytes((r + kh - 1) * w * cin, esize)
        return slot, smem_bytes(kh, kw, cin, cout, st, slot)

    if band_rows > 0:
        r = min(band_rows, ho)
    else:
        heights = {-(-ho // n) for n in range(1, ho + 1)}
        r = min(heights, key=lambda t: (makespan(b, ho, t, ctas_max), -t))
        while r > 1 and layout(r, stages)[1] > MAX_SMEM:
            r = -(-ho // (-(-ho // r) + 1))
        while stages > 1 and layout(r, stages)[1] > MAX_SMEM:
            stages -= 1
    bands = -(-ho // r)
    items = b * bands
    work = wo * -(-cout // 4)              # (pixel, quad) pairs of a row
    slot, total = layout(r, stages)
    return Plan(band_rows=r, bands=bands, items=items,
                ctas=min(items, ctas_max),
                threads=min(MAX_THREADS, -(-work // 32) * 32),
                stages=stages, slot=slot, smem_bytes=total)


def item_cells(pl: Plan, ho: int, item: int) -> Iterator[Tuple[int, int]]:
    """The (image, output row) cells item ``item`` writes, decoded as the
    kernel decodes it."""
    img, band = divmod(item, pl.bands)
    y0 = band * pl.band_rows
    for y in range(y0, min(y0 + pl.band_rows, ho)):
        yield img, y


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"conv2d kernel: {msg}")


def launch_plan(x_shape, w_shape, dtype, sms: int) -> Plan:
    """``plan`` for operands of these shapes and dtype; raises where the
    plan needs more shared memory than one CTA may use."""
    b, h, wd, cin = x_shape
    kh, kw, _, cout = w_shape
    pl = plan(b, h, wd, cin, kh, kw, cout, dtype.itemsize, sms)
    _check(pl.items < 2 ** 31, f"{pl.items} work items")
    _check(pl.smem_bytes <= MAX_SMEM, f"the filter as float32 and a ring "
           f"of {pl.stages} slots of {pl.band_rows}-row bands need "
           f"{pl.smem_bytes} bytes of shared memory; one CTA may use "
           f"{MAX_SMEM}")
    return pl


def conv2d(x, w):
    """x (B,H,W,Cin) x w (KH,KW,Cin,Cout) -> (B,H-KH+1,W-KW+1,Cout) in
    x's dtype, valid, stride 1, on the card."""
    refuse_autograd("conv2d", x=x, w=w)
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
    dev = x.device
    pl = launch_plan(x.shape, w.shape, x.dtype, attention_split.sm_count(dev))
    out = torch.empty(b, h - kh + 1, wd - kw + 1, cout, dtype=x.dtype,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                      out.data_ptr(), b, h, wd, cin, kh, kw, cout,
                      pl.band_rows, pl.bands, pl.items, pl.ctas, pl.threads,
                      pl.stages, pl.slot, pl.smem_bytes, stream)
    return out
