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

Design: one launch.  ``ctas`` CTAs, ``ctas_per_sm`` resident on each
SM, each over a contiguous range of (image, output row) pairs
(``Plan.cta_rows``) cut into chunks of ``slot_pairs`` pairs
(``Plan.chunks``; a chunk's input rows are one span in memory, also
across an image boundary); a producer warp streams each chunk's input
and dy rows into a ring of ``stages`` shared-memory slots by 1-D bulk
copies, and the consumer warps compute from the slots as they fill.  At
the paper's 3x3x1 filter with 32 channels the warps take the pairs in
turn and a lane holds one channel's 9 taps in registers (``Plan.groups``
of one warp each); other filters have one group of threads holding
``per`` outputs each.  The CTA sums its groups in order; the CTAs of a
thread-block cluster of ``cluster`` sum their partials in rank order
(each rank the outputs it owns, sent to it over distributed shared
memory) and write one to a workspace; the CTA that takes the last ticket
from a device counter sums the workspace in index order (``slices``
interleaved runs, then the runs in order) and resets the counter.  No
float atomics, so the bits depend on the plan alone.  ``plan`` is pure
Python over the shapes and the SM count, so the CPU tests reach it; the
launcher validates it.  Operands are not padded and must be contiguous;
a filter gradient of more than ``MAX_CONSUMERS * MAX_PER`` outputs, or
a slot past one CTA's shared memory, is refused, with no fallback.

The shape of the plan comes from the card (``chip_smoke.py``'s forced
plans, PERF.md): one CTA an SM with 16 consumer warps and slots of 16
pairs streams fastest, and clusters of 2 (not 4) keep every SM in use.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import attention_split
from repro_torch.kernels.build import CudaKernel, refuse_autograd

MAX_SMEM = 232_448          # bytes of shared memory one CTA may use (H100)
SM_SMEM = 233_472           # bytes of shared memory an SM gives its CTAs
CTA_RESERVE = 1_024         # of which each resident CTA takes for itself
MAX_CONSUMERS = 512         # consumer threads of the general variant
MAX_THREADS = MAX_CONSUMERS + 32    # and the producer warp
MAX_PER = 8                 # outputs one thread accumulates (registers)
MAX_STAGES = 8              # ring slots (mbarrier pairs in the head)
MAX_CLUSTER = 8             # CTAs of a portable thread-block cluster
HEAD = 256                  # bytes: the slots' mbarriers and a flag
FIXED_TAPS = 9              # the 3x3x1 taps a lane holds
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CTAS_PER_SM = 1             # CTAs resident per SM
CLUSTER = 2                 # CTAs whose partials merge in shared memory
SLOT_PAIRS = 16             # (image, output row) pairs a slot holds
WARPS = 16                  # consumer warps of the 3x3x1 variant

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("conv2d_wgrad", "conv2d_wgrad_launch",
                    [_I, _P, _P, _P, _P, _P] + [_I] * 7   # dtype, x, dy, ws,
                                                          # counter, dw, shape
                    + [_I] * 10 + [_P])                   # the plan, stream


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def slot_bytes(elements: int, esize: int) -> int:
    """Bytes of a slot region for ``elements`` contiguous elements of
    ``esize`` bytes copied as whole 16-byte chunks: a window that starts
    anywhere on an element boundary sits at its own offset within its
    first chunk."""
    return _round16(elements * esize + 16 - esize)


def copy_window(lo: int, hi: int, a_lo: int, a_hi: int, esize: int):
    """How the kernel copies the bytes [lo, hi) of the array [a_lo, a_hi)
    into a slot (``copy_window`` in the source): -> (lead, bulk, elements),
    the window's offset in the slot, the bulk copy as (slot offset,
    address, bytes) or None, and the addresses copied element by
    element."""
    base = lo // 16 * 16
    c0 = max(base, _round16(a_lo))
    c1 = min(_round16(hi), a_hi // 16 * 16)
    bulk = (c0 - base, c0, c1 - c0) if c1 > c0 else None
    elements = [a for a in range(lo, hi, esize)
                if bulk is None or not c0 <= a < c1]
    return lo - base, bulk, elements


@dataclasses.dataclass(frozen=True)
class Plan:
    """``ctas`` CTAs of ``threads`` (``warps`` consumer warps and a
    producer), CTA c over the pairs ``cta_rows(c)`` of the ``rows`` = B x
    ``ho`` (image, output row) pairs, in ``chunks(c)`` of up to
    ``slot_pairs``, through ``stages`` ring slots of ``x_slot`` +
    ``dy_slot`` bytes.  ``fixed``: a lane holds ``per`` = 9 taps of one
    channel and the warps take the pairs in turn; else each consumer
    thread holds ``per`` outputs.  Clusters of ``cluster`` CTAs; the last
    CTA sums the ``clusters`` partials in ``slices`` runs."""
    rows: int
    ho: int
    nout: int
    fixed: bool
    ctas: int
    cluster: int
    stages: int
    slot_pairs: int
    warps: int
    per: int
    x_slot: int
    dy_slot: int
    slices: int
    smem_bytes: int

    @property
    def threads(self) -> int:
        return 32 * (self.warps + 1)

    @property
    def clusters(self) -> int:
        return self.ctas // self.cluster

    @property
    def groups(self) -> int:
        """Groups of consumer threads that take a CTA's pairs in turn,
        each holding every output."""
        return self.warps if self.fixed else 1

    def cta_rows(self, cta: int) -> range:
        return range(cta * self.rows // self.ctas,
                     (cta + 1) * self.rows // self.ctas)

    def chunks(self, cta: int) -> List[Tuple[int, int]]:
        """(first pair, pairs) of the CTA's chunks, in ring order: a slot's
        worth each but the last."""
        r = self.cta_rows(cta)
        return [(q, min(self.slot_pairs, r.stop - q))
                for q in range(r.start, r.stop, self.slot_pairs)]

    def group_rows(self, cta: int, group: int) -> range:
        """The pairs one group sums, in order."""
        return self.cta_rows(cta)[group::self.groups]

    def rank_outputs(self, rank: int) -> range:
        """The outputs whose cluster partial a rank sums and writes."""
        m = -(-self.nout // self.cluster)
        return range(rank * m, min(self.nout, (rank + 1) * m))

    def slice_clusters(self, s: int) -> range:
        """The cluster partials the final sum's run ``s`` adds, in order."""
        return range(s, self.clusters, self.slices)


def x_rows(slot_pairs: int, ho: int, kh: int) -> int:
    """Input rows of a chunk of ``slot_pairs`` pairs: a window a pair, and
    ``kh - 1`` more at each image boundary the chunk crosses (the next
    image's rows follow the last one's in memory)."""
    crossings = (slot_pairs + ho - 2) // ho
    return slot_pairs - 1 + kh + (kh - 1) * crossings


def smem_bytes(nout: int, fixed: bool, warps: int, cluster: int,
               stages: int, x_slot: int, dy_slot: int, slices: int) -> int:
    """The layout's total: the head, the inbox (every rank's float32 share
    of the CTA's outputs), then the ring, which the warps' partials and
    the final sum's runs reuse."""
    region = stages * (x_slot + dy_slot)
    if fixed:
        region = max(region, 4 * nout * warps)
    region = max(region, 4 * nout * slices)
    return HEAD + _round16(4 * cluster * -(-nout // cluster)) + region


def final_width(nout: int) -> int:
    """Outputs a thread of the final sum adds at once: 4 (16-byte loads)
    where the workspace's rows are whole 16-byte groups."""
    return 4 if nout % 4 == 0 else 1


def plan(b: int, h: int, w: int, cin: int, kh: int, kw: int, cout: int,
         esize: int, sms: int, *, ctas_per_sm: int = CTAS_PER_SM,
         cluster: int = CLUSTER, stages: int = MAX_STAGES,
         slot_pairs: int = SLOT_PAIRS, warps: int = WARPS) -> Plan:
    """The launch plan for x (b,h,w,cin) of ``esize``-byte elements and dy
    (b,h-kh+1,w-kw+1,cout) on a card of ``sms`` SMs: clusters of
    ``cluster`` CTAs (fewer where there are fewer pairs), as many whole
    clusters as ``ctas_per_sm`` CTAs an SM allow, one pair a CTA at least;
    a slot of ``slot_pairs`` pairs (the 3x3x1 variant: a multiple of its
    ``warps``), no more than a CTA takes; up to ``stages`` slots, as many
    as the CTA's share of the SM's shared memory holds and its chunks
    fill, then fewer pairs a slot while one slot exceeds it.  The
    layout is padded so that no more than ``ctas_per_sm`` CTAs fit an SM.
    The plan's ``per`` may exceed ``MAX_PER`` and its ``smem_bytes``
    ``MAX_SMEM``; ``launch_plan`` refuses both."""
    ho, wo = h - kh + 1, w - kw + 1
    rows = b * ho
    nout = kh * kw * cin * cout
    fixed = (kh, kw, cin, cout) == (3, 3, 1, 32)   # taps in registers
    if fixed:
        per = FIXED_TAPS
    else:
        consumers = min(MAX_CONSUMERS, -(-nout // 32) * 32)
        warps, per = consumers // 32, -(-nout // consumers)
    step = warps if fixed else 1          # a slot's pairs come in steps
    cs = max(1, min(cluster, rows))
    ctas = cs * max(1, min(rows, ctas_per_sm * sms) // cs)
    clusters = ctas // cs
    threads = 32 * (warps + 1)
    slices = max(1, min(threads // (nout // final_width(nout)), clusters))
    per_cta = -(-rows // ctas)
    share = min(MAX_SMEM, SM_SMEM // ctas_per_sm - CTA_RESERVE)
    r = max(step, min(slot_pairs, -(-per_cta // step) * step) // step * step)

    def layout(r, st):
        xs = slot_bytes(x_rows(r, ho, kh) * w * cin, esize)
        ds = slot_bytes(r * wo * cout, esize)
        return xs, ds, smem_bytes(nout, fixed, warps, cs, st, xs, ds,
                                  slices)

    while r > step and layout(r, 1)[2] > share:
        r -= step
    fit = 1
    while fit < stages and layout(r, fit + 1)[2] <= share:
        fit += 1
    st = max(1, min(fit, -(-per_cta // r)))
    xs, ds, total = layout(r, st)
    floor = _round16(SM_SMEM // (ctas_per_sm + 1) - CTA_RESERVE + 1)
    return Plan(rows=rows, ho=ho, nout=nout, fixed=fixed, ctas=ctas,
                cluster=cs, stages=st, slot_pairs=r, warps=warps, per=per,
                x_slot=xs, dy_slot=ds, slices=slices,
                smem_bytes=max(total, min(floor, MAX_SMEM)))


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"conv2d_wgrad kernel: {msg}")


def launch_plan(x_shape, kh: int, kw: int, cout: int, sms: int,
                esize: int = 4) -> Plan:
    """``plan`` for these shapes; raises where a thread would hold more
    than ``MAX_PER`` outputs or one pair exceeds a CTA's shared memory."""
    b, h, w, cin = x_shape
    pl = plan(b, h, w, cin, kh, kw, cout, esize, sms)
    _check(pl.per <= MAX_PER or pl.fixed, f"a {kh}x{kw}x{cin}x{cout} filter "
           f"gradient has {kh * kw * cin * cout} outputs; at most "
           f"{MAX_CONSUMERS * MAX_PER}")
    _check(pl.smem_bytes <= MAX_SMEM, f"one (image, output row) pair needs "
           f"{pl.smem_bytes} bytes of shared memory; one CTA may use "
           f"{MAX_SMEM}")
    _check(pl.rows < 2 ** 31, f"{pl.rows} (image, output row) pairs")
    return pl


# (device index, stream) -> [ticket counter (int32, 0 between launches),
# float32 workspace]: made on a stream's first call, kept for its next
_SCRATCH: Dict[Tuple[int, int], list] = {}


def scratch(device, stream: int, n: int):
    """The stream's counter and a workspace of at least ``n`` floats.  The
    kernel leaves the counter at 0, so it is zeroed once, when made.
    Buffers made while the stream is being captured into a CUDA graph
    belong to that graph (its memory pool; the counter's zeroing is a
    node of it) and are not kept."""
    key = (device.index, stream)
    ent = _SCRATCH.get(key)
    keep = not torch.cuda.is_current_stream_capturing()
    if ent is None:
        ent = [torch.zeros(1, dtype=torch.int32, device=device),
               torch.empty(0, dtype=torch.float32, device=device)]
        if keep:
            _SCRATCH[key] = ent
    if ent[1].numel() < n:
        ws = torch.empty(n, dtype=torch.float32, device=device)
        if not keep:
            return ent[0], ws
        ent[1] = ws
    return ent[0], ent[1]


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
    pl = launch_plan(x.shape, kh, kw, cout, attention_split.sm_count(dev),
                     x.element_size())
    dw = torch.empty(kh, kw, cin, cout, dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counter, ws = scratch(dev, stream, pl.clusters * pl.nout)
        KERNEL.launch(DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(),
                      ws.data_ptr(), counter.data_ptr(), dw.data_ptr(), b, h,
                      wd, cin, kh, kw, cout, pl.ctas, pl.cluster, pl.stages,
                      pl.slot_pairs, pl.warps, pl.per, pl.x_slot, pl.dy_slot,
                      pl.slices, pl.smem_bytes, stream)
    return dw
