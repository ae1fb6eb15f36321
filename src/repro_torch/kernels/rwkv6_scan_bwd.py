"""The backward of the WKV6 recurrence as a hand-written CUDA kernel for
Hopper.

The reference trains rwkv6 through ``jax.grad`` of its jnp ``lax.scan``
(``repro/models/rwkv6.py:190-199``; its Pallas kernel has no VJP); here
one launch a layer and backward pass gives every gradient of
``rwkv6_scan``: dr, dk, dv, dw (B,H,S,hd), du (H,hd) and ds0 (B,H,hd,hd)
from dout (B,H,S,hd) and ds_final (B,H,hd,hd), float32.  It carries the
backward of every rwkv6 layer's time-mix in training
(``ops.rwkv6_scan``'s autograd Function).  Source:
``csrc/rwkv6_scan_bwd.cu``; semantics: ``ref.rwkv6_scan_bwd_ref``.

Bound on an H100: operations, at rwkv6-1.6b's training shape (14 a
(row, head, step, i, j), the output's bonus term factored out of every
sum, against the bytes of the inputs and the gradients; the source note
counts both).

Design: the time axis in parallel.  Both recurrences (the state and its
adjoint) are elementwise in (i, j), so a first kernel runs them alone,
the state forward from s0 and the adjoint backward from ds_final, one
task a (batch row, head, span of ``SPAN`` value columns, direction), and
writes each at every chunk boundary of ``CHUNK`` steps (two operations
an element a step).  The second kernel then takes every (batch row,
head, chunk) as an item: it re-runs the chunk's states from the
checkpoint into registers and walks them in reverse from the adjoint
checkpoint, summing dr, dk, dw, dv and du; a thread takes two state rows
of four columns.  The spans of an item are one thread-block cluster:
dr, dk and dw are summed over the spans through distributed shared
memory in span order and written once; du's per-chunk partials are
summed in (row, chunk) order by the last CTA of the head to take a
ticket.  No float atomics, so the bits depend on the inputs alone.
Operands are read through element strides like the forward's (the
model's transposed views go in without copies), and dr, dk, dv, dw take
the layouts of r, k, v, w.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, refuse_autograd

MAX_HEAD_DIM = 64
SPAN = 32                   # value columns a CTA takes (a cluster's rank)
CHUNK = 16                  # steps a CTA of the second kernel takes
THREADS = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "rwkv6_scan_bwd", "rwkv6_scan_bwd_launch",
    [_P] * 18 + [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 5 + [_P])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rwkv6_scan_bwd kernel: {msg}")


def scratch_sizes(b: int, h: int, s: int, hd: int) -> dict:
    """Elements of the launch's scratch: one state (``ck_s``) and one
    adjoint (``ck_g``) checkpoint a boundary between chunks of ``CHUNK``
    steps, two float4 a thread of each span of ``SPAN`` columns (at least
    1 float each); du's partials a (row, chunk), float32; one int32
    ticket a head; in the order the launcher takes them."""
    nspan, nchunks = -(-hd // SPAN), -(-s // CHUNK)
    ckpt = max(1, b * h * (nchunks - 1) * nspan * THREADS * 8)
    return {"ck_s": ckpt, "ck_g": ckpt, "du_part": b * nchunks * h * hd,
            "tickets": h}


def rwkv6_scan_bwd(r, k, v, w, u, s0, dout, ds_final=None,
                   need=(True,) * 6):
    """The gradients of ``rwkv6_scan(r, k, v, w, u, s0)`` on the card:
    r/k/v/w/dout (B,H,S,hd) float32, u (H,hd), s0 (B,H,hd,hd) or None
    (zeros), ds_final (B,H,hd,hd) or None (zeros).  ``need``: which of
    (dr, dk, dv, dw, du, ds0) to compute.  -> those six, None where not
    needed; dr/dk/dv/dw in the layouts of r/k/v/w, du (H,hd), ds0
    (B,H,hd,hd) float32."""
    refuse_autograd("rwkv6_scan_bwd", r=r, k=k, v=v, w=w, u=u, s0=s0,
                    dout=dout, ds_final=ds_final)
    _check(r.is_cuda, "r must be a CUDA tensor (CPU tensors take "
           "ref.rwkv6_scan_bwd_ref)")
    _check(r.dim() == 4, "r/k/v/w/dout must be (B,H,S,hd)")
    b, h, s, hd = r.shape
    dev = r.device
    if s0 is None:
        s0 = torch.zeros(b, h, hd, hd, dtype=torch.float32, device=dev)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0), ("dout", dout), ("ds_final", ds_final)):
        if t is None:
            continue
        _check(t.device == dev, f"{name} is on {t.device}, r on {dev}")
        _check(t.dtype == torch.float32, f"{name} is {t.dtype} (float32 "
               "only)")
    for name, t in (("k", k), ("v", v), ("w", w), ("dout", dout)):
        _check(t.shape == r.shape, f"{name} {tuple(t.shape)} != r "
               f"{tuple(r.shape)}")
    _check(1 <= hd <= MAX_HEAD_DIM, f"head_dim {hd} (1..{MAX_HEAD_DIM})")
    _check(s >= 1 and 1 <= b <= 65535 and 1 <= h <= 65535,
           f"shape {tuple(r.shape)}")
    _check(u.shape == (h, hd) and u.is_contiguous(),
           f"u must be contiguous (H,hd) = {(h, hd)}")
    for name, t in (("s0", s0), ("ds_final", ds_final)):
        _check(t is None or (t.shape == (b, h, hd, hd)
                             and t.is_contiguous()),
               f"{name} must be contiguous (B,H,hd,hd) = {(b, h, hd, hd)}")
    need = tuple(bool(n) for n in need)
    _check(len(need) == 6, "need: six flags (dr, dk, dv, dw, du, ds0)")
    outs = [torch.empty_like(t) if n else None
            for t, n in zip((r, k, v, w), need)]
    du = torch.empty(h, hd, dtype=torch.float32, device=dev) \
        if need[4] else None
    ds0 = torch.empty_like(s0) if need[5] else None
    strided = (r, k, v, w, dout, outs[2], outs[0], outs[1], outs[3])
    for name, t in zip(("r", "k", "v", "w", "dout", "dv", "dr", "dk", "dw"),
                       strided):
        _check(t is None or t.stride(-1) == 1,
               f"{name} must have head_dim contiguous")
    strides = (ctypes.c_longlong * 27)(
        *(0 if t is None else t.stride(i) for t in strided
          for i in range(3)))
    ws = {key: torch.empty(n, dtype=torch.int32 if key == "tickets"
                           else torch.float32, device=dev)
          for key, n in scratch_sizes(b, h, s, hd).items()}

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(ptr(r), ptr(k), ptr(v), ptr(w), ptr(u), ptr(s0),
                      ptr(dout), ptr(ds_final), *map(ptr, outs), ptr(du),
                      ptr(ds0), *(t.data_ptr() for t in ws.values()),
                      strides, b, h, s, hd,
                      sum(1 << i for i, n in enumerate(need) if n),
                      stream)
    return (*outs, du, ds0)
