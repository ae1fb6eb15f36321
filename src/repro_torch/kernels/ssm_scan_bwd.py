"""The backward of mamba's selective scan as a hand-written CUDA kernel for
Hopper.

The reference trains jamba through ``jax.grad`` of its selective
``lax.scan`` (``repro/models/ssm.py:134-145``, no Pallas kernel); here
one launch a mamba layer and backward pass gives every gradient of
``ssm_scan``: ddt (B,S,di), dbm, dcm (B,S,N), dx (B,S,di) in x's dtype,
da (di,N) and dh0 (B,di,N) from dy (B,S,di) in x's dtype and dh_final
(B,di,N).  It carries the backward of every mamba layer in training
(``ops.ssm_scan``'s autograd Function).  Source: ``csrc/ssm_scan_bwd.cu``;
semantics: ``ref.ssm_scan_bwd_ref``.

Bound on an H100: bytes, at jamba's training shape, with the arithmetic
and the exponentials close behind (the source note counts them).

Design: the forward's split, a CTA of 256 threads per (batch row, 64
channels), a channel's 16 states over 4 threads.  The training forward
keeps the state every ``CHUNK`` steps (``ssm_scan(..., checkpoints=True)``,
the ``ckpt`` argument here); the kernel walks the chunks backwards and
re-runs each chunk's states from its checkpoint, taking each decay's
``ex2`` once: the first 8 steps' decays are kept in shared memory, the
last 8 steps' decays and states in registers, and the first 8 steps'
states are re-run from the kept decays after the last 8 are walked.  dB
and dC sum over every channel: the CTAs of ``CLUSTER`` = 2 column
blocks of a row (a thread-block cluster, fixed in the kernel: larger
clusters leave fewer CTAs resident, PERF.md) add theirs over distributed
shared memory in rank order, and each cluster writes a partial (B, S,
clusters, N); a second kernel of the same launch adds the partials in
cluster order (da over the rows too): no float atomics, so the bits
depend on the inputs alone.  Where S > ``CHUNK`` the caller passes the
checkpoints (``ops.ssm_scan``'s autograd Function saves them).
Operands must be contiguous and 16-byte aligned, N = 16 and di a
multiple of 8, as for the forward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ssm_scan as _ss
from repro_torch.kernels.build import CudaKernel, refuse_autograd
from repro_torch.kernels.ssm_scan import STATE_DIM, X_DTYPES

CHANNELS = 64               # channels a CTA takes
CHUNK = _ss.CKPT_STEPS      # steps between checkpoints of the state
THREADS = 256
CLUSTER = 2                 # column blocks a cluster takes (the kernel's
                            # kCluster)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("ssm_scan_bwd", "ssm_scan_bwd_launch",
                    [_P] * 18 + [_I] * 6 + [_P])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssm_scan_bwd kernel: {msg}")


def workspace_floats(b: int, s: int, di: int) -> dict:
    """Floats of a launch's scratch, as the wrapper allocates it: the
    clusters' partials of dbm and dcm (a row's column blocks ``CLUSTER``
    at a time, the last cluster's blocks past di summed as zeros) and
    the per-row partials of da."""
    nclus = -(-di // (CHANNELS * CLUSTER))
    return {"dbm_part": b * s * nclus * STATE_DIM,
            "dcm_part": b * s * nclus * STATE_DIM,
            "da_part": b * di * STATE_DIM}


def _aligned(t):
    """t itself where it is contiguous and 16-byte aligned, else a copy."""
    if t is None or (t.is_contiguous() and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def ssm_scan_bwd(dt, bm, cm, x, a, h0, dy, dh_final=None,
                 need=(True,) * 6, ckpt=None):
    """The gradients of ``ssm_scan(dt, bm, cm, x, a, h0)`` on the card:
    dt (B,S,di), bm / cm (B,S,N), a (di,N), h0 (B,di,N) contiguous float32
    and 16-byte aligned, as the forward takes them; x (B,S,di) and dy in
    x's dtype (float32 or bfloat16), dh_final (B,di,N) float32 or None
    (zeros); dy and dh_final are copied where they are not contiguous and
    aligned.  ``need``: which of (ddt, dbm, dcm, dx, da, dh0) to compute.
    ``ckpt``: the forward's checkpoints (B, ceil(S/16) - 1, di, N), as
    ``ssm_scan(..., checkpoints=True)`` returns them; needed where S > 16
    (None: none, where S <= 16).  -> those six, None where not needed."""
    refuse_autograd("ssm_scan_bwd", dt=dt, bm=bm, cm=cm, x=x, a=a, h0=h0,
                    dy=dy, dh_final=dh_final)
    _check(dt.is_cuda, "dt must be a CUDA tensor (CPU tensors take "
           "ref.ssm_scan_bwd_ref)")
    _check(dt.dim() == 3, "dt must be (B,S,di)")
    b, s, di = dt.shape
    n = a.shape[-1]
    _check(n == STATE_DIM, f"state size {n} (the kernel takes "
           f"{STATE_DIM})")
    dy, dh_final = _aligned(dy), _aligned(dh_final)
    want = {"dt": (b, s, di), "x": (b, s, di), "dy": (b, s, di),
            "bm": (b, s, n), "cm": (b, s, n), "a": (di, n), "h0": (b, di, n),
            "dh_final": (b, di, n)}
    for name, t in (("dt", dt), ("bm", bm), ("cm", cm), ("x", x), ("a", a),
                    ("h0", h0), ("dy", dy), ("dh_final", dh_final)):
        if t is None:
            continue
        _check(t.device == dt.device, f"{name} is on {t.device}, dt on "
               f"{dt.device}")
        if name == "x":
            _check(t.dtype in X_DTYPES, f"x is {t.dtype} (float32 or "
                   "bfloat16)")
        elif name == "dy":
            _check(t.dtype == x.dtype, f"dy is {t.dtype}, x {x.dtype}")
        else:
            _check(t.dtype == torch.float32, f"{name} is {t.dtype} (float32 "
                   "only)")
        _check(tuple(t.shape) == want[name], f"{name} {tuple(t.shape)} != "
               f"{want[name]}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
        _check(t.data_ptr() % 16 == 0, f"{name} must start 16-byte "
               "aligned")
    _check(1 <= b <= 65535 and s >= 1 and di >= 1 and di % 8 == 0,
           f"shape {(b, s, di)} (1..65,535 rows, S >= 1, d_inner a "
           "multiple of 8)")
    need = tuple(bool(f) for f in need)
    _check(len(need) == 6, "need: six flags (ddt, dbm, dcm, dx, da, dh0)")
    want_ck = (b, _ss.checkpoint_count(s), di, n)
    if ckpt is None:
        _check(s <= CHUNK, f"S = {s} needs ckpt, the forward's checkpoints "
               "(ssm_scan(..., checkpoints=True))")
    else:
        _check(ckpt.device == dt.device and ckpt.dtype == torch.float32
               and tuple(ckpt.shape) == want_ck and ckpt.is_contiguous()
               and ckpt.data_ptr() % 16 == 0,
               f"ckpt must be {want_ck} float32 on {dt.device}, contiguous "
               "and 16-byte aligned (ssm_scan(..., checkpoints=True))")
    outs = [torch.empty_like(t) if f else None
            for t, f in zip((dt, bm, cm, x, a, h0), need)]
    ws = [torch.empty(size, dtype=torch.float32, device=dt.device)
          for size in workspace_floats(b, s, di).values()]

    def ptr(t):
        return None if t is None else t.data_ptr()

    dev = dt.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(ptr(dt), ptr(bm), ptr(cm), ptr(x), ptr(a), ptr(h0),
                      ptr(dy), ptr(dh_final),
                      ptr(ckpt) if ckpt is not None and ckpt.numel()
                      else None, *map(ptr, outs), *map(ptr, ws),
                      b, s, di, n, int(x.dtype == torch.bfloat16),
                      sum(1 << i for i, f in enumerate(need) if f), stream)
    return tuple(outs)
