"""Mamba's selective scan as a hand-written CUDA kernel for Hopper.

The reference runs the recurrence as a ``jax.lax.scan`` outside any
Pallas kernel (``repro/models/ssm.py:ssm_forward``); here it is one
launch per mamba layer and dispatch: per (batch row, channel),
``h <- exp(dt a) h + (dt x) B`` and ``y = h . C`` from the state ``h0``.
It carries every mamba layer of both engines: ragged chunks and decode
steps of the paged engine, whole prompts and decode steps of the slot
engine.  x is read, and y written, in the model dtype (float32 or
bfloat16); everything else is float32.  Source: ``csrc/ssm_scan.cu``;
semantics: ``ref.ssm_scan_ref``.

Bound on an H100: bytes, at both of the path's shapes (dt, x and y
stream once; the state is read and written once); the exponentials, one
per state a step, take the SFU about as long as the bytes take at a
chunk of 8 rows (the source note counts both).

Design: a channel's 16 states over 4 neighbouring threads, each thread
holding a pair of neighbouring channels, 64 channels a CTA; time walked
in order in each thread, so the state is bit-identical however a
sequence is cut into calls; a ring of two shared-memory slots of
``slot_steps`` steps each, whose 1-D bulk copies run ahead of the
arithmetic.  A decode step (S = 1) reads its operands straight from
device memory.  The kernel takes no sequence length: the masked route
sets ``dt`` to 0 past a row's valid lanes, which carries its state
through exactly.

``checkpoints=True`` (the training forward of ``ops.ssm_scan``'s
autograd Function) also returns the state after every ``CKPT_STEPS``
steps but the last, (B, ceil(S / 16) - 1, di, N) float32, which the
backward kernel starts each of its chunks from; a separate instantiation
writes them, so the serving launches compute and write what they did.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import attention_split
from repro_torch.kernels.build import CudaKernel, refuse_autograd

STATE_DIM = 16
CKPT_STEPS = 16             # steps between the training forward's states
CHANNELS = 64               # channels a CTA takes (128 threads, 2 each)
STEPS = (32, 16)            # steps a ring slot holds: while every CTA is
                            # resident at once, and else
STAGES = 2                  # ring slots: one chunk in flight while one
                            # computes
BAR_BYTES = 128             # the slots' mbarriers, at the base of shared
SM_SMEM = 233_472           # an SM's shared memory for CTAs (228 KB)
CTA_RESERVED = 1024         # the driver's share of it per CTA
CTAS_PER_SM = 8             # at most: 64 registers a thread, 128 threads
X_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("ssm_scan", "ssm_scan_launch",
                    [_P] * 9 + [_I] * 4          # operands, B, S, di, N
                    + [_I] * 2 + [_P])           # x_bf16, steps, stream


def smem_bytes(steps: int, xsize: int) -> int:
    """As ``csrc/ssm_scan.cu`` lays it out: the barriers, then ``STAGES``
    slots of ``steps`` x (dt, x, bm, cm)."""
    slot = steps * (CHANNELS * 4 + CHANNELS * xsize + 2 * STATE_DIM * 4)
    return BAR_BYTES + STAGES * slot


def resident_ctas(smem: int) -> int:
    """CTAs an SM holds at once with ``smem`` bytes of shared memory."""
    return min(CTAS_PER_SM, SM_SMEM // (smem + CTA_RESERVED))


def slot_steps(b: int, di: int, xsize: int, sms: int) -> int:
    """Steps a ring slot holds for ``b`` rows of ``di`` channels, x of
    ``xsize`` bytes, on a card of ``sms`` SMs: ``STEPS[0]`` while the
    grid's CTAs are all resident at once with them (fewer chunks, fewer
    barriers); else ``STEPS[1]``, whose smaller ring lets more CTAs share
    an SM."""
    ctas = b * -(-di // CHANNELS)
    big = resident_ctas(smem_bytes(STEPS[0], xsize))
    return STEPS[0] if ctas <= big * sms else STEPS[1]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssm_scan kernel: {msg}")


def checkpoint_count(s: int) -> int:
    """States ``checkpoints=True`` keeps: one at each multiple of
    ``CKPT_STEPS`` steps short of S."""
    return (s - 1) // CKPT_STEPS


def ssm_scan(dt, bm, cm, x, a, h0, checkpoints: bool = False):
    """dt (B,S,di), bm / cm (B,S,N), a (di,N), h0 (B,di,N) contiguous
    float32, x (B,S,di) contiguous float32 or bfloat16, all on the card
    and 16-byte aligned, N = 16, di a multiple of 8.  -> (y (B,S,di) in
    x's dtype, h_final (B,di,N) float32), and with ``checkpoints`` the
    states after steps 16, 32, .. short of S, (B, ceil(S/16) - 1, di, N)
    float32."""
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
        if name == "x":
            _check(t.dtype in X_DTYPES, f"x is {t.dtype} (float32 or "
                   "bfloat16)")
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
    steps = slot_steps(b, di, x.element_size(),
                       attention_split.sm_count(dt.device))
    y = torch.empty_like(x)
    h_final = torch.empty_like(h0)
    ckpt = (torch.empty(b, checkpoint_count(s), di, n, dtype=torch.float32,
                        device=dt.device) if checkpoints else None)
    dev = dt.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        KERNEL.launch(dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                      x.data_ptr(), a.data_ptr(), h0.data_ptr(),
                      y.data_ptr(), h_final.data_ptr(),
                      ckpt.data_ptr() if ckpt is not None and ckpt.numel()
                      else None, b, s, di, n,
                      int(x.dtype == torch.bfloat16), steps, stream)
    return (y, h_final) if ckpt is None else (y, h_final, ckpt)
