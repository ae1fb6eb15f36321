"""Learning-rate schedules (step -> float32 lr tensor), the port of
``repro.optim.schedules``.  A step given as a tensor keeps its device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    def f(step):
        return torch.full((), lr, dtype=torch.float32,
                          device=_step(step).device)

    return f


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def f(step):
        step = _step(step)
        warm = peak_lr * (step + 1) / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak_lr - floor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, cos)

    return f
