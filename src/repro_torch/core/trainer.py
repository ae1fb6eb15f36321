"""Trainer: the strategy-driven loop with checkpointing and metrics, the
port of ``repro.core.trainer``'s ``Trainer`` and ``worker_batches``.

``Trainer`` runs a strategy (the paper's Spark/Elephas shape: W workers
x K local steps per round) over any model with a ``loss_fn(params,
batch)``.  The reference's ``make_train_step`` (its LLM train path) is
not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager


@dataclasses.dataclass
class Trainer:
    strategy: Any
    loss_fn: Callable
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 0
    log_every: int = 10

    def fit(self, params, batch_iter: Iterator, rounds: int,
            log: Callable[[str], None] = print):
        """``batch_iter`` yields (W, K, B, ...) dicts of tensors per round.
        -> (params, state, history: one dict of floats per round).  The
        per-round ``float()`` of the metrics waits for the device."""
        state = self.strategy.init(params)
        history = []
        t0 = time.time()
        for r in range(rounds):
            batches = next(batch_iter)
            params, state, metrics = self.strategy.round(
                params, state, batches, self.loss_fn)
            history.append({k: float(v) for k, v in metrics.items()})
            if self.log_every and (r % self.log_every == 0 or r == rounds - 1):
                log(f"round {r:4d} " + " ".join(
                    f"{k}={v:.4f}" for k, v in history[-1].items()) +
                    f" ({time.time() - t0:.1f}s)")
            if self.ckpt and self.ckpt_every and (r + 1) % self.ckpt_every == 0:
                self.ckpt.save(r + 1, {"params": params})
        return params, state, history


def worker_batches(x: np.ndarray, y: np.ndarray, num_workers: int,
                   steps_per_round: int, batch_size: int, seed: int,
                   wrap: Callable = None, device="cuda") -> Iterator:
    """Round iterator for strategy training: (W, K, B, ...) tensors on
    ``device`` drawn without replacement per round (reshuffling every
    epoch) — the RDD-shard semantics of the paper's Spark pipeline.  The
    same numpy draws as the reference, so the same seed gives the same
    batches; each round's arrays go to the device once."""
    n = x.shape[0]
    per_round = num_workers * steps_per_round * batch_size
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    pos = 0
    while True:
        if pos + per_round > n:
            order = rng.permutation(n)
            pos = 0
        idx = order[pos : pos + per_round]
        pos += per_round
        xb = x[idx].reshape(num_workers, steps_per_round, batch_size,
                            *x.shape[1:])
        yb = y[idx].reshape(num_workers, steps_per_round, batch_size,
                            *y.shape[1:])
        batch = {"x": torch.from_numpy(xb).to(device),
                 "y": torch.from_numpy(yb).to(device)}
        yield wrap(batch) if wrap else batch
