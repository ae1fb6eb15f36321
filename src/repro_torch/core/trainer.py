"""Trainer: the strategy-driven loop with checkpointing and metrics, and
the LLM pool's train step; the port of ``repro.core.trainer``.

Two frontends over the same substrate:

  * ``Trainer``         strategy-based (the paper's Spark/Elephas shape):
                        W workers x K local steps per round, any model
                        with a ``loss_fn(params, batch)``.
  * ``make_train_step`` one train step (gradients, clipping, optimizer)
                        for ``launch/train.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.strategies import _value_and_grad
from repro_torch.models.sharding import local_tensor, placed_like
from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.optim.optimizers import tree_leaves

# the most elements of one leaf that a donated step updates at once: its
# float32 temporaries stay at a few times 256 MiB whatever the leaf size
DONATE_CHUNK = 1 << 26


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


def _donated_update(optimizer: Optimizer, g_leaves: list, opt_state,
                    params):
    """``optimizer.update`` then ``apply_updates``, written into the
    tensors of ``params`` and of ``opt_state``'s per-parameter trees, over
    slices of at most ``DONATE_CHUNK`` elements of one leaf at a time;
    ``g_leaves`` are the gradients in ``tree_leaves`` order, each dropped
    from the list once used.  Every optimizer of ``optim`` is elementwise
    but for its step count, so the slices give the values of one update
    of the whole tree, and the moments are never held twice.  Sharded
    leaves (DTensors placed alike, the dry-run's) update each device's
    shard.  -> (params, the new state)."""
    p_leaves = [local_tensor(p) for p in tree_leaves(params)]
    g_leaves[:] = [local_tensor(g) for g in g_leaves]
    if not all(p.is_contiguous() for p in p_leaves):
        raise ValueError("a donated train step updates contiguous "
                         "parameters in place")
    per_leaf = {k: [local_tensor(t) for t in tree_leaves(v)]
                for k, v in opt_state.items() if isinstance(v, dict)}
    shared = {k: v for k, v in opt_state.items() if k not in per_leaf}
    new_shared = shared
    with torch.no_grad():
        for i, p in enumerate(p_leaves):
            flat_p, flat_g = p.view(-1), g_leaves[i].reshape(-1)
            for a in range(0, flat_p.numel(), DONATE_CHUNK):
                sl = slice(a, a + DONATE_CHUNK)
                state = {**shared, **{k: {"x": leaves[i].view(-1)[sl]}
                                      for k, leaves in per_leaf.items()}}
                upd, new = optimizer.update({"x": flat_g[sl]}, state,
                                            {"x": flat_p[sl]})
                flat_p[sl].copy_(apply_updates({"x": flat_p[sl]}, upd)["x"])
                for k, leaves in per_leaf.items():
                    leaves[i].view(-1)[sl].copy_(new[k]["x"])
                new_shared = {k: new[k] for k in shared}
            g_leaves[i] = None                    # free each gradient
    return params, {**opt_state, **new_shared}


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    clip: float = 1.0):
    """One train step: (params, opt_state, batch) -> (params, opt_state,
    metrics).  The loss and the gradient of every parameter leaf by
    ``torch.autograd``, then ``clip_by_global_norm`` (``grad_norm`` joins
    the metrics), then ``optimizer.update`` and ``apply_updates``, as the
    reference's step.  The metrics stay tensors on the parameters'
    device: the step waits for no device result.

    ``params`` and ``opt_state`` are donated, as the reference CLI jits
    its step with ``donate_argnums=(0, 1)``: the step writes the new
    values into their tensors (``_donated_update``) and returns them, so
    it holds one copy of the optimizer's moments."""

    def train_step(params, opt_state, batch):
        _, metrics, grads = _value_and_grad(loss_fn, params, batch)
        # sharded (the dry-run's): each gradient reduced to its
        # parameter's placement (a no-op for plain tensors)
        grads = placed_like(grads, params)
        if clip:
            grads, gnorm = clip_by_global_norm(grads, clip)
            metrics = {**metrics, "grad_norm": gnorm}
        g_leaves = tree_leaves(grads)
        del grads
        params, opt_state = _donated_update(optimizer, g_leaves, opt_state,
                                            params)
        return params, opt_state, metrics

    return train_step


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
