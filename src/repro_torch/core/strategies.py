"""Distributed-training strategies, the port of ``repro.core.strategies``:
the paper's Spark-ML/Elephas synchronization policies (Sec. II-C, 5
workers) as objects.

  SyncDataParallel    Elephas "synchronous": per-step gradient averaging.
  LocalSGD            K local steps per worker, then parameter averaging.
  ElasticAveraging    EASGD (Zhang et al. 2015): workers are elastically
                      attracted to a center variable, the center moves
                      toward the worker mean.

Every strategy exposes:
    init(params)                               -> state
    round(params, state, batches, loss_fn)     -> (params, state, metrics)
where ``batches`` is a dict of tensors with leading axes (W, K, B, ...) —
W workers by K local steps — and ``loss_fn(params, batch) -> (loss,
metrics)``.  Per-worker state (``params_w``, ``opt_w``) is stacked on a
leading W axis, as in the reference, so the two trees compare leaf by
leaf.  Workers run in a Python loop over W: the reference's ``jax.vmap``
has no counterpart here, since ``torch.func.vmap`` cannot batch a kernel
launched through ctypes.  Sync averages the W gradients before one
optimizer update per step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.optim import Optimizer, apply_updates, clip_by_global_norm
from repro_torch.optim.optimizers import tree_leaves, tree_map

LossFn = Callable[[Any, Any], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


def _worker_mean(tree):
    return tree_map(lambda x: x.mean(0), tree)


def _stack(trees):
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _index(tree, *idx):
    return tree_map(lambda x: x[idx], tree)


def _grid(batches) -> Tuple[int, int]:
    """(W, K) of a round's batches."""
    return tuple(tree_leaves(batches)[0].shape[:2])


def _value_and_grad(loss_fn: LossFn, params, batch):
    """-> (loss, metrics, grads), all detached; a parameter the loss does
    not reach gets a zero gradient, as under ``jax.grad``."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_fn(leaves, batch)
        grads = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                         allow_unused=True,
                                         materialize_grads=True))
    grads = tree_map(lambda p: next(grads), leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _local_step(opt: Optimizer, loss_fn: LossFn, clip: float):
    def step(params, opt_state, batch):
        _, metrics, grads = _value_and_grad(loss_fn, params, batch)
        if clip:
            grads, gnorm = clip_by_global_norm(grads, clip)
            metrics = {**metrics, "grad_norm": gnorm}
        upd, opt_state = opt.update(grads, opt_state, params)
        return apply_updates(params, upd), opt_state, metrics

    return step


def _run_workers(step, params_w, opt_w, batches):
    """Each worker's K local steps from its own slice of the stacked
    state -> (params_w, opt_w, mean over workers of the last step's
    loss)."""
    w_n, k_n = _grid(batches)
    ps, os_, losses = [], [], []
    for w in range(w_n):
        p, o = _index(params_w, w), _index(opt_w, w)
        for k in range(k_n):
            p, o, m = step(p, o, _index(batches, w, k))
        ps.append(p)
        os_.append(o)
        losses.append(m["loss"])
    return _stack(ps), _stack(os_), torch.stack(losses).mean()


@dataclasses.dataclass
class SyncDataParallel:
    """Per-step gradient all-reduce (Elephas synchronous mode).

    Each of the K steps in a round: every worker computes grads on its own
    microbatch; grads are averaged; ONE shared parameter copy advances.
    """

    optimizer: Optimizer
    num_workers: int
    clip: float = 0.0

    def init(self, params):
        return {"opt": self.optimizer.init(params)}

    def round(self, params, state, batches, loss_fn: LossFn):
        opt_state = state["opt"]
        w_n, k_n = _grid(batches)
        for k in range(k_n):
            losses, grads = [], []
            for w in range(w_n):
                loss, _, g = _value_and_grad(loss_fn, params,
                                             _index(batches, w, k))
                losses.append(loss)
                grads.append(g)
            with torch.no_grad():
                grads = _worker_mean(_stack(grads))
            if self.clip:
                grads, _ = clip_by_global_norm(grads, self.clip)
            upd, opt_state = self.optimizer.update(grads, opt_state, params)
            params = apply_updates(params, upd)
        return params, {"opt": opt_state}, {
            "loss": torch.stack(losses).mean()}


@dataclasses.dataclass
class LocalSGD:
    """K local steps per worker, then parameter averaging (post-local SGD;
    Elephas's delayed-sync mode with a precise sync period)."""

    optimizer: Optimizer
    num_workers: int
    clip: float = 0.0

    def init(self, params):
        return {"params_w": _stack([params] * self.num_workers),
                "opt_w": _stack([self.optimizer.init(params)
                                 for _ in range(self.num_workers)])}

    def round(self, params, state, batches, loss_fn: LossFn):
        step = _local_step(self.optimizer, loss_fn, self.clip)
        # re-seed workers from the current consensus params
        params_w = _stack([params] * self.num_workers)
        params_w, opt_w, loss = _run_workers(step, params_w, state["opt_w"],
                                             batches)
        with torch.no_grad():
            new_params = _worker_mean(params_w)
        return new_params, {"params_w": params_w, "opt_w": opt_w}, {
            "loss": loss}


@dataclasses.dataclass
class ElasticAveraging:
    """EASGD: workers keep their own parameters between rounds and are
    pulled toward a center variable; the center drifts toward the worker
    mean.  ``alpha`` is the elastic coefficient (per sync)."""

    optimizer: Optimizer
    num_workers: int
    alpha: float = 0.5
    clip: float = 0.0

    def init(self, params):
        return {"params_w": _stack([params] * self.num_workers),
                "opt_w": _stack([self.optimizer.init(params)
                                 for _ in range(self.num_workers)])}

    def round(self, params, state, batches, loss_fn: LossFn):
        step = _local_step(self.optimizer, loss_fn, self.clip)
        params_w, opt_w, loss = _run_workers(step, state["params_w"],
                                             state["opt_w"], batches)
        a = self.alpha
        with torch.no_grad():
            diff = tree_map(lambda pw, c: pw - c[None], params_w, params)
            params_w = tree_map(lambda pw, d: pw - a * d, params_w, diff)
            center = tree_map(lambda c, d: c + a * d.mean(0).to(c.dtype),
                              params, diff)
        return center, {"params_w": params_w, "opt_w": opt_w}, {
            "loss": loss}


STRATEGIES = {
    "sync": SyncDataParallel,
    "local_sgd": LocalSGD,
    "elastic": ElasticAveraging,
}


def make_strategy(name: str, optimizer: Optimizer, num_workers: int,
                  **kw) -> Any:
    return STRATEGIES[name](optimizer=optimizer, num_workers=num_workers, **kw)
