"""Optimizers as (init, update) pairs over nested dicts of tensors, the
port of ``repro.optim.optimizers``.

``update`` returns (updates, new state); ``apply_updates`` adds them.
The state tree is the reference's: ``count`` an int32 scalar tensor on
the parameters' device, ``mu``/``nu`` float32 whatever the parameter
dtype; each update is cast back to its parameter's dtype.  Everything
is functional and runs under ``torch.no_grad()``, so a reference state
bridged with ``bridge.params_from_jax`` carries across and two trees
compare leaf by leaf (``torch.optim`` keeps another state tree).
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, keys in ``tree``'s order;
    ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params)


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _f32_like(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params):
        with torch.no_grad():
            step = state["count"]
            lr_t = lr_fn(step)
            upd = tree_map(lambda g, p: (-lr_t * g.float()).to(p.dtype),
                           grads, params)
            return upd, {"count": step + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"count": _count(params), "mu": tree_map(_f32_like, params)}

    def update(grads, state, params):
        with torch.no_grad():
            step = state["count"]
            mu = tree_map(lambda m, g: beta * m + g.float(), state["mu"],
                          grads)
            lr_t = lr_fn(step)
            upd = tree_map(lambda m, p: (-lr_t * m).to(p.dtype), mu, params)
            return upd, {"count": step + 1, "mu": mu}

    return Optimizer(init, update)


def _adam_core(lr_fn, b1, b2, eps, weight_decay):
    def init(params):
        return {"count": _count(params), "mu": tree_map(_f32_like, params),
                "nu": tree_map(_f32_like, params)}

    def update(grads, state, params):
        with torch.no_grad():
            step = state["count"] + 1
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                          state["mu"], grads)
            nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.float() ** 2,
                          state["nu"], grads)
            bc1 = 1 - b1 ** step.float()
            bc2 = 1 - b2 ** step.float()
            lr_t = lr_fn(step - 1)

            def u(m, n, p):
                upd = (m / bc1) / (torch.sqrt(n / bc2) + eps)
                if weight_decay:
                    upd = upd + weight_decay * p.float()
                return (-lr_t * upd).to(p.dtype)

            upd = tree_map(u, mu, nu, params)
            return upd, {"count": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return _adam_core(_lr_fn(lr), b1, b2, eps, 0.0)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    return _adam_core(_lr_fn(lr), b1, b2, eps, weight_decay)


def apply_updates(params, updates):
    with torch.no_grad():
        return tree_map(lambda p, u: p + u, params, updates)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled so their global L2 norm is at most ``max_norm``,
    the norm before scaling), both computed in float32."""
    with torch.no_grad():
        gn = torch.sqrt(sum(torch.sum(g.float() ** 2)
                            for g in tree_leaves(grads)))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return tree_map(lambda g: (g.float() * scale).to(g.dtype),
                        grads), gn
