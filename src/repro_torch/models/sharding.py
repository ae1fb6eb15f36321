"""Logical-axis sharding rules over a torch ``DeviceMesh``.

The port of ``repro.models.sharding``.  Every parameter, cache leaf and
activation the dry-run reaches is annotated with *logical* axis names; a
``Rules`` table maps logical names to mesh axes, so a distribution
strategy is a rules table, not model code.  ``Rules.spec`` is the
reference's, rule for rule:

  * **shape-aware filtering**: an assignment is dropped when the
    dimension does not divide the product of its mesh axes (8 KV heads
    over a 16-way ``model`` axis, whisper's vocab 51,865);
  * **dedup (first wins)**: a mesh axis appears once per spec; a later
    logical axis that maps to a used mesh axis stays replicated (weights
    declare ``d_model -> data`` for FSDP while activations, whose
    ``batch`` already claims ``data``, keep ``d_model`` replicated).

A spec is a tuple with one entry per tensor dimension: ``None``, a mesh
axis name, or a tuple of names (outermost first), the reference's
``PartitionSpec`` entries.  ``Rules.placements`` turns it into DTensor
placements on the rules' mesh: ``Shard(i)`` on every mesh dimension that
tensor dimension ``i`` names, ``Replicate()`` elsewhere.

``shard(x, *logical)`` is ``with_sharding_constraint``'s counterpart:
with no rules active (every serving and training path) it returns ``x``
after one ``ContextVar.get``; under ``use_rules`` it redistributes ``x``
to the placements the rules give (a plain tensor is taken as replicated
first), which is where DTensor inserts the collectives the dry-run
counts.  ``local(fn, ...)`` runs a piece that DTensor has no sharding
strategy for on each device's shards (``local_map``), with the
placements the rules give its arguments and results; with no rules it is
``fn`` itself.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


class Rules:
    def __init__(self, table: Dict[str, MeshAxes], axis_sizes: Dict[str, int],
                 mesh=None):
        self.table = dict(table)
        self.axis_sizes = dict(axis_sizes)
        self.mesh = mesh

    def _resolve(self, name: Optional[str]) -> Tuple[str, ...]:
        ax = self.table.get(name) if name else None
        if ax is None:
            return ()
        if isinstance(ax, str):
            ax = (ax,)
        return tuple(a for a in ax if a in self.axis_sizes)

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        parts, used = [], set()
        for i, name in enumerate(logical):
            kept = [a for a in self._resolve(name) if a not in used]
            size_ok = True
            if shape is not None and kept:
                total = 1
                for a in kept:
                    total *= self.axis_sizes[a]
                size_ok = shape[i] % total == 0
            if kept and size_ok:
                used.update(kept)
                parts.append(tuple(kept) if len(kept) > 1 else kept[0])
            else:
                parts.append(None)
        return tuple(parts)

    def placements(self, logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None):
        """The spec as DTensor placements on ``self.mesh``."""
        return spec_placements(self.mesh, self.spec(logical, shape))


def spec_placements(mesh, spec: Spec):
    """A spec (one entry per tensor dim) -> one placement per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry,) if isinstance(entry, str) else entry:
            out[names.index(a)] = Shard(i)
    return tuple(out)


def local_shape(spec: Spec, shape: Sequence[int],
                axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of ``shape``."""
    out = []
    for n, entry in zip(shape, spec):
        for a in () if entry is None else (
                (entry,) if isinstance(entry, str) else entry):
            n //= axis_sizes[a]
        out.append(n)
    return tuple(out)


# ----------------------------------------------------------------------
# Rule tables, the reference's.  Variants:
#   dp    — the paper's own strategy: pure data parallel (Spark/Elephas).
#   tp    — DP over (pod, data) + tensor parallel over ``model`` (Megatron
#           pattern); decode shards the KV length over ``model``
#           (flash-decoding style).
#   fsdp  — tp + weight/optimizer d_model sharded over ``data``.
#   sp    — activations shard (batch, seq) over (data, model); weights
#           replicated, for archs whose heads do not divide ``model``.
# ----------------------------------------------------------------------

_COMMON_TP = {
    "batch": ("pod", "data"),
    "seq": None,
    "frames": None,
    "heads": "model",
    "kv_heads": "model",
    "heads_x_dim": "model",
    "head_dim": None,
    "head_dim2": None,
    "d_ff": "model",
    "expert_ff": "model",
    "vocab": "model",
    "experts": "model",
    "layers": None,
    "conv": None,
    "state": None,
    "d_model": None,
    "kv_len": None,
}

RULE_TABLES: Dict[str, Dict[str, Dict[str, MeshAxes]]] = {
    "dp": {
        "train": {"batch": ("pod", "data")},
        "prefill": {"batch": ("pod", "data")},
        "decode": {"batch": ("pod", "data")},
    },
    "tp": {
        "train": dict(_COMMON_TP),
        "prefill": {**_COMMON_TP, "kv_len": "model"},
        "decode": {**_COMMON_TP, "kv_len": "model"},
    },
    "fsdp": {
        "train": {**_COMMON_TP, "d_model": "data"},
        "prefill": {**_COMMON_TP, "d_model": "data", "kv_len": "model"},
        "decode": {**_COMMON_TP, "kv_len": "model", "d_model": "data"},
    },
    "sp": {
        "train": {**_COMMON_TP, "seq": "model", "d_model": None,
                  "d_ff": None, "vocab": "model"},
        "prefill": {**_COMMON_TP, "seq": "model", "d_ff": None},
        "decode": {**_COMMON_TP, "kv_len": "model"},
    },
}


def make_rules(mesh, mode: str, variant: str = "tp") -> Rules:
    """Rules for ``mode`` under ``variant`` on ``mesh`` (a ``DeviceMesh``,
    or anything with ``axis_names`` and ``devices.shape``, for a schema
    walk with no mesh behind it)."""
    table = RULE_TABLES[variant][mode]
    if hasattr(mesh, "mesh_dim_names"):
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        return Rules(table, sizes, mesh)
    return Rules(table, dict(zip(mesh.axis_names, mesh.devices.shape)))


# ----------------------------------------------------------------------
_ACTIVE: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "sharding_rules", default=None
)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    tok = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(tok)


def active_rules() -> Optional[Rules]:
    return _ACTIVE.get()


def as_dtensor(x, mesh):
    """``x`` as a DTensor on ``mesh``: a plain tensor is each device's
    whole copy (replicated)."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def local_tensor(x):
    """A DTensor's shard on this device (DTensors live under rules); any
    other tensor as it is."""
    if _ACTIVE.get() is None:
        return x
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def placed_like(tree, ref):
    """Each DTensor leaf of ``tree`` redistributed to the placements of
    ``ref``'s leaf (a gradient to its parameter's: the data-parallel
    reduction); plain leaves as they are."""
    if _ACTIVE.get() is None:
        return tree
    if isinstance(tree, dict):
        return {k: placed_like(v, ref[k]) for k, v in tree.items()}
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor) and isinstance(ref, DTensor):
        return tree.redistribute(ref.device_mesh, ref.placements)
    return tree


def global_offset(x, dim: int) -> int:
    """Where this device's shard of DTensor ``x`` starts along ``dim``
    (even shards, mesh dimensions nested outermost first)."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    size, off = x.shape[dim], 0
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.dim() == dim % x.dim():
            size //= mesh.size(m)
            off += int(coord[m]) * size
    return off


def shard(x, *logical: Optional[str]):
    """Constrain ``x`` to the placements its logical axes give (no-op
    without rules)."""
    rules = _ACTIVE.get()
    if rules is None:
        return x
    assert len(logical) == x.dim(), (logical, tuple(x.shape))
    x = as_dtensor(x, rules.mesh)
    placements = rules.placements(logical, x.shape)
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, placements)
    return x.redistribute(rules.mesh, placements)


class _Constrain(torch.autograd.Function):
    """A constraint under autograd: forward, the redistribution; backward,
    the gradient brought to the constraint's placements, then to the
    input's, where a pending sum (``Partial``) takes the whole gradient
    (``Replicate``), as the backward of a sum does.  (DTensor's own
    backward of ``Partial -> Replicate`` leaves the gradient partial,
    which the next product can only meet by gathering its weight.)"""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.src, ctx.dst = x.placements, placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate

        mesh = g.device_mesh
        g = g.redistribute(mesh, ctx.dst)
        src = [Replicate() if p.is_partial() else p for p in ctx.src]
        return g.redistribute(mesh, src), None


def local(fn, in_logical, out_logical):
    """``fn`` run on each device's shards under the active rules.

    ``in_logical``: one logical tuple per positional argument (None for a
    non-tensor argument); ``out_logical``: one per output (a tuple of
    them for a tuple of outputs).  An output's logical axes are resolved
    against the global shape of the argument dimension that carries the
    same name, so a batch of 1 that stays replicated going in stays so
    coming out.  With no rules active this returns ``fn``."""
    rules = _ACTIVE.get()
    if rules is None:
        return fn

    def on_shards(*args):
        with use_rules(None):       # plain tensors inside: no constraints
            return fn(*args)

    def call(*args):
        from torch.distributed.tensor.experimental import local_map

        sizes = {}
        in_pl = []
        for a, lg in zip(args, in_logical):
            if lg is None:
                in_pl.append(None)
                continue
            sizes.update({n: s for n, s in zip(lg, a.shape) if n})
            in_pl.append(rules.placements(lg, a.shape))
        single = isinstance(out_logical[0], (str, type(None)))
        outs = (out_logical,) if single else out_logical
        out_pl = []
        for lg in outs:
            shape = [sizes.get(n, 0) if n else 1 for n in lg]
            # a name no argument carries resolves as replicated
            spec = rules.spec([n if sizes.get(n) else None for n in lg],
                              shape)
            out_pl.append(spec_placements(rules.mesh, spec))
        mapped = local_map(on_shards, out_placements=tuple(out_pl), in_placements=tuple(in_pl),
                           device_mesh=rules.mesh, redistribute_inputs=True)
        args = tuple(as_dtensor(a, rules.mesh) if lg is not None else a
                     for a, lg in zip(args, in_logical))
        return mapped(*args)

    return call
