"""Parameter schemas and their seeded initialisation.

A model declares its parameters once as a nested dict of ``ParamSpec``
(shape + logical axes + initializer), mirroring ``repro.models.module``.
From that one declaration come the concrete parameters, their fake
stand-ins for the dry-run (``abstract_params``: nothing allocated) and
their sharding specs under a rules table (``param_pspecs``).
``init_params``
draws every leaf from one ``torch.Generator`` on the target device with
the reference's scale rules:

* ``"embed"``: N(0, 0.02);
* ``"normal"`` / ``"scaled"``: N(0, 1 / fan_in), fan-in read on
  ``scale_dim`` (a negative axis, so layer stacking keeps it);
* ``"zeros"`` / ``"ones"`` as named.

A spec's ``dtype`` overrides the model dtype for its leaf (the MoE
router is float32 whatever the model dtype, as in the reference), except
in a float64 model, which keeps every leaf and every computation in
float64 (a rounding yardstick for float32 runs, on the CPU: the layers
compute through ``at_least_f32`` where they would take float32).

The numbers differ from ``jax.random``'s for the same seed; tests that
compare the two packages bridge the reference's weights instead
(``repro_torch.bridge``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name -> torch dtype."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(DTYPES)}") from None


def at_least_f32(t):
    """``t`` in float32, or as it is where it is float64: where the layers
    compute in float32 whatever the model dtype, a float64 model stays in
    float64."""
    return t if t.dtype == torch.float64 else t.float()


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]   # one logical axis name per dim
    init: str = "normal"          # normal | zeros | ones | scaled | embed
    scale_dim: int = -1           # fan-in axis for "normal"/"scaled"
    dtype: Optional[str] = None   # overrides the model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape,
                                                      self.logical)

    def torch_dtype(self, dtype: str) -> torch.dtype:
        """The leaf's dtype in a model of ``dtype``."""
        return torch_dtype(dtype if dtype == "float64"
                           else self.dtype or dtype)


def init_params(schema, seed: int, dtype: str, device) -> dict:
    """Concrete parameters for ``schema``, drawn depth-first in sorted
    key order, so the weights depend only on the schema and the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(spec: ParamSpec):
        dt = spec.torch_dtype(dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        # scaled in place: one float32 transient per leaf, not two
        v = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        if spec.init == "embed":
            return v.mul_(0.02).to(dt)
        fan_in = spec.shape[spec.scale_dim] if spec.shape else 1
        return v.div_(math.sqrt(max(fan_in, 1))).to(dt)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        return draw(node)

    return walk(schema)


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict, in its key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, depth-first in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def fake_mode():
    """A context in which tensors are fake (shapes and dtypes, no
    storage): the active ``FakeTensorMode`` if there is one, else a new
    one."""
    import contextlib

    from torch._subclasses.fake_tensor import FakeTensorMode

    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE):
        return contextlib.nullcontext()
    return FakeTensorMode()


def abstract_params(schema, dtype: str):
    """Fake tensors of the schema's global shapes and dtypes on the CPU
    (the reference's ShapeDtypeStructs): nothing is allocated
    (``fake_mode``)."""
    with fake_mode():
        return tree_map(lambda s: torch.empty(s.shape,
                                              dtype=s.torch_dtype(dtype)),
                        schema)


def param_pspecs(schema, rules):
    """The schema's sharding specs under ``rules`` (``Rules.spec`` of each
    leaf's logical axes and shape)."""
    return tree_map(lambda s: rules.spec(s.logical, s.shape), schema)


def count_params(schema) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(schema))


def stack_specs(spec_tree, n: int):
    """Add a leading stacked-layers axis to every ParamSpec in a tree."""
    def f(s: ParamSpec):
        assert s.scale_dim < 0, \
            "use negative scale_dim so stacking preserves it"
        return ParamSpec((n,) + s.shape, ("layers",) + s.logical, s.init,
                         s.scale_dim, s.dtype)

    return tree_map(f, spec_tree)
