"""Parameter schemas and their seeded initialisation.

A model declares its parameters once as a nested dict of ``ParamSpec``
(shape + initializer), mirroring ``repro.models.module``.  ``init_params``
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
    init: str = "normal"          # normal | zeros | ones | scaled | embed
    scale_dim: int = -1           # fan-in axis for "normal"/"scaled"
    dtype: Optional[str] = None   # overrides the model dtype


def init_params(schema, seed: int, dtype: str, device) -> dict:
    """Concrete parameters for ``schema``, drawn depth-first in sorted
    key order, so the weights depend only on the schema and the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(spec: ParamSpec):
        dt = torch_dtype(dtype if dtype == "float64"
                         else spec.dtype or dtype)
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


def stack_specs(spec_tree, n: int):
    """Add a leading stacked-layers axis to every ParamSpec in a tree."""
    if isinstance(spec_tree, dict):
        return {k: stack_specs(v, n) for k, v in spec_tree.items()}
    s = spec_tree
    assert s.scale_dim < 0, "use negative scale_dim so stacking preserves it"
    return ParamSpec((n,) + s.shape, s.init, s.scale_dim, s.dtype)
