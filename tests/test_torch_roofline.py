"""The port's roofline arithmetic against the reference's: ``model_flops``
and the recurrent cores' analytic cost for every architecture and
shape, the ring factors, how a collective is priced by the links its
group crosses, and the terms' dominance."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import rwkv6 as rwkv_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.roofline.analysis import (RooflineResult,  # noqa: E402
                                           collective_bytes, model_flops,
                                           roofline_terms)


def test_shapes_are_the_references():
    from repro.configs.shapes import SHAPES as REF

    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == \
        {k: tuple(vars(v).values()) for k, v in REF.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(arch):
    from repro.configs.base import get_config as ref_config
    from repro.configs.shapes import SHAPES as REF
    from repro.roofline.analysis import model_flops as ref_model_flops

    for name, shape in SHAPES.items():
        assert model_flops(get_config(arch), shape) == \
            ref_model_flops(ref_config(arch), REF[name])


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "rwkv6-1.6b"])
@pytest.mark.parametrize("batch,seq", [(1, 1), (32, 32_768), (256, 4_096),
                                       (1, 524_288)])
def test_recurrence_cost_matches_the_reference(arch, batch, seq):
    from repro.configs.base import get_config as ref_config
    from repro.models import rwkv6 as ref_rwkv
    from repro.models import ssm as ref_ssm

    port, ref = ((ssm_mod, ref_ssm) if arch.startswith("jamba")
                 else (rwkv_mod, ref_rwkv))
    assert port.recurrence_cost(get_config(arch), batch, seq) == \
        ref.recurrence_cost(ref_config(arch), batch, seq)


def test_ring_factors_are_the_references():
    from repro.roofline.analysis import _FACTOR as REF
    from repro_torch.roofline.analysis import _FACTOR

    assert _FACTOR == REF


def test_collectives_priced_by_their_slowest_link():
    """All ranks in one node of 8: NVLink; a group crossing nodes:
    InfiniBand.  An all-reduce moves twice its buffer (ring)."""
    node = tuple(range(8))
    across = tuple(range(0, 256, 16))           # a "data" group
    model = tuple(range(16))                    # a 16-way "model" group
    w, kinds, secs = collective_bytes([("all-reduce", 1e9, node),
                                       ("all-gather", 1e9, across),
                                       ("reduce-scatter", 5e8, model)])
    assert kinds == {"all-reduce": 1e9, "all-gather": 1e9,
                     "reduce-scatter": 5e8}
    assert w == 2e9 + 1e9 + 5e8
    assert secs == pytest.approx(2e9 / mesh_mod.NVLINK_BYTES_PER_S
                                 + 1e9 / mesh_mod.IB_BYTES_PER_S
                                 + 5e8 / mesh_mod.IB_BYTES_PER_S)
    assert mesh_mod.link_bytes_per_s(range(8, 16)) == \
        mesh_mod.NVLINK_BYTES_PER_S
    assert mesh_mod.link_bytes_per_s((7, 8)) == mesh_mod.IB_BYTES_PER_S


def test_roofline_terms_priced_with_the_h100_constants():
    r = roofline_terms(989e12, 3.35e12, [("all-reduce", 225e9,
                                          tuple(range(8)))])
    t = r.terms()
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert roofline_terms(1e15, 1.0).dominant == "compute"
    assert roofline_terms(1.0, 1e13).dominant == "memory"
    assert RooflineResult(1.0, 1.0, 0.0, {}, 10.0).dominant == "collective"
    assert mesh_mod.PEAK_FLOPS["bfloat16"] == 989e12
    assert mesh_mod.HBM_BYTES == 80 * 2 ** 30


def test_mesh_module_touches_no_process_group_on_import():
    """Importing the mesh, sharding and dry-run modules makes no process
    group (a fresh interpreter)."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    code = ("import torch.distributed as d\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "assert not d.is_initialized()\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env={**os.environ, "PYTHONPATH": str(root / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert math.prod(mesh_mod.PRODUCTION_SHAPES[True][0]) == 512
