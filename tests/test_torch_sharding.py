"""The port's sharding rules and the model's sharding schema against the
reference's, at full size and with nothing allocated: ``Rules.spec`` over
a sweep of logical axes and shapes, and for every architecture, mode and
rules variant the parameters' specs (and the DTensor placements they
become), the caches' specs, the input shapes and the layer signatures.

The reference's ``make_rules`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in object gives it the production
mesh without 256 JAX devices."""
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ARCH_IDS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.models import sharding as port_sharding  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.models.module import ParamSpec, count_params  # noqa: E402

VARIANTS = ("dp", "tp", "fsdp", "sp")
MODES = ("train", "prefill", "decode")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
NAMES = (None, "batch", "seq", "heads", "kv_heads", "head_dim", "d_ff",
         "vocab", "experts", "d_model", "kv_len", "layers", "embed_d")


def _stand_in(shape, names):
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=np.int8))


def _rules(mesh_key, mode, variant):
    from repro.models.sharding import make_rules as ref_make_rules

    mesh = _stand_in(*MESHES[mesh_key])
    return (ref_make_rules(mesh, mode, variant),
            port_sharding.make_rules(mesh, mode, variant))


def _specs_equal(ref_tree, port_tree, where=""):
    if isinstance(ref_tree, dict):
        assert sorted(ref_tree) == sorted(port_tree), where
        for k in ref_tree:
            _specs_equal(ref_tree[k], port_tree[k], f"{where}/{k}")
        return
    assert tuple(ref_tree) == port_tree, (where, ref_tree, port_tree)


def test_rule_tables_are_the_references():
    from repro.models.sharding import RULE_TABLES

    assert port_sharding.RULE_TABLES == RULE_TABLES


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_rules_spec_matches_the_reference(variant, mode, mesh_key):
    """Shape-aware filtering and first-wins dedup, rule for rule, over
    every logical tuple of up to three names and sizes that do and do not
    divide the mesh axes."""
    ref, port = _rules(mesh_key, mode, variant)
    rng = np.random.default_rng(0)
    sizes = (1, 2, 6, 16, 24, 32, 51865, 256)
    for n in (1, 2, 3):
        for logical in itertools.product(NAMES, repeat=n):
            shape = tuple(int(s) for s in rng.choice(sizes, size=n))
            assert tuple(ref.spec(logical, shape)) == \
                port.spec(logical, shape), (logical, shape)
            assert tuple(ref.spec(logical)) == port.spec(logical)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_schema_logical_axes_are_the_references(arch):
    """Every parameter leaf has the reference's shape, logical axes, init,
    fan-in axis and dtype override."""
    from repro.models.api import Model as RefModel
    from repro.models.module import ParamSpec as RefSpec

    import jax

    ref = jax.tree.leaves(RefModel(get_config(arch)).schema(),
                          is_leaf=lambda x: isinstance(x, RefSpec))
    port = sorted_leaves(Model(get_config(arch), "cpu").schema())
    assert len(ref) == len(port)
    for r, p in zip(ref, port):
        assert isinstance(p, ParamSpec)
        assert (tuple(r.shape), tuple(r.logical), r.init, r.scale_dim,
                r.dtype) == (p.shape, p.logical, p.init, p.scale_dim,
                             p.dtype)


def test_param_spec_checks_its_logical_axes():
    with pytest.raises(AssertionError):
        ParamSpec((4, 8), ("d_model",))
    from repro.models.module import count_params as ref_count

    for arch in ARCH_IDS:
        from repro.models.api import Model as RefModel
        assert count_params(Model(get_config(arch), "cpu").schema()) == \
            ref_count(RefModel(get_config(arch)).schema())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_match_the_reference(arch):
    """Full size, every mode and variant at (16, 16), and tp at
    (2, 16, 16): the parameters' and the decode caches' specs."""
    from repro.models.api import Model as RefModel

    cfg = get_config(arch)
    ref_model, port_model = RefModel(cfg), Model(cfg, "cpu")
    shape = SHAPES["decode_32k"]
    cases = [("16x16", m, v) for m in MODES for v in VARIANTS] + \
        [("pod2x16x16", m, "tp") for m in MODES]
    for mesh_key, mode, variant in cases:
        ref, port = _rules(mesh_key, mode, variant)
        _specs_equal(ref_model.param_pspecs(ref),
                     port_model.param_pspecs(port),
                     f"{mesh_key}/{mode}/{variant}")
        _specs_equal(ref_model.cache_pspecs(ref, shape.global_batch,
                                            shape.seq_len),
                     port_model.cache_pspecs(port, shape.global_batch,
                                             shape.seq_len),
                     f"cache {mesh_key}/{mode}/{variant}")


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _shapes_equal(ref_tree, port_tree, where=""):
    if isinstance(ref_tree, dict):
        assert sorted(ref_tree) == sorted(port_tree), where
        for k in ref_tree:
            _shapes_equal(ref_tree[k], port_tree[k], f"{where}/{k}")
        return
    assert isinstance(port_tree, torch.Tensor)
    assert (tuple(ref_tree.shape), str(ref_tree.dtype)) == \
        (tuple(port_tree.shape), _dtype_name(port_tree)), where


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_signatures_match_the_reference(arch):
    """Every shape's abstract batch (decode: the caches too) as fake
    tensors of the reference's shapes and dtypes, the abstract parameters,
    the caches' logical axes and the layer signatures."""
    from repro.models.api import Model as RefModel

    cfg = get_config(arch)
    ref_model, port_model = RefModel(cfg), Model(cfg, "cpu")
    for shape in SHAPES.values():
        _shapes_equal(ref_model.input_specs(shape),
                      port_model.input_specs(shape), shape.name)
    _shapes_equal(ref_model.abstract_params(), port_model.abstract_params())
    assert ref_model.cache_logical() == port_model.cache_logical()
    assert ref_model.layer_signatures() == port_model.layer_signatures()


def test_placements_follow_the_reference_specs():
    """The DTensor placements the port builds for each parameter leaf
    (qwen3 and jamba, every variant, train) are the reference spec's: a
    tensor dimension's mesh axes become ``Shard`` on those mesh
    dimensions, every other mesh dimension ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro.models.api import Model as RefModel

    names = ("data", "model")
    mesh = types.SimpleNamespace(ndim=2, mesh_dim_names=names)
    for arch in ("qwen3-0.6b", "jamba-1.5-large-398b"):
        cfg = get_config(arch)
        schema = Model(cfg, "cpu").schema()
        for variant in VARIANTS:
            ref, port = _rules("16x16", "train", variant)
            port.mesh = mesh
            ref_specs = jax_leaves(RefModel(cfg).param_pspecs(ref))
            for spec, r in zip(sorted_leaves(schema), ref_specs):
                want = [Replicate(), Replicate()]
                for dim, entry in enumerate(tuple(r)):
                    for ax in (() if entry is None else
                               (entry,) if isinstance(entry, str) else entry):
                        want[names.index(ax)] = Shard(dim)
                assert list(port.placements(spec.logical, spec.shape)) == \
                    want


def sorted_leaves(tree):
    """Leaves in sorted key order, as ``jax.tree.leaves`` walks dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    return [tree]


def jax_leaves(tree):
    import jax
    from jax.sharding import PartitionSpec

    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, PartitionSpec))


def test_shard_is_a_no_op_without_rules():
    x = torch.ones(2, 3)
    assert port_sharding.active_rules() is None
    assert port_sharding.shard(x, "batch", "d_model") is x
    fn = lambda t: t  # noqa: E731
    assert port_sharding.local(fn, (("batch",),), ("batch",)) is fn
