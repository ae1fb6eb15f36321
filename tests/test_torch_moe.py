"""The port's MoE FFN and the three MoE configs against the reference.

On the CPU, the same numpy inputs go through ``repro.models.moe`` and
``repro_torch.models.moe`` with the reference's weights bridged:

* ``moe_apply`` for SwiGLU, GeGLU and plain gelu experts, at the
  published capacity factor 1.25 (with a router skewed so that some
  (token, expert) pairs overflow and are dropped) and under dropless
  capacity.  ``y`` and the router loss agree within ``atol=rtol=1e-5``:
  float32 on both sides, where only summation order differs (the expert
  products and the softmax over <= 8 experts); a wrong drop, slot or
  gate moves ``y`` by a whole expert's output, >1e-1.
* a float32 router inside a bf16 model: the init and the bridge keep the
  router float32, and routing in float32 on bf16 activations picks the
  reference's experts; ``y`` agrees within ``atol=rtol=2e-2`` (bf16
  rounds each expert output and the gates at the reference's casts,
  but the two frameworks round their bf16 products' sums in other
  places: a few bf16 ulps of values ~1).
* the configs: dbrx-132b, grok-1-314b and jamba-1.5-large-398b are the
  reference's, full and reduced.
* ``route``, the router ``moe_apply`` takes its experts and gates from,
  and ``chip_smoke.py``'s ``PinnedRouting``, which records the plain
  arm's routes and hands them to the kernel arm (the card's model-parity
  gate for stacks whose mamba layers feed near-tie routers): on the
  CPU, where both arms run the plain versions, the two arms agree
  exactly, and every recorded route is taken back.
"""
import dataclasses
import importlib.util
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.models.module import init_params as jax_init  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
MOE_ARCHS = ("dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b")
PUBLISHED = {"dbrx-132b": (16, 4, "swiglu", "layernorm", 48, 8, 128),
             "grok-1-314b": (8, 2, "geglu", "rmsnorm", 48, 8, 128),
             "jamba-1.5-large-398b": (16, 2, "swiglu", "rmsnorm", 64, 8, 128)}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_config_is_the_reference_config(arch):
    full = get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(jax_get_config(arch).reduced())
    assert (full.num_experts, full.num_experts_per_tok, full.mlp_kind,
            full.norm_kind, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim) == PUBLISHED[arch]
    assert full.moe_capacity_factor == 1.25


def _cfg(kind, dropless, dtype="float32"):
    """Reduced dbrx (4 experts, top-2, d_model 256, d_ff 512) with the
    expert kind ``kind``."""
    cfg = dataclasses.replace(get_config("dbrx-132b").reduced(),
                              mlp_kind=kind, dtype=dtype)
    if dropless:
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    return cfg


def _params(cfg, seed=0, skew=0.0):
    """The reference's MoE parameters as numpy (router float32), the
    router's expert-0 column lifted by ``skew`` so that, on inputs with a
    positive mean, expert 0 is picked often enough to overflow its
    capacity."""
    tree = jax.tree.map(np.asarray, jax_init(jmoe.moe_schema(cfg),
                                             jax.random.PRNGKey(seed),
                                             cfg.dtype))
    tree["router"] = tree["router"].copy()
    tree["router"][:, 0] += skew
    return tree


def _run(cfg, tree, x):
    """-> ((y, aux) of the reference, (y, aux) of the port)."""
    jy, jaux = jmoe.moe_apply(jax.tree.map(jnp.asarray, tree), cfg,
                              jnp.asarray(x))
    ty, taux = tmoe.moe_apply(params_from_jax(tree, device="cpu"), cfg,
                              torch.from_numpy(x))
    return (np.asarray(jy.astype(jnp.float32)), float(jaux)), \
        (ty.float().numpy(), float(taux))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_apply_matches_reference(kind, dropless):
    cfg = _cfg(kind, dropless)
    tree = _params(cfg, skew=0.05)
    rng = np.random.default_rng(1)
    # a positive mean makes the skewed column win for most tokens
    x = (rng.normal(size=(2, 16, cfg.d_model)) + 0.25).astype(np.float32)
    (jy, jaux), (ty, taux) = _run(cfg, tree, x)
    np.testing.assert_allclose(ty, jy, **TOL)
    np.testing.assert_allclose(taux, jaux, **TOL)
    # capacity 1.25 drops pairs here (the skewed expert overflows); the
    # dropless run of the same inputs keeps them
    (_, _), (ty_all, _) = _run(_cfg(kind, True), tree, x)
    dropped = np.abs(ty - ty_all).max(axis=-1) > 1e-3
    assert dropped.any() != dropless
    assert tmoe.capacity_for(cfg, 16) == jmoe.capacity_for(cfg, 16) == \
        (16 if dropless else 11)


def test_capacity_matches_reference():
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        for s in (1, 2, 7, 16, 64, 256, 1000):
            assert tmoe.capacity_for(cfg, s) == jmoe.capacity_for(cfg, s)


def test_float32_router_inside_a_bf16_model():
    cfg = _cfg("swiglu", dropless=False, dtype="bfloat16")
    tree = _params(cfg, skew=0.05)
    assert tree["router"].dtype == np.float32
    assert tree["up"].dtype.name == "bfloat16"
    ours = Model(cfg, device="cpu").init(seed=0)
    layer = ours["stack"]["periods"]["slot0"]["ffn"]
    assert layer["router"].dtype == torch.float32
    assert layer["up"].dtype == torch.bfloat16
    bridged = params_from_jax(tree, device="cpu")
    assert bridged["router"].dtype == torch.float32
    assert np.array_equal(bridged["router"].numpy(), tree["router"])
    rng = np.random.default_rng(2)
    x32 = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    x = jnp.asarray(x32).astype(jnp.bfloat16)
    jy, _ = jmoe.moe_apply(jax.tree.map(jnp.asarray, tree), cfg, x)
    tx = torch.from_numpy(x32).to(torch.bfloat16)
    assert np.array_equal(np.asarray(x.astype(jnp.float32)),
                          tx.float().numpy())
    ty, _ = tmoe.moe_apply(bridged, cfg, tx)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               **BF16_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_carries_the_moe_trees(arch):
    """The whole reduced model tree bridges as it is, float32 routers in
    a bf16 model included, and the port's init draws the same shapes and
    dtypes."""
    cfg = dataclasses.replace(jax_get_config(arch).reduced(),
                              dtype="bfloat16")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    bridged = params_from_jax(tree, device="cpu")
    ours = Model(dataclasses.replace(get_config(arch).reduced(),
                                     dtype="bfloat16"), device="cpu").init(0)

    def sig(t):
        return tuple(t.shape), str(t.dtype).replace("torch.", "")

    assert jax.tree.map(sig, ours) == jax.tree.map(sig, bridged) == \
        jax.tree.map(lambda a: (tuple(a.shape), a.dtype.name), tree)
    routers = [leaf for path, leaf in
               jax.tree_util.tree_leaves_with_path(bridged)
               if "router" in jax.tree_util.keystr(path)]
    assert routers and all(r.dtype == torch.float32 for r in routers)


def test_moe_apply_takes_its_routes_from_route():
    cfg = _cfg("swiglu", True)
    tp = params_from_jax(_params(cfg), "cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    y, _ = tmoe.moe_apply(tp, cfg, x)
    probs, gates, idx = tmoe.route(tp, cfg, x)
    assert idx.shape == gates.shape == (2, 16, cfg.num_experts_per_tok)
    with mock.patch.object(tmoe, "route",
                           lambda p, c, v: (probs, gates, idx)):
        assert torch.equal(tmoe.moe_apply(tp, cfg, x)[0], y)
    # another token's experts move the output by whole expert outputs
    with mock.patch.object(tmoe, "route",
                           lambda p, c, v: (probs, gates, idx.roll(1, 1))):
        assert (tmoe.moe_apply(tp, cfg, x)[0] - y).abs().max() > 1e-2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", ["paged", "slot"])
def test_pinned_routing_arms_agree_and_take_every_route(path):
    """Reduced jamba (a mamba layer, then attention + MoE): the plain arm
    routes (one MoE layer: paged, one prefill dispatch and one decode
    step; slot, two prefills and one decode step), the kernel arm takes
    each route back."""
    from repro_torch.kernels import ops, ref
    from repro_torch.serving.kvcache import write_slot
    from repro_torch.serving.server import ragged_dispatch

    cs = _chip_smoke()
    model = Model(get_config("jamba-1.5-large-398b").reduced(),
                  device="cpu")
    params = cs.perturb_mamba(torch, model.init(seed=0), seed=1)
    routed = []
    real = tmoe.route

    def counted(p, cfg, x):
        routed.append(x.shape[:2])
        return real(p, cfg, x)

    with mock.patch.object(tmoe, "route", counted):
        pin = cs.PinnedRouting(ops, ref)
        if path == "paged":
            rel = cs.model_parity(
                torch, "cpu", model, params, ops, ref, ragged_dispatch,
                arms=(("plain", pin.plain), ("kernel", pin.kernel)))
        else:
            rel = cs.slot_model_parity(
                torch, "cpu", model, params, ops, ref, write_slot,
                arms=(pin.plain, pin.kernel))
    assert rel == {"prefill": 0.0, "decode": 0.0}
    assert not pin.seen
    # the plain arm's routes (the replay routes nothing itself), after
    # the paged path's prefix dispatch, which runs before either arm
    want = {"paged": [(4, 200), (4, 96), (4, 1)],
            "slot": [(1, 150), (1, 37), (3, 1)]}[path]
    assert [tuple(r) for r in routed] == want
