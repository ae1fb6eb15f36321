"""The port's training half against the reference, on the CPU.

The same numpy inputs go through the reference (JAX) and the port
(``repro_torch``), whose ``ops`` take the plain versions for CPU tensors:

* optimizers (``sgd``, ``momentum``, ``adam``, ``adamw``, each with a
  constant rate and ``sgd``/``adam`` under a schedule), schedules and
  ``clip_by_global_norm``: 3 steps on the same gradients, parameters and
  the whole state tree leaf by leaf.  float32, ``atol=1e-6``: the same
  operations on the same float32 numbers, a few ulps apart at most;
* ``worker_batches``: the reference's arrays exactly, across a reshuffle;
* one ``round`` of each strategy (W=3, K=2, B=8) on the paper's CNN, from
  the reference's params and state after a first round, bridged.  With
  ``sgd(0.1)``: params and state within ``atol=1e-6, rtol=1e-4``, as
  ``test_cnn_loss_gradients_match_jax`` (gradients summed in another
  order).  With the pipeline's ``adam(1e-3)``: Adam's ``m / (sqrt(v) +
  eps)`` is ~±1 wherever a gradient is tiny, so a gradient that rounding
  puts near 0 may flip its step: every element within ``2 * lr * K`` (one
  flipped step per local step), and >= 99.9 % of elements within 1e-5;
  the loss metric within ``rtol=1e-5``;
* the autograd Function around ``ops.conv2d`` (dx and dw) and the plain
  ``conv2d_wgrad_ref`` against ``jax.vjp`` of the reference's
  ``conv2d_valid`` (``lax.conv``, ``repro/models/cnn.py:37-46``) over the
  reference's conv sweep (``tests/test_kernels.py``).  float32: within
  ``1e-5 * max|want| + 1e-5 * |want|`` (the filter gradient sums up to
  87,880 products, so its rounding scales with the largest value).
  bfloat16: the same inputs rounded to bfloat16 on both sides, the
  reference computing in float32; the port sums in float32 and rounds
  once, so one bfloat16 ulp (``rtol=2**-7``) plus that absolute part.

The pipeline's ``train`` is held in ``tests/test_torch_stratus.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs.mnist_cnn import CONFIG as JCONFIG  # noqa: E402
from repro.core import strategies as jstrat  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.module import init_params as jinit  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.mnist_cnn import CONFIG  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.core import trainer as ttrainer  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

OPT_TOL = dict(atol=1e-6, rtol=0)
TIGHT = dict(atol=1e-6, rtol=1e-4)


def _np(tree):
    """A tree of torch tensors or jax arrays as numpy (float32 for bf16)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def assert_trees_close(got, want, **tol):
    got, want = _leaves(_np(got)), _leaves(_np(want))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **tol)


# ------------------------------------------------------------ optimizers


def _param_tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                  "d": rng.normal(size=(2, 2, 3)).astype(np.float32)}}


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.momentum(0.1, beta=0.8),
    "adam": lambda m: m.adam(1e-2),
    "adamw": lambda m: m.adamw(1e-2, weight_decay=0.1),
    "sgd_cosine_warmup": lambda m: m.sgd(m.cosine_warmup(0.1, 2, 5, 0.01)),
    "adam_constant": lambda m: m.adam(m.constant(1e-2)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_reference(name):
    rng = np.random.default_rng(0)
    params = _param_tree(rng)
    grads = [_param_tree(rng) for _ in range(3)]
    jopt, topt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](toptim)
    jp = jax.tree.map(jnp.asarray, params)
    tp = params_from_jax(params, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    assert_trees_close(ts, js, **OPT_TOL)
    for g in grads:
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = joptim.apply_updates(jp, ju)
        tu, ts = topt.update(params_from_jax(g, device="cpu"), ts, tp)
        tp = toptim.apply_updates(tp, tu)
        assert_trees_close(tu, ju, **OPT_TOL)
        assert_trees_close(ts, js, **OPT_TOL)
        assert_trees_close(tp, jp, **OPT_TOL)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 3


def test_optimizer_state_is_float32_for_bfloat16_params():
    rng = np.random.default_rng(1)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in _param_tree(rng).items() if k == "a"}
    opt = toptim.adam(1e-2)
    state = opt.init(tp)
    upd, state = opt.update({"a": torch.ones(3, 4, dtype=torch.bfloat16)},
                            state, tp)
    assert upd["a"].dtype == torch.bfloat16
    assert state["mu"]["a"].dtype == state["nu"]["a"].dtype == torch.float32
    assert toptim.apply_updates(tp, upd)["a"].dtype == torch.bfloat16


@pytest.mark.parametrize("as_tensor", [False, True], ids=["int", "tensor"])
def test_schedules_match_reference(as_tensor):
    jsched = [joptim.constant(3e-4), joptim.cosine_warmup(0.1, 3, 10, 0.01),
              joptim.cosine_warmup(0.1, 0, 4)]
    tsched = [toptim.constant(3e-4), toptim.cosine_warmup(0.1, 3, 10, 0.01),
              toptim.cosine_warmup(0.1, 0, 4)]
    for step in range(12):
        for jf, tf in zip(jsched, tsched):
            want = float(jf(jnp.asarray(step, jnp.int32)))
            arg = torch.tensor(step, dtype=torch.int32) if as_tensor else step
            got = tf(arg)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), want, **OPT_TOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0], ids=["clips", "passes"])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = _param_tree(np.random.default_rng(2))
    jg, jn = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                        max_norm)
    tg, tn = toptim.clip_by_global_norm(params_from_jax(grads, device="cpu"),
                                        max_norm)
    np.testing.assert_allclose(float(tn), float(jn), **OPT_TOL)
    assert_trees_close(tg, jg, **OPT_TOL)


# ------------------------------------------------------------ data


def test_worker_batches_match_reference():
    """4 rounds of 2 workers x 3 steps x 4 images from 50: the third round
    reshuffles."""
    rng = np.random.default_rng(3)
    x = rng.random((50, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 50).astype(np.int32)
    jit_ = jtrainer.worker_batches(x, y, 2, 3, 4, seed=5)
    tit = ttrainer.worker_batches(x, y, 2, 3, 4, seed=5, device="cpu")
    for _ in range(4):
        want, got = next(jit_), next(tit)
        assert sorted(got) == sorted(want) == ["x", "y"]
        for k in ("x", "y"):
            assert got[k].device.type == "cpu"
            a, b = got[k].numpy(), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape == (
                (2, 3, 4, 4, 4, 1) if k == "x" else (2, 3, 4))
            assert a.tobytes() == b.tobytes()


# ------------------------------------------------------------ strategies


W, K, B = 3, 2, 8


@pytest.fixture(scope="module")
def cnn_case():
    """The reference's seeded CNN weights (numpy) and two rounds of
    (W, K, B) digits."""
    params = jax.tree.map(np.asarray, jinit(
        jcnn.cnn_schema(JCONFIG), jax.random.PRNGKey(11), "float32"))
    rng = np.random.default_rng(12)
    rounds = [{"x": rng.random((W, K, B, 28, 28, 1)).astype(np.float32),
               "y": rng.integers(0, 10, (W, K, B)).astype(np.int32)}
              for _ in range(2)]
    return params, rounds


def _jloss(p, b):
    return jcnn.cnn_loss(p, JCONFIG, b["x"], b["y"])


def _tloss(p, b):
    return tcnn.cnn_loss(p, CONFIG, b["x"], b["y"])


def _params_within_adam_limits(got, want, lr):
    for name, g in _leaves(_np(got)):
        w = dict(_leaves(_np(want)))[name]
        diff = np.abs(g - w)
        assert diff.max() <= 2 * lr * K, (name, diff.max())
        assert np.mean(diff <= 1e-5) >= 0.999, (name, np.mean(diff <= 1e-5))


@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
@pytest.mark.parametrize("strategy", sorted(tstrat.STRATEGIES))
def test_strategy_round_matches_reference(cnn_case, strategy, opt_name):
    params, (first, second) = cnn_case
    lr = 0.1 if opt_name == "sgd" else 1e-3
    jopt = getattr(joptim, opt_name)(lr)
    jst = jstrat.make_strategy(strategy, jopt, W)
    jp = jax.tree.map(jnp.asarray, params)
    # a first reference round, so the bridged state is not the init's
    jp, js, _ = jst.round(jp, jst.init(jp), jax.tree.map(jnp.asarray, first),
                          _jloss)
    tst = tstrat.make_strategy(strategy, getattr(toptim, opt_name)(lr), W)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ts = params_from_jax(jax.tree.map(np.asarray, js), device="cpu")
    assert_trees_close(tst.init(tp), jst.init(jp), **OPT_TOL)

    jp2, js2, jm = jst.round(jp, js, jax.tree.map(jnp.asarray, second),
                             _jloss)
    tp2, ts2, tm = tst.round(tp, ts, params_from_jax(second, device="cpu"),
                             _tloss)
    assert sorted(tm) == sorted(jm) == ["loss"]
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    if opt_name == "sgd":
        assert_trees_close(tp2, jp2, **TIGHT)
        assert_trees_close(ts2, js2, **TIGHT)
    else:
        _params_within_adam_limits(tp2, jp2, lr)
        if "params_w" in js2:
            _params_within_adam_limits(ts2["params_w"], js2["params_w"], lr)
        opt_key = "opt" if "opt" in js2 else "opt_w"
        assert_trees_close(ts2[opt_key]["count"], js2[opt_key]["count"])
        for moment in ("mu", "nu"):
            assert_trees_close(ts2[opt_key][moment], js2[opt_key][moment],
                               **TIGHT)


# ------------------------------------------------------------ conv gradients


CONV_SHAPES = [
    # (B, H, W, Cin, K, Cout): the reference's sweep
    (5, 28, 28, 1, 3, 32),       # the paper's CNN
    (130, 28, 28, 1, 3, 32),     # batch > block
    (4, 12, 16, 3, 5, 8),        # rectangular, 5x5
    (2, 9, 9, 2, 1, 4),          # 1x1
]


def _conv_grad_case(shape, dtype):
    """x, w and the output cotangent g as numpy float32 holding values of
    ``dtype``, and the reference's (dx, dw) of ``conv2d_valid`` in
    float32 on them."""
    b, h, w, cin, k, cout = shape
    rng = np.random.default_rng(6)
    arrays = [rng.normal(size=s).astype(np.float32) for s in (
        (b, h, w, cin), (k, k, cin, cout), (b, h - k + 1, w - k + 1, cout))]
    arrays[1] *= 0.2
    if dtype == "bfloat16":
        arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                  for a in arrays]
    x, wt, g = arrays
    _, vjp = jax.vjp(jcnn.conv2d_valid, jnp.asarray(x), jnp.asarray(wt))
    dx, dw = vjp(jnp.asarray(g))
    return (x, wt, g), (np.asarray(dx), np.asarray(dw))


def _assert_grad_close(got, want, dtype, name):
    got = got.float().numpy()
    scale = float(np.abs(want).max())
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=rtol,
                               err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv2d_function_gradients_match_reference(shape, dtype):
    (x, wt, g), (dx, dw) = _conv_grad_case(shape, dtype)
    tdt = getattr(torch, dtype)
    tx, tw = (torch.from_numpy(a).to(tdt).requires_grad_(True)
              for a in (x, wt))
    ops.reset_launch_counts()
    out = ops.conv2d(tx, tw)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(tdt))
    assert tx.grad.dtype == tw.grad.dtype == tdt
    _assert_grad_close(tx.grad, dx, dtype, "dx")
    _assert_grad_close(tw.grad, dw, dtype, "dw")
    assert set(ops.launch_counts().values()) == {0}      # plain versions


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv2d_wgrad_plain_matches_reference(shape, dtype):
    (x, _, g), (_, dw) = _conv_grad_case(shape, dtype)
    tdt = getattr(torch, dtype)
    k = shape[4]
    got = ref.conv2d_wgrad_ref(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(g).to(tdt), k, k)
    assert got.dtype == tdt and tuple(got.shape) == dw.shape
    _assert_grad_close(got, dw, dtype, "dw")
