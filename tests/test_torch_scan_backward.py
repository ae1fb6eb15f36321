"""The backward of the two recurrences, on the CPU.

* ``ref.rwkv6_scan_bwd_ref`` and ``ref.ssm_scan_bwd_ref`` (the plain
  versions that the ``rwkv6_scan_bwd`` / ``ssm_scan_bwd`` kernels are held
  to, and that ``ops``'s autograd Functions run for CPU tensors) against
  ``torch.autograd.grad`` of the forward plain versions, in float64: every
  gradient within 1e-10 x its max|g| (the same sums in another order, at
  float64).  Sequence lengths 1, 33 and 70 (not multiples of the
  kernels' 16-step chunks), a non-zero start state and a given gradient
  of the final state; masked lanes (rwkv6: decay 1 and key 0; mamba:
  dt = 0), whose state and its adjoint carry through; mamba with bf16 x
  (and dy), whose dx is the float32 run's within 2 bf16 ulps.
* The Functions: only the gradients autograd asks for, a gradient of the
  final state left out counting as zeros, nothing kept under
  ``torch.no_grad()`` or ``torch.inference_mode()``.
* The port's ``rwkv_time_mix`` and ``ssm_forward`` through the Functions
  against ``jax.value_and_grad`` of the reference's (``repro/models/
  rwkv6.py:159``, ``repro/models/ssm.py:113``) on bridged reduced-width
  weights (the init's constant leaves drawn from a seed): the gradients of
  x, of every parameter and of the start state, float32.  The loss within
  1e-5, each leaf within 1e-4 x its max|g|, as
  ``tests/test_torch_llm_train.py`` holds ``Model.loss``.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.module import init_params as jax_init  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

F64_REL = 1e-10
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rel, name=""):
    got = got.detach().double().numpy()
    want = want.detach().double().numpy()
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


def rwkv_inputs(s, *, b=2, h=3, hd=8, seed=0, masked=False):
    """float64 r, k, v, w, u, s0, and the cotangents of out and s_final;
    masked: row 1's lanes from s // 2 on get decay 1 and key 0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, h, s, hd)) for _ in range(3))
    w = rng.uniform(0.05, 0.99, size=(b, h, s, hd))
    if masked:
        w[1, :, s // 2:] = 1.0
        k[1, :, s // 2:] = 0.0
    u = rng.normal(size=(h, hd))
    s0 = rng.normal(size=(b, h, hd, hd)) * 0.5
    dout = rng.normal(size=(b, h, s, hd))
    dsf = rng.normal(size=(b, h, hd, hd))
    return [_t(a) for a in (r, k, v, w, u, s0)], _t(dout), _t(dsf)


def ssm_inputs(s, *, b=2, di=8, n=16, seed=0, masked=False):
    """float64 dt, bm, cm, x, a, h0, and the cotangents of y and h_final;
    masked: row 1's lanes from s // 2 on get dt = 0."""
    rng = np.random.default_rng(seed)
    dt = rng.uniform(0.0, 0.6, size=(b, s, di))
    if masked:
        dt[1, s // 2:] = 0.0
    bm, cm = (rng.normal(size=(b, s, n)) for _ in range(2))
    x = rng.normal(size=(b, s, di))
    a = -np.exp(rng.normal(size=(di, n)))
    h0 = rng.normal(size=(b, di, n))
    dy = rng.normal(size=(b, s, di))
    dhf = rng.normal(size=(b, di, n))
    return [_t(a_) for a_ in (dt, bm, cm, x, a, h0)], _t(dy), _t(dhf)


def _autograd(fwd, inputs, cots):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    outs = fwd(*leaves)
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, leaves)


# ------------------------------------------------------------ plain versions


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("s", [1, 33, 70])
def test_rwkv6_scan_bwd_ref_matches_autograd(s, masked):
    inputs, dout, dsf = rwkv_inputs(s, masked=masked)
    want = _autograd(ref.rwkv6_scan_ref, inputs, (dout, dsf))
    got = ref.rwkv6_scan_bwd_ref(*inputs, dout, dsf)
    for name, g, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert g.dtype == torch.float64, name
        _close(g, w, F64_REL, name)
    if masked:
        # a masked lane leaves its adjoint alone: k there gets the state's
        # adjoint times v, w its adjoint times the (carried) state
        assert got[3][1, :, s // 2:].abs().max() > 0


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("s", [1, 33, 70])
def test_ssm_scan_bwd_ref_matches_autograd(s, masked):
    inputs, dy, dhf = ssm_inputs(s, masked=masked)
    want = _autograd(ref.ssm_scan_ref, inputs, (dy, dhf))
    got = ref.ssm_scan_bwd_ref(*inputs, dy, dhf)
    for name, g, w in zip(("ddt", "dbm", "dcm", "dx", "da", "dh0"), got,
                          want):
        assert g.dtype == torch.float64, name
        _close(g, w, F64_REL, name)
    if masked:
        # dt = 0 lanes: the state and its adjoint pass unchanged, so dx
        # there is 0 and the start state's gradient still sees dh_final
        assert float(got[3][1, s // 2:].abs().max()) == 0.0


def test_final_state_gradient_left_out_is_zeros():
    inputs, dout, _ = rwkv_inputs(9)
    a = ref.rwkv6_scan_bwd_ref(*inputs, dout)
    b = ref.rwkv6_scan_bwd_ref(*inputs, dout, torch.zeros_like(inputs[5]))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    inputs, dy, _ = ssm_inputs(9)
    a = ref.ssm_scan_bwd_ref(*inputs, dy)
    b = ref.ssm_scan_bwd_ref(*inputs, dy, torch.zeros_like(inputs[5]))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_ssm_scan_bwd_ref_bf16_x_within_two_ulps_of_float32():
    """x and dy in bf16 (as jamba's scan reads x and gets dy): dx in bf16
    is the float32 run's (on the same bf16 values) rounded, within 2
    bf16 ulps; the float32 gradients agree to float32 rounding."""
    inputs, dy, dhf = ssm_inputs(40, di=16, seed=3)
    inputs = [t.float() for t in inputs]
    x16, dy16 = inputs[3].bfloat16(), dy.bfloat16()
    got = ref.ssm_scan_bwd_ref(*inputs[:3], x16, *inputs[4:], dy16,
                               dhf.float())
    want = ref.ssm_scan_bwd_ref(*inputs[:3], x16.float(), *inputs[4:],
                                dy16.float(), dhf.float())
    assert got[3].dtype == torch.bfloat16 and got[0].dtype == torch.float32
    g, w = got[3].float(), want[3]
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    assert bool(((g - w).abs() <= 2 * ulp).all())
    for name, a, b in zip(("ddt", "dbm", "dcm", "da", "dh0"),
                          got[:3] + got[4:], want[:3] + want[4:]):
        _close(a, b, 1e-6, name)


# ------------------------------------------------------------ the Functions


def test_functions_give_only_the_gradients_asked_for():
    """u alone requires a gradient: the others stay None; the Function's
    u gradient is the plain backward's; no s_final gradient is zeros."""
    inputs, dout, _ = rwkv_inputs(20)
    r, k, v, w, u, s0 = inputs
    u = u.clone().requires_grad_(True)
    out, sf = ops.rwkv6_scan(r, k, v, w, u, s0)
    (out * dout).sum().backward()
    want = ref.rwkv6_scan_bwd_ref(r, k, v, w, u.detach(), s0, dout)
    assert torch.equal(u.grad, want[4])
    assert r.grad is None and s0.grad is None
    inputs, dy, dhf = ssm_inputs(20)
    leaves = [t.clone().requires_grad_(i in (0, 3)) for i, t in
              enumerate(inputs)]
    y, hf = ops.ssm_scan(*leaves)
    (hf * dhf).sum().backward()                 # y's gradient: none
    want = ref.ssm_scan_bwd_ref(*inputs, torch.zeros_like(dy), dhf)
    assert torch.equal(leaves[0].grad, want[0])
    assert torch.equal(leaves[3].grad, want[3])
    assert all(t.grad is None for i, t in enumerate(leaves) if i not in (0,
                                                                          3))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_functions_keep_nothing_without_grad(mode):
    ctx = torch.no_grad() if mode == "no_grad" else torch.inference_mode()
    inputs, _, _ = rwkv_inputs(5)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    with ctx:
        out, sf = ops.rwkv6_scan(*leaves)
    assert not out.requires_grad and out.grad_fn is None
    inputs, _, _ = ssm_inputs(5)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    with ctx:
        y, hf = ops.ssm_scan(*leaves)
    assert not y.requires_grad and y.grad_fn is None
    want = ref.ssm_scan_ref(*inputs)
    assert torch.equal(y, want[0]) and torch.equal(hf, want[1])


def test_functions_match_autograd_of_the_plain_forward():
    """Through ``ops`` (the Functions, CPU path) against autograd of the
    forward plain versions, float64, every input requiring a gradient."""
    for inputs, cots, fn, fwd in (
            (*rwkv_inputs(37, masked=True)[:1],
             rwkv_inputs(37, masked=True)[1:], ops.rwkv6_scan,
             ref.rwkv6_scan_ref),
            (*ssm_inputs(37, masked=True)[:1],
             ssm_inputs(37, masked=True)[1:], ops.ssm_scan,
             ref.ssm_scan_ref)):
        want = _autograd(fwd, inputs, cots)
        got = _autograd(fn, inputs, cots)
        for g, w in zip(got, want):
            _close(g, w, F64_REL)


def test_rwkv6_scan_takes_no_start_state_as_zeros():
    """s0 None, with and without gradients: the outputs and every
    gradient equal a zero start state's."""
    inputs, dout, dsf = rwkv_inputs(21)
    r, k, v, w, u, _ = inputs
    zeros = torch.zeros_like(inputs[5])
    with torch.no_grad():
        assert all(torch.equal(a, b) for a, b in zip(
            ops.rwkv6_scan(r, k, v, w, u), ops.rwkv6_scan(r, k, v, w, u,
                                                          zeros)))
    got = _autograd(lambda *t: ops.rwkv6_scan(*t), [r, k, v, w, u],
                    [dout, dsf])
    want = _autograd(lambda *t: ops.rwkv6_scan(*t, zeros), [r, k, v, w, u],
                     [dout, dsf])
    assert all(torch.equal(g, h) for g, h in zip(got, want))


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode",
                                  "no_input_requires_grad"])
def test_calls_without_gradients_skip_the_functions(mode):
    """Where no gradient can be asked for (serving), ``ops`` calls the
    plain version (the kernel on the card) alone, not through the
    autograd Functions: the same outputs, no graph."""
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "no_input_requires_grad": torch.enable_grad}[mode]
    needs = mode != "no_input_requires_grad"
    refuse = AssertionError("an autograd Function was applied")
    with mock.patch.object(ops._Rwkv6Scan, "apply", side_effect=refuse), \
            mock.patch.object(ops._SsmScan, "apply", side_effect=refuse):
        for inputs, fn, fwd in ((rwkv_inputs(9)[0], ops.rwkv6_scan,
                                 ref.rwkv6_scan_ref),
                                (ssm_inputs(9)[0], ops.ssm_scan,
                                 ref.ssm_scan_ref)):
            leaves = [t.clone().requires_grad_(needs) for t in inputs]
            with ctx():
                got = fn(*leaves)
            want = fwd(*inputs)
            assert all(torch.equal(g, w_) and g.grad_fn is None
                       for g, w_ in zip(got, want))


# ------------------------------------------------------------ the layers


def _check_grads(tree_got, tree_want, prefix=""):
    if isinstance(tree_want, dict):
        assert sorted(tree_got) == sorted(tree_want), prefix
        for key in tree_want:
            _check_grads(tree_got[key], tree_want[key], f"{prefix}/{key}")
        return
    want = np.asarray(tree_want, dtype=np.float64)
    got = tree_got.detach().double().numpy()
    assert got.shape == want.shape, prefix
    assert np.abs(want).max() > 0, prefix        # every leaf is live
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_REL * scale,
                               err_msg=prefix)


def _leafy(tree):
    return jax.tree.map(lambda a: _t(np.array(a)).requires_grad_(True), tree)


def _grads(tree):
    return jax.tree.map(lambda t: t.grad, tree,
                        is_leaf=lambda t: isinstance(t, torch.Tensor))


def _loss_fn(outs, cots, mean_fn):
    """A loss of order 1: the mean of each output times its cotangent."""
    return sum(mean_fn(o * c) for o, c in zip(outs, cots))


def _rwkv_cfg():
    cfg = get_config("rwkv6-1.6b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("rwkv6-1.6b").reduced())
    return cfg


def _rwkv_params(cfg, seed=0):
    """The reference's time-mix weights as numpy, its zero-initialised
    leaves drawn from ``seed`` (as ``tests/test_torch_rwkv6.py`` does)."""
    tree = jax.tree.map(np.asarray, jax_init(
        jrwkv.rwkv_schema(cfg), jax.random.PRNGKey(seed), cfg.dtype))
    rng = np.random.default_rng(seed + 1)
    draw = {"mu": lambda s: rng.uniform(0, 1, s),
            "w_base": lambda s: rng.normal(0, 1, s),
            "u": lambda s: rng.normal(0, 0.5, s),
            "mix_b": lambda s: rng.normal(0, 0.1, s),
            "w_b": lambda s: rng.normal(0, 0.1, s)}
    return {k: (draw[k](v.shape).astype(v.dtype) if k in draw else v)
            for k, v in tree.items()}


def test_rwkv_time_mix_gradients_match_reference():
    """x (2 rows of 21 tokens), every time-mix weight and the start state
    (``s``, ``x_tm``), one seeded cotangent each for y, s and x_tm."""
    cfg = _rwkv_cfg()
    tree = _rwkv_params(cfg)
    rng = np.random.default_rng(5)
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    x = rng.normal(size=(2, 21, cfg.d_model)).astype(np.float32)
    st = {"s": (rng.normal(size=(2, h, hd, hd)) * 0.3).astype(np.float32),
          "x_tm": rng.normal(size=(2, cfg.d_model)).astype(np.float32)}
    cots = [rng.normal(size=shape).astype(np.float32) for shape in
            (x.shape, st["s"].shape, st["x_tm"].shape)]

    def jloss(p, x, st):
        y, new = jrwkv.rwkv_time_mix(p, cfg, x, st)
        return _loss_fn((y, new["s"], new["x_tm"]), cots, jnp.mean)

    want_loss, want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
        jax.tree.map(jnp.asarray, st))
    tp = {k: v.requires_grad_(True) for k, v in
          params_from_jax(tree, device="cpu").items()}
    tx, tst = _leafy(x), _leafy(st)
    y, new = trwkv.rwkv_time_mix(tp, cfg, tx, tst)
    loss = _loss_fn((y, new["s"], new["x_tm"]), map(_t, cots), torch.mean)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=LOSS_ATOL, rtol=0)
    _check_grads(_grads(tp), want[0], "params")
    _check_grads(tx.grad, want[1], "x")
    _check_grads(_grads(tst), want[2], "state")


def _ssm_cfg():
    cfg = get_config("jamba-1.5-large-398b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("jamba-1.5-large-398b").reduced())
    return cfg


def test_ssm_forward_gradients_match_reference():
    """x (2 rows of 19 tokens), every mamba weight (``dt_bias`` and
    ``a_log`` drawn) and the start state (``h``, ``conv``), one seeded
    cotangent each for y, h and conv."""
    cfg = _ssm_cfg()
    tree = jax.tree.map(np.asarray, jax_init(
        jssm.ssm_schema(cfg), jax.random.PRNGKey(0), cfg.dtype))
    rng = np.random.default_rng(100)
    tree["dt_bias"] = (rng.normal(size=tree["dt_bias"].shape) * 0.5
                       - 1.0).astype(np.float32)
    tree["a_log"] = rng.normal(size=tree["a_log"].shape).astype(np.float32)
    di = jssm.d_inner(cfg)
    x = rng.normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    st = {"h": rng.normal(size=(2, di, cfg.ssm_state_dim)).astype(
              np.float32),
          "conv": rng.normal(size=(2, cfg.ssm_conv_width - 1, di)).astype(
              np.float32)}
    cots = [rng.normal(size=shape).astype(np.float32) for shape in
            (x.shape, st["h"].shape, st["conv"].shape)]

    def jloss(p, x, st):
        y, new = jssm.ssm_forward(p, cfg, x, st)
        return _loss_fn((y, new["h"], new["conv"]), cots, jnp.mean)

    want_loss, want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
        jax.tree.map(jnp.asarray, st))
    tp = {k: v.requires_grad_(True) for k, v in
          params_from_jax(tree, device="cpu").items()}
    tx, tst = _leafy(x), _leafy(st)
    y, new = tssm.ssm_forward(tp, cfg, tx, tst)
    loss = _loss_fn((y, new["h"], new["conv"]), map(_t, cots), torch.mean)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               atol=LOSS_ATOL, rtol=0)
    _check_grads(_grads(tp), want[0], "params")
    _check_grads(tx.grad, want[1], "x")
    _check_grads(_grads(tst), want[2], "state")


# ------------------------------------------------- a float64 model on the CPU


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_float64_model_stays_in_float64(arch):
    """A float64 model (the yardstick ``chip_smoke.py`` reads float32
    rounding against): every drawn leaf, the router's too, and the loss
    and every gradient of ``Model.loss`` are float64 (no layer drops to
    float32), and on the float32 model's weights it gives the float32
    model's loss within ``LOSS_ATOL`` and its gradients within 1e-3 x
    max|g|: ten times the 1e-4 the float32 runs are held to against each
    other, since here one side has no rounding at all and the cancelling
    sums of rwkv6's ``u`` and mamba's ``x_proj`` put float32 rounding
    near 1e-4 of their max (``chip_smoke.py`` phase 6c reads it)."""
    from repro_torch.core.strategies import _value_and_grad
    from repro_torch.data.tokens import make_stream
    from repro_torch.models.api import Model
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                              num_layers=2)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=max(
        cfg.moe_capacity_factor, cfg.num_experts / max(
            cfg.num_experts_per_tok, 1)))            # dropless
    c64 = dataclasses.replace(cfg, dtype="float64")
    m32, m64 = Model(cfg, device="cpu"), Model(c64, device="cpu")
    assert all(t.dtype == torch.float64
               for t in tree_leaves(m64.init(seed=0)))
    p32 = m32.init(seed=0)
    p64 = tree_map(lambda t: t.double(), p32)
    batch = {k: _t(v) for k, v in
             make_stream(cfg.vocab_size, 24, 2, 0).batch(0).items()}
    l32, _, g32 = _value_and_grad(lambda p, b: m32.loss(p, b), p32, batch)
    l64, _, g64 = _value_and_grad(lambda p, b: m64.loss(p, b), p64, batch)
    assert l64.dtype == torch.float64
    assert all(g.dtype == torch.float64 for g in tree_leaves(g64))
    np.testing.assert_allclose(float(l32), float(l64), atol=LOSS_ATOL,
                               rtol=0)
    for g, w in zip(tree_leaves(g32), tree_leaves(g64)):
        _close(g, w, 1e-3)
