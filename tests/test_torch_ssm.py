"""The port's mamba layer and its selective scan against the reference.

On the CPU, the same numpy inputs go through ``repro.models.ssm`` and
``repro_torch.models.ssm`` on reduced jamba's mamba layer (d_model 256,
d_inner 512, 16 states, conv width 4), the reference's weights with its
zero-initialised ``dt_bias`` and all-ones ``a_log`` drawn from a seed
(the init leaves every channel's decay and step-size bias alike):

* ``ref.ssm_scan_ref`` (what ``ops.ssm_scan`` runs for CPU tensors) on
  the reference's own scan inputs (its ``_split_proj``, ``_causal_conv``
  and ``_selective_terms``) against the reference's ``lax.scan``: the
  final state and the layer output built from the scan's ``y``;
* ``ssm_forward`` from a non-zero state (``h`` and the ``prev`` conv
  context), unmasked and masked (right-padded rows with per-row
  ``seq_len``), output and state, and the masked state against an
  unpadded run over each row's valid lanes.

Tolerance ``atol=rtol=1e-5``: float32 on both sides, sequential scans
whose only difference is the order of each step's 16-term output sum and
of the projections' sums, over values of magnitude ~1; a wrong decay,
mask or conv context moves them by >1e-2.  The scan also runs in float64
(``ssm_scan_ref`` promotes), where it agrees with the float32 scan to
float32 rounding.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.module import init_params as jax_init  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssm_scan as ss_mod  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _cfg():
    cfg = get_config("jamba-1.5-large-398b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("jamba-1.5-large-398b").reduced())
    return cfg


def _params(cfg, seed=0):
    """The reference's mamba parameters as numpy, dt_bias ~ N(-1, 0.5)
    and a_log ~ N(0, 1) drawn from ``seed`` (decays exp(-exp(a_log) dt)
    from ~0.3 to ~1)."""
    tree = jax.tree.map(np.asarray, jax_init(jssm.ssm_schema(cfg),
                                             jax.random.PRNGKey(seed),
                                             cfg.dtype))
    rng = np.random.default_rng(seed + 100)
    tree["dt_bias"] = (rng.normal(size=tree["dt_bias"].shape) * 0.5
                       - 1.0).astype(np.float32)
    tree["a_log"] = rng.normal(size=tree["a_log"].shape).astype(np.float32)
    return tree


def _state(cfg, rng, b):
    di = jssm.d_inner(cfg)
    return {"h": rng.normal(size=(b, di, cfg.ssm_state_dim)).astype(
                np.float32),
            "conv": rng.normal(size=(b, cfg.ssm_conv_width - 1, di)).astype(
                np.float32)}


def _both(cfg, seed=0):
    tree = _params(cfg, seed)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def test_schema_matches_reference():
    cfg = _cfg()
    jtree = jax_init(jssm.ssm_schema(cfg), jax.random.PRNGKey(0), "float32")
    from repro_torch.models.module import init_params
    ours = init_params(tssm.ssm_schema(cfg), 0, "float32", "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == \
        jax.tree.map(lambda a: tuple(a.shape), jtree)
    assert not ours["dt_bias"].any() and torch.all(ours["a_log"] == 1)
    st = tssm.init_state(cfg, 3, torch.float32, "cpu")
    want = jssm.init_state(cfg, 3, jnp.float32)
    assert {k: tuple(v.shape) for k, v in st.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}


@pytest.mark.parametrize("s", [1, 7, 33])
def test_scan_plain_matches_reference(s):
    """The plain scan on the reference's own scan inputs: final state,
    and the layer output rebuilt from its ``y``, against the
    reference's ``ssm_forward``."""
    cfg = _cfg()
    jp, _ = _both(cfg)
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    st = _state(cfg, rng, 2)
    jst = jax.tree.map(jnp.asarray, st)
    jy, jnew = jssm.ssm_forward(jp, cfg, jnp.asarray(x), jst)
    x_in, z = jssm._split_proj(jp, cfg, jnp.asarray(x))
    x_c, _ = jssm._causal_conv(jp, x_in, jst["conv"])
    dt, bm, cm, xc = jssm._selective_terms(jp, cfg, x_c)
    a = -np.exp(np.asarray(jp["a_log"]))
    dt = np.broadcast_to(np.asarray(dt), xc.shape)
    t = [torch.from_numpy(np.array(v)) for v in
         (dt, np.asarray(bm), np.asarray(cm), np.asarray(xc), a, st["h"])]
    y, h = ref.ssm_scan_ref(*t)
    np.testing.assert_allclose(h.numpy(), np.asarray(jnew["h"]), **TOL)
    out = (y.numpy() * np.asarray(jax.nn.silu(z))) @ np.asarray(
        jp["out_proj"])
    np.testing.assert_allclose(out, np.asarray(jy), **TOL)
    # float64: the same recurrence without float32 rounding of its own
    y64, h64 = ref.ssm_scan_ref(*(v.double() for v in t))
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(h.numpy(), h64.numpy(), **TOL)
    np.testing.assert_allclose(y.numpy(), y64.numpy(), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_ssm_forward_matches_reference(masked):
    """From a non-zero state (``h`` and the ``prev`` conv context), one
    call over 3 rows of 9 lanes; masked: rows hold 9, 4 and 1 valid
    lanes."""
    cfg = _cfg()
    jp, tp = _both(cfg)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 9, cfg.d_model)).astype(np.float32)
    st = _state(cfg, rng, 3)
    sl = np.array([9, 4, 1], np.int32)
    jy, jst = jssm.ssm_forward(jp, cfg, jnp.asarray(x),
                               jax.tree.map(jnp.asarray, st),
                               seq_len=jnp.asarray(sl) if masked else None)
    ty, tst = tssm.ssm_forward(tp, cfg, torch.from_numpy(x),
                               jax.tree.map(torch.from_numpy, st),
                               seq_len=torch.from_numpy(sl) if masked
                               else None)
    valid = np.arange(9)[None, :] < (sl if masked else np.full(3, 9))[:, None]
    np.testing.assert_allclose(ty.numpy()[valid], np.asarray(jy)[valid],
                               **TOL)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)
    if not masked:
        return
    # the masked state is an unpadded run's over each row's valid lanes
    for i, n in enumerate(sl):
        one = jax.tree.map(lambda a: torch.from_numpy(a[i:i + 1]), st)
        _, want = tssm.ssm_forward(tp, cfg, torch.from_numpy(x[i:i + 1, :n]),
                                   one)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tst[k][i:i + 1].numpy(),
                                       want[k].numpy(), **TOL)


def test_masked_lanes_carry_the_state_exactly():
    """dt = 0 past a row's length: the plain scan's state after the
    padded lanes is bit-identical to the state after the valid ones."""
    rng = np.random.default_rng(3)
    b, s, di, n = 2, 6, 32, 16
    dt = rng.uniform(0.01, 1.0, (b, s, di)).astype(np.float32)
    bm, cm = (rng.normal(size=(b, s, n)).astype(np.float32)
              for _ in range(2))
    x = rng.normal(size=(b, s, di)).astype(np.float32)
    a = -np.exp(rng.normal(size=(di, n))).astype(np.float32)
    h0 = rng.normal(size=(b, di, n)).astype(np.float32)
    t = [torch.from_numpy(v) for v in (dt, bm, cm, x, a, h0)]
    masked = t[0].clone()
    masked[:, 4:] = 0
    _, h_pad = ref.ssm_scan_ref(masked, *t[1:])
    _, h_cut = ref.ssm_scan_ref(*(v[:, :4] for v in t[:4]), t[4], t[5])
    assert torch.equal(h_pad, h_cut)


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(0)
    b, s, di, n = 1, 3, 8, 16
    t = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
         for shape in ((b, s, di), (b, s, n), (b, s, n), (b, s, di),
                       (di, n), (b, di, n))]
    before = ops.launch_counts()
    got = ops.ssm_scan(*t)
    want = ref.ssm_scan_ref(*t)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        ss_mod.ssm_scan(*t)
