"""The selective scan's checkpoints for its backward, on the CPU.

``ops.ssm_scan``'s autograd Function asks its forward for the state after
every 16 steps short of S (``checkpoints=True``), and the backward re-runs
each 16-step chunk from its checkpoint instead of the whole recurrence
from h0.  Here, on reduced jamba's mamba layer (d_model 256, d_inner
512, 16 states) with the reference's weights bridged and numpy-seeded
inputs and state:

* the plain forward's checkpoint k (``ref.ssm_scan_ref``, on the scan
  inputs the port's ``ssm_forward`` passes ``ops.ssm_scan``) against the
  state the reference's ``ssm_forward`` returns over the first 16 (k + 1)
  tokens, S = 1, 16, 37 and 130, unmasked and with per-row ``seq_len``
  (the reference's ``seq_len`` cut to the prefix);
* the plain backward from those checkpoints bit-equal to the same call
  without them, and the Function's CPU gradients bit-equal to the plain
  backward's without them;
* y and h_final unchanged by asking for the checkpoints.

Tolerance ``atol=rtol=1e-5``, as ``tests/test_torch_ssm.py``'s for the
same layer: float32 on both sides, sequential scans whose only
difference is the order of the projections' sums; a state off by one
step moves it by >1e-2.
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
from repro_torch.models import ssm as tssm  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
STEPS = 16
GRADS = ("ddt", "dbm", "dcm", "dx", "da", "dh0")


def _cfg():
    cfg = get_config("jamba-1.5-large-398b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("jamba-1.5-large-398b").reduced())
    return cfg


def _both(cfg, seed=0):
    """The reference's mamba parameters, dt_bias ~ N(-1, 0.5) and a_log ~
    N(0, 1) drawn from ``seed``, as jax arrays and bridged tensors."""
    tree = jax.tree.map(np.asarray, jax_init(jssm.ssm_schema(cfg),
                                             jax.random.PRNGKey(seed),
                                             cfg.dtype))
    rng = np.random.default_rng(seed + 100)
    tree["dt_bias"] = (rng.normal(size=tree["dt_bias"].shape) * 0.5
                       - 1.0).astype(np.float32)
    tree["a_log"] = rng.normal(size=tree["a_log"].shape).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, "cpu")


def _inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    di = jssm.d_inner(cfg)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    st = {"h": rng.normal(size=(2, di, cfg.ssm_state_dim)).astype(
              np.float32),
          "conv": rng.normal(size=(2, cfg.ssm_conv_width - 1, di)).astype(
              np.float32)}
    return x, st


def _scan_args(cfg, tp, x, st, seq_len):
    """The operands the port's ``ssm_forward`` passes ``ops.ssm_scan``."""
    seen = []

    def record(*args):
        seen.append(args)
        return ref.ssm_scan_ref(*args)

    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    sl = None if seq_len is None else torch.tensor(seq_len)
    orig = tssm.kernel_ops.ssm_scan
    tssm.kernel_ops.ssm_scan = record
    try:
        with torch.no_grad():
            tssm.ssm_forward(tp, cfg, torch.from_numpy(x), tst, seq_len=sl)
    finally:
        tssm.kernel_ops.ssm_scan = orig
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [1, 16, 37, 130])
def test_plain_checkpoints_are_the_reference_prefix_states(s, masked):
    cfg = _cfg()
    jp, tp = _both(cfg)
    x, st = _inputs(cfg, s, seed=s)
    seq_len = [s, max(1, (2 * s) // 3)] if masked else None
    args = _scan_args(cfg, tp, x, st, seq_len)
    y, h, ck = ref.ssm_scan_ref(*args, checkpoints=True)
    assert tuple(ck.shape) == (2, (s - 1) // STEPS, jssm.d_inner(cfg),
                               cfg.ssm_state_dim)
    jst = jax.tree.map(jnp.asarray, st)
    for k in range(ck.shape[1]):
        n = STEPS * (k + 1)
        sl = (None if seq_len is None
              else jnp.asarray([min(v, n) for v in seq_len], jnp.int32))
        _, new = jssm.ssm_forward(jp, cfg, jnp.asarray(x[:, :n]), jst,
                                  seq_len=sl)
        np.testing.assert_allclose(ck[:, k].numpy(), np.asarray(new["h"]),
                                   **TOL)
    # the final state too, where the chunks end
    sl = None if seq_len is None else jnp.asarray(seq_len, jnp.int32)
    _, new = jssm.ssm_forward(jp, cfg, jnp.asarray(x), jst, seq_len=sl)
    np.testing.assert_allclose(h.numpy(), np.asarray(new["h"]), **TOL)


@pytest.mark.parametrize("s", [1, 16, 37, 130])
def test_backward_from_checkpoints_gives_the_same_bits(s):
    """The plain backward re-run from the forward's checkpoints equals
    the one walking from h0, bit for bit; so do the Function's CPU
    gradients; and asking for the checkpoints leaves y and h_final as
    they were."""
    cfg = _cfg()
    _, tp = _both(cfg)
    x, st = _inputs(cfg, s, seed=100 + s)
    args = _scan_args(cfg, tp, x, st, None)
    rng = np.random.default_rng(s)
    dy = torch.from_numpy(rng.normal(size=tuple(args[3].shape)).astype(
        np.float32))
    dhf = torch.from_numpy(rng.normal(size=tuple(args[5].shape)).astype(
        np.float32))
    y, h, ck = ref.ssm_scan_ref(*args, checkpoints=True)
    y0, h0 = ref.ssm_scan_ref(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    want = ref.ssm_scan_bwd_ref(*args, dy, dhf)
    got = ref.ssm_scan_bwd_ref(*args, dy, dhf, ckpt=ck)
    for name, g, w in zip(GRADS, got, want):
        assert torch.equal(g, w), name
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    yf, hf = ops.ssm_scan(*leaves)
    assert torch.equal(yf, y) and torch.equal(hf, h)
    ((yf * dy).sum() + (hf * dhf).sum()).backward()
    for name, leaf, w in zip(GRADS, leaves, want):
        assert torch.equal(leaf.grad, w), name
