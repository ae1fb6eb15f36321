"""The selective scan in the model dtype, and its launch plan.

The scan reads x in the model dtype (float32 or bfloat16) and returns y
in it, as the reference's step casts ``x_t`` to float32 and its scan's
output back to ``x.dtype`` (``repro/models/ssm.py:ssm_forward``); the
mamba layer hands it ``silu(x_c)`` as it is and gates the returned y
with no cast.  On the CPU:

* ``ops.ssm_scan`` (the plain version on CPU tensors) with bf16 x
  returns bf16 y equal, bit for bit, to the float32-x run's y rounded to
  bf16, and the same float32 final state;
* ``ssm_forward`` on reduced jamba's mamba layer in bfloat16 against the
  reference's in bfloat16, from the same numpy inputs and state.
  Tolerance ``atol=5e-2, rtol=2e-2``: both sides round the
  projections, the causal conv and the gate to bf16, but in other places
  (XLA keeps fused elementwise chains in float32, PyTorch rounds after
  each op), so ``xc`` and ``z`` differ by a bf16 ulp here and there; the
  float32 scan carries that into ``h`` (within 1e-2) and y, and the
  output projection sums 512 such channels into outputs up to ~5, where
  terms of a few units cancel: ~70 % of the outputs differ, by up to
  ~2e-2 (1.3 bf16 ulps of 4) at outputs of 0.1.  ``atol`` is three bf16
  ulps of 4.  A wrong decay, mask or gate moves them by > 1e-1; the cast
  of x and y itself is held bit for bit by the first test;
* ``slot_steps``: 32-step ring slots while every CTA of the grid is
  resident at once, else 16-step ones; the shared memory the source lays
  out;
* ``ssm_forward`` hands the scan 16-byte aligned operands (the kernel
  takes no other), at one row of one step too, where a column slice of
  the projection counts as contiguous but starts mid-row.
"""
import dataclasses
from pathlib import Path
from unittest import mock

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

BF16_TOL = dict(atol=5e-2, rtol=2e-2)


def _scan_case(rng, b, s, di, n=16):
    dt = np.log1p(np.exp(rng.normal(-1.0, 0.5, (b, s, di))))
    return [torch.from_numpy(v.astype(np.float32)) for v in (
        dt, rng.normal(size=(b, s, n)), rng.normal(size=(b, s, n)),
        rng.normal(size=(b, s, di)), -np.exp(rng.normal(size=(di, n))),
        rng.normal(size=(b, di, n)))]


@pytest.mark.parametrize("shape", [(1, 1, 32), (2, 37, 64), (3, 9, 200)])
def test_bf16_x_gives_the_float32_run_rounded(shape):
    t = _scan_case(np.random.default_rng(sum(shape)), *shape)
    xb = t[3].bfloat16()
    y32, h32 = ops.ssm_scan(t[0], t[1], t[2], xb.float(), t[4], t[5])
    yb, hb = ops.ssm_scan(t[0], t[1], t[2], xb, t[4], t[5])
    assert y32.dtype == torch.float32 and yb.dtype == torch.bfloat16
    assert hb.dtype == torch.float32
    assert torch.equal(yb, y32.bfloat16())
    assert torch.equal(hb, h32)


def test_float64_stays_float64():
    t = _scan_case(np.random.default_rng(1), 2, 5, 16)
    y, h = ref.ssm_scan_ref(*(v.double() for v in t))
    assert y.dtype == h.dtype == torch.float64


def _bf16(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16))


@pytest.mark.parametrize("masked", [False, True])
def test_ssm_forward_bf16_matches_reference(masked):
    """Reduced jamba's mamba layer in bfloat16 (every leaf bf16, dt_bias
    ~ N(-1, 0.5) and a_log ~ N(0, 1) drawn from a seed), from a non-zero
    state, 3 rows of 9 lanes; masked: rows of 9, 4 and 1 valid lanes."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(
        jax_get_config("jamba-1.5-large-398b").reduced(), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_init(jssm.ssm_schema(jcfg),
                                             jax.random.PRNGKey(0),
                                             "bfloat16"))
    assert tree["in_proj"].dtype.name == "bfloat16"
    rng = np.random.default_rng(100)
    tree["dt_bias"] = _bf16(rng.normal(size=tree["dt_bias"].shape) * 0.5
                            - 1.0)
    tree["a_log"] = _bf16(rng.normal(size=tree["a_log"].shape))
    tp = params_from_jax(tree, "cpu")
    di = tssm.d_inner(cfg)
    x32 = rng.normal(size=(3, 9, cfg.d_model)).astype(np.float32)
    h = rng.normal(size=(3, di, cfg.ssm_state_dim)).astype(np.float32)
    conv = _bf16(rng.normal(size=(3, cfg.ssm_conv_width - 1, di)))
    sl = np.array([9, 4, 1], np.int32)
    jy, jst = jssm.ssm_forward(
        jax.tree.map(jnp.asarray, tree), jcfg,
        jnp.asarray(x32).astype(jnp.bfloat16),
        {"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
        seq_len=jnp.asarray(sl) if masked else None)
    ty, tst = tssm.ssm_forward(
        tp, cfg, torch.from_numpy(x32).bfloat16(),
        params_from_jax({"h": h, "conv": conv}, "cpu"),
        seq_len=torch.from_numpy(sl) if masked else None)
    assert ty.dtype == torch.bfloat16 and tst["h"].dtype == torch.float32
    valid = np.arange(9)[None, :] < (sl if masked else np.full(3, 9))[:, None]
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(ty.float().numpy()[valid], want[valid],
                               **BF16_TOL)
    np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]),
                               **BF16_TOL)
    np.testing.assert_allclose(tst["conv"].float().numpy(),
                               np.asarray(jst["conv"].astype(jnp.float32)),
                               **BF16_TOL)


# (rows, d_inner, x bytes, SMs) -> steps a slot: one row of jamba's
# 16,384 channels is 256 CTAs, all resident on 132 SMs with 32-step slots
# (5 an SM in float32, 6 in bf16); 8 rows are 2,048 CTAs, which take the
# 16-step slots (8 an SM)
@pytest.mark.parametrize("shape,want", [
    ((1, 16384, 4, 132), 32), ((1, 16384, 2, 132), 32),
    ((2, 16384, 4, 132), 32), ((3, 16384, 4, 132), 16),
    ((3, 16384, 2, 132), 32), ((4, 16384, 2, 132), 16),
    ((8, 16384, 4, 132), 16), ((8, 16384, 2, 132), 16),
    ((1, 512, 4, 132), 32), ((3, 200, 4, 132), 32),
    ((1, 16384, 4, 50), 16), ((65535, 512, 2, 132), 16)])
def test_slot_steps(shape, want):
    assert ss_mod.slot_steps(*shape) == want


def test_slot_steps_big_while_every_cta_is_resident():
    for xsize, per_sm in ((4, 5), (2, 6)):
        big = ss_mod.smem_bytes(ss_mod.STEPS[0], xsize)
        assert ss_mod.resident_ctas(big) == per_sm
        small = ss_mod.smem_bytes(ss_mod.STEPS[1], xsize)
        assert ss_mod.resident_ctas(small) == ss_mod.CTAS_PER_SM
        rows = per_sm * 132 // (16384 // ss_mod.CHANNELS)   # CTAs that fit
        assert ss_mod.slot_steps(rows, 16384, xsize, 132) == 32
        assert ss_mod.slot_steps(rows + 1, 16384, xsize, 132) == 16


def test_smem_layout_matches_the_source():
    """barriers, then two slots of (dt, x, bm, cm) rows: 16-byte
    multiples at every boundary the bulk copies write to, the widest
    ring within the 48 KB a launch gets without asking."""
    for xsize in (4, 2):
        slot = (ss_mod.smem_bytes(1, xsize) - ss_mod.BAR_BYTES) \
            // ss_mod.STAGES
        assert slot == ss_mod.CHANNELS * (4 + xsize) + 2 * 16 * 4
        assert slot % 16 == 0 and ss_mod.BAR_BYTES % 16 == 0
        assert ss_mod.CHANNELS * xsize % 16 == 0
        assert ss_mod.smem_bytes(max(ss_mod.STEPS), xsize) <= 48 * 1024
    src = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
           / "csrc" / "ssm_scan.cu").read_text()
    assert f"constexpr int kStages = {ss_mod.STAGES};" in src
    assert f"constexpr int kBarBytes = {ss_mod.BAR_BYTES};" in src
    assert "steps == 32 ? launch<XT, 32>" in src and \
        ss_mod.STEPS == (32, 16)


@pytest.mark.parametrize("b,s", [(1, 1), (3, 1), (1, 9), (2, 5)])
def test_ssm_forward_hands_the_scan_aligned_operands(b, s):
    cfg = get_config("jamba-1.5-large-398b").reduced()
    tree = jax.tree.map(np.asarray, jax_init(jssm.ssm_schema(cfg),
                                             jax.random.PRNGKey(0),
                                             "float32"))
    tp = params_from_jax(tree, "cpu")
    di = tssm.d_inner(cfg)
    seen = []

    def scan(*args):
        seen.append([t.data_ptr() % 16 for t in args])
        assert all(t.is_contiguous() for t in args)
        return ref.ssm_scan_ref(*args)

    rng = np.random.default_rng(b * 10 + s)
    x = torch.from_numpy(rng.normal(size=(b, s, cfg.d_model))
                         .astype(np.float32))
    with mock.patch.object(ops, "ssm_scan", scan):
        tssm.ssm_forward(tp, cfg, x, tssm.init_state(cfg, b, torch.float32,
                                                     "cpu"))
    assert seen == [[0] * 6] and di % 8 == 0


def test_cpu_tensors_take_the_plain_version_in_any_x_dtype():
    """The kernel's wrapper refuses CPU tensors; ``ops`` routes them to
    the plain version, which returns y in x's dtype, float16 too (the
    kernel takes float32 and bfloat16 only, on the card)."""
    t = _scan_case(np.random.default_rng(0), 1, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ss_mod.ssm_scan(t[0], t[1], t[2], t[3].half(), t[4], t[5])
    y, _ = ops.ssm_scan(t[0], t[1], t[2], t[3].half(), t[4], t[5])
    assert y.dtype == torch.float16
