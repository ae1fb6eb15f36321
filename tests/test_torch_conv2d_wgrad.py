"""The filter-gradient kernel ``conv2d_wgrad``: its launch plan on the CPU,
the kernel and the training path on the card.

On the CPU (no JAX needed; the plain version is held against the
reference in ``tests/test_torch_train.py``): ``kernels/conv2d_wgrad.py:
plan`` over every shape of ``chip_smoke.py``'s conv sweep and the paper's
shape at the batches training and evaluation use, on an H100's 132 SMs:
the CTAs' partials cover every (image, output row) pair once, each CTA
takes at least one (so there are no more partials than pairs), the
threads hold every output, and the staged pairs fit one CTA's shared
memory; shapes past the kernel's limits are refused.  ``ops.
conv2d_wgrad`` takes the plain version for CPU tensors and the wrapper
refuses them.

On the card (tests marked ``cuda``, skipped elsewhere; no JAX, so they
run with ``--noconftest``):

* the kernel against ``conv2d_wgrad_ref`` over the sweep plus B=64 and
  2,000 at the paper's shape, dy N(0, 1).  Both sum in float32 in other
  orders over up to B*H'*W' (1.35 million) products, so the rounding
  scales with the largest value: float32 within ``1e-5 * max|plain| +
  1e-5 * |plain|``; bfloat16 (both round the float32 sum once) within
  that absolute part plus one bfloat16 ulp, ``rtol=2**-7``;
* a second launch on the same inputs gives the same bits (no atomics);
* the autograd Function's dx and dw (kernels) against autograd through
  the plain ``conv2d_ref`` on the card, float32, the same limits;
* one sync round (3 workers x 2 steps of 64 digits, ``adam(1e-3)``)
  through the kernels against the plain versions: the loss within
  ``rtol=1e-5``, every parameter within ``2 * lr * K`` and >= 99.9 % of
  them within 1e-5 (Adam's step flips sign where rounding puts a
  gradient near 0; see ``tests/test_torch_train.py``);
* one sync training step of 5 workers launches ``conv2d`` 5 times and
  ``conv2d_wgrad`` 5 times (the images need no gradient: no dx conv).
"""
import collections
import contextlib
import importlib.util
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.mnist_cnn import CONFIG  # noqa: E402
from repro_torch.core import strategies  # noqa: E402
from repro_torch.kernels import conv2d_wgrad as cw  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.module import init_params  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

SMS = 132                                   # an H100 SXM
PAPER = (28, 28, 1, 3, 32)                  # H, W, Cin, K, Cout


def _smoke_shapes():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.CONV_SHAPES)


SHAPES = sorted(set(_smoke_shapes() + [(b, *PAPER)
                                       for b in (1, 64, 2000, 5000)]))


def _plan(shape, sms=SMS):
    b, h, w, cin, k, cout = shape
    return cw.launch_plan((b, h, w, cin), k, k, cout, sms)


@pytest.mark.parametrize("sms", [SMS, 1], ids=["h100", "one_sm"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_partials_cover_every_pair_once(shape, sms):
    b, h, w, cin, k, cout = shape
    pl = _plan(shape, sms)
    assert pl.rows == b * (h - k + 1)
    assert 1 <= pl.ctas <= min(pl.rows, cw.CTAS_PER_SM * sms)
    seen = collections.Counter()
    for cta in range(pl.ctas):
        assert len(pl.cta_rows(cta)) >= 1
        seen.update(pl.cta_rows(cta))
    assert set(seen) == set(range(pl.rows)) and set(seen.values()) == {1}
    # no more pairs staged at once than a CTA takes
    assert pl.group <= max(len(pl.cta_rows(c)) for c in range(pl.ctas))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_threads_hold_every_output_and_pairs_fit(shape):
    b, h, w, cin, k, cout = shape
    pl = _plan(shape)
    nout = k * k * cin * cout
    assert pl.threads % 32 == 0 and 32 <= pl.threads <= cw.MAX_THREADS
    assert pl.threads * pl.per >= nout and 1 <= pl.per <= cw.MAX_PER
    assert pl.threads * (pl.per - 1) < nout          # no idle pass
    assert 1 <= pl.group <= cw.GROUP
    assert pl.smem_bytes == pl.group * cw.pair_bytes(w, cin, k, k, cout)
    assert pl.smem_bytes <= cw.MAX_SMEM


def test_the_paper_shape_gives_one_output_a_thread():
    pl = _plan((64, *PAPER))
    assert (pl.threads, pl.per, pl.ctas) == (288, 1, cw.CTAS_PER_SM * SMS)
    assert pl.group == -(-64 * 26 // pl.ctas)


def test_shapes_past_the_kernel_are_refused():
    with pytest.raises(ValueError, match="at most 4096"):
        cw.launch_plan((1, 8, 8, 64), 3, 3, 128, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        cw.launch_plan((1, 4, 30_000, 1), 3, 3, 1, SMS)


def test_cpu_tensors_take_the_plain_wgrad():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 9, 9, 2)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(2, 7, 7, 4)).astype(np.float32))
    ops.reset_launch_counts()
    assert torch.equal(ops.conv2d_wgrad(x, dy, 3, 3),
                       ref.conv2d_wgrad_ref(x, dy, 3, 3))
    assert ops.launch_counts()["conv2d_wgrad"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        cw.conv2d_wgrad(x, dy, 3, 3)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def wgrad_case(shape, device, dtype, seed=0):
    """x (images in [0, 1] at the paper's shape, N(0, 1) elsewhere) and an
    output gradient dy, N(0, 1)."""
    b, h, w, cin, k, cout = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand if (h, cin, k) == (28, 1, 3) else torch.randn
    x = draw(b, h, w, cin, generator=gen, device=device).to(dtype)
    dy = torch.randn(b, h - k + 1, w - k + 1, cout, generator=gen,
                     device=device).to(dtype)
    return x, dy


def assert_wgrad_close(got, want):
    scale = want.float().abs().max().item()
    rtol = 1e-5 if want.dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * scale)


CARD_SHAPES = _smoke_shapes() + [(64, *PAPER)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_conv2d_wgrad_kernel_matches_plain(cuda, shape, dtype):
    x, dy = wgrad_case(shape, cuda, dtype)
    k = shape[4]
    before = ops.launch_counts()["conv2d_wgrad"]
    got = ops.conv2d_wgrad(x, dy, k, k)
    want = ref.conv2d_wgrad_ref(x, dy, k, k)
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv2d_wgrad"] == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    assert_wgrad_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b", [64, 2000])
def test_conv2d_wgrad_repeat_is_bit_identical(cuda, b, dtype):
    x, dy = wgrad_case((b, *PAPER), cuda, dtype)
    first = ops.conv2d_wgrad(x, dy, 3, 3)
    second = ops.conv2d_wgrad(x, dy, 3, 3)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_conv2d_wgrad_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 28, 28, 1, device=cuda)
    dy = torch.zeros(2, 26, 26, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cw.conv2d_wgrad(x.transpose(1, 2), dy, 3, 3)
    with pytest.raises(ValueError, match="contiguous"):
        cw.conv2d_wgrad(x, dy.transpose(1, 2), 3, 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cw.conv2d_wgrad(x.half(), dy.half(), 3, 3)
    with pytest.raises(ValueError, match="valid output"):
        cw.conv2d_wgrad(x, dy, 5, 5)
    with pytest.raises(ValueError, match="at most 4096"):
        cw.conv2d_wgrad(torch.zeros(1, 8, 8, 64, device=cuda),
                        torch.zeros(1, 6, 6, 128, device=cuda), 3, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES[:4], ids=str)
def test_conv2d_function_gradients_match_plain(cuda, shape):
    b, h, w, cin, k, cout = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    x0 = torch.randn(b, h, w, cin, generator=gen, device=cuda)
    w0 = torch.randn(k, k, cin, cout, generator=gen, device=cuda) * 0.2
    g = torch.randn(b, h - k + 1, w - k + 1, cout, generator=gen,
                    device=cuda)
    grads, counts = {}, {}
    for name, fn in (("kernel", ops.conv2d), ("plain", ref.conv2d_ref)):
        x, wt = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        ops.reset_launch_counts()
        fn(x, wt).backward(g)
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()
        grads[name] = (x.grad, wt.grad)
    # forward and dx through conv2d, dw through conv2d_wgrad
    assert counts["kernel"]["conv2d"] == 2
    assert counts["kernel"]["conv2d_wgrad"] == 1
    assert set(counts["plain"].values()) == {0}
    for got, want in zip(grads["kernel"], grads["plain"]):
        assert_wgrad_close(got, want)


def _cnn(cuda, seed=0):
    params = init_params(cnn.cnn_schema(CONFIG), seed, "float32", cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed + 1)
    for name in ("conv_b", "dense1_b", "dense2_b"):
        params[name] = torch.randn(params[name].shape, generator=gen,
                                   device=cuda) * 0.1
    return params


def _batches(cuda, w, k, b, seed=2):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return {"x": torch.rand(w, k, b, 28, 28, 1, generator=gen, device=cuda),
            "y": torch.randint(0, 10, (w, k, b), generator=gen, device=cuda,
                               dtype=torch.int32)}


def _loss(p, batch):
    return cnn.cnn_loss(p, CONFIG, batch["x"], batch["y"])


@pytest.mark.cuda
def test_sync_round_through_kernels_matches_plain(cuda):
    params = _cnn(cuda)
    batches = _batches(cuda, 3, 2, 64)
    out = {}
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", mock.patch.multiple(
                          ops, conv2d=ref.conv2d_ref))):
        strat = strategies.SyncDataParallel(adam(1e-3), 3)
        with ctx:
            out[name] = strat.round(params, strat.init(params), batches,
                                    _loss)
    (kp, ks, km), (pp, ps, pm) = out["kernel"], out["plain"]
    torch.testing.assert_close(km["loss"], pm["loss"], rtol=1e-5, atol=0)
    assert int(ks["opt"]["count"]) == int(ps["opt"]["count"]) == 2
    for name in params:
        diff = (kp[name] - pp[name]).abs()
        assert diff.max().item() <= 2 * 1e-3 * 2, name
        assert (diff <= 1e-5).float().mean().item() >= 0.999, name


@pytest.mark.cuda
def test_one_training_step_launch_counts(cuda):
    params = _cnn(cuda)
    strat = strategies.SyncDataParallel(adam(1e-3), 5)
    state = strat.init(params)
    batches = _batches(cuda, 5, 1, 64)
    ops.reset_launch_counts()
    strat.round(params, state, batches, _loss)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["conv2d"] == 5 and counts["conv2d_wgrad"] == 5, counts
