"""The port's convolution and digit CNN against the reference.

On the CPU, the same numpy inputs go through the reference (JAX) and the
port (``repro_torch``), whose ``ops.conv2d`` takes its plain version
``ref.conv2d_ref`` for CPU tensors:

* the plain convolution against the Pallas kernel in interpret mode and
  against the reference's ``lax.conv`` oracle, over the reference's sweep
  (``tests/test_kernels.py``: the paper's shape, a batch past the block,
  a rectangular 5x5 and a 1x1, float32 and bfloat16).  float32: ``atol=
  rtol=1e-5``: both sides sum at most 75 float32 products of outputs
  below ~10, where a different order moves the sum by ~1e-6.  bfloat16:
  the reference sweep's own limit, ``atol=rtol=5e-2`` (the oracle
  ``lax.conv`` may round inside its sum; the kernel and the plain version
  round only the output);
* ``cnn_forward`` and ``cnn_loss`` on the reference's seeded weights
  bridged into the port, against the reference with and without its
  ``use_kernel`` (Pallas in interpret mode), at B=5 and 64: logits within
  ``atol=rtol=1e-4`` (float32 on both sides through a 5,408-term and a
  128-term product, ~1e-6 apart), loss and accuracy likewise.

On the card (tests marked ``cuda``, skipped elsewhere): the CUDA kernel
against the plain version over the sweep and at the paper's shape for
B = 1, 32, 1000 and 2000.  float32 ``atol=rtol=1e-5`` (FMA against a
separate multiply and add over at most 75 terms).  bfloat16 ``atol=1e-3,
rtol=2**-7``: both sides sum in float32 and round the output to bf16
once, so an element may land one bf16 ulp (2**-7 of its size) apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.mnist_cnn import CONFIG  # noqa: E402
from repro_torch.kernels import conv2d as cv_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.module import init_params  # noqa: E402

CONV_SHAPES = [
    # (B, H, W, Cin, K, Cout): the reference's sweep
    (5, 28, 28, 1, 3, 32),       # the paper's CNN
    (130, 28, 28, 1, 3, 32),     # batch > block
    (4, 12, 16, 3, 5, 8),        # rectangular, 5x5
    (2, 9, 9, 2, 1, 4),          # 1x1
]
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REF_TOL = dict(atol=5e-2, rtol=5e-2)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's oracle, Pallas kernel and CNN (JAX on the CPU); the
    card's tests below need none of it."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.conv2d import conv2d as pallas_conv2d
    from repro.models import cnn as jcnn
    from repro.models.module import init_params as jinit
    return jax, jnp, jref, pallas_conv2d, jcnn, jinit


def conv_case(shape, seed=0):
    b, h, w, cin, k, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wt = (rng.normal(size=(k, k, cin, cout)) * 0.2).astype(np.float32)
    return x, wt


def digits(b, seed=1):
    """Images in [0, 1], as the pipeline sends them."""
    rng = np.random.default_rng(seed)
    return rng.random((b, 28, 28, 1)).astype(np.float32)


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv2d_plain_matches_reference(jax_ref, shape, dtype):
    _, jnp, jref, pallas_conv2d, _, _ = jax_ref
    x, w = conv_case(shape)
    jx, jw = jnp.asarray(x).astype(dtype), jnp.asarray(w).astype(dtype)
    tdt = getattr(torch, dtype)
    ours = ref.conv2d_ref(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(w).to(tdt))
    assert ours.dtype == tdt
    ours = ours.float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_REF_TOL
    for other in (pallas_conv2d(jx, jw, interpret=True),
                  jref.conv2d_ref(jx, jw)):
        np.testing.assert_allclose(ours, np.asarray(other, np.float32),
                                   **tol)


def test_cpu_tensors_take_the_plain_conv():
    """``ops.conv2d`` routes CPU tensors to the plain version and launches
    no kernel; the kernel wrapper itself refuses CPU tensors."""
    x, w = (torch.from_numpy(a) for a in conv_case(CONV_SHAPES[2]))
    ops.reset_launch_counts()
    assert torch.equal(ops.conv2d(x, w), ref.conv2d_ref(x, w))
    assert torch.equal(cnn.conv2d_valid(x, w), ref.conv2d_ref(x, w))
    assert ops.launch_counts()["conv2d"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        cv_mod.conv2d(x, w)


def test_cnn_schema_matches_reference(jax_ref):
    jax, _, _, _, jcnn, jinit = jax_ref
    from repro.configs.mnist_cnn import CONFIG as JCONFIG
    want = jinit(jcnn.cnn_schema(JCONFIG), jax.random.PRNGKey(0), "float32")
    ours = init_params(cnn.cnn_schema(CONFIG), 0, "float32", "cpu")
    assert sorted(ours) == sorted(want)
    for name, t in ours.items():
        assert tuple(t.shape) == tuple(want[name].shape), name
        assert t.dtype == torch.float32
    for name in ("conv_b", "dense1_b", "dense2_b"):
        assert not ours[name].any()
    # fan-in on axis -2, as the reference: 1 for the conv (Cin), 5,408
    # and 128 for the dense layers
    for name, fan_in in (("conv_w", 1), ("dense1_w", 5408),
                         ("dense2_w", 128)):
        assert abs(ours[name].std().item() * fan_in ** 0.5 - 1) < 0.2, name


@pytest.fixture(scope="module")
def bridged(jax_ref):
    """The reference's seeded weights, as numpy and in the port."""
    jax, _, _, _, jcnn, jinit = jax_ref
    from repro.configs.mnist_cnn import CONFIG as JCONFIG
    np_params = jax.tree.map(np.asarray, jinit(
        jcnn.cnn_schema(JCONFIG), jax.random.PRNGKey(3), "float32"))
    # non-zero biases, so a wrong broadcast would show
    rng = np.random.default_rng(4)
    for name in ("conv_b", "dense1_b", "dense2_b"):
        np_params[name] = (rng.normal(size=np_params[name].shape)
                           * 0.1).astype(np.float32)
    return JCONFIG, np_params, params_from_jax(np_params, device="cpu")


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["lax_conv", "pallas_interpret"])
@pytest.mark.parametrize("batch", [5, 64])
def test_cnn_forward_and_loss_match_reference(jax_ref, bridged, monkeypatch,
                                              batch, use_kernel):
    _, jnp, _, _, jcnn, _ = jax_ref
    jcfg, np_params, params = bridged
    if use_kernel:
        monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    x = digits(batch)
    labels = np.random.default_rng(5).integers(0, 10, batch).astype(np.int32)
    want = np.asarray(jcnn.cnn_forward(jparams, jcfg, jnp.asarray(x),
                                       use_kernel=use_kernel))
    got = cnn.cnn_forward(params, CONFIG, torch.from_numpy(x)).numpy()
    assert got.shape == (batch, 10)
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    jloss, jm = jcnn.cnn_loss(jparams, jcfg, jnp.asarray(x),
                              jnp.asarray(labels), use_kernel=use_kernel)
    loss, m = cnn.cnn_loss(params, CONFIG, torch.from_numpy(x),
                           torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), float(jloss), **LOGIT_TOL)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               **LOGIT_TOL)
    assert m["accuracy"].item() == float(jm["accuracy"])


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _card_tol(dtype):
    return F32_TOL if dtype == torch.float32 else dict(atol=1e-3,
                                                        rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", CONV_SHAPES + [
    (b, 28, 28, 1, 3, 32) for b in (1, 32, 1000, 2000)], ids=str)
def test_conv2d_kernel_matches_plain(cuda, shape, dtype):
    x, w = (torch.from_numpy(a).to(cuda, dtype) for a in conv_case(shape))
    before = ops.launch_counts()["conv2d"]
    out = ops.conv2d(x, w)
    plain = ref.conv2d_ref(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts()["conv2d"] == before + 1
    assert out.dtype == dtype and out.shape == plain.shape
    torch.testing.assert_close(out.float(), plain.float(), **_card_tol(dtype))


@pytest.mark.cuda
def test_conv2d_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 28, 28, 1, device=cuda)
    w = torch.zeros(3, 3, 1, 32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cv_mod.conv2d(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="contiguous"):
        cv_mod.conv2d(x, w.transpose(0, 1))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cv_mod.conv2d(x.half(), w.half())
    with pytest.raises(ValueError, match="shared memory"):
        cv_mod.conv2d(torch.zeros(1, 8, 8, 64, device=cuda),
                      torch.zeros(3, 3, 64, 128, device=cuda))
    with pytest.raises(ValueError, match="input channels"):
        cv_mod.conv2d(x, torch.zeros(3, 3, 2, 32, device=cuda))


@pytest.mark.cuda
def test_cnn_forward_on_the_card_matches_plain(cuda):
    params = init_params(cnn.cnn_schema(CONFIG), 0, "float32", cuda)
    x = torch.from_numpy(digits(32)).to(cuda)
    ops.reset_launch_counts()
    got = cnn.cnn_forward(params, CONFIG, x)
    assert ops.launch_counts()["conv2d"] == 1
    cpu = {k: v.cpu() for k, v in params.items()}
    want = cnn.cnn_forward(cpu, CONFIG, x.cpu())
    torch.testing.assert_close(got.cpu(), want, **LOGIT_TOL)
