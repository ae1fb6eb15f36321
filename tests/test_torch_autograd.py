"""The kernel wrappers refuse autograd; ``ops.conv2d``, ``ops.rwkv6_scan``,
``ops.ssm_scan`` and the plain path differentiate.

The nine CUDA wrappers fill their outputs through ctypes, so a result
would carry no ``grad_fn`` and an input that requires grad would get no
gradient, silently.  Each raw wrapper raises when grad mode is on and a
tensor input requires grad (on any device: the check comes before the
device check), and launches as before under ``torch.no_grad()`` or on
detached inputs; the two backward kernels' wrappers too, so a gradient
of a gradient is refused rather than cut.  The convolution
differentiates through the autograd Function in ``ops.conv2d`` (its
backward runs ``conv2d_wgrad`` and ``conv2d``, kernels on the card,
plain versions on the CPU), and the two scans through theirs in ``ops``
(backward: ``rwkv6_scan_bwd`` / ``ssm_scan_bwd`` on the card, their plain
versions on the CPU: ``tests/test_torch_scan_backward.py``); the other
plain versions, which ``ops`` takes for CPU tensors, are ordinary
PyTorch.  The port's ``cnn_loss`` gradients on the CPU match
``jax.grad`` of the reference's ``cnn_loss`` on the same weights and
digits.  Tolerance:
float32 on both sides, the gradients of a mean over 16 digits summed
through 5,408 and 128 features in another order: ``atol=1e-6,
rtol=1e-4``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.mnist_cnn import CONFIG  # noqa: E402
from repro_torch.kernels import conv2d as cv_mod  # noqa: E402
from repro_torch.kernels import conv2d_wgrad as cw_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import paged_prefill as pp_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan_bwd as rwb_mod  # noqa: E402
from repro_torch.kernels import ssm_scan as ss_mod  # noqa: E402
from repro_torch.kernels import ssm_scan_bwd as ssb_mod  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from test_torch_kernels import (decode_case, pool_case,  # noqa: E402
                                prefill_case)


def kernel_inputs(name, device):
    """(wrapper, its kernel, float32 inputs in call order, the indices of
    the inputs autograd could flow into)."""
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    if name == "conv2d":
        args = [t(rng.normal(size=(2, 8, 8, 1)).astype(np.float32)),
                t(rng.normal(size=(3, 3, 1, 4)).astype(np.float32))]
        return cv_mod.conv2d, cv_mod.KERNEL, args, (0, 1)
    if name == "conv2d_wgrad":
        args = [t(rng.normal(size=(2, 8, 8, 1)).astype(np.float32)),
                t(rng.normal(size=(2, 6, 6, 4)).astype(np.float32))]
        return (lambda x, dy: cw_mod.conv2d_wgrad(x, dy, 3, 3),
                cw_mod.KERNEL, args, (0, 1))
    if name == "flash_attention":
        args = [t(rng.normal(size=(1, heads, 8, 16)).astype(np.float32))
                for heads in (4, 2, 2)]
        return fa_mod.flash_attention, fa_mod.KERNEL, args, (0, 1, 2)
    if name == "paged_attention":
        args = [t(a) for a in decode_case(rng, 2, 4, 2, 16, 9, 4, 3)]
        return pa_mod.paged_attention, pa_mod.KERNEL, args, (0, 1, 2)
    if name == "paged_prefill":
        args = [t(a) for a in prefill_case(rng, 2, 4, 4, 2, 16, 8)]
        return pp_mod.paged_prefill, pp_mod.KERNEL, args, (0, 1, 2)
    if name == "paged_prefill_pool":
        args = [t(a) for a in pool_case(rng, 2, 4, 4, 2, 16, 8, 4)]
        return (pp_mod.paged_prefill_pool, pp_mod.KERNEL_POOL, args,
                (0, 1, 2, 6, 7))
    if name.startswith("ssm_scan"):
        b, s, di, n = 2, 5, 8, ss_mod.STATE_DIM
        args = [t(np.full((b, s, di), 0.5, np.float32))]
        args += [t(rng.normal(size=shape).astype(np.float32)) for shape in
                 ((b, s, n), (b, s, n), (b, s, di))]
        args += [t(-np.ones((di, n), np.float32)),
                 t(rng.normal(size=(b, di, n)).astype(np.float32))]
        if name == "ssm_scan":
            return ss_mod.ssm_scan, ss_mod.KERNEL, args, (0, 1, 2, 3, 4, 5)
        args += [t(rng.normal(size=shape).astype(np.float32)) for shape in
                 ((b, s, di), (b, di, n))]              # dy, dh_final
        return (ssb_mod.ssm_scan_bwd, ssb_mod.KERNEL, args,
                (0, 1, 2, 3, 4, 5, 6, 7))
    shape = (1, 2, 5, 8)
    args = [t(rng.normal(size=shape).astype(np.float32)) for _ in range(3)]
    args += [t(np.full(shape, 0.9, np.float32)),
             t(rng.normal(size=(2, 8)).astype(np.float32)),
             t(rng.normal(size=(1, 2, 8, 8)).astype(np.float32))]
    if name == "rwkv6_scan":
        return rw_mod.rwkv6_scan, rw_mod.KERNEL, args, (0, 1, 2, 3, 4, 5)
    args += [t(rng.normal(size=shape).astype(np.float32)),    # dout
             t(rng.normal(size=(1, 2, 8, 8)).astype(np.float32))]
    return (rwb_mod.rwkv6_scan_bwd, rwb_mod.KERNEL, args,
            (0, 1, 2, 3, 4, 5, 6, 7))


KERNELS = ["conv2d", "conv2d_wgrad", "flash_attention", "paged_attention",
           "paged_prefill", "paged_prefill_pool", "rwkv6_scan", "rwkv6_scan_bwd", "ssm_scan",
           "ssm_scan_bwd"]


@pytest.mark.parametrize("name", KERNELS)
def test_wrappers_refuse_inputs_that_require_grad(name):
    """Each input autograd could flow into is refused under grad mode;
    under ``no_grad`` the same call passes the guard (and, on the CPU,
    stops at the wrapper's device check)."""
    fn, _, args, diff = kernel_inputs(name, "cpu")
    for i in diff:
        call = list(args)
        call[i] = args[i].clone().requires_grad_(True)
        with pytest.raises(ValueError, match="requires grad.*no backward"):
            fn(*call)
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            fn(*call)
        with pytest.raises(ValueError, match="CUDA"):
            fn(*[a.detach() for a in call])


def test_cnn_loss_gradients_match_jax():
    """The plain path's gradients for every parameter of the paper's CNN
    against ``jax.grad`` of the reference's loss, on bridged weights."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.mnist_cnn import CONFIG as JCONFIG
    from repro.models import cnn as jcnn
    from repro.models.module import init_params as jinit

    np_params = jax.tree.map(np.asarray, jinit(
        jcnn.cnn_schema(JCONFIG), jax.random.PRNGKey(7), "float32"))
    rng = np.random.default_rng(8)
    for name in ("conv_b", "dense1_b", "dense2_b"):
        np_params[name] = (rng.normal(size=np_params[name].shape)
                           * 0.1).astype(np.float32)
    x = rng.random((16, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)

    def jloss(p):
        return jcnn.cnn_loss(p, JCONFIG, jnp.asarray(x),
                             jnp.asarray(labels))[0]

    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in np_params.items()})
    params = {k: v.requires_grad_(True) for k, v in
              params_from_jax(np_params, device="cpu").items()}
    loss, _ = cnn.cnn_loss(params, CONFIG, torch.from_numpy(x),
                           torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss(
        {k: jnp.asarray(v) for k, v in np_params.items()})), rtol=1e-5)
    assert sorted(want) == sorted(params)
    for name, p in params.items():
        assert p.grad is not None, name
        assert p.grad.abs().max().item() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]),
                                   atol=1e-6, rtol=1e-4, err_msg=name)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNELS)
def test_wrappers_refuse_autograd_on_the_card(cuda, name):
    fn, kern, args, diff = kernel_inputs(name, cuda)
    for i in diff:
        call = list(args)
        call[i] = args[i].clone().requires_grad_(True)
        n0 = kern.launches
        with pytest.raises(ValueError, match="requires grad.*no backward"):
            fn(*call)
        assert kern.launches == n0
        with torch.no_grad():
            fn(*call)
        torch.cuda.synchronize()
        assert kern.launches == n0 + 1
