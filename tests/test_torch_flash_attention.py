"""The port's whole-prompt attention against the reference, on the CPU.

``repro_torch.kernels.ref.flash_attention_ref`` (the plain version the
CUDA kernel is held to on the card) against the reference's jnp oracle
``repro.kernels.ref.flash_attention_ref`` and its Pallas kernel in
interpret mode, over the reference's own sweep (``tests/test_kernels.py``
shapes x float32/bfloat16 x causal, sliding-window and non-causal), on
the same numpy inputs.  Tolerances are the reference suite's: float32
``atol=2e-4, rtol=1e-3``; bfloat16 ``5e-2`` (the Pallas kernel rounds
its blocks' partial results differently from the oracles).

Plus the attention layer of the slot path (``attn_apply``,
``attn_prefill``) against the reference's on bridged weights, and the
device dispatch of ``ops.flash_attention``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_fa  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

FA_SHAPES = [
    # (B, H, KV, Sq, Sk, hd), as tests/test_kernels.py
    (1, 4, 4, 64, 64, 64),        # MHA, square
    (2, 8, 2, 96, 96, 64),        # GQA 4:1, non-multiple seq
    (1, 8, 1, 128, 128, 128),     # MQA
    (2, 4, 4, 33, 75, 64),        # ragged cross shapes
]
MASKS = [(True, 0), (True, 16), (False, 0)]


def _tol(dtype):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" else \
        dict(atol=2e-4, rtol=1e-3)


def fa_case(rng, b, h, kv, sq, sk, hd, causal):
    """float32 numpy inputs; the reference's sweep makes Sk = Sq unless
    the attention is non-causal."""
    if causal:
        sk = sq
    return (rng.normal(size=(b, h, sq, hd)).astype(np.float32),
            rng.normal(size=(b, kv, sk, hd)).astype(np.float32),
            rng.normal(size=(b, kv, sk, hd)).astype(np.float32))


@pytest.mark.parametrize("shape", FA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_plain_matches_reference(shape, dtype, causal,
                                                 window):
    rng = np.random.default_rng(sum(shape) + 7 * window + int(causal))
    args = fa_case(rng, *shape, causal)
    jargs = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in args]
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in args]
    ours = ref.flash_attention_ref(*targs, causal=causal, window=window)
    assert ours.dtype == targs[0].dtype
    ours = ours.float().numpy()
    oracle = np.asarray(jref.flash_attention_ref(
        *jargs, causal=causal, window=window), np.float32)
    pallas = np.asarray(pallas_fa(*jargs, causal=causal, window=window,
                                  block_q=32, block_k=32, interpret=True),
                        np.float32)
    np.testing.assert_allclose(ours, oracle, **_tol(dtype))
    np.testing.assert_allclose(ours, pallas, **_tol(dtype))


def test_cpu_tensors_take_the_plain_version():
    """``ops.flash_attention`` serves CPU tensors with the plain version
    and launches nothing; the kernel wrapper refuses them."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(a) for a in
               fa_case(rng, 1, 4, 2, 9, 9, 16, causal=True))
    before = ops.launch_counts()
    assert torch.equal(ops.flash_attention(q, k, v, window=4),
                       ref.flash_attention_ref(q, k, v, window=4))
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        fa_mod.flash_attention(q, k, v)


# ------------------------------------------------------------ the layer


@pytest.fixture(scope="module")
def layer():
    """Layer-0 attention parameters of the reduced qwen3-0.6b, from the
    reference's init, on both sides."""
    cfg = reduced_cfg("qwen3-0.6b")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(3))
    jp = jax.tree.map(lambda a: a[0],
                      jparams["stack"]["periods"]["slot0"]["mix"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def test_attn_apply_matches_reference_kernel_branch(layer, monkeypatch):
    """The port's ``attn_apply`` with ``allow_kernel`` is the reference's
    kernel branch (Pallas flash kernel in interpret mode); without it,
    the reference's q-chunked branch.  (Its gradients and the branch's
    other masks: ``tests/test_torch_llm_train.py``.)"""
    cfg, jp, tp = layer
    monkeypatch.setenv("REPRO_USE_KERNELS", "1")
    monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    x = np.random.default_rng(1).normal(size=(2, 11, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(11, dtype=np.int32)
    expect = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                              allow_kernel=True)
    ours = tattn.attn_apply(tp, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos), allow_kernel=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(expect),
                               atol=1e-4, rtol=1e-4)
    chunked = jattn.attn_apply(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    ours = tattn.attn_apply(tp, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos))
    np.testing.assert_allclose(ours.numpy(), np.asarray(chunked),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("cache_max", [16, 11, 7])
def test_attn_prefill_output_and_cache_match_reference(layer, cache_max):
    """One projection feeds both the attention and the cache; the cache
    equals the reference's: prompt lanes then pos -1 lanes (16), a
    prompt exactly filling the strip (11), and the ring-aligned tail of
    a prompt longer than the strip (7)."""
    cfg, jp, tp = layer
    x = np.random.default_rng(2).normal(size=(2, 11, cfg.d_model)) \
        .astype(np.float32)
    pos = np.arange(11, dtype=np.int32)
    jy, jc = jattn.attn_prefill(jp, cfg, jnp.asarray(x), jnp.asarray(pos),
                                kind="attn", cache_max=cache_max)
    ty, tc = tattn.attn_prefill(tp, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos), kind="attn",
                                cache_max=cache_max)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-4,
                               rtol=1e-4)
    assert sorted(tc) == sorted(jc)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=1e-5, rtol=1e-5)
