"""The port's attention kernels and their plain versions.

On the CPU: the port's plain versions (``repro_torch.kernels.ref``)
against the reference — the Pallas decode kernel in interpret mode (as
``tests/test_paged_attention.py`` runs it) and the reference's jnp
oracles — on the same numpy inputs, plus the device dispatch of
``repro_torch.kernels.ops``.  Tolerance between the two frameworks:
float32 on both sides over at most a few hundred keys, so sums in a
different order differ by ~1e-7 of outputs of magnitude ~1; ``atol=1e-5``.

On the card (tests marked ``cuda``, skipped elsewhere): the CUDA kernels
against the plain versions at the same inputs.  float32: ``atol=rtol=
1e-4`` (summation order and ``expf`` against ``torch.exp`` over up to a
few hundred keys).  bfloat16, each with ``rtol=2**-7`` because both sides
round the output to bf16 once and an element may land one bf16 ulp
apart: decode and flash ``atol=2e-3`` (both sides otherwise float32);
prefill ``atol=3e-2`` (the plain version also rounds the probabilities
to bf16 before the value product, the kernel keeps them float32).  The
flash kernel's CPU-side checks (plain version against the reference)
are in ``tests/test_torch_flash_attention.py``, the WKV6 scan's in
``tests/test_torch_rwkv6.py``.  The WKV6 scan on the card, float32 only
(the model calls it so): ``atol=rtol=1e-4`` against outputs that reach
~100 — the kernel sums each step's 64 terms in another order, and the
state carries the rounding across up to 200 steps.
"""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import conv2d as cv_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import paged_prefill as pp_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw_mod  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's oracles and Pallas kernel (JAX on the CPU); the
    card's tests below need neither."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels.paged_attention import paged_attention as pallas_pa
    return jnp, jref, pallas_pa


def decode_case(rng, b, h, kv, hd, nb_pool, bs, nb, null_rows=()):
    """Pools with per-request block runs of random length: ragged tail
    lanes stay pos=-1, unused table columns pad with the null block,
    ``null_rows`` get all-null tables (inactive requests)."""
    k_pool = rng.normal(size=(nb_pool, bs, kv, hd)).astype(np.float32)
    v_pool = rng.normal(size=(nb_pool, bs, kv, hd)).astype(np.float32)
    pos_pool = np.full((nb_pool, bs), -1, np.int32)
    bt = np.zeros((b, nb), np.int32)
    pos = np.zeros((b,), np.int32)
    phys = list(range(1, nb_pool))
    rng.shuffle(phys)
    for i in range(b):
        if i in null_rows:
            continue
        n_used = int(rng.integers(1, nb + 1))
        length = int(rng.integers((n_used - 1) * bs + 1, n_used * bs + 1))
        for j in range(n_used):
            blk = phys.pop()
            bt[i, j] = blk
            lanes = np.arange(bs) + j * bs
            pos_pool[blk, lanes < length] = lanes[lanes < length]
        pos[i] = length - 1
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    return q, k_pool, v_pool, pos_pool, bt, pos


def prefill_case(rng, b, s, h, kv, hd, prefix):
    """Assembled keys as ``attn_prefill_paged`` builds them: a gathered
    prefix (null-padded past each row's cursor) followed by the chunk,
    per-row offsets and bucket-padded chunk lanes (kpos -1)."""
    L = prefix + s
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, L, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, L, kv, hd)).astype(np.float32)
    kpos = np.full((b, L), -1, np.int32)
    qpos = np.zeros((b, s), np.int32)
    for i in range(b):
        start = int(rng.integers(0, prefix + 1))
        n = int(rng.integers(1, s + 1))
        kpos[i, :start] = np.arange(start)
        qpos[i] = start + np.arange(s)
        kpos[i, prefix:prefix + n] = qpos[i, :n]
    return q, k, v, kpos, qpos


DECODE_SHAPES = [
    # (B, H, KV, hd, pool blocks, block size, table cols)
    (3, 4, 4, 16, 17, 4, 5),      # MHA, many small blocks
    (2, 4, 2, 32, 9, 8, 3),       # GQA 2:1
    (2, 8, 1, 64, 7, 16, 2),      # MQA
    (3, 16, 8, 128, 9, 16, 2),    # qwen3-0.6b heads
]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("window", [0, 7])
def test_paged_attention_plain_matches_reference(jax_ref, shape, window):
    jnp, jref, pallas_pa = jax_ref
    rng = np.random.default_rng(sum(shape) + window)
    args = decode_case(rng, *shape, null_rows=(1,))
    ours = ref.paged_attention_ref(*map(torch.from_numpy, args),
                                   window=window).numpy()
    jargs = [jnp.asarray(a) for a in args]
    oracle = np.asarray(jref.paged_attention_ref(*jargs, window=window))
    pallas = np.asarray(pallas_pa(*jargs, window=window, interpret=True))
    np.testing.assert_allclose(ours, oracle, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(ours, pallas, atol=ATOL, rtol=ATOL)
    assert np.all(ours[1] == 0)           # all-null row -> exact zeros


PREFILL_SHAPES = [
    # (B, S, H, KV, hd, prefix lanes)
    (2, 8, 4, 4, 16, 12),         # MHA
    (3, 8, 4, 2, 32, 16),         # GQA 2:1
    (2, 5, 8, 1, 64, 9),          # MQA, unaligned
    (4, 1, 4, 2, 32, 13),         # one query lane: fused decode rows
]


@pytest.mark.parametrize("shape", PREFILL_SHAPES)
@pytest.mark.parametrize("window", [0, 5])
def test_paged_prefill_plain_matches_reference(jax_ref, shape, window):
    jnp, jref, _ = jax_ref
    rng = np.random.default_rng(sum(shape) + 31 * window)
    args = prefill_case(rng, *shape)
    ours = ref.paged_prefill_ref(*map(torch.from_numpy, args),
                                 window=window).numpy()
    oracle = np.asarray(jref.paged_prefill_ref(
        *[jnp.asarray(a) for a in args], window=window))
    np.testing.assert_allclose(ours, oracle, atol=ATOL, rtol=ATOL)


def test_cpu_tensors_take_the_plain_versions():
    """``ops`` routes CPU tensors to the plain versions and launches no
    kernel; the kernel wrappers themselves refuse CPU tensors."""
    rng = np.random.default_rng(0)
    dec = [torch.from_numpy(a) for a in decode_case(rng, 2, 4, 2, 16, 9, 4, 3)]
    pre = [torch.from_numpy(a) for a in prefill_case(rng, 2, 4, 4, 2, 16, 8)]
    before = ops.launch_counts()
    assert torch.equal(ops.paged_attention(*dec, window=3),
                       ref.paged_attention_ref(*dec, window=3))
    assert torch.equal(ops.paged_prefill(*pre), ref.paged_prefill_ref(*pre))
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        pa_mod.paged_attention(*dec)
    with pytest.raises(ValueError, match="CUDA"):
        pp_mod.paged_prefill(*pre)


def test_cuda_sources_export_what_the_wrappers_bind():
    """Each ``csrc/<name>.cu`` defines the C symbols its wrapper binds
    with the argument count the wrapper declares (the compiler is not
    here to check it)."""
    assert build.sources() == ["conv2d", "flash_attention",
                               "paged_attention", "paged_prefill",
                               "rwkv6_scan"]
    for kern in (cv_mod.KERNEL, fa_mod.KERNEL, pa_mod.KERNEL, pp_mod.KERNEL,
                 rw_mod.KERNEL):
        text = (build.CSRC / f"{kern.library}.cu").read_text()
        for sym, argtypes in ((kern.symbol, kern.argtypes),
                              (kern.smem_symbol, kern.smem_argtypes)):
            if sym is None:             # static shared memory only
                continue
            m = re.search(r'extern "C" \w+ ' + sym + r"\(([^)]*)\)", text)
            assert m, sym
            assert len(m.group(1).split(",")) == len(argtypes), sym
        assert all(t in (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                         ctypes.POINTER(ctypes.c_longlong))
                   for t in kern.argtypes)


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _tol(kernel, dtype):
    if dtype == torch.float32:
        return dict(atol=1e-4, rtol=1e-4)
    return dict(atol={"paged_attention": 2e-3, "paged_prefill": 3e-2,
                      "flash_attention": 2e-3}[kernel], rtol=2 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_matches_plain(cuda, shape, window, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(shape) + window)
    q, k, v, kp, bt, pos = (torch.from_numpy(a).to(cuda) for a in
                            decode_case(rng, *shape, null_rows=(1,)))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n0 = pa_mod.KERNEL.launches
    out = ops.paged_attention(q, k, v, kp, bt, pos, window=window)
    torch.cuda.synchronize()
    assert pa_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_attention_ref(q, k, v, kp, bt, pos, window=window)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("paged_attention", dt))
    assert torch.all(out[1] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PREFILL_SHAPES + [(2, 40, 16, 8, 128, 70),
                                   (8, 1, 16, 8, 128, 512)])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_kernel_matches_plain(cuda, shape, window, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(shape) + 31 * window)
    q, k, v, kpos, qpos = (torch.from_numpy(a).to(cuda) for a in
                           prefill_case(rng, *shape))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n0 = pp_mod.KERNEL.launches
    out = ops.paged_prefill(q, k, v, kpos, qpos, window=window)
    torch.cuda.synchronize()
    assert pp_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_prefill_ref(q, k, v, kpos, qpos, window=window)
    # only lanes that see a key: the engine discards the others
    qp, kp = qpos[:, :, None], kpos[:, None, :]
    vis = (kp >= 0) & (kp <= qp)
    if window:
        vis &= qp - kp < window
    lanes = vis.any(-1)
    torch.testing.assert_close(out[lanes].float(), plain[lanes].float(),
                               **_tol("paged_prefill", dt))


# the reference's flash sweep (tests/test_kernels.py; Sk = Sq unless
# non-causal) x its masks, then the slot engine's prefill shapes at
# qwen3-0.6b's heads: the model's transposed (B,S,H,hd) views, one
# prompt row, windows 0 and 64, and non-causal with Sq != Sk
FA_CARD_CASES = (
    [(shape, causal, window, False)
     for shape in [(1, 4, 4, 64, 64, 64), (2, 8, 2, 96, 96, 64),
                   (1, 8, 1, 128, 128, 128), (2, 4, 4, 33, 75, 64)]
     for causal, window in [(True, 0), (True, 16), (False, 0)]]
    + [((1, 16, 8, s, s, 128), True, window, True)
       for s in (1, 37, 512) for window in (0, 64)]
    + [((1, 16, 8, 37, 100, 128), False, 0, True)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,window,model_layout", FA_CARD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_matches_plain(cuda, shape, causal, window,
                                              model_layout, dtype):
    b, h, kv, sq, sk, hd = shape
    if causal:
        sk = sq
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(shape) + window + int(causal))

    def operand(heads, s):
        a = torch.from_numpy(rng.normal(size=(b, s, heads, hd))
                             .astype(np.float32)).to(cuda, dt)
        # (B,S,heads,hd) viewed as (B,heads,S,hd), as the model passes it
        return a.transpose(1, 2) if model_layout else \
            a.transpose(1, 2).contiguous()

    q, k, v = operand(h, sq), operand(kv, sk), operand(kv, sk)
    n0 = fa_mod.KERNEL.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_mod.KERNEL.launches == n0 + 1
    assert out.shape == q.shape and out.stride() == q.stride()
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("flash_attention", dt))


# the reference's rwkv6 sweep (tests/test_kernels.py) x mild and extreme
# decay, then the slot path's shapes: rwkv6-1.6b's 32 heads of 64, one
# prompt row of 37 and 200 tokens, and a decode step over 4 slots, as the
# model passes them (float32 (B,S,H,hd) projections viewed (B,H,S,hd))
RW_CARD_CASES = (
    [(shape, extreme, False)
     for shape in [(1, 1, 16, 8), (2, 3, 50, 64), (1, 2, 128, 64)]
     for extreme in (False, True)]
    + [(shape, True, True)
       for shape in [(1, 32, 37, 64), (1, 32, 200, 64), (4, 32, 1, 64)]])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,extreme_decay,model_layout", RW_CARD_CASES)
@pytest.mark.parametrize("with_s0", [True, False])
def test_rwkv6_scan_kernel_matches_plain(cuda, shape, extreme_decay,
                                         model_layout, with_s0):
    b, h, s, hd = shape
    rng = np.random.default_rng(sum(shape) + int(extreme_decay))

    def operand(a):
        a = torch.from_numpy(a.astype(np.float32))
        # (B,S,H,hd) viewed as (B,H,S,hd), as the model passes it
        return a.permute(0, 2, 1, 3).contiguous().to(cuda).transpose(1, 2) \
            if model_layout else a.to(cuda)

    r, k, v = (operand(rng.normal(size=shape)) for _ in range(3))
    w = operand(np.exp(-np.exp(rng.normal(size=shape) * 2))
                if extreme_decay else np.full(shape, 0.95))
    u = torch.from_numpy(rng.normal(size=(h, hd)).astype(np.float32)
                         * 0.5).to(cuda)
    s0 = torch.from_numpy(rng.normal(size=(b, h, hd, hd)).astype(np.float32)
                          * 0.1).to(cuda) if with_s0 else None
    n0 = rw_mod.KERNEL.launches
    out, sf = ops.rwkv6_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert rw_mod.KERNEL.launches == n0 + 1
    assert out.shape == r.shape and out.stride() == r.stride()
    plain, plain_sf = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sf, plain_sf, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rwkv6_scan_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(1, 2, 3, 65, device=cuda)
    u = torch.zeros(2, 65, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        rw_mod.rwkv6_scan(x, x, x, x, u)
    y = torch.zeros(1, 2, 3, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        rw_mod.rwkv6_scan(y.bfloat16(), y, y, y, torch.zeros(2, 8,
                                                             device=cuda))
