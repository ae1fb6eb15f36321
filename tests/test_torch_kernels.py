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
apart: decode and flash ``atol=2e-3`` (the plain versions keep softmax
and value product in float32; the bf16 flash kernel feeds its
probabilities to the tensor cores as a bf16 hi + lo pair, ~16 bits);
prefill ``atol=3e-2`` (the plain version rounds the normalised
probabilities to bf16 before the value product, the bf16 kernel the
unnormalised ones).  The bf16 kernels' key-range split is planned on the
CPU in ``tests/test_torch_attention_split.py``.  The flash kernel's
CPU-side checks (plain version against the reference) are in
``tests/test_torch_flash_attention.py``, the WKV6 scan's in
``tests/test_torch_rwkv6.py``.  The WKV6 scan on the card, float32 only
(the model calls it so): ``atol=rtol=1e-4`` against outputs that reach
~100 — the kernel sums each step's 64 terms in another order, and the
state carries the rounding across up to 200 steps.  mamba's selective
scan on the card, float32: ``atol=rtol=1e-4`` against outputs of a few
units over up to 2,048 steps (each step's 16-term output sum in another
order, ``ex2.approx`` of the pre-scaled product against ``torch.exp``,
fused multiply-adds); with bf16 x and y, ``rtol=2**-7`` (both sides
round y once: one bf16 ulp) and the float32 ``atol``; its CPU-side
checks are in ``tests/test_torch_ssm.py`` and
``tests/test_torch_ssm_dtypes.py``.  Both
scans' masked lanes (``dt = 0``; decay 1 and key 0) must carry the state
through bit for bit, and the selective scan cut into calls with its
state carried must give the bits of one call.  The attention
kernels also run at dbrx-132b's and grok-1-314b's heads (48 query / 8 KV
heads of 128, a group of 6).
"""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention_split as split  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import conv2d as cv_mod  # noqa: E402
from repro_torch.kernels import conv2d_wgrad as cw_mod  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import paged_prefill as pp_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan_bwd as rwb_mod  # noqa: E402
from repro_torch.kernels import ssm_scan as ss_mod  # noqa: E402
from repro_torch.kernels import ssm_scan_bwd as ssb_mod  # noqa: E402

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


def prefill_case(rng, b, s, h, kv, hd, prefix, min_start=0):
    """Assembled keys as ``attn_prefill_paged`` builds them: a gathered
    prefix (null-padded past each row's cursor, which is at least
    ``min_start``) followed by the chunk, per-row offsets and
    bucket-padded chunk lanes (kpos -1)."""
    L = prefix + s
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, L, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, L, kv, hd)).astype(np.float32)
    kpos = np.full((b, L), -1, np.int32)
    qpos = np.zeros((b, s), np.int32)
    for i in range(b):
        start = int(rng.integers(min_start, prefix + 1))
        n = int(rng.integers(1, s + 1))
        kpos[i, :start] = np.arange(start)
        qpos[i] = start + np.arange(s)
        kpos[i, prefix:prefix + n] = qpos[i, :n]
    return q, k, v, kpos, qpos


def pool_case(rng, b, s, h, kv, hd, prefix, bs, min_start=0, null_rows=(),
              same_start=False):
    """A ragged dispatch as the paged engine hands it to
    ``attn_prefill_paged``: a pool (NB, bs, KV, hd) whose block 0 is the
    null block (pos -1), a table of ``ceil(prefix / bs)`` columns per row,
    null past the blocks the row holds, each row's cursor in
    ``[min_start, nb * bs]`` (one cursor for all rows if ``same_start``)
    and 1-``s`` valid chunk lanes (right-padded, kpos -1).  A row's blocks
    hold its positions below its cursor; a row may share its first blocks
    with the row before it (copy-on-write), whose positions there reach
    that row's own cursor, so a shared block can carry a donor tail past
    the sharer's cursor; the block holding the chunk's first lanes is the
    row's own, with its lanes from the cursor on -1.  Odd rows share
    (unless ``same_start``): each draws its cursor below the donor's, off
    a block boundary where it can, and takes the donor's blocks through
    the one holding its cursor, whose lanes past it are the donor's tail.
    ``null_rows``: padding rows, one valid lane at position 0 over an
    all-null table.  -> (q, k_pool, v_pool, pos_pool, block_table, starts
    (B,), k, v, kpos, qpos)."""
    nb = -(-prefix // bs)
    lp = nb * bs
    n_blocks = 1 + 2 * b * nb
    k_pool = rng.normal(size=(n_blocks, bs, kv, hd)).astype(np.float32)
    v_pool = rng.normal(size=(n_blocks, bs, kv, hd)).astype(np.float32)
    pos_pool = np.full((n_blocks, bs), -1, np.int32)
    bt = np.zeros((b, nb), np.int32)
    starts = np.zeros((b,), np.int32)
    kpos = np.full((b, s), -1, np.int32)
    qpos = np.zeros((b, s), np.int32)
    free = list(range(1, n_blocks))
    rng.shuffle(free)
    one_start = int(rng.integers(min_start, lp + 1))
    prev = None                       # (table row, cursor) of the donor
    for i in range(b):
        if i in null_rows:
            qpos[i] = np.arange(s)
            kpos[i, 0] = 0
            continue
        share = 0
        if same_start:
            start = one_start
        elif i % 2 and prev is not None and prev[1] > min_start:
            below = np.arange(min_start, prev[1])
            off = below[below % bs != 0] if bs > 1 else below
            start = int(rng.choice(off if len(off) else below))
            share = -(-start // bs)
        else:
            start = int(rng.integers(min_start, lp + 1))
        n = int(rng.integers(1, s + 1))
        starts[i] = start
        qpos[i] = start + np.arange(s)
        kpos[i, :n] = qpos[i, :n]
        for j in range(min(nb, -(-(start + n) // bs))):
            if j < share and prev[0][j]:
                bt[i, j] = prev[0][j]
                continue
            blk = free.pop()
            bt[i, j] = blk
            lanes = j * bs + np.arange(bs)
            pos_pool[blk] = np.where(lanes < start, lanes, -1)
        prev = (bt[i], start)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    return q, k_pool, v_pool, pos_pool, bt, starts, k, v, kpos, qpos


DECODE_SHAPES = [
    # (B, H, KV, hd, pool blocks, block size, table cols)
    (3, 4, 4, 16, 17, 4, 5),      # MHA, many small blocks
    (2, 4, 2, 32, 9, 8, 3),       # GQA 2:1
    (2, 8, 1, 64, 7, 16, 2),      # MQA
    (3, 16, 8, 128, 9, 16, 2),    # qwen3-0.6b heads
    (2, 8, 4, 256, 9, 16, 4),     # gemma3-4b heads
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
    (2, 8, 8, 4, 256, 20),        # gemma3-4b heads
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
    assert build.sources() == ["conv2d", "conv2d_wgrad", "flash_attention",
                               "paged_attention", "paged_attention_int8",
                               "paged_prefill", "paged_prefill_int8",
                               "rwkv6_scan", "rwkv6_scan_bwd", "ssm_scan",
                               "ssm_scan_bwd"]
    for kern in (cv_mod.KERNEL, cw_mod.KERNEL, fa_mod.KERNEL, pa_mod.KERNEL,
                 pa_mod.KERNEL_INT8, pp_mod.KERNEL, pp_mod.KERNEL_INT8,
                 pp_mod.KERNEL_POOL, pp_mod.KERNEL_POOL_INT8, rw_mod.KERNEL, rwb_mod.KERNEL, ss_mod.KERNEL,
                 ssb_mod.KERNEL):
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


# beyond the reference's sweep: qwen3-0.6b's heads at chip_smoke.py's
# decode shape (8 rows x 8 KV heads, split on an H100) and at 24 rows (192
# CTAs, whole), a table of 64 blocks, 64 and 128 query heads (groups of 8
# over head dims 64 and 128, and 64-head MHA), a group of 3 (compiled for
# 4), blocks of 24 keys (two chunks, the second half empty), and rows of
# all-null tables; (shape, null rows, whether the plan splits on an H100)
PA_CARD_CASES = [(shape, (1,), None) for shape in DECODE_SHAPES] + [
    ((8, 16, 8, 128, 8 * 32 + 1, 16, 32), (5,), True),
    ((24, 16, 8, 128, 24 * 16 + 1, 16, 16), (3, 17), False),
    ((4, 16, 8, 128, 4 * 64 + 1, 16, 64), (2,), True),
    ((2, 64, 8, 64, 2 * 24 + 1, 16, 24), (1,), True),
    ((2, 128, 16, 128, 2 * 24 + 1, 16, 24), (0,), True),
    ((3, 64, 64, 32, 3 * 6 + 1, 8, 6), (2,), False),
    ((2, 6, 2, 64, 2 * 24 + 1, 16, 24), (1,), True),
    ((3, 8, 4, 32, 3 * 20 + 1, 24, 20), (0,), True),
    ((8, 16, 8, 128, 8 * 20 + 1, 16, 20), (0, 3, 7), True),
    # phi4-mini-3.8b's heads (24 / 8: a group of 3) and qwen1.5-110b's
    # (64 / 8) at the fusion-off engine's tables of 16 blocks
    ((8, 24, 8, 128, 8 * 16 + 1, 16, 16), (5,), None),
    ((8, 64, 8, 128, 8 * 16 + 1, 16, 16), (5,), None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,null_rows,splits", PA_CARD_CASES)
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_matches_plain(cuda, shape, null_rows, splits,
                                              window, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(shape) + window)
    q, k, v, kp, bt, pos = (torch.from_numpy(a).to(cuda) for a in
                            decode_case(rng, *shape, null_rows=null_rows))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if splits is not None:
        b, _, kv = shape[:3]
        assert pa_mod.plan(b, kv, shape[-1],
                           split.sm_count(cuda)).split == splits
    n0 = pa_mod.KERNEL.launches
    out = ops.paged_attention(q, k, v, kp, bt, pos, window=window)
    torch.cuda.synchronize()
    assert pa_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_attention_ref(q, k, v, kp, bt, pos, window=window)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("paged_attention", dt))
    for r in null_rows:
        assert torch.all(out[r] == 0)


@pytest.mark.cuda
def test_paged_attention_refuses_what_it_does_not_take(cuda):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(cuda) for a in
            decode_case(rng, 2, 4, 2, 16, 9, 4, 3)]
    q, k, v, kp, bt, pos = args
    with pytest.raises(ValueError, match="head_dim 80"):
        pa_mod.paged_attention(torch.zeros(2, 4, 80, device=cuda),
                               torch.zeros(9, 4, 2, 80, device=cuda),
                               torch.zeros(9, 4, 2, 80, device=cuda),
                               kp, bt, pos)
    with pytest.raises(ValueError, match="group of 16"):
        pa_mod.paged_attention(torch.zeros(2, 16, 16, device=cuda),
                               k[:, :, :1].contiguous(),
                               v[:, :, :1].contiguous(), kp, bt, pos)
    flat = torch.zeros(1 + q.numel(), device=cuda)
    with pytest.raises(ValueError, match="16-byte boundary"):
        pa_mod.paged_attention(flat[1:].view(q.shape), k, v, kp, bt, pos)


# beyond the reference's sweep: a chunk and the fused decode dispatch at
# qwen3-0.6b's heads, slot decode (4 slots of 256 lanes), and the bf16
# tile's head dims 16-128 at groups of 1-8 with S off multiples of 16
PP_CARD_SHAPES = PREFILL_SHAPES + [
    (2, 40, 16, 8, 128, 70), (8, 1, 16, 8, 128, 512), (4, 1, 16, 8, 128, 255),
    (2, 37, 8, 8, 16, 100), (3, 100, 8, 2, 32, 64), (2, 200, 16, 2, 64, 40),
    (3, 1, 8, 1, 128, 300),
    # phi4-mini-3.8b's heads (24 / 8: a group of 3, 21 positions a tile)
    # and qwen1.5-110b's (64 / 8): a chunk and the fused decode dispatch
    (2, 100, 24, 8, 128, 70), (8, 1, 24, 8, 128, 512),
    (2, 100, 64, 8, 128, 70), (8, 1, 64, 8, 128, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PP_CARD_SHAPES)
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
# then the bf16 tile's head dims 16-128 at groups 1-8, S off multiples of
# 16 and 64, and non-causal windows with Sq > Sk, where late queries see
# no key (compared where they see one, zeros elsewhere)
FA_CARD_CASES = (
    [(shape, causal, window, False)
     for shape in [(1, 4, 4, 64, 64, 64), (2, 8, 2, 96, 96, 64),
                   (1, 8, 1, 128, 128, 128), (2, 4, 4, 33, 75, 64)]
     for causal, window in [(True, 0), (True, 16), (False, 0)]]
    + [((1, 16, 8, s, s, 128), True, window, True)
       for s in (1, 37, 100, 200, 512, 2048) for window in (0, 64)]
    + [((1, 16, 8, 37, 100, 128), False, 0, True)]
    + [(shape, causal, window, layout)
       for shape, layout in [((2, 8, 8, 100, 100, 16), False),
                             ((1, 8, 4, 37, 37, 32), True),
                             ((1, 16, 4, 200, 200, 64), True),
                             ((2, 16, 2, 1, 1, 32), False)]
       for causal, window in [(True, 0), (True, 48)]]
    + [((1, 8, 2, 190, 50, 32), False, 20, True),
       ((1, 16, 8, 300, 70, 128), False, 0, False)]
    # phi4-mini-3.8b's heads (24 / 8: a group of 3) and qwen1.5-110b's
    # (64 / 8), as the slot engine admits a prompt
    + [((1, h, 8, s, s, 128), True, window, True)
       for h in (24, 64) for s in (37, 512) for window in (0, 64)])


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
    qi = torch.arange(sq, device=cuda)[:, None]
    kj = torch.arange(sk, device=cuda)[None, :]
    vis = torch.ones(sq, sk, dtype=torch.bool, device=cuda)
    if causal:
        vis &= kj <= qi
    if window:
        vis &= qi - kj < window
    sees = vis.any(1)
    torch.testing.assert_close(out[:, :, sees].float(),
                               plain[:, :, sees].float(),
                               **_tol("flash_attention", dt))
    assert torch.all(out[:, :, ~sees] == 0)


# the reference's rwkv6 sweep (tests/test_kernels.py) x mild and extreme
# decay, then the slot path's shapes: rwkv6-1.6b's 32 heads of 64, one
# prompt row of 37 and 200 tokens, and a decode step over 4 slots, as the
# model passes them (float32 (B,S,H,hd) projections viewed (B,H,S,hd))
RW_CARD_CASES = (
    [(shape, extreme, False)
     for shape in [(1, 1, 16, 8), (2, 3, 50, 64), (1, 2, 128, 64)]
     for extreme in (False, True)]
    + [(shape, True, True)
       for shape in [(1, 32, 37, 64), (1, 32, 200, 64), (4, 32, 1, 64)]]
    # head dims off the 16-column block: 40 (a last block of 8 columns)
    # and 45 (odd: 4-byte copies), and 20 over a ragged tail of steps
    + [((2, 3, 45, 40), True, True), ((2, 2, 33, 45), True, False),
       ((1, 2, 70, 20), False, True)])


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


# one shape the planner splits and one it does not, per bf16 kernel, on
# this card (an H100's 132 SMs): flash at S=512 (16 query tiles x 8 KV
# heads = 128 CTAs) and S=2048; paged_prefill at the fused decode
# dispatch (8 rows x 8 KV heads) and a 4-row chunk of 256 lanes
SPLIT_CARD_CASES = [("flash_attention", 512, True),
                    ("flash_attention", 2048, False),
                    ("paged_prefill", 1, True),
                    ("paged_prefill", 256, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,s,splits", SPLIT_CARD_CASES)
def test_bf16_split_plan_on_the_card(cuda, kernel, s, splits):
    sms = split.sm_count(cuda)
    assert sms >= 128, f"planned for an H100's 132 SMs, not {sms}"
    rng = np.random.default_rng(s)
    if kernel == "flash_attention":
        pl = fa_mod.plan(1, 16, 8, s, s, True, 0, sms)
        q, k, v = (torch.from_numpy(rng.normal(size=(1, heads, s, 128))
                                    .astype(np.float32))
                   .to(cuda, torch.bfloat16) for heads in (16, 8, 8))
        out = ops.flash_attention(q, k, v)
        plain = ref.flash_attention_ref(q, k, v)
        lanes = torch.ones(out.shape[:-1], dtype=torch.bool, device=cuda)
    else:
        b = 8 if s == 1 else 4
        q, k, v, kpos, qpos = (torch.from_numpy(a).to(cuda) for a in
                               prefill_case(rng, b, s, 16, 8, 128, 512))
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        pl = pp_mod.plan(b, s, k.shape[1], 16, 8, sms)
        out = ops.paged_prefill(q, k, v, kpos, qpos)
        plain = ref.paged_prefill_ref(q, k, v, kpos, qpos)
        lanes = ((kpos[:, None, :] >= 0)
                 & (kpos[:, None, :] <= qpos[:, :, None])).any(-1)
    torch.cuda.synchronize()
    assert pl.split == splits
    if s == 1:
        assert pl.ctas(8 * 8) >= sms
    torch.testing.assert_close(out[lanes].float(), plain[lanes].float(),
                               **_tol(kernel, torch.bfloat16))


@pytest.mark.cuda
def test_bf16_wrappers_refuse_what_the_tile_does_not_take(cuda):
    bf = dict(device=cuda, dtype=torch.bfloat16)
    kp = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    qp = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    q, k = torch.zeros(1, 4, 8, 80, **bf), torch.zeros(1, 2, 8, 80, **bf)
    with pytest.raises(ValueError, match="head_dim 80"):
        fa_mod.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="head_dim 80"):
        pp_mod.paged_prefill(torch.zeros(1, 8, 4, 80, **bf),
                             torch.zeros(1, 8, 2, 80, **bf),
                             torch.zeros(1, 8, 2, 80, **bf), kp, qp)
    # views starting one element into their storage
    flat = torch.zeros(1 + 4 * 8 * 64, **bf)
    k = torch.zeros(1, 2, 8, 64, **bf)
    with pytest.raises(ValueError, match="16-byte boundary"):
        fa_mod.flash_attention(flat[1:].view(1, 4, 8, 64), k, k)
    with pytest.raises(ValueError, match="16-byte boundary"):
        pp_mod.paged_prefill(flat[1:].view(1, 8, 4, 64),
                             torch.zeros(1, 8, 2, 64, **bf),
                             torch.zeros(1, 8, 2, 64, **bf), kp, qp)
    # rows 68 elements apart: strides off multiples of 8
    wide = torch.zeros(1, 4, 8, 68, **bf)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        fa_mod.flash_attention(wide, k, k)


# ----------------------------------------- speculative decoding's shapes


def verify_case(rng, chunks=(16, 11), windows=8, pad_rows=6, s=16, h=16,
                kv=8, hd=128, prefix=256, take=5, bs=16):
    """A fused verify dispatch as the engine assembles it: chunk rows of
    ``chunks`` valid lanes, ``windows`` verify rows of ``take`` lanes
    starting mid-block (their prefix keys guarded below the start), and
    padding rows of one lane over an empty prefix; every row's tail
    lanes padded (kpos -1)."""
    b = len(chunks) + windows + pad_rows
    L = prefix + s
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, L, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, L, kv, hd)).astype(np.float32)
    kpos = np.full((b, L), -1, np.int32)
    qpos = np.zeros((b, s), np.int32)
    for i in range(b):
        if i < len(chunks):
            n, start = chunks[i], bs * int(rng.integers(0, prefix // bs))
        elif i < len(chunks) + windows:
            n = take
            start = bs * int(rng.integers(0, prefix // bs - 1)) + \
                int(rng.integers(1, bs))
        else:
            n, start = 1, 0
        kpos[i, :start] = np.arange(start)
        qpos[i] = start + np.arange(s)
        kpos[i, prefix:prefix + n] = qpos[i, :n]
    return q, k, v, kpos, qpos


@pytest.mark.cuda
@pytest.mark.parametrize("take", [2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_kernel_at_verify_shape(cuda, take, dtype):
    """Verify windows of ``take`` lanes beside two chunk rows, as the
    spec engine's ragged dispatch runs them (qwen3-0.6b's heads)."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(take)
    q, k, v, kpos, qpos = (torch.from_numpy(a).to(cuda) for a in
                           verify_case(rng, take=take))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n0 = pp_mod.KERNEL.launches
    out = ops.paged_prefill(q, k, v, kpos, qpos)
    torch.cuda.synchronize()
    assert pp_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_prefill_ref(q, k, v, kpos, qpos)
    lanes = ((kpos[:, None, :] >= 0)
             & (kpos[:, None, :] <= qpos[:, :, None])).any(-1)
    assert int(lanes[2:10].sum()) == 8 * 16          # every window lane
    torch.testing.assert_close(out[lanes].float(), plain[lanes].float(),
                               **_tol("paged_prefill", dt))


@pytest.mark.cuda
@pytest.mark.parametrize("s,valid", [(8, 5), (16, 11), (40, 40), (64, 33),
                                     (128, 100), (256, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_at_draft_shapes(cuda, s, valid, dtype):
    """The draft model's cacheless forwards: one row, qwen3-0.6b's
    heads, causal, ``valid`` tokens right-padded to ``s`` (a pad token's
    projections repeated), in the model's transposed views.  Every valid
    row must match the plain version on the unpadded row."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s)

    def operand(heads):
        a = rng.normal(size=(1, s, heads, 128)).astype(np.float32)
        a[:, valid:] = a[:, valid:valid + 1] if valid < s else 0
        return torch.from_numpy(a).to(cuda, dt).transpose(1, 2)

    q, k, v = operand(16), operand(8), operand(8)
    n0 = fa_mod.KERNEL.launches
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_mod.KERNEL.launches == n0 + 1
    plain = ref.flash_attention_ref(*(t[:, :, :valid] for t in (q, k, v)))
    torch.testing.assert_close(out[:, :, :valid].float(), plain.float(),
                               **_tol("flash_attention", dt))


# ------------------------------------------------- gemma3-4b's head_dim 256


# gemma3-4b's heads (8 query, 4 KV heads of 256) with its local layers'
# window of 1,024 and without: paged_prefill at the fused decode dispatch
# (8 rows, one lane, 512 prefix lanes), a chunk (4 rows, S=256, 512 prefix
# lanes) and a chunk whose queries sit past position 1,024 (2 rows, S=64,
# cursors in [1,100, 1,536]), so the band cuts the prefix
GEMMA3_PP_CARD_SHAPES = [((8, 1, 8, 4, 256, 512), 0),
                         ((4, 256, 8, 4, 256, 512), 0),
                         ((2, 64, 8, 4, 256, 1536), 1100)]
# flash_attention: one causal row of S=512 and S=2048 (the band cuts at
# 2048), in the model's transposed views
GEMMA3_FA_CARD_SHAPES = [(1, 8, 4, 512, 512, 256), (1, 8, 4, 2048, 2048, 256)]
# paged_attention: 8 rows over tables of 16 blocks of 16, and of 128
# blocks, where rows past position 1,024 are cut by the band
GEMMA3_PA_CARD_SHAPES = [((8, 8, 4, 256, 8 * 16 + 1, 16, 16), (5,)),
                         ((8, 8, 4, 256, 8 * 128 + 1, 16, 128), (2,))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,min_start", GEMMA3_PP_CARD_SHAPES)
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_kernel_at_head_dim_256(cuda, shape, min_start,
                                               window, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(shape) + window)
    q, k, v, kpos, qpos = (torch.from_numpy(a).to(cuda) for a in
                           prefill_case(rng, *shape, min_start=min_start))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n0 = pp_mod.KERNEL.launches
    out = ops.paged_prefill(q, k, v, kpos, qpos, window=window)
    torch.cuda.synchronize()
    assert pp_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_prefill_ref(q, k, v, kpos, qpos, window=window)
    qp, kp = qpos[:, :, None], kpos[:, None, :]
    vis = (kp >= 0) & (kp <= qp)
    if window:
        cut = vis & (qp - kp >= window)
        assert cut.any() == (min_start > 0)
        vis &= ~cut
    lanes = vis.any(-1)
    torch.testing.assert_close(out[lanes].float(), plain[lanes].float(),
                               **_tol("paged_prefill", dt))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GEMMA3_FA_CARD_SHAPES)
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_at_head_dim_256(cuda, shape, window, dtype):
    b, h, kv, sq, sk, hd = shape
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sq + window)

    def operand(heads):
        return torch.from_numpy(rng.normal(size=(b, sq, heads, hd))
                                .astype(np.float32)).to(cuda, dt) \
            .transpose(1, 2)

    q, k, v = operand(h), operand(kv), operand(kv)
    n0 = fa_mod.KERNEL.launches
    out = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa_mod.KERNEL.launches == n0 + 1
    plain = ref.flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("flash_attention", dt))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,null_rows", GEMMA3_PA_CARD_SHAPES)
@pytest.mark.parametrize("window", [0, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_at_head_dim_256(cuda, shape, null_rows,
                                                window, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(shape) + window)
    q, k, v, kp, bt, pos = (torch.from_numpy(a).to(cuda) for a in
                            decode_case(rng, *shape, null_rows=null_rows))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if shape[-1] * shape[-2] > 1024:
        assert int(pos.max()) >= 1024          # the band cuts some row
    n0 = pa_mod.KERNEL.launches
    out = ops.paged_attention(q, k, v, kp, bt, pos, window=window)
    torch.cuda.synchronize()
    assert pa_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_attention_ref(q, k, v, kp, bt, pos, window=window)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("paged_attention", dt))
    for r in null_rows:
        assert torch.all(out[r] == 0)


# ------------------------------------------------------------ the scans
# mamba's selective scan, (B, S, di): jamba's width (d_inner 16,384) at a
# prefill row and a chunk of 64, a full chunk of 256 over 8 rows, decode
# steps over 1 and 8 rows, and a long document's whole prompt of 2,048 on
# one row; reduced jamba's 512 channels; 200 channels (a CTA's last 32
# channels a quarter full)
SSM_CARD_SHAPES = [(1, 64, 16384), (8, 256, 16384), (1, 1, 16384),
                   (8, 1, 16384), (1, 2048, 16384), (2, 37, 512),
                   (3, 9, 200)]
# bf16 y against the plain version's bf16 y: both round the float32 sum
# once, so an element may land one bf16 ulp apart (2**-7 of its size);
# atol the float32 case's, which the sum before rounding may differ by
SSM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=1e-4, rtol=2 ** -7)}


def ssm_case(rng, b, s, di, n=16):
    """Scan inputs as the model makes them: softplus step sizes around
    0.3, decays -exp(N(0, 1)), N(0, 1) projections and inputs, a start
    state."""
    dt = np.log1p(np.exp(rng.normal(-1.0, 0.5, (b, s, di))))
    return [dt.astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, n)).astype(np.float32),
            rng.normal(size=(b, s, di)).astype(np.float32),
            -np.exp(rng.normal(size=(di, n))).astype(np.float32),
            rng.normal(size=(b, di, n)).astype(np.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSM_CARD_SHAPES)
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_matches_plain(cuda, shape, masked, x_dtype):
    b, s, di = shape
    rng = np.random.default_rng(sum(shape))
    t = [torch.from_numpy(a).to(cuda) for a in ssm_case(rng, b, s, di)]
    xdt = getattr(torch, x_dtype)
    t[3] = t[3].to(xdt)
    lens = torch.from_numpy(rng.integers(1, s + 1, b)).to(cuda)
    if masked:
        lanes = torch.arange(s, device=cuda)[None, :]
        t[0] = torch.where((lanes < lens[:, None])[..., None], t[0], 0.0)
    n0 = ss_mod.KERNEL.launches
    y, h = ops.ssm_scan(*t)
    torch.cuda.synchronize()
    assert ss_mod.KERNEL.launches == n0 + 1
    assert y.dtype == xdt and h.dtype == torch.float32
    plain_y, plain_h = ref.ssm_scan_ref(*t)
    torch.testing.assert_close(y.float(), plain_y.float(), **SSM_TOL[xdt])
    torch.testing.assert_close(h, plain_h, **SSM_TOL[torch.float32])
    if masked:
        # the state past a row's length is the state after its valid
        # lanes, bit for bit
        for i, n in enumerate(lens.tolist()):
            _, hi = ops.ssm_scan(*(a[i:i + 1, :n].contiguous()
                                   for a in t[:4]), t[4],
                                 t[5][i:i + 1].contiguous())
            assert torch.equal(h[i:i + 1], hi)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_ssm_scan_kernel_chunk_invariant(cuda, x_dtype):
    """Each state's update is one fixed expression walked in order, so
    cutting a sequence into calls with the state carried gives the same
    bits: one call over S = 256 against calls over 100 and 156 steps,
    and one call over S = 8 against 8 decode steps (S = 1); and the same
    rows in a call of 8 (16-step ring slots) and of 2 (32-step ones)."""
    rng = np.random.default_rng(24)
    t8 = [torch.from_numpy(a).to(cuda) for a in ssm_case(rng, 8, 256, 16384)]
    t8[3] = t8[3].to(getattr(torch, x_dtype))
    t = [a[:2].contiguous() for a in t8[:4]] + [t8[4], t8[5][:2].contiguous()]
    sms = split.sm_count(torch.device(cuda))
    assert [ss_mod.slot_steps(b, 16384, t[3].element_size(), sms)
            for b in (8, 2)] == [16, 32]
    y, h = ops.ssm_scan(*t)
    y_all, h_all = ops.ssm_scan(*t8)
    assert torch.equal(y_all[:2], y) and torch.equal(h_all[:2], h)

    def part(lo, hi, h0):
        return ops.ssm_scan(*(a[:, lo:hi].contiguous() for a in t[:4]),
                            t[4], h0)

    y1, h1 = part(0, 100, t[5])
    y2, h2 = part(100, 256, h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)
    y8, h8 = part(0, 8, t[5])
    hs, ys = t[5], []
    for i in range(8):
        yi, hs = part(i, i + 1, hs)
        ys.append(yi)
    assert torch.equal(torch.cat(ys, 1), y8) and torch.equal(hs, h8)
    assert torch.equal(y8, y[:, :8])


@pytest.mark.cuda
def test_ssm_scan_kernel_refuses_what_it_does_not_take(cuda):
    t = [torch.from_numpy(a).to(cuda) for a in
         ssm_case(np.random.default_rng(0), 2, 3, 8)]
    with pytest.raises(ValueError, match="state size"):
        ss_mod.ssm_scan(*(torch.from_numpy(a).to(cuda) for a in
                          ssm_case(np.random.default_rng(0), 2, 3, 8, n=8)))
    with pytest.raises(ValueError, match="contiguous"):
        ss_mod.ssm_scan(t[0].transpose(0, 1).contiguous().transpose(0, 1),
                        *t[1:])
    # x may be float32 or bfloat16 (y follows it); nothing else, and the
    # other operands are float32 only
    with pytest.raises(ValueError, match="float32"):
        ss_mod.ssm_scan(t[0], t[1], t[2], t[3].half(), t[4], t[5])
    with pytest.raises(ValueError, match="float32"):
        ss_mod.ssm_scan(t[0], t[1].bfloat16(), t[2], t[3], t[4], t[5])
    # 16-byte aligned operands and d_inner a multiple of 8 only
    bm = torch.empty(t[1].numel() + 1, device=cuda)[1:].view(t[1].shape)
    bm.copy_(t[1])
    with pytest.raises(ValueError, match="aligned"):
        ss_mod.ssm_scan(t[0], bm, *t[2:])
    with pytest.raises(ValueError, match="multiple of 8"):
        ss_mod.ssm_scan(*(torch.from_numpy(a).to(cuda) for a in
                          ssm_case(np.random.default_rng(0), 2, 3, 12)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 37, 64), (4, 32, 1, 64)])
def test_rwkv6_scan_kernel_carries_masked_lanes(cuda, shape):
    """The masked route's padding (decay 1, key 0 past a row's length)
    leaves the kernel's final state equal, bit for bit, to its state
    after the valid lanes only."""
    b, h, s, hd = shape
    rng = np.random.default_rng(s)
    r, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda) for _ in range(3))
    w = torch.from_numpy(np.exp(-np.exp(rng.normal(size=shape)))
                         .astype(np.float32)).to(cuda)
    u = torch.from_numpy(rng.normal(size=(h, hd)).astype(np.float32)
                         ).to(cuda)
    s0 = torch.from_numpy(rng.normal(size=(b, h, hd, hd)).astype(np.float32)
                          * 0.1).to(cuda)
    lens = [max(1, s - 5 * i) for i in range(b)]
    pad = torch.tensor([[t >= n for t in range(s)] for n in lens],
                       device=cuda)[:, None, :, None]
    _, sf = ops.rwkv6_scan(r, torch.where(pad, 0.0, k), v,
                           torch.where(pad, 1.0, w), u, s0)
    for i, n in enumerate(lens):
        _, want = ops.rwkv6_scan(*(a[i:i + 1, :, :n].contiguous()
                                   for a in (r, k, v, w)), u,
                                 s0[i:i + 1].contiguous())
        assert torch.equal(sf[i:i + 1], want)


# dbrx-132b's and grok-1-314b's attention heads (48 query / 8 KV heads of
# 128: a group of 6): paged_prefill at the fused decode dispatch (8 rows,
# one lane, 512 prefix lanes) and a chunk (4 rows, S=256), paged_attention
# over tables of 16 blocks of 16, flash_attention at one causal row of
# S=512
MOE_HEADS = (48, 8, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_kernel_at_moe_heads(cuda, s, dtype):
    h, kv, hd = MOE_HEADS
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(s)
    q, k, v, kpos, qpos = (torch.from_numpy(a).to(cuda) for a in
                           prefill_case(rng, 8 if s == 1 else 4, s, h, kv,
                                        hd, 512))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n0 = pp_mod.KERNEL.launches
    out = ops.paged_prefill(q, k, v, kpos, qpos)
    torch.cuda.synchronize()
    assert pp_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_prefill_ref(q, k, v, kpos, qpos)
    lanes = ((kpos[:, None, :] >= 0) &
             (kpos[:, None, :] <= qpos[:, :, None])).any(-1)
    torch.testing.assert_close(out[lanes].float(), plain[lanes].float(),
                               **_tol("paged_prefill", dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_kernel_at_moe_heads(cuda, dtype):
    h, kv, hd = MOE_HEADS
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(48)
    q, k, v, kp, bt, pos = (torch.from_numpy(a).to(cuda) for a in
                            decode_case(rng, 8, h, kv, hd, 8 * 16 + 1, 16,
                                        16, null_rows=(5,)))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    n0 = pa_mod.KERNEL.launches
    out = ops.paged_attention(q, k, v, kp, bt, pos)
    torch.cuda.synchronize()
    assert pa_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_attention_ref(q, k, v, kp, bt, pos)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("paged_attention", dt))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_at_moe_heads(cuda, dtype):
    h, kv, hd = MOE_HEADS
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(512)

    def operand(heads):
        return torch.from_numpy(rng.normal(size=(1, 512, heads, hd))
                                .astype(np.float32)).to(cuda, dt) \
            .transpose(1, 2)

    q, k, v = operand(h), operand(kv), operand(kv)
    n0 = fa_mod.KERNEL.launches
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_mod.KERNEL.launches == n0 + 1
    plain = ref.flash_attention_ref(q, k, v)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("flash_attention", dt))


# ------------------------------------------------------------ int8 cache
# The int8 KV cache's variants: the pools (decode) or the gathered prefix
# (ragged prefill, slot decode) int8 with a float32 scale per (lane, KV
# head), quantized as the model quantizes them.  Each launch is held to
# its int8 plain version at the float kernel's tolerance, and must equal,
# bit for bit, the float kernel's launch over the dequantized keys (the
# prefill over the dequantized prefix and the chunk, concatenated): the
# kernels dequantize to the model dtype before any product.


def _quantized(t):
    from repro_torch.models.attention import _quantize_kv
    return _quantize_kv(t)


PA_INT8_CARD_CASES = PA_CARD_CASES + [(s, n, None)
                                      for s, n in GEMMA3_PA_CARD_SHAPES]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,null_rows,splits", PA_INT8_CARD_CASES)
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_int8_kernel(cuda, shape, null_rows, splits, window,
                                     dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sum(shape) + window + 1)
    q, k, v, kp, bt, pos = (torch.from_numpy(a).to(cuda) for a in
                            decode_case(rng, *shape, null_rows=null_rows))
    q = q.to(dt)
    (k8, ks), (v8, vs) = _quantized(k.to(dt)), _quantized(v.to(dt))
    n0, f0 = pa_mod.KERNEL_INT8.launches, pa_mod.KERNEL.launches
    out = ops.paged_attention_int8(q, k8, v8, ks, vs, kp, bt, pos,
                                   window=window)
    torch.cuda.synchronize()
    assert pa_mod.KERNEL_INT8.launches == n0 + 1
    assert pa_mod.KERNEL.launches == f0
    plain = ref.paged_attention_int8_ref(q, k8, v8, ks, vs, kp, bt, pos,
                                         window=window)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("paged_attention", dt))
    for r in null_rows:
        assert torch.all(out[r] == 0)
    dense = ops.paged_attention(q, ref.dequantize_kv(k8, ks, dt),
                                ref.dequantize_kv(v8, vs, dt), kp, bt, pos,
                                window=window)
    assert torch.equal(out, dense)


PP_INT8_CARD_SHAPES = ([(shape, 0) for shape in PP_CARD_SHAPES]
                       + GEMMA3_PP_CARD_SHAPES)


def _check_int8_prefill(device, shape, min_start, window, slot, dtype):
    """The prefix of ``prefill_case`` (its first ``prefix`` lanes) int8,
    the chunk in the model dtype; ``slot``: one query lane over the int8
    prefix alone (a slot decode, no chunk keys).  One launch of the int8
    entry, within tolerance of its plain version on the valid lanes and
    bit-equal to the float entry over the dequantized keys."""
    dt = getattr(torch, dtype)
    b, s, h, kv, hd, lp = shape
    rng = np.random.default_rng(sum(shape) + window + 2)
    q, k, v, kpos, qpos = (torch.from_numpy(a).to(device) for a in
                           prefill_case(rng, *shape, min_start=min_start))
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    (k8, ks), (v8, vs) = _quantized(k[:, :lp]), _quantized(v[:, :lp])
    kc, vc, kpc = k[:, lp:], v[:, lp:], kpos[:, lp:]
    if slot:
        q, qpos = q[:, :1].contiguous(), qpos[:, :1].contiguous()
        kc, vc, kpc = kc[:, :0], vc[:, :0], kpc[:, :0]
    kc, vc, kpc, kpp = (t.contiguous() for t in (kc, vc, kpc,
                                                 kpos[:, :lp]))
    n0, f0 = pp_mod.KERNEL_INT8.launches, pp_mod.KERNEL.launches
    out = ops.paged_prefill_int8(q, k8, v8, ks, vs, kpp, kc, vc, kpc, qpos,
                                 window=window)
    torch.cuda.synchronize()
    assert pp_mod.KERNEL_INT8.launches == n0 + 1
    assert pp_mod.KERNEL.launches == f0
    plain = ref.paged_prefill_int8_ref(q, k8, v8, ks, vs, kpp, kc, vc, kpc,
                                       qpos, window=window)
    kp_all = torch.cat([kpp, kpc], 1)
    qp, kp = qpos[:, :, None], kp_all[:, None, :]
    vis = (kp >= 0) & (kp <= qp)
    if window:
        vis &= qp - kp < window
    lanes = vis.any(-1)
    torch.testing.assert_close(out[lanes].float(), plain[lanes].float(),
                               **_tol("paged_prefill", dt))
    dense = ops.paged_prefill(
        q, torch.cat([ref.dequantize_kv(k8, ks, dt), kc], 1).contiguous(),
        torch.cat([ref.dequantize_kv(v8, vs, dt), vc], 1).contiguous(),
        kp_all.contiguous(), qpos, window=window)
    assert torch.equal(out, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,min_start", PP_INT8_CARD_SHAPES)
@pytest.mark.parametrize("window", [0, 5, 1024])
@pytest.mark.parametrize("slot", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_int8_kernel(cuda, shape, min_start, window, slot,
                                   dtype):
    """``_check_int8_prefill`` at the float entries' card shapes (their
    prefixes 40-512 lanes, tiles straddling Lp where it is not a multiple
    of 64) and gemma3-4b's."""
    _check_int8_prefill(cuda, shape, min_start, window, slot, dtype)


# The bf16 tile's int8 prefix at both shapes of work: decode shapes (16
# query rows or fewer, the warps on their own keys) and chunks (each warp
# on its own rows); no prefix (Lp = 0), a prefix ending inside the first
# tile or just past it (Lp = 1, 63, 65: a tile straddling Lp), a group of
# 1 with 16 query lanes, head_dim 256
PP_INT8_TILE_SHAPES = [
    (4, 1, 16, 8, 128, 0), (2, 40, 16, 8, 128, 0), (4, 1, 16, 8, 128, 1),
    (4, 1, 16, 8, 128, 63), (4, 1, 16, 8, 128, 65), (2, 100, 16, 8, 128, 65),
    (2, 16, 8, 8, 64, 77), (3, 1, 8, 1, 128, 130), (8, 1, 8, 4, 256, 100),
    (2, 64, 8, 4, 256, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PP_INT8_TILE_SHAPES)
@pytest.mark.parametrize("window", [0, 5, 1024])
def test_paged_prefill_int8_tile_paths(cuda, shape, window):
    _check_int8_prefill(cuda, shape, 0, window, False, "bfloat16")


@pytest.mark.cuda
def test_int8_caches_are_refused_by_the_float_entries(cuda):
    """An int8 pool handed to the float entries raises (``ops`` on any
    device, the wrappers on the card); the int8 entries refuse float
    pools and misshapen scales."""
    rng = np.random.default_rng(0)
    q, k, v, kp, bt, pos = (torch.from_numpy(a).to(cuda) for a in
                            decode_case(rng, 2, 4, 2, 16, 9, 4, 3))
    (k8, ks), (v8, vs) = _quantized(k), _quantized(v)
    with pytest.raises(ValueError, match="int8"):
        ops.paged_attention(q, k8, v8, kp, bt, pos)
    with pytest.raises(ValueError, match="k_pool and v_pool"):
        pa_mod.paged_attention(q, k8, v8, kp, bt, pos)
    with pytest.raises(ValueError, match="k_pool and v_pool"):
        pa_mod.paged_attention_int8(q, k, v, ks, vs, kp, bt, pos)
    with pytest.raises(ValueError, match="k_scale"):
        pa_mod.paged_attention_int8(q, k8, v8, ks[:, :2].contiguous(), vs,
                                    kp, bt, pos)
    qq, kk, vv, kpos, qpos = (torch.from_numpy(a).to(cuda) for a in
                              prefill_case(rng, 2, 4, 4, 2, 16, 8))
    (p8, ps), _ = _quantized(kk[:, :8]), None
    with pytest.raises(ValueError, match="int8"):
        ops.paged_prefill(qq, torch.cat([p8, p8], 1), kk, kpos, qpos)
    with pytest.raises(ValueError, match="int8"):
        pp_mod.paged_prefill_int8(qq, kk[:, :8].contiguous(),
                                  kk[:, :8].contiguous(), ps, ps,
                                  kpos[:, :8].contiguous(),
                                  kk[:, 8:].contiguous(),
                                  vv[:, 8:].contiguous(),
                                  kpos[:, 8:].contiguous(), qpos)


# whisper-tiny's and paligemma-3b's inference attention: the encoder's
# non-causal self-attention over 1,500 frames (6 / 6 heads of 64; Sk not a
# multiple of the 64-key tile), the cross-attention at a decode step (8
# rows, Sq 1) and at a prompt's prefill (Sq 200) over those frames, and
# paligemma's prefix-LM (8 query heads over 1 KV head of 256, a group of 8
# at head_dim 256) with its 256 patches, and with a prefix of 200 that is
# not a multiple of the tile, and 40 (every query sees every key); (B, H,
# KV, Sq, Sk, hd, causal, prefix)
FRONTEND_FA_CARD_CASES = [
    (1, 6, 6, 1500, 1500, 64, False, 0),
    (8, 6, 6, 1, 1500, 64, False, 0),
    (1, 6, 6, 200, 1500, 64, False, 0),
    (1, 8, 1, 456, 456, 256, True, 256),
    (1, 8, 1, 456, 456, 256, True, 200),
    (2, 8, 1, 40, 40, 256, True, 40),
    (1, 6, 6, 70, 70, 64, True, 65),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FRONTEND_FA_CARD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_at_frontend_shapes(cuda, shape, dtype):
    """The kernel against its plain version, in the model's transposed
    views; with a prefix, rows before its end differ from the causal
    launch's (the prefix is really seen) and the later rows agree with
    it."""
    b, h, kv, sq, sk, hd, causal, prefix = shape
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(sq + sk + prefix)

    def operand(heads, s):
        return torch.from_numpy(rng.normal(size=(b, s, heads, hd))
                                .astype(np.float32)).to(cuda, dt) \
            .transpose(1, 2)

    q, k, v = operand(h, sq), operand(kv, sk), operand(kv, sk)
    n0 = fa_mod.KERNEL.launches
    out = ops.flash_attention(q, k, v, causal=causal, prefix=prefix)
    torch.cuda.synchronize()
    assert fa_mod.KERNEL.launches == n0 + 1
    assert out.stride() == q.stride()
    plain = ref.flash_attention_ref(q, k, v, causal=causal, prefix=prefix)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("flash_attention", dt))
    if prefix:
        causal_out = ops.flash_attention(q, k, v)
        assert not torch.equal(causal_out[:, :, :prefix - 1],
                               out[:, :, :prefix - 1])
        torch.testing.assert_close(causal_out[:, :, prefix:].float(),
                                   out[:, :, prefix:].float(),
                                   **_tol("flash_attention", dt))


# slot decode (one query lane a row) at whisper-tiny's heads (6 / 6 of 64)
# and paligemma-3b's (8 / 1 of 256): 8 rows over strips of 216 and 472
# lanes, each row filled to its own length; (B, H, KV, hd, lanes)
FRONTEND_SLOT_CARD_SHAPES = [(8, 6, 6, 64, 216), (8, 8, 1, 256, 472)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FRONTEND_SLOT_CARD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_kernel_at_frontend_slot_decode(cuda, shape, dtype):
    b, h, kv, hd, lanes = shape
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(lanes)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, lanes, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, lanes, kv, hd)).astype(np.float32)
    n = rng.integers(lanes // 4, lanes, size=b)
    kpos = np.where(np.arange(lanes)[None] <= n[:, None],
                    np.arange(lanes)[None], -1).astype(np.int32)
    qpos = n[:, None].astype(np.int32)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in (q, k, v))
    kpos, qpos = torch.from_numpy(kpos).to(cuda), torch.from_numpy(qpos).to(
        cuda)
    n0 = pp_mod.KERNEL.launches
    out = ops.paged_prefill(q, k, v, kpos, qpos)
    torch.cuda.synchronize()
    assert pp_mod.KERNEL.launches == n0 + 1
    plain = ref.paged_prefill_ref(q, k, v, kpos, qpos)
    torch.testing.assert_close(out.float(), plain.float(),
                               **_tol("paged_prefill", dt))


# --------------------------------------------- the pool entries of prefill
# ``paged_prefill_pool`` / ``paged_prefill_pool_int8`` read the prefix out
# of the pool through the block table: each launch must equal, bit for
# bit, the contiguous entry's launch over the keys gathered through the
# table, guarded at each row's cursor and concatenated with the chunk (what
# ``attn_prefill_paged`` built before its op), at the float entries' card
# shapes, the verify dispatch, gemma3-4b's and the MoE stacks' heads and
# the frontends' slot-decode heads, block sizes 1, 4 and 16, split and
# unsplit plans, one cursor for every row (a Python int) and per-row
# cursors, and all-null tables.

POOL_CARD_SHAPES = (
    [(shape, 0, 0) for shape in PREFILL_SHAPES]
    + [(shape, 0, 5) for shape in PREFILL_SHAPES]
    + [(shape, m, w) for shape, m in GEMMA3_PP_CARD_SHAPES for w in (0, 1024)]
    + [((8, 1) + MOE_HEADS + (512,), 0, 0), ((4, 256) + MOE_HEADS + (512,),
                                             0, 0)]
    + [((8, 1, 16, 8, 128, 512), 0, 0), ((2, 40, 16, 8, 128, 70), 0, 0),
       ((16, 16, 16, 8, 128, 256), 0, 0)]
    + [((b, 1, h, kv, hd, lanes), 0, 0)
       for b, h, kv, hd, lanes in FRONTEND_SLOT_CARD_SHAPES])


def _pool_operands(device, dt, args, int8):
    """pool_case's arrays on ``device`` in dtype ``dt``; ``int8``: the
    pool quantized as the model quantizes it -> (q, pool leaves (k, v, and
    for int8 k_s, v_s), pos_pool, block_table, starts, k, v, kpos,
    qpos)."""
    q, kp, vp, pp, bt, starts, k, v, kpos, qpos = (
        torch.from_numpy(a).to(device) for a in args)
    q, k, v, kp, vp = (t.to(dt) for t in (q, k, v, kp, vp))
    if int8:
        (k8, ks), (v8, vs) = _quantized(kp), _quantized(vp)
        leaves = (k8, v8, ks, vs)
    else:
        leaves = (kp, vp)
    return q, leaves, pp, bt, starts, k, v, kpos, qpos


def _gathered(leaves, pp, bt, start, k, v, kpos, dt):
    """The keys the pool entries read, assembled: the prefix gathered
    through the table (dequantized for int8), its positions guarded at
    the cursors, the chunk after it."""
    g = [ref.gather_prefix(t, bt) for t in leaves]
    if len(g) == 4:
        g = [ref.dequantize_kv(g[0], g[2], dt),
             ref.dequantize_kv(g[1], g[3], dt)]
    ppos = ref.guarded_positions(pp, bt, start)
    return (torch.cat([g[0], k], 1).contiguous(),
            torch.cat([g[1], v], 1).contiguous(),
            torch.cat([ppos, kpos], 1).contiguous())


def _check_pool_entry(device, shape, min_start, window, bs, dtype, int8,
                      same_start=False, null_rows=(1,)):
    dt = getattr(torch, dtype)
    b = shape[0]
    rng = np.random.default_rng(sum(shape) + window + 7 * bs + int8)
    null_rows = tuple(r for r in null_rows if r < b)
    q, leaves, pp, bt, starts, k, v, kpos, qpos = _pool_operands(
        device, dt, pool_case(rng, *shape, bs, min_start=min_start,
                              null_rows=null_rows, same_start=same_start),
        int8)
    start = int(starts[0]) if same_start else starts
    kern = pp_mod.KERNEL_POOL_INT8 if int8 else pp_mod.KERNEL_POOL
    entry = ops.paged_prefill_pool_int8 if int8 else ops.paged_prefill_pool
    plain = (ref.paged_prefill_pool_int8_ref if int8
             else ref.paged_prefill_pool_ref)
    n0, c0 = kern.launches, pp_mod.KERNEL.launches
    out = entry(q, *leaves, pp, bt, start, k, v, kpos, qpos, window=window)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1 and pp_mod.KERNEL.launches == c0
    k_all, v_all, kp_all = _gathered(leaves, pp, bt, start, k, v, kpos, dt)
    dense = ops.paged_prefill(q, k_all, v_all, kp_all, qpos, window=window)
    assert torch.equal(out, dense)
    qp, kp = qpos[:, :, None], kp_all[:, None, :]
    vis = (kp >= 0) & (kp <= qp)
    if window:
        vis &= qp - kp < window
    lanes = vis.any(-1)
    want = plain(q, *leaves, pp, bt, start, k, v, kpos, qpos, window=window)
    torch.testing.assert_close(out[lanes].float(), want[lanes].float(),
                               **_tol("paged_prefill", dt))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape,min_start,window", POOL_CARD_SHAPES)
@pytest.mark.parametrize("bs", [1, 4, 16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_pool_entries_equal_the_gathered_launch(
        cuda, shape, min_start, window, bs, int8, dtype):
    _check_pool_entry(cuda, shape, min_start, window, bs, dtype, int8)


@pytest.mark.cuda
@pytest.mark.parametrize("s,splits", [(1, True), (256, False)])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("same_start", [False, True])
def test_paged_prefill_pool_plans_and_cursors(cuda, s, splits, int8,
                                              same_start):
    """qwen3-0.6b's heads: the fused decode dispatch (split on an H100)
    and a chunk (whole), one cursor for every row (an int) or one a
    row."""
    b = 8 if s == 1 else 4
    assert pp_mod.plan(b, s, 512 + s, 16, 8,
                       split.sm_count(cuda)).split == splits
    _check_pool_entry(cuda, (b, s, 16, 8, 128, 512), 0, 0, 16, "bfloat16",
                      int8, same_start=same_start)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_pool_all_null_tables(cuda, int8, dtype):
    """Every row a padding row over an all-null table: each sees its own
    chunk key alone."""
    out = _check_pool_entry(cuda, (4, 8, 16, 8, 128, 64), 0, 0, 16, dtype,
                            int8, null_rows=range(4))
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
def test_paged_prefill_pool_entries_refuse_what_they_do_not_take(cuda):
    rng = np.random.default_rng(3)
    args = pool_case(rng, 2, 8, 4, 2, 64, 32, 16)
    q, (kp, vp), pp, bt, starts, k, v, kpos, qpos = _pool_operands(
        cuda, torch.bfloat16, args, False)
    fine = (q, kp, vp, pp, bt, starts, k, v, kpos, qpos)
    pp_mod.paged_prefill_pool(*fine)
    with pytest.raises(ValueError, match="q's dtype"):
        pp_mod.paged_prefill_pool(q, kp.float(), vp.float(), *fine[3:])
    with pytest.raises(ValueError, match="pool is torch.float32"):
        ops.paged_prefill_pool(q, kp.float(), vp.float(), *fine[3:])
    strided = torch.zeros(kp.shape[:-1] + (2 * kp.shape[-1],),
                          dtype=kp.dtype, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="k_pool must be contiguous"):
        pp_mod.paged_prefill_pool(q, strided, vp, *fine[3:])
    with pytest.raises(ValueError, match="block_table is on cpu"):
        pp_mod.paged_prefill_pool(q, kp, vp, pp, bt.cpu(), *fine[5:])
    with pytest.raises(ValueError, match="start_pos"):
        pp_mod.paged_prefill_pool(q, kp, vp, pp, bt, starts.long(),
                                  *fine[6:])
    (k8, ks), (v8, vs) = _quantized(kp), _quantized(vp)
    with pytest.raises(ValueError, match="int8"):
        ops.paged_prefill_pool(q, k8, v8, *fine[3:])
    pp_mod.paged_prefill_pool_int8(q, k8, v8, ks, vs, *fine[3:])
    with pytest.raises(ValueError, match="must be int8"):
        pp_mod.paged_prefill_pool_int8(q, kp, vp, ks, vs, *fine[3:])
    strided8 = torch.zeros(k8.shape[:-1] + (2 * k8.shape[-1],),
                           dtype=torch.int8, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="k_pool must be contiguous"):
        pp_mod.paged_prefill_pool_int8(q, strided8, v8, ks, vs, *fine[3:])
    with pytest.raises(ValueError, match="block_table is on cpu"):
        pp_mod.paged_prefill_pool_int8(q, k8, v8, ks, vs, pp, bt.cpu(),
                                       *fine[5:])
    with pytest.raises(ValueError, match="k_scale_pool"):
        pp_mod.paged_prefill_pool_int8(q, k8, v8, ks[:, :2].contiguous(), vs,
                                       *fine[3:])
    torch.cuda.synchronize()
