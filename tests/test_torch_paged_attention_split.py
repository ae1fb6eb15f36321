"""The key-range split of the ``paged_attention`` decode kernel, on the CPU.

``repro_torch.kernels.paged_attention.plan`` cuts each request's block
table into pieces of whole blocks, from the batch, the KV heads, the
table width and the card's SM count alone; on the card each piece is a
CTA of one thread-block cluster per (request, KV head), and the cluster
merges the pieces' float32 partial softmax states
(``ref.attention_combine_ref`` is its plain version).  Here: (a) the
planner with an H100's 132 SMs: every table row is covered exactly once
at every piece length, at most one cluster of pieces, grids that
leave SMs idle are split to at least one CTA per SM at the serving
paths' shapes, grids that fill the card are not; (b) decode attention
computed piece by piece (``ref.attention_partial_ref`` per piece, then
the combine) against the whole plain version and the reference's
``paged_attention_ref`` on the same numpy inputs; (c) the kernel
source's piece arithmetic and compiled shapes against the planner's.
Tolerance: float32 on both sides over at most a few hundred keys, the
pieces' sums in another order and in base 2: ``atol=rtol=1e-5``.
"""
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from test_torch_kernels import decode_case  # noqa: E402

H100_SMS = 132
ATOL = 1e-5


@pytest.mark.parametrize("nb", [1, 7, 16, 32, 64])
def test_pieces_cover_each_table_row_once(nb):
    """Every piece length the planner may choose reads each logical block
    of the table exactly once, in order, and the kernel's grid holds
    exactly the pieces it needs."""
    for c in range(1, nb + 1):
        n = -(-nb // c)
        covered = []
        for j in range(n):
            lo, hi = pa_mod.piece_blocks(nb, c, j)
            assert lo < hi
            covered.extend(range(lo, hi))
        assert covered == list(range(nb))
    for b, kv in ((1, 1), (8, 8), (3, 4)):
        pl = pa_mod.plan(b, kv, nb, H100_SMS)
        assert pl.n_pieces == -(-nb // pl.blocks_per_piece)
        assert 1 <= pl.blocks_per_piece <= nb
        assert pl.n_pieces <= pa_mod.MAX_PIECES      # one cluster


# (name, batch rows, KV heads, table width): chip_smoke.py's decode_case
# (8 rows of qwen3-0.6b's 8 KV heads, 32 blocks of 16), the fusion-off
# paged engine as the smoke test and the serve CLI build it (max_batch 8,
# cache-max 256 over blocks of 16), and a longer cache-max of 1024
PATH_SHAPES = [("decode_case", 8, 8, 32), ("engine cache-max 256", 8, 8, 16),
               ("engine cache-max 1024", 8, 8, 64)]


@pytest.mark.parametrize("name,b,kv,nb", PATH_SHAPES,
                         ids=[s[0] for s in PATH_SHAPES])
def test_plan_fills_the_card_at_the_path_shapes(name, b, kv, nb):
    pl = pa_mod.plan(b, kv, nb, H100_SMS)
    assert b * kv < H100_SMS and pl.split
    assert pl.ctas(b, kv) >= H100_SMS


@pytest.mark.parametrize("b,kv,nb", [(17, 8, 32), (132, 1, 64), (64, 4, 16),
                                     (24, 8, 16)])
def test_plan_leaves_a_full_grid_whole(b, kv, nb):
    pl = pa_mod.plan(b, kv, nb, H100_SMS)
    assert b * kv >= H100_SMS
    assert not pl.split and pl.blocks_per_piece == nb


def test_plan_minimises_the_makespan_model():
    """The chosen piece length is the model's best among those that give
    every SM a CTA (among all where none does); a one-block table is
    never split (a piece holds whole blocks)."""
    from repro_torch.kernels import attention_split as split

    def cost(c, b, kv, nb):
        return split.makespan([nb], c, b * kv, H100_SMS,
                              fixed=pa_mod.FIXED_BLOCKS,
                              combine=pa_mod.COMBINE_BLOCKS,
                              ctas_per_sm=pa_mod.CTAS_PER_SM)

    for b, kv, nb in ((8, 8, 32), (8, 8, 16), (2, 4, 100), (1, 8, 9)):
        pl = pa_mod.plan(b, kv, nb, H100_SMS)
        lengths = [c for c in range(1, nb + 1)
                   if -(-nb // c) <= pa_mod.MAX_PIECES]
        full = [c for c in lengths
                if b * kv * -(-nb // c) >= H100_SMS] or lengths
        assert cost(pl.blocks_per_piece, b, kv, nb) == min(
            cost(c, b, kv, nb) for c in full)
    assert not pa_mod.plan(1, 1, 1, H100_SMS).split


def _piecewise(q, k_pool, v_pool, kpos_pool, bt, pos, window, c):
    """Decode attention over the table's pieces of ``c`` blocks, each a
    partial softmax state, merged by the plain combine."""
    b, h, hd = q.shape
    nb = bt.shape[1]
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    g = h // kv
    qg = q.reshape(b, kv, g, 1, hd)              # group heads as a batch
    parts = []
    for j in range(-(-nb // c)):
        lo, hi = pa_mod.piece_blocks(nb, c, j)
        blocks = bt[:, lo:hi].long()
        n = (hi - lo) * bs
        k = k_pool[blocks].reshape(b, n, kv, hd).permute(0, 2, 1, 3)
        v = v_pool[blocks].reshape(b, n, kv, hd).permute(0, 2, 1, 3)
        kp = kpos_pool[blocks].reshape(b, n)
        p = pos[:, None]
        vis = (kp >= 0) & (kp <= p)
        if window:
            vis &= p - kp < window
        parts.append(ref.attention_partial_ref(
            qg, k[:, :, None], v[:, :, None],
            vis[:, None, None, None, :].expand(b, kv, g, 1, n),
            1.0 / math.sqrt(hd)))
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    return ref.attention_combine_ref(m, l, acc).reshape(b, h, hd)


PIECE_CASES = [
    # (B, H, KV, hd, pool blocks, block size, table width, null rows)
    (4, 8, 4, 32, 4 * 9 + 1, 16, 9, (2,)),     # GQA 2:1, ragged rows
    (3, 4, 4, 16, 3 * 12 + 1, 4, 12, (0,)),    # MHA, small blocks
    (2, 16, 8, 128, 2 * 6 + 1, 16, 6, (1,)),   # qwen3-0.6b heads
]


@pytest.mark.parametrize("case", PIECE_CASES, ids=str)
@pytest.mark.parametrize("window", [0, 7])
def test_attention_by_pieces_matches_the_whole(case, window):
    *shape, nulls = case
    rng = np.random.default_rng(sum(shape) + window)
    args = decode_case(rng, *shape, null_rows=nulls)
    targs = [torch.from_numpy(a) for a in args]
    whole = ref.paged_attention_ref(*targs, window=window)
    oracle = np.asarray(jref.paged_attention_ref(
        *(jnp.asarray(a) for a in args), window=window))
    np.testing.assert_allclose(whole.numpy(), oracle, atol=ATOL, rtol=ATOL)
    nb = shape[-1]
    for c in sorted({1, 2, 3, nb}):
        got = _piecewise(*targs, window, c).numpy()
        np.testing.assert_allclose(got, whole.numpy(), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(got, oracle, atol=ATOL, rtol=ATOL)
        for r in nulls:
            assert np.all(got[r] == 0)          # all-null row -> zeros


def test_kernel_source_matches_the_planner():
    """The kernel's piece arithmetic, compiled head dims and group limit
    are the wrapper's (the compiler is not here to check them)."""
    text = "".join((build.CSRC / f).read_text()
                   for f in ("paged_attention.cuh", "paged_attention.cu"))
    assert "const int piece = blockIdx.x % a.n_pieces;" in text
    assert "const int p_lo = piece * a.blocks_per_piece;" in text
    assert "const int p_hi = min(p_lo + a.blocks_per_piece, a.nb);" in text
    assert "<<<B * a.KV, kThreads, smem, stream>>>" in text   # unsplit
    assert "cfg.gridDim = dim3(a.n_pieces * B * a.KV);" in text
    assert "attr[0].val.clusterDim.x = a.n_pieces;" in text
    assert f"constexpr int kMaxPieces = {pa_mod.MAX_PIECES};" in text
    cases = re.findall(r"case (\d+): return launch_g<T, S, \1>", text)
    assert tuple(map(int, cases)) == pa_mod.HEAD_DIMS
    assert f"constexpr int kMaxGroup = {pa_mod.MAX_GROUP};" in text
