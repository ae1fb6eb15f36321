"""The key-range split of the bf16 attention kernels, on the CPU.

``repro_torch.kernels.attention_split`` plans, from the shape and the
card's SM count alone, how many pieces of whole 64-key tiles each query
tile's key range is cut into; on the card each piece is a CTA and a
combine pass merges the pieces (``ref.attention_combine_ref`` is its
plain version).  Here: (a) the planner at the serving paths' shapes with
an H100's 132 SMs: every query tile's key range is covered exactly once
by 64-aligned pieces, and small grids are split; (b) the plain combine
over attention computed piece by piece (``ref.attention_partial_ref``)
against the reference's ``flash_attention_ref`` / ``paged_prefill_ref``
on the same numpy inputs.  Tolerance: float32 on both sides over at most
a few hundred keys, the pieces' sums in another order and in base 2:
``atol=rtol=1e-5``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import attention_split as split  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import paged_prefill as pp_mod  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from test_torch_kernels import prefill_case  # noqa: E402

H100_SMS = 132
ATOL = 1e-5

# (name, key ranges, plan, CTAs per query tile, split expected): the slot
# engine's prefill at one prompt row of qwen3-0.6b's 16/8 heads (a short
# prompt, the 512-token smoke prompt, a long one), a paged chunk step (4
# rows of 256 lanes over a 512-lane prefix), the fused decode dispatch (8
# rows of one lane, 512 prefix lanes) and slot decode (4 slots of 256
# lanes); tq = 64 / g = 32 query positions a tile, 1 when S = 1
PATH_SHAPES = [
    ("flash S=37", split.flash_key_ranges(37, 37, 32, True, 0),
     fa_mod.plan(1, 16, 8, 37, 37, True, 0, H100_SMS), 8, False),
    ("flash S=512", split.flash_key_ranges(512, 512, 32, True, 0),
     fa_mod.plan(1, 16, 8, 512, 512, True, 0, H100_SMS), 8, True),
    ("flash S=2048", split.flash_key_ranges(2048, 2048, 32, True, 0),
     fa_mod.plan(1, 16, 8, 2048, 2048, True, 0, H100_SMS), 8, False),
    ("paged 4x256", split.paged_key_ranges(256, 768, 32),
     pp_mod.plan(4, 256, 768, 16, 8, H100_SMS), 32, False),
    ("paged 8x1", split.paged_key_ranges(1, 513, 1),
     pp_mod.plan(8, 1, 513, 16, 8, H100_SMS), 64, True),
    ("slot decode 4x1", split.paged_key_ranges(1, 256, 1),
     pp_mod.plan(4, 1, 256, 16, 8, H100_SMS), 32, True),
]


@pytest.mark.parametrize("name,ranges,pl,ctas,splits", PATH_SHAPES,
                         ids=[s[0] for s in PATH_SHAPES])
def test_plan_covers_each_key_range_once(name, ranges, pl, ctas, splits):
    assert len(pl.pieces) == len(ranges)
    assert pl.split == splits
    for (lo, hi), n in zip(ranges, pl.pieces):
        assert n == split.pieces_of(lo, hi, pl.tiles_per_piece)
        covered = []
        for j in range(n):
            a, b = split.piece_keys(lo, hi, pl.tiles_per_piece, j)
            if a >= b:                 # only an empty range has none
                assert n == 1 and lo >= hi
                continue
            if a != lo:
                assert a % split.TILE_KEYS == 0
            if b != hi:
                assert b % split.TILE_KEYS == 0
            covered.extend(range(a, b))
        assert covered == list(range(lo, hi))     # once each, in order
    if name.endswith("x1"):
        # one query lane: the plan fills the card as far as whole 64-key
        # tiles allow (slot decode's 256 lanes hold 4: 4 x 32 = 128 CTAs)
        most = sum(max(1, -(-(hi - lo) // split.TILE_KEYS))
                   for lo, hi in ranges) * ctas
        assert pl.ctas(ctas) >= min(H100_SMS, most)
        if most < H100_SMS:
            assert pl.tiles_per_piece == 1
    if not splits:
        assert pl.ctas(ctas) == len(ranges) * ctas


def test_plan_splits_a_skewed_range():
    """A grid that fills the card still splits where one query tile's
    range is several times the mean, into pieces that no longer set the
    launch's length; an even grid that fills the card is left whole."""
    ranges = [(0, 64)] * 40 + [(0, 64 * 400)]
    tiles = [1] * 40 + [400]
    pl = split.plan(ranges, 8, H100_SMS)
    assert pl.split and pl.pieces[-1] > 1
    assert pl.tiles_per_piece <= 400 // split.SKEW
    assert split.makespan(tiles, pl.tiles_per_piece, 8, H100_SMS) < \
        split.makespan(tiles, 400, 8, H100_SMS) / 4
    assert split.plan([(0, 64 * 4)] * 40, 8, H100_SMS).split is False


def test_header_tile_matches_the_planner():
    """The kernel's tile and piece arithmetic is the planner's."""
    text = (build.CSRC / "attention_mma.cuh").read_text()
    assert f"constexpr int kTK = {split.TILE_KEYS};" in text
    assert "const int n = (thi - tlo + p.C - 1) / p.C;" in text
    assert "return n > 1 ? n : 1;" in text
    assert "thi = hi > lo ? (hi + kTK - 1) / kTK : tlo;" in text


# ------------------------------------------------------ combine, plain side


def _pieces(lo, hi, c):
    return [split.piece_keys(lo, hi, c, j)
            for j in range(split.pieces_of(lo, hi, c))]


def _combine_by_pieces(q, k, v, visible, ranges, tq, c):
    """Attention over the pieces of each query tile, merged by the plain
    combine: q (..., Sq, hd), k/v (..., Sk, hd), visible (..., Sq, Sk)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = torch.zeros(q.shape, dtype=torch.float32)
    for i, (lo, hi) in enumerate(ranges):
        rows = slice(i * tq, (i + 1) * tq)
        parts = []
        for a, b in _pieces(lo, hi, c):
            b = max(a, b)               # an empty range's one piece
            parts.append(ref.attention_partial_ref(
                q[..., rows, :], k[..., a:b, :], v[..., a:b, :],
                visible[..., rows, a:b], scale))
        m, l, acc = (torch.stack(t) for t in zip(*parts))
        out[..., rows, :] = ref.attention_combine_ref(m, l, acc)
    return out


FLASH_CASES = [
    # (B, H, KV, Sq, Sk, hd, causal, window)
    (1, 4, 2, 200, 200, 32, True, 0),
    (2, 4, 4, 130, 130, 16, True, 48),       # window inside the range
    (1, 8, 2, 70, 300, 32, False, 0),        # non-causal, Sq != Sk
    (1, 4, 1, 190, 50, 16, False, 20),       # rows past Sk + 19 see nothing
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("tiles_per_piece", [1, 2])
def test_combine_over_pieces_matches_flash_reference(case, tiles_per_piece):
    b, h, kv, sq, sk, hd, causal, window = case
    g = h // kv
    tq = 64 // g
    rng = np.random.default_rng(sq + sk + hd + window)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for shape in
               ((b, h, sq, hd), (b, kv, sk, hd), (b, kv, sk, hd)))
    qi, kj = np.arange(sq)[:, None], np.arange(sk)[None, :]
    vis = np.ones((sq, sk), bool)
    if causal:
        vis &= kj <= qi
    if window:
        vis &= qi - kj < window
    ranges = split.flash_key_ranges(sq, sk, tq, causal, window)
    # each query tile's range holds every key its queries can see
    for i, (lo, hi) in enumerate(ranges):
        seen = np.nonzero(vis[i * tq:(i + 1) * tq].any(0))[0]
        assert seen.size == 0 or (seen.min() >= lo and seen.max() < hi)
    qt = torch.from_numpy(q).reshape(b, kv, g, sq, hd)
    kt = torch.from_numpy(k)[:, :, None]
    vt = torch.from_numpy(v)[:, :, None]
    # rows (position, group head) of a KV head: the plain side takes the
    # group heads as a batch dim, every tile of tq positions at once
    ours = _combine_by_pieces(qt, kt, vt, torch.from_numpy(vis), ranges, tq,
                              tiles_per_piece).reshape(b, h, sq, hd).numpy()
    oracle = np.asarray(jref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    sees = vis.any(1)
    assert window == 0 or causal or not sees.all()
    np.testing.assert_allclose(ours[:, :, sees], oracle[:, :, sees],
                               atol=ATOL, rtol=ATOL)
    assert np.all(ours[:, :, ~sees] == 0)


PAGED_CASES = [
    # (B, S, H, KV, hd, prefix lanes): a chunk step, fused decode rows,
    # slot decode (L = 256)
    (3, 40, 4, 2, 32, 150),
    (8, 1, 4, 2, 32, 200),
    (4, 1, 8, 4, 16, 255),
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("window", [0, 70])
def test_combine_over_pieces_matches_paged_reference(case, window):
    b, s, h, kv, hd, prefix = case
    g = h // kv
    tq = min(64 // g, s)
    rng = np.random.default_rng(sum(case) + window)
    q, k, v, kpos, qpos = prefill_case(rng, b, s, h, kv, hd, prefix)
    kpos[-1] = -1               # a padding row: none of its lanes sees a key
    L = k.shape[1]
    pl = split.plan(split.paged_key_ranges(s, L, tq), b * kv, H100_SMS)
    if s == 1:
        assert pl.split
    kp, qp = kpos[:, None, :], qpos[:, :, None]
    vis = (kp >= 0) & (kp <= qp)
    if window:
        vis &= qp - kp < window                                 # (B,S,L)
    # plain side: (B, KV, g, S, hd) queries against (B, KV, 1, L, hd) keys
    qt = torch.from_numpy(q).reshape(b, s, kv, g, hd).permute(0, 2, 3, 1, 4)
    kt = torch.from_numpy(k).permute(0, 2, 1, 3)[:, :, None]
    vt = torch.from_numpy(v).permute(0, 2, 1, 3)[:, :, None]
    vist = torch.from_numpy(vis)[:, None, None]
    ours = _combine_by_pieces(qt, kt, vt, vist,
                              split.paged_key_ranges(s, L, tq), tq,
                              pl.tiles_per_piece)
    ours = ours.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).numpy()
    oracle = np.asarray(jref.paged_prefill_ref(
        *(jnp.asarray(a) for a in (q, k, v, kpos, qpos)), window=window))
    lanes = vis.any(-1)                                         # (B,S)
    assert lanes[:-1].all() and not lanes[-1].any()
    np.testing.assert_allclose(ours[lanes], oracle[lanes], atol=ATOL,
                               rtol=ATOL)
    assert np.all(ours[~lanes] == 0)


# ------------------------------------------------ the bf16 probabilities


# the card's flash cases (tests/test_torch_kernels.py FA_CARD_CASES, bf16)
P_CASES = (
    [(shape, causal, window)
     for shape in [(1, 4, 4, 64, 64, 64), (2, 8, 2, 96, 96, 64),
                   (1, 8, 1, 128, 128, 128), (2, 4, 4, 33, 75, 64)]
     for causal, window in [(True, 0), (True, 16), (False, 0)]]
    + [((1, 16, 8, s, s, 128), True, window)
       for s in (1, 37, 100, 200, 512) for window in (0, 64)]
    + [((1, 16, 8, 37, 100, 128), False, 0)])


def _p_rounding_excess(mode):
    """(elements over flash's bf16 limit, worst error / allowance) of the
    tile's arithmetic with P fed to P.V as ``mode``: "once" (bf16), "once,
    l rounded" (the denominator summed from the rounded P too) or "hi+lo"
    (two bf16 terms), against the plain version's float32 probabilities,
    both outputs rounded to bf16 once."""
    over, worst = 0, 0.0
    for i, ((b, h, kv, sq, sk, hd), causal, window) in enumerate(P_CASES):
        sk = sq if causal else sk
        for seed in range(3):
            rng = np.random.default_rng(10 * i + seed)
            q, k, v = (torch.from_numpy(rng.normal(size=(b, n, s, hd))
                                        .astype(np.float32)).bfloat16()
                       for n, s in ((h, sq), (kv, sk), (kv, sk)))
            plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window).float()
            g = h // kv
            sc = torch.einsum("bkgqd,bksd->bkgqs",
                              q.float().reshape(b, kv, g, sq, hd),
                              k.float()) / math.sqrt(hd)
            qi, kj = torch.arange(sq)[:, None], torch.arange(sk)[None, :]
            vis = torch.ones(sq, sk, dtype=torch.bool)
            if causal:
                vis &= kj <= qi
            if window:
                vis &= qi - kj < window
            sc = torch.where(vis, sc, ref.NEG_INF)
            p = torch.where(vis, torch.exp(sc - sc.amax(-1, keepdim=True)),
                            0.0)
            l = p.sum(-1, keepdim=True)
            hi = p.bfloat16().float()
            if mode == "hi+lo":
                pq = hi + (p - hi).bfloat16().float()
            else:
                pq = hi
                if mode == "once, l rounded":
                    l = hi.sum(-1, keepdim=True)
            out = (torch.einsum("bkgqs,bksd->bkgqd", pq, v.float()) / l)
            out = out.reshape(b, h, sq, hd).bfloat16().float()
            allowed = 2e-3 + 2 ** -7 * plain.abs()
            ratio = (out - plain).abs() / allowed
            over += int((ratio > 1).sum())
            worst = max(worst, float(ratio.max()))
    return over, worst


@pytest.mark.parametrize("mode,fits", [("once", False),
                                       ("once, l rounded", False),
                                       ("hi+lo", True)])
def test_bf16_probabilities_need_a_hi_lo_pair(mode, fits):
    """Why the bf16 flash kernel feeds P to the tensor cores as a bf16 hi
    + lo pair: over the card's flash cases (3 seeds each), P rounded once
    puts elements past the bf16 limit (atol 2e-3, rtol 2**-7) against the
    plain version's float32 probabilities (35, worst 1.37x the allowance,
    when this was written), with or without the denominator summed from
    the rounded P; the pair keeps every element inside (worst 0.78x)."""
    over, worst = _p_rounding_excess(mode)
    assert (over == 0) == fits, (over, worst)


@pytest.mark.parametrize("kernel", ["flash_attention", "paged_prefill"])
def test_bf16_sources_compile_the_planners_head_dims(kernel):
    """The head dims each bf16 source instantiates the tile at are the
    wrappers' ``MMA_HEAD_DIMS`` (the compiler is not here to check it),
    and from head_dim 256 on Q stays in shared memory, in a third tile
    beside K and V: 102,144 bytes, two CTAs to an SM's 228 KB."""
    import re

    text = "".join(p.read_text() for p in (build.CSRC / f"{kernel}.cu",
                                          build.CSRC / f"{kernel}.cuh")
                   if p.exists())
    cases = re.findall(r"case (\d+): return launch_mma<\1,", text)
    assert tuple(map(int, cases)) == split.MMA_HEAD_DIMS
    tile = (build.CSRC / "attention_mma.cuh").read_text()
    assert "constexpr bool q_in_smem(int hd) { return hd > 128; }" in tile
    pitch, rows, ints = 256 + 8, 64, (64 + 2 * 64) * 4
    assert 3 * rows * pitch * 2 + ints == 102_144
    assert 2 * (102_144 + 1024) <= 233_472        # the SM's 228 KB


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_float32_tile_fits_at_head_dim_256(g):
    """The float32 CUDA-core tile's shared memory (``attention_tile.cuh``
    ``tile_smem_bytes``: q, k padded to hd + 1, v, scores, acc, row
    state, positions) at head_dim 256 and the query tile the wrappers
    pick (``ROWS_PER_CTA // g`` lanes) fits what a CTA may use, so no
    group needs a smaller tile."""
    text = (build.CSRC / "attention_tile.cuh").read_text()
    assert ("size_t floats = (size_t)R * hd + (size_t)TK * (hd + 1) + "
            "(size_t)TK * hd +") in text
    hd, tk = 256, 32
    for mod in (fa_mod, pp_mod):
        rows = (mod.ROWS_PER_CTA // g) * g
        floats = rows * hd + tk * (hd + 1) + tk * hd + rows * tk \
            + rows * hd + 3 * rows
        assert floats * 4 + (tk + rows) * 4 <= fa_mod.MAX_SMEM
    if g == 2:                                    # gemma3-4b's group
        assert floats * 4 + (tk + rows) * 4 == 206_080
