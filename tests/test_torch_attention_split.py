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
# prompt, the 512-token smoke prompt, a long one: the flash tile's
# makespan constants leave all three whole), a paged chunk step (4
# rows of 256 lanes over a 512-lane prefix), the fused decode dispatch (8
# rows of one lane, 512 prefix lanes) and slot decode (4 slots of 256
# lanes); tq = 64 / g = 32 query positions a tile, 1 when S = 1
PATH_SHAPES = [
    ("flash S=37", split.flash_key_ranges(37, 37, 32, True, 0),
     fa_mod.plan(1, 16, 8, 37, 37, True, 0, H100_SMS), 8, False),
    ("flash S=512", split.flash_key_ranges(512, 512, 32, True, 0),
     fa_mod.plan(1, 16, 8, 512, 512, True, 0, H100_SMS), 8, False),
    ("flash S=2048", split.flash_key_ranges(2048, 2048, 32, True, 0),
     fa_mod.plan(1, 16, 8, 2048, 2048, True, 0, H100_SMS), 8, False),
    ("paged 4x256", split.paged_key_ranges(256, 768, 32),
     pp_mod.plan(4, 256, 768, 16, 8, H100_SMS), 32, False),
    ("paged 8x1", split.paged_key_ranges(1, 513, 1),
     pp_mod.plan(8, 1, 513, 16, 8, H100_SMS), 64, True),
    ("slot decode 4x1", split.paged_key_ranges(1, 256, 1),
     pp_mod.plan(4, 1, 256, 16, 8, H100_SMS), 32, True),
    # whisper-tiny's encoder (6/6 heads, 1,500 frames, non-causal: 24
    # query tiles x 6 heads = 144 CTAs, a lone second wave of 12 unsplit),
    # its cross-attention at a decode step of 8 rows and at a 200-token
    # prompt, and paligemma-3b's prefix-LM (8/1 heads, 256 patches)
    ("flash encoder", split.flash_key_ranges(1500, 1500, 64, False, 0),
     fa_mod.plan(1, 6, 6, 1500, 1500, False, 0, H100_SMS), 6, True),
    ("flash cross 8x1", split.flash_key_ranges(1, 1500, 1, False, 0),
     fa_mod.plan(8, 6, 6, 1, 1500, False, 0, H100_SMS), 48, True),
    ("flash cross prefill", split.flash_key_ranges(200, 1500, 64, False, 0),
     fa_mod.plan(1, 6, 6, 200, 1500, False, 0, H100_SMS), 6, True),
    ("flash prefix 256", split.flash_key_ranges(456, 456, 8, True, 0, 256),
     fa_mod.plan(1, 8, 1, 456, 456, True, 0, H100_SMS, 256), 1, False),
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


@pytest.mark.parametrize("header", ["attention_wgmma.cuh",
                                    "attention_mma.cuh",
                                    "attention_paged_wgmma.cuh"])
def test_header_tile_matches_the_planner(header):
    """Each bf16 tile's key tile and piece arithmetic is the planner's:
    the flash tile's (``attention_wgmma.cuh``), the ragged prefill's
    decode tile's (``attention_mma.cuh``), and its Hopper tile's, which
    walks 64-key tiles (``wg::kTK``) of the decode tile's pieces
    (``mma::key_range``, ``pieces_of``, ``locate``), so both tiles share
    one plan layout and one combine pass."""
    text = (build.CSRC / header).read_text()
    if header == "attention_paged_wgmma.cuh":
        assert '#include "attention_mma.cuh"' in text
        assert '#include "attention_wgmma.cuh"' in text
        for call in ("mma::locate(p, x, qt, piece, npieces);",
                     "mma::key_range(p, qt, klo, khi);",
                     "mma::pieces_of(p, qt, tlo, thi);",
                     "const int ta = tlo + piece * p.C, tb = min(ta + p.C, "
                     "thi);"):
            assert call in text
        text = (build.CSRC / "attention_wgmma.cuh").read_text()
    assert f"constexpr int kTK = {split.TILE_KEYS};" in text
    assert "const int n = (thi - tlo + p.C - 1) / p.C;" in text
    assert "return n > 1 ? n : 1;" in text
    assert "thi = hi > lo ? (hi + kTK - 1) / kTK : tlo;" in text


# the paged Hopper tile's makespan constants (fixed, combine, CTAs an SM),
# fit to an H100's forced-piece sweep (PERF.md); the decode tile keeps the
# defaults
PAGED_CONSTANTS = (6.0, 1.0, 1.75)


def test_paged_tile_planner_constants_are_pinned():
    assert (split.PAGED_FIXED_TILES, split.PAGED_COMBINE_TILES,
            split.PAGED_CTAS_PER_SM) == PAGED_CONSTANTS
    assert (split.FIXED_TILES, split.COMBINE_TILES,
            split.CTAS_PER_SM) == (2.0, 2.5, 1.25)


# (S, H, KV): the query rows a CTA of each tile serves
TILE_SHAPES = [((1, 16, 8), True), ((1, 64, 8), True), ((8, 16, 8), True),
               ((9, 16, 8), False), ((16, 16, 8), False),
               ((256, 16, 8), False), ((16, 8, 8), True),
               ((17, 8, 8), False), ((3, 48, 8), False),
               ((2, 8, 1), True), ((3, 8, 1), False)]


@pytest.mark.parametrize("shape,warp_keys", TILE_SHAPES,
                         ids=[str(s) for s, _ in TILE_SHAPES])
def test_tile_choice_matches_the_launcher(shape, warp_keys):
    """A launch of more than 16 query rows a CTA (``tq * g``) runs the
    Hopper tile and is planned with its constants; up to 16 run the
    kWarpKeys tile under the defaults, as ``paged_prefill.cuh``'s
    ``warp_keys_tile`` dispatches."""
    s, h, kv = shape
    text = (build.CSRC / "paged_prefill.cuh").read_text()
    assert (f"constexpr int kWarpKeysRows = {pp_mod.WARP_KEYS_ROWS};"
            in text)
    assert "return TQ * g <= kWarpKeysRows; }" in text
    assert ("return warp_keys_tile(TQ, p.g) ? launch_mma_hd<kQuant>(hd, p, "
            "s)") in text
    assert pp_mod.warp_keys_tile(s, h, kv) == warp_keys
    for b, l in ((8, 513), (2, 1600), (132, 64)):
        ranges = split.paged_key_ranges(s, l, min(64 // (h // kv), s))
        kw = {} if warp_keys else dict(
            fixed=split.PAGED_FIXED_TILES, combine=split.PAGED_COMBINE_TILES,
            ctas_per_sm=split.PAGED_CTAS_PER_SM)
        assert pp_mod.plan(b, s, l, h, kv, H100_SMS) == split.plan(
            ranges, b * kv, H100_SMS, **kw)


def test_flash_plan_leaves_no_lone_wave():
    """The flash planner counts waves: whisper's encoder, 144 CTAs on 132
    SMs unsplit (a second wave of 12), is cut into pieces whose modelled
    launch beats the whole ranges', and its grid holds more CTAs than one
    a SM; a grid of whole waves (here exactly two) is left whole, as is
    one with no wave to fill (S=2048's 512 CTAs spread over their
    skew)."""
    kw = dict(fixed=split.FLASH_FIXED_TILES,
              combine=split.FLASH_COMBINE_TILES,
              ctas_per_sm=split.FLASH_CTAS_PER_SM, waves=True)
    ranges = split.flash_key_ranges(1500, 1500, 64, False, 0)
    tiles = [split.tile_span(*r)[1] - split.tile_span(*r)[0]
             for r in ranges]
    pl = fa_mod.plan(1, 6, 6, 1500, 1500, False, 0, H100_SMS)
    assert pl.split
    assert pl.ctas(6) > 2 * H100_SMS
    assert split.makespan(tiles, pl.tiles_per_piece, 6, H100_SMS, **kw) < \
        split.makespan(tiles, max(tiles), 6, H100_SMS, **kw)
    # 22 query tiles x 12 heads = 264 CTAs: two whole waves
    assert not split.plan([(0, 1500)] * 22, 12, H100_SMS, **kw).split
    # without waves counted (the ragged prefill's model) the encoder
    # stays whole, as before
    assert not split.plan(ranges, 6, H100_SMS).split


# (B, S, L, H, KV) -> (tiles a piece, pieces of each query tile) of the
# ragged prefill, and (B, KV, nb) -> (blocks a piece, pieces) of the paged
# decode, on an H100's 132 SMs, as the planners gave them before the flash
# tile had constants of its own; the entries of more than 16 query rows a
# CTA (S > 1 here) under the Hopper tile's constants
PP_PLANS = [((4, 256, 768, 16, 8), (12, (1,) * 8)),
            ((8, 1, 513, 16, 8), (3, (3,))),
            ((4, 1, 256, 16, 8), (1, (4,))),
            ((16, 16, 272, 16, 8), (3, (2,))),
            ((8, 1, 216, 6, 6), (1, (4,))),
            ((8, 1, 472, 8, 1), (1, (8,))),
            ((4, 256, 768, 8, 4), (6, (2,) * 8)),
            ((2, 64, 1600, 8, 4), (2, (13, 13))),
            ((8, 1, 513, 24, 8), (3, (3,))),
            ((8, 1, 513, 64, 8), (3, (3,))),
            ((1, 200, 200, 16, 8), (1, (4,) * 7)),
            ((24, 1, 513, 16, 8), (9, (1,)))]
PA_PLANS = [((8, 8, 32), (11, 3)), ((8, 8, 16), (6, 3)),
            ((24, 8, 16), (16, 1)), ((1, 8, 128), (16, 8)),
            ((4, 1, 30), (4, 8)), ((8, 4, 129), (22, 6)),
            ((132, 1, 64), (64, 1)), ((2, 2, 200), (25, 8))]


@pytest.mark.parametrize("shape,want", PP_PLANS,
                         ids=[str(s) for s, _ in PP_PLANS])
def test_paged_prefill_plans_are_unchanged(shape, want):
    pl = pp_mod.plan(*shape, H100_SMS)
    assert (pl.tiles_per_piece, pl.pieces) == want


@pytest.mark.parametrize("shape,want", PA_PLANS,
                         ids=[str(s) for s, _ in PA_PLANS])
def test_paged_attention_plans_are_unchanged(shape, want):
    from repro_torch.kernels import paged_attention as pa_mod

    pl = pa_mod.plan(*shape, H100_SMS)
    assert (pl.blocks_per_piece, pl.n_pieces) == want


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
    """The head dims each bf16 source instantiates its tiles at are the
    wrappers' ``MMA_HEAD_DIMS`` (the compiler is not here to check it).
    The flash tile (``attention_wgmma.cuh``) keeps Q, then a ring of K
    and V slots (four up to head_dim 64, two at 128, one at 256) and its
    mbarriers: at most 99,368 bytes, as many CTAs to an SM's 228 KB as
    its launch bounds ask (three up to head_dim 64, two above).  The
    ragged prefill instantiates both its tiles, bf16 and int8: the
    Hopper tile (``attention_paged_wgmma.cuh``) keeps the same Q and
    ring, each slot with its positions, scales and tile index beside it,
    two CTAs to an SM at every head dim (at most 100,144 bytes, at 256);
    the kWarpKeys mma.sync tile keeps Q in shared memory from head_dim
    256 on, a third tile beside K and V: 102,144 bytes, two CTAs to an
    SM."""
    import re

    text = "".join(p.read_text() for p in (build.CSRC / f"{kernel}.cu",
                                          build.CSRC / f"{kernel}.cuh")
                   if p.exists())
    if kernel == "flash_attention":
        cases = re.findall(r"case (\d+): return launch_wgmma<\1,", text)
        assert tuple(map(int, cases)) == split.MMA_HEAD_DIMS
        tile = (build.CSRC / "attention_wgmma.cuh").read_text()
        assert "return hd >= 256 ? 1 : hd >= 128 ? 2 : 4;" in tile
        assert "return hd <= 64 ? 3 : 2;" in tile
        assert "__launch_bounds__(wg::kThreads, wg::min_blocks(HD))" in text
        for hd in split.MMA_HEAD_DIMS:
            stages = 1 if hd >= 256 else 2 if hd >= 128 else 4
            ctas = 3 if hd <= 64 else 2
            smem = (1 + 2 * stages) * 64 * hd * 2 + (1 + 4 * stages) * 8 \
                + 1024
            assert smem <= 99_368
            assert ctas * (smem + 1024) <= 233_472   # the SM's 228 KB
        return
    for tile in ("mma", "wgmma"):
        cases = re.findall(rf"case (\d+): return launch_{tile}<\1, kQuant>",
                           text)
        assert tuple(map(int, cases)) == split.MMA_HEAD_DIMS
    for launch in ("launch_mma_hd", "launch_wgmma_hd"):
        assert f"{launch}<kQuant>(hd, p, s)" in text
    paged = (build.CSRC / "attention_paged_wgmma.cuh").read_text()
    assert "constexpr int kPagedMinBlocks = 2;" in paged
    assert "__launch_bounds__(wg::kThreads, wg::kPagedMinBlocks)" in text
    aux = 3 * 64 * 4 + 2 * 4          # PagedAux: positions, scales, tile
    most = 0
    for hd in split.MMA_HEAD_DIMS:
        stages = 1 if hd >= 256 else 2 if hd >= 128 else 4
        smem = (1 + 2 * stages) * 64 * hd * 2 + stages * aux \
            + (1 + 4 * stages) * 8 + 1024
        assert 2 * (smem + 1024) <= 233_472          # two CTAs an SM
        most = max(most, smem)
    assert most == 100_144
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


def test_paged_planner_fit_recovers_the_model_constants():
    """``conv2d_compare.fit_paged_planner`` (how ``PAGED_CONSTANTS`` are
    read off the card), fed a forced-piece sweep that the makespan model
    itself times at known constants (each shape its own tile time and
    base), ranks those constants first: their plans are the fastest
    forced ones (regret 1) and they leave no residual."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "conv2d_compare.py"
    spec = importlib.util.spec_from_file_location("conv2d_compare", path)
    cmp_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cmp_mod)
    truth = (1.5, 4.0, 1.5)
    sweep = {}
    for i, shape in enumerate([(4, 256, 768, 16, 8), (16, 16, 272, 16, 8),
                               (4, 256, 768, 8, 4), (2, 64, 1600, 8, 4),
                               (1, 64, 2112, 16, 8)]):
        b, s, l, h, kv = shape
        rs = split.paged_key_ranges(s, l, min(64 // (h // kv), s))
        tiles = [split.tile_span(*r)[1] - split.tile_span(*r)[0] for r in rs]
        for c in cmp_mod.plan_candidates(max(tiles)):
            model = split.makespan(tiles, c, b * kv, H100_SMS,
                                   fixed=truth[0], combine=truth[1],
                                   ctas_per_sm=truth[2])
            sweep[f"s{i}", shape, c] = 0.002 * (i + 1) + 0.0007 * model
    regret, residual, *constants = cmp_mod.fit_paged_planner(sweep, split)[0]
    assert tuple(constants) == truth
    assert regret == 1.0 and residual < 1e-9
