"""The filter-gradient kernel ``conv2d_wgrad``: its launch plan on the CPU,
the kernel and the training path on the card.

On the CPU (no JAX needed; the plain version is held against the
reference in ``tests/test_torch_train.py``): ``kernels/conv2d_wgrad.py:
plan`` over every shape of ``chip_smoke.py``'s conv sweep and the paper's
shape at the batches training and evaluation use, on an H100's 132 SMs:
the CTAs cover every (image, output row) pair once, in chunks of a
slot's worth whose input rows fit the slot (also across an image),
their groups of consumer threads take every pair of the CTA once,
clusters divide the CTAs and hold at most 8, and the ring and the
reductions fit one CTA's shared memory, padded so that no more CTAs
share an SM than planned; the copy windows of bfloat16 rows (56 bytes
at the paper's shape) are covered exactly by 16-byte aligned bulk
copies and element copies; the plan's
summation order (groups, CTA, cluster ranks, the final runs), replayed
in plain float32 on the CPU, meets the card's tolerance against
``conv2d_wgrad_ref``; shapes past the kernel's limits are refused.
``ops.conv2d_wgrad`` takes the plain version for CPU tensors and the
wrapper refuses them.

On the card (tests marked ``cuda``, skipped elsewhere; no JAX, so they
run with ``--noconftest``):

* the kernel against ``conv2d_wgrad_ref`` over the sweep plus B=64, 320,
  2,000 and 5,000 at the paper's shape, dy N(0, 1).  Both sum in float32
  in other orders over up to B*H'*W' (3.4 million) products, so the
  rounding scales with the largest value: float32 within ``1e-5 *
  max|plain| + 1e-5 * |plain|``; bfloat16 (both round the float32 sum
  once) within that absolute part plus one bfloat16 ulp, ``rtol=2**-7``;
* one call is one kernel on the card, and nothing else (a profiler
  trace): no second pass and no memset;
* a second launch on the same inputs, and replays of a CUDA graph, give
  the same bits (no float atomics; the ticket counter is left at 0);
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
                                       for b in (1, 64, 320, 2000, 5000)]))


def _x_row(q, ho, k):
    """A pair's first input row over the whole batch."""
    img, y = divmod(q, ho)
    return img * (ho + k - 1) + y


def _plan(shape, sms=SMS, esize=4):
    b, h, w, cin, k, cout = shape
    return cw.launch_plan((b, h, w, cin), k, k, cout, sms, esize)


@pytest.mark.parametrize("sms", [SMS, 1], ids=["h100", "one_sm"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_partials_cover_every_pair_once(shape, sms):
    b, h, w, cin, k, cout = shape
    ho = h - k + 1
    pl = _plan(shape, sms)
    assert pl.rows == b * ho and pl.ho == ho
    assert 1 <= pl.cluster <= cw.MAX_CLUSTER and pl.ctas % pl.cluster == 0
    assert pl.ctas <= pl.rows
    assert pl.ctas <= max(cw.CTAS_PER_SM * sms, pl.cluster)
    seen = collections.Counter()
    for cta in range(pl.ctas):
        rows = pl.cta_rows(cta)
        assert len(rows) >= 1
        seen.update(rows)
        # the chunks walk the range in order, a slot's worth each but the
        # last; their input rows fit the slot, also across an image
        chunks = pl.chunks(cta)
        assert [q for q0, n in chunks for q in range(q0, q0 + n)] == \
            list(rows)
        assert all(n == pl.slot_pairs for _, n in chunks[:-1])
        for q0, n in chunks:
            assert 1 <= n <= pl.slot_pairs
            span = _x_row(q0 + n - 1, ho, k) - _x_row(q0, ho, k) + k
            assert span <= cw.x_rows(pl.slot_pairs, ho, k)
        # the groups take every pair of the CTA once
        got = sorted(q for g in range(pl.groups)
                     for q in pl.group_rows(cta, g))
        assert got == list(rows)
    assert set(seen) == set(range(pl.rows)) and set(seen.values()) == {1}
    # every output merged and stored by one rank; every cluster partial in
    # one run of the final sum
    outs = [o for r in range(pl.cluster) for o in pl.rank_outputs(r)]
    assert outs == list(range(pl.nout))
    runs = sorted(c for s in range(pl.slices) for c in pl.slice_clusters(s))
    assert runs == list(range(pl.clusters))


@pytest.mark.parametrize("esize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_threads_hold_every_output_and_pairs_fit(shape, esize):
    b, h, w, cin, k, cout = shape
    pl = _plan(shape, esize=esize)
    nout = k * k * cin * cout
    assert pl.nout == nout
    assert pl.threads == 32 * (pl.warps + 1) <= cw.MAX_THREADS
    if pl.fixed:
        assert (k, cin, cout) == (3, 1, 32) and pl.per == cw.FIXED_TAPS
        assert pl.per * 32 == nout            # a lane: one channel's taps
    else:
        assert 32 * pl.warps * pl.per >= nout and 1 <= pl.per <= cw.MAX_PER
        assert 32 * pl.warps * (pl.per - 1) < nout    # no idle pass
    assert 1 <= pl.stages <= cw.MAX_STAGES
    assert 1 <= pl.slot_pairs <= max(cw.SLOT_PAIRS, pl.warps)
    if pl.fixed:                              # warp w: pairs w, w + warps..
        assert pl.slot_pairs % pl.warps == 0
    # no more slots than the CTA's chunks, no larger a slot than it needs
    per_cta = max(len(pl.cta_rows(c)) for c in range(pl.ctas))
    assert pl.stages <= -(-per_cta // pl.slot_pairs)
    assert pl.slot_pairs - (pl.warps if pl.fixed else 1) < per_cta
    assert pl.x_slot == cw.slot_bytes(
        cw.x_rows(pl.slot_pairs, h - k + 1, k) * w * cin, esize)
    assert pl.dy_slot == cw.slot_bytes(pl.slot_pairs * (w - k + 1) * cout,
                                       esize)
    assert pl.x_slot % 16 == 0 and pl.dy_slot % 16 == 0
    assert 1 <= pl.slices <= pl.clusters
    total = cw.smem_bytes(nout, pl.fixed, pl.warps, pl.cluster, pl.stages,
                          pl.x_slot, pl.dy_slot, pl.slices)
    assert total <= pl.smem_bytes
    # CTAS_PER_SM CTAs an SM, and not one more
    room = pl.smem_bytes + cw.CTA_RESERVE
    assert cw.CTAS_PER_SM * room <= cw.SM_SMEM < (cw.CTAS_PER_SM + 1) * room
    # the ring, then the warps' partials and the final runs in its place
    inbox = 4 * pl.cluster * -(-nout // pl.cluster)
    region = pl.smem_bytes - cw.HEAD - -(-inbox // 16) * 16
    assert region >= pl.stages * (pl.x_slot + pl.dy_slot)
    assert region >= 4 * nout * pl.slices
    assert region >= (4 * nout * pl.warps if pl.fixed else 0)
    assert pl.smem_bytes <= cw.MAX_SMEM


def test_the_paper_shape_gives_one_output_a_thread():
    # one output channel a lane, its 9 taps in registers; the warps take
    # the pairs in turn; every stage of a CTA's small range in flight at
    # once at the training step's B=64
    pl = _plan((64, *PAPER))
    assert pl.fixed and (pl.warps, pl.per) == (cw.WARPS, 9)
    assert pl.groups == pl.warps and pl.slot_pairs == pl.warps
    assert pl.ctas == cw.CTAS_PER_SM * SMS and pl.cluster == cw.CLUSTER
    per_cta = max(len(pl.cta_rows(c)) for c in range(pl.ctas))
    assert pl.stages * pl.slot_pairs >= per_cta     # all of it in flight
    assert max(len(pl.chunks(c)) for c in range(pl.ctas)) <= pl.stages
    # evaluation's batch streams through a ring of whole slots, at least
    # 32 KB of loads in flight per SM (CTAS_PER_SM CTAs)
    big = _plan((2000, *PAPER))
    assert big.slot_pairs == cw.SLOT_PAIRS and big.stages >= 2
    assert cw.CTAS_PER_SM * big.stages * (big.x_slot + big.dy_slot) >= 32768
    # the final sum: 16-byte loads, a run of 4 outputs for as many threads
    # of the last CTA as there are whole sets of the outputs
    assert cw.final_width(288) == 4
    assert big.slices == big.threads // (288 // 4)


def test_shapes_past_the_kernel_are_refused():
    with pytest.raises(ValueError, match="at most 4096"):
        cw.launch_plan((1, 8, 8, 64), 3, 3, 128, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        cw.launch_plan((1, 4, 30_000, 1), 3, 3, 1, SMS)
    # the largest filter gradient the kernel takes still plans
    assert cw.launch_plan((1, 8, 8, 32), 2, 2, 32, SMS).per == cw.MAX_PER


def _windows(pl, shape, esize, x_base, d_base):
    """Every chunk's (lo, hi, array lo, array hi, slot bytes) of x and of
    dy, addresses as the kernel computes them."""
    b, h, w, cin, k, cout = shape
    ho, wo = h - k + 1, w - k + 1
    x_end = x_base + b * h * w * cin * esize
    d_end = d_base + b * ho * wo * cout * esize
    row = w * cin * esize
    for cta in range(pl.ctas):
        for q, n in pl.chunks(cta):
            lo = x_base + _x_row(q, ho, k) * row
            yield lo, x_base + (_x_row(q + n - 1, ho, k) + k) * row, \
                x_base, x_end, pl.x_slot
            lo = d_base + q * wo * cout * esize
            yield lo, lo + n * wo * cout * esize, d_base, d_end, pl.dy_slot


@pytest.mark.parametrize("offset", [0, 8, 2], ids=["aligned", "8_bytes_in",
                                                   "2_bytes_in"])
@pytest.mark.parametrize("shape", [(5, *PAPER), (64, *PAPER),
                                   (4, 12, 16, 3, 5, 8), (2, 9, 9, 2, 1, 4),
                                   (12, 15, 15, 1, 3, 12)], ids=str)
def test_bf16_rows_get_a_valid_copy_window(shape, offset):
    esize = 2
    pl = _plan(shape, esize=esize)
    base = 1 << 20
    for lo, hi, a_lo, a_hi, room in _windows(pl, shape, esize, base + offset,
                                             base + 4096 * 4096 + offset):
        lead, bulk, elements = cw.copy_window(lo, hi, a_lo, a_hi, esize)
        assert 0 <= lead <= 16 - esize and lead + hi - lo <= room
        covered = set(elements)
        assert all(lo <= a < hi for a in elements)
        if bulk is not None:
            at, src, nbytes = bulk
            assert at % 16 == 0 and src % 16 == 0 and nbytes % 16 == 0
            assert a_lo <= src and src + nbytes <= a_hi     # inside the array
            assert 0 <= at and at + nbytes <= room          # inside the slot
            assert at == src - (lo - lead)                  # at its place
            covered |= {a for a in range(lo, hi, esize)
                        if src <= a < src + nbytes}
            assert not set(elements) & set(range(src, src + nbytes))
        assert covered == set(range(lo, hi, esize))
        if offset == 0 and (hi - lo) % 16 == 0 and lo % 16 == 0:
            assert not elements                    # whole chunks, one copy
    if offset == 0 and shape[1:] == PAPER:
        # a bfloat16 input row of 28 pixels is 56 bytes: a window may start
        # 8 bytes into a chunk, and the copy still needs no element copies
        leads = {cw.copy_window(lo, hi, a, b, esize)[0]
                 for lo, hi, a, b, _ in _windows(pl, shape, esize, base,
                                                 base + 4096 * 4096)}
        assert 8 in leads


def _contributions(x, dy, k):
    """(pairs, KH*KW*Cin*Cout) float32: each (image, output row) pair's
    products summed over its row of pixels."""
    b, _, _, cin = x.shape
    _, ho, wo, cout = dy.shape
    out = torch.empty(b, ho, k, k, cin, cout)
    for i in range(k):
        for j in range(k):
            out[:, :, i, j] = torch.einsum(
                "byxc,byxo->byco", x[:, i:i + ho, j:j + wo, :], dy)
    return out.reshape(b * ho, -1)


def _replay(pl, contrib):
    """The kernel's summation order over per-pair sums, in float32: each
    group over its pairs in order, the CTA over its groups, each cluster
    over its ranks, then the final runs and the runs in order."""
    def ordered(parts):
        acc = torch.zeros(pl.nout)
        for p in parts:
            acc = acc + p
        return acc

    ctas = [ordered(ordered(contrib[q] for q in pl.group_rows(c, g))
                    for g in range(pl.groups)) for c in range(pl.ctas)]
    clusters = [ordered(ctas[cl * pl.cluster:(cl + 1) * pl.cluster])
                for cl in range(pl.clusters)]
    return ordered(ordered(clusters[c] for c in pl.slice_clusters(s))
                   for s in range(pl.slices))


REPLAY_SHAPES = [s for s in SHAPES if s[0] * (s[1] - s[4] + 1) <= 8320]


@pytest.mark.parametrize("sms", [SMS, 1], ids=["h100", "one_sm"])
@pytest.mark.parametrize("shape", REPLAY_SHAPES, ids=str)
def test_the_plans_summation_order_matches_the_reference(shape, sms):
    b, h, w, cin, k, cout = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.random((b, h, w, cin), dtype=np.float32))
    dy = torch.from_numpy(
        rng.standard_normal((b, h - k + 1, w - k + 1, cout),
                            dtype=np.float32))
    pl = _plan(shape, sms)
    got = _replay(pl, _contributions(x, dy, k)).reshape(k, k, cin, cout)
    assert_wgrad_close(got, ref.conv2d_wgrad_ref(x, dy, k, k))


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


CARD_SHAPES = _smoke_shapes() + [(64, *PAPER), (320, *PAPER)]
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
@pytest.mark.parametrize("b", [64, 320, 2000])
def test_conv2d_wgrad_repeat_is_bit_identical(cuda, b, dtype):
    x, dy = wgrad_case((b, *PAPER), cuda, dtype)
    first = ops.conv2d_wgrad(x, dy, 3, 3)
    for _ in range(3):
        again = ops.conv2d_wgrad(x, dy, 3, 3)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, *PAPER), (2000, *PAPER),
                                   (4, 12, 16, 3, 5, 8)], ids=str)
def test_conv2d_wgrad_graph_replays_are_bit_identical(cuda, shape):
    x, dy = wgrad_case(shape, cuda, torch.float32)
    k = shape[4]
    want = ops.conv2d_wgrad(x, dy, k, k)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # the stream's counter, made outside
        ops.conv2d_wgrad(x, dy, k, k)   # the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        out = ops.conv2d_wgrad(x, dy, k, k)
    counter = cw._SCRATCH[(cuda.index or 0, side.cuda_stream)][0]
    for _ in range(4):
        out.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert counter.item() == 0      # left at 0 by the last cluster


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 2000])
def test_conv2d_wgrad_is_one_kernel_a_call(cuda, b):
    from torch.profiler import ProfilerActivity, profile

    x, dy = wgrad_case((b, *PAPER), cuda, torch.float32)
    ops.conv2d_wgrad(x, dy, 3, 3)       # build, load, the stream's counter
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.conv2d_wgrad(x, dy, 3, 3)
        torch.cuda.synchronize()
    device = {e.key: e.count for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0}
    assert len(device) == 1, device
    (name, count), = device.items()
    assert "wgrad_kernel" in name and count == 3, device


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
