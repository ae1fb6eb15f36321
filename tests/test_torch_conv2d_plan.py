"""The conv2d kernel's launch plan, on the CPU.

``kernels/conv2d.py:plan`` decides, from the shapes and the SM count, the
work items the persistent CTAs of ``csrc/conv2d.cu`` walk (bands of
output rows of one image) and the shared memory of their ring; the
launcher only validates it.  These tests hold the plan for the paper's
shape at the batches the digit path and evaluation launch (and a larger
one), and for every shape of ``chip_smoke.py``'s parity sweep, in both
dtypes, on an H100's 132 SMs: each (image, output row) is written by
exactly one item, the ring fits one CTA's shared memory, and the serving
batches make at least as many items as the previous design's grid had
CTAs.
"""
import collections
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import conv2d as cv  # noqa: E402

SMS = 132                                   # an H100 SXM
PAPER = (28, 28, 1, 3, 32)                  # H, W, Cin, K, Cout


def _smoke_shapes():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return list(mod.CONV_SHAPES)


SHAPES = sorted(set(_smoke_shapes() + [(b, *PAPER)
                                       for b in (1, 32, 1000, 2000, 5000)]))
DTYPES = [torch.float32, torch.bfloat16]


def _plan(shape, dtype, sms=SMS):
    b, h, w, cin, k, cout = shape
    return cv.launch_plan((b, h, w, cin), (k, k, cin, cout), dtype, sms)


def _grid_before(b, h, w, cin, k, cout, sms=SMS):
    """CTAs of the previous design's grid (one per band of rows and
    image, bands sized for two CTAs an SM)."""
    ho = h - k + 1
    fill = -(-2 * sms // b)
    r = -(-ho // fill)
    fit = (48 * 1024) // (w * cin * 4) - (k - 1)
    r = max(1, min(r, fit))
    return -(-ho // r) * min(b, 65535)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_items_cover_every_row_once(shape, dtype):
    b, h, w, cin, k, cout = shape
    ho = h - k + 1
    pl = _plan(shape, dtype)
    assert pl.items == b * pl.bands
    assert pl.bands == -(-ho // pl.band_rows)
    assert 1 <= pl.ctas <= min(pl.items, cv.CTAS_PER_SM * SMS)
    seen = collections.Counter()
    for cta in range(pl.ctas):
        for item in pl.cta_items(cta):
            seen.update(cv.item_cells(pl, ho, item))
    assert set(seen) == {(i, y) for i in range(b) for y in range(ho)}
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ring_fits_shared_memory(shape, dtype):
    b, h, w, cin, k, cout = shape
    es = dtype.itemsize
    pl = _plan(shape, dtype)
    assert pl.smem_bytes <= cv.MAX_SMEM
    assert pl.smem_bytes == cv.smem_bytes(k, k, cin, cout, pl.stages,
                                          pl.slot)
    assert pl.stages == cv.STAGES and pl.stages * 8 <= cv.BAR_BYTES
    # a slot holds its window at any element offset within a 16-byte
    # chunk, in whole chunks
    elems = (pl.band_rows + k - 1) * w * cin
    assert pl.slot % 16 == 0 and pl.slot >= elems * es + 16 - es
    assert pl.threads % 32 == 0 and 32 <= pl.threads <= cv.MAX_THREADS


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 32])
def test_serving_batches_reach_as_many_sms_as_before(b, dtype):
    pl = _plan((b, *PAPER), dtype)
    assert pl.items >= _grid_before(b, *PAPER)
    # one item a CTA: nothing waits behind a CTA's first item
    assert pl.ctas == pl.items <= cv.CTAS_PER_SM * SMS


def test_evaluations_batches_take_whole_images():
    for b in (1000, 2000):
        pl = _plan((b, *PAPER), torch.float32)
        assert (pl.band_rows, pl.items) == (26, b)
        assert pl.ctas == cv.CTAS_PER_SM * SMS


@pytest.mark.parametrize("b", [1, 32, 130, 2000, 5000])
def test_band_height_is_the_models_best(b):
    ctas_max = cv.CTAS_PER_SM * SMS
    pl = _plan((b, *PAPER), torch.float32)
    best = min(cv.makespan(b, 26, r, ctas_max) for r in range(1, 27))
    assert cv.makespan(b, 26, pl.band_rows, ctas_max) == best


def test_a_filter_past_shared_memory_is_refused():
    with pytest.raises(ValueError, match="shared memory"):
        cv.launch_plan((1, 8, 8, 64), (3, 3, 64, 128), torch.float32, SMS)
