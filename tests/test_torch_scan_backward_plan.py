"""The WKV6 backward kernel's scratch, on the CPU.

``rwkv6_scan_bwd.scratch_sizes`` sizes what the wrapper allocates for a
launch: one state and one adjoint checkpoint at each boundary between
chunks of 16 steps (two float4 a thread of 256, a span of 32 value
columns), du's partials a (row, chunk) and one ticket a head.  Each is
held to a direct count: the columns and steps walked one by one.  The
wrapper refuses CPU tensors (they take the plain version).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rwkv6_scan_bwd as rwb  # noqa: E402

SHAPES = [(1, 1, 1, 1), (8, 32, 128, 64), (1, 32, 300, 64), (2, 3, 16, 48),
          (2, 3, 17, 32), (3, 5, 15, 40), (4, 2, 33, 6), (2, 4, 2048, 16)]


def direct(b, h, s, hd):
    """The scratch by enumeration: a span per run of 32 columns, a chunk
    per run of 16 steps, a checkpoint where a step starts a chunk other
    than the first."""
    spans = len({j // 32 for j in range(hd)})
    chunks = len({t // 16 for t in range(s)})
    bounds = sum(1 for t in range(1, s) if t % 16 == 0)
    threads = 32 * 8          # 2 state rows of 4 columns a thread
    ckpt = max(1, b * h * bounds * spans * threads * 2 * 4)
    return {"ck_s": ckpt, "ck_g": ckpt, "du_part": b * chunks * h * hd,
            "tickets": h}


@pytest.mark.parametrize("b,h,s,hd", SHAPES)
def test_plan_matches_a_direct_count(b, h, s, hd):
    assert rwb.scratch_sizes(b, h, s, hd) == direct(b, h, s, hd)


def test_plan_of_the_training_shape():
    """rwkv6-1.6b's 8 x 128 (32 heads of 64): 7 boundaries of 4.2 MB of
    state each (29.4 MB) for the state and again for the adjoint, 8
    chunks of du partials."""
    sz = rwb.scratch_sizes(8, 32, 128, 64)
    assert sz["ck_s"] * 4 == sz["ck_g"] * 4 == 7 * 8 * 32 * 64 * 64 * 4
    assert sz["du_part"] == 8 * 8 * 32 * 64 and sz["tickets"] == 32


@pytest.mark.parametrize("hd", [8, 80])
def test_wrapper_refuses_cpu_tensors(hd):
    r = torch.zeros(1, 1, 4, hd)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rwb.rwkv6_scan_bwd(r, r, r, r, torch.zeros(1, hd), None, r)
