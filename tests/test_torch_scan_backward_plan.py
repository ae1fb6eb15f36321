"""The scan backward kernels' scratch, on the CPU.

``rwkv6_scan_bwd.scratch_sizes`` sizes what the wrapper allocates for a
launch: one state and one adjoint checkpoint at each boundary between
chunks of 16 steps (two float4 a thread of 256, a span of 32 value
columns), du's partials a (row, chunk) and one ticket a head.  Each is
held to a direct count: the columns and steps walked one by one.  The
wrapper refuses CPU tensors (they take the plain version).

``ssm_scan_bwd.workspace_floats`` likewise: the dB and dC partials of
each cluster of 2 column blocks (64 channels a block), a (row, step),
and da's partials a row, against a count of channels walked one by one;
and the checkpoints the training forward writes for it
(``ssm_scan.checkpoint_count``), one state a boundary between chunks of
16 steps, against a count of the steps.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import rwkv6_scan_bwd as rwb  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.kernels import ssm_scan_bwd as ssb  # noqa: E402

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


# (rows, S, d_inner): jamba's training shapes, one block, the last
# cluster part-full (4 and 253 blocks, 6 of 3 clusters: 200, 16,192,
# 328), S at and past a chunk
SSM_SHAPES = [(8, 128, 16384), (2, 2048, 16384), (1, 1, 8), (3, 37, 200),
              (2, 45, 328), (2, 16, 16192), (2, 17, 16192), (4, 33, 512)]


def ssm_direct(b, s, di):
    """The ssm backward's scratch by enumeration: 64 channels a block, 2
    blocks a cluster."""
    blocks = len({d // 64 for d in range(di)})
    clusters = len({blk // 2 for blk in range(blocks)})
    return {"dbm_part": b * s * clusters * 16,
            "dcm_part": b * s * clusters * 16, "da_part": b * di * 16}


@pytest.mark.parametrize("b,s,di", SSM_SHAPES)
def test_ssm_plan_matches_a_direct_count(b, s, di):
    assert ssb.workspace_floats(b, s, di) == ssm_direct(b, s, di)
    bounds = sum(1 for t in range(1, s) if t % 16 == 0)
    assert ss.checkpoint_count(s) == bounds


def test_ssm_plan_of_the_training_shapes():
    """jamba at 8 x 128: 256 blocks in 128 clusters of 2, so 128 partials
    of dB and of dC a (row, step) where the first design wrote 256; the
    forward keeps 7 checkpoints of 8 rows x 16,384 channels x 16 states
    (58.7 MB).  At phase 6c's 2 x 2,048: 127 checkpoints, 266 MB, the
    partials 33.6 MB each (134 MB both in the first design)."""
    assert ssb.CLUSTER == 2
    sz = ssb.workspace_floats(8, 128, 16384)
    assert sz["dbm_part"] == 8 * 128 * 128 * 16
    assert ss.checkpoint_count(128) * 8 * 16384 * 16 * 4 == 58_720_256
    sz = ssb.workspace_floats(2, 2048, 16384)
    assert ss.checkpoint_count(2048) * 2 * 16384 * 16 * 4 == 266_338_304
    assert sz["dbm_part"] * 4 == 2 * 2048 * 128 * 16 * 4 == 33_554_432
    assert ssb.workspace_floats(1, 1, 8)["dbm_part"] == 16


def test_ssm_wrapper_refuses_cpu_tensors():
    t = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssb.ssm_scan_bwd(t, torch.zeros(1, 4, 16), torch.zeros(1, 4, 16), t,
                         torch.zeros(8, 16), torch.zeros(1, 8, 16), t)
