"""The two backward kernels on the card (tests marked ``cuda``; they skip
without a card, and import no JAX, so they run with ``--noconftest``).

``rwkv6_scan_bwd`` at rwkv6-1.6b's heads (32 of 64) and ``ssm_scan_bwd``
at jamba-1.5-large-398b's width (d_inner 16,384, 16 states), at S = 1,
128 (the training shape, 8 rows), 300 (1 row) and 2,048 (2 rows), each
against its
plain version (``ref.rwkv6_scan_bwd_ref`` / ``ref.ssm_scan_bwd_ref``) on
the card on the same inputs, with a non-zero start state and a given
gradient of the final state.  float32: every gradient within 1e-4 x its
max|g| (the kernels sum over rows, columns, channels and steps in other
orders than the plain versions' einsums, and take exp(dt a) as the
forward does, by ``ex2.approx``).  bf16 x (and dy): dx within 2 bf16
ulps of the plain version's, which rounds the same float32 sum once,
plus that float32 floor.  Each launch twice: the same bits (no float
atomics).  Also: masked lanes (rwkv6 decay 1 and key 0; mamba dt = 0);
the model's transposed (B,S,H,hd) views giving the bits of contiguous
copies; other head dims (a column block part-full; 4-byte copies) and
d_inner widths (a CTA part-full); a subset of the gradients giving the full launch's bits for
those; the WKV6 backward's chunk grid at head dims 32, 48 and 64 (one
or two column spans, its cluster's size) and S = 1, 7, 37, 129 and 300,
with and without a final-state gradient and with masked rows, and every
one of its 63 subsets of gradients; the autograd Functions in ``ops``
launching each kernel once a forward and once a backward; and a
backward whose kernel cannot launch raising rather than falling back to
the plain version.  The selective scan's training forward: each
checkpoint bit-equal to the final state of a call over that prefix, and
y and h_final bit-equal to the serving call's; ``ssm_scan_bwd`` from
those checkpoints against the plain version, and its repeats
bit-identical, where d_inner leaves a cluster of 2 column blocks
part-full (blocks past d_inner summed as zeros); the backward refusing
to run without them where S > 16.
"""
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan_bwd as rwb_mod  # noqa: E402
from repro_torch.kernels import ssm_scan as ss_mod  # noqa: E402
from repro_torch.kernels import ssm_scan_bwd as ssb_mod  # noqa: E402

REL = 1e-4
HEADS, HEAD_DIM = 32, 64          # rwkv6-1.6b
D_INNER, STATES = 16384, 16       # jamba-1.5-large-398b
# (rows, S, masked): S = 1, the training shape, one row of 300 (19
# chunks, the last part-full), a long sequence
CASES = [(8, 1, False), (8, 128, False), (8, 128, True), (1, 300, False),
         (1, 300, True), (2, 2048, False), (2, 2048, True)]
# rwkv6_scan_bwd's chunk grid: head dims of 2, 3 and 4 column blocks (the
# cluster's size) at S = 1, under one chunk of 16, not a multiple of it
# (37, 129) and 300
GRID_CASES = [(32, 1), (48, 7), (64, 37), (32, 300), (48, 129), (64, 300)]
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def rwkv_case(device, b, s, seed=0, masked=False):
    """As the rwkv6 layer passes them: (B,S,H,hd) projections viewed as
    (B,H,S,hd), decays exp(-exp(N(-3, 1))), a start state; dout and
    ds_final.  masked: row 0's second half has decay 1 and key 0."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    r, k, v = (randn(b, s, HEADS, HEAD_DIM).transpose(1, 2)
               for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, s, HEADS, HEAD_DIM) - 3.0)
                  ).transpose(1, 2)
    if masked:
        w[0, :, s // 2:] = 1.0
        k[0, :, s // 2:] = 0.0
    u = randn(HEADS, HEAD_DIM) * 0.5
    s0 = randn(b, HEADS, HEAD_DIM, HEAD_DIM) * 0.1
    dout = randn(b, s, HEADS, HEAD_DIM).transpose(1, 2)
    dsf = randn(b, HEADS, HEAD_DIM, HEAD_DIM)
    return [r, k, v, w, u, s0], dout, dsf


def ssm_case(device, b, s, xdt, seed=0, masked=False):
    """As the mamba layer passes them: softplus step sizes, N(0, 1)
    projections and inputs, decays -exp(N(0, 1)), a start state; dy (in
    x's dtype) and dh_final.  masked: row 0's second half has dt = 0."""
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    dt = F.softplus(randn(b, s, D_INNER) * 0.5 - 1.0)
    if masked:
        dt[0, s // 2:] = 0.0
    args = [dt, randn(b, s, STATES), randn(b, s, STATES),
            randn(b, s, D_INNER).to(xdt), -torch.exp(randn(D_INNER, STATES)),
            randn(b, D_INNER, STATES)]
    return args, randn(b, s, D_INNER).to(xdt), randn(b, D_INNER, STATES)


def ssm_bwd(args, dy, dhf=None, **kw):
    """``ssm_scan_bwd`` from the training forward's checkpoints, as
    ``ops.ssm_scan``'s autograd Function passes them."""
    ck = ss_mod.ssm_scan(*args, checkpoints=True)[2]
    return ssb_mod.ssm_scan_bwd(*args, dy, dhf, ckpt=ck, **kw)


def assert_close(got, want, name):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL * max(scale, 1e-30), (name, err, scale)


def assert_bf16_close(got, want, name):
    """Within 2 bf16 ulps of the plain value, plus the float32 floor."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    floor = REL * w.abs().max().item()
    bad = (g - w).abs() > 2 * ulp + floor
    assert not bool(bad.any()), (name, (g - w).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,masked", CASES)
def test_rwkv6_scan_bwd_matches_plain(cuda, b, s, masked):
    args, dout, dsf = rwkv_case(cuda, b, s, masked=masked)
    got = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf)
    again = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf)
    want = ref.rwkv6_scan_bwd_ref(*args, dout, dsf)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                             again, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert torch.equal(g, a), name                 # the same bits
        assert_close(g, w, name)
    # dr, dk, dv, dw take the (transposed) layouts of r, k, v, w
    assert [t.stride() for t in got[:4]] == [t.stride() for t in args[:4]]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,s", [(8, 37), (24, 16), (40, 33), (6, 21)])
def test_rwkv6_scan_bwd_other_head_dims_match_plain(cuda, hd, s):
    """Head dims that leave a column block part-full (8, 24, 40) or are
    not a multiple of 4 (6: 4-byte copies), contiguous float32."""
    gen = torch.Generator(device=cuda).manual_seed(hd)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    b, h = 2, 3
    r, k, v = (randn(b, h, s, hd) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, h, s, hd) - 1.0))
    args = [r, k, v, w, randn(h, hd) * 0.5, randn(b, h, hd, hd) * 0.1]
    dout, dsf = randn(b, h, s, hd), randn(b, h, hd, hd)
    got = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf)
    want = ref.rwkv6_scan_bwd_ref(*args, dout, dsf)
    torch.cuda.synchronize()
    for name, g, w_ in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got, want):
        assert_close(g, w_, name)


def grid_case(device, hd, s, masked=False, b=2, h=4):
    """Contiguous float32 inputs at ``hd`` and ``s``; masked: row 0's
    second half has decay 1 and key 0."""
    gen = torch.Generator(device=device).manual_seed(hd * 1000 + s)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    r, k, v = (randn(b, h, s, hd) for _ in range(3))
    w = torch.exp(-torch.exp(randn(b, h, s, hd) - 2.0))
    if masked:
        w[0, :, s // 2:] = 1.0
        k[0, :, s // 2:] = 0.0
    args = [r, k, v, w, randn(h, hd) * 0.5, randn(b, h, hd, hd) * 0.1]
    return args, randn(b, h, s, hd), randn(b, h, hd, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,s", GRID_CASES)
@pytest.mark.parametrize("variant", ["final", "no_final", "masked"])
def test_rwkv6_scan_bwd_chunk_grid_matches_plain(cuda, hd, s, variant):
    """Every chunk at once, the column blocks summed in a cluster: each
    gradient within 1e-4 x max|g| of the plain version, with a final
    state gradient, without one (zeros), and with masked rows; a second
    launch gives the same bits."""
    args, dout, dsf = grid_case(cuda, hd, s, masked=variant == "masked")
    if variant == "no_final":
        dsf = None
    got = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf)
    again = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf)
    want = ref.rwkv6_scan_bwd_ref(*args, dout, dsf)
    torch.cuda.synchronize()
    for name, g, a, w in zip(GRADS, got, again, want):
        assert torch.equal(g, a), name
        assert_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,s", [(48, 37), (64, 130)])
def test_rwkv6_scan_bwd_every_need_subset_gives_the_full_bits(cuda, hd, s):
    """Each of the 63 subsets of (dr, dk, dv, dw, du, ds0) launches alone
    and gives, for the gradients it asks for, the full launch's bits."""
    args, dout, dsf = grid_case(cuda, hd, s)
    full = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf)
    for mask in range(1, 64):
        need = tuple(bool(mask >> i & 1) for i in range(6))
        part = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf, need=need)
        for name, g, p, n in zip(GRADS, full, part, need):
            assert (p is None) != n, (mask, name)
            assert p is None or torch.equal(g, p), (mask, name)


@pytest.mark.cuda
def test_rwkv6_scan_bwd_views_and_subsets_give_the_same_bits(cuda):
    args, dout, dsf = rwkv_case(cuda, 4, 77)
    full = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf)
    dense = [t.contiguous() for t in args[:4]] + args[4:]
    for g, c in zip(full, rwb_mod.rwkv6_scan_bwd(*dense, dout.contiguous(),
                                                 dsf)):
        assert torch.equal(g, c)
    need = (False, True, False, False, True, False)
    part = rwb_mod.rwkv6_scan_bwd(*args, dout, dsf, need=need)
    for g, p, n in zip(full, part, need):
        assert (p is None) != n and (p is None or torch.equal(g, p))
    # no ds_final and no s0: zeros
    zero = rwb_mod.rwkv6_scan_bwd(*args[:5], None, dout)
    want = rwb_mod.rwkv6_scan_bwd(*args[:5], torch.zeros_like(args[5]),
                                  dout, torch.zeros_like(dsf))
    assert all(torch.equal(a, b) for a, b in zip(zero, want))


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,masked", CASES)
def test_ssm_scan_bwd_matches_plain(cuda, b, s, masked, xdt):
    args, dy, dhf = ssm_case(cuda, b, s, getattr(torch, xdt), masked=masked)
    got = ssm_bwd(args, dy, dhf)
    again = ssm_bwd(args, dy, dhf)
    want = ref.ssm_scan_bwd_ref(*args, dy, dhf)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("ddt", "dbm", "dcm", "dx", "da", "dh0"), got,
                             again, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, a), name                 # the same bits
        if name == "dx" and xdt == "bfloat16":
            assert_bf16_close(g, w, name)
        else:
            assert_close(g, w, name)
    if masked:
        assert float(got[3][0, s // 2:].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("di,xdt", [(8, "float32"), (200, "bfloat16"),
                                    (512, "float32")])
def test_ssm_scan_bwd_other_widths_match_plain(cuda, di, xdt):
    """d_inner below one CTA's 64 channels, not a multiple of 64 (the
    last CTA part-full), and reduced jamba's 512; S = 37."""
    import torch.nn.functional as F

    gen = torch.Generator(device=cuda).manual_seed(di)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    b, s = 3, 37
    args = [F.softplus(randn(b, s, di) * 0.5 - 1.0), randn(b, s, STATES),
            randn(b, s, STATES), randn(b, s, di).to(getattr(torch, xdt)),
            -torch.exp(randn(di, STATES)), randn(b, di, STATES)]
    dy, dhf = randn(b, s, di).to(args[3].dtype), randn(b, di, STATES)
    got = ssm_bwd(args, dy, dhf)
    want = ref.ssm_scan_bwd_ref(*args, dy, dhf)
    torch.cuda.synchronize()
    for name, g, w in zip(("ddt", "dbm", "dcm", "dx", "da", "dh0"), got,
                          want):
        if name == "dx" and xdt == "bfloat16":
            assert_bf16_close(g, w, name)
        else:
            assert_close(g, w, name)


@pytest.mark.cuda
def test_ssm_scan_bwd_subsets_give_the_same_bits(cuda):
    args, dy, dhf = ssm_case(cuda, 2, 45, torch.bfloat16)
    full = ssm_bwd(args, dy, dhf)
    need = (True, False, True, False, True, False)
    part = ssm_bwd(args, dy, dhf, need=need)
    for g, p, n in zip(full, part, need):
        assert (p is None) != n and (p is None or torch.equal(g, p))
    zero = ssm_bwd(args, dy)
    want = ssm_bwd(args, dy, torch.zeros_like(dhf))
    with pytest.raises(ValueError, match="needs ckpt"):
        ssb_mod.ssm_scan_bwd(*args, dy, dhf)
    assert all(torch.equal(a, b) for a, b in zip(zero, want))


@pytest.mark.cuda
def test_functions_launch_each_kernel_once_a_pass(cuda):
    """Through ``ops``: the forward kernel once, the backward kernel once,
    the gradients the raw backward's."""
    for fn, case, fwd, bwd, bwd_fn in (
            (ops.rwkv6_scan, rwkv_case(cuda, 2, 40), "rwkv6_scan",
             "rwkv6_scan_bwd", rwb_mod.rwkv6_scan_bwd),
            (ops.ssm_scan, ssm_case(cuda, 2, 40, torch.float32), "ssm_scan",
             "ssm_scan_bwd", lambda *a: ssm_bwd(a[:6], *a[6:]))):
        args, cot, cot_final = case
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        ops.reset_launch_counts()
        out, final = fn(*leaves)
        ((out * cot).sum() + (final * cot_final).sum()).backward()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts[fwd] == 1 and counts[bwd] == 1, counts
        want = bwd_fn(*args, cot.contiguous(), cot_final)
        for leaf, w in zip(leaves, want):
            assert torch.equal(leaf.grad, w)


@pytest.mark.cuda
def test_a_backward_that_cannot_launch_raises(cuda):
    """No fallback: a CUDA backward whose kernel fails raises."""
    args, dout, _ = rwkv_case(cuda, 1, 20)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    out, _ = ops.rwkv6_scan(*leaves)
    with mock.patch.object(rwb_mod.KERNEL, "launch",
                           side_effect=RuntimeError("no launch")), \
            pytest.raises(RuntimeError, match="no launch"):
        (out * dout).sum().backward()
    args, dy, _ = ssm_case(cuda, 1, 20, torch.float32)
    leaves = [t.detach().clone().requires_grad_(True) for t in args]
    y, _ = ops.ssm_scan(*leaves)
    with mock.patch.object(ssb_mod.KERNEL, "launch",
                           side_effect=RuntimeError("no launch")), \
            pytest.raises(RuntimeError, match="no launch"):
        (y * dy).sum().backward()


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_ssm_scan_checkpoints_are_the_prefix_final_states(cuda, xdt):
    """Checkpoint k of the training forward equals, bit for bit, h_final
    of a call over the first 16 (k + 1) steps; its y and h_final equal
    the serving call's."""
    args, _, _ = ssm_case(cuda, 2, 70, getattr(torch, xdt))
    y, hf, ck = ss_mod.ssm_scan(*args, checkpoints=True)
    y0, hf0 = ss_mod.ssm_scan(*args)
    assert torch.equal(y, y0) and torch.equal(hf, hf0)
    assert tuple(ck.shape) == (2, 4, D_INNER, STATES)
    for k in range(ck.shape[1]):
        n = 16 * (k + 1)
        cut = [t[:, :n].contiguous() for t in args[:4]] + args[4:]
        assert torch.equal(ck[:, k], ss_mod.ssm_scan(*cut)[1]), k
    assert ss_mod.ssm_scan(*[t[:, :16].contiguous() for t in args[:4]]
                           + args[4:], checkpoints=True)[2].shape[1] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("di", [8, 200, 328, 16192])
def test_ssm_scan_bwd_ragged_clusters_repeat_bit_identical(cuda, di):
    """Clusters of 2 column blocks where d_inner is not a multiple of
    their 128 channels: 8 (one block, the other past d_inner), 200 (the
    last block 8 channels), 328 (the last cluster's second block 8
    channels) and 16,192 (253 blocks, the last cluster one block), S = 45
    (a part-full last chunk) from the forward's checkpoints: within the
    plain version's tolerance, and a repeat gives the same bits."""
    import torch.nn.functional as F

    gen = torch.Generator(device=cuda).manual_seed(di)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda)

    b, s = 2, 45
    args = [F.softplus(randn(b, s, di) * 0.5 - 1.0), randn(b, s, STATES),
            randn(b, s, STATES), randn(b, s, di).to(torch.bfloat16),
            -torch.exp(randn(di, STATES)), randn(b, di, STATES)]
    dy, dhf = randn(b, s, di).to(torch.bfloat16), randn(b, di, STATES)
    ck = ss_mod.ssm_scan(*args, checkpoints=True)[2]
    got = ssb_mod.ssm_scan_bwd(*args, dy, dhf, ckpt=ck)
    again = ssb_mod.ssm_scan_bwd(*args, dy, dhf, ckpt=ck)
    want = ref.ssm_scan_bwd_ref(*args, dy, dhf)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("ddt", "dbm", "dcm", "dx", "da", "dh0"), got,
                             again, want):
        assert torch.equal(g, a), name
        if name == "dx":
            assert_bf16_close(g, w, name)
        else:
            assert_close(g, w, name)
