"""The port's paged model against the reference, on the same weights.

Reduced qwen3-0.6b in float32 on the CPU: the reference's parameters
(``repro.models.api.Model(cfg).init``) are bridged into the port
(``repro_torch.bridge.params_from_jax``), both sides get the same block
pools and inputs (numpy, fixed seeds), and ``prefill_paged`` /
``decode_step_paged`` logits and outputs must agree.

Tolerance: float32 on both sides; the two frameworks sum the matrix
products in different orders, which moves logits of magnitude ~1 by
~1e-6, so ``atol=rtol=1e-4`` leaves two orders of margin and still
catches any wrong mask, position or weight (those move logits by >1e-2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
NB, BS = 24, 4


@pytest.fixture(scope="module")
def pair():
    cfg = reduced_cfg("qwen3-0.6b")
    port_cfg = get_config("qwen3-0.6b").reduced()
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, Model(port_cfg, device="cpu"), tparams


def _pools(model_cfg, rng, lanes):
    """Random K/V pools (numpy, stack layout) whose pos lanes hold the
    given {(block, lane): position} entries, every other lane -1."""
    n = model_cfg.num_layers
    shape = (n, NB, BS, model_cfg.num_kv_heads, model_cfg.resolved_head_dim)
    pos = np.full((n, NB, BS), -1, np.int32)
    for (blk, lane), p in lanes.items():
        pos[:, blk, lane] = p
    slot = {"k": rng.normal(size=shape).astype(np.float32),
            "v": rng.normal(size=shape).astype(np.float32), "pos": pos}
    return {"periods": {"slot0": slot}, "rem": {}}


def _prefix_lanes(tables, lengths):
    """Lanes holding positions [0, length) of each row through its
    block table."""
    lanes = {}
    for row, n in zip(tables, lengths):
        for p in range(n):
            lanes[(int(row[p // BS]), p % BS)] = p
    return lanes


def _both(np_pools):
    jp = jax.tree.map(jnp.asarray, np_pools)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), np_pools)
    return jp, tp


def _prefill(pair, toks, np_pools, bt, start, seq_len, all_logits=False):
    jm, jparams, tm, tparams = pair
    jp, tp = _both(np_pools)
    s = toks.shape[1]
    sl = None if seq_len is None else np.asarray(seq_len, np.int32)
    jl, jc = jm.prefill_paged(
        jparams, {"tokens": jnp.asarray(toks)}, jp, jnp.asarray(bt),
        jnp.asarray(start), cache_max=s,
        seq_len=None if sl is None else jnp.asarray(sl),
        all_logits=all_logits)
    tl, tc = tm.prefill_paged(
        tparams, {"tokens": torch.from_numpy(toks)}, tp,
        torch.from_numpy(bt), torch.as_tensor(start),
        seq_len=None if sl is None else torch.from_numpy(sl),
        all_logits=all_logits)
    return (np.asarray(jl), jax.tree.map(np.asarray, jc),
            tl.numpy(), jax.tree.map(lambda t: t.numpy(), tc))


def _check_caches(jc, tc, seq_len, s):
    jslot, tslot = jc["periods"]["slot0"], tc["periods"]["slot0"]
    np.testing.assert_array_equal(tslot["pos"], jslot["pos"])
    valid = np.arange(s)[None, :] < np.asarray(seq_len)[:, None]
    for name in ("k", "v"):
        np.testing.assert_allclose(tslot[name][:, valid], jslot[name][:, valid],
                                   **TOL)


def test_prefill_fresh_batch(pair):
    """Fresh prompts: start 0, all-null tables, bucket-padded lanes."""
    rng = np.random.default_rng(0)
    vocab = pair[0].cfg.vocab_size
    toks = rng.integers(1, vocab, (3, 8)).astype(np.int32)
    seq_len = [8, 5, 3]
    bt = np.zeros((3, 2), np.int32)
    jl, jc, tl, tc = _prefill(pair, toks, _pools(pair[0].cfg, rng, {}), bt,
                              np.int32(0), seq_len)
    assert tl.shape == (3, 1, vocab)
    np.testing.assert_allclose(tl, jl, **TOL)
    _check_caches(jc, tc, seq_len, 8)


def test_prefill_prefix_offset_batch(pair):
    """Every row resumes at one scalar cursor past a cached prefix; lanes
    at/past the cursor in a copied block (a diverged COW tail) must stay
    masked."""
    rng = np.random.default_rng(1)
    vocab = pair[0].cfg.vocab_size
    start = 6
    bt = np.array([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    lanes = _prefix_lanes(bt, [start, start])
    lanes[(2, 2)] = 6          # diverged donor tail past the cursor
    lanes[(5, 3)] = 7
    toks = rng.integers(1, vocab, (2, 4)).astype(np.int32)
    jl, jc, tl, tc = _prefill(pair, toks, _pools(pair[0].cfg, rng, lanes),
                              bt, np.int32(start), [4, 2])
    np.testing.assert_allclose(tl, jl, **TOL)
    _check_caches(jc, tc, [4, 2], 4)


@pytest.mark.parametrize("all_logits", [False, True])
def test_prefill_ragged_per_row_cursors(pair, all_logits):
    """Continuous batching: per-row cursors, tables and valid lengths in
    one dispatch, plus a padding row against the null table."""
    rng = np.random.default_rng(2)
    vocab = pair[0].cfg.vocab_size
    starts = np.array([0, 5, 9, 0], np.int32)
    seq_len = [8, 3, 1, 1]
    bt = np.array([[7, 8, 0, 0], [1, 2, 3, 0], [4, 5, 6, 9], [0, 0, 0, 0]],
                  np.int32)
    lanes = _prefix_lanes(bt[:3], starts[:3])
    toks = rng.integers(1, vocab, (4, 8)).astype(np.int32)
    jl, jc, tl, tc = _prefill(pair, toks, _pools(pair[0].cfg, rng, lanes),
                              bt, starts, seq_len, all_logits=all_logits)
    if all_logits:
        valid = np.arange(8)[None, :] < np.asarray(seq_len)[:, None]
        np.testing.assert_allclose(tl[valid], jl[valid], **TOL)
    else:
        np.testing.assert_allclose(tl, jl, **TOL)
    _check_caches(jc, tc, seq_len, 8)


@pytest.mark.parametrize("decode_kernel", [False, True])
def test_decode_step_active_and_inactive_rows(pair, decode_kernel):
    """One decode step over active rows at ragged positions and inactive
    rows (null tables, ``active`` False): active logits and the pool
    writes match the reference's decode step through its jnp gather
    (``decode_kernel`` False) and through its kernel op (True;
    ``repro.kernels.ops.paged_attention``, the reference's oracle on the
    CPU); inactive rows write only pos -1 into the null block."""
    jm, jparams, tm, tparams = pair
    rng = np.random.default_rng(3)
    vocab = jm.cfg.vocab_size
    pos = np.array([5, 0, 11, 0], np.int32)
    active = np.array([True, False, True, False])
    bt = np.array([[1, 2, 0], [0, 0, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    lanes = _prefix_lanes(bt[[0, 2]], pos[[0, 2]])
    np_pools = _pools(jm.cfg, rng, lanes)
    toks = rng.integers(1, vocab, (4, 1)).astype(np.int32)
    jp, tp = _both(np_pools)
    jl, jpools = jm.decode_step_paged(
        jparams, jp, jnp.asarray(bt), jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(active), decode_kernel=decode_kernel)
    tl, tpools = tm.decode_step_paged(
        tparams, tp, torch.from_numpy(bt), torch.from_numpy(toks),
        torch.from_numpy(pos), torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               **TOL)
    jslot = jax.tree.map(np.asarray, jpools["periods"]["slot0"])
    tslot = jax.tree.map(lambda t: t.numpy(), tpools["periods"]["slot0"])
    np.testing.assert_array_equal(tslot["pos"], jslot["pos"])
    # block 0 takes the inactive rows' racing garbage payloads
    for name in ("k", "v"):
        np.testing.assert_allclose(tslot[name][:, 1:], jslot[name][:, 1:],
                                   **TOL)


def test_init_schema_matches_reference(pair):
    """The port's seeded init draws the reference's schema shapes with its
    scale rules: N(0, 0.02) embeddings, N(0, 1/fan_in) projections."""
    jm, jparams, tm, _ = pair
    ours = tm.init(seed=7)
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == ref_shapes
    assert torch.equal(tm.init(seed=7)["embed"]["tokens"],
                       ours["embed"]["tokens"])
    assert abs(ours["embed"]["tokens"].std().item() - 0.02) < 2e-3
    wq = ours["stack"]["periods"]["slot0"]["mix"]["wq"]
    assert abs(wq.std().item() - wq.shape[1] ** -0.5) < 0.1 * wq.shape[1] ** -0.5
    assert torch.all(ours["final_norm"]["scale"] == 1)


def test_model_refuses_unported_configs():
    base = get_config("qwen3-0.6b").reduced()
    for bad in (dataclasses.replace(base, is_encoder_decoder=True),
                dataclasses.replace(base, frontend="vision")):
        with pytest.raises(ValueError):
            Model(bad, device="cpu")
    # the int8 KV cache is ported: the model builds, its pools are int8
    quant = Model(dataclasses.replace(base, kv_cache_quant=True),
                  device="cpu")
    assert quant.pool_init(4, 2)["periods"]["slot0"]["k"].dtype == \
        torch.int8
    with pytest.raises(KeyError, match="not carried"):
        get_config("whisper-tiny")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Model(base)
