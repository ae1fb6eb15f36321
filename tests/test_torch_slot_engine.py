"""The port's slot path against the reference, on the same weights.

Reduced qwen3-0.6b in float32 on the CPU, the reference's parameters
bridged into the port (``repro_torch.bridge.params_from_jax``):

* ``Model.prefill`` logits and caches, and ``Model.decode_step`` logits
  and cache writes, against the reference's on the same inputs.  The
  reference's prefill runs both ways it can: through its Pallas flash
  kernel in interpret mode (``REPRO_USE_KERNELS=1`` and
  ``REPRO_FORCE_PALLAS_INTERPRET=1``, as ``tests/test_kernels.py`` sets
  them) and through its q-chunked jnp path.  Tolerance ``atol=rtol=
  1e-4``: float32 on both sides, where summation order moves logits of
  magnitude ~1 by ~1e-6, while a wrong mask, position or lane moves
  them by >1e-2.
* ``LLMEngine`` token-identical to the reference's ``LLMEngine`` on a
  seeded mixed-length workload with more requests than slots, so slots
  are reused, and to the port's own ``PagedLLMEngine`` (the check of
  ``tests/test_config_matrix.py``), with the stats schema validated.
* ``write_slot`` against the reference's splice of the whole strip.  It
  is this test that holds the splice: in a strip of global attention,
  lane j only ever holds position j, so a new occupant rewrites every
  lane its mask can reach before reading it, and a splice of the prompt
  lanes alone would still give the same tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving import stats_schema as jschema  # noqa: E402
from repro.serving.loadgen import mixed_length_workload  # noqa: E402
from repro.serving.server import LLMEngine as JaxLLMEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402
from repro_torch.serving import stats_schema  # noqa: E402
from repro_torch.serving.server import LLMEngine, PagedLLMEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    cfg = reduced_cfg("qwen3-0.6b")
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, Model(get_config("qwen3-0.6b").reduced(),
                              device="cpu"), tparams


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


def _check_caches(tc, jc):
    assert jax.tree.structure(tc) == jax.tree.structure(jc)
    for (path, t), j in zip(jax.tree_util.tree_flatten_with_path(tc)[0],
                            jax.tree.leaves(jc)):
        assert t.shape == j.shape, path
        if path[-1].key == "pos":
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("route", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("cache_max", [24, 9])
def test_model_prefill_matches_reference(pair, monkeypatch, route,
                                         cache_max):
    """Logits and caches of a batch of two 13-token prompts: a strip
    longer than the prompt (24) and a ring-aligned one (9)."""
    jm, jparams, tm, tparams = pair
    if route == "pallas_interpret":
        monkeypatch.setenv("REPRO_USE_KERNELS", "1")
        monkeypatch.setenv("REPRO_FORCE_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("REPRO_USE_KERNELS", raising=False)
        monkeypatch.delenv("REPRO_FORCE_PALLAS_INTERPRET", raising=False)
    toks = np.random.default_rng(0).integers(
        1, jm.cfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                        cache_max=cache_max)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        cache_max=cache_max)
    assert tl.shape == (2, 1, jm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_caches(_torch_np(tc), _np(jc))


def test_model_decode_step_matches_reference(pair):
    """One step over rows at ragged positions: a live row, a dead slot at
    position 0, a row writing past the strip's end (ring lane pos % C);
    logits and the written caches agree."""
    jm, jparams, tm, tparams = pair
    cfg = jm.cfg
    rng = np.random.default_rng(1)
    b, c = 3, 8
    kv_shape = (cfg.num_layers, b, c, cfg.num_kv_heads, cfg.resolved_head_dim)
    lens = [5, 0, 8]
    pos_strip = np.full((cfg.num_layers, b, c), -1, np.int32)
    for row, n in enumerate(lens):
        pos_strip[:, row, :n] = np.arange(n)
    caches = {"periods": {"slot0": {
        "k": rng.normal(size=kv_shape).astype(np.float32),
        "v": rng.normal(size=kv_shape).astype(np.float32),
        "pos": pos_strip}}, "rem": {}}
    toks = rng.integers(1, cfg.vocab_size, (b, 1)).astype(np.int32)
    pos = np.array([5, 0, 11], np.int32)
    jl, jc = jm.decode_step(jparams, jax.tree.map(jnp.asarray, caches),
                            jnp.asarray(toks), jnp.asarray(pos))
    tl, tc = tm.decode_step(
        tparams, jax.tree.map(lambda a: torch.from_numpy(a.copy()), caches),
        torch.from_numpy(toks), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _check_caches(_torch_np(tc), _np(jc))


def test_cache_init_layout_matches_reference(pair):
    jm, _, tm, _ = pair
    ours = tm.cache_init(3, 16)
    ref = jm.cache_abstract(3, 16)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        ours) == \
        jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), ref)
    leaves = ours["periods"]["slot0"]
    assert torch.all(leaves["pos"] == -1)
    assert not leaves["k"].any() and not leaves["v"].any()


def test_write_slot_matches_reference():
    """The whole strip lands in the slot, pos -1 lanes included, for
    period-stacked and remainder leaves; other slots are untouched."""
    rng = np.random.default_rng(2)

    def tree(batch):
        def leaf(*shape):
            return rng.normal(size=shape).astype(np.float32)
        return {"periods": {"slot0": {
            "k": leaf(2, batch, 6, 2, 4),
            "pos": rng.integers(-1, 9, (2, batch, 6)).astype(np.int32)}},
            "rem": {"layer0": {"k": leaf(batch, 6, 2, 4)}}}

    big, small = tree(4), tree(1)
    expect = _np(jkv.write_slot(jax.tree.map(jnp.asarray, big),
                                jax.tree.map(jnp.asarray, small), 2))
    ours = tkv.write_slot(jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                                       big),
                          jax.tree.map(torch.from_numpy, small), 2)
    for t, j in zip(jax.tree.leaves(_torch_np(ours)), jax.tree.leaves(expect)):
        np.testing.assert_array_equal(t, j)


def test_slot_manager_matches_reference():
    ref, ours = jkv.SlotManager(3), tkv.SlotManager(3)
    for m in (ref, ours):
        assert [m.alloc() for _ in range(4)] == [0, 1, 2, None]
        m.free(1)
        m.free(0)
        assert (m.live, m.num_free, m.alloc()) == ([2], 2, 0)


# ------------------------------------------------------------ engines


def _workload(vocab):
    """9 mixed-length requests (4-24 prompt tokens) for 3 slots: slots
    are reused, and the longest requests fill their 32-lane strips."""
    return mixed_length_workload(num_requests=9, vocab_size=vocab,
                                 min_len=4, max_len=24, median_len=10.0,
                                 max_new=10, seed=6)


def _drain(engine, wl):
    for p, n in zip(wl.prompts, wl.max_news):
        engine.submit(p, max_new=n)
    outs = {}
    for _ in range(2000):
        if engine.idle:
            break
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
    assert engine.idle
    return outs


@pytest.fixture(scope="module")
def reference_slot_run(pair):
    jm, jparams, _, _ = pair
    eng = JaxLLMEngine(jm, jparams, num_slots=3, cache_max=32)
    return _drain(eng, _workload(jm.cfg.vocab_size)), eng.stats()


def test_slot_engine_token_identical_to_reference(pair, reference_slot_run):
    _, _, tm, tparams = pair
    ref_outs, ref_stats = reference_slot_run
    wl = _workload(tm.cfg.vocab_size)
    ops.reset_launch_counts()
    eng = LLMEngine(tm, tparams, num_slots=3, cache_max=32)
    outs = _drain(eng, wl)
    assert ops.launch_counts() == {"conv2d": 0, "flash_attention": 0,
                                   "paged_attention": 0, "paged_prefill": 0,
                                   "rwkv6_scan": 0}
    assert outs == ref_outs
    assert len(outs) == len(wl.prompts)
    # some request stopped at a full strip, not at max_new
    assert any(len(t) < n for t, n in zip(outs.values(), wl.max_news))
    stats = stats_schema.validate(eng.stats())
    jschema.validate(stats)
    assert stats == ref_stats


def test_slot_engine_token_identical_to_paged_engine(pair):
    """Strips long enough that no request stops at a full one (the paged
    engine refuses requests past ``max_len`` at submit)."""
    _, _, tm, tparams = pair
    wl = _workload(tm.cfg.vocab_size)
    slot = LLMEngine(tm, tparams, num_slots=3, cache_max=40)
    paged = PagedLLMEngine(tm, tparams, num_blocks=32, block_size=4,
                           max_batch=8, max_len=40)
    slot_outs = _drain(slot, wl)
    assert _drain(paged, wl) == slot_outs
    assert [len(slot_outs[i + 1]) for i in range(9)] == wl.max_news
    assert paged.allocator.num_live == 0
    stats_schema.validate(paged.stats())
    stats_schema.validate(slot.stats())


def test_slot_engine_refuses_obs(pair):
    _, _, tm, tparams = pair
    with pytest.raises(NotImplementedError):
        LLMEngine(tm, tparams, obs=object())
