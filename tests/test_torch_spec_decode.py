"""The port's speculative decoding against the reference's.

Reduced qwen3-0.6b in float32 on the CPU, the reference's parameters
bridged into the port (``repro_torch.bridge.params_from_jax``):

* the drafters: ``NgramDrafter`` proposals equal the reference's on
  seeded and generated histories; ``DraftModelDrafter`` proposals equal
  the reference's (its forwards counted); ``Model.forward`` logits agree
  with the reference's at ``atol=rtol=1e-4`` (float32 on both sides,
  sums in another order move logits of magnitude ~1 by ~1e-6, a wrong
  mask or position by >1e-2); ``layer_truncated_draft`` shares the
  target's storage and refuses what the reference refuses;
* the engine: with spec decoding on, ``PagedLLMEngine`` emits exactly
  the port's spec-off tokens and the reference's spec-on tokens, for
  n-gram drafting at k in {1, 2, 4, 8} and the one-layer draft at k in
  {2, 4}, under a pool tight enough to preempt, and with the prefix
  cache and copy-on-write; the spec gauges equal the reference's; the
  allocator's invariants hold after a spec lifecycle, and the blocks a
  spec run publishes to the radix tree hold no rolled-back lane.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving import spec_decode as jsd  # noqa: E402
from repro.serving import stats_schema as jschema  # noqa: E402
from repro.serving.loadgen import (repetitive_workload,  # noqa: E402
                                   shared_prefix_workload)
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import stats_schema  # noqa: E402
from repro_torch.serving.kvcache import BlockAllocator  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402
from repro_torch.serving.server import PagedLLMEngine  # noqa: E402
from repro_torch.serving.spec_decode import (DraftModelDrafter,  # noqa: E402
                                             NgramDrafter,
                                             layer_truncated_draft,
                                             make_drafter)

TOL = dict(atol=1e-4, rtol=1e-4)
SPEC_GAUGES = ("spec_decode", "spec_k", "accepted_tokens_per_step",
               "draft_hit_rate", "spec_rollbacks", "decode_fusion",
               "preemptions", "admissions", "prefill_tokens", "cow_copies",
               "prefill_compiles", "hit_rate")


@pytest.fixture(scope="module")
def pair():
    cfg = reduced_cfg("qwen3-0.6b")
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, Model(get_config("qwen3-0.6b").reduced(),
                              device="cpu"), tparams


def _drain(engine, max_steps=2000):
    outs = {}
    for _ in range(max_steps):
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
        if engine.idle:
            break
    assert engine.idle
    return outs


def _run(cls, model, params, prompts, max_new, *, num_blocks=64,
         max_len=96, **kw):
    """The reference tests' engine shape: blocks of 8, chunks of 16, a
    budget of 64 tokens a step."""
    engine = cls(model, params, num_blocks=num_blocks, block_size=8,
                 max_batch=8, max_len=max_len, prefill_chunk=16,
                 step_token_budget=64, **kw)
    for p in prompts:
        engine.submit(p, max_new=max_new)
    return engine, _drain(engine)


def _drafts(jm, jparams, tm, tparams, mode):
    """-> (reference kwargs, port kwargs) for a spec mode."""
    if mode != "draft":
        return dict(spec_decode=mode), dict(spec_decode=mode)
    n = tm.cfg.num_layers // 2
    jd, jdp = jsd.layer_truncated_draft(jm, jparams, n)
    td, tdp = layer_truncated_draft(tm, tparams, n)
    return (dict(spec_decode="draft", draft_model=jd, draft_params=jdp),
            dict(spec_decode="draft", draft_model=td, draft_params=tdp))


@pytest.fixture(scope="module")
def repetitive(pair):
    """The reference spec tests' workload and the port's spec-off
    tokens on it."""
    _, _, tm, tparams = pair
    wl = repetitive_workload(num_requests=4, vocab_size=tm.cfg.vocab_size,
                             prompt_len=12, max_new=16, seed=3)
    _, off = _run(PagedLLMEngine, tm, tparams, wl.prompts, 16)
    return wl, off


# ------------------------------------------------------------- drafters


HISTORIES = [[7, 8, 9] * 5, [1, 2, 3, 4, 5, 9, 2, 3], [1, 2, 3, 4, 5], [3],
             [5, 5, 5, 5], [4, 1, 4, 2, 4, 1, 4], [9, 8, 7, 9, 8, 6, 9, 8]]


@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("max_n", [1, 3])
def test_ngram_proposals_equal_reference_on_seeded_histories(k, max_n):
    ours, theirs = NgramDrafter(max_n=max_n), jsd.NgramDrafter(max_n=max_n)
    rng = np.random.default_rng(k * 10 + max_n)
    hists = [np.asarray(h, np.int32) for h in HISTORIES] + [
        rng.integers(1, 6, int(n)).astype(np.int32)
        for n in rng.integers(1, 40, 12)]
    for h in hists:
        assert ours.propose(h, k) == theirs.propose(h, k), h.tolist()


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(1, 5), min_size=1, max_size=48),
       st.integers(1, 9), st.integers(1, 4))
def test_ngram_proposals_equal_reference_on_generated_histories(h, k, max_n):
    hist = np.asarray(h, np.int32)
    assert NgramDrafter(max_n=max_n).propose(hist, k) == \
        jsd.NgramDrafter(max_n=max_n).propose(hist, k)


def test_forward_logits_match_reference(pair):
    jm, jparams, tm, tparams = pair
    rng = np.random.default_rng(11)
    for s in (8, 13, 32):
        toks = rng.integers(1, tm.cfg.vocab_size, (2, s)).astype(np.int32)
        want = np.asarray(jm.forward(jparams, {"tokens": jnp.asarray(toks)},
                                     remat=False)[0])
        with torch.inference_mode():
            got = tm.forward(tparams, {"tokens": torch.from_numpy(toks)})
        assert got.shape == (2, s, tm.cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_draft_model_proposals_equal_reference(pair):
    jm, jparams, tm, tparams = pair
    ours = DraftModelDrafter(tm, tparams, max_len=64)
    theirs = jsd.DraftModelDrafter(jm, jparams, max_len=64)
    rng = np.random.default_rng(5)
    n = 0
    for length, k in ((5, 3), (11, 4), (20, 2), (62, 4)):
        h = rng.integers(1, tm.cfg.vocab_size, length).astype(np.int32)
        got = ours.propose(h, k)
        assert got == theirs.propose(h, k)
        n += min(k, 64 - length)
        assert len(got) == min(k, 64 - length)      # stops at max_len
    assert ours.forwards == n
    assert ours._sigs == theirs._sigs == {8, 16, 32, 64}


def test_layer_truncated_draft_shares_storage(pair):
    jm, jparams, tm, tparams = pair
    dm, dp = layer_truncated_draft(tm, tparams, 1)
    assert dm.cfg.num_layers == 1 and dm.device == tm.device
    assert dp["embed"] is tparams["embed"]
    assert dp["final_norm"] is tparams["final_norm"]

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]

    for d, t in zip(leaves(dp["stack"]["periods"]),
                    leaves(tparams["stack"]["periods"])):
        assert d.shape[0] == 1 and d.shape[1:] == t.shape[1:]
        assert d.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr()
        assert d.data_ptr() == t.data_ptr()
    for n in (0, tm.cfg.num_layers, -1):
        with pytest.raises(ValueError, match="cannot truncate"):
            layer_truncated_draft(tm, tparams, n)
    # the draft computes the reference draft's function
    jd, jdp = jsd.layer_truncated_draft(jm, jparams, 1)
    toks = np.arange(1, 11, dtype=np.int32)[None]
    with torch.inference_mode():
        got = dm.forward(dp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jd.forward(jdp, {"tokens": jnp.asarray(toks)},
                                           remat=False)[0]), **TOL)


def test_make_drafter_modes(pair):
    _, _, tm, tparams = pair
    assert make_drafter("off") is None and make_drafter(None) is None
    assert make_drafter("ngram").name == "ngram"
    assert make_drafter("draft", draft_model=tm,
                        draft_params=tparams).name == "draft"
    with pytest.raises(ValueError, match="draft_model"):
        make_drafter("draft")
    with pytest.raises(ValueError, match="spec_decode"):
        make_drafter("beam")
    with pytest.raises(ValueError):
        NgramDrafter(max_n=1, min_n=2)


# ------------------------------------------- engine-level token identity


@pytest.mark.parametrize("mode,k", [("ngram", 1), ("ngram", 2),
                                    ("ngram", 4), ("ngram", 8),
                                    ("draft", 2), ("draft", 4)])
def test_spec_token_identity(pair, repetitive, mode, k):
    """Spec on emits the port's spec-off tokens and the reference's
    spec-on tokens, with the reference's gauges; no kernel launches on
    the CPU."""
    jm, jparams, tm, tparams = pair
    wl, off = repetitive
    jkw, tkw = _drafts(jm, jparams, tm, tparams, mode)
    ops.reset_launch_counts()
    eng, outs = _run(PagedLLMEngine, tm, tparams, wl.prompts, 16, spec_k=k,
                     **tkw)
    assert set(ops.launch_counts().values()) == {0}
    ref_eng, ref_outs = _run(JaxEngine, jm, jparams, wl.prompts, 16,
                             spec_k=k, **jkw)
    assert outs == off
    assert outs == ref_outs
    s = stats_schema.validate(eng.stats())
    ref_s = ref_eng.stats()
    for key in SPEC_GAUGES:
        assert s[key] == ref_s[key], key
    assert eng.spec_verify_rows == ref_eng.spec_verify_rows > 0
    assert (eng.spec_proposed, eng.spec_accepted, eng.spec_emitted) == \
        (ref_eng.spec_proposed, ref_eng.spec_accepted, ref_eng.spec_emitted)
    if mode == "draft":
        assert eng.drafter.forwards > 0
        assert eng.drafter._sigs == ref_eng.drafter._sigs


def test_spec_identity_under_preemption(pair):
    """A pool too small for every request preempts mid-speculation;
    resuming from the accepted cursor changes no token."""
    jm, jparams, tm, tparams = pair
    wl = repetitive_workload(num_requests=5, vocab_size=tm.cfg.vocab_size,
                             prompt_len=12, max_new=14, seed=1)
    tight = dict(num_blocks=13, max_len=40)
    _, off = _run(PagedLLMEngine, tm, tparams, wl.prompts, 14, **tight)
    eng, outs = _run(PagedLLMEngine, tm, tparams, wl.prompts, 14,
                     spec_decode="ngram", spec_k=4, **tight)
    ref_eng, ref_outs = _run(JaxEngine, jm, jparams, wl.prompts, 14,
                             spec_decode="ngram", spec_k=4, **tight)
    assert outs == off == ref_outs
    assert eng.preemptions == ref_eng.preemptions > 0
    assert eng.spec_rollbacks == ref_eng.spec_rollbacks
    assert eng.allocator.num_live == 0
    _check_allocator(eng)


def _cow_waves(cls, model, params, prompts, **kw):
    """Serve ``prompts``, then forks of the first request's prompt +
    output that diverge inside a published block (copy-on-write at
    admission).  -> (engine, tokens of both waves)."""
    engine, outs = _run(cls, model, params, prompts, 10, **kw)
    seq = np.concatenate([prompts[0], np.asarray(outs[1], np.int32)])
    forks = []
    for i, cut in enumerate((27, 29, 30)):
        f = seq[:cut + 2].copy()
        f[cut] = 1 + (int(f[cut]) + i) % (model.cfg.vocab_size - 1)
        forks.append(f)
    for f in forks:
        engine.submit(f, max_new=6)
    outs.update(_drain(engine))
    return engine, outs


def test_spec_identity_with_prefix_cache_cow(pair):
    """Shared-prefix traffic with the radix cache on, then forks that
    diverge inside a cached block: verify windows write through
    copy-on-write blocks; output matches the spec-off cache-on and
    cache-off runs and the reference's cache+spec run."""
    jm, jparams, tm, tparams = pair
    wl = shared_prefix_workload(num_requests=4, prefix_len=20, suffix_len=3,
                                vocab_size=tm.cfg.vocab_size, num_prefixes=1,
                                seed=2)
    runs = {}
    for name, kw in (("off", dict(prefix_cache=False)),
                     ("pc", dict(prefix_cache=True)),
                     ("pc+spec", dict(prefix_cache=True,
                                      spec_decode="ngram", spec_k=4))):
        eng, runs[name] = _cow_waves(PagedLLMEngine, tm, tparams, wl.prompts,
                                     **kw)
    ref_eng, ref_outs = _cow_waves(JaxEngine, jm, jparams, wl.prompts,
                                   prefix_cache=True, spec_decode="ngram",
                                   spec_k=4)
    assert len(ref_outs) == 7
    assert runs["pc+spec"] == runs["pc"] == runs["off"] == ref_outs
    s, ref_s = eng.stats(), ref_eng.stats()
    for key in SPEC_GAUGES + ("cached_blocks", "evictions"):
        assert s[key] == ref_s[key], key
    assert s["cow_copies"] > 0 and s["hit_rate"] > 0
    _check_allocator(eng)


def test_spec_publishes_no_rolled_back_lane(pair):
    """At finish the full blocks of prompt + output land in the radix
    tree (a follow-up hits past the original prompt), and every lane of
    a published block holds its own position: no lane a rejected draft
    wrote survives there."""
    _, _, tm, tparams = pair
    engine = PagedLLMEngine(tm, tparams, num_blocks=64, block_size=8,
                            max_batch=8, max_len=96, prefill_chunk=16,
                            step_token_budget=64, prefix_cache=True,
                            spec_decode="ngram", spec_k=4)
    prompt = np.arange(1, 17, dtype=np.int32)        # 2 full blocks
    engine.submit(prompt, max_new=10)
    (out,) = _drain(engine).values()
    assert engine.spec_rollbacks > 0               # drafts were rejected
    seq = np.concatenate([prompt, np.asarray(out, np.int32)])
    full = (len(prompt) + len(out) - 1) // 8
    assert engine.prefix_cache.cached_blocks >= full
    m = engine.prefix_cache.probe(seq[:full * 8])
    assert len(m.blocks) == full
    pos = engine.pools["periods"]["slot0"]["pos"]    # (layers, NB, bs)
    for i, b in enumerate(m.blocks):
        want = torch.arange(i * 8, (i + 1) * 8, dtype=torch.int32)
        assert torch.equal(pos[:, b], want.expand(pos.shape[0], 8))
    follow = np.concatenate([prompt, np.asarray(out[:8], np.int32)])
    engine.submit(follow, max_new=4)
    _drain(engine)
    assert engine.prefix_cache.hit_tokens >= 16       # beyond the prompt
    _check_allocator(engine)


# ------------------------------------------------ allocator invariants


def _check_allocator(engine):
    """A drained engine: every block free or held by the radix tree
    alone, the block table all null, and every freed block's lanes
    invalid."""
    a = engine.allocator
    assert engine.idle
    assert a.num_free + a.num_live == a.num_usable
    cached = engine.prefix_cache.blocks() if engine.prefix_cache else []
    assert a.num_live == len(cached)
    for b in cached:
        assert a.refcount(b) == 1
    assert not engine.block_table.any()
    pos = engine.pools["periods"]["slot0"]["pos"]
    held = set(cached)
    for b in range(1, a.num_usable + 1):
        if b not in held:
            assert bool((pos[:, b] == -1).all()), b


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=3),
                min_size=4, max_size=40),
       st.integers(min_value=6, max_value=14))
def test_speculative_lifecycle_allocator_invariants(steps, num_blocks):
    """The reference's property, on the port's allocator and radix tree:
    random propose / accept-and-roll-back / finish / preempt sequences
    keep the free list conserved, roll back only private tail blocks,
    and leave tree-held blocks a refcount of at least 1."""
    bs = 4
    a = BlockAllocator(num_blocks=num_blocks, block_size=bs)
    tree = PrefixCache(block_size=bs)
    rng = np.random.default_rng(len(steps) * 1000 + num_blocks)
    blocks, pos, toks = [], 0, []

    def check():
        assert a.num_free + a.num_live == a.num_usable
        for b in blocks[:pos // bs]:
            assert a.refcount(b) >= 1

    for op in steps:
        if op == 0:                            # propose: grow + write k
            k = int(rng.integers(1, 6))
            need = -(-(pos + k) // bs)
            while len(blocks) < need and a.num_free > 0:
                blocks.extend(a.alloc(1))
            k = min(k, len(blocks) * bs - pos)
            if k <= 0:
                continue
            toks.extend(int(t) for t in rng.integers(0, 50, k))
            pos += k
        elif op == 1:                          # accept, roll the rest back
            newpos = max(0, pos - int(rng.integers(0, 3)))
            keep = -(-newpos // bs) if newpos else 0
            tail = blocks[keep:]
            del blocks[keep:]
            released = a.free(tail)
            for b in tail:
                if b not in released:          # still tree-held
                    assert a.refcount(b) >= 1
            del toks[newpos:]
            pos = newpos
        elif op == 2 and pos >= bs:            # finish: publish + release
            tree.insert(toks, blocks, a)
            a.free(blocks)
            for b in tree.blocks():
                assert a.refcount(b) >= 1
            blocks, pos, toks = [], 0, []
        elif op == 3:                          # preempt: drop everything
            a.free(blocks)
            blocks, pos, toks = [], 0, []
        check()
    a.free(blocks)
    assert a.num_free + a.num_live == a.num_usable


def test_spec_off_gauges_match_reference(pair):
    """Spec off reports the reference's constants: mode off, k 0, and
    ratios over zero verify rows (plain fused decode does not count)."""
    jm, jparams, tm, tparams = pair
    wl = repetitive_workload(num_requests=2, vocab_size=tm.cfg.vocab_size,
                             prompt_len=12, max_new=6, seed=0)
    eng, outs = _run(PagedLLMEngine, tm, tparams, wl.prompts, 6)
    ref_eng, ref_outs = _run(JaxEngine, jm, jparams, wl.prompts, 6)
    assert outs == ref_outs
    s = stats_schema.validate(eng.stats())
    jschema.validate(s)
    for key in SPEC_GAUGES:
        assert s[key] == ref_eng.stats()[key], key
    assert eng.spec_verify_rows == 0 and s["spec_k"] == 0
