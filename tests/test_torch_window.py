"""The paged engine's window accounting, against the reference.

On a stack of sliding-window layers only (reduced gemma3-4b with every
layer ``attn_local`` and window 8, as ``tests/test_paged_kvcache.py``
builds it), every layer's reach is bounded, so the engine frees a
request's blocks once they slide wholly out of the window
(``PagedLLMEngine._window_shrink``) and a request never holds more than
ceil(8 / 4) + 1 = 3 blocks.  On the CPU, the reference's weights bridged
into the port:

* the port's engine emits the reference engine's tokens and frees as
  many blocks (``window_blocks_freed``), with decode fusion on and off,
  the serial scheduler and n-gram speculation, each freeing at its own
  call site (chunk accounting, the decode dispatch, verify acceptance);
* a pool of 7 usable blocks that preempts under window-blind accounting
  serves the same 4 requests without preempting under window accounting;
* the reference's eager-free invariants hold after every step of a few
  seeded admit / decode / preempt / resume lifecycles, and a forced
  mid-decode preemption resumes to the same tokens;
* ``Model.paged_live_window`` equals the reference's on every stack the
  port carries.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import stats_schema  # noqa: E402
from repro_torch.serving.server import PagedLLMEngine  # noqa: E402

WINDOW = dict(layer_kinds=("attn_local",), sliding_window=8)
ROOMY = dict(num_blocks=40, block_size=4, max_batch=8, max_len=48)
_PAIR = {}


def pair():
    """-> (reference model, its params, port model, bridged params) of the
    all-``attn_local`` stack."""
    if not _PAIR:
        cfg = dataclasses.replace(reduced_cfg("gemma3-4b"), **WINDOW)
        port = dataclasses.replace(get_config("gemma3-4b").reduced(),
                                   **WINDOW)
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
        jm = JaxModel(cfg)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        _PAIR["m"] = (jm, jax.tree.map(jnp.asarray, tree),
                      Model(port, device="cpu"),
                      params_from_jax(tree, device="cpu"))
    return _PAIR["m"]


def check_window_invariants(engine):
    """The reference's eager-free contract (``tests/test_paged_kvcache.py
    ::_check_window_invariants``), between engine steps: the allocator
    conserves blocks; every admitted request's live blocks stay within
    the bound (a prefilling row's over its written region only, since
    the whole prompt's blocks are claimed at admission); no block
    holding a position the next query can see has been freed."""
    bs, w = engine.block_size, engine.live_window
    bound = engine.window_bound
    a = engine.allocator
    assert a.num_free + a.num_live == a.num_usable
    for row in engine.active:
        blocks = engine.row_blocks[row]
        assert sum(1 for b in blocks if b) <= bound
        done = int(engine.pos[row])
        for q in range(max(0, done - w + 1), done):
            if q // bs < len(blocks):
                assert blocks[q // bs] != 0
    for cur in engine.prefilling.values():
        written = cur.all_blocks[:-(-cur.done // bs)] if cur.done else []
        assert sum(1 for b in written if b) <= bound
        for q in range(max(0, cur.done - w + 1), cur.done):
            assert cur.all_blocks[q // bs] != 0


def drive(engine, prompts, max_new, *, check=False, preempt_after=None):
    """Submit every prompt, step to idle (checking the invariants after
    each step, preempting the youngest once after ``preempt_after``
    steps); -> {rid: tokens}."""
    for p in prompts:
        engine.submit(p, max_new=max_new)
    outs = {}
    for i in range(3000):
        if engine.idle:
            break
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
        if check:
            check_window_invariants(engine)
        if i + 1 == preempt_after:
            engine._preempt_youngest()
            if check:
                check_window_invariants(engine)
    assert engine.idle
    return outs


def prompts_for(vocab, n=4, length=12, seed=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def reference_run():
    """The reference engine on 4 prompts of 12 tokens, 12 new each, in a
    roomy pool: its tokens and its ``window_blocks_freed``."""
    jm, jparams, _, _ = pair()
    eng = JaxEngine(jm, jparams, **ROOMY)
    outs = drive(eng, prompts_for(jm.cfg.vocab_size), 12)
    assert eng.preemptions == 0
    assert eng.stats()["window_blocks_freed"] > 0
    return outs, eng.stats()["window_blocks_freed"]


@pytest.mark.parametrize("mode", [
    dict(), dict(decode_fusion=False), dict(scheduler="serial"),
    dict(spec_decode="ngram", spec_k=3),
], ids=["fused", "fusion-off", "serial", "ngram"])
def test_window_accounting_matches_reference(reference_run, mode):
    jm, jparams, tm, tparams = pair()
    want, want_freed = reference_run
    prompts = prompts_for(tm.cfg.vocab_size)
    eng = PagedLLMEngine(tm, tparams, prefix_cache=True, **ROOMY, **mode)
    # a window-freed block must never be published: the cache is off
    assert eng.prefix_cache is None
    assert (eng.live_window, eng.window_bound) == (8, 3)
    assert drive(eng, prompts, 12, check=True) == want
    s = stats_schema.validate(eng.stats())
    assert s["prefix_cache"] == 0 and s["preemptions"] == 0
    if mode:
        ref = JaxEngine(jm, jparams, **ROOMY, **mode)
        assert drive(ref, prompts, 12) == want
        want_freed = ref.stats()["window_blocks_freed"]
    assert s["window_blocks_freed"] == want_freed > 0
    assert eng.allocator.num_live == 0


def test_tight_pool_serves_without_preempting(reference_run):
    """7 usable blocks for 4 requests that each end on 6 blocks:
    window-blind accounting admits two, which outgrow the pool and
    preempt; window accounting serves all four clean (at most 3 blocks
    each), with the roomy pool's tokens, as the reference's does."""
    jm, jparams, tm, tparams = pair()
    want, _ = reference_run
    prompts = prompts_for(tm.cfg.vocab_size)
    tight = dict(ROOMY, num_blocks=8)
    blind = PagedLLMEngine(tm, tparams, window_accounting=False, **tight)
    assert blind.live_window is None
    assert drive(blind, prompts, 12) == want
    assert blind.preemptions > 0
    assert blind.stats()["window_blocks_freed"] == 0
    ref = JaxEngine(jm, jparams, window_accounting=False, **tight)
    drive(ref, prompts, 12)
    assert ref.preemptions == blind.preemptions
    eng = PagedLLMEngine(tm, tparams, **tight)
    assert drive(eng, prompts, 12, check=True) == want
    assert eng.preemptions == 0
    assert eng.allocator.num_live == 0
    ref = JaxEngine(jm, jparams, **tight)
    assert drive(ref, prompts, 12) == want
    assert eng.stats()["window_blocks_freed"] == \
        ref.stats()["window_blocks_freed"]


def test_forced_preemption_resumes_to_the_same_tokens(reference_run):
    """A mid-decode eviction re-prefills prompt + generated tokens through
    the window-masked path and continues where greedy decode went."""
    _, _, tm, tparams = pair()
    want, _ = reference_run
    eng = PagedLLMEngine(tm, tparams, **ROOMY)
    assert drive(eng, prompts_for(tm.cfg.vocab_size), 12, check=True,
                 preempt_after=4) == want
    assert eng.preemptions == 1
    assert eng.allocator.num_live == 0


# seeded draws of the reference's lifecycle property: (prompt length past
# the window, max_new, steps before the next submit) per request, and the
# pool, from tight to roomy
LIFECYCLES = [
    ([(9, 10, 0), (16, 1, 2), (12, 6, 1), (14, 10, 0)], 10),
    ([(16, 10, 2), (9, 3, 0), (11, 8, 2)], 12),
    ([(13, 7, 1), (15, 9, 1), (10, 10, 0), (16, 2, 2)], 40),
    ([(16, 10, 0)], 10),
]


@pytest.mark.parametrize("reqs,num_blocks", LIFECYCLES)
def test_windowed_lifecycle_invariants(reqs, num_blocks):
    """Admit / decode / preempt / resume on the windowed stack: the
    invariants hold after every step, every pool drains clean, and the
    reference engine on the same schedule emits the same tokens and
    frees and preempts as often."""
    jm, jparams, tm, tparams = pair()
    runs = []
    for cls, m, p in ((PagedLLMEngine, tm, tparams),
                      (JaxEngine, jm, jparams)):
        eng = cls(m, p, num_blocks=num_blocks, block_size=4, max_batch=4,
                  max_len=32, prefix_cache=True)
        assert eng.prefix_cache is None
        rng = np.random.default_rng(1)
        outs = {}
        for plen, max_new, gap in reqs:
            eng.submit(rng.integers(1, tm.cfg.vocab_size, plen)
                       .astype(np.int32), max_new=max_new)
            for _ in range(gap):
                for r in eng.step():
                    outs[r.rid] = list(r.out_tokens)
                check_window_invariants(eng)
        for _ in range(2000):
            if eng.idle:
                break
            for r in eng.step():
                outs[r.rid] = list(r.out_tokens)
            check_window_invariants(eng)
        assert eng.idle and eng.allocator.num_live == 0
        runs.append((outs, eng.preemptions,
                     eng.stats()["window_blocks_freed"]))
    assert runs[0] == runs[1]
    assert len(runs[0][0]) == len(reqs)


@pytest.mark.parametrize("case", ["window", "gemma3-4b", "qwen3-0.6b",
                                  "rwkv6-1.6b", "window-0"])
def test_paged_live_window_matches_reference(case):
    """8 for the all-local stack, None where a global layer reads the
    whole prefix (gemma3-4b, qwen3-0.6b) or a local layer has window 0,
    1 for a pure recurrent stack (state, no KV)."""
    if case in ("window", "window-0"):
        extra = WINDOW if case == "window" else dict(WINDOW, sliding_window=0)
        cfg = dataclasses.replace(reduced_cfg("gemma3-4b"), **extra)
    else:
        cfg = reduced_cfg(case)
    want = {"window": 8, "gemma3-4b": None, "qwen3-0.6b": None,
            "rwkv6-1.6b": 1, "window-0": None}[case]
    assert JaxModel(cfg).paged_live_window() == want
    assert Model(cfg, device="cpu").paged_live_window() == want
