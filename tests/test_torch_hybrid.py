"""MoE and recurrent-hybrid stacks through the port, against the reference.

Reduced jamba-1.5-large-398b (a mamba layer, then an attention layer
with an MoE FFN), dbrx-132b and grok-1-314b (attention + MoE, SwiGLU and
GeGLU experts) and rwkv6-1.6b, float32, the reference's weights bridged
(mamba's ``dt_bias`` / ``a_log`` and rwkv6's zero-initialised leaves
drawn from a seed first, so that no decay is a constant), at the
published capacity factor 1.25:

* ``Model.prefill_paged`` with ``state_rows`` (a ragged dispatch that
  writes prefixes and state slots, then a second one that reads them,
  a padding row sent to the trash slot) and ``decode_step_paged``
  (active and inactive rows): logits within ``atol=rtol=1e-4``, and the
  pools after the writes (KV and state slots) alike;
* the paged engine (decode fusion on and off) and the slot engine emit
  the reference engines' tokens exactly; jamba and rwkv6 also under a
  pool tight enough to preempt, with one more preemption forced;
* the serve CLI prints the reference CLI's ``req N:`` lines, paged (the
  default) and slot; ``--spec-decode`` with a recurrent stack is
  refused as the reference refuses it.

1e-4: float32 on both sides, where summation order moves logits of
magnitude ~1 by ~1e-6 per layer; a wrong state slot, mask, drop or gate
moves them by >1e-2.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.loadgen import mixed_length_workload  # noqa: E402
from repro.serving.server import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import stats_schema  # noqa: E402
from repro_torch.serving.server import (LLMEngine, PagedLLMEngine,  # noqa: E402
                                        ragged_dispatch)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("jamba-1.5-large-398b", "dbrx-132b", "grok-1-314b", "rwkv6-1.6b")
RECURRENT = ("jamba-1.5-large-398b", "rwkv6-1.6b")
NB, BS, MAX_BATCH = 16, 4, 4
PAGED = dict(num_blocks=32, block_size=4, max_batch=4, max_len=48,
             prefix_cache=True)
# a pool too small for the batch: 4 usable blocks a request at most
TIGHT = dict(num_blocks=12, block_size=4, max_batch=4, max_len=48)


def _drawn(tree, seed):
    """Draw the leaves the init sets to constants (mamba: dt_bias zeros,
    a_log ones; rwkv6: mu, mu_k, w_base, u, mix_b, w_b zeros) from
    ``seed``, in a numpy tree."""
    rng = np.random.default_rng(seed)
    draw = {"dt_bias": lambda s: rng.normal(-1.0, 0.5, s),
            "a_log": lambda s: rng.normal(0, 1, s),
            "mu": lambda s: rng.uniform(0, 1, s),
            "mu_k": lambda s: rng.uniform(0, 1, s),
            "w_base": lambda s: rng.normal(0, 1, s),
            "u": lambda s: rng.normal(0, 0.5, s),
            "mix_b": lambda s: rng.normal(0, 0.1, s),
            "w_b": lambda s: rng.normal(0, 0.1, s)}

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    draw[k](v.shape).astype(v.dtype) if k in draw else v)
                for k, v in sorted(node.items())}

    return walk(tree)


_PAIRS = {}


def pair(arch, dropless=False):
    """-> (reference model, its params, port model, bridged params)."""
    key = (arch, dropless)
    if key not in _PAIRS:
        cfg = reduced_cfg(arch, dropless=dropless)
        port_cfg = dataclasses.replace(
            get_config(arch).reduced(),
            moe_capacity_factor=cfg.moe_capacity_factor)
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
        jm = JaxModel(cfg)
        tree = _drawn(jax.tree.map(np.asarray,
                                   jm.init(jax.random.PRNGKey(0))), 1)
        _PAIRS[key] = (jm, jax.tree.map(jnp.asarray, tree),
                       Model(port_cfg, device="cpu"),
                       params_from_jax(tree, device="cpu"))
    return _PAIRS[key]


def _reference_dispatch(jm, params, pools, toks, bt, starts, lens, srows,
                        all_logits):
    """The reference engine's fused dispatch (``prefill_paged`` and the
    chunk's scatter), with the scatter indices built in numpy."""
    r, c = toks.shape
    logits, caches = jm.prefill_paged(
        params, {"tokens": jnp.asarray(toks)}, pools, jnp.asarray(bt),
        jnp.asarray(starts), cache_max=c, seq_len=jnp.asarray(lens),
        all_logits=all_logits, state_rows=jnp.asarray(srows))
    lane = np.arange(c)[None, :]
    pos = starts[:, None] + lane
    valid = lane < lens[:, None]
    db = np.where(valid, np.take_along_axis(
        bt, np.minimum(pos // BS, bt.shape[1] - 1), axis=1), 0)
    sr = np.broadcast_to(np.arange(r)[:, None], (r, c))
    pools = jkv.write_chunk_tokens(pools, caches, sr.ravel(),
                                   np.broadcast_to(lane, (r, c)).ravel(),
                                   db.ravel(), (pos % BS).ravel(),
                                   state_rows=srows)
    return logits, jkv.scrub_null_block(pools)


def _port_dispatch(tm, params, pools, toks, bt, starts, lens, srows,
                   all_logits):
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (toks, bt, starts, lens, srows)]
    return ragged_dispatch(tm, params, pools, *t[:4], block_size=BS,
                           all_logits=all_logits, state_rows=t[4])


def _check_pools(tpools, jpools):
    ours = jax.tree.map(lambda t: t.numpy(), tpools)
    theirs = jax.tree.map(np.asarray, jpools)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_path_with_state_rows_matches_reference(arch):
    """Two requests in engine rows 2 and 0 (state slots 2 and 0 of 5,
    slot 4 the trash): a dispatch writes their first 5 and 3 tokens (a
    padding row beside them), a second carries 4 and 6 more past those
    prefixes, then a decode step over engine rows 0-3 with rows 1 and 3
    inactive.  Logits and every pool leaf agree with the reference."""
    jm, jparams, tm, tparams = pair(arch)
    cfg = jm.cfg
    rng = np.random.default_rng(5)
    jpools = jm.pool_init(NB, BS, state_batch=MAX_BATCH + 1)
    tpools = tm.pool_init(NB, BS, state_batch=MAX_BATCH + 1)
    _check_pools(tpools, jpools)
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 0], [0, 0, 0, 0]], np.int32)
    srows = np.array([2, 0, MAX_BATCH], np.int32)
    for starts, lens, all_logits in (([0, 0, 0], [5, 3, 1], False),
                                     ([5, 3, 0], [4, 6, 1], True)):
        starts = np.array(starts, np.int32)
        lens = np.array(lens, np.int32)
        toks = rng.integers(1, cfg.vocab_size, (3, 8)).astype(np.int32)
        jl, jpools = _reference_dispatch(jm, jparams, jpools, toks, bt,
                                         starts, lens, srows, all_logits)
        tl = _port_dispatch(tm, tparams, tpools, toks, bt, starts, lens,
                            srows, all_logits)
        if all_logits:
            valid = np.arange(8)[None, :] < lens[:, None]
            np.testing.assert_allclose(tl.numpy()[valid],
                                       np.asarray(jl)[valid], **TOL)
        else:
            np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                       **TOL)
        # the trash slot holds garbage on both sides: compare the others
        _check_pools(_live_slots(tpools), _live_slots(jpools))

    pos = np.array([9, 0, 9, 0], np.int32)
    active = np.array([True, False, True, False])
    dbt = np.array([[5, 6, 7, 8], [0] * 4, [1, 2, 3, 9], [0] * 4], np.int32)
    step = rng.integers(1, cfg.vocab_size, (4, 1)).astype(np.int32)
    jl, jpools = jm.decode_step_paged(jparams, jpools, jnp.asarray(dbt),
                                      jnp.asarray(step), jnp.asarray(pos),
                                      jnp.asarray(active))
    tl, tpools = tm.decode_step_paged(
        tparams, tpools, torch.from_numpy(dbt), torch.from_numpy(step),
        torch.from_numpy(pos), torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               **TOL)
    _check_pools(_live_slots(tpools), _live_slots(jpools))


def _live_slots(pools):
    """Pools less what holds garbage on both sides: the state leaves'
    trash slot (their last row) and the KV leaves' null block (block 0,
    where padding lanes land in no defined order)."""
    def cut(node, axis):
        return {k: cut(v, axis) if isinstance(v, dict) else
                v[(slice(None),) * axis + (
                    slice(0, -1) if k in ("h", "conv", "s", "x_tm", "x_cm")
                    else slice(1, None),)]
                for k, v in node.items()}

    return {"periods": cut(pools["periods"], 1), "rem": cut(pools["rem"], 0)}


def _workload(vocab):
    """8 requests of 3-20 prompt tokens and up to 8 new ones."""
    return mixed_length_workload(num_requests=8, vocab_size=vocab,
                                 min_len=3, max_len=20, median_len=9.0,
                                 max_new=8, seed=6)


def _drain(engine, prompts, news, preempt_at=None):
    for p, n in zip(prompts, news):
        engine.submit(p, max_new=n)
    outs = {}
    for step in range(2000):
        if engine.idle:
            break
        if step == preempt_at and len(engine.active) + \
                len(engine.prefilling) > 1:
            engine._preempt_youngest()
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
    assert engine.idle
    return outs


_REFERENCE = {}


def _reference_tokens(arch, engine):
    key = (arch, engine)
    if key not in _REFERENCE:
        jm, jparams, _, _ = pair(arch)
        wl = _workload(jm.cfg.vocab_size)
        eng = JaxEngine(jm, jparams, **PAGED) if engine == "paged" else \
            JaxLLMEngine(jm, jparams, num_slots=MAX_BATCH, cache_max=48)
        _REFERENCE[key] = _drain(eng, wl.prompts, wl.max_news)
    return _REFERENCE[key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["fusion_on", "fusion_off", "slot"])
def test_engines_emit_the_reference_tokens(arch, mode):
    jm, _, tm, tparams = pair(arch)
    wl = _workload(jm.cfg.vocab_size)
    if mode == "slot":
        eng = LLMEngine(tm, tparams, num_slots=MAX_BATCH, cache_max=48)
    else:
        eng = PagedLLMEngine(tm, tparams, decode_fusion=mode == "fusion_on",
                             **PAGED)
    outs = _drain(eng, wl.prompts, wl.max_news)
    assert outs == _reference_tokens(arch, "slot" if mode == "slot"
                                     else "paged")
    stats = stats_schema.validate(eng.stats())
    if mode != "slot":
        assert stats["prefix_cache"] == int(not tm.paged_has_state)


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("fusion", [True, False])
def test_preemption_resumes_to_the_reference_tokens(arch, fusion):
    """A tight pool (jamba preempts under it; rwkv6's window accounting
    keeps it at two blocks a request) and one preemption forced mid-run:
    the resumed requests re-prefill from position 0 (their state slots
    read as zeros) and every request emits the reference engine's tokens
    on the same pool, with the same number of preemptions."""
    jm, jparams, tm, tparams = pair(arch)
    wl = _workload(jm.cfg.vocab_size)
    ref_eng = JaxEngine(jm, jparams, decode_fusion=fusion, **TIGHT)
    want = _drain(ref_eng, wl.prompts, wl.max_news, preempt_at=3)
    eng = PagedLLMEngine(tm, tparams, decode_fusion=fusion, **TIGHT)
    got = _drain(eng, wl.prompts, wl.max_news, preempt_at=3)
    assert got == want
    assert eng.preemptions == ref_eng.preemptions >= 1
    assert eng.stats()["state_slots_used"] == 0
    assert eng.allocator.num_live == 0


def test_state_slot_gauge_counts_admitted_requests():
    jm, _, tm, tparams = pair("jamba-1.5-large-398b")
    eng = PagedLLMEngine(tm, tparams, **PAGED)
    wl = _workload(jm.cfg.vocab_size)
    for p, n in zip(wl.prompts, wl.max_news):
        eng.submit(p, max_new=n)
    eng.step()
    s = eng.stats()
    assert s["state_slots_used"] == s["active"] + s["prefilling"] > 0
    qwen = Model(get_config("qwen3-0.6b").reduced(), device="cpu")
    assert PagedLLMEngine(qwen, qwen.init(0)).stats()[
        "state_slots_used"] == 0


def _serve(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--requests", "4", "--prompt-len",
                    "12", "--max-new", "5", "--stats-every", "0", *argv])
    return buf.getvalue().splitlines()


def _req_lines(lines):
    return [ln for ln in lines if ln.strip().startswith("req ")]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("engine", [[], ["--engine", "slot"]])
def test_serve_cli_serves_like_the_reference_cli(monkeypatch, arch, engine):
    """The reference's seed-0 weights for the reduced config bridged in:
    the port's CLI prints the reference CLI's ``req N:`` lines, with the
    paged engine by default and with the slot engine."""
    from repro.launch import serve as jserve

    cfg = get_config(arch).reduced()
    tparams = params_from_jax(jax.tree.map(
        np.asarray, JaxModel(reduced_cfg(arch, dropless=False)).init(
            jax.random.PRNGKey(0))), device="cpu")
    build_model = serve.build_model
    monkeypatch.setattr(serve, "build_model",
                        lambda args: build_model(args)[:2] + (tparams,))
    lines = _serve("--arch", arch, *engine)
    assert f"engine={'slot' if engine else 'paged'}" in lines[0]
    assert lines[0].startswith("4 requests, 20 tokens")
    monkeypatch.setattr("sys.argv", ["serve", "--requests", "4",
                                     "--prompt-len", "12", "--max-new", "5",
                                     "--stats-every", "0", "--arch", arch,
                                     *engine])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main()
    want = _req_lines(buf.getvalue().splitlines())
    assert len(want) == 3 and cfg.name.endswith("-reduced")
    assert _req_lines(lines) == want


@pytest.mark.parametrize("arch", RECURRENT)
def test_spec_decode_refused_on_recurrent_stacks(monkeypatch, arch):
    """``--spec-decode`` needs roll-backable KV: the port's CLI and paged
    engine refuse a recurrent stack with the reference's message."""
    from repro.launch import serve as jserve

    match = "recurrent layer state cannot roll back"
    with pytest.raises(ValueError, match=match):
        _serve("--arch", arch, "--spec-decode", "ngram")
    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch,
                                     "--spec-decode", "ngram"])
    with pytest.raises(ValueError, match=match):
        jserve.main()
