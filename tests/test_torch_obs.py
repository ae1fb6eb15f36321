"""The port's observability hooks against the reference's.

Reduced qwen3-0.6b in float32 on the CPU, the reference's parameters
bridged into the port.  Each engine runs under
``Observability.create(trace=True, trace_mode="sim")`` on a clock the
test advances, beside the reference's engine on the same workload; the
exported Chrome traces must be equal event for event and
``metrics.render()`` equal line for line.  The engines time their steps
with ``time.perf_counter``, which the test pins to 0 in both server
modules, so the step-seconds histogram is deterministic too.  Cases: the
paged engine with spec decoding off, with n-gram drafting, and with the
serial scheduler; the slot engine; and a pool tight enough to preempt
and resume.  Plus the copied recorder and facade on a synthetic
lifecycle.
"""
import json
import types

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import reduced_cfg  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving import server as jserver  # noqa: E402
from repro.serving.loadgen import repetitive_workload  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.obs.trace import span_report  # noqa: E402
from repro_torch.serving import server as tserver  # noqa: E402

FROZEN = types.SimpleNamespace(perf_counter=lambda: 0.0)

CASES = {
    "paged_spec_off": ("paged", dict(num_blocks=64, block_size=8,
                                     max_len=64, prefill_chunk=8)),
    "paged_spec_ngram": ("paged", dict(num_blocks=64, block_size=8,
                                       max_len=64, prefill_chunk=8,
                                       spec_decode="ngram", spec_k=4)),
    "paged_serial": ("paged", dict(num_blocks=64, block_size=8, max_len=64,
                                   scheduler="serial")),
    "paged_preempt": ("paged", dict(num_blocks=12, block_size=4, max_len=40,
                                    prefill_chunk=8, prefix_cache=True)),
    "slot": ("slot", dict(num_slots=2, cache_max=40)),
}


@pytest.fixture(scope="module")
def pair():
    cfg = reduced_cfg("qwen3-0.6b")
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, Model(get_config("qwen3-0.6b").reduced(),
                              device="cpu"), tparams


def _serve(mod, model, params, obs_pkg, kind, kw, prompts):
    """Submit in two waves on a clock advancing 0.25 a step; -> (engine,
    {rid: tokens}, bundle)."""
    bundle = obs_pkg.Observability.create(trace=True, trace_mode="sim")
    cls = mod.PagedLLMEngine if kind == "paged" else mod.LLMEngine
    eng = cls(model, params, obs=bundle, **kw)
    outs, now = {}, 0.0
    half = len(prompts) // 2
    for p in prompts[:half]:
        eng.submit(p, max_new=10, now=now)
    for i in range(2000):
        if i == 3:
            for p in prompts[half:]:
                eng.submit(p, max_new=10, now=now)
        for r in eng.step(now=now):
            outs[r.rid] = list(r.out_tokens)
        now += 0.25
        if eng.idle and i >= 3:
            break
    assert eng.idle
    return eng, outs, bundle


@pytest.mark.parametrize("case", sorted(CASES))
def test_sim_trace_and_metrics_equal_reference(pair, monkeypatch, case):
    jm, jparams, tm, tparams = pair
    kind, kw = CASES[case]
    monkeypatch.setattr(jserver, "time", FROZEN)
    monkeypatch.setattr(tserver, "time", FROZEN)
    wl = repetitive_workload(num_requests=4, vocab_size=tm.cfg.vocab_size,
                             prompt_len=14, max_new=10, seed=6)
    ref_eng, ref_outs, ref_obs = _serve(jserver, jm, jparams, jobs, kind, kw,
                                        wl.prompts)
    eng, outs, bundle = _serve(tserver, tm, tparams, tobs, kind, kw,
                               wl.prompts)
    assert outs == ref_outs and len(outs) == 4
    trace, ref_trace = bundle.trace.to_chrome(), ref_obs.trace.to_chrome()
    assert json.dumps(trace) == json.dumps(ref_trace)
    assert bundle.metrics.render() == ref_obs.metrics.render()
    assert tobs.validate_chrome_trace(trace, sorted(outs)) == []
    rep = span_report(trace)
    assert all(rep[r]["opens"] == rep[r]["closes"] == 1 for r in outs)
    names = {e["name"] for e in trace["traceEvents"]}
    if case == "paged_spec_ngram":
        assert "spec_verify" in names
        assert "engine_spec_proposed_total" in bundle.metrics.render()
    if case == "paged_preempt":
        assert eng.preemptions > 0 and "evicted_resume" in names
    if kind == "paged":
        c = {e["name"]: e["value"] for e in
             bundle.metrics.snapshot()["counters"]}
        assert c["engine_spec_proposed_total"] == eng.spec_proposed


def test_instrumentation_never_changes_a_token(pair):
    """Both engines, obs on (metrics and trace) vs off: the same tokens;
    the slot engine's counters read its run."""
    _, _, tm, tparams = pair
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, tm.cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]
    for cls, kw in ((tserver.LLMEngine, dict(num_slots=2, cache_max=32)),
                    (tserver.PagedLLMEngine, dict(num_blocks=32, block_size=8,
                                                  max_batch=4, max_len=32,
                                                  spec_decode="ngram"))):
        runs = []
        for obs in (None, tobs.Observability.create(trace=True)):
            eng = cls(tm, tparams, obs=obs, **kw)
            for p in prompts:
                eng.submit(p, max_new=5)
            outs = {}
            while not eng.idle:
                for r in eng.step():
                    outs[r.rid] = list(r.out_tokens)
            runs.append(outs)
        assert runs[0] == runs[1] and len(runs[0]) == 3
        lab = {"engine": eng._engine_kind}
        m = obs.metrics
        assert m.counter("engine_finished_total", labels=lab).value == 3
        assert m.counter("engine_generated_tokens_total",
                         labels=lab).value == 15
        assert m.histogram("request_ttft_seconds").count == 3
        assert tobs.validate_chrome_trace(obs.trace.to_chrome(),
                                          [1, 2, 3]) == []


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 2), min_size=1, max_size=6),
       st.integers(1, 4), st.sampled_from(["sim", "wall"]))
def test_engine_obs_facade_exports_equal_reference(preempts, tokens, mode):
    """The copied facade and recorder on a synthetic lifecycle (preempt
    / resume cycles, spec windows): the same export and page."""
    pages = []
    for pkg in (tobs, jobs):
        bundle = pkg.Observability.create(trace=True, trace_mode=mode)
        eo = pkg.EngineObs(bundle, "paged", replica=1)
        ts = 0.0
        for rid, n in enumerate(preempts, start=1):
            eo.request_queued(rid, ts, prompt_len=8, max_new=tokens)
            eo.admitted(rid, ts + 0.1, resume=False, cached_blocks=1,
                        cow=True)
            eo.prefill_chunk(rid, ts + 0.2, 0, 8)
            for _ in range(n):
                eo.preempted(rid, ts + 0.3, "decode")
                eo.admitted(rid, ts + 0.4, resume=True, cached_blocks=0,
                            cow=False)
            eo.first_token(rid, ts + 0.5, 0.5)
            eo.spec_verify(rid, ts + 0.6, proposed=3, accepted=n,
                           emitted=n + 1, rolled_back=2 - n)
            for t in range(tokens - 1):
                eo.token(rid, ts + 0.7 + t, 0.05 * (t + 1))
            eo.step(ts, 0.004, admitted=1, chunk_tokens=8, decode_batch=n,
                    tokens=tokens, retraced=n == 0, queue_depth=n,
                    active=1, free_blocks=9, pool_occupancy=0.25)
            eo.finished(rid, ts + 9.0, 9.0, tokens)
            ts += 1.0
        pages.append((json.dumps(bundle.trace.to_chrome()),
                      bundle.metrics.render(),
                      json.dumps(bundle.metrics.snapshot())))
    assert pages[0] == pages[1]
