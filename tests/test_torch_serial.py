"""The port's serial scheduler against the reference's.

Reduced qwen3-0.6b in float32 on the CPU, the reference's parameters
bridged into the port.  ``PagedLLMEngine(scheduler="serial")`` admits at
most the queue's head a step, prefills its whole prompt in one chunk,
and decodes (in the separate decode dispatch) only on steps that
prefilled nothing.  It must emit exactly the reference's serial tokens
and the port's continuous tokens, on the mixed-length workload and on
the prefix-cache case of ``tests/test_continuous_batching.py``, with the
reference's gauges and one admission per step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving import stats_schema as jschema  # noqa: E402
from repro.serving.loadgen import mixed_length_workload  # noqa: E402
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import stats_schema  # noqa: E402
from repro_torch.serving.server import PagedLLMEngine  # noqa: E402

GAUGES = ("admissions", "preemptions", "prefill_tokens", "prefill_compiles",
          "decode_compiles", "decode_kernel", "decode_fusion", "hit_rate",
          "cached_blocks", "cow_copies", "peak_active", "spec_decode",
          "spec_k")


@pytest.fixture(scope="module")
def pair():
    cfg = reduced_cfg("qwen3-0.6b")
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, Model(get_config("qwen3-0.6b").reduced(),
                              device="cpu"), tparams


def _drive(cls, model, params, prompts, max_news, **kw):
    """-> (engine, {rid: tokens}, admissions made in each step)."""
    engine = cls(model, params, num_blocks=64, block_size=8, max_batch=8,
                 max_len=96, **kw)
    for p, n in zip(prompts, max_news):
        engine.submit(p, max_new=n)
    outs, per_step = {}, []
    for _ in range(2000):
        before = engine.admissions
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
        per_step.append(engine.admissions - before)
        if engine.idle:
            break
    assert engine.idle
    return engine, outs, per_step


def _workload(name, vocab):
    """-> (prompts, max_news, engine kwargs)."""
    if name == "mixed_length":
        wl = mixed_length_workload(num_requests=8, vocab_size=vocab,
                                   max_len=60, seed=4)
        return wl.prompts, wl.max_news, {}
    rng = np.random.default_rng(7)
    prefix = rng.integers(1, vocab, 24).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(1, vocab, 3 + i)
                               .astype(np.int32)]) for i in range(5)]
    return prompts, [6] * 5, dict(prefix_cache=True)


@pytest.mark.parametrize("name", ["mixed_length", "prefix_cache"])
def test_serial_matches_reference_and_continuous(pair, name):
    jm, jparams, tm, tparams = pair
    prompts, news, kw = _workload(name, tm.cfg.vocab_size)
    eng, serial, per_step = _drive(PagedLLMEngine, tm, tparams, prompts,
                                   news, scheduler="serial", **kw)
    ref, ref_serial, ref_per_step = _drive(JaxEngine, jm, jparams, prompts,
                                           news, scheduler="serial", **kw)
    _, cont, _ = _drive(PagedLLMEngine, tm, tparams, prompts, news,
                        prefill_chunk=8, **kw)
    assert serial == ref_serial
    assert cont == serial
    assert len(serial) == len(prompts)
    # one admission a step at most, in the reference's steps
    assert max(per_step) == 1 and per_step == ref_per_step
    s = stats_schema.validate(eng.stats())
    jschema.validate(s)
    ref_s = ref.stats()
    for key in GAUGES:
        assert s[key] == ref_s[key], key
    assert s["decode_fusion"] == 0 and s["decode_compiles"] == 1
    assert s["decode_kernel"] == 0          # no kernel runs on the CPU
    if name == "prefix_cache":
        assert s["hit_rate"] > 0
    assert eng.allocator.num_live == s["cached_blocks"]


def test_serial_prefill_and_decode_never_share_a_step(pair):
    """A step that prefilled does not decode: a decoding request gains
    no token on a step that admitted another."""
    _, _, tm, tparams = pair
    rng = np.random.default_rng(3)
    eng = PagedLLMEngine(tm, tparams, num_blocks=64, block_size=8,
                         max_batch=8, max_len=96, scheduler="serial")
    eng.submit(rng.integers(1, tm.cfg.vocab_size, 10).astype(np.int32),
               max_new=8)
    eng.step()                               # admit + prefill rid 1
    assert len(eng.active) == 1
    (req,) = eng.active.values()
    assert len(req.out_tokens) == 1
    eng.submit(rng.integers(1, tm.cfg.vocab_size, 30).astype(np.int32),
               max_new=4)
    eng.step()                               # prefills rid 2 whole
    assert eng.prefill_tokens == 40 and len(req.out_tokens) == 1
    eng.step()                               # decodes both
    assert len(req.out_tokens) == 2
    assert [len(r.out_tokens) for r in eng.active.values()] == [2, 2]


def test_engine_refuses_what_the_reference_refuses(pair):
    _, _, tm, tparams = pair
    with pytest.raises(ValueError, match="scheduler"):
        PagedLLMEngine(tm, tparams, scheduler="fifo")
    with pytest.raises(ValueError, match="continuous"):
        PagedLLMEngine(tm, tparams, scheduler="serial", spec_decode="ngram")
    with pytest.raises(ValueError, match="spec_k"):
        PagedLLMEngine(tm, tparams, spec_decode="ngram", spec_k=0)
    with pytest.raises(ValueError, match="spec_decode"):
        PagedLLMEngine(tm, tparams, spec_decode="beam")
    with pytest.raises(ValueError, match="draft_model"):
        PagedLLMEngine(tm, tparams, spec_decode="draft")
