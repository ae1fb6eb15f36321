"""The port's paged serving engine against the reference engine.

On the CPU, with the reference's reduced qwen3-0.6b weights bridged into
the port, ``repro_torch.serving.server.PagedLLMEngine`` must emit exactly
the tokens of ``repro.serving.server.PagedLLMEngine`` on seeded
shared-prefix and bursty workloads under a pool tight enough to preempt,
with the prefix cache on; inside the port, decode fusion on and off must
agree exactly.  Plus the pool edits of ``serving/kvcache.py`` against the
reference's, the stats schema, and the serve CLI.
"""
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving import stats_schema as jschema  # noqa: E402
from repro.serving.loadgen import (bursty_mixed_workload,  # noqa: E402
                                   shared_prefix_workload)
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402
from repro_torch.serving import stats_schema  # noqa: E402
from repro_torch.serving.server import PagedLLMEngine  # noqa: E402

# 9 usable blocks of 4 tokens for up to 8 concurrent requests of up to
# 40 tokens: admission, eviction, copy-on-write and preemption all fire
TIGHT = dict(num_blocks=10, block_size=4, max_batch=8, max_len=40,
             prefix_cache=True)


def _workload(name, vocab):
    """-> (bursts of prompts, bursts of max_new)."""
    if name == "shared_prefix":
        wl = shared_prefix_workload(num_requests=6, prefix_len=10,
                                    suffix_len=7, vocab_size=vocab,
                                    num_prefixes=2, seed=4)
        return [wl.prompts[:3], wl.prompts[3:]], [[8] * 3, [8] * 3]
    wl = bursty_mixed_workload(num_bursts=2, burst_size=4, vocab_size=vocab,
                               min_len=3, max_len=24, max_new=8, seed=5)
    return wl.bursts, wl.burst_news


def _drive(engine, bursts, news, steps_between=3):
    """Submit each burst, step a few times between bursts, drain."""
    outs = {}

    def step():
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)

    for burst, burst_news in zip(bursts, news):
        for p, n in zip(burst, burst_news):
            engine.submit(p, max_new=n)
        for _ in range(steps_between):
            step()
    for _ in range(2000):
        if engine.idle:
            break
        step()
    assert engine.idle
    return outs


@pytest.fixture(scope="module")
def models():
    cfg = reduced_cfg("qwen3-0.6b")
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(get_config("qwen3-0.6b").reduced(), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, tm, tparams


@pytest.fixture(scope="module")
def reference_runs(models):
    """The reference engine's tokens and gauges per workload (its own
    tests hold decode fusion on and off identical)."""
    jm, jparams, _, _ = models
    runs = {}
    for name in ("shared_prefix", "bursty_mixed"):
        eng = JaxEngine(jm, jparams, **TIGHT)
        runs[name] = (_drive(eng, *_workload(name, jm.cfg.vocab_size)),
                      eng.stats())
    return runs


@pytest.mark.parametrize("workload", ["shared_prefix", "bursty_mixed"])
def test_engine_token_identical_to_reference(models, reference_runs,
                                             workload):
    _, _, tm, tparams = models
    ref_outs, ref_stats = reference_runs[workload]
    bursts, news = _workload(workload, tm.cfg.vocab_size)
    ops.reset_launch_counts()
    runs, stats = {}, {}
    for fusion in (True, False):
        eng = PagedLLMEngine(tm, tparams, decode_fusion=fusion, **TIGHT)
        runs[fusion] = _drive(eng, bursts, news)
        s = stats[fusion] = stats_schema.validate(eng.stats())
        jschema.validate(s)                 # the reference's schema too
        assert s["preemptions"] > 0
        assert s["decode_fusion"] == int(fusion)
        assert s["decode_kernel"] == 0      # no kernel runs on the CPU
        assert eng.allocator.num_live == s["cached_blocks"]
    assert ops.launch_counts() == {"conv2d": 0, "conv2d_wgrad": 0,
                                   "flash_attention": 0,
                                   "paged_attention": 0,
                                   "paged_attention_int8": 0,
                                   "paged_prefill": 0,
                                   "paged_prefill_int8": 0,
                                   "rwkv6_scan": 0, "rwkv6_scan_bwd": 0,
                                   "ssm_scan": 0, "ssm_scan_bwd": 0}
    assert runs[True] == ref_outs
    assert runs[False] == ref_outs
    assert len(ref_outs) == sum(len(b) for b in bursts)
    for key in ("preemptions", "admissions", "prefill_tokens", "hit_rate",
                "evictions", "cow_copies", "prefill_compiles"):
        assert stats[True][key] == ref_stats[key], key


def test_decode_kernel_gauge_reads_launches(models):
    """The gauge reports the kernel's launches by this engine's decode
    dispatch: 0 on the CPU, where the decode dispatch runs the plain
    version, and 0 with decode fusion on (the decode dispatch never
    runs)."""
    _, _, tm, tparams = models
    prompt = np.arange(1, 9, dtype=np.int32)
    for fusion in (True, False):
        eng = PagedLLMEngine(tm, tparams, num_blocks=17, block_size=4,
                             max_len=32, decode_fusion=fusion)
        eng.submit(prompt, max_new=4)
        _drive(eng, [], [])
        s = eng.stats()
        assert s["finished"] == 1
        assert s["decode_kernel"] == 0
        assert s["decode_compiles"] == (0 if fusion else 1)


def test_engine_refuses_unported_features(models):
    """What the reference refuses, the port refuses with the same
    ``ValueError``s: speculative decoding under the serial scheduler,
    and ``spec_k`` below 1."""
    jm, jparams, tm, tparams = models
    for kw, match in ((dict(scheduler="serial", spec_decode="ngram"),
                       "continuous"),
                      (dict(spec_decode="ngram", spec_k=0), "spec_k")):
        for cls, m, p in ((PagedLLMEngine, tm, tparams),
                          (JaxEngine, jm, jparams)):
            with pytest.raises(ValueError, match=match):
                cls(m, p, **kw)


# ------------------------------------------------------------ pool edits


def _np_pools(rng):
    shape = (2, 6, 4, 2, 8)
    return {"periods": {"slot0": {
        "k": rng.normal(size=shape).astype(np.float32),
        "v": rng.normal(size=shape).astype(np.float32),
        "pos": rng.integers(-1, 20, size=shape[:3]).astype(np.int32)}},
        "rem": {}}


@pytest.mark.parametrize("edit", ["copy", "invalidate", "lanes", "scrub",
                                  "chunk"])
def test_pool_edits_match_reference(edit):
    rng = np.random.default_rng(9)
    pools = _np_pools(rng)
    jp = jax.tree.map(jnp.asarray, pools)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), pools)
    if edit == "copy":
        jp, tp = (jkv.copy_blocks(jp, [2, 5], [1, 3]),
                  tkv.copy_blocks(tp, [2, 5], [1, 3]))
    elif edit == "invalidate":
        jp, tp = (jkv.invalidate_blocks(jp, [1, 4]),
                  tkv.invalidate_blocks(tp, [1, 4]))
    elif edit == "lanes":
        jp, tp = (jkv.invalidate_lanes(jp, np.array([2, 3]), np.array([1, 3])),
                  tkv.invalidate_lanes(tp, np.array([2, 3]), np.array([1, 3])))
    elif edit == "scrub":
        jp, tp = jkv.scrub_null_block(jp), tkv.scrub_null_block(tp)
    else:
        caches = {"periods": {"slot0": {
            "k": rng.normal(size=(2, 3, 5, 2, 8)).astype(np.float32),
            "v": rng.normal(size=(2, 3, 5, 2, 8)).astype(np.float32),
            "pos": rng.integers(0, 30, size=(2, 3, 5)).astype(np.int32)}},
            "rem": {}}
        idx = [np.array(a, np.int32) for a in
               ([0, 0, 1, 2], [0, 4, 2, 3], [1, 2, 5, 3], [0, 3, 2, 1])]
        jp = jkv.write_chunk_tokens(jp, jax.tree.map(jnp.asarray, caches),
                                    *idx)
        tp = tkv.write_chunk_tokens(
            tp, jax.tree.map(torch.from_numpy, caches), *idx)
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(
            tp["periods"]["slot0"][name].numpy(),
            np.asarray(jp["periods"]["slot0"][name]))


def test_block_allocator_fifo_refcounts():
    ref, ours = jkv.BlockAllocator(6, 4), tkv.BlockAllocator(6, 4)
    for a in (ref, ours):
        got = a.alloc(3)
        a.incref(got[1])
        assert a.free(got) == [got[0], got[2]]
        assert a.alloc(5) is None
        assert a.alloc(2) == [4, 5]
        assert a.alloc(2) == [1, 3]        # released blocks reuse FIFO
        assert (a.num_free, a.num_live, a.num_usable) == (0, 5, 5)
        assert a.blocks_for(0) == 1 and a.blocks_for(9) == 3
    with pytest.raises(ValueError):
        tkv.BlockAllocator(1, 4)


# ------------------------------------------------------------ serve CLI


def _serve(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--requests", "4", "--prompt-len",
                    "12", "--max-new", "5", "--stats-every", "0", *argv])
    return buf.getvalue().splitlines()


def test_serve_cli_fusion_on_off_same_tokens():
    on = _serve("--decode-fusion", "on")
    off = _serve("--decode-fusion", "off")
    req_on = [ln for ln in on if ln.strip().startswith("req ")]
    assert len(req_on) == 3
    assert req_on == [ln for ln in off if ln.strip().startswith("req ")]
    assert on[0].startswith("4 requests, 20 tokens")


@pytest.mark.parametrize("argv", [
    ["--engine", "slot", "--replicas", "2"],
    ["--replicas", "2", "--trace-out", "T"],
    ["--arch", "whisper-tiny"], ["--decode-kernel", "off"],
    ["--arch", "paligemma-3b"],
    ["--engine", "slot", "--affinity", "off", "--replicas", "2"],
    ["--engine", "slot", "--spec-decode", "ngram"],
])
def test_serve_cli_refuses_unported_flags(argv):
    if argv[0] == "--arch":
        # the frontend configs: the reference CLI's refusal, after the
        # config is read
        with pytest.raises(SystemExit, match="text-only decode"):
            _serve(*argv)
        return
    with pytest.raises((SystemExit, KeyError)):
        _serve(*argv)


def _req_lines(lines):
    return [ln for ln in lines if ln.strip().startswith("req ")]


@pytest.mark.parametrize("argv", [
    ["--scheduler", "serial"], ["--spec-decode", "ngram"], ["--metrics"],
    ["--trace-out", "TRACE"], ["--spec-k", "2"], ["--draft-layers", "2"],
    ["--spec-decode", "draft", "--spec-k", "3"],
])
def test_serve_cli_serves_like_the_reference_cli(models, monkeypatch,
                                                tmp_path, argv):
    """The flags the port now carries serve: with the reference's seed-0
    weights bridged in, each argv prints the reference CLI's ``req N:``
    lines for the same argv; ``--metrics`` prints the Prometheus page
    and ``--trace-out`` writes a trace that validates."""
    from repro.launch import serve as jserve
    from repro_torch.obs import validate_chrome_trace

    _, _, _, tparams = models
    argv = [str(tmp_path / "t.json") if a == "TRACE" else a for a in argv]
    build_model = serve.build_model
    monkeypatch.setattr(serve, "build_model",
                        lambda args: build_model(args)[:2] + (tparams,))
    lines = _serve(*argv)
    # the reference writes its own trace, so the port's stays to be read
    ref_argv = [str(tmp_path / "ref.json") if a.endswith("t.json") else a
                for a in argv]
    monkeypatch.setattr("sys.argv", ["serve", "--requests", "4",
                                     "--prompt-len", "12", "--max-new", "5",
                                     "--stats-every", "0", *ref_argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main()
    want = _req_lines(buf.getvalue().splitlines())
    assert len(want) == 3
    assert _req_lines(lines) == want
    assert lines[0].startswith("4 requests, 20 tokens")
    if "--metrics" in argv:
        assert "engine_requests_total{engine=\"paged\"} 4" in lines
    if "--trace-out" in argv:
        import json

        def events(path):
            with open(path) as f:
                trace = json.load(f)
            return trace, [(ev["name"], ev["ph"], ev["pid"], ev["tid"])
                           for ev in trace["traceEvents"]]

        trace, got = events(argv[-1])
        assert validate_chrome_trace(trace, [1, 2, 3, 4]) == []
        # wall-clock traces: the same events for the same requests, in
        # the same order, as the reference CLI's
        assert got == events(ref_argv[-1])[1]


def _reference_cli(monkeypatch, argv):
    """The reference CLI's stdout lines for ``argv`` (after ``_serve``'s
    defaults, less ``--device``)."""
    from repro.launch import serve as jserve

    monkeypatch.setattr("sys.argv", ["serve", "--requests", "4",
                                     "--prompt-len", "12", "--max-new", "5",
                                     "--stats-every", "0", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jserve.main()
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("affinity", ["on", "off"])
def test_serve_cli_cluster_serves_like_the_reference_cli(models, monkeypatch,
                                                         affinity):
    """``--replicas 2`` at ``--device cpu``, the reference's seed-0 weights
    bridged in: the ``[cluster]`` line, the ``[lb]`` line with each
    replica's gauges, and the ``req N: ... rM via ...`` routing tags equal
    the reference CLI's for the same argv.  A 32-token prompt gives a
    16-token tenant prefix, one whole block, so affinity on routes by it
    (hits > 0)."""
    _, _, _, tparams = models
    build_model = serve.build_model
    monkeypatch.setattr(serve, "build_model",
                        lambda args: build_model(args)[:2] + (tparams,))
    argv = ["--replicas", "2", "--affinity", affinity, "--requests", "8",
            "--prompt-len", "32"]
    lines = _serve(*argv)
    want = _reference_cli(monkeypatch, argv)
    assert lines[0].startswith("8 requests (0 rejected 429), 40 tokens")
    assert "replicas=2, device=cpu)" in lines[0]
    assert lines[1:] == want[1:]
    assert lines[1].startswith(f"[cluster] replicas=2 affinity={affinity}")
    hits = int(lines[1].split("hits=")[1].split()[0])
    assert (hits > 0) == (affinity == "on")
    tags = [ln.split("tokens")[1] for ln in _req_lines(lines)]
    assert len(tags) == 3 and all(" via " in t for t in tags)


@pytest.mark.parametrize("argv", [
    ["--replicas", "2", "--engine", "slot"],
    ["--replicas", "2", "--trace-out", "T"],
])
def test_serve_cli_cluster_refusals_are_the_reference_clis(monkeypatch,
                                                           tmp_path, argv):
    argv = [str(tmp_path / "t.json") if a == "T" else a for a in argv]
    with pytest.raises(SystemExit) as ours:
        _serve(*argv)
    with pytest.raises(SystemExit) as theirs:
        _reference_cli(monkeypatch, argv)
    assert str(ours.value) == str(theirs.value)
    assert "--replicas needs the paged engine" in str(ours.value) or \
        "--trace-out is per-engine" in str(ours.value)


@pytest.mark.parametrize("argv", [["--engine", "slot"], ["--slots", "2"]])
def test_serve_cli_slot_flags_serve(argv):
    """The slot engine serves (``--slots`` sizes it; the paged engine, the
    default, ignores it, as in the reference) with the paged engine's
    tokens."""
    lines = _serve(*argv)
    assert lines[0].startswith("4 requests, 20 tokens")
    assert f"engine={'slot' if '--engine' in argv else 'paged'}" in lines[0]
    req = [ln for ln in lines if ln.strip().startswith("req ")]
    assert len(req) == 3
    assert req == [ln for ln in _serve() if ln.strip().startswith("req ")]


def test_serve_cli_reduced_flag():
    ap = serve.make_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args([]).device == "cuda"
    # --engine resolves to paged where the stack pages, as in the
    # reference CLI: every stack the port carries
    args = ap.parse_args(["--device", "cpu", "--arch", "rwkv6-1.6b"])
    assert args.engine is None
    serve.build_model(args)
    assert args.engine == "paged"
