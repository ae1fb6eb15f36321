"""The port's rwkv6 layer kind and WKV6 scan against the reference.

On the CPU, the same numpy inputs go through the reference (JAX) and the
port (``repro_torch``), whose ``ops.rwkv6_scan`` takes its plain version
``ref.rwkv6_scan_ref`` for CPU tensors:

* the plain scan against the reference's jnp oracle over the reference's
  sweep (``tests/test_kernels.py``: shapes, mild and extreme decay, a
  start state): ``rtol=1e-5`` and ``atol`` 1e-6 of the largest output.
  Both are sequential float32 scans and only the order of each step's
  64-term sums differs, but the sweep's outputs reach ~130 (decay 0.95
  keeps ~20 steps of N(0,1) products in the state), where one float32
  ulp is ~8e-6, so an absolute limit must scale with them;
* the same inputs against the Pallas kernel in interpret mode, with that
  sweep's own limits, ``atol=5e-3, rtol=1e-2`` (they hold the chunked
  log-form to the sequential scan);
* the time-mix, one block, ``Model.prefill`` plus decode steps, and the
  slot engine on reduced rwkv6-1.6b (2 layers, d_model 256, 4 heads of
  64) with the reference's weights bridged into the port.  The
  reference's init leaves ``u``, ``mu``, ``mix_b``, ``w_base``, ``w_b``
  and ``mu_k`` at zero, which silences the bonus term and makes the
  decay a constant; ``_perturbed`` draws them from a seed first.
  Tolerance ``atol=rtol=1e-4``: float32 on both sides, where summation
  order moves activations of magnitude ~1 by ~1e-6 per layer, while a
  wrong shift, mix or decay moves them by >1e-2.  The engine must emit
  the reference engine's tokens exactly.
* the masked time-mix (right-padded rows with per-row ``seq_len``, the
  paged engine's ragged chunks) against the reference's masked scan;
  the paged engine and the serve CLI's default (paged) route serve
  rwkv6 with the slot engine's tokens, and refuse speculative decoding
  as the reference does (tests/test_torch_hybrid.py holds the paged
  path to the reference's).
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
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving import stats_schema as jschema  # noqa: E402
from repro.serving.loadgen import mixed_length_workload  # noqa: E402
from repro.serving.server import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.server import PagedLLMEngine as JaxPagedEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import stats_schema  # noqa: E402
from repro_torch.serving.server import LLMEngine, PagedLLMEngine  # noqa: E402

SCAN_RTOL = 1e-5
SCAN_ATOL_OF_MAX = 1e-6          # a few float32 ulps of the largest value
PALLAS_TOL = dict(atol=5e-3, rtol=1e-2)
TOL = dict(atol=1e-4, rtol=1e-4)
ZERO_INIT = ("u", "mu", "mix_b", "w_base", "w_b", "mu_k")


# ------------------------------------------------------------ the scan


def scan_case(shape, extreme_decay, seed=0):
    """The reference sweep's inputs (tests/test_kernels.py), from numpy:
    N(0,1) r/k/v, decay 0.95 or exp(-exp(2 N(0,1))), u and s0 at 0.1."""
    b, h, s, hd = shape
    rng = np.random.default_rng(seed + sum(shape) + int(extreme_decay))
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    if extreme_decay:
        w = np.exp(-np.exp(rng.normal(size=shape) * 2)).astype(np.float32)
    else:
        w = np.full(shape, 0.95, np.float32)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(b, h, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


SCAN_SHAPES = [(1, 1, 16, 8), (2, 3, 50, 64), (1, 2, 128, 64)]


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("extreme_decay", [False, True])
def test_rwkv6_scan_plain_matches_reference(shape, extreme_decay):
    from repro.kernels import ref as jref
    args = scan_case(shape, extreme_decay)
    out, sf = ref.rwkv6_scan_ref(*map(torch.from_numpy, args))
    eo, es = jref.rwkv6_scan_ref(*map(jnp.asarray, args))
    assert out.shape == shape and sf.shape == shape[:2] + shape[-1:] * 2
    for ours, theirs in ((out, eo), (sf, es)):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(
            ours.numpy(), theirs, rtol=SCAN_RTOL,
            atol=SCAN_ATOL_OF_MAX * np.abs(theirs).max())


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("extreme_decay", [False, True])
def test_rwkv6_scan_plain_matches_pallas_interpret(shape, extreme_decay):
    from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_scan
    args = scan_case(shape, extreme_decay)
    out, sf = ops.rwkv6_scan(*map(torch.from_numpy, args))
    po, ps = pallas_scan(*map(jnp.asarray, args), interpret=True)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(po), **PALLAS_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(ps), **PALLAS_TOL)


def test_rwkv6_scan_state_chaining():
    """Two halves, the second from the first's final state, equal one
    run; no s0 means a zero state."""
    r, k, v, w, u, _ = map(torch.from_numpy,
                           scan_case((1, 2, 64, 32), True, seed=3))
    full, sf = ops.rwkv6_scan(r, k, v, w, u)
    h1, s1 = ops.rwkv6_scan(r[:, :, :29], k[:, :, :29], v[:, :, :29],
                            w[:, :, :29], u, torch.zeros_like(sf))
    h2, s2 = ops.rwkv6_scan(r[:, :, 29:], k[:, :, 29:], v[:, :, 29:],
                            w[:, :, 29:], u, s1)
    torch.testing.assert_close(torch.cat([h1, h2], 2), full)
    torch.testing.assert_close(s2, sf)


def test_rwkv6_scan_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels import rwkv6_scan as rw_mod
    args = list(map(torch.from_numpy, scan_case((1, 2, 5, 8), False)))
    before = ops.launch_counts()
    out, sf = ops.rwkv6_scan(*args)
    expect = ref.rwkv6_scan_ref(*args)
    assert torch.equal(out, expect[0]) and torch.equal(sf, expect[1])
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        rw_mod.rwkv6_scan(*args)


# ------------------------------------------------------------ the model


def _perturbed(tree, seed):
    """The reference's zero-initialised rwkv6 leaves drawn from ``seed``:
    mixing coefficients in [0, 1), decay bases N(0, 1) (per-channel
    decays from ~0.69 to ~0.998), bonus N(0, 0.5), LoRA outputs
    N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    draw = {"mu": lambda s: rng.uniform(0, 1, s),
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


@pytest.fixture(scope="module")
def pair():
    cfg = reduced_cfg("rwkv6-1.6b")
    jm = JaxModel(cfg)
    np_params = _perturbed(jax.tree.map(np.asarray,
                                        jm.init(jax.random.PRNGKey(0))), 1)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tm = Model(get_config("rwkv6-1.6b").reduced(), device="cpu")
    return jm, jparams, tm, params_from_jax(np_params, device="cpu")


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree["stack"]["periods"]["slot0"])


def _tlayer(tree, i):
    def index(node):
        return {k: index(v) if isinstance(v, dict) else v[i]
                for k, v in node.items()}
    return index(tree["stack"]["periods"]["slot0"])


def _state(cfg, rng, b):
    h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"s": (rng.normal(size=(b, h, hd, hd)) * 0.3).astype(np.float32),
            "x_tm": rng.normal(size=(b, cfg.d_model)).astype(np.float32),
            "x_cm": rng.normal(size=(b, cfg.d_model)).astype(np.float32)}


def _check(ours, theirs, tol=TOL):
    ours = jax.tree.map(lambda t: t.numpy(), ours)
    assert jax.tree.structure(ours) == jax.tree.structure(
        jax.tree.map(np.asarray, theirs))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def test_config_and_schema_match_reference(pair):
    jm, jparams, tm, _ = pair
    assert dataclasses.asdict(get_config("rwkv6-1.6b")) == \
        dataclasses.asdict(jax_get_config("rwkv6-1.6b"))
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    ours = tm.init(seed=0)
    assert jax.tree.map(lambda t: tuple(t.shape), ours) == \
        jax.tree.map(lambda a: tuple(a.shape), jparams)
    for k in ZERO_INIT:
        leaf = ours["stack"]["periods"]["slot0"]["mix" if k != "mu_k"
                                                 else "ffn"][k]
        assert not leaf.any(), k           # the reference's zero init
    assert torch.all(ours["final_norm"]["bias"] == 0)


def test_time_mix_matches_reference(pair):
    jm, jparams, _, tparams = pair
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    st = _state(cfg, rng, 2)
    jy, jst = jrwkv.rwkv_time_mix(_layer(jparams, 1)["mix"], cfg,
                                  jnp.asarray(x),
                                  jax.tree.map(jnp.asarray, st))
    ty, tst = trwkv.rwkv_time_mix(_tlayer(tparams, 1)["mix"], cfg,
                                  torch.from_numpy(x),
                                  jax.tree.map(torch.from_numpy, st))
    _check({"y": ty, **tst}, {"y": jy, **jst})
    # the perturbed leaves are live: the bonus and the decay's LoRA move y
    flat = _tlayer(tparams, 1)["mix"]
    for leaf in ("u", "w_b"):
        zeroed = {**flat, leaf: torch.zeros_like(flat[leaf])}
        y0, _ = trwkv.rwkv_time_mix(zeroed, cfg, torch.from_numpy(x),
                                    jax.tree.map(torch.from_numpy, st))
        assert (y0 - ty).abs().max() > 1e-2, leaf
    # the masked route: rows of 7 and 3 valid lanes (decay 1 and key 0
    # past them in the port, the reference's frozen scan)
    sl = np.array([7, 3], np.int32)
    jy, jst = jrwkv.rwkv_time_mix(_layer(jparams, 1)["mix"], cfg,
                                  jnp.asarray(x),
                                  jax.tree.map(jnp.asarray, st),
                                  seq_len=jnp.asarray(sl))
    ty, tst = trwkv.rwkv_time_mix(flat, cfg, torch.from_numpy(x),
                                  jax.tree.map(torch.from_numpy, st),
                                  seq_len=torch.from_numpy(sl))
    _check(tst, jst)
    _check(ty[1, :3], jy[1, :3])
    _check(ty[0], jy[0])


def test_block_prefill_and_decode_match_reference(pair):
    """One block from zero state over a prompt (``block_prefill``) and
    from a given state (``block_decode``, written in place)."""
    jm, jparams, _, tparams = pair
    cfg = jm.cfg
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    jx, _, jc = jtf.block_prefill(_layer(jparams, 0), cfg, jnp.asarray(x),
                                  jnp.arange(9), kind="rwkv6", moe=False,
                                  cache_max=16)
    tx, tc = ttf.block_prefill(_tlayer(tparams, 0), cfg, torch.from_numpy(x),
                               torch.arange(9), kind="rwkv6", cache_max=16)
    _check({"x": tx, **tc}, {"x": jx, **jc})

    st = _state(cfg, rng, 2)
    x1 = x[:, :1]
    jx, jc = jtf.block_decode(_layer(jparams, 0), cfg, jnp.asarray(x1),
                              jax.tree.map(jnp.asarray, st), jnp.zeros(2),
                              kind="rwkv6", moe=False)
    cache = jax.tree.map(torch.from_numpy, st)
    tx, tc = ttf.block_decode(_tlayer(tparams, 0), cfg, torch.from_numpy(x1),
                              cache, torch.zeros(2), kind="rwkv6")
    assert tc is cache
    _check({"x": tx, **cache}, {"x": jx, **jc})


def test_cache_init_layout_matches_reference(pair):
    jm, _, tm, _ = pair
    ours = tm.cache_init(3, 16)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]),
                        ours) == \
        jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                     jm.cache_abstract(3, 16))
    assert not any(t.any() for t in jax.tree.leaves(ours))


def test_prefill_and_decode_steps_match_reference(pair):
    """``Model.prefill`` of two 13-token prompts, then 3 ``decode_step``s
    fed the greedy tokens: logits and states agree at every step."""
    jm, jparams, tm, tparams = pair
    toks = np.random.default_rng(0).integers(
        1, jm.cfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                        cache_max=32)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        cache_max=32)
    assert tl.shape == (2, 1, jm.cfg.vocab_size)
    _check(tl, jl)
    _check(tc, jc)
    for step in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        pos = np.full((2,), 13 + step, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(nxt),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(nxt),
                                torch.from_numpy(pos))
        _check(tl, jl)
    _check(tc, jc)


# ------------------------------------------------------------ engines


def _workload(vocab):
    """10 mixed-length requests (4-24 prompt tokens) for 4 slots: slots
    are reused, and the longest requests reach their strip's end."""
    return mixed_length_workload(num_requests=10, vocab_size=vocab,
                                 min_len=4, max_len=24, median_len=10.0,
                                 max_new=10, seed=8)


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


def test_slot_engine_token_identical_to_reference(pair):
    jm, jparams, tm, tparams = pair
    wl = _workload(jm.cfg.vocab_size)
    ref_eng = JaxLLMEngine(jm, jparams, num_slots=4, cache_max=30)
    ref_outs = _drain(ref_eng, wl)
    ops.reset_launch_counts()
    eng = LLMEngine(tm, tparams, num_slots=4, cache_max=30)
    outs = _drain(eng, wl)
    assert ops.launch_counts()["rwkv6_scan"] == 0      # CPU: plain version
    assert outs == ref_outs
    assert len(outs) == len(wl.prompts)
    # some request stopped at a full strip (pos + 1 >= cache_max)
    assert any(len(t) < n for t, n in zip(outs.values(), wl.max_news))
    stats = stats_schema.validate(eng.stats())
    jschema.validate(stats)
    assert stats == ref_eng.stats()


def test_paged_path_refuses_recurrent_stacks(pair):
    """The paged path serves recurrent stacks through state slots, and
    refuses what they cannot do, as the reference does: speculative
    decoding (no roll-back of recurrent state); the prefix cache is
    forced off."""
    jm, jparams, tm, tparams = pair
    assert tm.supports_paged and tm.paged_has_state
    for m, p, cls in ((tm, tparams, PagedLLMEngine),
                      (jm, jparams, JaxPagedEngine)):
        with pytest.raises(ValueError, match="cannot roll back"):
            cls(m, p, num_blocks=8, block_size=4, spec_decode="ngram")
    pools = tm.pool_init(8, 4, state_batch=3)
    assert pools["periods"]["slot0"]["s"].shape[:2] == (2, 3)
    eng = PagedLLMEngine(tm, tparams, num_blocks=8, block_size=4,
                         prefix_cache=True)
    assert eng.prefix_cache is None and eng.live_window == 1
    assert eng.stats()["prefix_cache"] == 0
    qwen = Model(get_config("qwen3-0.6b").reduced(), device="cpu")
    assert qwen.supports_paged and not qwen.paged_has_state


def _serve(*argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", "--arch", "rwkv6-1.6b", "--requests",
                    "5", "--prompt-len", "12", "--max-new", "4",
                    "--stats-every", "0", *argv])
    return buf.getvalue().splitlines()


def test_serve_cli_rwkv6_slot_serves_paged_refuses():
    """The slot engine and the default paged engine serve rwkv6 with the
    same tokens; the paged route refuses speculative decoding."""
    lines = _serve("--engine", "slot", "--slots", "2")
    assert lines[0].startswith("5 requests, 20 tokens")
    assert "engine=slot" in lines[0]
    paged = _serve()
    assert "engine=paged" in paged[0]

    def reqs(ls):
        return [ln for ln in ls if ln.strip().startswith("req ")]

    assert len(reqs(paged)) == 3 and reqs(paged) == reqs(lines)
    with pytest.raises(ValueError, match="cannot roll back"):
        _serve("--spec-decode", "ngram")
