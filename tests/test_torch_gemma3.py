"""gemma3-4b in the port, against the reference.

gemma3-4b mixes sliding-window (``attn_local``: window 1,024, RoPE base
10k) and global (``attn``: base 1M) layers 5:1, with a GeGLU MLP,
qk-norm, head_dim 256 and a tied vocabulary.  On the CPU, reduced
(``reduced()``: 2 layers ``("attn_local", "attn")``, window 32, head_dim
64, float32) and the same at gemma3's real head width (``head_dim=256``),
the reference's parameters bridged into the port:

* ``mlp_apply``'s GeGLU against the reference's (``jax.nn.gelu`` is the
  tanh form), ``atol=rtol=1e-5``;
* each attention entry at ``attn_local`` (whole-prompt prefill past the
  window, slot decode after the 32-lane ring wraps, paged prefill and
  decode past the window) against the reference's function, and the
  model's slot and paged paths, ``atol=rtol=1e-4`` (float32 on both
  sides: summation order moves logits of magnitude ~1 by ~1e-6, while a
  wrong window, RoPE base or ring lane moves them by >1e-2);
* the paged engine (decode fusion on and off, under a pool of 10 blocks
  that preempts), the slot engine and n-gram speculation emit the
  reference engines' tokens, and the serve CLI's ``--arch gemma3-4b``
  prints the reference CLI's ``req N:`` lines.
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving.server import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import stats_schema  # noqa: E402
from repro_torch.serving.server import LLMEngine, PagedLLMEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
HEAD_DIMS = (64, 256)
# the reference's config-matrix pool for gemma3 (tests/test_config_matrix
# .py): 9 usable blocks of 4 for 4 requests of 12 + 12 tokens
TIGHT = dict(num_blocks=10, block_size=4, max_batch=8, max_len=64)

_PAIRS = {}


def configs(hd):
    """-> (reference config, port config), reduced, at head_dim ``hd``."""
    cfg, port = reduced_cfg("gemma3-4b"), get_config("gemma3-4b").reduced()
    if hd != cfg.head_dim:
        cfg = dataclasses.replace(cfg, head_dim=hd)
        port = dataclasses.replace(port, head_dim=hd)
    return cfg, port


def pair(hd=64):
    """-> (reference model, its params, port model, bridged params)."""
    if hd not in _PAIRS:
        cfg, port = configs(hd)
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
        jm = JaxModel(cfg)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        _PAIRS[hd] = (jm, jax.tree.map(jnp.asarray, tree),
                      Model(port, device="cpu"),
                      params_from_jax(tree, device="cpu"))
    return _PAIRS[hd]


def test_config_is_the_reference_config():
    full = get_config("gemma3-4b")
    assert dataclasses.asdict(full) == \
        dataclasses.asdict(jax_get_config("gemma3-4b"))
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(reduced_cfg("gemma3-4b"))
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size) == \
        (34, 2560, 8, 4, 256, 10_240, 262_144)
    assert full.kinds_for_layers.count("attn") == 5      # layers 5, 11, ...
    assert full.reduced().layer_kinds == ("attn_local", "attn")
    assert full.reduced().sliding_window == 32


def test_bridge_carries_the_whole_tree():
    """GeGLU's three matrices, the qk-norm scales and the tied embedding
    (no ``unembed``) cross ``params_from_jax`` with every value."""
    jm, jparams, tm, tparams = pair()
    ref = jax.tree.map(np.asarray, jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), tparams) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), tm.init(seed=0)) == \
        jax.tree.map(lambda a: tuple(a.shape), ref)
    assert "unembed" not in tparams["embed"]
    for j in ("slot0", "slot1"):
        layer = tparams["stack"]["periods"][j]
        assert set(layer["ffn"]) == {"gate", "up", "down"}
        assert {"q_norm", "k_norm"} <= set(layer["mix"])
    jax.tree.map(lambda t, a: np.testing.assert_array_equal(t.numpy(), a),
                 tparams, ref)


@pytest.mark.parametrize("shape", [(2, 7, 256, 512), (1, 3, 64, 96)])
def test_geglu_mlp_matches_reference(shape):
    b, s, d, f = shape
    rng = np.random.default_rng(0)
    p = {"gate": rng.normal(size=(d, f)) * d ** -0.5,
         "up": rng.normal(size=(d, f)) * d ** -0.5,
         "down": rng.normal(size=(f, d)) * f ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(b, s, d)).astype(np.float32) * 2
    want = np.asarray(jlayers.mlp_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "geglu"))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)
    got = tlayers.mlp_apply(tp, tx, "geglu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # the erf form is another function: it would fail this comparison
    erf = (torch.nn.functional.gelu(tx @ tp["gate"]) * (tx @ tp["up"])) \
        @ tp["down"]
    assert np.abs(erf.numpy() - want).max() > 1e-4
    # the plain gelu MLP (whisper's, no gate) is ported too; a kind the
    # reference does not have is refused
    plain = {k: p[k] for k in ("up", "down")}
    want = np.asarray(jlayers.mlp_apply(
        {k: jnp.asarray(v) for k, v in plain.items()}, jnp.asarray(x),
        "gelu"))
    got = tlayers.mlp_apply({k: tp[k] for k in plain}, tx, "gelu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="relu"):
        tlayers.mlp_apply({}, tx, "relu")


# ------------------------------------------------------------ attention


def _layer(hd, slot):
    """The reference's and the port's attention params of one layer."""
    jm, jparams, tm, tparams = pair(hd)
    jl = jax.tree.map(lambda a: a[0],
                      jparams["stack"]["periods"][slot]["mix"])
    tl = {k: v[0] for k, v in tparams["stack"]["periods"][slot]["mix"]
          .items()}
    return jm.cfg, jl, tl


def _x(rng, cfg, *shape):
    return rng.normal(size=(*shape, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_local_slot_attention_matches_reference(hd):
    """``attn_prefill`` of a 50-token prompt into a 32-lane ring (the last
    32 positions, ring-aligned), then 40 ``attn_decode`` steps, which
    wrap the ring past lane 31: outputs and every strip agree."""
    cfg, jl, tl = _layer(hd, "slot0")
    rng = np.random.default_rng(1)
    x = _x(rng, cfg, 2, 50)
    pos = np.arange(50, dtype=np.int32)
    jy, jc = jattn.attn_prefill(jl, cfg, jnp.asarray(x), jnp.asarray(pos),
                                kind="attn_local", cache_max=96)
    ty, tc = tattn.attn_prefill(tl, cfg, torch.from_numpy(x),
                                torch.from_numpy(pos), kind="attn_local",
                                cache_max=96)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert tc["k"].shape[1] == cfg.sliding_window == 32
    for step in range(40):
        xs = _x(rng, cfg, 2, 1)
        p = np.array([50 + step, 50 + step], np.int32)
        jy, jc = jattn.attn_decode(jl, cfg, jnp.asarray(xs), jc,
                                   jnp.asarray(p), kind="attn_local")
        ty, tc = tattn.attn_decode(tl, cfg, torch.from_numpy(xs), tc,
                                   torch.from_numpy(p), kind="attn_local")
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert tc["pos"].numpy().min() == 90 - 32 and \
        tc["pos"].numpy()[0, 89 % 32] == 89
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def _pool(rng, cfg, nb, bs, lanes):
    """A random K/V pool whose pos lanes hold {(block, lane): position},
    every other lane -1."""
    shape = (nb, bs, cfg.num_kv_heads, cfg.resolved_head_dim)
    pos = np.full((nb, bs), -1, np.int32)
    for (blk, lane), p in lanes.items():
        pos[blk, lane] = p
    return {"k": rng.normal(size=shape).astype(np.float32),
            "v": rng.normal(size=shape).astype(np.float32), "pos": pos}


def _both(pool):
    return ({k: jnp.asarray(v) for k, v in pool.items()},
            {k: torch.from_numpy(v.copy()) for k, v in pool.items()})


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("kind", ["attn_local", "attn"])
def test_paged_attention_past_the_window_matches_reference(hd, kind):
    """``attn_prefill_paged``: rows whose chunks start at positions 0, 20,
    45 and 70 over prefixes in blocks of 8 (the local band cuts keys 32
    back); ``attn_decode_paged`` at positions 47 and 75 over active and
    inactive rows: outputs, the chunk cache and the pool writes agree."""
    cfg, jl, tl = _layer(hd, "slot0" if kind == "attn_local" else "slot1")
    rng = np.random.default_rng(2)
    bs, nb_pool = 8, 40
    starts = np.array([0, 20, 45, 70], np.int32)
    seq_len = np.array([16, 9, 16, 1], np.int32)
    bt = np.zeros((4, 11), np.int32)
    free = iter(range(1, nb_pool))
    lanes = {}
    for i, (st, n) in enumerate(zip(starts, seq_len)):
        for lb in range(-(-(st + n) // bs)):
            bt[i, lb] = next(free)
        for p in range(st):
            lanes[(int(bt[i, p // bs]), p % bs)] = p
    x = _x(rng, cfg, 4, 16)
    positions = starts[:, None] + np.arange(16, dtype=np.int32)
    jp, tp = _both(_pool(rng, cfg, nb_pool, bs, lanes))
    jy, jc = jattn.attn_prefill_paged(
        jl, cfg, jnp.asarray(x), jnp.asarray(positions), jp,
        jnp.asarray(bt), jnp.asarray(starts), kind=kind, cache_max=16,
        seq_len=jnp.asarray(seq_len))
    ty, tc = tattn.attn_prefill_paged(
        tl, cfg, torch.from_numpy(x), torch.from_numpy(positions), tp,
        torch.from_numpy(bt), torch.from_numpy(starts), kind=kind,
        seq_len=torch.from_numpy(seq_len))
    valid = np.arange(16)[None, :] < seq_len[:, None]
    np.testing.assert_allclose(ty.numpy()[valid], np.asarray(jy)[valid],
                               **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy()[valid],
                                   np.asarray(jc[name])[:, :16][valid],
                                   **TOL)

    pos = np.array([47, 0, 75, 0], np.int32)
    active = np.array([True, False, True, False])
    bt = np.zeros((4, 10), np.int32)
    lanes = {}
    for i in (0, 2):
        for lb in range(pos[i] // bs + 1):
            bt[i, lb] = next(free) if i == 0 else nb_pool - 1 - lb
        for p in range(pos[i]):
            lanes[(int(bt[i, p // bs]), p % bs)] = p
    jp, tp = _both(_pool(rng, cfg, nb_pool, bs, lanes))
    xs = _x(rng, cfg, 4, 1)
    jy, jp = jattn.attn_decode_paged(
        jl, cfg, jnp.asarray(xs), jp, jnp.asarray(bt), jnp.asarray(pos),
        jnp.asarray(active), kind=kind)
    ty = tattn.attn_decode_paged(tl, cfg, torch.from_numpy(xs), tp,
                                 torch.from_numpy(bt), torch.from_numpy(pos),
                                 torch.from_numpy(active), kind=kind)
    np.testing.assert_allclose(ty.numpy()[active], np.asarray(jy)[active],
                               **TOL)
    np.testing.assert_array_equal(tp["pos"].numpy(), np.asarray(jp["pos"]))
    for name in ("k", "v"):      # block 0 takes the inactive rows' payloads
        np.testing.assert_allclose(tp[name].numpy()[1:],
                                   np.asarray(jp[name])[1:], **TOL)


# ------------------------------------------------------------ the model


def _stack_pools(rng, cfg, nb, bs, lanes):
    """Pools of the reduced stack (one period of the two layers)."""
    return {"periods": {f"slot{j}": {k: v[None] for k, v in
                                     _pool(rng, cfg, nb, bs, lanes).items()}
                        for j in range(2)}, "rem": {}}


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_slot_path_matches_reference(hd):
    """Two 50-token prompts (past the 32-token window) prefilled whole,
    then 40 decode steps (the local ring wraps; the global strip of 96
    lanes does not): logits agree at every step."""
    jm, jparams, tm, tparams = pair(hd)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jm.cfg.vocab_size, (2, 50)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_max=96)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        cache_max=96)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for step in range(40):
        st = rng.integers(1, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
        pos = np.full(2, 50 + step, np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(st),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(st),
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_paged_path_matches_reference(hd):
    """One ragged dispatch (per-row cursors at 0, 40 and 70 over cached
    prefixes, a padding row) with every lane's logits, then one decode
    step at positions 56 and 86: logits and the pools' writes agree."""
    jm, jparams, tm, tparams = pair(hd)
    cfg = jm.cfg
    rng = np.random.default_rng(4)
    bs, nb_pool = 8, 48
    starts = np.array([0, 40, 70, 0], np.int32)
    seq_len = np.array([16, 16, 3, 1], np.int32)
    bt = np.zeros((4, 12), np.int32)
    for i, (st, n) in enumerate(zip(starts, seq_len)):
        nb = -(-(st + n + 1) // bs)
        bt[i, :nb] = 1 + 12 * i + np.arange(nb)
    lanes = {(int(bt[i, p // bs]), p % bs): p
             for i in range(3) for p in range(starts[i])}
    pools = _stack_pools(rng, cfg, nb_pool, bs, lanes)
    jp = jax.tree.map(jnp.asarray, pools)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), pools)
    toks = rng.integers(1, cfg.vocab_size, (4, 16)).astype(np.int32)
    jl, _ = jm.prefill_paged(jparams, {"tokens": jnp.asarray(toks)}, jp,
                             jnp.asarray(bt), jnp.asarray(starts),
                             cache_max=16, seq_len=jnp.asarray(seq_len),
                             all_logits=True)
    tl, _ = tm.prefill_paged(tparams, {"tokens": torch.from_numpy(toks)},
                             tp, torch.from_numpy(bt),
                             torch.from_numpy(starts),
                             seq_len=torch.from_numpy(seq_len),
                             all_logits=True)
    valid = np.arange(16)[None, :] < seq_len[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               **TOL)

    pos = np.array([56, 0, 86, 0], np.int32)
    active = np.array([True, False, True, False])
    dbt = np.zeros((4, 12), np.int32)
    dbt[0, :8] = 1 + np.arange(8)
    dbt[2, :11] = 20 + np.arange(11)
    lanes = {(int(dbt[i, p // bs]), p % bs): p
             for i in (0, 2) for p in range(pos[i])}
    pools = _stack_pools(rng, cfg, nb_pool, bs, lanes)
    step = rng.integers(1, cfg.vocab_size, (4, 1)).astype(np.int32)
    jl, jpools = jm.decode_step_paged(
        jparams, jax.tree.map(jnp.asarray, pools), jnp.asarray(dbt),
        jnp.asarray(step), jnp.asarray(pos), jnp.asarray(active))
    tl, tpools = tm.decode_step_paged(
        tparams, jax.tree.map(lambda a: torch.from_numpy(a.copy()), pools),
        torch.from_numpy(dbt), torch.from_numpy(step), torch.from_numpy(pos),
        torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               **TOL)
    for j in ("slot0", "slot1"):
        for name in ("k", "v"):
            np.testing.assert_allclose(
                tpools["periods"][j][name].numpy()[:, 1:],
                np.asarray(jpools["periods"][j][name])[:, 1:], **TOL)


# ------------------------------------------------------------ engines


def _drain(engine, prompts, max_new, force_preempt_after=None):
    for p in prompts:
        engine.submit(p, max_new=max_new)
    outs = {}
    for i in range(3000):
        if engine.idle:
            break
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
        if i + 1 == force_preempt_after and not engine.preemptions:
            engine._preempt_youngest()
    assert engine.idle
    return outs


def _prompts(vocab, n, length, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).astype(np.int32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def reference_tokens():
    """The reference's paged engine on two workloads: the config matrix's
    (4 prompts of 12 tokens, 12 new, a pool of 10 blocks with the prefix
    cache, which preempts) and prompts past the window (3 of 45 tokens,
    24 new, a roomy pool)."""
    jm, jparams, _, _ = pair()
    vocab = jm.cfg.vocab_size
    tight = JaxEngine(jm, jparams, prefix_cache=True, **TIGHT)
    want_tight = _drain(tight, _prompts(vocab, 4, 12, 1), 12)
    assert tight.preemptions > 0
    roomy = JaxEngine(jm, jparams, num_blocks=64, block_size=4, max_batch=8,
                      max_len=80)
    return want_tight, _drain(roomy, _prompts(vocab, 3, 45, 2), 24)


@pytest.mark.parametrize("fusion", [True, False])
def test_paged_engine_emits_the_reference_tokens(reference_tokens, fusion):
    _, _, tm, tparams = pair()
    want_tight, want_long = reference_tokens
    vocab = tm.cfg.vocab_size
    eng = PagedLLMEngine(tm, tparams, prefix_cache=True,
                         decode_fusion=fusion, **TIGHT)
    assert _drain(eng, _prompts(vocab, 4, 12, 1), 12) == want_tight
    s = stats_schema.validate(eng.stats())
    assert s["preemptions"] > 0
    assert s["window_blocks_freed"] == 0        # the global layer reads all
    assert eng.live_window is None
    eng = PagedLLMEngine(tm, tparams, num_blocks=64, block_size=4,
                         max_batch=8, max_len=80, decode_fusion=fusion)
    assert _drain(eng, _prompts(vocab, 3, 45, 2), 24) == want_long


def test_slot_engine_emits_the_reference_tokens(reference_tokens):
    """The slot engine (local rings of 32 lanes, global strips of 80), the
    reference's slot engine and the reference's paged engine agree."""
    jm, jparams, tm, tparams = pair()
    want_tight, want_long = reference_tokens
    vocab = tm.cfg.vocab_size
    for prompts, max_new, want in ((_prompts(vocab, 4, 12, 1), 12,
                                    want_tight),
                                   (_prompts(vocab, 3, 45, 2), 24,
                                    want_long)):
        assert _drain(LLMEngine(tm, tparams, num_slots=2, cache_max=80),
                      prompts, max_new) == want
    assert _drain(JaxLLMEngine(jm, jparams, num_slots=2, cache_max=80),
                  _prompts(vocab, 3, 45, 2), 24) == want_long


def test_ngram_speculation_emits_the_reference_tokens(reference_tokens):
    """n-gram drafting at k=4 over prompts that repeat a 9-token phrase:
    verify windows past the window, accepted drafts, the reference's
    tokens (its own spec engine's too)."""
    jm, jparams, tm, tparams = pair()
    rng = np.random.default_rng(5)
    phrase = rng.integers(1, tm.cfg.vocab_size, 9).astype(np.int32)
    prompts = [np.concatenate([rng.integers(1, tm.cfg.vocab_size, 4)
                               .astype(np.int32), np.tile(phrase, 5)])
               for _ in range(3)]
    kw = dict(num_blocks=64, block_size=4, max_batch=8, max_len=80,
              spec_decode="ngram", spec_k=4)
    want = _drain(JaxEngine(jm, jparams, num_blocks=64, block_size=4,
                            max_batch=8, max_len=80), prompts, 20)
    assert _drain(JaxEngine(jm, jparams, **kw), prompts, 20) == want
    eng = PagedLLMEngine(tm, tparams, **kw)
    assert _drain(eng, prompts, 20) == want
    s = eng.stats()
    assert s["draft_hit_rate"] > 0 and s["accepted_tokens_per_step"] > 1


# ------------------------------------------------------------ serve CLI


def _req_lines(lines):
    return [ln for ln in lines if ln.strip().startswith("req ")]


@pytest.mark.parametrize("argv", [
    [], ["--decode-fusion", "off"], ["--engine", "slot"],
    ["--window-accounting", "off"], ["--spec-decode", "ngram"],
])
def test_serve_cli_serves_gemma3_like_the_reference_cli(monkeypatch, argv):
    """``--arch gemma3-4b`` with 40-token prompts (past the reduced
    window), the reference's seed-0 weights bridged in: the port's CLI
    prints the reference CLI's ``req N:`` lines."""
    from repro.launch import serve as jserve

    _, _, _, tparams = pair()
    build_model = serve.build_model
    monkeypatch.setattr(serve, "build_model",
                        lambda args: build_model(args)[:2] + (tparams,))
    common = ["--arch", "gemma3-4b", "--requests", "4", "--prompt-len",
              "40", "--max-new", "6", "--stats-every", "0", *argv]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--device", "cpu", *common])
    lines = buf.getvalue().splitlines()
    monkeypatch.setattr("sys.argv", ["serve", *common])
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        jserve.main()
    want = _req_lines(ref.getvalue().splitlines())
    assert len(want) == 3
    assert _req_lines(lines) == want
    assert lines[0].startswith("4 requests, 24 tokens")
