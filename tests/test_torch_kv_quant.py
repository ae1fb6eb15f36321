"""The int8 KV cache (``kv_cache_quant``) in the port against the reference.

On the CPU, float32, the reference's reduced weights bridged into the
port (``repro_torch.bridge``), the same numpy inputs on both sides:

* ``_quantize_kv`` gives the reference's int8 codes and float32 scales
  bit for bit (random, all-zero and +-max rows, values exactly at a
  half: round half to even of a true division); ``_dequantize_kv`` its
  values;
* the int8 plain versions (``ref.paged_attention_int8_ref``,
  ``ref.paged_prefill_int8_ref``) equal the reference's dequantize-then-
  plain-version read;
* ``Model.prefill`` / ``decode_step`` and the paged dispatch /
  ``decode_step_paged`` at reduced qwen3-0.6b, phi4-mini (a GQA group of
  3), gemma3-4b (``attn_local``, prompts past the ring) and jamba (mamba
  state beside the pool): logits within ``TOL``, caches and pools as the
  reference's;
* the engines, per mode: the paged engine fused, fusion off, serial,
  with the prefix cache (a copy-on-write hit and preemption under a tight
  pool), n-gram speculation at k=4, a 2-replica ``ServingCluster``, and
  the slot engine against ``LLMEngine``: tokens exactly the reference's;
  and the mode-vs-mode identities the reference keeps under int8 hold in
  the port alike;
* the pool edits on int8 leaves (``copy_blocks`` moves the scales,
  ``write_chunk_tokens`` refuses a float source), ``Model`` builds every
  carried config with the int8 cache, and the pool's bytes per token.

Tolerances.  Logits: ``atol=rtol=1e-4``, float32 on both sides (the two
frameworks sum products in other orders, ~1e-6 on logits of ~1).  Cache
codes come from K/V that the two frameworks compute ~1e-7 apart, so a
value within that of a rounding boundary may land one code apart: codes
may differ by at most 1, and in at most 1 of 1,000 lanes; scales within
``1e-5`` relative.  The same inputs quantized on both sides (the first
test) must agree exactly.

On the card the int8 kernels are held to these plain versions in
``tests/test_torch_kernels.py`` (marked ``cuda``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.serving.cluster import ServingCluster as JaxCluster  # noqa: E402
from repro.serving.loadgen import shared_prefix_workload  # noqa: E402
from repro.serving.server import LLMEngine as JaxSlotEngine  # noqa: E402
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import _MODULE_FOR, get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402
from repro_torch.serving.cluster import ServingCluster  # noqa: E402
from repro_torch.serving.server import (LLMEngine, PagedLLMEngine,  # noqa: E402
                                        ragged_dispatch)

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen3-0.6b", "group-3", "gemma3-4b", "jamba-1.5-large-398b")
NB, BS = 24, 4

_PAIRS = {}


def _cfgs(arch):
    """(reference config, port config), both reduced, int8 cache on."""
    if arch == "group-3":
        extra = dict(name="phi4-mini-group3", num_heads=6, num_kv_heads=2)
        arch = "phi4-mini-3.8b"
    else:
        extra = {}
    cfg = dataclasses.replace(reduced_cfg(arch), kv_cache_quant=True,
                              **extra)
    port = dataclasses.replace(get_config(arch).reduced(),
                               moe_capacity_factor=cfg.moe_capacity_factor,
                               kv_cache_quant=True, **extra)
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    return cfg, port


def pair(arch):
    """-> (reference model, its params, port model, bridged params)."""
    if arch not in _PAIRS:
        cfg, port = _cfgs(arch)
        jm = JaxModel(cfg)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        _PAIRS[arch] = (jm, jax.tree.map(jnp.asarray, tree),
                        Model(port, device="cpu"),
                        params_from_jax(tree, device="cpu"))
    return _PAIRS[arch]


def _close_caches(ours, theirs):
    """Every leaf of two cache or pool trees: int8 codes at most 1 apart
    in at most 1 of 1,000 lanes, other integers equal, floats close."""
    ours = jax.tree.map(lambda t: t.numpy(), ours)
    theirs = jax.tree.map(np.asarray, theirs)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.int8:
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, d.max()
        elif a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def _adopt(ours, theirs):
    """Copy the reference's cache or pool leaves into the port's, in
    place, so the next read starts from identical codes: each read is
    then held to ``TOL`` on its own, not through a code one apart."""
    for t, j in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        t.copy_(torch.from_numpy(np.array(j)))


# ------------------------------------------------------------ quantize


def _rows(case):
    rng = np.random.default_rng(0)
    if case == "random":
        return rng.normal(size=(3, 5, 2, 64)).astype(np.float32) * 3
    if case == "zeros":
        return np.zeros((2, 4, 2, 16), np.float32)
    if case == "max":
        # +-max in every row, and rows of one value repeated
        t = rng.normal(size=(2, 3, 2, 32)).astype(np.float32)
        t[..., 0] = 7.0
        t[..., 1] = -7.0
        t[1, 2] = -2.5
        return t
    # halves: a row of max 127 has scale exactly 1, so every value below
    # is a true half and rounds to even
    halves = np.array([127.0, 0.5, -0.5, 1.5, -1.5, 2.5, -3.5, 126.5,
                       -126.5, 63.5, 64.5, -0.0, 0.0, 7.5, -8.5, 100.25],
                      np.float32)
    return np.stack([halves, -halves])[None, :, None, :]


@pytest.mark.parametrize("case", ["random", "zeros", "max", "halves",
                                  "bfloat16"])
def test_quantize_kv_matches_reference(case):
    x = _rows("random" if case == "bfloat16" else case)
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    if case == "bfloat16":
        tx = tx.bfloat16()
        jx = jnp.asarray(tx.float().numpy()).astype(jnp.bfloat16)
    codes, scales = tattn._quantize_kv(tx)
    jcodes, jscales = jattn._quantize_kv(jx)
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    if case == "halves":
        assert codes[0, 0, 0, :9].tolist() == [127, 0, 0, 2, -2, 2, -4,
                                                126, -126]
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = tattn._dequantize_kv(codes, scales, dt).float().numpy()
        want = np.asarray(jattn._dequantize_kv(jcodes, jscales, jdt)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ plain versions


def _int8_pool(rng, nb_pool, bs, kv, hd):
    codes = rng.integers(-127, 128, (nb_pool, bs, kv, hd)).astype(np.int8)
    scales = rng.uniform(0.001, 0.05, (nb_pool, bs, kv)).astype(np.float32)
    return codes, scales


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("hd,h,kv", [(16, 4, 4), (64, 6, 2), (128, 8, 1)])
def test_int8_plain_versions_match_dequantize_then_plain(window, hd, h, kv):
    """The port's int8 plain versions against the reference's read of a
    quantized cache: ``_dequantize_kv`` then its plain version."""
    rng = np.random.default_rng(hd + window)
    b, nb_pool, bs, nb = 3, 13, 4, 4
    kc, ks = _int8_pool(rng, nb_pool, bs, kv, hd)
    vc, vs = _int8_pool(rng, nb_pool, bs, kv, hd)
    kpos_pool = np.full((nb_pool, bs), -1, np.int32)
    bt = np.zeros((b, nb), np.int32)
    pos = np.array([13, 6, 0], np.int32)
    for i, n in enumerate((14, 7)):                # row 2: all-null
        blocks = np.arange(1, 5) + 4 * i
        bt[i, :-(-n // bs)] = blocks[:-(-n // bs)]
        for p in range(n):
            kpos_pool[bt[i, p // bs], p % bs] = p
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, kc, vc, ks, vs, kpos_pool, bt,
                                       pos)]
    ours = ref.paged_attention_int8_ref(*t, window=window).numpy()
    deq = [jattn._dequantize_kv(jnp.asarray(c), jnp.asarray(s), jnp.float32)
           for c, s in ((kc, ks), (vc, vs))]
    want = np.asarray(jref.paged_attention_ref(
        jnp.asarray(q), *deq, jnp.asarray(kpos_pool), jnp.asarray(bt),
        jnp.asarray(pos), window=window))
    np.testing.assert_allclose(ours, want, atol=1e-5, rtol=1e-5)
    assert np.all(ours[2] == 0)

    # the ragged prefill read: the gathered int8 prefix, then the chunk
    s, lp = 5, nb * bs
    qq = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    kk = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    vv = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    starts = np.array([14, 7, 0], np.int32)
    qpos = (starts[:, None] + np.arange(s)).astype(np.int32)
    kpos_c = np.where(np.arange(s)[None] < np.array([[5], [3], [1]]), qpos,
                      -1).astype(np.int32)
    kpos_p = kpos_pool[bt].reshape(b, lp)
    pk, pv = (c[bt].reshape(b, lp, kv, hd) for c in (kc, vc))
    pks, pvs = (sc[bt].reshape(b, lp, kv) for sc in (ks, vs))
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (qq, pk, pv, pks, pvs, kpos_p, kk, vv, kpos_c, qpos)]
    ours = ref.paged_prefill_int8_ref(*t, window=window).numpy()
    jk = jnp.concatenate([jattn._dequantize_kv(jnp.asarray(pk),
                                               jnp.asarray(pks),
                                               jnp.float32), kk], 1)
    jv = jnp.concatenate([jattn._dequantize_kv(jnp.asarray(pv),
                                               jnp.asarray(pvs),
                                               jnp.float32), vv], 1)
    want = np.asarray(jref.paged_prefill_ref(
        jnp.asarray(qq), jk, jv, jnp.concatenate([kpos_p, kpos_c], 1),
        jnp.asarray(qpos), window=window))
    np.testing.assert_allclose(ours, want, atol=1e-5, rtol=1e-5)

    # a slot decode: the whole strip is the prefix, no chunk keys
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (qq[:, :1], pk, pv, pks, pvs, kpos_p)]
    none = torch.zeros(b, 0, kv, hd)
    ours = ref.paged_prefill_int8_ref(
        *t, none, none, torch.zeros(b, 0, dtype=torch.int32),
        torch.from_numpy(qpos[:, :1].copy()), window=window).numpy()
    want = np.asarray(jref.paged_prefill_ref(
        jnp.asarray(qq[:, :1]), jk[:, :lp], jv[:, :lp], jnp.asarray(kpos_p),
        jnp.asarray(qpos[:, :1]), window=window))
    np.testing.assert_allclose(ours, want, atol=1e-5, rtol=1e-5)


def test_float_entries_refuse_int8_pools():
    rng = np.random.default_rng(0)
    kc, ks = _int8_pool(rng, 5, 4, 2, 16)
    q = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="paged_attention_int8"):
        ops.paged_attention(q, torch.from_numpy(kc), torch.from_numpy(kc),
                            torch.full((5, 4), -1, dtype=torch.int32),
                            torch.zeros(1, 2, dtype=torch.int32),
                            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="paged_prefill_int8"):
        ops.paged_prefill(q[:, None], torch.from_numpy(kc[None, 0]),
                          torch.from_numpy(kc[None, 0]),
                          torch.zeros(1, 4, dtype=torch.int32),
                          torch.zeros(1, 1, dtype=torch.int32))


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_path_matches_reference(arch):
    """A 40-token prompt (past gemma3's reduced ring of 32: the codes and
    scales roll together) and two decode steps."""
    jm, jparams, tm, tparams = pair(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jm.cfg.vocab_size, (1, 40)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_max=64)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        cache_max=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)
    _adopt(tc, jc)
    kv = [t for path, t in jax.tree_util.tree_leaves_with_path(tc)
          if path[-1].key in ("k", "v")]
    assert kv and all(t.dtype == torch.int8 for t in kv)
    for i in range(2):
        step = rng.integers(1, jm.cfg.vocab_size, (1, 1)).astype(np.int32)
        pos = np.array([40 + i], np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(step),
                                jnp.asarray(pos))
        tl, tc = tm.decode_step(tparams, tc, torch.from_numpy(step),
                                torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close_caches(tc, jc)
        _adopt(tc, jc)


def _reference_dispatch(jm, params, pools, toks, bt, starts, lens, srows):
    """The reference engine's fused dispatch: ``prefill_paged`` (every
    lane's logits) and the chunk's scatter."""
    r, c = toks.shape
    logits, caches = jm.prefill_paged(
        params, {"tokens": jnp.asarray(toks)}, pools, jnp.asarray(bt),
        jnp.asarray(starts), cache_max=c, seq_len=jnp.asarray(lens),
        all_logits=True, state_rows=jnp.asarray(srows))
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


def _live(pools, n_slots):
    """The pools without what holds garbage on both sides: the recurrent
    layers' trash slot (the last) and the null block's K/V payload
    (every padding lane is scattered there, its pos lanes stay -1)."""
    def cut(node, axis):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = cut(v, axis)
            elif k in tkv._STATE_LEAVES:
                out[k] = v[(slice(None),) * axis + (slice(0, n_slots),)]
            elif k == "pos":
                out[k] = v
            else:
                out[k] = v[(slice(None),) * axis + (slice(1, None),)]
        return out
    return {"periods": cut(pools["periods"], 1), "rem": cut(pools["rem"], 0)}


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_path_matches_reference(arch):
    """Two requests: a dispatch writes their first 20 and 13 tokens (a
    padding row beside them), a second carries 20 and 9 more past those
    prefixes (past gemma3's window of 32), then a decode step over rows
    0-2 with row 2 inactive.  Logits and the int8 pools agree."""
    jm, jparams, tm, tparams = pair(arch)
    rng = np.random.default_rng(5)
    jpools = jm.pool_init(NB, BS, state_batch=4)
    tpools = tm.pool_init(NB, BS, state_batch=4)
    _close_caches(tpools, jpools)
    bt = np.zeros((3, 11), np.int32)
    bt[0] = np.arange(1, 12)
    bt[1, :6] = np.arange(12, 18)
    srows = np.array([0, 1, 3], np.int32)
    for starts, lens in (([0, 0, 0], [20, 13, 1]), ([20, 13, 0], [20, 9, 1])):
        starts = np.array(starts, np.int32)
        lens = np.array(lens, np.int32)
        toks = rng.integers(1, jm.cfg.vocab_size, (3, 20)).astype(np.int32)
        jl, jpools = _reference_dispatch(jm, jparams, jpools, toks, bt,
                                         starts, lens, srows)
        t = [torch.from_numpy(np.ascontiguousarray(a))
             for a in (toks, bt, starts, lens, srows)]
        tl = ragged_dispatch(tm, tparams, tpools, *t[:4], block_size=BS,
                             all_logits=True, state_rows=t[4])
        valid = np.arange(20)[None, :] < lens[:, None]
        valid[2] = False
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                                   **TOL)
        _close_caches(_live(tpools, 3), _live(jpools, 3))
        _adopt(tpools, jpools)

    pos = np.array([40, 22, 0], np.int32)
    active = np.array([True, True, False])
    dbt = np.where(active[:, None], bt, 0).astype(np.int32)
    step = rng.integers(1, jm.cfg.vocab_size, (3, 1)).astype(np.int32)
    jl, jpools = jm.decode_step_paged(jparams, jpools, jnp.asarray(dbt),
                                      jnp.asarray(step), jnp.asarray(pos),
                                      jnp.asarray(active))
    tl, tpools = tm.decode_step_paged(
        tparams, tpools, torch.from_numpy(dbt), torch.from_numpy(step),
        torch.from_numpy(pos), torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               **TOL)
    _close_caches(_live(tpools, 3), _live(jpools, 3))


# ------------------------------------------------------------ engines

# 9 usable blocks of 4 tokens for up to 8 requests of up to 40 tokens:
# admission, eviction, copy-on-write and preemption all fire
TIGHT = dict(num_blocks=10, block_size=4, max_batch=8, max_len=40,
             prefix_cache=True)
MODES = {"fused": {}, "fusion_off": dict(decode_fusion=False),
         "serial": dict(scheduler="serial"),
         "ngram": dict(spec_decode="ngram", spec_k=4),
         "roomy": dict(num_blocks=64, prefix_cache=False)}


def _workload(vocab):
    wl = shared_prefix_workload(num_requests=6, prefix_len=10, suffix_len=7,
                                vocab_size=vocab, num_prefixes=2, seed=4)
    return [wl.prompts[:3], wl.prompts[3:]], [[8] * 3, [8] * 3]


def _drive(engine, bursts, news, steps_between=3):
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


def _cluster(cluster, bursts, news):
    cids = [cluster.submit(p, max_new=n, now=float(i)) for i, (p, n) in
            enumerate(zip(sum(bursts, []), sum(news, [])))]
    outs = {r.cid: list(r.out_tokens) for r in cluster.drain(now=100.0)}
    return [outs[c] for c in cids]


@pytest.fixture(scope="module")
def mode_runs():
    """Each mode's tokens and stats on both packages, reduced qwen3-0.6b
    with the int8 cache: {mode: (ours, theirs, our stats, their
    stats)}."""
    jm, jparams, tm, tparams = pair("qwen3-0.6b")
    bursts, news = _workload(jm.cfg.vocab_size)
    runs = {}
    for mode, kw in MODES.items():
        kw = {**TIGHT, **kw}
        ours, theirs = (PagedLLMEngine(tm, tparams, **kw),
                        JaxEngine(jm, jparams, **kw))
        runs[mode] = (_drive(ours, bursts, news),
                      _drive(theirs, bursts, news), ours.stats(),
                      theirs.stats())
    ours, theirs = (LLMEngine(tm, tparams, num_slots=8, cache_max=64),
                    JaxSlotEngine(jm, jparams, num_slots=8, cache_max=64))
    runs["slot"] = (_drive(ours, bursts, news), _drive(theirs, bursts, news),
                    {}, {})
    kw = dict(num_blocks=24, block_size=4, max_batch=4, max_len=40,
              prefix_cache=True)
    ours = ServingCluster(lambda i: PagedLLMEngine(tm, tparams, **kw), 2,
                          seed=0)
    theirs = JaxCluster(lambda i: JaxEngine(jm, jparams, **kw), 2, seed=0)
    runs["cluster_2"] = (_cluster(ours, bursts, news),
                         _cluster(theirs, bursts, news), ours.stats(),
                         theirs.stats())
    assert ours.route_log == theirs.route_log
    return runs


@pytest.mark.parametrize("mode", [*MODES, "slot", "cluster_2"])
def test_engine_mode_emits_the_reference_tokens(mode_runs, mode):
    ours, theirs, ostats, tstats = mode_runs[mode]
    assert ours == theirs
    assert len(ours) == 6 and all(len(t) == 8 for t in
                                  (ours.values() if isinstance(ours, dict)
                                   else ours))
    for key in ("preemptions", "cow_copies", "prefix_hits", "evictions",
                "admissions"):
        if key in tstats:
            assert ostats[key] == tstats[key], key
    if mode == "fused":
        # the tight pool preempts and the prefix cache hits through a
        # copy-on-write block
        assert tstats["preemptions"] > 0 and tstats["cow_copies"] > 0


def test_mode_identities_match_the_reference(mode_runs):
    """Under int8 a fused decode row attends its own key at full
    precision, a fusion-off, serial or slot decode step its quantized
    copy, so mode-vs-mode identity is no longer a theorem: which modes
    agree is read off the reference and must be the port's.  On this
    workload every mode agrees in both."""
    def flat(outs):
        return outs if isinstance(outs, list) else [outs[r] for r in
                                                    sorted(outs)]

    names = list(mode_runs)
    for side in (0, 1):
        same = {(a, b): flat(mode_runs[a][side]) == flat(mode_runs[b][side])
                for a in names for b in names}
        if side == 0:
            ours = same
        else:
            assert ours == same
    assert all(ours.values())


# ------------------------------------------------------------ pool edits


def test_pool_edits_on_int8_leaves():
    """``copy_blocks`` copies the scale leaves with their blocks (as the
    reference's), ``write_chunk_tokens`` refuses a float chunk cache for
    an int8 pool instead of truncating it, the lane kills touch ``pos``
    only."""
    jm, _, tm, _ = pair("qwen3-0.6b")
    rng = np.random.default_rng(2)
    jpools = jm.pool_init(8, BS)
    tpools = tm.pool_init(8, BS)
    assert set(tpools["periods"]["slot0"]) == {"k", "v", "k_s", "v_s", "pos"}

    def fill(node):
        return {k: (fill(v) if isinstance(v, dict) else
                    rng.integers(-127, 128, v.shape).astype(v.dtype)
                    if v.dtype == np.int8 else
                    rng.integers(-1, 30, v.shape).astype(v.dtype)
                    if v.dtype.kind == "i" else
                    rng.uniform(0, 1, v.shape).astype(v.dtype))
                for k, v in node.items()}

    np_pools = fill(jax.tree.map(np.asarray, jpools))
    jpools = jax.tree.map(jnp.asarray, np_pools)
    tpools = jax.tree.map(lambda a: torch.from_numpy(a.copy()), np_pools)
    jpools = jkv.copy_blocks(jpools, [1, 3], [5, 6])
    tpools = tkv.copy_blocks(tpools, [1, 3], [5, 6])
    jpools = jkv.invalidate_blocks(jpools, [2])
    tpools = tkv.invalidate_blocks(tpools, [2])
    jpools = jkv.scrub_null_block(jpools)
    tpools = tkv.scrub_null_block(tpools)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 tpools)),
                    jax.tree.leaves(jax.tree.map(np.asarray, jpools))):
        np.testing.assert_array_equal(a, b)

    leaf = tpools["periods"]["slot0"]
    n = leaf["k"].shape[0]
    kv, hd = leaf["k"].shape[-2:]
    float_cache = {"periods": {"slot0": {
        "k": torch.zeros(n, 1, 2, kv, hd), "v": torch.zeros(n, 1, 2, kv, hd),
        "k_s": torch.ones(n, 1, 2, kv), "v_s": torch.ones(n, 1, 2, kv),
        "pos": torch.zeros(n, 1, 2, dtype=torch.int32)}}, "rem": {}}
    before = leaf["k"].clone()
    with pytest.raises(TypeError, match="int8"):
        tkv.write_chunk_tokens(tpools, float_cache, [0], [0], [4], [0])
    assert torch.equal(leaf["k"], before)


def test_every_config_builds_with_the_int8_cache():
    """``Model`` takes ``kv_cache_quant`` for every carried config; the
    pools' K/V bytes per token (scales included, pos lanes not) are
    under 0.6x the model dtype's at qwen1.5-110b, as the reference's
    own test asks of its cache, and 59,136 against 114,688 at
    qwen3-0.6b (28 layers x 8 KV heads x 128)."""
    for name in sorted(_MODULE_FOR):
        Model(dataclasses.replace(get_config(name), kv_cache_quant=True),
              device="cpu")

    def kv_bytes(cfg):
        pools = Model(dataclasses.replace(cfg, num_layers=2),
                      device="cpu").pool_init(2, 1)
        leaves = jax.tree_util.tree_leaves_with_path(pools)
        per_layer = sum(t.numel() * t.element_size() for path, t in leaves
                        if path[-1].key != "pos") / 2 / 2   # 2 layers, lanes
        return per_layer * cfg.num_layers

    for name, want in (("qwen1.5-110b", None), ("qwen3-0.6b", 59_136)):
        cfg = get_config(name)
        dense = kv_bytes(cfg)
        quant = kv_bytes(dataclasses.replace(cfg, kv_cache_quant=True))
        assert quant < 0.6 * dense
        if want is not None:
            assert (quant, dense) == (want, 114_688)
