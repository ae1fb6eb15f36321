"""phi4-mini-3.8b and qwen1.5-110b in the port, against the reference.

Both are dense ``attn`` stacks (swiglu, rmsnorm, rope).  phi4-mini ties
its embeddings and has a GQA group of 3 (24 query / 8 KV heads);
qwen1.5-110b has a group of 8 (64 / 8) and q/k/v biases.  On the CPU,
reduced (2 layers, float32), the reference's parameters bridged into the
port: ``prefill_paged`` (one ragged dispatch past cached prefixes) and
``decode_step_paged``, ``prefill`` and ``decode_step`` agree with the
reference's within ``atol=rtol=1e-4`` (float32 on both sides: summation
order moves logits of magnitude ~1 by ~1e-6; a wrong mask, position,
bias or tied weight moves them by >1e-2), and the paged engine (decode
fusion on and off) and the slot engine emit the reference engines'
greedy tokens.

The init draws q/k/v biases as zeros, as the reference's does, so
qwen1.5's are overwritten with seeded non-zero values in the numpy tree
before either package uses it.  ``reduced()`` always gives 4 / 2 heads,
so no reduced config reaches a group of 3: ``group-3`` is reduced
phi4-mini with 6 query / 2 KV heads of 64.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving.loadgen import shared_prefix_workload  # noqa: E402
from repro.serving.server import LLMEngine as JaxLLMEngine  # noqa: E402
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving.server import LLMEngine, PagedLLMEngine  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("phi4-mini-3.8b", "qwen1.5-110b")
CASES = ARCHS + ("group-3",)
NB, BS = 24, 4
PAGED = dict(num_blocks=48, block_size=8, max_batch=4, max_len=96,
             prefix_cache=True)


def _configs(case):
    """-> (reference config, port config), both reduced."""
    if case == "group-3":
        group3 = dict(name="phi4-mini-group3", num_heads=6, num_kv_heads=2)
        return (dataclasses.replace(reduced_cfg("phi4-mini-3.8b"), **group3),
                dataclasses.replace(get_config("phi4-mini-3.8b").reduced(),
                                    **group3))
    return reduced_cfg(case), get_config(case).reduced()


def seeded_qkv_bias(tree, seed):
    """Overwrite every ``bq``/``bk``/``bv`` leaf of a numpy parameter tree
    with N(0, 0.5) draws (in sorted key order), in place."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key])
            elif key in ("bq", "bk", "bv"):
                node[key] = (0.5 * rng.normal(size=node[key].shape)).astype(
                    node[key].dtype)

    walk(tree)
    return tree


_PAIRS = {}


def pair(case):
    """-> (reference model, its params, port model, bridged params)."""
    if case not in _PAIRS:
        cfg, port_cfg = _configs(case)
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
        jm = JaxModel(cfg)
        tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        if cfg.qkv_bias:
            seeded_qkv_bias(tree, seed=1)
        _PAIRS[case] = (jm, jax.tree.map(jnp.asarray, tree),
                        Model(port_cfg, device="cpu"),
                        params_from_jax(tree, device="cpu"))
    return _PAIRS[case]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    full = get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(full.reduced()) == \
        dataclasses.asdict(reduced_cfg(arch))
    assert full.resolved_head_dim == 128 and full.num_kv_heads == 8
    group = full.num_heads // full.num_kv_heads
    assert (group, full.tie_embeddings, full.qkv_bias) == \
        {"phi4-mini-3.8b": (3, True, False),
         "qwen1.5-110b": (8, False, True)}[arch]


def test_qkv_bias_is_seeded_non_zero():
    jm, jparams, _, tparams = pair("qwen1.5-110b")
    mix = jax.tree.map(np.asarray, jparams)["stack"]["periods"]["slot0"][
        "mix"]
    for key in ("bq", "bk", "bv"):
        assert np.abs(mix[key]).min() > 0
        np.testing.assert_array_equal(
            tparams["stack"]["periods"]["slot0"]["mix"][key].numpy(),
            mix[key])


def _pools(cfg, rng, lanes):
    """Random K/V pools whose pos lanes hold the {(block, lane): position}
    entries, every other lane -1."""
    n = cfg.num_layers
    shape = (n, NB, BS, cfg.num_kv_heads, cfg.resolved_head_dim)
    pos = np.full((n, NB, BS), -1, np.int32)
    for (blk, lane), p in lanes.items():
        pos[:, blk, lane] = p
    return {"periods": {"slot0": {
        "k": rng.normal(size=shape).astype(np.float32),
        "v": rng.normal(size=shape).astype(np.float32), "pos": pos}},
        "rem": {}}


def _prefix_lanes(tables, lengths):
    return {(int(row[p // BS]), p % BS): p
            for row, n in zip(tables, lengths) for p in range(n)}


def _both(np_pools):
    return (jax.tree.map(jnp.asarray, np_pools),
            jax.tree.map(lambda a: torch.from_numpy(a.copy()), np_pools))


@pytest.mark.parametrize("case", CASES)
def test_paged_path_matches_reference(case):
    """One ragged dispatch (per-row cursors past cached prefixes, a
    padding row) with every lane's logits, then one decode step over
    active and inactive rows: logits and pool writes agree."""
    jm, jparams, tm, tparams = pair(case)
    cfg = jm.cfg
    rng = np.random.default_rng(2)
    starts = np.array([0, 5, 9, 0], np.int32)
    seq_len = np.array([8, 3, 1, 1], np.int32)
    bt = np.array([[7, 8, 0, 0], [1, 2, 3, 0], [4, 5, 6, 9], [0, 0, 0, 0]],
                  np.int32)
    toks = rng.integers(1, cfg.vocab_size, (4, 8)).astype(np.int32)
    jp, tp = _both(_pools(cfg, rng, _prefix_lanes(bt[:3], starts[:3])))
    jl, jc = jm.prefill_paged(jparams, {"tokens": jnp.asarray(toks)}, jp,
                              jnp.asarray(bt), jnp.asarray(starts),
                              cache_max=8, seq_len=jnp.asarray(seq_len),
                              all_logits=True)
    tl, tc = tm.prefill_paged(tparams, {"tokens": torch.from_numpy(toks)},
                              tp, torch.from_numpy(bt),
                              torch.from_numpy(starts),
                              seq_len=torch.from_numpy(seq_len),
                              all_logits=True)
    valid = np.arange(8)[None, :] < seq_len[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tc["periods"]["slot0"][name].numpy()[:, valid],
            np.asarray(jc["periods"]["slot0"][name])[:, valid], **TOL)

    pos = np.array([5, 0, 11, 0], np.int32)
    active = np.array([True, False, True, False])
    bt = np.array([[1, 2, 0], [0, 0, 0], [3, 4, 5], [0, 0, 0]], np.int32)
    jp, tp = _both(_pools(cfg, rng, _prefix_lanes(bt[[0, 2]], pos[[0, 2]])))
    step = rng.integers(1, cfg.vocab_size, (4, 1)).astype(np.int32)
    jl, jpools = jm.decode_step_paged(
        jparams, jp, jnp.asarray(bt), jnp.asarray(step), jnp.asarray(pos),
        jnp.asarray(active))
    tl, tpools = tm.decode_step_paged(
        tparams, tp, torch.from_numpy(bt), torch.from_numpy(step),
        torch.from_numpy(pos), torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[active], np.asarray(jl)[active],
                               **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tpools["periods"]["slot0"][name].numpy()[:, 1:],
            np.asarray(jpools["periods"]["slot0"][name])[:, 1:], **TOL)


@pytest.mark.parametrize("case", CASES)
def test_slot_path_matches_reference(case):
    """Whole-prompt prefill of two 13-token prompts, then one decode step
    over both rows at their next positions: logits agree."""
    jm, jparams, tm, tparams = pair(case)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, jm.cfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)}, cache_max=24)
    tl, tc = tm.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                        cache_max=24)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    step = rng.integers(1, jm.cfg.vocab_size, (2, 1)).astype(np.int32)
    pos = np.array([13, 13], np.int32)
    jl, _ = jm.decode_step(jparams, jc, jnp.asarray(step), jnp.asarray(pos))
    tl, _ = tm.decode_step(tparams, tc, torch.from_numpy(step),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _drive(engine, prompts, max_new):
    for p in prompts:
        engine.submit(p, max_new=max_new)
    outs = {}
    for _ in range(500):
        if engine.idle:
            break
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
    assert engine.idle
    return outs


@pytest.mark.parametrize("case", CASES)
def test_engines_emit_the_reference_tokens(case):
    """Six prompts over two shared 16-token prefixes (prefix cache hits)
    through the reference's paged engine; the port's paged engine with
    decode fusion on and off, the port's slot engine and the reference's
    slot engine emit the same greedy tokens."""
    jm, jparams, tm, tparams = pair(case)
    wl = shared_prefix_workload(num_requests=6, prefix_len=16, suffix_len=7,
                                vocab_size=jm.cfg.vocab_size,
                                num_prefixes=2, seed=4)
    want = _drive(JaxEngine(jm, jparams, **PAGED), wl.prompts, 5)
    assert len(want) == 6
    for fusion in (True, False):
        eng = PagedLLMEngine(tm, tparams, decode_fusion=fusion, **PAGED)
        assert _drive(eng, wl.prompts, 5) == want, fusion
        assert eng.stats()["hit_rate"] > 0
    assert _drive(LLMEngine(tm, tparams, num_slots=4, cache_max=96),
                  wl.prompts, 5) == want
    assert _drive(JaxLLMEngine(jm, jparams, num_slots=4, cache_max=96),
                  wl.prompts, 5) == want
