"""paligemma-3b (the prefix-LM over image patches) in the port, against
the reference.

Reduced config (2 layers, 4 patches of width 1152 projected to d_model
256, MQA heads of 64, float32), the reference's seed-0 weights bridged
into the port with every norm scale drawn non-trivial, the same numpy
patch embeddings fed to both.  The patches go in front of the tokens and
every query sees them (``bidir_prefix``): in the port's inference path
through ``ops.flash_attention(prefix=)``, whose plain version runs here;
in its training path and in the reference through ``attn_apply``'s
q-chunked branch.

Tolerances as ``tests/test_torch_encdec.py``: logits ``atol=rtol=1e-4``
(float32 both sides, measured ~2e-6), gradients 1e-4 x each leaf's
max|g|, greedy tokens identical, the CLI's printed losses within 1.5e-4;
the attention alone ``atol=1e-5``.  The key ranges of the kernel's
planner are integers, held exactly to a direct count.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import attention_split as split  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import frontend as tfe  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving.server import LLMEngine, PagedLLMEngine  # noqa: E402
from test_torch_encdec import (_leaves, _step_losses,  # noqa: E402
                               assert_grads_close, drawn, embeds_np,
                               run_both_clis)

ARCH = "paligemma-3b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, NEW = 2, 10, 4

_PAIR = []


def pair():
    """-> (reference model, jnp params, port model, port params, numpy
    tree) on the reduced config."""
    if not _PAIR:
        cfg = jax_get_config(ARCH).reduced()
        jm = JaxModel(cfg)
        tree = drawn(jax.tree.map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0))), 1)
        tm = Model(get_config(ARCH).reduced(), device="cpu")
        _PAIR.append((jm, jax.tree.map(jnp.asarray, tree), tm,
                      params_from_jax(tree, device="cpu"), tree))
    return _PAIR[0]


def batches(cfg, total, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, total)).astype(np.int32)
    emb = embeds_np(cfg, B, seed)
    return ({"tokens": jnp.asarray(toks), "embeds": jnp.asarray(emb)},
            {"tokens": torch.from_numpy(toks),
             "embeds": torch.from_numpy(emb)})


def test_config_matches_the_reference():
    full, pfull = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(pfull)
    red = get_config(ARCH).reduced()
    assert dataclasses.asdict(red) == dataclasses.asdict(full.reduced())
    assert (red.num_prefix_tokens, red.num_kv_heads, red.num_layers) == \
        (4, 1, 2)
    assert tfe.frontend_tokens(red) == 4
    assert tfe.embed_dim(red) == tfe.VISION_WIDTH == 1152
    assert tfe.frontend_schema(red)["projector"].shape == (1152, 256)
    assert tfe.frontend_tokens(full) == 256


def test_schema_and_bridge_carry_every_leaf():
    jm, _, tm, tp, tree = pair()
    ours = tm.init(seed=3)
    want = [(k, v.shape) for k, v in _leaves(tree)]
    assert [(k, tuple(v.shape)) for k, v in _leaves(ours)] == want
    assert ("/projector", (1152, 256)) in want
    for (k, got), (_, w) in zip(_leaves(tp), _leaves(tree)):
        assert np.array_equal(got.numpy(), w), k


def test_fake_embeds_are_seeded():
    cfg = get_config(ARCH).reduced()
    a = tfe.fake_embeds(cfg, 2, "float32", seed=4, device="cpu")
    assert a.shape == (2, 4, 1152) and a.dtype == torch.float32
    assert torch.equal(a, tfe.fake_embeds(cfg, 2, torch.float32, seed=4,
                                          device="cpu"))
    assert not torch.equal(a, tfe.fake_embeds(cfg, 2, "float32", seed=5,
                                              device="cpu"))


def test_forward_matches_the_reference():
    """``forward`` (the prefix through the flash entry) and
    ``forward_train`` against the reference's ``Model.forward``: logits
    of the tokens only, the patches' dropped."""
    jm, jp, tm, tp, _ = pair()
    jb, tb = batches(tm.cfg, S)
    want, _ = jm.forward(jp, jb, remat=False)
    with torch.no_grad():
        got = tm.forward(tp, tb)
        train, _ = tm.forward_train(tp, tb)
    assert got.shape == (B, S, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(train.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_the_reference():
    """The caches hold the 4 patches and the prompt; decoding goes on at
    position 4 + S (``tests/test_arch_smoke.py``'s convention)."""
    jm, jp, tm, tp, _ = pair()
    jb, tb = batches(tm.cfg, S, seed=3)
    n = tm.cfg.num_prefix_tokens
    cache_max = n + S + NEW
    jl, jc = jm.prefill(jp, jb, cache_max=cache_max)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, tb, cache_max=cache_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    lanes = tc["periods"]["slot0"]["pos"][0, 0]
    assert lanes[:n + S].tolist() == list(range(n + S))
    assert int(lanes[n + S:].max()) == -1
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    for t in range(S, S + NEW):
        pos = np.full((B,), n + t, np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, None]),
                                jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, None]),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert np.array_equal(tl.numpy()[:, 0].argmax(-1),
                              np.asarray(jl)[:, 0].argmax(-1))
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)


def test_loss_and_gradients_match_the_reference():
    jm, jp, tm, _, tree = pair()
    jb, tb = batches(tm.cfg, S, seed=1)
    labels = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, jb)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(), tree)
    total, _ = tm.loss(tp, tb)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss), atol=1e-5,
                               rtol=0)
    tgrads = jax.tree.map(lambda t: t.grad, tp,
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert_grads_close(tgrads, jax.tree.map(np.asarray, grads))
    assert float(tgrads["projector"].abs().max()) > 0


@pytest.mark.parametrize("s,prefix,q_chunk", [
    (12, 4, 1024), (12, 4, 5), (40, 17, 16), (9, 9, 4), (20, 1, 8)])
def test_prefix_attention_matches_the_q_chunked_reference(s, prefix, q_chunk):
    """One paligemma attention layer: the port's kernel branch
    (``attn_apply(allow_kernel=True, bidir_prefix=)`` ->
    ``flash_attention_ref(prefix=)``) and its q-chunked branch against
    the reference's q-chunked ``attn_apply(bidir_prefix=)``, query
    chunks that split the prefix or not."""
    jm, jp, tm, tp, _ = pair()
    p = {k: v[0] for k, v in tp["stack"]["periods"]["slot0"]["mix"].items()}
    jpl = {k: v[0] for k, v in jp["stack"]["periods"]["slot0"]["mix"].items()}
    x = np.random.default_rng(s).normal(
        size=(B, s, tm.cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want = jattn.attn_apply(jpl, jm.cfg, jnp.asarray(x), jnp.asarray(pos),
                            bidir_prefix=prefix, q_chunk=q_chunk)
    with torch.no_grad():
        kern = tattn.attn_apply(p, tm.cfg, torch.from_numpy(x),
                                torch.from_numpy(pos), bidir_prefix=prefix,
                                allow_kernel=True)
        chunked = tattn.attn_apply(p, tm.cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos),
                                   bidir_prefix=prefix, q_chunk=q_chunk)
    np.testing.assert_allclose(kern.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_flash_attention_ref_prefix_is_the_mask_it_names():
    """The plain version with ``prefix`` equals plain attention under the
    mask j <= i or j < prefix, at GQA and Sk > Sq; a prefix is refused
    with ``causal=False`` or a window, by the plain version and the
    wrapper alike."""
    rng = np.random.default_rng(0)
    b, h, kv, sq, sk, hd, prefix = 2, 8, 2, 23, 30, 16, 9
    q = torch.from_numpy(rng.normal(size=(b, h, sq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(b, kv, sk, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(b, kv, sk, hd)).astype(np.float32))
    i = torch.arange(sq)[:, None]
    j = torch.arange(sk)[None, :]
    mask = (j <= i) | (j < prefix)
    kr = k.repeat_interleave(h // kv, 1)
    vr = v.repeat_interleave(h // kv, 1)
    sc = (q @ kr.transpose(-1, -2)) / hd ** 0.5
    want = torch.softmax(sc.masked_fill(~mask, float("-inf")), -1) @ vr
    got = ops.flash_attention(q, k, v, prefix=prefix)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(ops.flash_attention(q, k, v, prefix=0),
                       ref.flash_attention_ref(q, k, v))
    for kw in (dict(causal=False), dict(window=4)):
        with pytest.raises(ValueError, match="prefix"):
            ops.flash_attention(q, k, v, prefix=prefix, **kw)
        with pytest.raises(ValueError, match="prefix"):
            fa_mod.flash_attention(q, k, v, prefix=prefix, **kw)


def direct_ranges(sq, sk, tq, prefix):
    """Keys [lo, hi) some query of each tile sees, by counting them."""
    out = []
    for s0 in range(0, sq, tq):
        seen = [j for j in range(sk) for i in range(s0, min(s0 + tq, sq))
                if j <= i or j < prefix]
        out.append((min(seen), max(seen) + 1) if seen else (0, 0))
    return out


@pytest.mark.parametrize("sq,sk,tq,prefix", [
    (456, 456, 8, 256), (456, 456, 8, 200), (40, 40, 8, 0), (40, 40, 8, 40),
    (70, 70, 64, 65), (1, 1, 8, 1), (300, 300, 32, 257), (33, 50, 16, 45)])
def test_flash_key_ranges_with_a_prefix_match_a_direct_count(sq, sk, tq,
                                                             prefix):
    """The planner's ranges are the keys the queries see, they never
    shrink from one query tile to the next (so launching the last tile
    first stays heaviest-first), and a plan covers every key once."""
    got = split.flash_key_ranges(sq, sk, tq, True, 0, prefix)
    assert got == direct_ranges(sq, sk, tq, prefix)
    his = [hi for _, hi in got]
    assert his == sorted(his)
    # paligemma's 8 query heads over 1 KV head: 8 positions a tile
    pl = fa_mod.plan(1, 8, 1, sq, sk, True, 0, 132, prefix)
    ranges = split.flash_key_ranges(sq, sk, min(8, sq), True, 0, prefix)
    assert len(pl.pieces) == len(ranges)
    for (lo, hi), n in zip(ranges, pl.pieces):
        keys = [split.piece_keys(lo, hi, pl.tiles_per_piece, j)
                for j in range(n)]
        assert keys[0][0] == lo and keys[-1][1] == hi
        assert all(a[1] == b[0] for a, b in zip(keys, keys[1:]))


def test_engines_refuse_it():
    _, _, tm, tp, _ = pair()
    assert not tm.supports_paged
    with pytest.raises(ValueError, match="token stack"):
        LLMEngine(tm, tp, num_slots=2, cache_max=32)
    with pytest.raises(ValueError, match="decoder-only token stack"):
        PagedLLMEngine(tm, tp)


def test_train_cli_matches_the_reference_cli(monkeypatch, capsys):
    want, got = run_both_clis(ARCH, monkeypatch, capsys)
    assert got[:2] == want[:2]
    g, w = _step_losses(got), _step_losses(want)
    assert sorted(g) == sorted(w) == [0, 1, 2]
    for step in w:
        np.testing.assert_allclose(g[step], w[step], atol=1.5e-4, rtol=0)
