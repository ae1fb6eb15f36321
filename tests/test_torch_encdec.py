"""whisper-tiny (the encoder-decoder) in the port, against the reference.

Reduced config (2 + 2 layers, 16 frames, d_model 256, float32), the
reference's seed-0 weights bridged into the port with every bias leaf
(q/k/v, the cross-attention's unused ``bk``/``bv``, the layernorms')
and every norm scale drawn non-trivial from a numpy seed, the same
numpy frame embeddings fed to both (the two packages' ``fake_embeds``
draw different numbers).  On the CPU the port's attention runs the
kernels' plain versions; the reference runs its jnp path.

Tolerances: logits and losses float32 on both sides, sums in other
orders over at most a few hundred terms, logits of magnitude ~1:
``atol=rtol=1e-4`` (measured ~3e-6); a wrong mask, bias, position row or
norm moves them by > 1e-2.  Gradients: each leaf within 1e-4 x its
max|g| (at least 1e-3 of the largest leaf's: the self-attention's
``bk`` has a gradient of 0 in exact arithmetic).  Greedy tokens identical.
The train CLI's printed losses (4 decimals): within 1.5e-4.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import frontend as jfe  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import frontend as tfe  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving.server import LLMEngine, PagedLLMEngine  # noqa: E402

ARCH = "whisper-tiny"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, NEW = 2, 12, 4


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, dtype=np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


def drawn(tree, seed):
    """A numpy parameter tree with every bias leaf (``bq``, ``bk``,
    ``bv``, a layernorm's ``bias``) N(0, 0.3) and every norm ``scale``
    1 + N(0, 0.1), in sorted key order; the init sets them to 0 and 1."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bq", "bk", "bv", "bias"):
                out[k] = (0.3 * rng.normal(size=v.shape)).astype(v.dtype)
            elif k == "scale":
                out[k] = (1 + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
            else:
                out[k] = v
        return out

    return walk(tree)


def embeds_np(cfg, batch, seed):
    """Frontend embeddings both packages take: (B, N, W) float32."""
    rng = np.random.default_rng(1000 + seed)
    return rng.normal(size=(batch, tfe.frontend_tokens(cfg),
                            tfe.embed_dim(cfg))).astype(np.float32)


_PAIRS = {}


def pair(max_position=None):
    """-> (reference model, jnp params, port model, port params, numpy
    tree) on the reduced config (``max_position`` replaced on both
    sides where given)."""
    if max_position not in _PAIRS:
        cfg = jax_get_config(ARCH).reduced()
        pcfg = get_config(ARCH).reduced()
        if max_position:
            cfg = dataclasses.replace(cfg, max_position=max_position)
            pcfg = dataclasses.replace(pcfg, max_position=max_position)
        jm = JaxModel(cfg)
        tree = drawn(jax.tree.map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0))), 1)
        tm = Model(pcfg, device="cpu")
        _PAIRS[max_position] = (jm, jax.tree.map(jnp.asarray, tree), tm,
                                params_from_jax(tree, device="cpu"), tree)
    return _PAIRS[max_position]


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
    assert (red.encoder_layers, red.encoder_frames, red.num_layers) == \
        (2, 16, 2)
    assert tfe.frontend_tokens(red) == 16 and tfe.embed_dim(red) == 256
    assert tfe.frontend_schema(red) == {}


def test_schema_and_bridge_carry_every_leaf():
    """The port's own init has the reference's tree, leaf by leaf
    (``encdec`` with its encoder, decoder and ``enc_pos``, learned
    ``positions``, no ``gate`` in the plain gelu MLP, no qk-norm in the
    cross-attention), and the bridge carries every leaf bit for bit."""
    jm, _, tm, tp, tree = pair()
    ours = tm.init(seed=3)
    want = [(k, v.shape) for k, v in _leaves(tree)]
    assert [(k, tuple(v.shape)) for k, v in _leaves(ours)] == want
    names = {k for k, _ in want}
    assert "/embed/positions" in names and "/encdec/enc_pos" in names
    assert "/encdec/decoder/layer1/cross/bk" in names
    assert not any(k.endswith("/gate") for k in names)
    for (k, got), (_, w) in zip(_leaves(tp), _leaves(tree)):
        assert np.array_equal(got.numpy(), w), k


def test_forward_matches_the_reference():
    """``forward`` (every attention through the flash entry: encoder and
    cross non-causal) and ``forward_train`` against the reference's
    ``Model.forward``."""
    jm, jp, tm, tp, _ = pair()
    jb, tb = batches(tm.cfg, S)
    want, aux = jm.forward(jp, jb, remat=False)
    with torch.no_grad():
        got = tm.forward(tp, tb)
        train, taux = tm.forward_train(tp, tb)
    assert got.shape == (B, S, tm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(train.numpy(), np.asarray(want), **TOL)
    assert float(taux) == float(aux) == 0.0


@pytest.mark.parametrize("max_position", [None, 14])
def test_prefill_and_decode_match_the_reference(max_position):
    """Prefill S tokens, then NEW greedy decode steps from the
    reference's tokens: logits within ``TOL``, the same argmax each step.
    At ``max_position`` 14 the steps past position 13 reuse its learned
    row (and its cache lane), as the reference's clip does."""
    jm, jp, tm, tp, _ = pair(max_position)
    jb, tb = batches(tm.cfg, S)
    cache_max = S + NEW
    jl, jc = jm.prefill(jp, jb, cache_max=cache_max)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, tb, cache_max=cache_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert set(tc) == {f"layer{i}" for i in range(tm.cfg.num_layers)}
    assert tuple(tc["layer0"]["xk"].shape) == \
        tuple(jc["layer0"]["xk"].shape)
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)
    for t in range(S, S + NEW):
        pos = np.full((B,), t, np.int32)
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, None]),
                                jnp.asarray(pos))
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok[:, None]),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert np.array_equal(tl.numpy()[:, 0].argmax(-1),
                              np.asarray(jl)[:, 0].argmax(-1))
        tok = np.asarray(jl)[:, 0].argmax(-1).astype(np.int32)
    if max_position:
        # the self-attention strips hold the clipped position
        assert int(tc["layer0"]["self"]["pos"].max()) == max_position - 1


def test_training_forward_past_the_last_position_matches_the_reference():
    """S = 18 tokens at ``max_position`` 14: positions 13..17 all take
    row 13 and, in the training forward's mask, one position."""
    jm, jp, tm, tp, _ = pair(14)
    jb, tb = batches(tm.cfg, 18, seed=2)
    want, _ = jm.forward(jp, jb, remat=False)
    with torch.no_grad():
        got, _ = tm.forward_train(tp, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def assert_grads_close(got, want, rel=1e-4, floor=1e-3):
    """Each leaf within ``rel`` x its max|want| (and both trees alike),
    that max taken at least ``floor`` x the largest of all leaves: the
    self-attention's ``bk`` shifts every score of a query alike, so its
    gradient is 0 in exact arithmetic and rounding noise (~1e-9) on
    both sides."""
    got, want = _leaves(_np(got)), _leaves(_np(want))
    assert [k for k, _ in got] == [k for k, _ in want]
    top = max(float(np.abs(w).max()) for _, w in want)
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), floor * top)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=name)


def test_loss_and_gradients_match_the_reference():
    """``Model.loss`` and every gradient leaf against
    ``jax.value_and_grad`` of the reference's: the cross-attention's
    ``bk``/``bv`` get zero gradients on both sides (never added)."""
    jm, jp, tm, _, tree = pair()
    jb, tb = batches(tm.cfg, S, seed=1)
    labels = np.random.default_rng(5).integers(
        0, tm.cfg.vocab_size, (B, S)).astype(np.int32)
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, jb)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(), tree)
    total, tmetrics = tm.loss(tp, tb)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(loss), atol=1e-5,
                               rtol=0)
    assert sorted(tmetrics) == sorted(metrics)
    # a leaf outside the graph has no .grad: the reference's gradient is 0
    tgrads = jax.tree.map(lambda t: torch.zeros_like(t) if t.grad is None
                          else t.grad, tp,
                          is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert_grads_close(tgrads, jax.tree.map(np.asarray, grads))
    cross = tgrads["encdec"]["decoder"]["layer0"]["cross"]
    assert float(cross["bk"].abs().max()) == 0.0
    assert float(cross["wk"].abs().max()) > 0.0


def test_cross_kv_ignores_its_bias_leaves():
    """The reference's ``cross_kv`` adds neither ``bk`` nor ``bv`` (the
    schema carries them, seeded non-zero here) and ``cross_apply`` only
    ``bq``: the port's match, and ``cross_attend`` (the kernel's plain
    version) gives ``cross_apply``'s output."""
    jm, jp, tm, tp, tree = pair()
    p = tp["encdec"]["decoder"]["layer1"]["cross"]
    jpc = jp["encdec"]["decoder"]["layer1"]["cross"]
    assert float(p["bk"].abs().max()) > 0.1
    rng = np.random.default_rng(7)
    enc = rng.normal(size=(B, 16, tm.cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(B, 5, tm.cfg.d_model)).astype(np.float32)
    k, v = tattn.cross_kv(p, torch.from_numpy(enc))
    jk, jv = jattn.cross_kv(jpc, jnp.asarray(enc))
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    bare = torch.einsum("bsd,dhk->bshk", torch.from_numpy(enc), p["wk"])
    assert torch.equal(k, bare)
    want = jattn.cross_apply(jpc, jm.cfg, jnp.asarray(x), jk, jv)
    with torch.no_grad():
        got = tattn.cross_apply(p, tm.cfg, torch.from_numpy(x), k, v)
        kern = tattn.cross_attend(p, tm.cfg, torch.from_numpy(x), k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(kern.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_cache_init_has_the_reference_layout():
    jm, _, tm, _, _ = pair()
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jm.cache_abstract(3, 20))
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")),
                       tm.cache_init(3, 20),
                       is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert got == want
    assert int(tm.cache_init(3, 20)["layer1"]["self"]["pos"].max()) == -1


def test_engines_refuse_it():
    """No engine serves it, as none of the reference's does: the slot
    engine at construction (the reference's fails at its first
    admission, prefilling ``{"tokens"}`` without ``"embeds"``), the
    paged engine with the reference's message."""
    _, _, tm, tp, _ = pair()
    with pytest.raises(ValueError, match="token stack"):
        LLMEngine(tm, tp, num_slots=2, cache_max=32)
    with pytest.raises(ValueError, match="decoder-only token stack"):
        PagedLLMEngine(tm, tp)


def _step_losses(lines):
    return {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
            for m in (re.match(r"step +(\d+) loss=(\S+) xent=(\S+) ", ln)
                      for ln in lines) if m}


def run_both_clis(arch, monkeypatch, capsys, steps=3):
    """The reference CLI and the port's (``--device cpu``), ``--reduced``,
    ``steps`` steps logged each, on the reference's seed-0 weights, both
    given the same numpy embeddings for step s (their ``fake_embeds``
    patched).  -> (reference lines, port lines)."""
    argv = ["--arch", arch, "--steps", str(steps), "--batch", "2",
            "--seq", "16", "--log-every", "1"]
    monkeypatch.setattr(jfe, "fake_embeds", lambda cfg, b, dtype, seed=0:
                        jnp.asarray(embeds_np(cfg, b, seed)))
    monkeypatch.setattr("sys.argv", ["train", *argv])
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    cfg = jax_get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, JaxModel(cfg).init(
        jax.random.PRNGKey(0)))
    monkeypatch.setattr(Model, "init", lambda self, seed=0:
                        params_from_jax(tree, device=self.device))
    monkeypatch.setattr(tfe, "fake_embeds",
                        lambda cfg, b, dtype, seed=0, device="cuda":
                        torch.from_numpy(embeds_np(cfg, b, seed)).to(device))
    ttrain.main(["--device", "cpu", *argv])
    return want, capsys.readouterr().out.splitlines()


def test_train_cli_matches_the_reference_cli(monkeypatch, capsys):
    want, got = run_both_clis(ARCH, monkeypatch, capsys)
    assert got[:2] == want[:2]                   # arch= and params: lines
    g, w = _step_losses(got), _step_losses(want)
    assert sorted(g) == sorted(w) == [0, 1, 2]
    for step in w:
        np.testing.assert_allclose(g[step], w[step], atol=1.5e-4, rtol=0)
