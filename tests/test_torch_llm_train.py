"""The port's LLM training path against the reference, on the CPU.

Seeded numpy inputs and the reference's weights bridged into the port
(reduced configs, float32; the leaves the init sets to constants drawn,
as ``tests/test_torch_hybrid.py`` does, so no gradient is trivially 0):

* the token stream: bit-equal batches for several (seed, step, shard);
* ``softmax_xent`` with and without a mask: within 1e-6;
* ``attn_apply``'s q-chunked branch, output and the gradients of x, of
  every weight and (cross-attention) of k and v against ``jax.vjp`` with
  one seeded cotangent: causal, windowed ``attn_local`` with the window
  across query chunks, ``bidir_prefix``, ``kv_override``, (B,S) per-row
  positions, and S not a multiple of the chunk (``_Q_CHUNK_OVERRIDE``).
  Outputs within 1e-5, each gradient within 1e-4 x its max|g|;
* ``Model.loss`` (xent and the MoE router term) and every gradient leaf
  against ``jax.value_and_grad(model.loss)`` for qwen3-0.6b, gemma3-4b,
  dbrx-132b (dropless capacity, ``conftest.reduced_cfg``), rwkv6-1.6b and
  jamba-1.5-large-398b: the loss within 1e-5, each leaf within 1e-4 x
  its max|g|; the gradients with remat on equal those with it off;
* three ``make_train_step`` steps (``adamw`` over ``cosine_warmup``,
  clip 1.0) step for step against the reference's (qwen3-0.6b,
  dbrx-132b, rwkv6-1.6b, jamba-1.5-large-398b): losses and grad norms
  within 1e-5 (the recurrent stacks' grad norms, ~25, within 1e-5 of
  their size); parameters as ``tests/test_torch_train.py`` holds Adam
  (its ``m / (sqrt(v) + eps)`` is ~1 in size wherever a gradient is
  tiny, so rounding may flip such a step: every element within 2 x lr x
  steps, and >= 99.9 % within 1e-5); the step's in-place update, a slice
  of each leaf at a time, gives the whole-tree update's values bit for
  bit;
* the CLI: ``--device cpu --reduced`` against the reference CLI on the
  same weights (every printed loss within 1.5e-4: 4 decimals printed),
  a restart from ``--ckpt-dir`` resuming the same losses, its refusals,
  and rwkv6 and jamba passing its checks with a card present (their
  scans differentiate through ``ops``'s autograd Functions, whose
  backward kernels ``tests/test_torch_scan_backward_card.py`` holds to
  the plain versions on the card).
"""
import dataclasses
import re
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from conftest import reduced_cfg  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.data import tokens as jtokens  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import strategies as tstrat  # noqa: E402
from repro_torch.core import trainer as ttrainer  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402

ARCHS = ["qwen3-0.6b", "gemma3-4b", "dbrx-132b", "rwkv6-1.6b",
         "jamba-1.5-large-398b"]
RECURRENT = ("rwkv6-1.6b", "jamba-1.5-large-398b")
B, S = 2, 48          # S past gemma3's reduced window of 32


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


def assert_grads_close(got, want, rel=1e-4):
    """Each leaf within ``rel`` x its max|want| (and both trees alike)."""
    got, want = _leaves(_np(got)), _leaves(_np(want))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (name, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale,
                                   err_msg=name)


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


def pair(arch):
    """-> (reference model, its params (jnp), port model, numpy params)
    on the reduced config (dropless MoE capacity), shared by the module."""
    if arch not in _PAIRS:
        cfg = reduced_cfg(arch)
        port_cfg = dataclasses.replace(
            get_config(arch).reduced(),
            moe_capacity_factor=cfg.moe_capacity_factor)
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
        jm = JaxModel(cfg)
        tree = _drawn(jax.tree.map(np.asarray,
                                   jm.init(jax.random.PRNGKey(0))), 1)
        _PAIRS[arch] = (jm, jax.tree.map(jnp.asarray, tree),
                        Model(port_cfg, device="cpu"), tree)
    return _PAIRS[arch]


def _batch(vocab, seed=0, step=0):
    b = ttokens.make_stream(vocab, S, B, seed).batch(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


# ------------------------------------------------------------ data, loss


@pytest.mark.parametrize("seed,step,shard,num_shards,vocab", [
    (0, 0, 0, 1, 512), (0, 7, 1, 2, 512), (3, 41, 3, 4, 151936),
    (11, 2, 0, 1, 2)])
def test_token_stream_is_bit_equal_to_the_reference(seed, step, shard,
                                                    num_shards, vocab):
    want = jtokens.make_stream(vocab, 37, 8, seed).batch(step, shard,
                                                         num_shards)
    got = ttokens.make_stream(vocab, 37, 8, seed).batch(step, shard,
                                                        num_shards)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        assert np.array_equal(got[k], want[k]), k
    it = iter(ttokens.make_stream(vocab, 37, 8, seed))
    first = next(it)
    assert np.array_equal(first["tokens"],
                          jtokens.make_stream(vocab, 37, 8, seed)
                          .batch(0)["tokens"])


@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(5)
    logits = (3 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None if mask is None else jnp.asarray(mask))
    got = tlayers.softmax_xent(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=0)
    if masked:           # an all-zero mask divides by max(0, 1)
        zero = np.zeros_like(mask)
        got0 = tlayers.softmax_xent(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(zero))
        assert float(got0) == 0.0 == float(jlayers.softmax_xent(
            jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(zero)))


# ------------------------------------------------------------ attention


ATTN_CASES = {
    # name: (arch, kind, S, q_chunk override, extra kwargs)
    "causal": ("qwen3-0.6b", "attn", 40, None, {}),
    "local_window_across_chunks": ("gemma3-4b", "attn_local", 80, 32, {}),
    "bidir_prefix": ("gemma3-4b", "attn", 24, None, {"bidir_prefix": 7}),
    "kv_override": ("qwen3-0.6b", "attn", 20, 8, {"kv_override": 13}),
    "per_row_positions": ("gemma3-4b", "attn_local", 40, 16,
                          {"row_offsets": (0, 9)}),
    "ragged_chunks": ("qwen3-0.6b", "attn", 29, 8, {}),
}


def _layer(arch, kind):
    """The first layer of ``kind``'s attention weights, numpy."""
    jm, _, _, tree = pair(arch)
    cfg = jm.cfg
    j = next(j for j in range(len(cfg.layer_kinds))
             if cfg.layer_kinds[j] == kind)
    return cfg, jax.tree.map(lambda a: a[0],
                             tree["stack"]["periods"][f"slot{j}"]["mix"])


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attn_apply_q_chunked_matches_reference(case):
    arch, kind, s, chunk, extra = ATTN_CASES[case]
    cfg, p_np = _layer(arch, kind)
    rng = np.random.default_rng(sorted(ATTN_CASES).index(case))
    hd, kvh = cfg.resolved_head_dim, cfg.num_kv_heads
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    if "row_offsets" in extra:
        pos = pos[None] + np.asarray(extra["row_offsets"],
                                     np.int32)[:, None]
    kw = {"kind": kind}
    if "bidir_prefix" in extra:
        kw["bidir_prefix"] = extra["bidir_prefix"]
    kv = None
    if "kv_override" in extra:
        sk = extra["kv_override"]
        kv = (rng.normal(size=(2, sk, kvh, hd)).astype(np.float32),
              rng.normal(size=(2, sk, kvh, hd)).astype(np.float32),
              np.arange(sk, dtype=np.int32))

    def jfn(p, x, k=None, v=None):
        ov = None if kv is None else (k, v, jnp.asarray(kv[2]))
        return jattn.attn_apply(p, cfg, x, jnp.asarray(pos),
                                kv_override=ov, **kw)

    jargs = [jax.tree.map(jnp.asarray, p_np), jnp.asarray(x)]
    if kv is not None:
        jargs += [jnp.asarray(kv[0]), jnp.asarray(kv[1])]
    @jax.jit
    def fwd_bwd(*args):
        y, vjp = jax.vjp(jfn, *args)
        return y, vjp(jnp.asarray(ct))

    token = jattn._Q_CHUNK_OVERRIDE.set(chunk)
    try:
        want, want_grads = fwd_bwd(*jargs)
    finally:
        jattn._Q_CHUNK_OVERRIDE.reset(token)

    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in p_np.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tkv = None
    if kv is not None:
        tkv = (torch.from_numpy(kv[0]).requires_grad_(),
               torch.from_numpy(kv[1]).requires_grad_(),
               torch.from_numpy(kv[2]))
    token = tattn._Q_CHUNK_OVERRIDE.set(chunk)
    try:
        got = tattn.attn_apply(tp, cfg, tx, torch.from_numpy(pos),
                               kv_override=tkv, **kw)
    finally:
        tattn._Q_CHUNK_OVERRIDE.reset(token)
    (got * torch.from_numpy(ct)).sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    # a weight the branch does not read (cross-attention: wk, wv, the
    # norms) gets no gradient, and a zero one under jax.vjp
    assert_grads_close({k: torch.zeros_like(t) if t.grad is None else t.grad
                        for k, t in tp.items()}, want_grads[0])
    assert_grads_close({"x": tx.grad}, {"x": want_grads[1]})
    if kv is not None:
        assert_grads_close({"k": tkv[0].grad, "v": tkv[1].grad},
                           {"k": want_grads[2], "v": want_grads[3]})


def test_q_chunked_branch_recomputes_each_chunk_in_the_backward():
    """The chunk scores are not kept for the backward: with grad mode on,
    each chunk runs under ``torch.utils.checkpoint``, so its body runs
    once more in the backward pass (the reference's ``jax.checkpoint``);
    without grad, once."""
    cfg, p_np = _layer("qwen3-0.6b", "attn")
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_()
          for k, v in p_np.items()}
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 20, cfg.d_model)).astype(np.float32))
    calls = []
    body = tattn._chunk_attend

    def counted(*a, **k):
        calls.append(1)
        return body(*a, **k)

    token = tattn._Q_CHUNK_OVERRIDE.set(8)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tattn, "_chunk_attend", counted)
            y = tattn.attn_apply(tp, cfg, x, torch.arange(20))
            assert len(calls) == 3                # chunks of 7, 7, 6
            y.sum().backward()
            assert len(calls) == 6
            with torch.no_grad():
                tattn.attn_apply(tp, cfg, x, torch.arange(20))
            assert len(calls) == 9
    finally:
        tattn._Q_CHUNK_OVERRIDE.reset(token)


# ------------------------------------------------------------ model loss


_LOSS = {}


def reference_loss_and_grads(arch, remat=True):
    """jit(value_and_grad(model.loss)) on the module's weights and the
    stream's first batch -> (loss, metrics, grads), numpy; cached."""
    key = (arch, remat)
    if key not in _LOSS:
        jm, jp, _, _ = pair(arch)
        jb, _ = _batch(jm.cfg.vocab_size)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: jm.loss(p, b, remat=remat), has_aux=True))
        (loss, metrics), grads = fn(jp, jb)
        _LOSS[key] = (float(loss), {k: float(v) for k, v in metrics.items()},
                      jax.tree.map(np.asarray, grads))
    return _LOSS[key]


def port_loss_and_grads(arch, remat=True):
    _, _, tm, tree = pair(arch)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(), tree)
    _, tb = _batch(tm.cfg.vocab_size)
    total, metrics = tm.loss(tp, tb, remat=remat)
    total.backward()
    return total, metrics, jax.tree.map(lambda t: t.grad, tp,
                                        is_leaf=lambda t: isinstance(
                                            t, torch.Tensor))


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_gradients_match_reference(arch):
    want_loss, want_metrics, want_grads = reference_loss_and_grads(arch)
    total, metrics, grads = port_loss_and_grads(arch)
    assert total.dtype == torch.float32
    assert sorted(metrics) == sorted(want_metrics) == ["aux", "loss", "xent"]
    np.testing.assert_allclose(float(total.detach()), want_loss, atol=1e-5,
                               rtol=0)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   want_metrics[k],
                                   atol=1e-5, rtol=0, err_msg=k)
    if arch == "dbrx-132b" or arch.startswith("jamba"):
        assert want_metrics["aux"] > 0.5       # the router term is in
    else:
        assert float(metrics["aux"].detach()) == 0.0
    assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_remat_does_not_change_the_gradients(arch):
    """Recomputing each period in the backward pass gives the gradients
    of the plain backward, in both packages."""
    on, off = port_loss_and_grads(arch, True), port_loss_and_grads(arch,
                                                                   False)
    assert float(on[0].detach()) == float(off[0].detach())
    assert_grads_close(on[2], off[2], rel=1e-6)
    assert_grads_close(off[2], reference_loss_and_grads(arch, False)[2])


def test_training_forward_agrees_with_the_draft_forward():
    """``forward_train`` (q-chunked attention, no kernel) and
    ``forward`` (the inference forward through ``ops.flash_attention``)
    give the same logits; only the training forward differentiates."""
    _, _, tm, tree = pair("gemma3-4b")
    tp = params_from_jax(tree, device="cpu")
    _, tb = _batch(tm.cfg.vocab_size)
    logits, aux = tm.forward_train(tp, tb)
    with torch.no_grad():
        draft = tm.forward(tp, tb)
    assert logits.shape == draft.shape == (B, S, tm.cfg.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), draft.numpy(),
                               atol=1e-4, rtol=0)
    assert logits.requires_grad is False    # no leaf asked for a gradient


# ------------------------------------------------------------ train step


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "dbrx-132b", *RECURRENT])
def test_train_steps_match_reference_step_for_step(arch):
    jm, jp, tm, tree = pair(arch)
    lr, steps = 3e-4, 3
    jopt = joptim.adamw(joptim.cosine_warmup(lr, 2, 10))
    topt = toptim.adamw(toptim.cosine_warmup(lr, 2, 10))
    jstep = jax.jit(jtrainer.make_train_step(
        lambda p, b: jm.loss(p, b), jopt, clip=1.0))
    tstep = ttrainer.make_train_step(lambda p, b: tm.loss(p, b), topt,
                                     clip=1.0)
    js = jopt.init(jp)
    tp = params_from_jax(tree, device="cpu")
    ts = topt.init(tp)
    for step in range(steps):
        jb = {k: jnp.asarray(v) for k, v in
              jtokens.make_stream(jm.cfg.vocab_size, S, B, 0)
              .batch(step).items()}
        tb = {k: torch.from_numpy(v) for k, v in
              ttokens.make_stream(tm.cfg.vocab_size, S, B, 0)
              .batch(step).items()}
        jp, js, jmet = jstep(jp, js, jb)
        tp, ts, tmet = tstep(tp, ts, tb)
        assert sorted(tmet) == sorted(jmet) == \
            ["aux", "grad_norm", "loss", "xent"]
        for k in jmet:
            # the recurrent stacks' grad norms are ~25 (their drawn decay
            # and bonus leaves): after an Adam step float32 rounding alone
            # moves them past 1e-5, so they are held to 1e-5 of their size
            scale = (max(1.0, float(jmet[k]))
                     if k == "grad_norm" and arch in RECURRENT else 1.0)
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       atol=1e-5 * scale, rtol=0,
                                       err_msg=f"step {step} {k}")
    for (name, got), (_, want) in zip(
            _leaves(_np(tp)), _leaves(_np(jax.tree.map(np.asarray, jp)))):
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr * steps, name
        assert np.mean(diff <= 1e-5) >= 0.999, name
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == steps


def test_donated_step_updates_the_given_tensors_in_slices(monkeypatch):
    """The step writes into the tensors it was given, a slice of at most
    ``DONATE_CHUNK`` elements at a time (here 4,099, so the reduced
    model's larger leaves are cut, at uneven ends), with the values of
    one ``optimizer.update`` + ``apply_updates`` over the whole tree."""
    _, _, tm, tree = pair("qwen3-0.6b")
    opt = toptim.adamw(1e-3)
    _, tb = _batch(tm.cfg.vocab_size)
    loss = lambda p, b: tm.loss(p, b)                      # noqa: E731
    ref_p = params_from_jax(tree, device="cpu")
    _, _, grads = tstrat._value_and_grad(loss, ref_p, tb)
    grads, _ = toptim.clip_by_global_norm(grads, 1.0)
    upd, ref_s = opt.update(grads, opt.init(ref_p), ref_p)
    ref_p = toptim.apply_updates(ref_p, upd)
    monkeypatch.setattr(ttrainer, "DONATE_CHUNK", 4099)
    params = params_from_jax(tree, device="cpu")
    state = opt.init(params)
    ids = [id(t) for t in toptim.optimizers.tree_leaves(params)]
    new_p, new_s, _ = ttrainer.make_train_step(loss, opt)(params, state, tb)
    assert [id(t) for t in toptim.optimizers.tree_leaves(new_p)] == ids
    assert new_s["mu"] is state["mu"] and int(new_s["count"]) == 1
    for part in ("mu", "nu"):
        for (name, got), (_, want) in zip(_leaves(_np(new_s[part])),
                                          _leaves(_np(ref_s[part]))):
            assert np.array_equal(got, want), (part, name)
    for (name, got), (_, want) in zip(_leaves(_np(new_p)),
                                      _leaves(_np(ref_p))):
        assert np.array_equal(got, want), name


# ------------------------------------------------------------ the CLI


def _run_cli(capsys, *argv):
    ttrain.main(["--device", "cpu", *argv])
    return capsys.readouterr().out.splitlines()


def _step_losses(lines):
    return {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
            for m in (re.match(r"step +(\d+) loss=(\S+) xent=(\S+) ", ln)
                      for ln in lines) if m}


def test_train_cli_matches_the_reference_cli(monkeypatch, capsys):
    """``--device cpu --reduced`` (the default arch, 6 steps, every step
    logged) prints the reference CLI's losses on the reference's seed-0
    weights, and its closing verdict line."""
    argv = ["--steps", "6", "--batch", "4", "--seq", "32",
            "--log-every", "1"]
    monkeypatch.setattr("sys.argv", ["train", *argv])
    jtrain.main()
    want = capsys.readouterr().out.splitlines()
    cfg = reduced_cfg("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, JaxModel(cfg).init(
        jax.random.PRNGKey(0)))
    monkeypatch.setattr(Model, "init", lambda self, seed=0:
                        params_from_jax(tree, device=self.device))
    got = _run_cli(capsys, *argv)
    assert got[0] == want[0]                     # arch= line
    assert got[1] == want[1]                     # params: line
    g, w = _step_losses(got), _step_losses(want)
    assert sorted(g) == sorted(w) == list(range(6))
    for step in w:
        np.testing.assert_allclose(g[step], w[step], atol=1.5e-4, rtol=0)
    assert re.match(r"loss \S+ -> \S+ \((LEARNING|check hyperparams)\)$",
                    got[-1])


def test_train_cli_resumes_from_its_checkpoint(capsys, tmp_path):
    """8 steps with a checkpoint every 2; a second run given only the
    step-4 checkpoint restores it and prints the first run's losses for
    steps 4-7."""
    argv = ["--steps", "8", "--batch", "2", "--seq", "24", "--log-every",
            "1"]
    whole = _run_cli(capsys, *argv, "--ckpt-dir", str(tmp_path / "a"))
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == \
        ["step_4", "step_6", "step_8"]                   # keep=3
    shutil.copytree(tmp_path / "a" / "step_4", tmp_path / "b" / "step_4")
    resumed = _run_cli(capsys, *argv, "--ckpt-dir", str(tmp_path / "b"))
    assert "restored step 4" in resumed
    want = {s: v for s, v in _step_losses(whole).items() if s >= 4}
    assert _step_losses(resumed) == want
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == \
        ["step_4", "step_6", "step_8"]


def test_train_cli_run_returns_its_record(tmp_path):
    args = ttrain.make_parser().parse_args(
        ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16"])
    out = ttrain.run(args, log=lambda line: None)
    assert len(out["losses"]) == len(out["grad_norms"]) == \
        len(out["step_seconds"]) == 3
    assert all(np.isfinite(out["losses"])) and all(
        np.isfinite(out["grad_norms"]))
    assert out["start"] == 0 and int(out["opt_state"]["count"]) == 3


@pytest.mark.parametrize("argv,error,match", [
    (["--arch", "whisper-tiny"], KeyError, "not carried"),
    (["--arch", "paligemma-3b"], KeyError, "not carried"),
    (["--device", "cuda"], SystemExit, "is_available"),
])
def test_train_cli_refusals(argv, error, match, monkeypatch):
    if argv == ["--device", "cuda"]:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error, match=match):
        ttrain.main(argv)


@pytest.mark.parametrize("arch", RECURRENT)
def test_train_cli_takes_recurrent_stacks_on_the_card(arch, monkeypatch):
    """The scans differentiate on both devices (their backward kernels on
    the card): with a card present the CLI's checks pass rwkv6 and jamba;
    the CPU trains them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ttrain.check_args(ttrain.make_parser().parse_args(["--arch", arch]))
    monkeypatch.undo()
    args = ttrain.make_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "1",
         "--seq", "8"])
    assert all(np.isfinite(ttrain.run(args, log=lambda line: None)
                           ["losses"]))


def test_frontend_configs_are_refused_as_the_model_refuses_them():
    args = ttrain.make_parser().parse_args(["--device", "cpu"])
    base = get_config("qwen3-0.6b").reduced()
    for bad in (dataclasses.replace(base, frontend="vision"),
                dataclasses.replace(base, is_encoder_decoder=True)):
        with pytest.raises(ValueError, match="decoder-only"):
            ttrain.run(args, cfg=bad, log=lambda line: None)
