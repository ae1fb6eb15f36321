"""Mode-vs-mode token identity in bfloat16: the reference and the port.

Reduced qwen3-0.6b in bfloat16 on the CPU (the reference's weights
bridged into the port), ten prompts (six over a shared 16-token prefix,
four repetitive), 12 new tokens each.  Each engine mode's greedy tokens
are held against the same package's continuous scheduler with decode
fusion on, where every step is one ragged ``paged_prefill`` dispatch.

What the two packages show:

* speculative decoding (n-gram, k=4) keeps identity in both: verify
  windows ride the same ``paged_prefill`` dispatch;
* the reference's serial scheduler and fusion-off decode keep identity
  through its jnp gather read (``repro/models/attention.py:354-373``,
  its default off a TPU), which rounds the scores and the normalised
  probabilities to bf16 before the value product, as
  ``paged_prefill_ref`` does (``repro/kernels/ref.py:87-89``);
* the reference's own kernel read (``decode_kernel=True``: its
  ``paged_attention`` op, whose oracle ``paged_attention_ref`` keeps the
  scores, probabilities and value product in float32) parts from
  continuous at bf16 ties, and so does the port's serial and fusion-off
  decode, which reads through the port's ``paged_attention`` with the
  same float32 semantics (the port carries no gather read: on the card
  the kernel is the only decode read);
* with that one read swapped for the fused path's numerics
  (``paged_prefill_ref`` on one query lane over the gathered table) the
  port's serial and fusion-off modes are identical again.

So cross-mode identity in bf16 is a property of matching rounding, not
of the algorithm: it holds only between reads that round alike, and the
port's exact identity across every mode is a float32 fact.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro.serving.loadgen import repetitive_workload  # noqa: E402
from repro.serving.server import PagedLLMEngine as JaxEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving.server import PagedLLMEngine  # noqa: E402

ENGINE = dict(num_blocks=64, block_size=8, max_batch=8, max_len=96,
              prefix_cache=True)
MODES = {
    "ngram": dict(spec_decode="ngram", spec_k=4),
    "serial": dict(scheduler="serial"),
    "fusion off": dict(decode_fusion=False),
}
# (package, mode, decode read, identical to continuous)
CASES = [
    ("reference", "ngram", None, True),
    ("reference", "serial", "gather", True),
    ("reference", "fusion off", "gather", True),
    ("reference", "serial", "kernel", False),
    ("reference", "fusion off", "kernel", False),
    ("port", "ngram", None, True),
    ("port", "serial", "kernel", False),
    ("port", "fusion off", "kernel", False),
    ("port", "serial", "fused numerics", True),
    ("port", "fusion off", "fused numerics", True),
]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    head = rng.integers(1, vocab, 16).astype(np.int32)
    prompts = [np.concatenate([head, rng.integers(1, vocab, int(
        rng.integers(4, 40))).astype(np.int32)]) for _ in range(6)]
    return prompts + list(repetitive_workload(
        num_requests=4, vocab_size=vocab, prompt_len=24, max_new=12,
        seed=0).prompts)


@pytest.fixture(scope="module")
def sides():
    """-> {package: (engine class, model, params)}, bf16, one weight set."""
    cfg = dataclasses.replace(reduced_cfg("qwen3-0.6b"), dtype="bfloat16")
    jm = JaxModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tm = Model(dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                                   dtype="bfloat16"), device="cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    assert tparams["embed"]["tokens"].dtype == torch.bfloat16
    return {"reference": (JaxEngine, jm, jparams),
            "port": (PagedLLMEngine, tm, tparams)}


def _drive(side, **kw):
    cls, model, params = side
    engine = cls(model, params, **ENGINE, **kw)
    for p in _prompts(model.cfg.vocab_size):
        engine.submit(p, max_new=12)
    outs = {}
    while not engine.idle:
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
    return outs


def fused_numerics_read(q, k_pool, v_pool, kpos_pool, block_table, pos, *,
                        window=0):
    """The decode read as the fused dispatch computes it: one query lane
    of ``paged_prefill_ref`` over the gathered block table."""
    b, _, hd = q.shape
    nb = block_table.shape[1]
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    bt = block_table.long()
    return ref.paged_prefill_ref(
        q[:, None], k_pool[bt].reshape(b, nb * bs, kv, hd),
        v_pool[bt].reshape(b, nb * bs, kv, hd),
        kpos_pool[bt].reshape(b, nb * bs), pos.to(torch.int32)[:, None],
        window=window)[:, 0]


_CONTINUOUS = {}


@pytest.mark.parametrize("package,mode,read,identical", CASES)
def test_bf16_mode_identity(sides, package, mode, read, identical):
    side = sides[package]
    if package not in _CONTINUOUS:
        _CONTINUOUS[package] = _drive(side)
    want = _CONTINUOUS[package]
    kw = dict(MODES[mode])
    if package == "reference" and read is not None:
        kw["decode_kernel"] = read == "kernel"
    with (mock.patch.object(ops, "paged_attention", fused_numerics_read)
          if read == "fused numerics" else mock.patch.dict({})):
        got = _drive(side, **kw)
    assert sorted(got) == sorted(want)
    assert all(len(t) == 12 for t in got.values())
    assert (got == want) is identical
    if not identical:
        # parted at a tie: the requests agree on their first tokens
        assert all(got[r][0] == want[r][0] for r in want)
