"""Config-matrix identity suite of the port: the coverage gate for its
paged engine, as ``tests/test_config_matrix.py`` is the reference's.

Every architecture the port carries must serve through
``PagedLLMEngine`` token-identical to the slot engine at reduced shapes
(sliding-window, hybrid recurrent, MoE, GQA alike), float32, the
reference's seed-0 weights bridged, MoE under dropless capacity (a row
padded to a bucket would otherwise drop other tokens than the slot
engine's exact-length prefill).  A carried config that does not page is
a failure, not a skip: the port carries none of the reference's
unpageable configs (encoder-decoder, multimodal), and ``Model`` refuses
them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from conftest import reduced_cfg  # noqa: E402
from repro.models.api import Model as JaxModel  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import _MODULE_FOR, get_config  # noqa: E402
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.serving.server import LLMEngine, PagedLLMEngine  # noqa: E402
from repro_torch.serving.stats_schema import validate  # noqa: E402

CARRIED = sorted(_MODULE_FOR)
# the reference's unpageable configs: not carried by the port
UNPAGEABLE = ("whisper-tiny", "paligemma-3b")
# the reference suite's tight pools (block_size 4, 12-token prompts,
# max_new 12): they force preempt-and-requeue
_TIGHT_POOL = {"gemma3-4b": 10, "jamba-1.5-large-398b": 10,
               "rwkv6-1.6b": 7}

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = reduced_cfg(arch)
        port_cfg = dataclasses.replace(
            get_config(arch).reduced(),
            moe_capacity_factor=cfg.moe_capacity_factor)
        assert dataclasses.asdict(port_cfg) == dataclasses.asdict(cfg)
        tree = jax.tree.map(np.asarray,
                            JaxModel(cfg).init(jax.random.PRNGKey(0)))
        _MODELS[arch] = (Model(port_cfg, device="cpu"),
                         params_from_jax(tree, device="cpu"))
    return _MODELS[arch]


def _drain(engine, max_steps=3000):
    outs = {}
    for _ in range(max_steps):
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
        if engine.idle:
            break
    assert engine.idle
    return outs


def test_carries_the_new_architectures():
    assert {"dbrx-132b", "grok-1-314b", "jamba-1.5-large-398b",
            "rwkv6-1.6b"} <= set(CARRIED)


@pytest.mark.parametrize("arch", CARRIED)
def test_paged_matches_slot_for_config(arch):
    """Roomy pool: paged output equals the slot engine's token for
    token, and both stats dicts pass the schema."""
    model, params = _model(arch)
    assert model.supports_paged, (
        f"{arch} no longer routes to the paged engine — the config "
        "matrix does not allow silent slot-engine fallback")
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, 8).astype(np.int32)
               for _ in range(3)]

    slot = LLMEngine(model, params, num_slots=3, cache_max=64)
    for p in prompts:
        slot.submit(p, max_new=6)
    slot_outs = _drain(slot)

    paged = PagedLLMEngine(model, params, num_blocks=32, block_size=4,
                           max_batch=8, max_len=64)
    for p in prompts:
        paged.submit(p, max_new=6)
    paged_outs = _drain(paged)

    assert paged_outs == slot_outs
    assert paged.allocator.num_live == 0
    validate(paged.stats())
    validate(slot.stats())


@pytest.mark.parametrize("arch", sorted(_TIGHT_POOL))
def test_paged_identity_under_preemption_with_prefix_cache(arch):
    """A pool too small for the batch forces preempt-and-requeue, with
    the prefix cache requested on: outputs still match the slot engine
    exactly, and recurrent stacks report the cache off."""
    model, params = _model(arch)
    cfg = model.cfg
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, 12).astype(np.int32)
               for _ in range(4)]

    slot = LLMEngine(model, params, num_slots=4, cache_max=64)
    for p in prompts:
        slot.submit(p, max_new=12)
    slot_outs = _drain(slot)

    tight = PagedLLMEngine(model, params,
                           num_blocks=_TIGHT_POOL[arch], block_size=4,
                           max_batch=8, max_len=64, prefix_cache=True)
    for p in prompts:
        tight.submit(p, max_new=12)
    outs = {}
    for _ in range(4):
        for r in tight.step():
            outs[r.rid] = list(r.out_tokens)
    if not tight.preemptions:
        # eager window freeing can keep even this pool pressure-free
        # (rwkv6 holds <= 2 blocks a request): force one mid-decode
        # eviction so the resume path runs on every arch
        tight._preempt_youngest()
    outs.update(_drain(tight))

    assert tight.preemptions > 0
    assert outs == slot_outs
    s = validate(tight.stats())
    assert tight.allocator.num_live == s["cached_blocks"]
    if model.paged_has_state:
        assert s["prefix_cache"] == 0


@pytest.mark.parametrize("arch", UNPAGEABLE)
def test_unpageable_config_is_not_carried(arch):
    with pytest.raises(KeyError, match="not carried"):
        get_config(arch)
