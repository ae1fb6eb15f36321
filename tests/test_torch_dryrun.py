"""The port's dry-run on fake meshes of a fake process group (one
process, fake tensors, nothing allocated): per-device FLOPs from the
local shards, argument bytes against the reference's specs, the
compositional assembly against the whole step, the collectives a
sharded step records, and the CLI.

The fake group is process-wide: a module-scoped fixture makes it and
destroys it, so no other test in the worker sees it."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, InputShape  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (init_fake_world,  # noqa: E402
                                     make_host_mesh, make_production_mesh)
from repro_torch.models.api import Model  # noqa: E402
from repro_torch.models.sharding import make_rules, use_rules  # noqa: E402

TINY = {m: InputShape(m, 64, 4, m) for m in ("train", "prefill", "decode")}


@pytest.fixture(scope="module")
def world():
    import torch.distributed as dist

    init_fake_world(512)
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh22(world):
    return make_host_mesh(model_parallel=2, data_parallel=2)


def reduced(arch, **kw):
    cfg = get_config(arch).reduced()
    if cfg.num_experts:
        kw.setdefault("moe_capacity_factor",
                      float(cfg.num_experts) / cfg.num_experts_per_tok)
    return dataclasses.replace(cfg, **kw)


def test_combos_are_the_references():
    from repro.launch.dryrun import LONG_OK, combos

    assert list(dryrun.combos(False)) == list(combos(False))
    assert len(list(dryrun.combos(False))) == 33
    assert dryrun.LONG_OK == LONG_OK


def test_column_parallel_counts_its_shard(world):
    """A column-parallel product on the 16-way ``model`` axis counts 1/16
    of its global FLOPs on each device (FlopCounterMode, at the DTensor
    level, would count all of them)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_production_mesh()
    b, d, f = 64, 1024, 4096
    with dryrun._lowering(make_rules(mesh, "train", "tp")):
        x = dryrun.distribute(torch.empty(b, d), (None, None), mesh)
        w = dryrun.distribute(torch.empty(d, f), (None, "model"), mesh)
        with dryrun.counting() as cost:
            y = x @ w
    assert list(y.placements) == [Replicate(), Shard(1)]
    assert cost.flops == 2 * b * d * f / 16
    assert cost.collectives == []


def _local_bytes(spec, shape, itemsize, sizes):
    n = itemsize
    for dim, entry in zip(shape, tuple(spec)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        for a in axes:
            dim //= sizes[a]
        n *= dim
    return n


def _ref_bytes(specs, abstract, sizes):
    import jax
    from jax.sharding import PartitionSpec

    leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, PartitionSpec))
    return sum(_local_bytes(s, a.shape, a.dtype.itemsize, sizes)
               for s, a in zip(leaves, jax.tree.leaves(abstract)))


def test_argument_bytes_are_the_reference_specs_shards(world, mesh22):
    """Per-device argument bytes: the local shards of the parameters,
    caches and batch (train: and the adamw moments), from the reference's
    PartitionSpecs; whisper-tiny decode_32k on the production mesh and a
    reduced qwen3 train step on (2, 2)."""
    import types

    import numpy as np

    from repro.models.api import Model as RefModel
    from repro.models.sharding import make_rules as ref_rules

    mesh = make_production_mesh()
    shape = SHAPES["decode_32k"]
    cfg = get_config("whisper-tiny")
    low = dryrun.lower_step(Model(cfg, "cpu"), shape, mesh, "tp")
    stand_in = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.empty((16, 16)))
    rules = ref_rules(stand_in, "decode", "tp")
    sizes = {"data": 16, "model": 16}
    ref = RefModel(cfg)
    b = shape.global_batch
    want = (_ref_bytes(ref.param_pspecs(rules), ref.abstract_params(), sizes)
            + _ref_bytes(ref.cache_pspecs(rules, b, shape.seq_len),
                         ref.cache_abstract(b, shape.seq_len), sizes)
            + 2 * (b // 16) * 4)                      # tokens, pos
    assert low.argument_bytes == want
    assert 0 < low.output_bytes <= low.peak_bytes

    cfg = reduced("qwen3-0.6b")
    stand_in.devices = np.empty((2, 2))
    rules = ref_rules(stand_in, "train", "tp")
    sizes = {"data": 2, "model": 2}
    low = dryrun.lower_step(Model(cfg, "cpu"), TINY["train"], mesh22, "tp")
    from repro.configs.base import get_config as ref_config

    ref = RefModel(dataclasses.replace(ref_config("qwen3-0.6b").reduced()))
    params = _ref_bytes(ref.param_pspecs(rules), ref.abstract_params(), sizes)
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    want = params * (1 + 2 * 4 // itemsize) + 4 + 2 * (4 // 2) * 64 * 4
    assert low.argument_bytes == want


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_assembly_matches_the_whole_step(mode, mesh22):
    """A 2-layer reduced qwen3 (float32) on (2, 2): the compositional
    FLOPs are the whole step's (both count matmuls).  Prefill's head
    unembeds every position where the step unembeds the last."""
    cfg = reduced("qwen3-0.6b", num_layers=2, dtype="float32")
    model, shape = Model(cfg, "cpu"), TINY[mode]
    whole = dryrun.lower_step(model, shape, mesh22, "tp").cost["flops"]
    asm = dryrun.assemble_cost(model, shape, mesh22, "tp")
    composed = asm["per_device"]["flops"]
    if mode == "prefill":
        head = asm["parts"]["head"]["flops"]
        composed -= head * (shape.seq_len - 1) / shape.seq_len
    assert whole > 0
    assert composed == pytest.approx(whole, rel=1e-12)
    assert asm["model_flops_global"] > 0 and asm["useful_ratio"] > 0


def test_recurrent_layers_add_their_analytic_scan(mesh22):
    """rwkv6 (2 layers, reduced) training: the assembly is the whole
    step's matmuls plus each layer's ``recurrence_cost`` x 3 over the
    devices; the step itself walks no recurrence."""
    from repro_torch.models import rwkv6 as rwkv_mod

    cfg = reduced("rwkv6-1.6b", num_layers=2, dtype="float32")
    model, shape = Model(cfg, "cpu"), TINY["train"]
    whole = dryrun.lower_step(model, shape, mesh22, "tp").cost["flops"]
    asm = dryrun.assemble_cost(model, shape, mesh22, "tp")
    fl, _ = rwkv_mod.recurrence_cost(cfg, shape.global_batch,
                                     shape.seq_len)
    assert asm["per_device"]["flops"] == pytest.approx(
        whole + 2 * 3 * fl / 4, rel=1e-12)


def _groups(mesh, axis):
    import torch.distributed as dist

    return tuple(dist.get_process_group_ranks(mesh.get_group(axis)))


def test_sharded_steps_record_their_collectives(mesh22):
    """Reduced qwen3 training on (2, 2): under ``tp`` the row-parallel
    products all-reduce over ``model`` and the gradients over ``data``;
    under ``dp`` the step's only collectives are all-reduces over
    ``data`` (the gradients', and the loss's mean)."""
    cfg = reduced("qwen3-0.6b", num_layers=2)
    model = Model(cfg, "cpu")
    data, mdl = _groups(mesh22, "data"), _groups(mesh22, "model")
    tp = dryrun.lower_step(model, TINY["train"], mesh22, "tp")
    assert tp.cost["coll_by_kind"]["all-reduce"] > 0
    dp = dryrun.lower_step(model, TINY["train"], mesh22, "dp")
    assert {k for k, _, _ in dp.collectives} == {"all-reduce"}
    assert {r for _, _, r in dp.collectives} == {data}
    assert {r for _, _, r in tp.collectives} == {data, mdl}


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "gemma3-4b",
                                  "whisper-tiny", "dbrx-132b"])
def test_every_mode_runs_sharded(arch, mesh22):
    """Reduced hybrid, sliding-window, encoder-decoder and MoE stacks run
    each mode's step on (2, 2) under ``tp``, with nothing allocated."""
    model = Model(reduced(arch), "cpu")
    for mode in ("train", "prefill", "decode"):
        low = dryrun.lower_step(model, TINY[mode], mesh22, "tp")
        mem = dryrun.memory(low)
        assert low.cost["flops"] > 0 and mem["peak_gib"] > 0, mode
        assert mem["fits"]


def test_shard_without_mesh_rules_returns_the_tensor():
    from repro_torch.models.sharding import shard

    x = torch.ones(2, 2)
    with use_rules(None):
        assert shard(x, "batch", None) is x


def test_cli_writes_a_combo(world, tmp_path, capsys):
    """``--arch --shape --cost`` on the production mesh: one JSON with the
    memory, the full step's cost, the assembled terms and the useful
    ratio."""
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                 "--cost", "--out", str(tmp_path)])
    out = json.loads((tmp_path / "whisper-tiny__decode_32k__16x16__tp.json")
                     .read_text())
    assert set(out["memory"]) == {"argument_gib", "output_gib", "peak_gib",
                                  "fits"}
    asm = out["assembled"]
    assert set(asm["terms"]) == {"compute_s", "memory_s", "collective_s",
                                 "dominant"}
    assert asm["model_flops_global"] > 0 and asm["useful_ratio"] > 0
    assert "all combos ran" in capsys.readouterr().out
