"""Dry-run: every (architecture x input shape x mesh) run as one device
of the production mesh would run it, on fake tensors, with its
per-device memory, FLOPs, bytes, collectives and roofline terms.

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles an SPMD program for 512 fake host devices, this runs the step
itself as rank 0 of a fake ``torch.distributed`` group
(``launch/mesh.py``): parameters, optimizer state, batch and caches are
DTensors on the production ``DeviceMesh`` whose shards are fake tensors
(``FakeTensorMode``: shapes and dtypes, nothing allocated or computed),
placed by the reference's sharding rules (``models/sharding.py``), and
the model's ``shard()`` constraints redistribute its activations, which
is where DTensor issues the collectives.  Nothing runs on any device:
the kernels' entries in ``kernels/ops.py`` take their plain versions
(the shards lie on the CPU), and the plain version is the work counted.

``DeviceCost``, a dispatch mode, reads each op that runs on this
device's shards (it lets DTensor's own dispatch through and sees the
local ops beneath it):

* FLOPs of the matmul-like ops, by ``torch.utils.flop_counter``'s
  formulas at the local shapes (``roofline/analysis.py`` says what that
  leaves out);
* bytes: each op's local inputs and outputs, views and collectives
  excluded (an unfused upper bound);
* collectives: kind, result bytes and the group's ranks;
* memory: the bytes of every storage the step creates, live at once at
  the peak (storages are tracked until freed), on top of the arguments'
  shards.

Per-device memory replaces ``compiled.memory_analysis()``: argument bytes
(the local shards of parameters, optimizer state, batch and caches),
output bytes, the peak (arguments plus the peak of the step's own
storages) and ``fits`` against the card's 80 GiB.  The peak is the plain
versions': the plain attention holds each device's (S, S) scores, which
the card's flash kernel never does.

The time-recurrent cores are not walked step by step: each mamba or
rwkv6 scan is an analytic stand-in (``_analytic_scans``: outputs and
gradients of the right shapes, the inputs kept for the backward as
``ops`` keeps them), and their cost is the reference's
``recurrence_cost``, added per layer by ``assemble_cost`` (x3 in
training), as the reference adds it where XLA counts a scan body once.

``assemble_cost`` composes the per-device totals as the reference does:
one layer of each signature (``Model.layer_signatures``) times its
count, the embed/unembed/loss head and, in training, the optimizer
update.  Training layers recompute their forward in the backward
(``torch.utils.checkpoint``), as the stack's periods do.

Usage (no GPU needed; results as JSON under ``results/dryrun_torch/``):

    python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--variant tp]
    python -m repro_torch.launch.dryrun --all --cost   # + roofline terms
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, InputShape, get_shape
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models.api import Model
from repro_torch.models.module import (abstract_params, param_pspecs,
                                       torch_dtype, tree_leaves, tree_map)
from repro_torch.models.sharding import (Rules, local_shape, make_rules,
                                         spec_placements, use_rules)
from repro_torch.roofline.analysis import (RooflineResult, collective_bytes,
                                           model_flops)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

# long_500k needs sub-quadratic decode state; whisper's decoder is a
# 448-position enc-dec (the reference's shape skips)
LONG_OK = {"rwkv6-1.6b", "jamba-1.5-large-398b", "gemma3-4b"}


def combos(multi_pod: bool):
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_OK:
                continue
            yield arch, shape


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape) if mesh.ndim == 2 else \
        "pod" + "x".join(str(n) for n in mesh.shape)


# ---------------------------------------------------------------- counting

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "wait_tensor"}


def _tensors(tree) -> List[torch.Tensor]:
    # a loop, not a recursive closure: a closure that calls itself is a
    # reference cycle, which would keep the tensors it saw alive until
    # Python's collector runs, and the peak of live storage with them
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
        elif isinstance(x, dict):
            todo.extend(x.values())
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_ranks(name: str) -> Tuple[int, ...]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))


class DeviceCost(torch.utils._python_dispatch.TorchDispatchMode):
    """Reads every op that runs on this device's shards (see the module
    docstring).  DTensor-level ops are deferred (``NotImplemented``) to
    DTensor's dispatch, whose local ops come back here; the fake ops
    DTensor runs on global shapes to propagate metadata are not counted
    (``counting`` marks them)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: List[Tuple[str, float, Tuple[int, ...]]] = []
        self.live = 0
        self.peak = 0
        self.suspended = 0
        self._seen = weakref.WeakSet()

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.suspended:
            return out
        name = func.__name__.split(".")[0]
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.collectives.append(
                    (kind, float(sum(_nbytes(t) for t in _tensors(out))),
                     _group_ranks(args[-1])))
            self._track(out)
            return out
        fn = flop_registry.get(func.overloadpacket)
        if fn is not None:
            self.flops += float(fn(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        self._track(out)
        return out

    def cost(self) -> Dict[str, Any]:
        wb, kinds, secs = collective_bytes(self.collectives)
        return {"flops": self.flops, "bytes": self.bytes,
                "coll_weighted": wb, "coll_seconds": secs,
                "coll_by_kind": kinds}


@contextlib.contextmanager
def counting():
    """A ``DeviceCost`` active over the block; DTensor's fake propagation
    of global shapes runs uncounted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    cost = DeviceCost()
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def uncounted(self, op_schema):
        cost.suspended += 1
        try:
            return orig(self, op_schema)
        finally:
            cost.suspended -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = uncounted
    try:
        with cost:
            yield cost
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


# ------------------------------------------------------- analytic scans


class _ScanStandIn(torch.autograd.Function):
    """Outputs of a recurrent scan's shapes and dtypes, and gradients of
    its inputs', with the inputs (and mamba's checkpoints) kept for the
    backward as ``ops``'s Functions keep them."""

    @staticmethod
    def forward(ctx, out_meta, keep, *inputs):
        ctx.save_for_backward(*inputs, *keep)
        ctx.n = len(inputs)
        ctx.strides = [t.stride() for t in inputs]
        return tuple(torch.empty(s, dtype=d, device=inputs[0].device)
                     for s, d in out_meta)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors[:ctx.n]
        return (None, None) + tuple(
            torch.empty_strided(t.shape, st, dtype=t.dtype, device=t.device)
            if need else None
            for t, st, need in zip(saved, ctx.strides,
                                   ctx.needs_input_grad[2:]))


def _rwkv6_stand_in(r, k, v, w, u, s0=None):
    b, h, _, hd = r.shape
    if s0 is None:
        s0 = r.new_zeros((b, h, hd, hd), dtype=torch.float32)
    meta = ((r.shape, r.dtype), ((b, h, hd, hd), torch.float32))
    return _ScanStandIn.apply(meta, (), r, k, v, w, u, s0)


def _ssm_stand_in(dt, bm, cm, x, a, h0):
    from repro_torch.kernels.ref import SSM_CKPT_STEPS

    b, s, di = x.shape
    meta = ((x.shape, x.dtype), (h0.shape, torch.float32))
    keep = ()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dt, bm, cm, x, a, h0)):
        n = -(-s // SSM_CKPT_STEPS) - 1
        keep = (h0.new_empty((b, n) + tuple(h0.shape[1:]),
                             dtype=torch.float32),)
    return _ScanStandIn.apply(meta, keep, dt, bm, cm, x, a, h0)


@contextlib.contextmanager
def _analytic_scans():
    """The models' ``ops.rwkv6_scan`` / ``ops.ssm_scan`` calls answered by
    the stand-ins for the duration of a lowering (their plain versions
    walk S steps in Python: minutes a layer at 32,768 steps)."""
    from repro_torch.kernels import ops

    saved = ops.rwkv6_scan, ops.ssm_scan
    ops.rwkv6_scan, ops.ssm_scan = _rwkv6_stand_in, _ssm_stand_in
    try:
        yield
    finally:
        ops.rwkv6_scan, ops.ssm_scan = saved


# ---------------------------------------------------------------- helpers


def distribute(abstract, specs, mesh, requires_grad: bool = False):
    """Fake global tensors + their specs -> DTensors on ``mesh`` whose
    shards are fake tensors of the local shapes (nothing allocated)."""
    from torch.distributed.tensor import DTensor

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def one(t, spec):
        shape = tuple(t.shape)
        loc = t.new_empty(local_shape(spec, shape, sizes))
        stride, n = [], 1
        for dim in reversed(shape):
            stride.insert(0, n)
            n *= dim
        d = DTensor.from_local(loc, mesh, spec_placements(mesh, spec),
                               run_check=False, shape=torch.Size(shape),
                               stride=tuple(stride))
        return d.requires_grad_(True) if requires_grad else d

    def walk(a, s):
        if isinstance(a, dict):
            return {k: walk(a[k], s[k]) for k in a}
        return one(a, s)

    return walk(abstract, specs)


def local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def _batch_pspecs(batch_abs, rules: Rules):
    """Batch sharded over (pod, data), shape-filtered (a batch of 1 stays
    replicated)."""
    return {k: rules.spec(("batch",) + (None,) * (v.dim() - 1),
                          tuple(v.shape))
            for k, v in batch_abs.items() if k != "caches"}


def _opt_abstract(params_abs):
    f32 = lambda t: t.new_empty(t.shape, dtype=torch.float32)  # noqa: E731
    return {"mu": tree_map(f32, params_abs), "nu": tree_map(f32, params_abs)}


@contextlib.contextmanager
def _lowering(rules: Rules):
    """Fake tensors, implicit replication of plain tensors, the rules and
    the analytic scans, as every lowering below runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode() as fake, implicit_replication(), \
            use_rules(rules), _analytic_scans():
        yield fake


@dataclasses.dataclass
class Lowered:
    """One step as one device runs it."""
    cost: Dict[str, Any]          # DeviceCost.cost()
    argument_bytes: int
    output_bytes: int
    peak_bytes: int               # arguments + the step's own storages
    seconds: float
    collectives: list             # (kind, bytes, group ranks) each


# ---------------------------------------------------------------- lowering


def lower_step(model: Model, shape: InputShape, mesh, variant: str
               ) -> Lowered:
    """The whole train (``Model.loss`` + ``make_train_step`` + ``adamw``),
    prefill or decode step for one combo, on rank 0's fake shards."""
    from repro_torch.core.trainer import make_train_step
    from repro_torch.optim import adamw

    cfg = model.cfg
    rules = make_rules(mesh, shape.mode, variant)
    t0 = time.time()
    with _lowering(rules):
        pspecs = model.param_pspecs(rules)
        specs = model.input_specs(shape)
        batch = distribute({k: v for k, v in specs.items() if k != "caches"},
                           _batch_pspecs(specs, rules), mesh)
        params = distribute(model.abstract_params(), pspecs, mesh)
        args = [params, batch]
        if shape.mode == "train":
            opt_abs = _opt_abstract(model.abstract_params())
            opt = {"count": torch.zeros((), dtype=torch.int32),
                   **distribute(opt_abs, {"mu": pspecs, "nu": pspecs}, mesh)}
            args.append(opt)
            step = make_train_step(lambda p, b: model.loss(p, b), adamw(1e-4))
            fn = lambda: step(params, opt, batch)  # noqa: E731
        elif shape.mode == "prefill":
            fn = lambda: model.prefill(  # noqa: E731
                params, batch, cache_max=shape.seq_len)
        else:
            caches = distribute(specs["caches"], model.cache_pspecs(
                rules, shape.global_batch, shape.seq_len), mesh)
            args.append(caches)
            fn = lambda: model.decode_step(  # noqa: E731
                params, caches, batch["tokens"], batch["pos"])
        arg_bytes = local_bytes(args)
        grad = torch.enable_grad() if shape.mode == "train" else \
            torch.no_grad()
        with grad, counting() as cost:
            out = fn()
            out_bytes = local_bytes(out)
            del out
        peak = cost.peak
    return Lowered(cost.cost(), arg_bytes, out_bytes, arg_bytes + peak,
                   time.time() - t0, cost.collectives)


def memory(low: Lowered) -> Dict[str, Any]:
    return {"argument_gib": low.argument_bytes / 2**30,
            "output_gib": low.output_bytes / 2**30,
            "peak_gib": low.peak_bytes / 2**30,
            "fits": low.peak_bytes <= HBM_BYTES}


# ------------------------------------------------------- compositional cost


def _positions(cfg, n: int):
    pos = torch.arange(n, dtype=torch.int32)
    return torch.clamp(pos, max=cfg.max_position - 1) if (
        cfg.pos_kind == "learned") else pos


def _layer_cost(model: Model, shape: InputShape, mesh, variant: str,
                sig: Tuple[str, bool]) -> Dict[str, Any]:
    """One layer of signature ``sig`` under the same rules -> its
    per-device cost, the recurrent cores' analytic scan cost added."""
    from torch.utils.checkpoint import checkpoint

    cfg = model.cfg
    kind, moe = sig
    mode = shape.mode
    rules = make_rules(mesh, mode, variant)
    schema = tf.block_schema(cfg, kind, moe)
    b = shape.global_batch
    s = shape.seq_len if mode != "decode" else 1
    dt = torch_dtype(cfg.dtype)
    with _lowering(rules):
        p = distribute(abstract_params(schema, cfg.dtype),
                       param_pspecs(schema, rules), mesh)
        x_abs = torch.empty((b, s, cfg.d_model), dtype=dt)
        x = distribute(x_abs, rules.spec(("batch", None, None),
                                         tuple(x_abs.shape)), mesh)
        if mode == "train":
            x.requires_grad_(True)
            leaves = [t.detach().requires_grad_(True) for t in
                      tree_leaves(p)]
            it = iter(leaves)
            p = tree_map(lambda _: next(it), p)
            positions = _positions(cfg, s)

            def block(x, *flat):
                it = iter(flat)
                pp = tree_map(lambda _: next(it), p)
                y, aux = tf.block_apply_train(pp, cfg, x, positions,
                                              kind=kind, moe=moe)
                return y, aux

            remat = not cfg.is_encoder_decoder
            with torch.enable_grad(), counting() as cost:
                y, aux = (checkpoint(block, x, *leaves, use_reentrant=False,
                                     preserve_rng_state=False) if remat
                          else block(x, *leaves))
                loss = torch.sum(y.float()) + aux
                torch.autograd.grad(loss, [x] + leaves)
        elif mode == "prefill":
            with torch.no_grad(), counting() as cost:
                tf.block_prefill(p, cfg, x, _positions(cfg, s), kind=kind,
                                 moe=moe, cache_max=shape.seq_len)
        else:
            cache_abs = tf.block_cache_abstract(cfg, kind, b, shape.seq_len,
                                                dt)
            logical = tf.block_cache_logical(cfg, kind)
            cache = distribute(cache_abs, {k: rules.spec(
                logical[k], tuple(cache_abs[k].shape)) for k in cache_abs},
                mesh)
            pos = distribute(torch.empty((b,), dtype=torch.int32),
                             rules.spec(("batch",), (b,)), mesh)
            with torch.no_grad(), counting() as cost:
                tf.block_decode(p, cfg, x, cache, pos, kind=kind, moe=moe)
    c = cost.cost()
    n_dev = mesh.size()
    # the recurrence, analytic (the stand-ins count nothing)
    rec = {"mamba": ssm_mod, "rwkv6": rwkv_mod}.get(kind)
    if rec is not None:
        fl, by = rec.recurrence_cost(cfg, b, s)
        scale = 3.0 if mode == "train" else 1.0
        c["flops"] += scale * fl / n_dev
        c["bytes"] += scale * by / n_dev
    return c


def _head_cost(model: Model, shape: InputShape, mesh, variant: str
               ) -> Dict[str, Any]:
    """Embed -> unembed -> loss (train: + gradients).  Decode: one
    token."""
    from repro_torch.models.layers import (embed_apply, embed_schema,
                                           softmax_xent, unembed_apply)

    cfg = model.cfg
    mode = shape.mode
    rules = make_rules(mesh, mode, variant)
    schema = embed_schema(cfg)
    b = shape.global_batch
    s = shape.seq_len if mode != "decode" else 1
    with _lowering(rules):
        p = distribute(abstract_params(schema, cfg.dtype),
                       param_pspecs(schema, rules), mesh,
                       requires_grad=mode == "train")
        tok_abs = torch.empty((b, s), dtype=torch.int32)
        tok_spec = rules.spec(("batch", None), (b, s))
        toks = distribute(tok_abs, tok_spec, mesh)
        positions = _positions(cfg, s)[None] if cfg.pos_kind == "learned" \
            else None
        if mode == "train":
            labels = distribute(tok_abs, tok_spec, mesh)
            with torch.enable_grad(), counting() as cost:
                logits = unembed_apply(p, cfg,
                                       embed_apply(p, cfg, toks, positions))
                loss = softmax_xent(logits, labels)
                torch.autograd.grad(loss, tree_leaves(p))
        else:
            with torch.no_grad(), counting() as cost:
                unembed_apply(p, cfg, embed_apply(p, cfg, toks, positions))
    return cost.cost()


def _optimizer_cost(model: Model, mesh, variant: str) -> Dict[str, Any]:
    """The adamw update over the whole parameter tree, as the train step
    writes it (``_donated_update``, on each device's shards)."""
    from repro_torch.core.trainer import _donated_update
    from repro_torch.optim import adamw

    rules = make_rules(mesh, "train", variant)
    with _lowering(rules):
        pspecs = model.param_pspecs(rules)
        params = distribute(model.abstract_params(), pspecs, mesh)
        grads = distribute(model.abstract_params(), pspecs, mesh)
        opt = {"count": torch.zeros((), dtype=torch.int32),
               **distribute(_opt_abstract(model.abstract_params()),
                            {"mu": pspecs, "nu": pspecs}, mesh)}
        with torch.no_grad(), counting() as cost:
            _donated_update(adamw(1e-4), tree_leaves(grads), opt, params)
    return cost.cost()


_SUMMED = ("flops", "bytes", "coll_weighted", "coll_seconds")


def assemble_cost(model: Model, shape: InputShape, mesh, variant: str
                  ) -> Dict[str, Any]:
    """Compositional per-device totals (see the module docstring)."""
    cfg = model.cfg
    total = dict.fromkeys(_SUMMED, 0.0)
    kinds_total: Dict[str, float] = {}
    parts = {}

    def add(c, count=1):
        for k in _SUMMED:
            total[k] += count * c[k]
        for k, v in c["coll_by_kind"].items():
            kinds_total[k] = kinds_total.get(k, 0.0) + count * v

    for sig, count in model.layer_signatures().items():
        c = _layer_cost(model, shape, mesh, variant, sig)
        parts[f"layer_{sig[0]}{'_moe' if sig[1] else ''}"] = {
            **c, "count": count}
        add(c, count)
    parts["head"] = _head_cost(model, shape, mesh, variant)
    add(parts["head"])
    if shape.mode == "train":
        parts["optimizer"] = _optimizer_cost(model, mesh, variant)
        add(parts["optimizer"])

    rr = RooflineResult(total["flops"], total["bytes"],
                        total["coll_weighted"], kinds_total,
                        total["coll_seconds"])
    mf = model_flops(cfg, shape)
    n_dev = mesh.size()
    return {
        "per_device": total,
        "terms": rr.terms(),
        "parts": {k: {kk: vv for kk, vv in v.items() if kk != "coll_by_kind"}
                  for k, v in parts.items()},
        "coll_by_kind": kinds_total,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_ratio": (mf / n_dev) / max(total["flops"], 1.0),
    }


# ---------------------------------------------------------------- runner


def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              variant: str = "tp", with_cost: bool = False,
              kv_quant: bool = False, out_dir: Optional[str] = None,
              verbose: bool = True, mesh=None) -> Dict[str, Any]:
    """Lower one combo (and with ``with_cost`` assemble its roofline) on
    the production mesh, or on ``mesh`` where given."""
    cfg = get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_cache_quant=True)
        variant_name = variant + "+kvq"
    else:
        variant_name = variant
    shape = get_shape(shape_name)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
    model = Model(cfg, "cpu")
    name = mesh_name(mesh)

    t0 = time.time()
    low = lower_step(model, shape, mesh, variant)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": name,
        "variant": variant_name, "lower_seconds": round(low.seconds, 1),
        "memory": memory(low),
        "full_step_cost": {**low.cost,
                           "note": "matmul FLOPs; recurrences not counted"},
    }
    if with_cost:
        result["assembled"] = assemble_cost(model, shape, mesh, variant)
    result["seconds"] = round(time.time() - t0, 1)
    if verbose:
        mem = result["memory"]
        line = (f"{arch:22s} {shape_name:12s} {name:10s} {variant_name:6s} "
                f"lower={low.seconds:5.1f}s peak={mem['peak_gib']:7.2f}GiB "
                f"fits={mem['fits']!s:5s}")
        if with_cost:
            t = result["assembled"]["terms"]
            line += (f" compute={t['compute_s']*1e3:9.3f}ms "
                     f"memory={t['memory_s']*1e3:9.3f}ms "
                     f"coll={t['collective_s']*1e3:9.3f}ms "
                     f"dom={t['dominant']}")
        line += f" ({result['seconds']:.1f}s)"
        print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{arch}__{shape_name}__{name}__{variant_name}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(result, f, indent=1, default=float)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="tp",
                    choices=["dp", "tp", "fsdp", "sp"])
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode shapes)")
    ap.add_argument("--cost", action="store_true",
                    help="assemble compositional roofline terms")
    ap.add_argument("--out", default=os.path.abspath(RESULTS_DIR))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        todo = list(combos(args.multi_pod))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    name = mesh_name(mesh)
    variant = args.variant + ("+kvq" if args.kv_quant else "")
    failures = []
    for arch, shape in todo:
        fname = os.path.join(args.out, f"{arch}__{shape}__{name}__{variant}"
                             ".json")
        if args.skip_existing and os.path.exists(fname):
            print(f"skip {arch} {shape} (cached)", flush=True)
            continue
        try:
            run_combo(arch, shape, multi_pod=args.multi_pod,
                      variant=args.variant, with_cost=args.cost,
                      kv_quant=args.kv_quant, out_dir=args.out, mesh=mesh)
        except Exception as e:  # noqa: BLE001 — report every combo
            import traceback
            failures.append((arch, shape, repr(e)))
            print(f"FAIL {arch} {shape}: {e!r}", flush=True)
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures")
        raise SystemExit(1)
    print("\nall combos ran")


if __name__ == "__main__":
    main()
