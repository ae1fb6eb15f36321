#!/usr/bin/env python3
"""Time a conv kernel, the selective scan or its backward, the WKV6
backward, an int8 attention kernel or the ragged prefill's pool entries
of several checkouts on one card, in turns.

    python3 conv2d_compare.py [--kernel KERNEL] [--need SUBSET ...] TREE [TREE ...]

KERNEL: conv2d (the default), conv2d_wgrad, ssm_scan, ssm_scan_bwd,
rwkv6_scan_bwd, paged_prefill_int8, paged_attention_int8,
paged_prefill_pool, attention_bits or flash_attention.  Each TREE is the root of a checkout holding
``src/repro_torch`` (for another commit: ``git archive <commit> | tar -x
-C build/<dir>``).  The trees run in the order given and then in reverse
(parent, change, change, parent), each in a child process of its own,
since two ``repro_torch`` packages cannot share one.  A child builds that
tree's kernel into the tree's ``build/``, holds it against the plain
version, and times it with ``chip_smoke.py``'s two methods: events
around one launch (``time_ms``) and CUDA-graph replay (``graph_ms``);
beside it the floor (one launch on one element), both ways.  ``conv2d``:
the forward conv at the paper's shape (28x28x1 images, 32 filters of
3x3, float32) at B = 1, 32 and 2000, beside cuDNN (``F.conv2d``, TF32
off).  ``conv2d_wgrad``: the filter gradient at B = 64, 320 and 2000,
beside ``torch.nn.grad.conv2d_weight``.  ``ssm_scan``: mamba's selective
scan at ``chip_smoke.py``'s ``SSM_SHAPES`` and one row of S = 2,048
(jamba's d_inner 16,384), float32, and with bf16 x and y where the
tree's kernel takes them (no library call computes it).
``rwkv6_scan_bwd``: the WKV6 backward at ``chip_smoke.py``'s
``SCAN_BWD_SHAPES`` (32 heads of 64, a start state and a final-state
gradient), held to the plain backward within ``BWD_GRAD_REL`` x max|g|
(no library call either); each ``--need`` SUBSET (gradient names joined
by commas, of dr, dk, dv, dw, du, ds0; default all six) is timed on its
own.  ``ssm_scan_bwd``: mamba's selective-scan backward at
``SCAN_BWD_SHAPES`` (jamba's d_inner 16,384, a start state and a
final-state gradient) against the plain backward, the same way, with
``--need`` subsets of ddt, dbm, dcm, dx, da, dh0; where the tree's
backward reads the forward's checkpoints (a ``ckpt`` argument) they are
made before the timing by the tree's training forward, which is timed
too (``ssm_scan_fwd_ckpt``); where a SUBSET is all six, the serving
forward at ``SSM_TIMED`` is timed beside it, as ``--kernel ssm_scan``
times it.  ``paged_attention_int8``: the int8 KV
cache's decode in bf16 at phase 7's int8 decode shapes (8 rows x 32
blocks of 16 at 16/8 heads; tables of 16 blocks at the dense configs'
and gemma3-4b's heads), each bit-equal to the bf16 kernel over the
dequantized pools and timed beside it, the outputs' SHA-256 printed.
``paged_prefill_int8``: the int8 KV cache's ragged prefill in bf16
at phase 7's four int8 shapes (a chunk of S = 256 over an int8 prefix of
512, fused decode, slot decode, spec verify), each held bit-equal to the
bf16 kernel over the concatenated dequantized keys and timed beside it
and beside SDPA on those keys; the outputs' SHA-256 is printed, the same
in every run where the trees' kernels give the same bits.
``paged_prefill_pool``: the paged engine's attention at
``chip_smoke.py``'s ``pool_timing_cases`` (bf16; a chunk of S = 256,
fused decode and spec verify over a pool of 16-lane blocks, float and
int8, and gemma3-4b's three head_dim-256 shapes): in every tree the
composed path (the prefix gathered through the block table, the cursor
guard, the concatenation with the chunk and the contiguous entry; int8:
the gather, the guard and ``paged_prefill_int8``), and where the tree
has them the pool entries (``ops.paged_prefill_pool`` and
``paged_prefill_pool_int8``, which read the pool through the table),
each held bit-equal to the composed path; both timed, their chunk and
fused-decode launches split by kernel; the bf16 tile each case runs
(``tile_of``); the outputs' SHA-256; the tree's
``ptxas -v`` of ``paged_prefill``, ``paged_prefill_int8`` and
``flash_attention``; in the first run of the last TREE a sweep of the
pool entry over forced tiles a piece at ``PAGED_SWEEP``'s shapes, with
the Hopper tile's makespan constants fit to it (``fit_paged_planner``);
and one fused decode dispatch (8 rows, one token
each after 512 cached) and one chunk dispatch (8 rows of 256 tokens
after 512) of qwen3-0.6b (28 layers) and gemma3-4b (34), uncut, bf16,
through ``ragged_dispatch`` under the profiler: kernels launched, and
device ms of the attention kernels, the gathers and the
concatenations.
``attention_bits``: ``flash_attention``, ``paged_prefill`` and
``paged_prefill_int8`` at the shapes ``chip_smoke.py`` checks
without a prefix (phase 2's, the draft's, the dense configs' and
gemma3-4b's heads, windows 0 and 64 / 1,024), bf16 and float32: each
output's SHA-256, which must be the same in every run (a bf16 ragged
prefill named by its tile, ``paged_prefill:mma`` for the kWarpKeys
decode tile and ``paged_prefill:wgmma`` for the Hopper tile, so each
tile's bits are compared with the parent's on their own), and each tree's
``ptxas -v`` registers and spills of those kernels' instantiations, a
prefix instantiation's (``kPrefix``, that tree's own) left out; the
digests are compared kernel by kernel, so a tree whose flash tile
changed still shows whether ``paged_prefill``'s bits did.  The full
launches are also split by kernel under ``torch.profiler`` (device time
a call).
``flash_attention``: the whole-prompt kernel in bf16 at ``chip_smoke.py``'s
phase-7 flash shapes (one causal row of S = 512 and 2,048 at 16/8 heads
of 128 and at gemma3-4b's 8/4 of 256, the draft's ``DRAFT_SHAPES``) and
``FRONTEND_FA_SHAPES``
(whisper's encoder and cross-attention, paligemma's prefix-LM): each
held to the plain version within ``KERNEL_TOL``, timed both ways beside
SDPA (the prefix as a boolean mask), with its plan (tiles a piece,
CTAs) and its bound (inputs once over 3.35 TB/s, or 4 hd FLOP a visible
(query head, key) over 989 TFLOP/s); the tree's ``ptxas -v`` of every
``flash_attention`` instantiation; and in the first run of the last
TREE a sweep over forced tiles a piece at ``FLASH_SWEEP``'s shapes, with
the flash planner's makespan constants fit to it
(``fit_flash_planner``).  Prints a line per run, the card's name and power limit, and a
JSON object of every reading last.  Needs one NVIDIA GPU.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BATCHES = {"conv2d": (1, 32, 2000), "conv2d_wgrad": (64, 320, 2000),
           "ssm_scan": (), "ssm_scan_bwd": (), "rwkv6_scan_bwd": (),
           "paged_prefill_int8": (), "paged_attention_int8": (),
           "paged_prefill_pool": (), "attention_bits": (),
           "flash_attention": ()}
GRADS = {"rwkv6_scan_bwd": ("dr", "dk", "dv", "dw", "du", "ds0"),
         "ssm_scan_bwd": ("ddt", "dbm", "dcm", "dx", "da", "dh0")}


def ssm_child(torch, cs, dev) -> dict:
    """The tree's ``ssm_scan`` held against its plain version, then timed
    at ``cs.SSM_TIMED`` in float32 and bf16 x (skipped where the tree's
    wrapper refuses bf16)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss_mod

    gen = torch.Generator(device=dev).manual_seed(9)
    res = {}
    for b, s in cs.SSM_TIMED:
        args = list(cs.ssm_case(torch, gen, dev, b, s))
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            args[3] = args[3].to(dt)
            try:
                y, h = ss_mod.ssm_scan(*args)
            except ValueError:
                continue
            py, ph = ref.ssm_scan_ref(*args)
            torch.testing.assert_close(y.float(), py.float(),
                                       **cs.KERNEL_TOL["ssm_scan", name])
            torch.testing.assert_close(h, ph,
                                       **cs.KERNEL_TOL["ssm_scan", "float32"])
            fn = (lambda args=tuple(args): ss_mod.ssm_scan(*args))
            res[f"ssm_scan_{b}x{s}_{name}"] = (cs.time_ms(torch, fn),
                                               cs.graph_ms(torch, fn))
    return res


def kernel_split(torch, fn, reps=10) -> dict:
    """Device time of one call of ``fn`` by kernel (ms, the mean over
    ``reps`` calls under ``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0:
            name = e.key.split("(")[0].replace("void ", "").split("::")[-1]
            out[name] = out.get(name, 0.0) + t / reps / 1e3
    return out


def rwkv_bwd_child(torch, cs, dev, needs) -> dict:
    """The tree's ``rwkv6_scan_bwd`` held against its plain version, then
    timed at ``cs.SCAN_BWD_SHAPES`` for each subset of gradients in
    ``needs`` (tuples of names from ``GRADS``)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan_bwd as rwb

    gen = torch.Generator(device=dev).manual_seed(13)
    res = {}
    for b, s in cs.SCAN_BWD_SHAPES["rwkv6_scan_bwd"]:
        args = list(cs.rwkv_case(torch, gen, dev, b=b, s=s))
        dout = torch.randn(b, s, 32, 64, generator=gen,
                           device=dev).transpose(1, 2)
        dsf = torch.randn(args[5].shape, generator=gen, device=dev)
        want = ref.rwkv6_scan_bwd_ref(*args, dout, dsf)
        for subset in needs:
            need = tuple(n in subset for n in GRADS["rwkv6_scan_bwd"])
            got = rwb.rwkv6_scan_bwd(*args, dout, dsf, need=need)
            for name, g, w, n in zip(GRADS["rwkv6_scan_bwd"], got, want,
                                     need):
                if n:
                    cs._bwd_err(torch, name, g, w)
            fn = (lambda args=tuple(args), dout=dout, dsf=dsf, need=need:
                  rwb.rwkv6_scan_bwd(*args, dout, dsf, need=need))
            tag = "" if len(subset) == 6 else "_" + "+".join(subset)
            res[f"rwkv6_scan_bwd_{b}x{s}{tag}"] = (cs.time_ms(torch, fn),
                                                   cs.graph_ms(torch, fn))
            if not tag:
                res[f"kernels_{b}x{s}"] = kernel_split(torch, fn)
    return res


def int8_child(torch, cs, dev) -> dict:
    """The tree's ``paged_prefill_int8`` (bf16) at phase 7's four int8
    shapes: bit-equal to the tree's ``paged_prefill`` over the
    concatenated dequantized keys, then both timed, and SDPA over those
    keys (masked as the kernel sees them)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(2)
    spec_gen = torch.Generator(device=dev).manual_seed(6)
    dt = torch.bfloat16
    shapes = (("s256", cs.prefill_case(torch, gen, dev, dt), 512),
              ("s1", cs.prefill_case(torch, gen, dev, dt, b=8, s=1), 512),
              ("slot", cs.slot_decode_case(torch, gen, dev, dt), 256),
              ("verify", cs.verify_case(torch, spec_gen, dev, dt), 256))
    res, digests = {"digests": {}}, {}
    for name, args, lp in shapes:
        i8 = cs.int8_prefill_args(args, lp)
        deq = cs.dequantized_args(torch, ref, i8)
        out = ops.paged_prefill_int8(*i8)
        dense = ops.paged_prefill(*deq)
        torch.cuda.synchronize()
        assert torch.equal(out, dense), \
            f"paged_prefill_int8 {name}: not bit-equal to the bf16 kernel"
        digests[name] = hashlib.sha256(
            out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        mask = cs.prefill_visible(torch, deq[3], deq[4], 0)[:, None]
        for key, fn in (
                (f"paged_prefill_int8_{name}",
                 lambda a=i8: ops.paged_prefill_int8(*a)),
                (f"paged_prefill_bf16_{name}",
                 lambda a=deq: ops.paged_prefill(*a)),
                (f"sdpa_{name}",
                 lambda d=deq, m=mask: cs.sdpa(
                     torch, *(t.transpose(1, 2) for t in d[:3]), m))):
            res[key] = (cs.time_ms(torch, fn), cs.graph_ms(torch, fn))
            if not key.startswith("sdpa"):
                res[f"kernels_{key}"] = kernel_split(torch, fn)
    res["digests"] = digests
    return res


def dispatch_profile(torch, dev, arch) -> dict:
    """The tree's ``arch`` uncut in bf16 (seed 0): a pool of 16-lane
    blocks, 8 rows' prompts of 512 tokens written by one dispatch, then
    under the profiler a fused decode dispatch (one token a row at
    position 512) and a chunk dispatch (256 tokens a row from 512), each
    through ``ragged_dispatch`` -> {dispatch: {"kernels": launches,
    "<group>_ms": device ms}} for the attention kernels
    (``paged_prefill``), the gathers (``gather_kernel``) and the
    concatenations (``CatArrayBatchedCopy``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.models.api import Model
    from repro_torch.serving.server import ragged_dispatch

    model = Model(get_config(arch), device=dev)
    params = model.init(seed=0)
    bs, rows, prefix = 16, 8, 512
    nb = (prefix + 256) // bs
    pools = model.pool_init(rows * nb + 1, bs)
    bt = (torch.arange(rows * nb, device=dev, dtype=torch.int32)
          .reshape(rows, nb) + 1)
    gen = torch.Generator(device=dev).manual_seed(1)

    def dispatch(n, start):
        toks = torch.randint(1, model.cfg.vocab_size, (rows, n),
                             generator=gen, device=dev, dtype=torch.int32)
        full = torch.full((rows,), start, dtype=torch.int32, device=dev)
        lens = torch.full((rows,), n, dtype=torch.int32, device=dev)
        return lambda: ragged_dispatch(model, params, pools, toks, bt, full,
                                       lens, block_size=bs, all_logits=False)

    out = {}
    with torch.no_grad():
        dispatch(prefix, 0)()
        for name, fn in (("decode", dispatch(1, prefix)),
                         ("chunk", dispatch(256, prefix))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            rec = {"kernels": 0}
            for e in prof.key_averages():
                t = getattr(e, "self_device_time_total", 0)
                if not str(e.device_type).endswith("CUDA") or t <= 0:
                    continue
                rec["kernels"] += e.count
                for group, pat in (("attention", "paged_prefill"),
                                   ("gathers", "gather_kernel"),
                                   ("concatenations",
                                    "CatArrayBatchedCopy")):
                    if pat in e.key:
                        rec[f"{group}_ms"] = rec.get(f"{group}_ms",
                                                     0.0) + t / 1e3
            out[f"{arch}_{name}"] = rec
    del model, params, pools
    torch.cuda.empty_cache()
    return out


def pool_child(torch, cs, dev, sweep=False) -> dict:
    """The tree's composed path and, where it has them, its pool entries
    at ``cs.pool_timing_cases``: each pool launch bit-equal to the
    composed path, both timed, the outputs' SHA-256, the bf16 tile each
    runs; the tree's ptxas; ``dispatch_profile`` of qwen3-0.6b and
    gemma3-4b; with ``sweep`` the forced-piece sweep of the Hopper tile
    (``paged_sweep``)."""
    from repro_torch.kernels import build, ops, ref

    libs = ("flash_attention", "paged_prefill", "paged_prefill_int8")
    build.build_all(list(libs))         # for their ptxas logs
    pool = hasattr(ops, "paged_prefill_pool")
    res, digests, tiles = {}, {}, {}
    for key, _, window, pc in cs.pool_timing_cases(torch, dev):
        tiles[key] = tile_of(pc[0].shape[1], pc[0].shape[2],
                             pc[5].shape[2])
        comp = (lambda pc=pc, w=window:                       # noqa: E731
                cs.composed_call(torch, ops, ref, pc, w))
        want = comp()
        fns = [(f"composed_{key}", comp)]
        if pool:
            fn = (lambda pc=pc, w=window:                     # noqa: E731
                  cs.pool_call(ops, pc, w))
            got = fn()
            torch.cuda.synchronize()
            assert torch.equal(got, want), \
                f"{key}: the pool entry is not bit-equal to the composed path"
            fns.append((f"pool_{key}", fn))
        torch.cuda.synchronize()
        digests[key] = hashlib.sha256(
            want.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        for name, f in fns:
            res[name] = (cs.time_ms(torch, f), cs.graph_ms(torch, f))
            if key.endswith(("pool", "pool_s1", "pool_int8",
                             "pool_int8_s1")):
                res[f"kernels_{name}"] = kernel_split(torch, f)
    for arch in ("qwen3-0.6b", "gemma3-4b"):
        res.update(dispatch_profile(torch, dev, arch))
    res["digests"] = digests
    res["tiles"] = tiles
    res["ptxas"] = ptxas_table(Path(ops.__file__).parents[3], libs)
    if sweep:
        res.update(paged_sweep(torch, cs, dev))
    return res


def paged_sweep(torch, cs, dev) -> dict:
    """The pool entry (bf16) at ``PAGED_SWEEP``'s shapes under every
    tiles-a-piece value the planner can choose, graph ms each, and the
    Hopper tile's makespan constants fit to it (``fit_paged_planner``),
    beside the plans the tree's planner makes."""
    from unittest import mock

    from repro_torch.kernels import attention_split as split
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_prefill as pp_mod

    cases = [(key, pc) for key, _, _, pc in cs.pool_timing_cases(torch, dev)
             if key in PAGED_SWEEP]
    gen = torch.Generator(device=dev).manual_seed(17)
    cases.append(("long", cs.pool_case(
        torch, gen, dev, cs.prefill_case(torch, gen, dev, torch.bfloat16,
                                         b=1, s=64, prefix=2048), 2048)))
    points, plans = {}, {}
    sms = split.sm_count(dev)
    for name, pc in cases:
        q, pos_pool, bt, k = pc[0], pc[2], pc[3], pc[5]
        b, s, h, _ = q.shape
        kv = k.shape[2]
        l = bt.shape[1] * pos_pool.shape[1] + k.shape[1]
        rs = split.paged_key_ranges(s, l, min(64 // (h // kv), s))
        longest = max(split.tile_span(lo, hi)[1] - split.tile_span(lo, hi)[0]
                      for lo, hi in rs)
        for c in plan_candidates(longest):
            forced = split.Plan(c, tuple(split.pieces_of(lo, hi, c)
                                         for lo, hi in rs))
            with mock.patch.object(pp_mod, "plan", lambda *a, f=forced: f):
                points[name, (b, s, l, h, kv), c] = cs.graph_ms(
                    torch, lambda pc=pc: cs.pool_call(ops, pc))
        plans[name] = pp_mod.plan(b, s, l, h, kv, sms).tiles_per_piece
    return {"sweep": {f"{n} c={c}": ms for (n, _, c), ms in points.items()},
            "fit": [list(f) for f in fit_paged_planner(points, split)],
            "plans": plans}


def ssm_bwd_child(torch, cs, dev, needs) -> dict:
    """The tree's ``ssm_scan_bwd`` held against its plain version (and a
    repeat against itself, bit for bit), then timed at
    ``cs.SCAN_BWD_SHAPES`` for each subset of gradients in ``needs``; its
    full launch split by kernel; where it reads the forward's checkpoints,
    the training forward that makes them; then the serving forward
    (``ssm_child``)."""
    import inspect

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss_mod
    from repro_torch.kernels import ssm_scan_bwd as ssb

    names = GRADS["ssm_scan_bwd"]
    full = any(len(sub) == 6 for sub in needs)
    takes_ckpt = "ckpt" in inspect.signature(ssb.ssm_scan_bwd).parameters
    gen = torch.Generator(device=dev).manual_seed(13)
    res = {}
    for b, s, xdt in cs.SCAN_BWD_SHAPES["ssm_scan_bwd"]:
        args = list(cs.ssm_case(torch, gen, dev, b, s))
        args[3] = args[3].to(getattr(torch, xdt))
        dy = torch.randn(b, s, args[0].shape[2], generator=gen,
                         device=dev).to(args[3].dtype)
        dhf = torch.randn(args[5].shape, generator=gen, device=dev)
        want = ref.ssm_scan_bwd_ref(*args, dy, dhf)
        shape = f"{b}x{s}_{xdt}"
        kw = {}
        if takes_ckpt:
            kw["ckpt"] = ss_mod.ssm_scan(*args, checkpoints=True)[2]
            fwd = (lambda a=tuple(args):
                   ss_mod.ssm_scan(*a, checkpoints=True))
            res[f"ssm_scan_fwd_ckpt_{shape}"] = (cs.time_ms(torch, fwd),
                                                 cs.graph_ms(torch, fwd))
        fwd = lambda a=tuple(args): ss_mod.ssm_scan(*a)     # noqa: E731
        res[f"ssm_scan_fwd_{shape}"] = (cs.time_ms(torch, fwd),
                                        cs.graph_ms(torch, fwd))
        for subset in needs:
            need = tuple(n in subset for n in names)
            got = ssb.ssm_scan_bwd(*args, dy, dhf, need=need, **kw)
            again = ssb.ssm_scan_bwd(*args, dy, dhf, need=need, **kw)
            for name, g, a, w, n in zip(names, got, again, want, need):
                if n:
                    assert torch.equal(g, a), (name, "repeat")
                    cs._bwd_err(torch, name, g, w,
                                bf16=name == "dx" and xdt == "bfloat16")
            fn = (lambda a=tuple(args), dy=dy, dhf=dhf, need=need, kw=kw:
                  ssb.ssm_scan_bwd(*a, dy, dhf, need=need, **kw))
            tag = "" if len(subset) == 6 else "_" + "+".join(subset)
            res[f"ssm_scan_bwd_{shape}{tag}"] = (cs.time_ms(torch, fn),
                                                 cs.graph_ms(torch, fn))
            if not tag:
                res[f"kernels_{shape}"] = kernel_split(torch, fn)
    return {**res, **(ssm_child(torch, cs, dev) if full else {})}


def paged_int8_child(torch, cs, dev) -> dict:
    """The tree's ``paged_attention_int8`` (bf16) at phase 7's int8
    decode shapes: bit-equal to the tree's ``paged_attention`` over the
    dequantized pools, then both timed."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(2)
    dt = torch.bfloat16
    shapes = [("decode", cs.decode_case(torch, gen, dev, dt))]
    heads = {arch: dict(h=h, kv=kv) for arch, (h, kv)
             in cs.DENSE_HEADS.items()}
    heads["gemma3-4b"] = cs.GEMMA3_HEADS
    for arch, kw in heads.items():
        shapes.append((arch, cs.decode_case(torch, gen, dev, dt, nb=16,
                                            null_rows=(2,), **kw)))
    res, digests = {}, {}
    for name, args in shapes:
        i8 = cs.int8_decode_args(args)
        deq = cs.dequantized_args(torch, ref, i8)
        out = ops.paged_attention_int8(*i8)
        dense = ops.paged_attention(*deq)
        torch.cuda.synchronize()
        assert torch.equal(out, dense), \
            f"paged_attention_int8 {name}: not bit-equal to the bf16 kernel"
        digests[name] = hashlib.sha256(
            out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        for key, fn in ((f"paged_attention_int8_{name}",
                         lambda a=i8: ops.paged_attention_int8(*a)),
                        (f"paged_attention_bf16_{name}",
                         lambda a=deq: ops.paged_attention(*a))):
            res[key] = (cs.time_ms(torch, fn), cs.graph_ms(torch, fn))
    res["digests"] = digests
    return res


def ptxas_table(tree: Path, libs) -> dict:
    """``ptxas -v`` of the tree's build logs -> {instantiation: "regs /
    spill stores"}, an instantiation named by its kernel and template
    arguments; a flash kernel's trailing ``kPrefix`` argument, where the
    tree has one, is dropped when false (so trees with and without it
    name their other instantiations alike) and its true instantiations
    are left out."""
    import re

    # flash kernels: template arguments without / with kPrefix
    arity = {"flash_attention_mma_kernel": 2,
             "flash_attention_wgmma_kernel": 2,
             "flash_attention_combine_kernel": 1,
             "flash_attention_kernel": 1}
    table = {}
    for lib in libs:
        fn = spill = None
        for line in (tree / "build" / "kernels" / f"{lib}.log").read_text() \
                .splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), None
            elif fn and "spill stores" in line:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            elif fn and "Used" in line and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                kind = re.match(r"_ZN11repro_torch\d+(\w+?)I", fn).group(1)
                args = re.findall(r"L[ib](\d+)E",
                                  fn[:fn.index("EEEv") + 3])
                fn = None
                if kind in arity and len(args) == arity[kind] + 1:
                    if args.pop() == "1":
                        continue
                table[f"{lib}:{kind}<{','.join(args)}>"] = \
                    f"{regs} / {spill}"
    return table


def attention_bits_child(torch, cs, dev) -> dict:
    """The tree's bf16-tile attention kernels at the shapes phase 2 and
    phase 4e check without a prefix, both dtypes -> {"digests": {case:
    SHA-256 of the output}, "ptxas": ptxas_table}."""
    from repro_torch.kernels import ops

    digests = {}

    def keep(name, out, q=None, kv=0):
        # bf16 ragged-prefill launches named by the tile they run: the
        # kWarpKeys mma.sync tile (16 query rows a CTA or fewer) or the
        # Hopper tile, so its digests are compared with the parent's on
        # their own
        if q is not None and q.dtype == torch.bfloat16:
            kind, rest = name.split(" ", 1)
            name = f"{kind}:{tile_of(q.shape[1], q.shape[2], kv)} {rest}"
        torch.cuda.synchronize()
        raw = out.view(torch.int16) if out.dtype == torch.bfloat16 else out
        digests[name] = hashlib.sha256(
            raw.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        gen = torch.Generator(device=dev).manual_seed(0)
        spec_gen = torch.Generator(device=dev).manual_seed(4)
        for sq, sk, causal, window in ((37, 37, True, 0), (37, 37, True, 64),
                                       (512, 512, True, 0),
                                       (512, 512, True, 64),
                                       (2048, 2048, True, 0),
                                       (37, 100, False, 0)):
            q, k, v = cs.flash_case(torch, gen, dev, dt, sq=sq, sk=sk)
            keep(f"flash {dtype_name} {sq}x{sk} c{int(causal)} w{window}",
                 ops.flash_attention(q, k, v, causal=causal, window=window))
        for s, valid in cs.DRAFT_SHAPES:
            q, k, v = cs.draft_case(torch, spec_gen, dev, dt, s, valid)
            keep(f"flash {dtype_name} draft {s}", ops.flash_attention(q, k, v))
        for window in (0, 64):
            for name, args in (
                    ("chunk", cs.prefill_case(torch, gen, dev, dt, b=4,
                                              s=256)),
                    ("fused", cs.prefill_case(torch, gen, dev, dt, b=8,
                                              s=1)),
                    ("slot", cs.slot_decode_case(torch, gen, dev, dt)),
                    ("verify", cs.verify_case(torch, spec_gen, dev, dt))):
                keep(f"paged_prefill {dtype_name} {name} w{window}",
                     ops.paged_prefill(*args, window=window), args[0],
                     args[1].shape[2])
                for lp in cs.INT8_PREFIXES[:1] if name == "chunk" else ():
                    keep(f"paged_prefill_int8 {dtype_name} {name} w{window}",
                         ops.paged_prefill_int8(*cs.int8_prefill_args(
                             args, lp), window=window), args[0],
                         args[1].shape[2])
        hgen = torch.Generator(device=dev).manual_seed(7)
        for arch, (h, kv) in cs.DENSE_HEADS.items():
            q, k, v = cs.flash_case(torch, hgen, dev, dt, h=h, kv=kv, sq=512)
            keep(f"flash {dtype_name} {arch}", ops.flash_attention(q, k, v))
            args = cs.prefill_case(torch, hgen, dev, dt, b=4, s=256, h=h,
                                   kv=kv)
            keep(f"paged_prefill {dtype_name} {arch}",
                 ops.paged_prefill(*args), args[0], kv)
            s1 = cs.prefill_case(torch, hgen, dev, dt, b=8, s=1, h=h, kv=kv)
            keep(f"paged_prefill {dtype_name} {arch} fused",
                 ops.paged_prefill(*s1), s1[0], kv)
        ggen = torch.Generator(device=dev).manual_seed(11)
        for window in (0, cs.GEMMA3_WINDOW):
            for what, kw in cs.GEMMA3_PP_SHAPES:
                args = cs.prefill_case(torch, ggen, dev, dt, **kw,
                                       **cs.GEMMA3_HEADS)
                keep(f"paged_prefill {dtype_name} hd256 {what} w{window}",
                     ops.paged_prefill(*args, window=window), args[0],
                     args[1].shape[2])
            for s in cs.GEMMA3_FA_SHAPES:
                q, k, v = cs.flash_case(torch, ggen, dev, dt, sq=s,
                                        **cs.GEMMA3_HEADS)
                keep(f"flash {dtype_name} hd256 {s} w{window}",
                     ops.flash_attention(q, k, v, window=window))
    return {"digests": digests,
            "ptxas": ptxas_table(Path(ops.__file__).parents[3],
                                 ("flash_attention", "paged_prefill",
                                  "paged_prefill_int8"))}


# shapes of the forced-piece sweep: every tiles-a-piece value the planner
# can choose at each (``attention_split.plan``'s candidates)
FLASH_SWEEP = ("s512", "s2048", "encoder", "cross_prefill", "prefix_256")
# the ragged prefill's Hopper-tile shapes of the pool sweep
# (``cs.pool_timing_cases`` keys, bf16), and one row's chunk of 64 lanes
# after a prefix of 2,048 (16 CTAs: the split decides its time)
PAGED_SWEEP = ("paged_prefill_pool", "paged_prefill_pool_verify",
               "paged_prefill_pool_hd256_chunk_w0",
               "paged_prefill_pool_hd256_chunk past 1,024_w0", "long")


def tile_of(s: int, h: int, kv: int) -> str:
    """The bf16 tile a ragged-prefill launch of ``s`` query lanes at ``h``
    / ``kv`` heads runs in the tree this script sits in: ``mma`` (the
    kWarpKeys tile, 16 query rows a CTA or fewer) or ``wgmma``."""
    g = h // kv
    return "mma" if min(64 // g, s) * g <= 16 else "wgmma"


def plan_candidates(longest: int):
    """The tiles a piece ``attention_split.plan`` chooses among."""
    return sorted({longest} | {m << k for k in range(longest.bit_length())
                               for m in (2, 3) if m << k < longest} | {1})


def flash_cases(torch, cs, dev):
    """-> [(name, (B, H, KV, Sq, Sk, hd, causal, prefix), q, k, v)] at the
    phase-7 flash shapes (gemma3-4b's head_dim-256 rows included) and
    ``FRONTEND_FA_SHAPES``."""
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    spec_gen = torch.Generator(device=dev).manual_seed(6)
    fgen = torch.Generator(device=dev).manual_seed(12)
    out = []
    for s in (512, 2048):
        out.append((f"s{s}", (1, 16, 8, s, s, 128, True, 0),
                    *cs.flash_case(torch, gen, dev, dt, sq=s)))
    for s, valid in cs.DRAFT_SHAPES:
        out.append((f"draft{s}", (1, 16, 8, s, s, 128, True, 0),
                    *cs.draft_case(torch, spec_gen, dev, dt, s, valid)))
    for name, shape in cs.FRONTEND_FA_SHAPES.items():
        out.append((name, shape,
                    *cs.frontend_fa_case(torch, fgen, dev, dt, shape)))
    ggen = torch.Generator(device=dev).manual_seed(13)
    for s in cs.GEMMA3_FA_SHAPES:
        h, kv, hd = (cs.GEMMA3_HEADS[n] for n in ("h", "kv", "hd"))
        out.append((f"hd256_{s}", (1, h, kv, s, s, hd, True, 0),
                    *cs.flash_case(torch, ggen, dev, dt, sq=s,
                                   **cs.GEMMA3_HEADS)))
    return out


def ptxas_all(tree: Path, lib: str) -> dict:
    """``ptxas -v`` of every kernel of one of the tree's libraries ->
    {kernel<template arguments>: "registers / spill stores"}."""
    import re

    table, fn, spill = {}, None, None
    for line in (tree / "build" / "kernels" / f"{lib}.log").read_text() \
            .splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), None
        elif fn and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            kind = re.match(r"_ZN11repro_torch\d+(\w+?)I", fn)
            args = re.findall(r"L[ib](\d+)E", fn)
            name = (f"{kind.group(1)}<{','.join(args)}>" if kind
                    else fn[:60])
            table[name] = f"{regs} / {spill}"
            fn = None
    return table


def fit_paged_planner(sweep, split, sms=132):
    """The ragged prefill's Hopper-tile makespan constants read off a
    forced-piece sweep {(name, (B, S, L, H, KV), tiles a piece): graph
    ms}, as ``fit_flash_planner`` reads the flash tile's (no ``waves``:
    the ragged prefill's model)."""
    ranges = {}
    for name, shape, _ in sweep:
        b, s, l, h, kv = shape
        rs = split.paged_key_ranges(s, l, min(64 // (h // kv), s))
        ranges[name, shape] = ([max(0, t[1] - t[0]) for t in
                                (split.tile_span(*r) for r in rs)], b * kv)
    return fit_constants(sweep, split, ranges, False, sms)


def fit_flash_planner(sweep, split, sms=132):
    """The flash planner's makespan constants read off a forced-piece
    sweep {(name, shape, tiles a piece): graph ms}: over a grid of the
    three constants, the plans ``attention_split.plan`` would choose at
    the sweep's shapes, and their time against each shape's fastest
    forced plan (the mean ratio, the regret), then a least-squares fit of
    the model (``makespan`` with ``waves``, in 64-key tile times; each
    shape its own tile time and base, as head dims and groups differ) ->
    [(regret, relative RMS residual, fixed, combine, ctas_per_sm)], the
    best first: least regret, then least residual."""
    ranges = {}
    for name, shape, _ in sweep:
        b, h, kv, sq, sk, hd, causal, prefix = shape
        tq = min(64 // (h // kv), sq)
        rs = split.flash_key_ranges(sq, sk, tq, causal, 0, prefix)
        ranges[name, shape] = ([max(0, t[1] - t[0]) for t in
                                (split.tile_span(*r) for r in rs)], b * kv)
    return fit_constants(sweep, split, ranges, True, sms)


def fit_constants(sweep, split, ranges, waves, sms):
    """``fit_flash_planner``'s search over the three makespan constants,
    for the sweep's shapes' (tiles of each query tile, CTAs a query
    tile) ``ranges`` under ``makespan`` with or without ``waves``."""
    by_shape = {}
    for (name, shape, c), ms in sweep.items():
        by_shape.setdefault((name, shape), []).append((c, ms))
    fits = []
    for fixed in (0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0):
        for combine in (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0):
            for per_sm in (1.0, 1.25, 1.5, 1.75, 2.0):
                res = []
                for key, pts in by_shape.items():
                    tiles, ctas = ranges[key]
                    xs = [split.makespan(tiles, c, ctas, sms, fixed=fixed,
                                         combine=combine, ctas_per_sm=per_sm,
                                         waves=waves) for c, _ in pts]
                    ys = [ms for _, ms in pts]
                    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
                    sxx = sum((x - mx) ** 2 for x in xs)
                    tau = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
                           / sxx if sxx else 0.0)
                    base = my - tau * mx
                    res += [((base + tau * x - y) / y) ** 2
                            for x, y in zip(xs, ys)]
                regret = []
                for key, pts in by_shape.items():
                    tiles, ctas = ranges[key]
                    rs = [(0, t * split.TILE_KEYS) for t in tiles]
                    c = split.plan(rs, ctas, sms, fixed=fixed,
                                   combine=combine, ctas_per_sm=per_sm,
                                   waves=waves).tiles_per_piece
                    times = dict(pts)
                    regret.append(times[c] / min(times.values()))
                fits.append((sum(regret) / len(regret),
                             (sum(res) / len(res)) ** 0.5, fixed, combine,
                             per_sm))
    return sorted(fits)[:5]


def flash_child(torch, cs, dev, sweep=False) -> dict:
    """The tree's bf16 ``flash_attention`` at ``flash_cases``: held to the
    plain version, timed beside SDPA, its plan and bound; the tree's
    ptxas; with ``sweep`` the forced-piece sweep and its fit."""
    from unittest import mock

    from repro_torch.kernels import attention_split as split
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.launch.mesh import HBM_BYTES_PER_S, PEAK_FLOPS

    build.build_all(["flash_attention"])
    sms = split.sm_count(dev)
    res, plans, bounds = {}, {}, {}
    cases = flash_cases(torch, cs, dev)
    for name, shape, q, k, v in cases:
        b, h, kv, sq, sk, hd, causal, prefix = shape
        got = ops.flash_attention(q, k, v, causal=causal, prefix=prefix)
        want = ref.flash_attention_ref(q, k, v, causal=causal, prefix=prefix)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   **cs.KERNEL_TOL["flash_attention",
                                                   "bfloat16"])
        i, j = (torch.arange(n, device=dev) for n in (sq, sk))
        seen = ((j[None] <= i[:, None]) | (j[None] < prefix) if causal
                else torch.ones(sq, sk, dtype=torch.bool, device=dev))
        fn = (lambda q=q, k=k, v=v, c=causal, p=prefix:
              ops.flash_attention(q, k, v, causal=c, prefix=p))
        lib = ((lambda q=q, k=k, v=v, m=seen[None, None]:
                cs.sdpa(torch, q, k, v, m)) if prefix else
               (lambda q=q, k=k, v=v, c=causal: cs.sdpa(torch, q, k, v,
                                                         causal=c)))
        res[f"flash_{name}"] = (cs.time_ms(torch, fn), cs.graph_ms(torch, fn))
        res[f"sdpa_{name}"] = (cs.time_ms(torch, lib),
                               cs.graph_ms(torch, lib))
        pl = fa_mod.plan(b, h, kv, sq, sk, causal, 0, sms, prefix)
        plans[name] = f"{pl.tiles_per_piece} tiles a piece, " \
            f"{pl.ctas(b * kv)} CTAs"
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        flops = 4 * hd * h * b * int(seen.sum())
        bounds[name] = max(nbytes / HBM_BYTES_PER_S,
                           flops / PEAK_FLOPS["bfloat16"]) * 1e3
    out = {**res, "plans": plans, "bounds_ms": bounds,
           "ptxas": ptxas_all(Path(ops.__file__).parents[3],
                              "flash_attention")}
    if sweep:
        points = {}
        for name, shape, q, k, v in cases:
            if name not in FLASH_SWEEP:
                continue
            b, h, kv, sq, sk, hd, causal, prefix = shape
            tq = min(64 // (h // kv), sq)
            rs = split.flash_key_ranges(sq, sk, tq, causal, 0, prefix)
            longest = max(split.tile_span(lo, hi)[1]
                          - split.tile_span(lo, hi)[0] for lo, hi in rs)
            for c in plan_candidates(longest):
                forced = split.Plan(c, tuple(split.pieces_of(lo, hi, c)
                                             for lo, hi in rs))
                with mock.patch.object(fa_mod, "plan",
                                       lambda *a, f=forced: f):
                    fn = (lambda q=q, k=k, v=v, c=causal, p=prefix:
                          ops.flash_attention(q, k, v, causal=c, prefix=p))
                    points[name, shape, c] = cs.graph_ms(torch, fn)
        out["sweep"] = {f"{n} c={c}": ms for (n, _, c), ms in points.items()}
        out["fit"] = [list(f) for f in fit_flash_planner(points, split)]
    return out


def child(tree: Path, kernel: str, needs=()) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.nn.grad import conv2d_weight

    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(tree / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import conv2d as cv_mod
    from repro_torch.kernels import conv2d_wgrad as wg_mod
    from repro_torch.kernels import ref

    assert Path(cv_mod.__file__).resolve().is_relative_to(tree.resolve())
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(2)
    one = torch.zeros(1, device=dev)
    res = {"floor": (cs.time_ms(torch, lambda: one.add_(1)),
                     cs.graph_ms(torch, lambda: one.add_(1)))}
    if kernel == "ssm_scan":
        return {**res, **ssm_child(torch, cs, dev)}
    if kernel == "rwkv6_scan_bwd":
        return {**res, **rwkv_bwd_child(torch, cs, dev,
                                        needs or (GRADS[kernel],))}
    if kernel == "ssm_scan_bwd":
        return {**res, **ssm_bwd_child(torch, cs, dev,
                                       needs or (GRADS[kernel],))}
    if kernel == "paged_prefill_int8":
        return {**res, **int8_child(torch, cs, dev)}
    if kernel == "paged_attention_int8":
        return {**res, **paged_int8_child(torch, cs, dev)}
    if kernel == "paged_prefill_pool":
        return {**res, **pool_child(torch, cs, dev,
                                    sweep=("sweep",) in needs)}
    if kernel == "attention_bits":
        return {**res, **attention_bits_child(torch, cs, dev)}
    if kernel == "flash_attention":
        return {**res, **flash_child(torch, cs, dev,
                                     sweep=("sweep",) in needs)}
    for b in BATCHES[kernel]:
        x = torch.rand(b, 28, 28, 1, generator=gen, device=dev)
        xn = x.permute(0, 3, 1, 2)
        if kernel == "conv2d":
            w = torch.randn(3, 3, 1, 32, generator=gen, device=dev)
            wn = w.permute(3, 2, 0, 1)
            got, want = cv_mod.conv2d(x, w), ref.conv2d_ref(x, w)
            torch.testing.assert_close(got, want,
                                       **cs.KERNEL_TOL["conv2d", "float32"])
            fn, lib = (lambda: cv_mod.conv2d(x, w),
                       lambda: F.conv2d(xn, wn))
        else:
            dy = torch.randn(b, 26, 26, 32, generator=gen, device=dev)
            dyn = dy.permute(0, 3, 1, 2).contiguous()
            xn = xn.contiguous()
            cs.assert_wgrad_close(torch, wg_mod.conv2d_wgrad(x, dy, 3, 3),
                                  ref.conv2d_wgrad_ref(x, dy, 3, 3),
                                  "float32")
            fn, lib = (lambda: wg_mod.conv2d_wgrad(x, dy, 3, 3),
                       lambda: conv2d_weight(xn, (32, 1, 3, 3), dyn))
        res[f"{kernel}_{b}"] = (cs.time_ms(torch, fn), cs.graph_ms(torch, fn))
        res[f"cudnn_{b}"] = (cs.time_ms(torch, lib), cs.graph_ms(torch, lib))
    return res


def main(argv) -> int:
    if len(argv) >= 3 and argv[0] == "--child":
        needs = tuple(tuple(n.split(",")) for n in argv[3:])
        print(json.dumps(child(Path(argv[1]), argv[2], needs)))
        return 0
    kernel, needs = "conv2d", []
    while argv[:1] in (["--kernel"], ["--need"]) and len(argv) >= 2:
        if argv[0] == "--kernel":
            kernel = argv[1]
        else:
            needs.append(argv[1])
        argv = argv[2:]
    import torch

    bad = [n for sub in needs for n in sub.split(",")
           if n not in GRADS.get(kernel, ())]
    if (not torch.cuda.is_available() or not argv or kernel not in BATCHES
            or bad):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs

    trees = [Path(t).resolve() for t in argv]
    runs = []
    for i, tree in enumerate(trees + trees[::-1]):
        extra = (["sweep"] if kernel in ("flash_attention",
                                         "paged_prefill_pool")
                 and i == len(trees) - 1 else [])
        out = subprocess.run([sys.executable, __file__, "--child", str(tree),
                              kernel, *needs, *extra],
                             capture_output=True, text=True, check=False)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({"tree": str(tree), **res})
        print(f"{tree}: " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in res.items()
            if not isinstance(v, dict) and k != "fit")
            + "  (ms, event / graph-replayed)", flush=True)
        for k, v in res.items():
            if isinstance(v, dict) and k not in ("digests", "ptxas",
                                                 "plans", "bounds_ms",
                                                 "sweep", "tiles"):
                print(f"  {k} (profiler, ms a call): " + ", ".join(
                    f"{n} {t:.4f}" for n, t in v.items()), flush=True)
    digests = [r.get("digests") for r in runs]
    if digests[0]:
        print("outputs' SHA-256 the same in every run: "
              + str(all(d == digests[0] for d in digests)), digests[0])
        for kind in sorted({n.split()[0] for n in digests[0]}):
            same = all({n: h for n, h in d.items() if n.split()[0] == kind}
                       == {n: h for n, h in digests[0].items()
                           if n.split()[0] == kind} for d in digests)
            print(f"  {kind}: the same in every run: {same}")
    for r in runs:
        for key in ("plans", "bounds_ms", "sweep", "fit", "tiles"):
            if key in r:
                print(f"{key} {r['tree']}: {r[key]}")
    tables = [r.get("ptxas") for r in runs]
    if tables[0]:
        for r in runs[:len(trees)]:
            print(f"ptxas {r['tree']}: {r['ptxas']}")
        print("ptxas registers / spill stores the same in every tree: "
              + str(all(t == tables[0] for t in tables)))
    smi = cs.nvidia_smi()
    print(smi)
    print(json.dumps({"card": smi, "kernel": kernel, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
