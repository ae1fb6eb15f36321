#!/usr/bin/env python3
"""Time a conv kernel, the selective scan or its backward, the WKV6
backward, an int8 attention kernel or the ragged prefill's pool entries
of several checkouts on one card, in turns.

    python3 conv2d_compare.py [--kernel KERNEL] [--need SUBSET ...] TREE [TREE ...]

KERNEL: conv2d (the default), conv2d_wgrad, ssm_scan, ssm_scan_bwd,
rwkv6_scan_bwd, paged_prefill_int8, paged_attention_int8,
paged_prefill_pool or attention_bits.  Each TREE is the root of a checkout holding
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
fused-decode launches split by kernel; the outputs' SHA-256; the tree's
``ptxas -v`` of ``paged_prefill``, ``paged_prefill_int8`` and
``flash_attention``; and one fused decode dispatch (8 rows, one token
each after 512 cached) and one chunk dispatch (8 rows of 256 tokens
after 512) of qwen3-0.6b (28 layers) and gemma3-4b (34), uncut, bf16,
through ``ragged_dispatch`` under the profiler: kernels launched, and
device ms of the attention kernels, the gathers and the
concatenations.
``attention_bits``: ``flash_attention``, ``paged_prefill`` and
``paged_prefill_int8`` (the kernels over the shared bf16 tile,
``csrc/attention_mma.cuh``) at the shapes ``chip_smoke.py`` checks
without a prefix (phase 2's, the draft's, the dense configs' and
gemma3-4b's heads, windows 0 and 64 / 1,024), bf16 and float32: each
output's SHA-256, which must be the same in every run, and each tree's
``ptxas -v`` registers and spills of those kernels' instantiations, a
prefix instantiation's (``kPrefix``, that tree's own) left out.  The full
launches are also split by kernel under ``torch.profiler`` (device time
a call).  Prints a line per run, the card's name and power limit, and a
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
           "paged_prefill_pool": (), "attention_bits": ()}
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


def pool_child(torch, cs, dev) -> dict:
    """The tree's composed path and, where it has them, its pool entries
    at ``cs.pool_timing_cases``: each pool launch bit-equal to the
    composed path, both timed, the outputs' SHA-256; the tree's ptxas;
    ``dispatch_profile`` of qwen3-0.6b and gemma3-4b."""
    from repro_torch.kernels import build, ops, ref

    libs = ("flash_attention", "paged_prefill", "paged_prefill_int8")
    build.build_all(list(libs))         # for their ptxas logs
    pool = hasattr(ops, "paged_prefill_pool")
    res, digests = {}, {}
    for key, _, window, pc in cs.pool_timing_cases(torch, dev):
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
    res["ptxas"] = ptxas_table(Path(ops.__file__).parents[3], libs)
    return res


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

    def keep(name, out):
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
                     ops.paged_prefill(*args, window=window))
                for lp in cs.INT8_PREFIXES[:1] if name == "chunk" else ():
                    keep(f"paged_prefill_int8 {dtype_name} {name} w{window}",
                         ops.paged_prefill_int8(*cs.int8_prefill_args(
                             args, lp), window=window))
        hgen = torch.Generator(device=dev).manual_seed(7)
        for arch, (h, kv) in cs.DENSE_HEADS.items():
            q, k, v = cs.flash_case(torch, hgen, dev, dt, h=h, kv=kv, sq=512)
            keep(f"flash {dtype_name} {arch}", ops.flash_attention(q, k, v))
            args = cs.prefill_case(torch, hgen, dev, dt, b=4, s=256, h=h,
                                   kv=kv)
            keep(f"paged_prefill {dtype_name} {arch}",
                 ops.paged_prefill(*args))
        ggen = torch.Generator(device=dev).manual_seed(11)
        for window in (0, cs.GEMMA3_WINDOW):
            for what, kw in cs.GEMMA3_PP_SHAPES:
                args = cs.prefill_case(torch, ggen, dev, dt, **kw,
                                       **cs.GEMMA3_HEADS)
                keep(f"paged_prefill {dtype_name} hd256 {what} w{window}",
                     ops.paged_prefill(*args, window=window))
            for s in cs.GEMMA3_FA_SHAPES:
                q, k, v = cs.flash_case(torch, ggen, dev, dt, sq=s,
                                        **cs.GEMMA3_HEADS)
                keep(f"flash {dtype_name} hd256 {s} w{window}",
                     ops.flash_attention(q, k, v, window=window))
    return {"digests": digests,
            "ptxas": ptxas_table(Path(ops.__file__).parents[3],
                                 ("flash_attention", "paged_prefill",
                                  "paged_prefill_int8"))}


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
        return {**res, **pool_child(torch, cs, dev)}
    if kernel == "attention_bits":
        return {**res, **attention_bits_child(torch, cs, dev)}
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
    for tree in trees + trees[::-1]:
        out = subprocess.run([sys.executable, __file__, "--child", str(tree),
                              kernel, *needs],
                             capture_output=True, text=True, check=False)
        if out.returncode != 0:
            print(out.stdout, out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({"tree": str(tree), **res})
        print(f"{tree}: " + ", ".join(
            f"{k} {v[0]:.4f} / {v[1]:.4f}" for k, v in res.items()
            if not isinstance(v, dict))
            + "  (ms, event / graph-replayed)", flush=True)
        for k, v in res.items():
            if isinstance(v, dict) and k not in ("digests", "ptxas"):
                print(f"  {k} (profiler, ms a call): " + ", ".join(
                    f"{n} {t:.4f}" for n, t in v.items()), flush=True)
    digests = [r.get("digests") for r in runs]
    if digests[0]:
        print("outputs' SHA-256 the same in every run: "
              + str(all(d == digests[0] for d in digests)), digests[0])
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
