#!/usr/bin/env python3
"""Time a conv kernel, the selective scan, the WKV6 backward or the int8
ragged prefill of several checkouts on one card, in turns.

    python3 conv2d_compare.py [--kernel KERNEL] [--need SUBSET ...] TREE [TREE ...]

KERNEL: conv2d (the default), conv2d_wgrad, ssm_scan, rwkv6_scan_bwd or
paged_prefill_int8.  Each TREE is the root of a checkout holding
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
own.  ``paged_prefill_int8``: the int8 KV cache's ragged prefill in bf16
at phase 7's four int8 shapes (a chunk of S = 256 over an int8 prefix of
512, fused decode, slot decode, spec verify), each held bit-equal to the
bf16 kernel over the concatenated dequantized keys and timed beside it
and beside SDPA on those keys; the outputs' SHA-256 is printed, the same
in every run where the trees' kernels give the same bits.  The full
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
           "ssm_scan": (), "rwkv6_scan_bwd": (), "paged_prefill_int8": ()}
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


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
            need = tuple(n in subset for n in GRADS)
            got = rwb.rwkv6_scan_bwd(*args, dout, dsf, need=need)
            for name, g, w, n in zip(GRADS, got, want, need):
                if n:
                    cs._bwd_err(torch, name, g, w)
            fn = (lambda args=tuple(args), dout=dout, dsf=dsf, need=need:
                  rwb.rwkv6_scan_bwd(*args, dout, dsf, need=need))
            tag = "" if len(subset) == len(GRADS) else "_" + "+".join(subset)
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


def child(tree: Path, kernel: str, needs=(GRADS,)) -> dict:
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
        return {**res, **rwkv_bwd_child(torch, cs, dev, needs)}
    if kernel == "paged_prefill_int8":
        return {**res, **int8_child(torch, cs, dev)}
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
        needs = tuple(tuple(n.split(",")) for n in argv[3:]) or (GRADS,)
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

    bad = [n for sub in needs for n in sub.split(",") if n not in GRADS]
    if (not torch.cuda.is_available() or not argv or kernel not in BATCHES
            or bad or (needs and kernel != "rwkv6_scan_bwd")):
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
            if isinstance(v, dict) and k != "digests":
                print(f"  {k} (profiler, ms a call): " + ", ".join(
                    f"{n} {t:.4f}" for n, t in v.items()), flush=True)
    digests = [r.get("digests") for r in runs]
    if digests[0]:
        print("outputs' SHA-256 the same in every run: "
              + str(all(d == digests[0] for d in digests)), digests[0])
    smi = cs.nvidia_smi()
    print(smi)
    print(json.dumps({"card": smi, "kernel": kernel, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
