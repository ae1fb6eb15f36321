#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a),
then runs seven phases, each raising on failure:

1. device: the card's name and power limit, the kernels' build time;
2. kernel parity: each kernel against its plain PyTorch version at the
   serving paths' shapes (``paged_prefill`` at a chunk's and at the fused
   decode dispatch's, ``flash_attention`` at the slot engine's
   whole-prompt prefill) in bfloat16 and float32, ``rwkv6_scan`` at the
   rwkv6 slot path's prefill and decode in float32;
3. model: qwen3-0.6b at its published width (28 layers, bfloat16, seeded
   random weights): one ragged prefill dispatch and one decode step of
   the paged path, and two whole-prompt prefills and one decode step of
   the slot path, through the kernels and through the plain versions
   agree;
4. engine: the serve path (``launch.serve.build_engine``) answers 8
   requests at full width with the paged engine, decode fusion on
   (``paged_prefill``) and off (``paged_attention``), with a pool tight
   enough to preempt, and with the slot engine (``flash_attention`` for
   each admission, ``paged_prefill`` for decode); the launch counts show
   each kernel ran; then at full width with 2 layers in float32 the
   paged engine's two modes and the slot engine must emit identical
   tokens;
5. rwkv6: with the qwen3 model freed, rwkv6-1.6b at its published
   width (24 layers, bfloat16, seeded random weights with the
   reference's zero-initialised leaves drawn too) through the serve
   path's slot engine: whole-prompt prefills and decode steps through
   ``rwkv6_scan`` and through its plain version agree, in bfloat16 and
   in float32, each beside the scan in float64; the engine
   answers 8 requests with ``rwkv6_scan`` launched 24 times per engine
   step and no attention kernel; at 2 layers in float32 the engine
   emits the same tokens through the kernel and the plain version;
6. digits: the paper's pipeline (mnist-cnn at its published width,
   float32, seeded weights saved and restored through the checkpoint
   store): ``conv2d`` against its plain version over the reference's
   sweep and the pipeline's batches in float32 and bfloat16;
   ``StratusPipeline.evaluate`` over 2,000 test and 1,000 canvas digits
   with the plain path's predictions; ``StratusApp`` answering 20 posted
   canvas digits (paper-faithful config) with the plain path's digits,
   and a POST load of 25 users through ``LoadGenerator`` on the
   micro-batched config under 5 % failures; ``conv2d`` launched once per
   forward pass;
7. times: each kernel's time beside its bound, its plain version's and
   one PyTorch library call's where there is one (a yardstick only; the
   port never calls it).

Prints one JSON line of kernel records, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when there is no CUDA device or no checkout around it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12           # H100 SXM device memory rate
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no tensor
                                                      # cores for float32

# tolerances, kernel vs plain version on the same inputs
KERNEL_TOL = {
    # sums in another order and expf over up to 768 keys
    ("paged_attention", "float32"): dict(atol=1e-4, rtol=1e-4),
    ("paged_prefill", "float32"): dict(atol=1e-4, rtol=1e-4),
    # both sides compute in float32 and round the output to bf16 once, so
    # an element may land one bf16 ulp apart (2**-7 of its size); the
    # measured error is ~2.4e-4, the absolute part leaves 8x headroom
    ("paged_attention", "bfloat16"): dict(atol=2e-3, rtol=2 ** -7),
    # the plain version also rounds the probabilities to bf16 before the
    # value product, the kernel keeps them float32; measured ~1.6e-2
    ("paged_prefill", "bfloat16"): dict(atol=3e-2, rtol=2 ** -7),
    # both sides keep softmax and value product in float32 and round the
    # output once, as the decode kernel; sums over up to 512 keys
    ("flash_attention", "float32"): dict(atol=1e-4, rtol=1e-4),
    ("flash_attention", "bfloat16"): dict(atol=2e-3, rtol=2 ** -7),
    # float32 only (the model calls it so): each step's 64-term sums in
    # another order, the state carrying the rounding across 200 steps,
    # outputs reaching ~100
    ("rwkv6_scan", "float32"): dict(atol=1e-4, rtol=1e-4),
    # an FMA chain against the plain version's products and adds, over at
    # most 75 terms of outputs below ~10
    ("conv2d", "float32"): dict(atol=1e-5, rtol=1e-5),
    # both sides sum in float32 and round the output to bf16 once: one
    # bf16 ulp (2**-7 of the value) apart at most
    ("conv2d", "bfloat16"): dict(atol=1e-3, rtol=2 ** -7),
}
# relative L2 error of logits, kernels vs plain versions through a model:
# bf16 rounds activations in each of 28 layers, so kernel-side rounding
# differences compound; float32 (2 layers) only reorders sums
MODEL_TOL = {"bfloat16": 5e-2, "float32": 1e-4}
# rwkv6-1.6b at full width (24 layers, seeded random weights): the
# recurrence carries every rounding difference into all later tokens and
# the random network amplifies it along its depth.  Against the scan in
# float64, the plain scan's own float32 rounding moves the logits of the
# prefills (150 and 37 tokens) by 6.1e-2 in bf16 and 7.9e-5 in float32,
# the kernel's by 6.4e-2 and 6.9e-4 (on each layer's own inputs the
# kernel is the more exact of the two); 2 decode steps from equal states
# move by 1.8e-2 and 1.2e-6.  The limits are 2-3x the kernel-vs-plain
# readings (6.2e-2, 1.9e-2; 7.0e-4, 1.2e-6), and each run prints the
# float64 readings beside them
RWKV_MODEL_TOL = {"bfloat16": {"prefill": 0.15, "decode": 4e-2},
                  "float32": {"prefill": 2e-3, "decode": 1e-4}}
# the digit pipeline, kernel vs plain path: float32 probabilities; an
# argmax may differ only where the plain path's top-two logits are closer
DIGIT_PROB_ATOL = 1e-5
DIGIT_TIE_MARGIN = 1e-5
# (B, H, W, Cin, K, Cout): the reference's sweep (tests/test_kernels.py),
# then the pipeline's batches at the paper's shape: the consumer's 1 and
# up to 32, evaluation's 1,000 canvas and 2,000 test digits
CONV_SHAPES = ((5, 28, 28, 1, 3, 32), (130, 28, 28, 1, 3, 32),
               (4, 12, 16, 3, 5, 8), (2, 9, 9, 2, 1, 4),
               (1, 28, 28, 1, 3, 32), (32, 28, 28, 1, 3, 32),
               (1000, 28, 28, 1, 3, 32), (2000, 28, 28, 1, 3, 32))
MICRO_BATCHED = dict(max_batch=32, consume_base=0.05,
                     balancer_policy="power_of_two")


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------- inputs


def decode_case(torch, gen, device, dtype, b=8, h=16, kv=8, hd=128, bs=16,
                nb=32, null_rows=(5,)):
    """A block-paged pool with ragged per-row lengths (up to ``nb``
    blocks), tables null-padded past each row's run, ``null_rows`` with
    all-null tables."""
    nb_pool = b * nb + 1
    k = torch.randn(nb_pool, bs, kv, hd, generator=gen, device=device)
    v = torch.randn(nb_pool, bs, kv, hd, generator=gen, device=device)
    kpos = torch.full((nb_pool, bs), -1, dtype=torch.int32, device=device)
    bt = torch.zeros(b, nb, dtype=torch.int32, device=device)
    pos = torch.zeros(b, dtype=torch.int32, device=device)
    perm = torch.randperm(nb_pool - 1, generator=gen, device=device) + 1
    nxt = 0
    for i in range(b):
        if i in null_rows:
            continue
        length = int(torch.randint(1, nb * bs + 1, (1,), generator=gen,
                                   device=device))
        n_used = -(-length // bs)
        blocks = perm[nxt:nxt + n_used]
        nxt += n_used
        bt[i, :n_used] = blocks.int()
        lanes = torch.arange(n_used * bs, device=device)
        kpos[blocks] = torch.where(lanes < length, lanes, -1).int().reshape(
            n_used, bs)
        pos[i] = length - 1
    q = torch.randn(b, h, hd, generator=gen, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype), kpos, bt, pos


def prefill_case(torch, gen, device, dtype, b=4, s=256, h=16, kv=8, hd=128,
                 prefix=512):
    """Keys as the engine assembles them: a gathered prefix (null past
    each row's cursor) then the chunk, per-row cursors, padded lanes."""
    L = prefix + s
    q = torch.randn(b, s, h, hd, generator=gen, device=device)
    k = torch.randn(b, L, kv, hd, generator=gen, device=device)
    v = torch.randn(b, L, kv, hd, generator=gen, device=device)
    kpos = torch.full((b, L), -1, dtype=torch.int32, device=device)
    qpos = torch.zeros(b, s, dtype=torch.int32, device=device)
    for i in range(b):
        start = int(torch.randint(0, prefix + 1, (1,), generator=gen,
                                  device=device))
        n = int(torch.randint(1, s + 1, (1,), generator=gen, device=device))
        kpos[i, :start] = torch.arange(start, device=device)
        qpos[i] = start + torch.arange(s, device=device)
        kpos[i, prefix:prefix + n] = qpos[i, :n]
    return q.to(dtype), k.to(dtype), v.to(dtype), kpos, qpos


def flash_case(torch, gen, device, dtype, b=1, h=16, kv=8, hd=128, sq=512,
               sk=None):
    """Whole-prompt operands as the slot prefill passes them: (B,S,heads,
    hd) projections viewed as (B,heads,S,hd)."""
    sk = sq if sk is None else sk

    def operand(heads, s):
        return torch.randn(b, s, heads, hd, generator=gen,
                           device=device).to(dtype).transpose(1, 2)

    return operand(h, sq), operand(kv, sk), operand(kv, sk)


def rwkv_case(torch, gen, device, b=1, h=32, s=200, hd=64):
    """WKV6 operands as the rwkv6 layer passes them: float32 (B,S,H,hd)
    projections viewed as (B,H,S,hd), data-dependent decays
    exp(-exp(N(-3, 1))) as ``_decay`` makes them, a start state."""
    def operand(t):
        return t.transpose(1, 2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    r, k, v = (operand(randn(b, s, h, hd)) for _ in range(3))
    w = operand(torch.exp(-torch.exp(randn(b, s, h, hd) - 3.0)))
    u = randn(h, hd) * 0.5
    s0 = randn(b, h, hd, hd) * 0.1
    return r, k, v, w, u, s0


RWKV_SHAPES = ((1, 37), (1, 200), (4, 1))     # (rows, S): prefill, decode


def decode_visible(torch, kpos_pool, bt, pos, window):
    kp = kpos_pool[bt.long()].reshape(bt.shape[0], -1)         # (B, nb*bs)
    p = pos[:, None]
    vis = (kp >= 0) & (kp <= p)
    if window:
        vis &= p - kp < window
    return vis


def prefill_visible(torch, kpos, qpos, window):
    kp, qp = kpos[:, None, :], qpos[:, :, None]
    vis = (kp >= 0) & (kp <= qp)
    if window:
        vis &= qp - kp < window
    return vis                                                  # (B,S,L)


# ---------------------------------------------------------------- phases


def kernel_parity(torch, device, ops, ref):
    """Phase 2: decode at the decode dispatch's shape; prefill at a chunk
    shape (4 rows, S=256) and at the fused decode dispatch's (8 rows,
    S=1); flash at one prompt row of 37 and 512 tokens (windows 0 and
    64) and non-causal with 37 queries over 100 keys; the WKV6 scan at
    rwkv6-1.6b's 32 heads: one prompt row of 37 and 200 tokens and a
    decode step over 4 slots, each also against the scan in float64.
    -> {kernel: max abs error over its bfloat16 cases (``rwkv6_scan``:
    its float32 cases)}."""
    gen = torch.Generator(device=device).manual_seed(0)
    errs = {"paged_attention": 0.0, "paged_prefill": 0.0,
            "flash_attention": 0.0, "rwkv6_scan": 0.0}
    for b, s in RWKV_SHAPES:
        args = rwkv_case(torch, gen, device, b=b, s=s)
        out, sf = ops.rwkv6_scan(*args)
        plain, plain_sf = ref.rwkv6_scan_ref(*args)
        torch.cuda.synchronize()
        for got, want in ((out, plain), (sf, plain_sf)):
            torch.testing.assert_close(got, want,
                                       **KERNEL_TOL["rwkv6_scan", "float32"])
        err = max((out - plain).abs().max().item(),
                  (sf - plain_sf).abs().max().item())
        exact = ref.rwkv6_scan_ref(*(t.double() for t in args))[0]
        log(f"parity rwkv6_scan float32 {b} rows S={s}: max_abs_err="
            f"{err:.3e} (max |out| {plain.abs().max().item():.1f}); "
            f"against the float64 scan: kernel "
            f"{(out - exact).abs().max().item():.3e}, plain "
            f"{(plain - exact).abs().max().item():.3e}")
        errs["rwkv6_scan"] = max(errs["rwkv6_scan"], err)
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for sq, sk, causal, window in ((37, 37, True, 0), (37, 37, True, 64),
                                       (512, 512, True, 0),
                                       (512, 512, True, 64),
                                       (37, 100, False, 0)):
            q, k, v = flash_case(torch, gen, device, dtype, sq=sq, sk=sk)
            out = ops.flash_attention(q, k, v, causal=causal, window=window)
            plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            torch.testing.assert_close(
                out.float(), plain.float(),
                **KERNEL_TOL["flash_attention", dtype_name])
            log(f"parity flash_attention {dtype_name} Sq={sq} Sk={sk} "
                f"causal={causal} window={window}: max_abs_err={err:.3e}")
            if dtype_name == "bfloat16":
                errs["flash_attention"] = max(errs["flash_attention"], err)
        for window in (0, 64):
            args = decode_case(torch, gen, device, dtype)
            out = ops.paged_attention(*args, window=window)
            plain = ref.paged_attention_ref(*args, window=window)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            torch.testing.assert_close(
                out.float(), plain.float(),
                **KERNEL_TOL["paged_attention", dtype_name])
            assert torch.all(out[5] == 0), "all-null row must be zeros"
            log(f"parity paged_attention {dtype_name} window={window}: "
                f"max_abs_err={err:.3e}")
            if dtype_name == "bfloat16":
                errs["paged_attention"] = max(errs["paged_attention"], err)

            for b, s in ((4, 256), (8, 1)):
                args = prefill_case(torch, gen, device, dtype, b=b, s=s)
                out = ops.paged_prefill(*args, window=window)
                plain = ref.paged_prefill_ref(*args, window=window)
                torch.cuda.synchronize()
                lanes = prefill_visible(torch, args[3], args[4],
                                        window).any(-1)
                assert lanes.any()
                err = (out[lanes].float()
                       - plain[lanes].float()).abs().max().item()
                torch.testing.assert_close(
                    out[lanes].float(), plain[lanes].float(),
                    **KERNEL_TOL["paged_prefill", dtype_name])
                log(f"parity paged_prefill {dtype_name} {b} rows S={s} "
                    f"window={window}: max_abs_err={err:.3e} "
                    f"({int(lanes.sum())} visible lanes)")
                if dtype_name == "bfloat16":
                    errs["paged_prefill"] = max(errs["paged_prefill"], err)
    return errs


def plain_ops(ops, ref):
    """Route the models' kernels to the plain versions for one comparison
    run (patching the ops module the models call through)."""
    return mock.patch.multiple(ops, paged_attention=ref.paged_attention_ref,
                               paged_prefill=ref.paged_prefill_ref,
                               flash_attention=ref.flash_attention_ref,
                               rwkv6_scan=ref.rwkv6_scan_ref,
                               conv2d=ref.conv2d_ref)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def model_parity(torch, device, model, params, ops, ref, ragged_dispatch):
    """Phase 3, paged path: one ragged prefill dispatch (per-row cursors
    past a cached prefix) and one decode step, kernels vs plain versions
    on identical pools.  -> {"prefill": rel_err, "decode": rel_err}."""
    cfg = model.cfg
    bs, rows = 16, 4
    prefix_lens = [48, 112, 0, 200]
    chunk_lens = [64, 16, 96, 1]
    nb = -(-max(p + c + 1 for p, c in zip(prefix_lens, chunk_lens)) // bs)
    pools = model.pool_init(rows * nb + 1, bs)
    bt = (torch.arange(rows * nb, device=device, dtype=torch.int32)
          .reshape(rows, nb) + 1)
    gen = torch.Generator(device=device).manual_seed(1)

    def tokens(n):
        return torch.randint(1, cfg.vocab_size, (rows, n), generator=gen,
                             device=device, dtype=torch.int32)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    # write the prefixes (rows with prefix 0 dispatch one padding lane)
    ragged_dispatch(model, params, pools, tokens(max(prefix_lens)), bt,
                    i32([0] * rows), i32([max(p, 1) for p in prefix_lens]),
                    block_size=bs, all_logits=False)
    toks = tokens(max(chunk_lens))
    out = {}
    logits = {}
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_ops(ops, ref))):
        with ctx:
            logits[name], _ = model.prefill_paged(
                params, {"tokens": toks}, pools, bt, i32(prefix_lens),
                seq_len=i32(chunk_lens), all_logits=True)
    lanes = torch.arange(toks.shape[1], device=device)[None, :] < \
        i32(chunk_lens)[:, None]
    out["prefill"] = _rel_err(torch, logits["kernel"][lanes],
                              logits["plain"][lanes])

    # one decode step at each row's next position (rows 2 inactive)
    pos = i32([p + c for p, c in zip(prefix_lens, chunk_lens)])
    active = torch.tensor([True, True, False, True], device=device)
    step_tokens = tokens(1)
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_ops(ops, ref))):
        step_pools = _clone(pools)
        with ctx:
            logits[name], _ = model.decode_step_paged(
                params, step_pools, torch.where(active[:, None], bt, 0),
                step_tokens, pos, active)
    out["decode"] = _rel_err(torch, logits["kernel"][active],
                             logits["plain"][active])
    return out


def slot_model_parity(torch, device, model, params, ops, ref, write_slot,
                      decode_steps=1, arms=None):
    """Phases 3 and 5, slot path: whole-prompt prefills of 150 and 37
    tokens (``Model.prefill``, one row each, as the slot engine admits),
    their caches spliced into two of three slots, and ``decode_steps``
    decode steps over all three (the third a dead slot at position 0),
    kernels vs plain versions (or the two ``arms``, context managers)
    from identical caches.  -> {"prefill": rel_err, "decode": rel_err
    over every step}."""
    arms = arms or (contextlib.nullcontext(), plain_ops(ops, ref))
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(3)
    lens = (150, 37)
    prompts = [torch.randint(1, cfg.vocab_size, (1, n), generator=gen,
                             device=device, dtype=torch.int32) for n in lens]
    cache = model.cache_init(3, 256)
    logits = ([], [])
    for arm, ctx in enumerate(arms):
        for slot, toks in enumerate(prompts):
            with ctx:
                lg, c1 = model.prefill(params, {"tokens": toks},
                                       cache_max=256)
            logits[arm].append(lg[0, -1])
            if arm == 0:
                write_slot(cache, c1, slot)
    out = {"prefill": _rel_err(torch, torch.stack(logits[0]),
                               torch.stack(logits[1]))}
    steps = torch.randint(1, cfg.vocab_size, (decode_steps, 3, 1),
                          generator=gen, device=device, dtype=torch.int32)
    step_logits = ([], [])
    for arm, ctx in enumerate(arms):
        caches = _clone(cache)
        for i in range(decode_steps):
            pos = torch.tensor([lens[0] + i, lens[1] + i, 0],
                               dtype=torch.int32, device=device)
            with ctx:
                lg, caches = model.decode_step(params, caches, steps[i], pos)
            step_logits[arm].append(lg[:2])
    out["decode"] = _rel_err(torch, torch.stack(step_logits[0]),
                             torch.stack(step_logits[1]))
    return out


def float64_scan(ops, ref):
    """Route the WKV6 scan to its plain version in float64, cast back to
    float32: the recurrence without float32 rounding of its own."""
    def scan(r, k, v, w, u, s0=None):
        out, sf = ref.rwkv6_scan_ref(
            *(t.double() for t in (r, k, v, w, u)),
            None if s0 is None else s0.double())
        return out.float(), sf.float()

    return mock.patch.object(ops, "rwkv6_scan", scan)


def _rel_err(torch, a, b) -> float:
    a, b = a.double(), b.double()
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    return ((a - b).norm() / b.norm()).item()


def smoke_workload(vocab_size, seed=0, n=8, prefix=32, lo=32, hi=200):
    """8 prompts of 32-200 tokens sharing a 32-token tenant prefix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    head = rng.integers(1, vocab_size, prefix).astype(np.int32)
    prompts = []
    for _ in range(n):
        length = int(rng.integers(lo, hi + 1))
        tail = rng.integers(1, vocab_size, length - prefix).astype(np.int32)
        prompts.append(np.concatenate([head, tail]))
    return prompts


SERVE_ARGV = ["--arch", "qwen3-0.6b", "--no-reduced", "--num-blocks", "32",
              "--block-size", "16", "--cache-max", "256", "--max-new", "16",
              "--prefix-cache", "on"]
SLOT_ARGV = ["--arch", "qwen3-0.6b", "--no-reduced", "--engine", "slot",
             "--slots", "4", "--cache-max", "256", "--max-new", "16"]


RWKV_ARGV = ["--arch", "rwkv6-1.6b", "--no-reduced", "--engine", "slot",
             "--slots", "4", "--cache-max", "256", "--max-new", "16"]


def run_engine(engine, prompts, max_new, sync, stats=None):
    """Submit every prompt, drain; -> ({rid: tokens}, seconds).  A
    ``stats`` dict receives the number of engine steps."""
    for p in prompts:
        engine.submit(p, max_new=max_new)
    sync()
    t0 = time.perf_counter()
    outs = {}
    steps = 0
    while not engine.idle:
        steps += 1
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)
    sync()
    if stats is not None:
        stats["steps"] = steps
    return outs, time.perf_counter() - t0


def perturb_zero_init(torch, params, seed):
    """Draw the rwkv6 leaves that the init (as the reference's) leaves at
    zero, which would silence the bonus term and make every decay the
    constant exp(-exp(-3)), in place: mixing coefficients U(0, 1), decay
    bases N(0, 1) (decays ~0.69 to ~0.998), bonus N(0, 0.5), LoRA
    outputs N(0, 0.1)."""
    scale = {"mu": None, "mu_k": None, "w_base": 1.0, "u": 0.5,
             "mix_b": 0.1, "w_b": 0.1}
    gen = None

    def walk(node):
        nonlocal gen
        for key in sorted(node):
            leaf = node[key]
            if isinstance(leaf, dict):
                walk(leaf)
            elif key in scale:
                gen = gen or torch.Generator(device=leaf.device).manual_seed(
                    seed)
                if scale[key] is None:
                    new = torch.rand(leaf.shape, generator=gen,
                                     device=leaf.device)
                else:
                    new = torch.randn(leaf.shape, generator=gen,
                                      device=leaf.device) * scale[key]
                leaf.copy_(new)

    walk(params)
    return params


def rwkv_model_parity(torch, device, model, params, ops, ref, write_slot):
    """The slot path's prefills and 2 decode steps, kernel vs plain scan,
    and each of them against the scan in float64 (what float32 rounding
    in the scan alone moves)."""
    def parity(a, b):
        return slot_model_parity(torch, device, model, params, ops, ref,
                                 write_slot, decode_steps=2, arms=(a, b))

    rel = parity(contextlib.nullcontext(), plain_ops(ops, ref))
    kernel = parity(contextlib.nullcontext(), float64_scan(ops, ref))
    plain = parity(plain_ops(ops, ref), float64_scan(ops, ref))
    dt = model.cfg.dtype
    log(f"model rwkv6-1.6b {dt} {model.cfg.num_layers} layers slot path, "
        f"kernel vs plain: prefill rel_err={rel['prefill']:.3e} "
        f"decode rel_err={rel['decode']:.3e} (2 steps); against the "
        f"float64 scan: kernel {kernel['prefill']:.3e} / "
        f"{kernel['decode']:.3e}, plain {plain['prefill']:.3e} / "
        f"{plain['decode']:.3e}")
    for key, tol in RWKV_MODEL_TOL[dt].items():
        assert rel[key] <= tol, (dt, rel, kernel, plain)

    # each layer's own scan inputs of the 150-token prefill (recorded on
    # the plain path): kernel and plain scan against the scan in float64
    calls = []

    def record(*args):
        calls.append(args)
        return ref.rwkv6_scan_ref(*args)

    gen = torch.Generator(device=device).manual_seed(3)
    toks = torch.randint(1, model.cfg.vocab_size, (1, 150), generator=gen,
                         device=device, dtype=torch.int32)
    with mock.patch.object(ops, "rwkv6_scan", record):
        model.prefill(params, {"tokens": toks}, cache_max=256)
    worst = {"kernel": 0.0, "plain": 0.0}
    for args in calls:
        exact = ref.rwkv6_scan_ref(*(t.double() for t in args))
        for name, fn in (("kernel", ops.rwkv6_scan),
                         ("plain", ref.rwkv6_scan_ref)):
            worst[name] = max(worst[name], *(
                _rel_err(torch, got.double(), want)
                for got, want in zip(fn(*args), exact)))
    log(f"  on each of the {len(calls)} layers' own scan inputs, worst "
        f"relative L2 error of output or state against the float64 scan: "
        f"kernel {worst['kernel']:.3e}, plain {worst['plain']:.3e}")
    assert worst["kernel"] <= 2 * worst["plain"], worst


def rwkv6_phase(torch, device, ops, ref, serve, Model, write_slot, validate,
                sync) -> int:
    """Phase 5: rwkv6-1.6b at full width through the serve path's slot
    engine.  -> ``rwkv6_scan`` launches of its engine run."""
    args = serve.make_parser().parse_args(RWKV_ARGV)
    serve.check_args(args)
    cfg, model, params = serve.build_model(args)
    perturb_zero_init(torch, params, seed=1)
    rwkv_model_parity(torch, device, model, params, ops, ref, write_slot)

    prompts = smoke_workload(cfg.vocab_size)
    run_engine(serve.build_engine(args, model, params), prompts[:2], 2,
               sync)                                          # warm-up
    engine = serve.build_engine(args, model, params)
    run = {}
    ops.reset_launch_counts()
    outs, secs = run_engine(engine, prompts, args.max_new, sync, run)
    counts = ops.launch_counts()
    stats = validate(engine.stats())
    ntok = sum(len(t) for t in outs.values())
    log(f"engine rwkv6-1.6b bf16 24 layers slot ({args.slots} slots): "
        f"{len(outs)} requests, {ntok} tokens in {secs:.3f}s "
        f"({ntok / secs:.1f} tok/s), {run['steps']} steps, "
        f"admissions={stats['admissions']} launches={counts}")
    assert len(outs) == len(prompts)
    assert all(len(t) == args.max_new for t in outs.values())
    assert stats["admissions"] == len(prompts)
    # one launch per layer per engine step (an admission or a decode step)
    assert counts["rwkv6_scan"] == cfg.num_layers * run["steps"], counts
    assert counts["flash_attention"] == counts["paged_attention"] == \
        counts["paged_prefill"] == 0, counts
    del model, params, engine
    torch.cuda.empty_cache()

    f32 = Model(dataclasses.replace(cfg, dtype="float32"), device=device)
    f32_params = perturb_zero_init(torch, f32.init(seed=args.seed), seed=1)
    rwkv_model_parity(torch, device, f32, f32_params, ops, ref, write_slot)
    del f32, f32_params
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, num_layers=2, dtype="float32")
    small_model = Model(small, device=device)
    small_params = perturb_zero_init(torch, small_model.init(seed=args.seed),
                                     seed=1)
    tokens = {}
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_ops(ops, ref))):
        with ctx:
            engine = serve.build_engine(args, small_model, small_params)
            tokens[name], secs = run_engine(engine, prompts, args.max_new,
                                            sync)
        log(f"engine rwkv6-1.6b float32 2 layers slot, {name}: "
            f"{sum(map(len, tokens[name].values())) / secs:.1f} tok/s")
    assert tokens["kernel"] == tokens["plain"], "rwkv6 kernel/plain tokens"
    log("engine rwkv6 float32 slot, kernel and plain: token-identical")
    return counts["rwkv6_scan"]


# ---------------------------------------------------------------- digits


def conv2d_parity(torch, device, ops, ref) -> float:
    """Phase 6: ``conv2d`` against its plain version over ``CONV_SHAPES``
    in float32 and bfloat16: images in [0, 1] at the paper's shape,
    N(0, 1) elsewhere, filters N(0, 0.2).  -> max abs error over the
    float32 cases (the model's dtype)."""
    gen = torch.Generator(device=device).manual_seed(4)
    worst = 0.0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for b, h, w, cin, k, cout in CONV_SHAPES:
            draw = torch.rand if (h, cin, k) == (28, 1, 3) else torch.randn
            x = draw(b, h, w, cin, generator=gen, device=device).to(dtype)
            wt = (torch.randn(k, k, cin, cout, generator=gen, device=device)
                  * 0.2).to(dtype)
            out = ops.conv2d(x, wt)
            plain = ref.conv2d_ref(x, wt)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            torch.testing.assert_close(out.float(), plain.float(),
                                       **KERNEL_TOL["conv2d", dtype_name])
            log(f"parity conv2d {dtype_name} x ({b},{h},{w},{cin}) w "
                f"({k},{k},{cin},{cout}): max_abs_err={err:.3e}")
            if dtype_name == "float32":
                worst = max(worst, err)
    return worst


def digit_predictions(torch, ops, ref, pipe, images):
    """Probabilities of ``images`` through the pipeline's forward pass on
    the kernel and on the plain path; the argmax must agree except where
    the plain path's top-two logits are closer than DIGIT_TIE_MARGIN.
    -> (plain digits, whether each is a tie, max |prob diff|, flips)."""
    from repro_torch.models.cnn import cnn_forward

    x = torch.from_numpy(images).to(pipe.device)
    logits = {}
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_ops(ops, ref))):
        with ctx, torch.inference_mode():
            logits[name] = cnn_forward(pipe.params, pipe.cfg, x)
    assert torch.isfinite(logits["kernel"]).all()
    probs = {k: torch.softmax(v, -1) for k, v in logits.items()}
    torch.testing.assert_close(probs["kernel"], probs["plain"],
                               atol=DIGIT_PROB_ATOL, rtol=0)
    digits = {k: v.argmax(-1) for k, v in logits.items()}
    top2 = logits["plain"].topk(2, -1).values
    tie = top2[:, 0] - top2[:, 1] < DIGIT_TIE_MARGIN
    flips = digits["kernel"] != digits["plain"]
    assert bool(tie[flips].all())
    return (digits["plain"].tolist(), tie.tolist(),
            (probs["kernel"] - probs["plain"]).abs().max().item(),
            int(flips.sum()))


def counting(fn, calls):
    """``fn`` that counts its calls in ``calls["n"]``."""
    def wrapped(*args):
        calls["n"] += 1
        return fn(*args)

    return wrapped


def digit_phase(torch, device, ops, ref) -> tuple:
    """Phase 6: the paper's digit pipeline on the card.  -> (max abs
    error of ``conv2d`` vs plain in float32, ``conv2d`` launches of the
    pipeline's runs: evaluation and both app runs)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.pipeline import StratusPipeline
    from repro_torch.data import mnist
    from repro_torch.serving.loadgen import LoadGenerator
    from repro_torch.serving.server import AppConfig
    from repro_torch.serving.sim import Clock

    err = conv2d_parity(torch, device, ops, ref)

    pipe = StratusPipeline(seed=0, device=device)
    with tempfile.TemporaryDirectory() as root:
        ckpt = CheckpointManager(root)
        ckpt.save(1, {"params": pipe.params})
        step, tree = ckpt.restore_latest({"params": pipe.params})
    assert step == 1
    for name, t in tree["params"].items():
        assert t.device == pipe.params[name].device
        assert torch.equal(t, pipe.params[name]), name
    pipe.params = tree["params"]

    launches = 0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ev = pipe.evaluate()
    secs = time.perf_counter() - t0
    n = ops.launch_counts()["conv2d"]
    assert n == 2, n                    # one forward pass per whole set
    launches += n
    with plain_ops(ops, ref):
        ev_plain = pipe.evaluate()
    log(f"digits evaluate (2,000 test + 1,000 canvas, seeded random "
        f"weights): {secs:.3f}s, conv2d launches={n}, test accuracy "
        f"{ev['test_accuracy']:.4f} (plain {ev_plain['test_accuracy']:.4f})"
        f", canvas {ev['canvas_accuracy']:.4f} (plain "
        f"{ev_plain['canvas_accuracy']:.4f})")
    flips = 0
    for what, (images, _) in (("test", mnist.make_split(2000, pipe.seed + 100)),
                              ("canvas", mnist.canvas_digits(
                                  1000, pipe.seed + 200))):
        _, _, perr, nflip = digit_predictions(torch, ops, ref, pipe, images)
        flips += nflip
        log(f"  {what}: kernel vs plain path, max |prob diff| {perr:.3e}, "
            f"argmax flips {nflip} (each within a {DIGIT_TIE_MARGIN} "
            "margin)")
    if flips == 0:
        assert ev == ev_plain, (ev, ev_plain)

    # the paper-faithful app: 20 posted canvas digits, as the quickstart
    images, labels = mnist.canvas_digits(20, seed=42)
    plain_digits, tie, _, _ = digit_predictions(torch, ops, ref, pipe,
                                                images)
    clock = Clock()
    app = pipe.deploy(clock)
    calls = {"n": 0}
    app.predict_fn = counting(app.predict_fn, calls)
    ops.reset_launch_counts()
    outcomes = []
    for img in images:
        app.post_predict(img, outcomes.append)
    clock.run(until=30.0)
    n = ops.launch_counts()["conv2d"]
    stored = [app.store.poll(f"req-{i + 1}") for i in range(len(images))]
    lat = sorted(o.latency for o in outcomes)
    log(f"digits app AppConfig(): {len(outcomes)} outcomes "
        f"{sorted({o.status for o in outcomes})}, latency {lat[0]:.3f}-"
        f"{lat[-1]:.3f}s virtual, predict calls={calls['n']}, conv2d "
        f"launches={n}; stored digits "
        f"{[d['digit'] if d else None for d in stored]}, labels "
        f"{labels.tolist()}")
    assert len(outcomes) == len(images)
    assert all(o.status == 200 for o in outcomes)
    for i, doc in enumerate(stored):
        assert doc["digit"] == plain_digits[i] or tie[i], (i, doc)
    assert n == calls["n"] > 0, (n, calls)
    launches += n

    # the micro-batched app under a POST load, every request a canvas digit
    pool, _ = mnist.canvas_digits(256, seed=43)
    plain_digits, tie, _, _ = digit_predictions(torch, ops, ref, pipe, pool)
    clock = Clock()
    app = pipe.deploy(clock, AppConfig(**MICRO_BATCHED), seed=25)
    calls = {"n": 0}
    app.predict_fn = counting(app.predict_fn, calls)
    sent = []

    def issue(done):
        sent.append(len(sent) % len(pool))
        app.post_predict(pool[sent[-1]], done)

    ops.reset_launch_counts()
    rep = LoadGenerator(clock, issue, users=25, spawn_rate=3, duration=30.0,
                        seed=25, kind="POST").run()
    n = ops.launch_counts()["conv2d"]
    log(f"digits app micro-batched {MICRO_BATCHED}: {rep.row()} "
        f"per_status={rep.per_status}, predict calls={calls['n']}, conv2d "
        f"launches={n}")
    assert rep.total > 0 and rep.failure_pct < 5.0, rep
    assert n == calls["n"] > 0, (n, calls)
    answered = 0
    for i, img in enumerate(sent):
        doc = app.store.poll(f"req-{i + 1}")
        if doc is not None:             # refused or timed-out requests
            answered += 1
            assert doc["digit"] == plain_digits[img] or tie[img], (i, doc)
    assert answered > 0
    launches += n
    del pipe, app
    torch.cuda.empty_cache()
    return err, launches


# ---------------------------------------------------------------- timing


def profile_engine(torch, run):
    """Device time by kernel over one engine run under torch.profiler.
    -> (wall seconds under the profiler, device-busy seconds,
    [(device us, launches, kernel name)] largest first)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        secs = run()
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0), reverse=True)
    return secs, sum(r[0] for r in rows) / 1e6, rows


SPIN_CYCLES = 2_000_000       # ~1 ms of the card's clock


def time_ms(torch, fn, iters=20):
    """Mean device time of ``fn`` over ``iters`` launches, with the 50 MB
    L2 cache flushed before each (a serving step finds its inputs cold).
    A spin kernel of ~1 ms runs before the start event, so the card is
    still busy while the host enqueues ``fn``: the events bracket the
    device's work, not the host's launch overhead (the engine runs
    measure that), except where ``fn`` takes the host longer than the
    spin to enqueue (the plain versions' Python loops)."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def sdpa(torch, q, k, v, mask=None, causal=False):
    """One PyTorch call for attention with an explicit boolean mask or
    the causal one: q (B,H,Sq,hd), k/v (B,KV,Sk,hd), mask (B,1,Sq,Sk)."""
    import torch.nn.functional as F

    try:
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              is_causal=causal,
                                              enable_gqa=True)
    except TypeError:                       # torch without enable_gqa
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            attn_mask=mask, is_causal=causal)


def kernel_times(torch, device, ops, ref):
    """Phase 7, at the parity phase's main-path shapes, the attention
    kernels in bfloat16 with window 0, ``rwkv6_scan`` and ``conv2d`` in
    float32.  -> {kernel: record}."""
    gen = torch.Generator(device=device).manual_seed(2)
    dt = torch.bfloat16
    elt = 2
    out = {}

    q, k, v, kp, bt, pos = decode_case(torch, gen, device, dt)
    b, h, hd = q.shape
    kv = k.shape[2]
    vis = decode_visible(torch, kp, bt, pos, 0)                  # (B, L)
    bs = k.shape[1]
    live = vis.reshape(b, -1, bs).any(-1)                        # (B, nb)
    live_blocks = int(live.sum())
    nbytes = (2 * q.numel() * elt + bt.numel() * 4 + pos.numel() * 4
              + live_blocks * (2 * bs * kv * hd * elt + bs * 4))
    flops = 4 * hd * h * int(vis.sum())
    gk = k[bt.long()].reshape(b, -1, kv, hd).transpose(1, 2)
    gv = v[bt.long()].reshape(b, -1, kv, hd).transpose(1, 2)
    mask = vis[:, None, None, :]
    out["paged_attention"] = dict(
        ms=time_ms(torch, lambda: ops.paged_attention(q, k, v, kp, bt, pos)),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(
            q, k, v, kp, bt, pos)),
        library_ms=time_ms(torch, lambda: sdpa(torch, q[:, :, None], gk, gv,
                                               mask)),
        bytes=nbytes, flops=flops)

    q, k, v, kpos, qpos = prefill_case(torch, gen, device, dt)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    vis = prefill_visible(torch, kpos, qpos, 0)                   # (B,S,L)
    keys = int(vis.any(1).sum())
    nbytes = (2 * q.numel() * elt + kpos.numel() * 4 + qpos.numel() * 4
              + keys * 2 * kv * hd * elt)
    flops = 4 * hd * h * int(vis.sum())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = vis[:, None]
    out["paged_prefill"] = dict(
        ms=time_ms(torch, lambda: ops.paged_prefill(q, k, v, kpos, qpos)),
        plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
            q, k, v, kpos, qpos)),
        library_ms=time_ms(torch, lambda: sdpa(torch, qt, kt, vt, mask)),
        bytes=nbytes, flops=flops)

    # the fused decode dispatch's shape: one query lane per row
    q, k, v, kpos, qpos = prefill_case(torch, gen, device, dt, b=8, s=1)
    vis = prefill_visible(torch, kpos, qpos, 0)
    nbytes = (2 * q.numel() * elt + kpos.numel() * 4 + qpos.numel() * 4
              + int(vis.any(1).sum()) * 2 * kv * hd * elt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out["paged_prefill_s1"] = dict(
        ms=time_ms(torch, lambda: ops.paged_prefill(q, k, v, kpos, qpos)),
        plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
            q, k, v, kpos, qpos)),
        library_ms=time_ms(torch, lambda: sdpa(torch, qt, kt, vt,
                                               vis[:, None])),
        bytes=nbytes, flops=4 * hd * h * int(vis.sum()))

    # the slot engine's whole-prompt prefill: one row, causal, window 0
    for s in (512, 2048):
        q, k, v = flash_case(torch, gen, device, dt, sq=s)
        b, h, _, hd = q.shape
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
        out[f"flash_attention_{s}"] = dict(
            ms=time_ms(torch, lambda: ops.flash_attention(q, k, v)),
            plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v)),
            library_ms=time_ms(torch, lambda: sdpa(torch, q, k, v,
                                                   causal=True)),
            bytes=nbytes, flops=4 * hd * h * b * (s * (s + 1) // 2))

    # the rwkv6 slot path: a prompt row of S=200 and a decode step over 4
    # slots, float32; bytes: r, k, v, w read and out written (B,H,S,hd), u,
    # s0 read and s_final written; operations: the least the recurrence
    # needs, 5 hd^2 + 5 hd per (row, head, step) (r.S and the state update
    # per (i, j), the bonus term per i / j)
    for b, s in ((1, 200), (4, 1)):
        r, k, v, w, u, s0 = rwkv_case(torch, gen, device, b=b, s=s)
        _, h, _, hd = r.shape
        out[f"rwkv6_scan_{b}x{s}"] = dict(
            ms=time_ms(torch, lambda: ops.rwkv6_scan(r, k, v, w, u, s0)),
            plain_ms=time_ms(torch, lambda: ref.rwkv6_scan_ref(
                r, k, v, w, u, s0)),
            library_ms=None, dtype="float32",
            bytes=4 * (5 * r.numel() + u.numel() + 2 * s0.numel()),
            flops=(5 * hd * hd + 5 * hd) * b * h * s)

    # the digit CNN's conv layer in float32 (the model's dtype) at the
    # consumer's batches of 1 and 32 and evaluation's 2,000 test digits;
    # bytes: x and w read, the output written (28x the input here);
    # library: cuDNN on the NCHW / OIHW views, TF32 off (``main``)
    import torch.nn.functional as F

    for b in (1, 32, 2000):
        x = torch.rand(b, 28, 28, 1, generator=gen, device=device)
        w = torch.randn(3, 3, 1, 32, generator=gen, device=device)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        out[f"conv2d_{b}"] = dict(
            ms=time_ms(torch, lambda: ops.conv2d(x, w)),
            plain_ms=time_ms(torch, lambda: ref.conv2d_ref(x, w)),
            library_ms=time_ms(torch, lambda: F.conv2d(xn, wn)),
            dtype="float32",
            bytes=4 * (x.numel() + w.numel() + b * 26 * 26 * 32),
            flops=2 * b * 26 * 26 * 3 * 3 * 32)

    for rec in out.values():
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rec["flops"] / PEAK_FLOPS[rec.get("dtype", "bfloat16")] * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


# ---------------------------------------------------------------- main


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch import serve
    from repro_torch.models.api import Model
    from repro_torch.serving.kvcache import write_slot
    from repro_torch.serving.server import ragged_dispatch
    from repro_torch.serving.stats_schema import validate

    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    # full float32 in products and convolutions: the plain versions run
    # float32 matmuls (already the default), and cuDNN's convolution, timed
    # as conv2d's yardstick, would otherwise run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f}s: "
        f"{sorted(p.name for p in libs.values())}")
    for name in libs:
        for line in (build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    # 2. kernel parity
    errs = kernel_parity(torch, device, ops, ref)

    # 3. model at full width, paged and slot paths
    full = get_config("qwen3-0.6b")
    small = dataclasses.replace(full, num_layers=2, dtype="float32")
    for cfg, what in ((full, "bf16 28 layers"), (small, "float32 2 layers")):
        model = Model(cfg, device=device)
        params = model.init(seed=0)
        tol = MODEL_TOL[cfg.dtype]
        for path, rel in (
                ("paged", model_parity(torch, device, model, params, ops,
                                       ref, ragged_dispatch)),
                ("slot", slot_model_parity(torch, device, model, params, ops,
                                           ref, write_slot))):
            log(f"model qwen3-0.6b {what} {path} path, kernels vs plain: "
                f"prefill rel_err={rel['prefill']:.3e} "
                f"decode rel_err={rel['decode']:.3e}")
            assert max(rel.values()) <= tol, (path, rel)
        del model, params

    # 4. engine through the serve path
    args = serve.make_parser().parse_args(SERVE_ARGV)
    serve.check_args(args)
    cfg, model, params = serve.build_model(args)
    prompts = smoke_workload(cfg.vocab_size)
    sync = torch.cuda.synchronize
    launches = {"conv2d": 0, "flash_attention": 0, "paged_attention": 0,
                "paged_prefill": 0, "rwkv6_scan": 0}
    for fusion in ("on", "off"):
        args.decode_fusion = fusion
        run_engine(serve.build_engine(args, model, params), prompts[:2], 2,
                   sync)                                      # warm-up
        engine = serve.build_engine(args, model, params)
        ops.reset_launch_counts()
        outs, secs = run_engine(engine, prompts, args.max_new, sync)
        counts = ops.launch_counts()
        stats = validate(engine.stats())
        ntok = sum(len(t) for t in outs.values())
        log(f"engine qwen3-0.6b bf16 28 layers decode_fusion={fusion}: "
            f"{len(outs)} requests, {ntok} tokens in {secs:.3f}s "
            f"({ntok / secs:.1f} tok/s), preemptions={stats['preemptions']} "
            f"hit_rate={stats['hit_rate']:.2f} launches={counts} "
            f"decode_kernel={stats['decode_kernel']}")
        assert len(outs) == len(prompts)
        assert all(len(t) == args.max_new for t in outs.values())
        assert stats["preemptions"] >= 1, "pool must be tight enough to preempt"
        if fusion == "on":
            assert counts["paged_prefill"] > 0
            assert stats["decode_kernel"] == 0
        else:
            assert counts["paged_attention"] > 0
            assert stats["decode_kernel"] == 1
        for k, n in counts.items():
            launches[k] += n

    slot_args = serve.make_parser().parse_args(SLOT_ARGV)
    serve.check_args(slot_args)
    run_engine(serve.build_engine(slot_args, model, params), prompts[:2], 2,
               sync)                                          # warm-up
    engine = serve.build_engine(slot_args, model, params)
    ops.reset_launch_counts()
    outs, secs = run_engine(engine, prompts, slot_args.max_new, sync)
    counts = ops.launch_counts()
    stats = validate(engine.stats())
    ntok = sum(len(t) for t in outs.values())
    log(f"engine qwen3-0.6b bf16 28 layers slot ({slot_args.slots} slots): "
        f"{len(outs)} requests, {ntok} tokens in {secs:.3f}s "
        f"({ntok / secs:.1f} tok/s), admissions={stats['admissions']} "
        f"launches={counts}")
    assert len(outs) == len(prompts)
    assert all(len(t) == slot_args.max_new for t in outs.values())
    assert stats["admissions"] == len(prompts)
    assert counts["flash_attention"] == cfg.num_layers * stats["admissions"]
    assert counts["paged_prefill"] > 0 and counts["paged_attention"] == 0
    for k, n in counts.items():
        launches[k] += n

    args.decode_fusion = "on"
    engine = serve.build_engine(args, model, params)
    secs, busy, rows = profile_engine(
        torch, lambda: run_engine(engine, prompts, args.max_new, sync)[1])
    ours = sum(us for us, _, key in rows if "paged_" in key) / 1e6
    log(f"profile engine bf16 28 layers decode_fusion=on: wall {secs:.3f}s "
        f"under the profiler, device busy {busy:.3f}s "
        f"({100 * busy / secs:.1f}%), attention kernels {ours:.3f}s "
        f"({100 * ours / max(busy, 1e-9):.1f}% of busy)")
    for us, n, key in rows[:10]:
        log(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:90]}")

    small_model = Model(small, device=device)
    small_params = small_model.init(seed=args.seed)
    tokens = {}
    for fusion in ("on", "off"):
        args.decode_fusion = fusion
        engine = serve.build_engine(args, small_model, small_params)
        tokens[fusion], secs = run_engine(engine, prompts, args.max_new, sync)
        log(f"engine qwen3-0.6b float32 2 layers decode_fusion={fusion}: "
            f"{sum(map(len, tokens[fusion].values())) / secs:.1f} tok/s")
    engine = serve.build_engine(slot_args, small_model, small_params)
    tokens["slot"], secs = run_engine(engine, prompts, slot_args.max_new,
                                      sync)
    log(f"engine qwen3-0.6b float32 2 layers slot: "
        f"{sum(map(len, tokens['slot'].values())) / secs:.1f} tok/s")
    assert tokens["on"] == tokens["off"], "fusion on/off tokens differ"
    assert tokens["slot"] == tokens["on"], "slot and paged tokens differ"
    log("engine float32 paged fusion on/off and slot: token-identical")

    # 5. rwkv6-1.6b through the slot engine, the qwen3 models freed first
    del model, params, small_model, small_params, engine
    torch.cuda.empty_cache()
    launches["rwkv6_scan"] = rwkv6_phase(torch, device, ops, ref, serve,
                                         Model, write_slot, validate, sync)

    # 6. the paper's digit pipeline
    errs["conv2d"], launches["conv2d"] = digit_phase(torch, device, ops, ref)

    # 7. times
    times = kernel_times(torch, device, ops, ref)
    for key, what in (("paged_prefill_s1", "paged_prefill bf16 at the "
                       "fused-decode shape (8 rows, S=1, 512 prefix keys)"),
                      ("flash_attention_2048", "flash_attention bf16 at one "
                       "causal row of S=2048")):
        t = times[key]
        log(f"time {what}: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
            f"sdpa {t['library_ms']:.4f} ms")
    records = []
    for name, key, replaces in (
            ("flash_attention", "flash_attention_512",
             "src/repro/kernels/flash_attention.py:92"),
            ("paged_attention", "paged_attention",
             "src/repro/kernels/paged_attention.py:96"),
            ("paged_prefill", "paged_prefill",
             "src/repro/kernels/ops.py:87")):
        t = times[key]
        log(f"time {key} bf16: {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} "
            f"ms ({t['bound_by']}), plain {t['plain_ms']:.4f} ms, "
            f"sdpa {t['library_ms']:.4f} ms")
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for key, what in (("rwkv6_scan_1x200", "one prompt row of S=200"),
                      ("rwkv6_scan_4x1", "a decode step over 4 slots")):
        t = times[key]
        log(f"time rwkv6_scan float32 at {what} (32 heads of 64): "
            f"{t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, no library "
            "call")
    t = times["rwkv6_scan_1x200"]
    records.append({
        "name": "rwkv6_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:90",
        "launches": launches["rwkv6_scan"],
        "max_abs_err": errs["rwkv6_scan"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None})
    for b in (1, 32, 2000):
        t = times[f"conv2d_{b}"]
        log(f"time conv2d float32 at B={b} (28x28x1 images, 32 filters of "
            f"3x3): {t['ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} bytes read and written), "
            f"plain {t['plain_ms']:.4f} ms, cudnn {t['library_ms']:.4f} ms "
            "(TF32 off)")
    t = times["conv2d_32"]              # the micro-batched consumer's batch
    records.append({
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d.py:37",
        "launches": launches["conv2d"], "max_abs_err": errs["conv2d"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
