#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``, sm_90a),
then runs its phases, each raising on failure:

1. device: the card's name and power limit, the kernels' build time;
2. kernel parity: each kernel against its plain PyTorch version at the
   serving paths' shapes (``paged_attention`` at the smoke decode shape
   and the fusion-off engine's, both split, and at 24 rows, whole;
   ``paged_prefill`` at a chunk's, at the fused decode dispatch's and at
   slot decode's, ``flash_attention`` at the slot engine's whole-prompt
   prefill up to 2,048 tokens; ``paged_prefill`` at the speculative
   verify dispatch and ``flash_attention`` at the draft model's padded
   one-row forwards) in bfloat16 and float32, ``rwkv6_scan`` at the
   rwkv6 slot path's prefill and decode in float32; then the three
   attention kernels in bfloat16 at phi4-mini-3.8b's heads (24/8, a
   group of 3), qwen1.5-110b's and jamba's (64/8) and dbrx-132b's and
   grok-1-314b's (48/8, a group of 6): the fused decode dispatch and a
   chunk of ``paged_prefill``, ``paged_attention`` over tables of 16
   blocks, ``flash_attention`` at S=512; ``ssm_scan`` at jamba's
   d_inner 16,384 (1 and 8 rows, S = 1, 64 and 256, and one row of
   2,048; plain and with ``dt`` 0 past per-row lengths) with x and y in
   float32 and in bf16, beside the scan in float64, a masked row's state
   bit-equal to its unpadded run's, and a chunk cut into two calls with
   the state carried bit-equal to one call; the int8 KV cache's variants
   ``paged_attention_int8`` and ``paged_prefill_int8`` at the decode,
   chunk (int8 prefixes of 512 and 496 lanes), fused-decode, slot-decode
   (strips of 256 and 200 lanes, no chunk keys) and verify shapes in
   bfloat16 and float32, at the dense configs' heads and at gemma3-4b's
   head_dim 256 (windows 0 and 1,024), each within ``KERNEL_TOL`` of its
   int8 plain version and bit-equal to the float kernel on the
   dequantized keys; ``flash_attention`` and ``paged_prefill`` at
   whisper-tiny's and paligemma-3b's shapes (``FRONTEND_*_SHAPES``:
   the encoder's non-causal 1,500 frames at 6/6 heads of 64, the
   cross-attention at Sq 1 (8 rows) and 200 over those frames, the
   prefix-LM at 8/1 heads of 256 with prefixes of 256 and 200 at
   S=456, slot decode at both configs' heads) in bfloat16 and float32;
   the two backward kernels at their training shapes
   (``SCAN_BWD_SHAPES``: ``rwkv6_scan_bwd`` at rwkv6-1.6b's 8 x 128 and
   one row of 300, ``ssm_scan_bwd`` at jamba's 8 x 128 with float32 and
   bf16 x and 2 x 2,048 with bf16 x), with a start state and a
   final-state gradient, every gradient within ``BWD_GRAD_REL`` x its
   max|g| of the plain backward (bf16 dx within 2 ulps), a repeat launch
   bit-identical; every ``paged_prefill`` case logs the bf16 tile it
   ran (``pp_tile``: the Hopper tile for more than 16 query rows a CTA,
   the kWarpKeys mma.sync tile for the decode shapes);
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
   each kernel ran; a profile of the paged engine in each mode (8
   tokens a prompt) lists
   device time by kernel, the bf16 attention's combine pass and
   ``paged_attention`` included; then at full
   width with 2 layers in float32 the paged engine's two modes and the
   slot engine must emit identical tokens;
4b. engine features: through the same serve path at full width in bf16,
   on the smoke prompts and 8 seeded ``repetitive_workload`` prompts,
   the serial scheduler (exactly 28 ``paged_prefill`` launches per
   admission step and 28 ``paged_attention`` per decode step), n-gram
   and one-layer-draft speculation at k=4 (verify windows wider than one
   lane in ``paged_prefill``, no ``paged_attention``; the draft's
   ``flash_attention`` launches equal its counted forwards), and the
   observability hooks (a trace that validates, every span closed, the
   spec counters in ``metrics.render()``); tokens/s and spec gauges per
   mode; how many bf16 tokens each mode shares with the continuous one,
   with the top-2 logit margin at each first flip; then at 2 layers in
   float32 serial, fusion off, n-gram k=1 and 4 and draft k=4 must emit
   the continuous mode's tokens;
4c. cluster: the serve path's paged config as 1, 2 and 4 replicas of the
   one weight copy behind the balancer and broker
   (``serving/cluster.py``), affinity on and off, on a multi-tenant
   workload beside the smoke prompts: tokens/s, cluster and engine
   steps, hit rates, 429s, the balancer's gauges; ``paged_prefill``
   launches exactly layers x engine steps; a replay from the seed routes
   alike; affinity keeps each tenant on one replica and serves at least
   as much from the caches; a balancer 429 and a broker 429, every
   accepted request whole and the broker drained; fusion off launches
   ``paged_attention`` exactly layers x decode dispatches; the merged
   TTFT histogram counts every request; bf16 tokens shared with 1
   replica before each first flip, with the top-2 logit margin there;
   at 2 layers in float32 every replica count, affinity on and off, and
   the slot engine emit the same tokens; the serve CLI's ``--replicas
   2 --metrics``;
4g. the int8 KV cache (run after 4c, on phase 4's qwen3-0.6b weights):
   ``kv_cache_quant`` through ``launch.serve.build_engine``; model parity
   int8 kernels vs int8 plain versions (paged: a ragged prefill after a
   prefix and a decode step; slot: a prompt and 2 decode steps); paged
   fusion on and off (the tight pool preempts, prefix cache on), n-gram
   k=4 and the slot engine on the smoke prompts with exact
   ``paged_prefill_int8`` / ``paged_attention_int8`` launches a dispatch
   and no float ``paged_prefill`` / ``paged_attention``; tokens/s, steps,
   preemptions; the pool's K/V bytes a token beside the bf16 pool's; as a
   reading, the tokens each mode shares with the bf16 cache's run and the
   top-2 margin at the first flip; at 2 layers in float32 each mode's
   tokens through the kernels equal its plain versions'; on the CPU
   tests' reduced config, settings and workload every mode token-
   identical, as the reference there;
4d. dense configs: with qwen3 freed, phi4-mini-3.8b at its published
   width (32 layers, 24/8 heads) and qwen1.5-110b at 4 of its 80
   full-width layers (64/8 heads, seeded non-zero q/k/v biases), bf16,
   seeded weights: model parity kernels vs plain on the paged and slot
   paths; phi4-mini's paged engine, fusion on and off, and slot engine,
   qwen1.5's paged engine, on the smoke prompts with exact launch
   counts; each config's memory high-water mark;
4e. gemma3-4b: at its published width (34 layers: 29 sliding-window
   ``attn_local`` layers of 1,024 and 5 global ones, 8/4 heads of 256,
   GeGLU, tied 262,144 vocab), bf16, seeded weights: the three
   attention kernels at head_dim 256 against their plain versions in
   bfloat16 and float32, window 0 and 1,024; model parity kernels vs
   plain past the window (paged: chunks after prefixes of 1,400 and 900
   tokens and a decode step; slot: a 1,500-token prompt, the local rings
   wrapped, and 2 decode steps); the paged engine (fusion on and off)
   and the slot engine on the smoke prompts and two of 1,100-2,000
   tokens, with exact launch counts; a profile of the fused engine; the
   weights' size and the memory high-water marks;
4f. MoE and mamba: dbrx-132b (4 of 40 layers), grok-1-314b (2 of 64)
   and jamba-1.5-large-398b (5 of 72: mamba, mamba + MoE, mamba, mamba +
   MoE, attention), every width published, bf16, seeded weights (mamba's
   constant leaves drawn), one after another: model parity kernels vs
   plain on the paged and slot paths (jamba's, whose mamba layers feed
   near-tie routers, a reading beside its paged one with the scan in
   float64 on the kernel side; its gate holds the plain path's routing
   on both paths); the serve path's engines (jamba:
   paged fusion on and off and slot; dbrx: fusion on and slot; grok:
   fusion on) on the smoke prompts with exact launches per dispatch (a
   jamba dispatch: 4 ``ssm_scan`` and one ``paged_prefill``, or one
   ``paged_attention`` on a decode dispatch), tokens/s, steps,
   preemptions, the peak of ``state_slots_used``, memory high-water
   marks; a profile of jamba's fused engine; then the three reduced
   configs in float32 under dropless capacity: paged fusion on, off and
   slot emit identical tokens;
4h. whisper-tiny (4 + 4 layers, 1,500 frames) and paligemma-3b (18
   layers, 256 patches) uncut, bf16, seeded weights and frontend
   embeddings, one after the other, through ``Model.prefill`` and
   ``Model.decode_step`` (no engine serves them, as none of the
   reference's does): the 8 smoke prompts prefilled one at a time,
   then decoding 16 greedy tokens as one batch; exactly 12
   ``flash_attention`` launches a whisper prefill (4 encoder, 4 self,
   4 cross) and 4 (cross) plus 4 ``paged_prefill`` a decode step, 18
   ``flash_attention`` a paligemma prefill (the prefix-LM) and 18
   ``paged_prefill`` a decode step; the plain versions fed the
   kernels' tokens, logits within ``MODEL_TOL``, the tokens they
   choose alike and the top-2 margin at each first flip;
   ``Model.forward`` against ``forward_train``; the median decode step
   and memory high-water marks; the reduced configs in float32, card
   (kernels) against CPU (plain versions), the same tokens;
5. rwkv6: with the qwen3 model freed, rwkv6-1.6b at its published
   width (24 layers, bfloat16, seeded random weights with the
   reference's zero-initialised leaves drawn too) through the serve
   path's slot engine: whole-prompt prefills and decode steps through
   ``rwkv6_scan`` and through its plain version agree, in bfloat16 and
   in float32, each beside the scan in float64; the engine
   answers 8 requests with ``rwkv6_scan`` launched 24 times per engine
   step and no attention kernel; the paged engine, fusion on and off,
   24 ``rwkv6_scan`` per dispatch and no attention kernel; a masked
   ragged dispatch's final states against the plain masked scan on each
   layer's own inputs; at 2 layers in float32 the slot engine emits the
   same tokens through the kernel and the plain version, and the paged
   engine (fusion on and off) the slot engine's;
6. digits: the paper's pipeline (mnist-cnn at its published width,
   float32, seeded weights saved and restored through the checkpoint
   store): ``conv2d`` against its plain version over the reference's
   sweep, the pipeline's batches, rows that are not multiples of 16
   bytes, a Cout that is not a multiple of 4 and B=5,000, in float32 and
   bfloat16;
   ``StratusPipeline.evaluate`` over 2,000 test and 1,000 canvas digits
   with the plain path's predictions; ``StratusApp`` answering 20 posted
   canvas digits (paper-faithful config) with the plain path's digits,
   and a POST load of 25 users through ``LoadGenerator`` on the
   micro-batched config under 5 % failures; ``conv2d`` launched once per
   forward pass;
6b. digits, training: ``conv2d_wgrad`` against its plain version over
   the same sweep plus the training step's B=64 and 320, float32 and
   bfloat16, a repeat launch bit-identical; ``ops.conv2d``'s autograd
   Function (dx, dw) against autograd through the plain ``conv2d_ref``;
   ``cnn_loss``'s
   gradients for all six parameters, kernels vs plain; 4 sync rounds
   through the kernels and through the plain versions from one seed;
   then ``StratusPipeline.train`` at the reference benchmark's budget
   (sync, 5 workers, 12,000 digits, 36 rounds of 2 steps): test accuracy
   >= 0.98, ``conv2d`` launched 360 + 2 (``evaluate``) times and
   ``conv2d_wgrad`` 360, its checkpoint restored and served; ``local_sgd``
   and ``elastic`` at ``bench_strategies``' budget (8,000 / 24 / 2), each
   >= 0.98;
6c. LLM training (``launch/train.py``'s path: attention launches no
   kernel, as the reference trains through its q-chunked jnp attention,
   its kernels having no VJP; rwkv6's and mamba's scans run their
   kernels forward and their backward kernels under autograd, exactly
   ``train_launches`` a run): qwen3-0.6b at its published width (28
   layers, bf16) for 20 steps (the CLI's 100 cut to keep the script
   inside its time) at batch 8 x seq 128 with a checkpoint every 5:
   every loss and grad norm finite, the LEARNING verdict, no kernel
   launched, the step-20 checkpoint restoring bit-equal weights and
   optimizer state, a restart from step 15 repeating the losses within
   ``RESUME_ATOL``; the median step time and memory high-water mark; the
   training forward's logits against ``Model.forward``'s
   (``flash_attention``) on the trained weights within the model
   tolerance; a profile of 3 more steps (device busy share, device time
   by kernel); at 2 layers in float32 (TF32 off) the loss and every
   gradient leaf on the card against the CPU; rwkv6-1.6b uncut through
   the CLI (20 steps, batch 8 x seq 128: 48
   ``rwkv6_scan`` and 24 ``rwkv6_scan_bwd`` a step, LEARNING, the median
   step and memory); the card against the CPU at rwkv6's 2 layers and
   jamba's reduced config (dropless) in float32, through the backward
   kernels; gemma3-4b (6 of 34 layers, seq 2,048: the window across two
   query chunks at head_dim 256), dbrx-132b (1 of 40 layers: the router
   term) and jamba-1.5-large-398b (1 of 72 layers, a mamba layer at
   d_inner 16,384 over seq 2,048: one ``ssm_scan`` and one
   ``ssm_scan_bwd`` a step) at their published widths, and whisper-tiny
   and paligemma-3b uncut (each step's frontend embeddings drawn from
   its seed), 10 steps each, losses finite and falling, no kernel
   launched; the card against the CPU at whisper's and paligemma's
   reduced configs in float32; each sub-step's seconds (the phase's
   seconds too, as every phase's);
7. times: each kernel's time beside its bound, its plain version's and
   one PyTorch library call's where there is one (a yardstick only; the
   port never calls it), the kernel and the library call both by events
   around one launch (``time_ms``) and by CUDA-graph replay
   (``graph_ms``), which reads below the events' floor; for the bf16
   attention shapes (the spec verify dispatch and the draft's forwards
   among them) the kernel's ratio to SDPA, whether its key ranges
   were split (``paged_attention``: its grid's CTAs) and, where split,
   the time with them whole; ``conv2d``'s launch plan and its times
   under forced plans; ``conv2d_wgrad`` at B=64, 320 and 2,000 beside
   ``torch.nn.grad.conv2d_weight`` and ``dy.sum()`` (a read of the same
   dy), its launch plan and its times under forced plans; the attention
   kernels at the dense configs' heads as in phase 2, and at gemma3-4b's
   heads of 256 as in phase 4e (window 0 and, where the band cuts,
   1,024: the bound counts only the keys inside each query's band;
   SDPA with the band as a mask, the kernel it ran named); ``ssm_scan``
   at phase 2's shapes, in float32 and with bf16 x and y, beside its
   bound (bytes counted by dtype), its SFU floor (16 exponentials a
   (row, step, channel) at 16 a clock per SM and the card's top SM
   clock) and its plain version (no library call computes the selective
   scan), and its ring's slot size; the two backward kernels at
   ``SCAN_BWD_SHAPES`` beside their bounds (bytes and operations as the
   sources count them; ``ssm_scan_bwd`` also its SFU floor) and their
   plain versions (no library call computes a scan's VJP); the int8 variants at phase 2's bf16
   shapes beside their bound (q, the int8 K/V and scales, kpos and the
   output each moved once), the bf16 kernel on the dequantized keys,
   their plain versions and SDPA over the dequantized keys (a yardstick:
   no PyTorch call reads int8 K/V); ``flash_attention`` and
   ``paged_prefill`` at whisper-tiny's and paligemma-3b's shapes as in
   phase 2, beside SDPA (the prefix as a boolean mask, the backend SDPA
   ran named); every ``paged_prefill`` shape with the bf16 tile it ran,
   and the bf16 ``paged_prefill`` launches of phases 3-6c by tile (both
   tiles must have run); the floor of both methods (one launch on one
   element);
8. the dry-run and the roofline of a whole step (``launch/dryrun.py``,
   ``roofline_phase``): qwen3-0.6b train_4k as rank 0 of the (16, 16)
   production mesh under ``tp`` on a fake process group (shapes only,
   on the host), its per-device memory and roofline terms; then
   qwen3-0.6b's prefill at full width in bf16 on the card (8 x 2,048
   tokens, median of 5 after a warm-up) against the assembled per-device
   FLOPs and bytes of the same shape on a (1, 1) fake mesh: compute_s,
   memory_s, the measured seconds and the share of bf16 peak, beside the
   card's name and power limit, and one prefill's device time by kernel.

Prints one JSON line of kernel records, the ``nvidia-smi`` name and
power limit, and last ``{"ok": true, "device": {...}}``.  Exits non-zero
without a result when there is no CUDA device or no checkout around it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
# the card's datasheet rates, set in main() from repro_torch.launch.mesh
# (one set of constants for the kernels' bounds and the roofline):
# HBM_BYTES_PER_S, and PEAK_FLOPS by dtype (dense; float32 on the CUDA
# cores, no tensor cores)
HBM_BYTES_PER_S = PEAK_FLOPS = None

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
    # each step's 16-term output sum in another order, ex2.approx of the
    # pre-scaled product against torch.exp and fused multiply-adds, the
    # state carrying the rounding across up to 2,048 steps; outputs of a
    # few units
    ("ssm_scan", "float32"): dict(atol=1e-4, rtol=1e-4),
    # bf16 x and y (the state float32, as float32's): both sides sum in
    # float32 and round y to bf16 once, one bf16 ulp apart at most, beside
    # the float32 difference before the rounding
    ("ssm_scan", "bfloat16"): dict(atol=1e-4, rtol=2 ** -7),
    # an FMA chain against the plain version's products and adds, over at
    # most 75 terms of outputs below ~10
    ("conv2d", "float32"): dict(atol=1e-5, rtol=1e-5),
    # both sides sum in float32 and round the output to bf16 once: one
    # bf16 ulp (2**-7 of the value) apart at most
    ("conv2d", "bfloat16"): dict(atol=1e-3, rtol=2 ** -7),
}
# conv2d_wgrad and the conv's autograd Function, kernel vs plain: float32
# sums in other orders over up to B*H'*W' (1.35 million at B=2,000)
# products, so the rounding scales with the largest value: atol is this
# many times max|plain|; bfloat16 adds one bf16 ulp (both sides round the
# float32 sum once)
WGRAD_TOL = {"float32": dict(scaled_atol=1e-5, rtol=1e-5),
             "bfloat16": dict(scaled_atol=1e-5, rtol=2 ** -7)}
# cnn_loss gradients at B=64, kernels vs plain path: float32, sums in
# other orders (as tests/test_torch_autograd.py against jax.grad), where
# every 2x2 max-pool picks the same element on both paths; a window whose
# top two conv outputs lie within GRAD_TIE_MARGIN may route its gradient
# to the other element (the dense layers' gradients stay held tight)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
GRAD_TIE_MARGIN = 1e-5
# the reference benchmark's budgets (benchmarks/run.py:
# bench_train_time_accuracy, bench_strategies) and the accuracy each must
# reach (the reference reaches 0.9995 and 0.998-1.000 at them on a CPU)
TRAIN_BUDGET = dict(train_n=12_000, rounds=36, steps_per_round=2)
STRATEGY_BUDGET = dict(train_n=8_000, rounds=24, steps_per_round=2)
TRAIN_MIN_ACCURACY = 0.98
# 4 sync rounds from one seed, kernels vs plain versions: each round's
# loss; the conv sums differ in order and Adam's steps amplify rounding
# where a gradient is near 0 (tests/test_torch_train.py)
TRAIN_LOSS_RTOL = 1e-3
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
# up to 32, evaluation's 1,000 canvas and 2,000 test digits; then the
# kernel's own edges: input and output rows that are not multiples of 16
# bytes (bfloat16 rows of 30 and 312 bytes; 84 and 228 with 6 output
# channels, not a multiple of 4), and a batch whose persistent CTAs each
# walk ~70 items
CONV_SHAPES = ((5, 28, 28, 1, 3, 32), (130, 28, 28, 1, 3, 32),
               (4, 12, 16, 3, 5, 8), (2, 9, 9, 2, 1, 4),
               (1, 28, 28, 1, 3, 32), (32, 28, 28, 1, 3, 32),
               (1000, 28, 28, 1, 3, 32), (2000, 28, 28, 1, 3, 32),
               (12, 15, 15, 1, 3, 12), (8, 20, 21, 2, 3, 6),
               (5000, 28, 28, 1, 3, 32))
MICRO_BATCHED = dict(max_batch=32, consume_base=0.05,
                     balancer_policy="power_of_two")


def lapper(prefix):
    """-> lap(what), which logs the seconds since the previous lap (the
    first: since this call), under ``prefix``."""
    last = [time.perf_counter()]

    def lap(what):
        now = time.perf_counter()
        log(f"  {prefix} {what}: {now - last[0]:.1f}s")
        last[0] = now
    return lap


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
                 prefix=512, min_start=0):
    """Keys as the engine assembles them: a gathered prefix (null past
    each row's cursor, which is at least ``min_start``) then the chunk,
    per-row cursors, padded lanes."""
    L = prefix + s
    q = torch.randn(b, s, h, hd, generator=gen, device=device)
    k = torch.randn(b, L, kv, hd, generator=gen, device=device)
    v = torch.randn(b, L, kv, hd, generator=gen, device=device)
    kpos = torch.full((b, L), -1, dtype=torch.int32, device=device)
    qpos = torch.zeros(b, s, dtype=torch.int32, device=device)
    for i in range(b):
        start = int(torch.randint(min_start, prefix + 1, (1,),
                                  generator=gen, device=device))
        n = int(torch.randint(1, s + 1, (1,), generator=gen, device=device))
        kpos[i, :start] = torch.arange(start, device=device)
        qpos[i] = start + torch.arange(s, device=device)
        kpos[i, prefix:prefix + n] = qpos[i, :n]
    return q.to(dtype), k.to(dtype), v.to(dtype), kpos, qpos


def slot_decode_case(torch, gen, device, dtype, b=4, lanes=256, h=16, kv=8,
                     hd=128):
    """A slot-engine decode read: each slot's strip of ``lanes`` holds
    positions 0..n-1 (n random, the new token's lane last), the rest -1;
    one query lane per slot at position n-1."""
    q = torch.randn(b, 1, h, hd, generator=gen, device=device)
    k = torch.randn(b, lanes, kv, hd, generator=gen, device=device)
    v = torch.randn(b, lanes, kv, hd, generator=gen, device=device)
    n = torch.randint(1, lanes + 1, (b,), generator=gen, device=device)
    lane = torch.arange(lanes, device=device)
    kpos = torch.where(lane[None] < n[:, None], lane[None], -1).int()
    qpos = (n - 1)[:, None].int()
    return q.to(dtype), k.to(dtype), v.to(dtype), kpos, qpos


def verify_case(torch, gen, device, dtype, chunks=(16, 11), windows=8,
                pad_rows=6, s=16, h=16, kv=8, hd=128, prefix=256, take=5,
                bs=16):
    """The spec engine's fused dispatch: 2 chunk rows, ``windows`` verify
    rows of ``take`` lanes starting mid-block, padding rows of one lane
    over an empty prefix (16 rows, c_pad 16, tables of 16 blocks)."""
    b = len(chunks) + windows + pad_rows
    L = prefix + s
    q = torch.randn(b, s, h, hd, generator=gen, device=device)
    k = torch.randn(b, L, kv, hd, generator=gen, device=device)
    v = torch.randn(b, L, kv, hd, generator=gen, device=device)
    kpos = torch.full((b, L), -1, dtype=torch.int32, device=device)
    qpos = torch.zeros(b, s, dtype=torch.int32, device=device)

    def randint(lo, hi):
        return int(torch.randint(lo, hi, (1,), generator=gen, device=device))

    for i in range(b):
        if i < len(chunks):
            n, start = chunks[i], bs * randint(0, prefix // bs)
        elif i < len(chunks) + windows:
            n, start = take, bs * randint(0, prefix // bs - 1) + \
                randint(1, bs)
        else:
            n, start = 1, 0
        kpos[i, :start] = torch.arange(start, device=device)
        qpos[i] = start + torch.arange(s, device=device)
        kpos[i, prefix:prefix + n] = qpos[i, :n]
    return q.to(dtype), k.to(dtype), v.to(dtype), kpos, qpos


# the draft model's forwards (one row, causal, right-padded to a power of
# two of at least 8): (S, valid tokens).  Phase 4b's drafter runs at S=64,
# 128 and 256 and asserts that every length it ran is listed here; S=40,
# no bucket, holds a tile's ragged edge
DRAFT_SHAPES = ((8, 5), (16, 11), (40, 40), (64, 33), (128, 100),
                (256, 130))


def draft_case(torch, gen, device, dtype, s, valid, h=16, kv=8, hd=128):
    """flash_case at a draft shape: the tail past ``valid`` repeats one
    pad token's projections."""
    def operand(heads):
        a = torch.randn(1, s, heads, hd, generator=gen, device=device)
        if valid < s:
            a[:, valid:] = a[:, valid:valid + 1]
        return a.to(dtype).transpose(1, 2)

    return operand(h), operand(kv), operand(kv)


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
# mamba's selective scan at jamba-1.5-large-398b's width (d_inner 16,384,
# 16 states), (rows, S): decode steps over 1 and 8 rows (the fusion-off
# decode dispatch), a prompt row and a ragged chunk dispatch of 64, and of
# 256 (a whole chunk)
SSM_SHAPES = ((1, 1), (8, 1), (1, 64), (8, 64), (1, 256), (8, 256))
SSM_D_INNER = 16384
# and a long document's whole prompt on the slot engine, one row of 2,048
SSM_TIMED = SSM_SHAPES + ((1, 2048),)
SFU_EX2_PER_CLOCK = 16        # MUFU.EX2 results a clock per SM (Hopper)
# the backward kernels at the shapes training gives them: rwkv6-1.6b at the
# CLI's batch 8 x seq 128 and one row past a 16-step chunk; jamba's mamba
# layer at 8 x 128 (float32 and bf16 x) and at phase 6c's 2 x 2,048 (bf16)
SCAN_BWD_SHAPES = {"rwkv6_scan_bwd": ((8, 128), (1, 300)),
                   "ssm_scan_bwd": ((8, 128, "float32"), (8, 128, "bfloat16"),
                                    (2, 2048, "bfloat16"))}
# the backward kernels against their plain versions: each gradient within
# this many times its max|g| (sums over rows, columns, channels and steps
# in other orders; ex2.approx for exp(dt a)); bf16 dx also 2 bf16 ulps
BWD_GRAD_REL = 1e-4
# paged decode (rows, table width, all-null rows): decode_case's shape and
# the fusion-off engine's (8 rows, cache-max 256 over blocks of 16), both
# split on an H100, and 24 rows (192 CTAs), which the planner leaves whole
PAGED_DECODE_SHAPES = ((8, 32, (5,)), (8, 16, (2,)), (24, 16, (3, 17)))
# the dense and MoE configs' attention heads (query, KV; head_dim 128):
# phi4-mini-3.8b's group of 3 (a bf16 tile holds 21 positions x 3 heads, 63
# of its 64 rows), qwen1.5-110b's (and jamba-1.5-large-398b's) group of 8
# over 64 query heads, dbrx-132b's and grok-1-314b's group of 6 over 48
DENSE_HEADS = {"phi4-mini-3.8b": (24, 8), "qwen1.5-110b": (64, 8),
               "dbrx-132b": (48, 8)}


def ssm_case(torch, gen, device, b, s, di=SSM_D_INNER, n=16):
    """Selective-scan operands as the mamba layer passes them: softplus
    step sizes around 0.3, N(0, 1) projections and inputs, decays
    -exp(N(0, 1)), a start state; float32, contiguous."""
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    dt = F.softplus(randn(b, s, di) * 0.5 - 1.0)
    return (dt, randn(b, s, n), randn(b, s, n), randn(b, s, di),
            -torch.exp(randn(di, n)), randn(b, di, n))


def decode_visible(torch, kpos_pool, bt, pos, window):
    kp = kpos_pool[bt.long()].reshape(bt.shape[0], -1)         # (B, nb*bs)
    p = pos[:, None]
    vis = (kp >= 0) & (kp <= p)
    if window:
        vis &= p - kp < window
    return vis


def pp_tile(q, kv, dtype_name="bfloat16") -> str:
    """The tile a ``paged_prefill`` launch of q (B, S, H, hd) at ``kv``
    heads runs: in bf16 the Hopper tile ("wgmma": more than 16 query rows
    a CTA) or the kWarpKeys mma.sync tile ("mma"); float32 its CUDA-core
    tile ("float32")."""
    from repro_torch.kernels import paged_prefill as pp_mod

    if dtype_name != "bfloat16":
        return "float32"
    return ("mma" if pp_mod.warp_keys_tile(q.shape[1], q.shape[2], kv)
            else "wgmma")


def prefill_visible(torch, kpos, qpos, window):
    kp, qp = kpos[:, None, :], qpos[:, :, None]
    vis = (kp >= 0) & (kp <= qp)
    if window:
        vis &= qp - kp < window
    return vis                                                  # (B,S,L)


# ---------------------------------------------------------------- phases


def kernel_parity(torch, device, ops, ref):
    """Phase 2: paged decode at ``PAGED_DECODE_SHAPES``; prefill at a chunk
    shape (4 rows, S=256), at the fused decode dispatch's (8 rows, S=1),
    at slot decode's (4 slots of 256 lanes, S=1) and at the spec engine's
    verify dispatch (``verify_case``); flash at one prompt row of 37 and
    512 tokens (windows 0 and 64) and 2,048 tokens, non-causal with 37
    queries over 100 keys, and at the draft's ``DRAFT_SHAPES``; the WKV6
    scan at
    rwkv6-1.6b's 32 heads: one prompt row of 37 and 200 tokens and a
    decode step over 4 slots, each also against the scan in float64.
    -> {kernel: max abs error over its bfloat16 cases (``rwkv6_scan``:
    its float32 cases)}."""
    from repro_torch.kernels import attention_split
    from repro_torch.kernels import paged_attention as pa_mod

    gen = torch.Generator(device=device).manual_seed(0)
    # speculative decoding's shapes draw from their own generator, so the
    # other cases keep the inputs of earlier runs
    spec_gen = torch.Generator(device=device).manual_seed(4)
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
                                       (2048, 2048, True, 0),
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
        for s, valid in DRAFT_SHAPES:
            q, k, v = draft_case(torch, spec_gen, device, dtype, s, valid)
            out = ops.flash_attention(q, k, v)[:, :, :valid]
            plain = ref.flash_attention_ref(
                *(t[:, :, :valid] for t in (q, k, v)))
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            torch.testing.assert_close(
                out.float(), plain.float(),
                **KERNEL_TOL["flash_attention", dtype_name])
            log(f"parity flash_attention {dtype_name} draft S={s} "
                f"({valid} valid, the rest padding) against the plain "
                f"version on the {valid} valid rows: max_abs_err={err:.3e}")
            if dtype_name == "bfloat16":
                errs["flash_attention"] = max(errs["flash_attention"], err)
        for window in (0, 64):
            for b, nb, nulls in PAGED_DECODE_SHAPES:
                args = decode_case(torch, gen, device, dtype, b=b, nb=nb,
                                   null_rows=nulls)
                pl = pa_mod.plan(b, args[1].shape[2], nb,
                                 attention_split.sm_count(device))
                out = ops.paged_attention(*args, window=window)
                plain = ref.paged_attention_ref(*args, window=window)
                torch.cuda.synchronize()
                err = (out.float() - plain.float()).abs().max().item()
                torch.testing.assert_close(
                    out.float(), plain.float(),
                    **KERNEL_TOL["paged_attention", dtype_name])
                assert all(torch.all(out[r] == 0) for r in nulls), \
                    "all-null rows must be zeros"
                log(f"parity paged_attention {dtype_name} {b} rows x {nb} "
                    f"blocks window={window}: max_abs_err={err:.3e} "
                    f"(split={pl.split}, {pl.ctas(b, args[1].shape[2])} "
                    "CTAs)")
                if dtype_name == "bfloat16":
                    errs["paged_attention"] = max(errs["paged_attention"],
                                                  err)

            for b, s in ((4, 256), (8, 1), ("slot", 1), ("verify", 16)):
                if b == "slot":
                    b, args = 4, slot_decode_case(torch, gen, device, dtype)
                elif b == "verify":
                    b, args = 16, verify_case(torch, spec_gen, device, dtype)
                else:
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
                    f"L={args[1].shape[1]} window={window} tile="
                    f"{pp_tile(args[0], args[1].shape[2], dtype_name)}: "
                    f"max_abs_err={err:.3e} "
                    f"({int(lanes.sum())} visible lanes)")
                if dtype_name == "bfloat16":
                    errs["paged_prefill"] = max(errs["paged_prefill"], err)
    return errs


def dense_head_parity(torch, device, ops, ref):
    """Phase 2, the dense configs' heads (``DENSE_HEADS``) in bfloat16 at
    the engines' shapes: ``paged_prefill`` at a fused decode dispatch (8
    rows, S=1, 512 prefix lanes) and at a 256-token chunk (4 rows),
    ``paged_attention`` over the fusion-off engine's tables of 16 blocks
    (8 rows, one all-null), ``flash_attention`` at one causal row of
    S=512.  -> {kernel: max abs error}."""
    gen = torch.Generator(device=device).manual_seed(7)
    dt = torch.bfloat16
    errs = dict.fromkeys(("paged_attention", "paged_prefill",
                          "flash_attention"), 0.0)

    def check(kernel, what, out, plain):
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        torch.testing.assert_close(out.float(), plain.float(),
                                   **KERNEL_TOL[kernel, "bfloat16"])
        log(f"parity {kernel} bfloat16 {what}: max_abs_err={err:.3e}")
        errs[kernel] = max(errs[kernel], err)

    for arch, (h, kv) in DENSE_HEADS.items():
        heads = f"{arch} heads ({h}/{kv})"
        for b, s in ((8, 1), (4, 256)):
            args = prefill_case(torch, gen, device, dt, b=b, s=s, h=h, kv=kv)
            lanes = prefill_visible(torch, args[3], args[4], 0).any(-1)
            check("paged_prefill", f"{heads} {b} rows S={s} L={s + 512} "
                  f"tile={pp_tile(args[0], kv)}",
                  ops.paged_prefill(*args)[lanes],
                  ref.paged_prefill_ref(*args)[lanes])
        args = decode_case(torch, gen, device, dt, b=8, h=h, kv=kv, nb=16,
                           null_rows=(2,))
        out = ops.paged_attention(*args)
        assert torch.all(out[2] == 0), "all-null rows must be zeros"
        check("paged_attention", f"{heads} 8 rows x 16 blocks", out,
              ref.paged_attention_ref(*args))
        q, k, v = flash_case(torch, gen, device, dt, h=h, kv=kv, sq=512)
        check("flash_attention", f"{heads} Sq=Sk=512 causal",
              ops.flash_attention(q, k, v),
              ref.flash_attention_ref(q, k, v))
    return errs


# whisper-tiny's and paligemma-3b's attention shapes (phases 2 and 7):
# flash_attention (B, H, KV, Sq, Sk, hd, causal, prefix): the encoder's
# non-causal 1,500 frames, the cross-attention at a decode step of the
# 8-row batch and at a 200-token prompt's prefill, paligemma's prefix-LM
# over its 256 patches and a 200-token prompt, and a prefix of 200 (not a
# multiple of the 64-key tile); paged_prefill's slot decode (B, H, KV, hd,
# lanes) of the 8-row batch at both configs' heads, strips of the longest
# smoke prompt plus 16 tokens (and paligemma's 256 patches)
FRONTEND_FA_SHAPES = {
    "encoder": (1, 6, 6, 1500, 1500, 64, False, 0),
    "cross_decode": (8, 6, 6, 1, 1500, 64, False, 0),
    "cross_prefill": (1, 6, 6, 200, 1500, 64, False, 0),
    "prefix_256": (1, 8, 1, 456, 456, 256, True, 256),
    "prefix_200": (1, 8, 1, 456, 456, 256, True, 200),
}
FRONTEND_PP_SHAPES = {"whisper_slot": (8, 6, 6, 64, 216),
                      "paligemma_slot": (8, 8, 1, 256, 472)}


def frontend_fa_case(torch, gen, device, dtype, shape):
    b, h, kv, sq, sk, hd, _, _ = shape
    return flash_case(torch, gen, device, dtype, b=b, h=h, kv=kv, hd=hd,
                      sq=sq, sk=sk)


def frontend_pp_case(torch, gen, device, dtype, shape):
    b, h, kv, hd, lanes = shape
    return slot_decode_case(torch, gen, device, dtype, b=b, lanes=lanes, h=h,
                            kv=kv, hd=hd)


def frontend_kernel_parity(torch, device, ops, ref):
    """Phase 2, whisper-tiny's and paligemma-3b's shapes
    (``FRONTEND_FA_SHAPES``, ``FRONTEND_PP_SHAPES``) in bfloat16 and
    float32, in the model's layouts.  -> {kernel: max abs error over the
    bfloat16 cases}."""
    gen = torch.Generator(device=device).manual_seed(11)
    errs = {"flash_attention": 0.0, "paged_prefill": 0.0}
    for dtype_name in ("bfloat16", "float32"):
        dtype = getattr(torch, dtype_name)
        for name, shape in FRONTEND_FA_SHAPES.items():
            causal, prefix = shape[6:]
            q, k, v = frontend_fa_case(torch, gen, device, dtype, shape)
            out = ops.flash_attention(q, k, v, causal=causal, prefix=prefix)
            plain = ref.flash_attention_ref(q, k, v, causal=causal,
                                            prefix=prefix)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            torch.testing.assert_close(
                out.float(), plain.float(),
                **KERNEL_TOL["flash_attention", dtype_name])
            log(f"parity flash_attention {dtype_name} {name} {shape[:6]} "
                f"causal={causal} prefix={prefix}: max_abs_err={err:.3e}")
            if dtype_name == "bfloat16":
                errs["flash_attention"] = max(errs["flash_attention"], err)
        for name, shape in FRONTEND_PP_SHAPES.items():
            args = frontend_pp_case(torch, gen, device, dtype, shape)
            out = ops.paged_prefill(*args)
            plain = ref.paged_prefill_ref(*args)
            torch.cuda.synchronize()
            err = (out.float() - plain.float()).abs().max().item()
            torch.testing.assert_close(
                out.float(), plain.float(),
                **KERNEL_TOL["paged_prefill", dtype_name])
            log(f"parity paged_prefill {dtype_name} {name} {shape} tile="
                f"{pp_tile(args[0], args[1].shape[2], dtype_name)}: "
                f"max_abs_err={err:.3e}")
            if dtype_name == "bfloat16":
                errs["paged_prefill"] = max(errs["paged_prefill"], err)
    return errs


# the int8 KV cache's kernels (phase 2): the prefix lengths of the
# ragged prefill's int8 segment beside phase 2's 512, one not a multiple
# of 64 (31 blocks of 16), and slot strips of 256 and 200 lanes
INT8_PREFIXES = (512, 496)
INT8_SLOT_LANES = (256, 200)


def int8_decode_args(args):
    """paged_attention operands (q, k, v pools, kpos, table, pos) -> the
    int8 entry's: the pools quantized as the model writes them."""
    from repro_torch.models.attention import _quantize_kv

    q, k, v, kp, bt, pos = args
    (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
    return q, k8, v8, ks, vs, kp, bt, pos


def int8_prefill_args(args, lp):
    """paged_prefill operands (q, k, v, kpos, qpos) -> the int8 entry's:
    the first ``lp`` key lanes an int8 prefix (quantized as the model
    writes the pool), the rest the chunk in the model dtype."""
    from repro_torch.models.attention import _quantize_kv

    q, k, v, kpos, qpos = args
    (k8, ks), (v8, vs) = _quantize_kv(k[:, :lp]), _quantize_kv(v[:, :lp])
    return (q, k8, v8, ks, vs, kpos[:, :lp].contiguous(),
            k[:, lp:].contiguous(), v[:, lp:].contiguous(),
            kpos[:, lp:].contiguous(), qpos)


def dequantized_args(torch, ref, args):
    """An int8 entry's operands -> the float entry's over the same keys,
    dequantized to q's dtype (and, for the prefill, put before the
    chunk), what the int8 launch must equal bit for bit."""
    if len(args) == 8:
        q, k8, v8, ks, vs, kp, bt, pos = args
        return (q, ref.dequantize_kv(k8, ks, q.dtype),
                ref.dequantize_kv(v8, vs, q.dtype), kp, bt, pos)
    q, k8, v8, ks, vs, kpp, k, v, kpc, qpos = args
    return (q, torch.cat([ref.dequantize_kv(k8, ks, q.dtype), k], 1),
            torch.cat([ref.dequantize_kv(v8, vs, q.dtype), v], 1),
            torch.cat([kpp, kpc], 1), qpos)


def pool_case(torch, gen, device, case, prefix, bs=16, int8=False):
    """An assembled case (``prefill_case`` or ``verify_case``: each row's
    ``prefix`` prefix lanes, then its chunk) laid into a block pool of
    ``bs`` lanes as the paged engine holds it: each row's blocks below
    its cursor at random pool blocks (block 0 the null block), its table
    null past them; the lanes at or past the cursor in the block holding
    it keep their lane's position, as a copy-on-write donor's tail does,
    for the cursor guard to hide.  ``int8``: the pool quantized as the
    model writes it.  -> (q, pool leaves (k, v; int8: k, v, k_s, v_s),
    pos_pool, block_table, cursors (B,), the chunk's k, v, kpos, qpos),
    the ``paged_prefill_pool[_int8]`` operands: what they read through
    the table is the case's prefix wherever a query sees it."""
    from repro_torch.models.attention import _quantize_kv

    q, k, v, kpos, qpos = case
    b, nb = q.shape[0], prefix // bs
    kv, hd = k.shape[2], k.shape[3]
    starts = (kpos[:, :prefix] >= 0).sum(1).int()
    n_pool = 1 + b * nb
    k_pool, v_pool = (torch.randn(n_pool, bs, kv, hd, generator=gen,
                                  device=device).to(k.dtype)
                      for _ in range(2))
    pos_pool = torch.full((n_pool, bs), -1, dtype=torch.int32, device=device)
    bt = torch.zeros(b, nb, dtype=torch.int32, device=device)
    perm = torch.randperm(n_pool - 1, generator=gen, device=device) + 1
    lanes = torch.arange(prefix, dtype=torch.int32,
                         device=device).reshape(nb, bs)
    for i, start in enumerate(starts.tolist()):
        used = -(-start // bs)
        blocks = perm[i * nb:i * nb + used]
        bt[i, :used] = blocks.int()
        k_pool[blocks] = k[i, :used * bs].reshape(used, bs, kv, hd)
        v_pool[blocks] = v[i, :used * bs].reshape(used, bs, kv, hd)
        pos_pool[blocks] = lanes[:used]
    leaves = (k_pool, v_pool)
    if int8:
        (k8, ks), (v8, vs) = _quantize_kv(k_pool), _quantize_kv(v_pool)
        leaves = (k8, v8, ks, vs)
    return (q, leaves, pos_pool, bt, starts,
            *(t[:, prefix:].contiguous() for t in (k, v, kpos)), qpos)


def pool_call(ops, pc, window=0):
    """The pool entry's launch on ``pool_case``'s operands."""
    q, leaves, pos_pool, bt, starts, k, v, kpos, qpos = pc
    fn = ops.paged_prefill_pool_int8 if len(leaves) == 4 \
        else ops.paged_prefill_pool
    return fn(q, *leaves, pos_pool, bt, starts, k, v, kpos, qpos,
              window=window)


def pool_gathered(ref, pc):
    """The prefix as the parent's ``attn_prefill_paged`` assembled it:
    each pool leaf gathered through the table, the positions guarded at
    the cursors.  -> (leaves (B, nb*bs, ...), guarded positions)."""
    leaves, pos_pool, bt, starts = pc[1:5]
    return (tuple(ref.gather_prefix(t, bt) for t in leaves),
            ref.guarded_positions(pos_pool, bt, starts))


def composed_call(torch, ops, ref, pc, window=0):
    """The parent's composed path: the gather and the cursor guard, then,
    over a float pool, the concatenation with the chunk and
    ``paged_prefill``, over an int8 pool ``paged_prefill_int8``."""
    q, k, v, kpos, qpos = pc[0], *pc[5:]
    (pk, pv, *scales), ppos = pool_gathered(ref, pc)
    if scales:
        return ops.paged_prefill_int8(q, pk, pv, *scales, ppos, k, v, kpos,
                                      qpos, window=window)
    return ops.paged_prefill(q, torch.cat([pk, k], 1), torch.cat([pv, v], 1),
                             torch.cat([ppos, kpos], 1), qpos, window=window)


def pool_keys(torch, ref, pc):
    """The keys a pool launch reads, assembled in q's dtype (an int8
    prefix dequantized): (k, v, kpos) over the prefix and the chunk."""
    q, k, v, kpos = pc[0], *pc[5:8]
    (pk, pv, *scales), ppos = pool_gathered(ref, pc)
    if scales:
        pk = ref.dequantize_kv(pk, scales[0], q.dtype)
        pv = ref.dequantize_kv(pv, scales[1], q.dtype)
    return (torch.cat([pk, k], 1), torch.cat([pv, v], 1),
            torch.cat([ppos, kpos], 1))


def pool_plain(ref, pc, window=0):
    q, leaves, pos_pool, bt, starts, k, v, kpos, qpos = pc
    fn = ref.paged_prefill_pool_int8_ref if len(leaves) == 4 \
        else ref.paged_prefill_pool_ref
    return fn(q, *leaves, pos_pool, bt, starts, k, v, kpos, qpos,
              window=window)


POOL_BLOCK_SIZES = (16, 4, 1)


def pool_kernel_parity(torch, device, ops, ref):
    """Phase 2, the pool entries (``paged_prefill_pool`` and
    ``paged_prefill_pool_int8``, the paged engine's attention): at the
    chunk (4 rows, S=256, 512 prefix lanes), the fused decode dispatch (8
    rows, S=1) and the spec verify dispatch (16 rows, S=16, 256 prefix
    lanes) of qwen3-0.6b's heads, the prefix in pool blocks of 16 (the
    engine's), 4 and 1 lanes, bfloat16 and float32, windows 0 and 64;
    then in bfloat16 at the dense configs' heads and, both dtypes, at
    gemma3-4b's head_dim 256 (windows 0 and 1,024), blocks of 16.  Each
    launch within ``KERNEL_TOL`` of its plain version on the lanes that
    see a key, and equal, bit for bit, to the contiguous entry's launch
    over the keys gathered through the table, guarded at the cursors and
    concatenated with the chunk (the parent's composed path).  -> {kernel:
    max abs error over its bfloat16 cases}."""
    gen = torch.Generator(device=device).manual_seed(23)
    errs = {"paged_prefill_pool": 0.0, "paged_prefill_pool_int8": 0.0}
    n_checked = 0

    def check(dtype_name, what, case, prefix, bs, window):
        nonlocal n_checked
        for int8 in (False, True):
            pc = pool_case(torch, gen, device, case, prefix, bs, int8)
            kernel = "paged_prefill_pool_int8" if int8 \
                else "paged_prefill_pool"
            out = pool_call(ops, pc, window)
            composed = composed_call(torch, ops, ref, pc, window)
            plain = pool_plain(ref, pc, window)
            torch.cuda.synchronize()
            kpos = pool_keys(torch, ref, pc)[2]
            lanes = prefill_visible(torch, kpos, pc[-1], window).any(-1)
            assert lanes.any()
            err = (out[lanes].float() - plain[lanes].float()).abs().max()
            err = err.item()
            torch.testing.assert_close(
                out[lanes].float(), plain[lanes].float(),
                **KERNEL_TOL["paged_prefill", dtype_name])
            assert torch.equal(out, composed), \
                f"{kernel} {what}: not bit-equal to the composed path"
            n_checked += 1
            log(f"parity {kernel} {dtype_name} {what}, blocks of {bs} "
                f"window={window} tile="
                f"{pp_tile(pc[0], pc[5].shape[2], dtype_name)}: "
                f"max_abs_err={err:.3e}, bit-equal to the gather + guard + "
                "concat + contiguous entry")
            if dtype_name == "bfloat16":
                errs[kernel] = max(errs[kernel], err)

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for window in (0, 64):
            for bs in POOL_BLOCK_SIZES:
                check(dtype_name, "4 rows S=256 prefix 512",
                      prefill_case(torch, gen, device, dt), 512, bs, window)
                check(dtype_name, "fused decode 8 rows S=1 prefix 512",
                      prefill_case(torch, gen, device, dt, b=8, s=1), 512,
                      bs, window)
                check(dtype_name, "spec verify 16 rows S=16 prefix 256",
                      verify_case(torch, gen, device, dt), 256, bs, window)
    for arch, (h, kv) in DENSE_HEADS.items():
        for b, s in ((8, 1), (4, 256)):
            check("bfloat16", f"{arch} heads ({h}/{kv}) {b} rows S={s}",
                  prefill_case(torch, gen, device, torch.bfloat16, b=b, s=s,
                               h=h, kv=kv), 512, 16, 0)
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for window in (0, GEMMA3_WINDOW):
            for what, kw in GEMMA3_PP_SHAPES:
                check(dtype_name, f"head_dim 256 {what}",
                      prefill_case(torch, gen, device, dt, **kw,
                                   **GEMMA3_HEADS),
                      kw.get("prefix", 512), 16, window)
    log(f"parity pool entries: {n_checked} launches, each bit-equal to the "
        "composed path")
    return errs


def int8_kernel_parity(torch, device, ops, ref):
    """Phase 2, the int8 KV cache's variants: ``paged_attention_int8`` at
    ``PAGED_DECODE_SHAPES`` and ``paged_prefill_int8`` at the chunk (int8
    prefixes of ``INT8_PREFIXES`` lanes), fused decode, slot decode
    (``INT8_SLOT_LANES``, no chunk keys) and verify shapes, bfloat16 and
    float32, windows 0 and 64; then in bfloat16 at the dense configs'
    heads (``DENSE_HEADS``) and at gemma3-4b's head_dim 256 in both dtypes,
    windows 0 and 1,024.  Each launch within ``KERNEL_TOL`` of its int8
    plain version (valid lanes), and equal, bit for bit, to the float
    kernel's launch on the dequantized keys.  -> {kernel: max abs error
    over its bfloat16 cases}."""
    gen = torch.Generator(device=device).manual_seed(21)
    errs = {"paged_attention_int8": 0.0, "paged_prefill_int8": 0.0}

    def check(kernel, dtype_name, what, args, window, nulls=()):
        base = kernel[:-len("_int8")]
        out = getattr(ops, kernel)(*args, window=window)
        plain = getattr(ref, f"{kernel}_ref")(*args, window=window)
        dense = getattr(ops, base)(*dequantized_args(torch, ref, args),
                                   window=window)
        torch.cuda.synchronize()
        if base == "paged_prefill":
            kpos = torch.cat([args[5], args[8]], 1)
            lanes = prefill_visible(torch, kpos, args[9], window).any(-1)
            assert lanes.any()
            o, pl_ = out[lanes], plain[lanes]
        else:
            o, pl_ = out, plain
        err = (o.float() - pl_.float()).abs().max().item()
        torch.testing.assert_close(o.float(), pl_.float(),
                                   **KERNEL_TOL[base, dtype_name])
        assert torch.equal(out, dense), \
            f"{kernel} {what}: not bit-equal to {base} on dequantized keys"
        assert all(torch.all(out[r] == 0) for r in nulls), \
            "all-null rows must be zeros"
        tile = (f" tile={pp_tile(args[0], args[6].shape[2], dtype_name)}"
                if base == "paged_prefill" else "")
        log(f"parity {kernel} {dtype_name} {what} window={window}{tile}: "
            f"max_abs_err={err:.3e}, bit-equal to {base} on the "
            "dequantized keys")
        if dtype_name == "bfloat16":
            errs[kernel] = max(errs[kernel], err)

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for window in (0, 64):
            for b, nb, nulls in PAGED_DECODE_SHAPES:
                args = decode_case(torch, gen, device, dt, b=b, nb=nb,
                                   null_rows=nulls)
                check("paged_attention_int8", dtype_name,
                      f"{b} rows x {nb} blocks", int8_decode_args(args),
                      window, nulls)
            for lp in INT8_PREFIXES:
                args = prefill_case(torch, gen, device, dt, prefix=lp)
                check("paged_prefill_int8", dtype_name,
                      f"4 rows S=256 int8 prefix {lp}",
                      int8_prefill_args(args, lp), window)
            args = prefill_case(torch, gen, device, dt, b=8, s=1)
            check("paged_prefill_int8", dtype_name,
                  "fused decode 8 rows S=1 int8 prefix 512",
                  int8_prefill_args(args, 512), window)
            for lanes in INT8_SLOT_LANES:
                args = slot_decode_case(torch, gen, device, dt, lanes=lanes)
                check("paged_prefill_int8", dtype_name,
                      f"slot decode 4 slots of {lanes} int8 lanes",
                      int8_prefill_args(args, lanes), window)
            args = verify_case(torch, gen, device, dt)
            check("paged_prefill_int8", dtype_name,
                  "spec verify 16 rows S=16 int8 prefix 256",
                  int8_prefill_args(args, 256), window)
    dt = torch.bfloat16
    for arch, (h, kv) in DENSE_HEADS.items():
        heads = f"{arch} heads ({h}/{kv})"
        for b, s in ((8, 1), (4, 256)):
            args = prefill_case(torch, gen, device, dt, b=b, s=s, h=h, kv=kv)
            check("paged_prefill_int8", "bfloat16",
                  f"{heads} {b} rows S={s} int8 prefix 512",
                  int8_prefill_args(args, 512), 0)
        args = decode_case(torch, gen, device, dt, b=8, h=h, kv=kv, nb=16,
                           null_rows=(2,))
        check("paged_attention_int8", "bfloat16", f"{heads} 8 rows x 16 "
              "blocks", int8_decode_args(args), 0, (2,))
    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for window in (0, GEMMA3_WINDOW):
            for what, kw in GEMMA3_PP_SHAPES:
                args = prefill_case(torch, gen, device, dt, **kw,
                                    **GEMMA3_HEADS)
                lp = kw.get("prefix", 512)
                check("paged_prefill_int8", dtype_name,
                      f"head_dim 256 {what} int8 prefix {lp}",
                      int8_prefill_args(args, lp), window)
            for nb, nulls in GEMMA3_PA_SHAPES:
                args = decode_case(torch, gen, device, dt, nb=nb,
                                   null_rows=nulls, **GEMMA3_HEADS)
                check("paged_attention_int8", dtype_name,
                      f"head_dim 256 8 rows x {nb} blocks",
                      int8_decode_args(args), window, nulls)
    return errs


def ssm_parity(torch, device, ops, ref) -> float:
    """Phase 2, mamba's selective scan at ``SSM_TIMED`` (``SSM_SHAPES``
    and one row of 2,048), x and y in float32 and in bf16, plain and
    with ``dt`` 0 past per-row lengths (the masked route): kernel against
    its plain version within ``KERNEL_TOL``, both beside the scan in
    float64; a masked row's final state equals, bit for bit, the
    kernel's state after its valid lanes; and a chunk of 8 rows of 256
    in bf16 cut into calls of 100 and 156 steps, the state carried,
    gives one call's bits.  -> max abs error."""
    gen = torch.Generator(device=device).manual_seed(8)
    worst = 0.0
    for b, s in SSM_TIMED:
        for masked in (False, True):
            args = list(ssm_case(torch, gen, device, b, s))
            lens = torch.randint(1, s + 1, (b,), generator=gen,
                                 device=device)
            if masked:
                lanes = torch.arange(s, device=device)[None, :]
                args[0] = torch.where((lanes < lens[:, None])[..., None],
                                      args[0], 0.0)
            for name, xdt in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
                args[3] = args[3].to(xdt)
                y, h = ops.ssm_scan(*args)
                plain_y, plain_h = ref.ssm_scan_ref(*args)
                torch.cuda.synchronize()
                assert y.dtype == xdt and h.dtype == torch.float32
                torch.testing.assert_close(
                    y.float(), plain_y.float(),
                    **KERNEL_TOL["ssm_scan", name])
                torch.testing.assert_close(
                    h, plain_h, **KERNEL_TOL["ssm_scan", "float32"])
                err = max((y.float() - plain_y.float()).abs().max().item(),
                          (h - plain_h).abs().max().item())
                exact_y, exact_h = ref.ssm_scan_ref(
                    *(t.double() for t in args))
                log(f"parity ssm_scan {name} x {b} rows S={s} d_inner "
                    f"{SSM_D_INNER}{' masked' if masked else ''}: "
                    f"max_abs_err={err:.3e} (max |y| "
                    f"{plain_y.float().abs().max().item():.1f}, |h| "
                    f"{plain_h.abs().max().item():.1f}); against the "
                    f"float64 scan: kernel "
                    f"{max((y - exact_y).abs().max().item(), (h - exact_h).abs().max().item()):.3e}, "
                    f"plain "
                    f"{max((plain_y - exact_y).abs().max().item(), (plain_h - exact_h).abs().max().item()):.3e}")
                worst = max(worst, err)
                if masked:
                    n = int(lens[0])
                    _, h0 = ops.ssm_scan(*(t[:1, :n].contiguous()
                                           for t in args[:4]), args[4],
                                         args[5][:1].contiguous())
                    assert torch.equal(h[:1], h0), \
                        "masked lanes moved the state"
    args = list(ssm_case(torch, gen, device, 8, 256))
    args[3] = args[3].bfloat16()
    y, h = ops.ssm_scan(*args)
    y1, h1 = ops.ssm_scan(*(t[:, :100].contiguous() for t in args[:4]),
                          args[4], args[5])
    y2, h2 = ops.ssm_scan(*(t[:, 100:].contiguous() for t in args[:4]),
                          args[4], h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h), \
        "a chunk cut into calls changed the bits"
    log("parity ssm_scan bf16 x 8 rows S=256 cut at 100 / 156, state "
        "carried: y and the state bit-equal to one call")
    return worst


def _bwd_err(torch, name, got, want, bf16=False) -> float:
    """Assert one gradient within ``BWD_GRAD_REL`` x its max|plain| (a
    bf16 one within 2 bf16 ulps of the plain value plus that floor) ->
    its max abs error."""
    g, w = got.float(), want.float()
    floor = BWD_GRAD_REL * w.abs().max().item()
    slack = floor
    if bf16:
        slack = floor + 2 * torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(1e-30))) - 7)
    err = (g - w).abs()
    assert bool((err <= slack).all()), (name, err.max().item(), floor)
    return err.max().item()


def scan_backward_parity(torch, device, ops, ref) -> dict:
    """Phase 2, the two backward kernels at their training shapes
    (``SCAN_BWD_SHAPES``) with a start state and a final-state gradient
    (``ssm_scan_bwd`` from the training forward's checkpoints): every
    gradient against the plain backward within ``BWD_GRAD_REL`` x its
    max|g| (bf16 dx within 2 ulps), a second launch bit-identical.
    -> {kernel: max abs error}."""
    from repro_torch.kernels import rwkv6_scan_bwd as rwb
    from repro_torch.kernels import ssm_scan as ss
    from repro_torch.kernels import ssm_scan_bwd as ssb

    gen = torch.Generator(device=device).manual_seed(12)
    errs = {"rwkv6_scan_bwd": 0.0, "ssm_scan_bwd": 0.0}
    for b, s in SCAN_BWD_SHAPES["rwkv6_scan_bwd"]:
        args = list(rwkv_case(torch, gen, device, b=b, s=s))
        dout = torch.randn(b, s, 32, 64, generator=gen,
                           device=device).transpose(1, 2)
        dsf = torch.randn(args[5].shape, generator=gen, device=device)
        got = rwb.rwkv6_scan_bwd(*args, dout, dsf)
        again = rwb.rwkv6_scan_bwd(*args, dout, dsf)
        want = ref.rwkv6_scan_bwd_ref(*args, dout, dsf)
        torch.cuda.synchronize()
        worst = 0.0
        for name, g, a, w in zip(("dr", "dk", "dv", "dw", "du", "ds0"), got,
                                 again, want):
            assert torch.equal(g, a), f"rwkv6_scan_bwd {name}: a repeat " \
                "launch changed the bits"
            worst = max(worst, _bwd_err(torch, name, g, w))
        log(f"parity rwkv6_scan_bwd float32 {b} rows S={s} (32 heads of "
            f"64): max_abs_err={worst:.3e} over dr, dk, dv, dw, du, ds0 "
            f"(max |du| {want[4].abs().max().item():.1f}); repeat "
            "bit-identical")
        errs["rwkv6_scan_bwd"] = max(errs["rwkv6_scan_bwd"], worst)
    for b, s, xdt in SCAN_BWD_SHAPES["ssm_scan_bwd"]:
        args = list(ssm_case(torch, gen, device, b, s))
        args[3] = args[3].to(getattr(torch, xdt))
        dy = torch.randn(b, s, SSM_D_INNER, generator=gen,
                         device=device).to(args[3].dtype)
        dhf = torch.randn(args[5].shape, generator=gen, device=device)
        ck = ss.ssm_scan(*args, checkpoints=True)[2]     # the forward's
        got = ssb.ssm_scan_bwd(*args, dy, dhf, ckpt=ck)
        again = ssb.ssm_scan_bwd(*args, dy, dhf, ckpt=ck)
        want = ref.ssm_scan_bwd_ref(*args, dy, dhf)
        torch.cuda.synchronize()
        worst = 0.0
        for name, g, a, w in zip(("ddt", "dbm", "dcm", "dx", "da", "dh0"),
                                 got, again, want):
            assert torch.equal(g, a), f"ssm_scan_bwd {name}: a repeat " \
                "launch changed the bits"
            worst = max(worst, _bwd_err(torch, name, g, w,
                                        bf16=name == "dx"
                                        and xdt == "bfloat16"))
        log(f"parity ssm_scan_bwd {xdt} x {b} rows S={s} d_inner "
            f"{SSM_D_INNER}: max_abs_err={worst:.3e} over ddt, dbm, dcm, "
            f"dx, da, dh0 (max |dbm| {want[1].abs().max().item():.1f}); "
            "repeat bit-identical")
        errs["ssm_scan_bwd"] = max(errs["ssm_scan_bwd"], worst)
    return errs


def plain_ops(ops, ref):
    """Route the models' kernels to the plain versions for one comparison
    run (patching the ops module the models call through)."""
    return mock.patch.multiple(ops, paged_attention=ref.paged_attention_ref,
                               paged_prefill=ref.paged_prefill_ref,
                               paged_attention_int8=(
                                   ref.paged_attention_int8_ref),
                               paged_prefill_int8=ref.paged_prefill_int8_ref,
                               flash_attention=ref.flash_attention_ref,
                               rwkv6_scan=ref.rwkv6_scan_ref,
                               ssm_scan=ref.ssm_scan_ref,
                               conv2d=ref.conv2d_ref,
                               conv2d_wgrad=ref.conv2d_wgrad_ref)


class _Both:
    """Two context managers entered as one, as often as asked."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def __enter__(self):
        self.first.__enter__()
        self.second.__enter__()

    def __exit__(self, *exc):
        self.second.__exit__(*exc)
        self.first.__exit__(*exc)


class PinnedRouting:
    """Two arms for ``model_parity`` and ``slot_model_parity`` that take
    the same experts.  ``plain`` runs the plain versions and records each
    MoE router's choice (``moe.route``: probabilities, gates, expert
    ids); ``kernel`` runs the kernels and takes the recorded choices back
    in call order instead of its own router's.  Where a token's top k is
    a near tie, any rounding-level difference upstream (a scan's
    exponential or sum order) picks another expert and moves its logits
    by a whole expert's output; with the choice held, what is left is the
    kernels' own difference.  Run ``plain`` before ``kernel``; ``seen``
    is empty again after a matched pair of runs."""

    def __init__(self, ops, ref):
        from repro_torch.models import moe

        self.seen = []
        real = moe.route

        def record(p, cfg, x):
            out = real(p, cfg, x)
            self.seen.append(out)
            return out

        def replay(p, cfg, x):
            assert self.seen, "the kernel arm routed more than the plain"
            out = self.seen.pop(0)
            assert out[2].shape[:2] == x.shape[:2], (out[2].shape, x.shape)
            return out

        self.plain = _Both(plain_ops(ops, ref),
                           mock.patch.object(moe, "route", record))
        self.kernel = mock.patch.object(moe, "route", replay)


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def model_parity(torch, device, model, params, ops, ref, ragged_dispatch,
                 arms=None):
    """Phase 3, paged path: one ragged prefill dispatch (per-row cursors
    past a cached prefix) and one decode step, kernels vs plain versions
    on identical pools (``arms``: the ("kernel", ctx) and ("plain", ctx)
    runs in the order given).  -> {"prefill": rel_err, "decode":
    rel_err}."""
    arms = arms or (("kernel", contextlib.nullcontext()),
                    ("plain", plain_ops(ops, ref)))
    cfg = model.cfg
    bs, rows = 16, 4
    prefix_lens = [48, 112, 0, 200]
    chunk_lens = [64, 16, 96, 1]
    nb = -(-max(p + c + 1 for p, c in zip(prefix_lens, chunk_lens)) // bs)
    # recurrent layers: row i's state in slot i (a spare last slot)
    pools = model.pool_init(rows * nb + 1, bs, state_batch=rows + 1)
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
    for name, ctx in arms:
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
    for name, ctx in arms:
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


def float64_ssm_scan(ref):
    """The selective scan's plain version in float64, y returned in x's
    dtype and the state in float32: the scan without float32 rounding
    of its own."""
    def scan(dt, bm, cm, x, a, h0):
        y, h = ref.ssm_scan_ref(*(t.double() for t in (dt, bm, cm, x, a,
                                                       h0)))
        return y.to(x.dtype), h.float()

    return scan


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


# phase 4's two engine profiles: the smoke prompts, 8 new tokens each
# (the engine runs take 16; the profiler's fold-up grows with the run)
PROFILE_NEW = 8
SERVE_ARGV = ["--arch", "qwen3-0.6b", "--no-reduced", "--num-blocks", "32",
              "--block-size", "16", "--cache-max", "256", "--max-new", "16",
              "--prefix-cache", "on"]
SLOT_ARGV = ["--arch", "qwen3-0.6b", "--no-reduced", "--engine", "slot",
             "--slots", "4", "--cache-max", "256", "--max-new", "16"]


RWKV_ARGV = ["--arch", "rwkv6-1.6b", "--no-reduced", "--engine", "slot",
             "--slots", "4", "--cache-max", "256", "--max-new", "16"]


def prefill_launches(counts, int8=False) -> int:
    """Launches of the ragged prefill, both entries: a paged engine's
    dispatches launch the pool entry (its attention reads the pool
    through the table), the slot engine's decode steps the contiguous
    one; the sum is what the one entry counted before the pool entries."""
    tag = "_int8" if int8 else ""
    return counts[f"paged_prefill{tag}"] + counts[f"paged_prefill_pool{tag}"]


def run_engine(engine, prompts, max_new, sync, stats=None,
               after_step=None):
    """Submit every prompt, drain; -> ({rid: tokens}, seconds).  A
    ``stats`` dict receives the number of engine steps; ``after_step``
    is called after each step."""
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
        if after_step is not None:
            after_step()
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


def rwkv_masked_parity(torch, device, model, params, ops, ref):
    """One ragged paged dispatch of 4 rows right-padded to 64 lanes (64,
    17, 1 and 40 valid), recorded on the plain path: on each layer's own
    masked scan inputs (decay 1, key 0 past a row's length) the kernel's
    final states equal the plain scan's within ``KERNEL_TOL``, and each
    row's equals, bit for bit, the kernel's state after its valid lanes
    alone."""
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(5)
    lens = [64, 17, 1, 40]
    toks = torch.randint(1, cfg.vocab_size, (4, 64), generator=gen,
                         device=device, dtype=torch.int32)
    i32 = functools.partial(torch.tensor, dtype=torch.int32, device=device)
    calls = []

    def record(*args):
        calls.append(args)
        return ref.rwkv6_scan_ref(*args)

    pools = model.pool_init(2, 16, state_batch=5)
    with mock.patch.object(ops, "rwkv6_scan", record):
        model.prefill_paged(params, {"tokens": toks}, pools,
                            torch.zeros(4, 1, dtype=torch.int32,
                                        device=device),
                            i32([0] * 4), seq_len=i32(lens))
    worst = 0.0
    for args in calls:
        _, sf = ops.rwkv6_scan(*args)
        _, plain_sf = ref.rwkv6_scan_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(sf, plain_sf,
                                   **KERNEL_TOL["rwkv6_scan", "float32"])
        worst = max(worst, (sf - plain_sf).abs().max().item())
        for i, n in enumerate(lens):
            _, cut = ops.rwkv6_scan(*(t[i:i + 1, :, :n] for t in args[:4]),
                                    args[4], args[5][i:i + 1])
            assert torch.equal(sf[i:i + 1], cut), "masked lanes moved S"
    log(f"parity rwkv6_scan masked ragged dispatch ({cfg.dtype}, rows of "
        f"{lens} valid lanes padded to 64) on the {len(calls)} layers' own "
        f"inputs: final states max_abs_err={worst:.3e} against the plain "
        f"masked scan; each row's state equals the kernel's over its valid "
        f"lanes alone, bit for bit")


def rwkv6_phase(torch, device, ops, ref, serve, Model, write_slot, validate,
                sync) -> int:
    """Phase 5: rwkv6-1.6b at full width through the serve path's slot
    engine and paged engine (fusion on and off).  -> ``rwkv6_scan``
    launches of its engine runs."""
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
        prefill_launches(counts) == 0, counts
    total = counts["rwkv6_scan"]

    # the paged engine: recurrent-state slots beside an unused block pool;
    # one rwkv6_scan a layer per dispatch, no attention kernel
    for fusion in ("on", "off"):
        a = mode_args(serve, arch="rwkv6-1.6b", decode_fusion=fusion)
        run_engine(serve.build_engine(a, model, params), prompts[:2], 2,
                   sync)                                      # warm-up
        engine = serve.build_engine(a, model, params)
        run = {}
        ops.reset_launch_counts()
        with counting_dispatches(model) as d:
            outs, secs = run_engine(engine, prompts, a.max_new, sync, run)
        counts = ops.launch_counts()
        stats = validate(engine.stats())
        ntok = sum(len(t) for t in outs.values())
        log(f"engine rwkv6-1.6b bf16 24 layers paged decode_fusion={fusion}: "
            f"{len(outs)} requests, {ntok} tokens in {secs:.3f}s "
            f"({ntok / secs:.1f} tok/s), {run['steps']} steps, "
            f"preemptions={stats['preemptions']} window_blocks_freed="
            f"{stats['window_blocks_freed']} dispatches={dict(d)} "
            f"launches={counts}")
        assert len(outs) == len(prompts)
        assert all(len(t) == a.max_new for t in outs.values())
        assert counts["rwkv6_scan"] == cfg.num_layers * (
            d["prefill_paged"] + d["decode_step_paged"]), (counts, d)
        if fusion == "on":
            assert d == {"prefill_paged": run["steps"],
                         "decode_step_paged": 0}, d
        assert counts["flash_attention"] == counts["paged_attention"] == \
            prefill_launches(counts) == counts["ssm_scan"] == 0, counts
        assert stats["prefix_cache"] == 0
        total += counts["rwkv6_scan"]
    rwkv_masked_parity(torch, device, model, params, ops, ref)
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
    for fusion in ("on", "off"):
        a = mode_args(serve, arch="rwkv6-1.6b", decode_fusion=fusion)
        got, _ = run_engine(serve.build_engine(a, small_model, small_params),
                            prompts, a.max_new, sync)
        assert got == tokens["kernel"], f"rwkv6 paged {fusion} vs slot"
    log("engine rwkv6 float32 2 layers paged fusion on/off and slot: "
        "token-identical")
    return total


# phase 4b's engine modes: serve-CLI flags over ``SERVE_ARGV``
FEATURE_MODES = {
    "continuous": {},
    "serial": dict(scheduler="serial"),
    "ngram": dict(spec_decode="ngram", spec_k=4),
    "draft": dict(spec_decode="draft", spec_k=4, draft_layers=1),
}
# instrumentation's cost is read from this many alternating pairs of the
# n-gram run with and without obs: one run's tokens/s moves by more than
# that cost between runs of one call
OBS_PAIRS = 7
# at 2 layers in float32 every mode must emit the continuous mode's tokens
IDENTITY_MODES = {
    "fusion off": dict(decode_fusion="off"),
    "serial": dict(scheduler="serial"),
    "ngram k=1": dict(spec_decode="ngram", spec_k=1),
    "ngram k=4": dict(spec_decode="ngram", spec_k=4),
    "draft k=4": dict(spec_decode="draft", spec_k=4, draft_layers=1),
}


def mode_args(serve, **flags):
    args = serve.make_parser().parse_args(SERVE_ARGV)
    for key, value in flags.items():
        setattr(args, key, value)
    serve.check_args(args)
    return args


def logit_margin(torch, model, params, prompt, agreed):
    """Top-1 minus top-2 logit of the target at the first position where
    two modes' tokens part (prompt + the tokens both emitted before it),
    through the kernels.  -> (margin, top-1 token, top-2 token)."""
    import numpy as np

    seq = np.concatenate([prompt, np.asarray(agreed, np.int32)])
    toks = torch.from_numpy(seq[None]).to(model.device)
    with torch.inference_mode():
        logits, _ = model.prefill(params, {"tokens": toks},
                                  cache_max=len(seq))
    top = torch.topk(logits[0, -1].float(), 2)
    return ((top.values[0] - top.values[1]).item(), int(top.indices[0]),
            int(top.indices[1]))


def draft_parity(torch, ops, ref, model, params, cache_max):
    """The drafter on the card against the same drafter under the plain
    ops: a one-layer ``layer_truncated_draft`` of ``model`` (2 layers,
    float32) proposes k=4 tokens from seeded histories whose last forward
    falls in each bucket of ``DRAFT_SHAPES``; a forward of each history
    right-padded to each S agrees at its valid rows within 1e-4, and the
    proposals are equal."""
    import numpy as np

    from repro_torch.serving.spec_decode import (layer_truncated_draft,
                                                 make_drafter)

    dmodel, dparams = layer_truncated_draft(model, params, 1)
    rng = np.random.default_rng(5)
    worst = 0.0
    for s, valid in DRAFT_SHAPES:
        # k=4 forwards at lengths valid-3 .. valid, the last in bucket s
        history = rng.integers(0, model.cfg.vocab_size, valid - 3)
        row = torch.from_numpy(
            np.pad(history, (0, s - len(history)))[None].astype(np.int32)
        ).to(model.device)
        got = {}
        for name, ctx in (("kernel", contextlib.nullcontext()),
                          ("plain", plain_ops(ops, ref))):
            with ctx:
                drafter = make_drafter("draft", draft_model=dmodel,
                                       draft_params=dparams,
                                       max_len=cache_max)
                proposal = drafter.propose(history, 4)
                with torch.inference_mode():
                    logits = dmodel.forward(dparams, {"tokens": row})
            got[name] = (proposal, logits[0, :len(history)].float())
        if s & (s - 1) == 0:                    # s is a bucket
            assert s in drafter._sigs, (s, drafter._sigs)
        err = (got["kernel"][1] - got["plain"][1]).abs().max().item()
        torch.testing.assert_close(got["kernel"][1], got["plain"][1],
                                   atol=1e-4, rtol=1e-4)
        assert got["kernel"][0] == got["plain"][0], got
        worst = max(worst, err)
        log(f"draft qwen3-0.6b float32 1 of 2 layers, history of "
            f"{len(history)}: proposals {got['kernel'][0]} equal the plain "
            f"ops'; logits at S={s} max_abs_err={err:.3e}")
    return worst


def engine_features_phase(torch, ops, ref, serve, model, params,
                          small_model, small_params, prompts, sync,
                          validate, smi) -> dict:
    """Phase 4b: the paged engine's serial scheduler, speculative
    decoding (n-gram and a one-layer draft, k=4) and observability hooks,
    at full width in bf16 through ``serve.build_engine``, on the smoke
    workload and on 8 seeded ``repetitive_workload`` prompts; then the
    drafter against its plain ops (``draft_parity``) and token identity
    across every mode at 2 layers in float32.  -> launch counts summed
    over its full-width runs (each read just after its run)."""
    import collections
    import statistics

    from repro_torch.obs import (Observability, span_report,
                                 validate_chrome_trace)
    from repro_torch.serving.loadgen import repetitive_workload

    cfg = model.cfg
    layers = cfg.num_layers
    workloads = {"smoke": prompts,
                 "repetitive": repetitive_workload(
                     num_requests=8, vocab_size=cfg.vocab_size,
                     prompt_len=32, max_new=16, seed=0).prompts}
    launches = dict.fromkeys(ops.launch_counts(), 0)
    tokens = {}

    def drive(args, work, obs=None, after_step=None):
        # the warm-up serves the same work, so the timed run meets no
        # shape (window width, c_pad bucket, draft length) first
        run_engine(serve.build_engine(args, model, params), work,
                   args.max_new, sync)
        engine = serve.build_engine(args, model, params, obs=obs)
        run = {}
        ops.reset_launch_counts()
        outs, secs = run_engine(engine, work, args.max_new, sync, run,
                                after_step and (lambda: after_step(engine)))
        counts = ops.launch_counts()
        return engine, outs, secs, counts, validate(engine.stats()), \
            run["steps"]

    for wname, work in workloads.items():
        for mode, flags in FEATURE_MODES.items():
            args = mode_args(serve, **flags)
            per_step = []
            engine, outs, secs, counts, stats, steps = drive(
                args, work, after_step=lambda e: per_step.append(
                    ops.launch_counts()))
            tokens[wname, mode] = outs
            ntok = sum(len(t) for t in outs.values())
            log(f"engine qwen3-0.6b bf16 28 layers {mode} on {wname}: "
                f"{len(outs)} requests, {ntok} tokens in {secs:.3f}s "
                f"({ntok / secs:.1f} tok/s; {smi}), {steps} steps, "
                f"preemptions={stats['preemptions']} "
                f"spec_verify_rows={engine.spec_verify_rows} "
                f"spec_proposed={engine.spec_proposed} "
                f"tokens_per_verify={stats['accepted_tokens_per_step']:.3f} "
                f"draft_hit_rate={stats['draft_hit_rate']:.3f} "
                f"rollbacks={stats['spec_rollbacks']} "
                f"launches={counts}")
            assert len(outs) == len(work)
            assert all(len(t) == args.max_new for t in outs.values())
            for k, n in counts.items():
                launches[k] += n
            if mode == "serial":
                # each step one dispatch: a whole-prompt prefill (one
                # paged_prefill a layer) or a decode step of every row
                # (one paged_attention a layer)
                deltas = [{k: b[k] - a.get(k, 0) for k in b} for a, b in
                          zip([{}] + per_step, per_step)]
                pre = [d for d in deltas if prefill_launches(d)]
                dec = [d for d in deltas if d["paged_attention"]]
                assert len(pre) + len(dec) == len(deltas) == steps
                assert all(d["paged_prefill_pool"] == layers
                           and d["paged_prefill"] == 0
                           and d["paged_attention"] == 0 for d in pre), pre
                assert all(d["paged_attention"] == layers
                           and prefill_launches(d) == 0 for d in dec), dec
                assert len(pre) == stats["admissions"]
                # no decode row rides the ragged dispatch
                assert not any(sig[3] for sig in engine._prefill_sigs)
                assert stats["decode_kernel"] == 1
                assert stats["decode_fusion"] == 0
                log(f"  serial: {len(pre)} admission steps x {layers} "
                    f"paged_prefill_pool, {len(dec)} decode steps x "
                    f"{layers} paged_attention")
            elif mode in ("ngram", "draft"):
                assert counts["paged_attention"] == 0
                assert counts["paged_prefill_pool"] > 0
                assert counts["paged_prefill"] == 0
                assert engine.spec_verify_rows > 0
                assert stats["spec_k"] == 4
                if mode == "draft" or wname == "repetitive":
                    # drafted lanes (windows wider than one lane) reached
                    # paged_prefill, the only attention kernel launched
                    assert engine.spec_proposed > 0
            if mode == "ngram" and wname == "repetitive":
                assert stats["draft_hit_rate"] > 0
                assert stats["spec_rollbacks"] > 0
            if mode == "draft":
                # the one-layer draft: one flash_attention a forward
                assert counts["flash_attention"] == \
                    engine.drafter.forwards * 1 > 0, (
                        counts, engine.drafter.forwards)
                log(f"  draft: {engine.drafter.forwards} forwards at "
                    f"lengths {sorted(engine.drafter._sigs)}")
                # every length it ran is held against the plain version
                # in phase 2 and timed in phase 7
                assert engine.drafter._sigs <= {s for s, _ in DRAFT_SHAPES}
            else:
                assert counts["flash_attention"] == 0

    # the observability hooks on the n-gram run, exported and read back
    obs = Observability.create(trace=True)
    args = mode_args(serve, **FEATURE_MODES["ngram"])
    engine, outs, secs, counts, stats, steps = drive(
        args, workloads["repetitive"], obs=obs)
    for k, n in counts.items():
        launches[k] += n
    assert outs == tokens["repetitive", "ngram"], "obs changed a token"
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        n_events = obs.trace.export(str(path))
        trace = json.loads(path.read_text())
    assert validate_chrome_trace(trace, sorted(outs)) == []
    spans = span_report(trace)
    assert all(spans[r]["opens"] == spans[r]["closes"] == 1 for r in outs)
    # each verify window's width: its drafted tokens and lane 0
    widths = collections.Counter(
        ev["args"]["proposed"] + 1 for ev in trace["traceEvents"]
        if ev["name"] == "spec_verify")
    assert sum(widths.values()) == engine.spec_verify_rows
    assert max(widths) > 1, widths
    page = obs.metrics.render()
    for name in ("engine_spec_proposed_total", "engine_spec_accepted_total",
                 "engine_spec_rollbacks_total",
                 "engine_spec_accepted_tokens_bucket"):
        assert name in page, name
    ntok = sum(len(t) for t in outs.values())
    log(f"engine qwen3-0.6b bf16 28 layers ngram + obs (trace and metrics) "
        f"on repetitive: {ntok / secs:.1f} tok/s ({smi}), {steps} steps, "
        f"{n_events} trace events, every span closed, "
        f"{len(page.splitlines())} metric lines; verify window widths "
        f"(lanes: rows) {dict(sorted(widths.items()))}")

    # instrumentation's cost: the same warmed run with and without obs,
    # in pairs whose order alternates (not counted as launches)
    rates = {"off": [], "on": []}
    for i in range(OBS_PAIRS):
        for side in ("off", "on")[::1 if i % 2 == 0 else -1]:
            on = Observability.create(trace=True) if side == "on" else None
            outs, secs = run_engine(serve.build_engine(args, model, params,
                                                       obs=on),
                                    workloads["repetitive"], args.max_new,
                                    sync)
            assert outs == tokens["repetitive", "ngram"]
            rates[side].append(ntok / secs)
    med = {k: statistics.median(v) for k, v in rates.items()}
    log(f"obs cost, ngram on repetitive, {OBS_PAIRS} alternating pairs "
        f"({smi}): tok/s off {[round(r, 1) for r in rates['off']]}, on "
        f"{[round(r, 1) for r in rates['on']]}; medians {med['off']:.1f} / "
        f"{med['on']:.1f} (on / off {med['on'] / med['off']:.3f}); obs "
        f"slower in {sum(a < b for a, b in zip(rates['on'], rates['off']))}"
        f" of {OBS_PAIRS} pairs")

    # bf16 at 28 layers: how many tokens each mode shares with continuous
    for (wname, mode), outs in sorted(tokens.items()):
        if mode == "continuous":
            continue
        want = tokens[wname, "continuous"]
        agree = total = 0
        for rid, toks in outs.items():
            same = next((i for i, (a, b) in enumerate(zip(toks, want[rid]))
                         if a != b), len(toks))
            agree += same
            total += len(toks)
            if same < len(toks):
                margin, t1, t2 = logit_margin(
                    torch, model, params, workloads[wname][rid - 1],
                    toks[:same])
                log(f"  bf16 {mode} vs continuous on {wname}, request "
                    f"{rid}: first flip at token {same} ({toks[same]} vs "
                    f"{want[rid][same]}); target's top-2 logit margin there "
                    f"{margin:.4f} (top-1 {t1}, top-2 {t2})")
        log(f"engine bf16 28 layers {mode} vs continuous on {wname}: "
            f"{agree} of {total} tokens agree before the first flip")

    draft_parity(torch, ops, ref, small_model, small_params,
                 mode_args(serve).cache_max)

    # 2 layers in float32: every mode emits the continuous mode's tokens
    for wname, work in workloads.items():
        base = mode_args(serve)
        want, _ = run_engine(serve.build_engine(base, small_model,
                                                small_params), work,
                             base.max_new, sync)
        for mode, flags in IDENTITY_MODES.items():
            args = mode_args(serve, **flags)
            engine = serve.build_engine(args, small_model, small_params)
            got, secs = run_engine(engine, work, args.max_new, sync)
            s = validate(engine.stats())
            log(f"engine qwen3-0.6b float32 2 layers {mode} on {wname}: "
                f"{sum(map(len, got.values())) / secs:.1f} tok/s, "
                f"preemptions={s['preemptions']} "
                f"hit_rate={s['hit_rate']:.2f} "
                f"draft_hit_rate={s['draft_hit_rate']:.3f}")
            assert got == want, f"{mode} tokens differ from continuous"
    log("engine float32 2 layers: serial, fusion off, ngram k=1/4 and "
        "draft k=4 token-identical to continuous")
    return launches


# ---------------------------------------------------------------- cluster


# phase 4c's workload: the port's multi-tenant generator (3 tenants' 32-
# token system prompts, 2 bursts of 4, user turns of up to 24 tokens, up
# to 16 new tokens), then the 8 smoke prompts as a fourth tenant (their
# shared 32-token head), 16 new tokens each
CLUSTER_WORKLOAD = dict(num_tenants=3, num_bursts=2, burst_size=4,
                        prefix_len=32, max_suffix=24, max_new=16, seed=0)
CLUSTER_REPLICAS = (1, 2, 4)


def cluster_workload(vocab_size, smoke_prompts):
    """-> (prompts, max_news, tenant ids) in submission order."""
    from repro_torch.serving.loadgen import multi_tenant_workload

    wl = multi_tenant_workload(vocab_size=vocab_size, **CLUSTER_WORKLOAD)
    n = len(smoke_prompts)
    return (list(wl.prompts) + list(smoke_prompts),
            list(wl.max_news) + [16] * n,
            list(wl.tenant_ids) + [wl.num_tenants] * n)


@contextlib.contextmanager
def counting_dispatches(model):
    """Count ``model``'s paged dispatches (``prefill_paged`` and
    ``decode_step_paged`` calls) while the block runs.  -> the counts."""
    n = {"prefill_paged": 0, "decode_step_paged": 0}
    for name in n:
        def counted(*a, _fn=getattr(model, name), _name=name, **kw):
            n[_name] += 1
            return _fn(*a, **kw)
        setattr(model, name, counted)
    try:
        yield n
    finally:
        for name in n:
            delattr(model, name)


def drive_cluster(ops, serve, args, model, params, work, replicas, sync, *,
                  affinity=True, **kw):
    """Submit ``work`` to a ``ServingCluster`` of ``replicas`` engines that
    ``serve.build_engine(args, ...)`` builds from the one ``(model,
    params)`` (one copy of the weights), drain it.  -> dict: the cluster,
    the cluster ids in submission order (None: a 429), {cid: tokens},
    seconds, cluster steps, each replica's engine steps, the model's
    dispatches and the launch counts of the run."""
    from repro_torch.serving.cluster import Rejected, ServingCluster

    cl = ServingCluster(lambda i: serve.build_engine(args, model, params),
                        replicas, affinity=affinity, seed=args.seed, **kw)
    assert all(e.params is params for e in cl.engines)
    engine_steps = [0] * replicas
    for i, eng in enumerate(cl.engines):
        def counted(now=0.0, _step=eng.step, _i=i):
            engine_steps[_i] += 1
            return _step(now)
        eng.step = counted
    ops.reset_launch_counts()
    with counting_dispatches(model) as dispatches:
        sync()
        t0 = time.perf_counter()
        cids = []
        for p, n in zip(*work[:2]):
            try:
                cids.append(cl.submit(p, max_new=n,
                                      now=time.perf_counter() - t0))
            except Rejected:
                cids.append(None)
        outs, steps = {}, 0
        while not cl.idle:
            steps += 1
            for r in cl.step(now=time.perf_counter() - t0):
                outs[r.cid] = list(r.out_tokens)
        sync()
        secs = time.perf_counter() - t0
    return dict(cluster=cl, cids=cids, outs=outs, secs=secs, steps=steps,
                engine_steps=engine_steps, dispatches=dict(dispatches),
                counts=ops.launch_counts())


def fleet_hit_rate(cluster) -> float:
    """Prompt tokens served from the replicas' radix caches, over all."""
    hit = sum(e.prefix_cache.hit_tokens for e in cluster.engines)
    miss = sum(e.prefix_cache.miss_tokens for e in cluster.engines)
    return hit / max(hit + miss, 1)


def first_flip(toks, want) -> int:
    """Tokens two runs share before the first that differs."""
    return next((i for i, (a, b) in enumerate(zip(toks, want)) if a != b),
                len(toks))


def cluster_phase(torch, ops, serve, model, params, small_model,
                  small_params, prompts, sync, validate, smi) -> dict:
    """Phase 4c: the cluster tier through ``serve.build_engine``'s paged
    config (32 blocks of 16 a replica, max batch 8, cache-max 256, prefix
    cache on), qwen3-0.6b at full width in bf16, 1, 2 and 4 replicas on
    the one card sharing one weight copy, affinity on and off, on
    ``cluster_workload``; a replay, the 429 paths, fusion off, merged
    metrics, bf16 shares against 1 replica, identity at 2 layers in
    float32, and the serve CLI's ``--replicas 2``.  -> launch counts
    summed over its full-width runs (each read just after its run)."""
    from repro_torch.obs import summarize_latencies

    args = mode_args(serve)
    layers = model.cfg.num_layers
    work = cluster_workload(model.cfg.vocab_size, prompts)
    n_req = len(work[0])
    launches = dict.fromkeys(ops.launch_counts(), 0)

    def drive(a, replicas, **kw):
        run = drive_cluster(ops, serve, a, model, params, work, replicas,
                            sync, **kw)
        for k, n in run["counts"].items():
            launches[k] += n
        cl = run["cluster"]
        s = validate(cl.stats())
        ntok = sum(map(len, run["outs"].values()))
        rates = [round(e.stats()["hit_rate"], 3) for e in cl.engines]
        log(f"cluster qwen3-0.6b {model.cfg.dtype} {layers} layers, "
            f"{replicas} replicas, "
            f"affinity {'on' if cl.affinity else 'off'}"
            f"{'' if a is args else ', ' + a.label}: {s['finished']} of "
            f"{n_req} requests, {ntok} tokens in {run['secs']:.3f}s "
            f"({ntok / run['secs']:.1f} tok/s; {smi}), {run['steps']} "
            f"cluster steps, engine steps {run['engine_steps']}, hit rates "
            f"{rates} (fleet {fleet_hit_rate(cl):.3f}), affinity "
            f"hits={s['affinity_hits']} misses={s['affinity_misses']}, "
            f"429s={s['rejected_429']}, dispatches {run['dispatches']}, "
            f"launches={run['counts']}")
        log("  " + serve._fmt_stats(cl.balancer.stats()).replace(
            "\n", "\n  "))
        # every accepted request finishes whole, nothing stays queued
        news = dict(zip(run["cids"], work[1]))
        assert sorted(run["outs"]) == sorted(c for c in run["cids"] if c)
        assert all(len(t) == news[c] for c, t in run["outs"].items())
        assert s["finished"] == s["submitted"] == n_req - s["rejected_429"]
        assert cl.broker.total_depth(cl.GROUP) == 0
        assert all(r.in_flight == 0 for r in cl.balancer.replicas)
        if a.decode_fusion == "on":
            # each engine step is one fused dispatch: a paged_prefill_pool
            # a layer, never paged_attention
            assert run["dispatches"] == {
                "prefill_paged": sum(run["engine_steps"]),
                "decode_step_paged": 0}, run
            assert run["counts"]["paged_prefill_pool"] == \
                layers * sum(run["engine_steps"]), run
            assert run["counts"]["paged_attention"] == 0, run
        assert run["counts"]["paged_prefill"] == 0, run
        assert run["counts"]["flash_attention"] == 0, run
        return run

    def labelled(label, **flags):
        a = mode_args(serve, **flags)
        a.label = label
        return a

    drive_cluster(ops, serve, args, model, params, work, 2, sync)   # warm-up
    runs = {(n, aff): drive(args, n, affinity=aff, obs=n == 2 and aff)
            for n in CLUSTER_REPLICAS for aff in (True, False)}

    # routing: a replay from the seed makes the same decisions; affinity
    # keeps each tenant on one replica and serves more from the caches
    again, first = drive(args, 2), runs[2, True]
    assert again["cluster"].route_log == first["cluster"].route_log
    same = again["outs"] == first["outs"]
    log(f"cluster replay, 2 replicas, affinity on, seed {args.seed}: "
        f"route_log identical ({len(again['cluster'].route_log)} "
        f"decisions); tokens {'identical' if same else 'differ'}")
    for n in CLUSTER_REPLICAS[1:]:
        on, off = runs[n, True]["cluster"], runs[n, False]["cluster"]
        placed = {}
        for (_, rid, _), tenant in zip(on.route_log, work[2]):
            placed.setdefault(tenant, set()).add(rid)
        assert all(len(r) == 1 for r in placed.values()), placed
        assert on.affinity_hits > 0
        assert fleet_hit_rate(on) >= fleet_hit_rate(off), n
        log(f"cluster {n} replicas: tenants on replicas "
            f"{ {t: sorted(r)[0] for t, r in sorted(placed.items())} } with "
            f"affinity on; fleet hit rate {fleet_hit_rate(on):.3f} on, "
            f"{fleet_hit_rate(off):.3f} off")

    # merged metrics: the fleet's TTFT histogram counts every request
    cl = runs[2, True]["cluster"]
    lat = summarize_latencies(cl.merged_metrics())
    assert lat["requests"] == cl.finished_count == n_req, lat
    log(f"cluster merged metrics (2 replicas): {lat}")

    # backpressure: a balancer 429 (4 in flight a replica, no queue) and a
    # broker 429 (partitions of 3 records)
    for a, kw in ((labelled("max batch 4, queue limit 0", max_batch=4),
                   dict(queue_limit=0)),
                  (labelled("partitions of 3"),
                   dict(queue_limit=64, broker_depth=3))):
        run = drive(a, 2, affinity=False, **kw)
        cl = run["cluster"]
        rejected = run["cids"].count(None)
        assert rejected > 0 and cl.rejected_429 == rejected
        if "broker_depth" in kw:
            assert cl.balancer.cancelled == rejected
        else:
            assert cl.balancer.rejected == rejected

    # decode fusion off: each decode dispatch a paged_attention a layer
    run = drive(labelled("decode fusion off", decode_fusion="off"), 2)
    d = run["dispatches"]
    assert run["counts"]["paged_attention"] == \
        layers * d["decode_step_paged"] > 0, run
    assert run["counts"]["paged_prefill_pool"] == \
        layers * d["prefill_paged"], run

    # bf16 at 28 layers: tokens each run shares with 1 replica, affinity
    # on, before a request's first flip, and the top-2 margin there
    base = runs[1, True]["outs"]
    for (n, aff), run in sorted(runs.items()):
        if (n, aff) == (1, True):
            continue
        agree = total = flips = 0
        for cid, toks in sorted(run["outs"].items()):
            same = first_flip(toks, base[cid])
            agree += same
            total += len(toks)
            if same < len(toks):
                flips += 1
                margin, t1, t2 = logit_margin(torch, model, params,
                                              work[0][cid - 1], toks[:same])
                log(f"  {n} replicas affinity {'on' if aff else 'off'}"
                    f" vs 1 replica, request {cid}: first flip at token "
                    f"{same}; target's top-2 logit margin there "
                    f"{margin:.4f} (top-1 {t1}, top-2 {t2})")
        log(f"cluster {model.cfg.dtype} {layers} layers, {n} replicas "
            f"affinity {'on' if aff else 'off'} vs 1 replica: {agree} of "
            f"{total} tokens agree before the first flip ({flips} requests "
            f"flip)")

    # 2 layers in float32: every replica count, affinity on and off, and
    # the slot engine emit the same tokens; and, with no EOS, scheduling
    # reads lengths, not token values, so each run routes, steps and hits
    # the caches as its 28-layer bf16 run did
    want = None
    for n in CLUSTER_REPLICAS:
        for aff in (True, False):
            run = drive_cluster(ops, serve, args, small_model, small_params,
                                work, n, sync, affinity=aff)
            got = [run["outs"][c] for c in run["cids"]]
            want = got if want is None else want
            assert got == want, (n, aff)
            bf16 = runs[n, aff]
            assert run["cluster"].route_log == bf16["cluster"].route_log
            assert run["engine_steps"] == bf16["engine_steps"], (n, aff)
            assert [e.stats()["hit_rate"] for e in run["cluster"].engines] \
                == [e.stats()["hit_rate"] for e in bf16["cluster"].engines]
            log(f"cluster {small_model.cfg.dtype} 2 layers, {n} replicas, "
                f"affinity {'on' if aff else 'off'}: engine steps "
                f"{run['engine_steps']}, routing and hit rates as at "
                f"{layers} layers in bf16")
    slot = serve.build_engine(serve.make_parser().parse_args(SLOT_ARGV),
                              small_model, small_params)
    for p, m in zip(*work[:2]):
        slot.submit(p, max_new=m)
    outs = {}
    while not slot.idle:
        for r in slot.step():
            outs[r.rid] = list(r.out_tokens)
    assert [outs[i + 1] for i in range(n_req)] == want
    log("cluster float32 2 layers: 1, 2 and 4 replicas, affinity on and "
        "off, and the slot engine token-identical")

    # the serve CLI's cluster tier, in this process
    buf = io.StringIO()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        serve.main(["--no-reduced", "--replicas", "2", "--requests", "8",
                    "--prompt-len", "32", "--max-new", "16", "--metrics"])
    for k, n in ops.launch_counts().items():
        launches[k] += n
    lines = buf.getvalue().splitlines()
    at = next(i for i, line in enumerate(lines)
              if line.startswith("8 requests"))
    for line in lines[at:at + 8]:
        log(f"  serve --replicas 2: {line}")
    assert lines[at].startswith("8 requests (0 rejected 429), 128 tokens")
    assert lines[at + 1].startswith("[cluster] replicas=2 affinity=on")
    assert "request_ttft_seconds_count 8" in lines, lines
    return launches


# ---------------------------------------------------------------- int8


# phase 4g's engine modes under the int8 KV cache: serve-CLI flags over
# ``SERVE_ARGV`` (32 blocks of 16: the tight pool preempts; prefix cache
# on), and the slot engine (``SLOT_ARGV``)
INT8_MODES = {"fusion on": dict(decode_fusion="on"),
              "fusion off": dict(decode_fusion="off"),
              "ngram k=4": dict(spec_decode="ngram", spec_k=4),
              "slot": None}
# the CPU tests' engine settings and workload (tests/test_torch_kv_quant.py:
# TIGHT, MODES, _workload), under which every mode of the reference emits
# the same tokens with the int8 cache
INT8_TIGHT = dict(num_blocks=10, block_size=4, max_batch=8, max_len=40,
                  prefix_cache=True)
INT8_CPU_MODES = {"fused": {}, "fusion_off": dict(decode_fusion=False),
                  "serial": dict(scheduler="serial"),
                  "ngram": dict(spec_decode="ngram", spec_k=4),
                  "roomy": dict(num_blocks=64, prefix_cache=False)}


def kv_bytes_per_token(model) -> int:
    """K/V bytes a token in ``model``'s pools, every layer (int8 values
    and their float32 scales, or the model dtype; the pos lanes not)."""
    pools = model.pool_init(2, 1)
    total = 0

    def walk(node):
        nonlocal total
        for name, leaf in node.items():
            if isinstance(leaf, dict):
                walk(leaf)
            elif name != "pos":
                total += leaf.numel() * leaf.element_size()

    walk(pools)
    return total // 2


def drive_steps(engine, bursts, news, steps_between=3):
    """How the CPU tests run an engine (``_drive`` in
    tests/test_torch_kv_quant.py): each burst submitted, a few steps
    between bursts, then drained."""
    outs = {}

    def step():
        for r in engine.step():
            outs[r.rid] = list(r.out_tokens)

    for burst, burst_news in zip(bursts, news):
        for p, n in zip(burst, burst_news):
            engine.submit(p, max_new=n)
        for _ in range(steps_between):
            step()
    while not engine.idle:
        step()
    return outs


def int8_phase(torch, device, ops, ref, serve, Model, ragged_dispatch,
               write_slot, validate, sync, smi, model, params, small_model,
               small_params, prompts) -> dict:
    """Phase 4g: the int8 KV cache (``kv_cache_quant``) on qwen3-0.6b at
    its published width (28 layers, bf16, the seeded weights of phase 4),
    through ``launch.serve.build_engine``: model parity int8 kernels vs
    int8 plain versions (paged: a ragged prefill after a prefix and a
    decode step; slot: a prompt and 2 decode steps); the engines of
    ``INT8_MODES`` on the smoke prompts with exact launches per dispatch
    (``paged_prefill_int8`` a fused, prefill or verify dispatch,
    ``paged_attention_int8`` a fusion-off decode step, a layer each; no
    float ``paged_prefill`` or ``paged_attention``), tokens/s, steps and
    preemptions; the pool's K/V bytes a token beside the bf16 pool's; as
    a reading, the tokens each mode shares with the bf16 cache's run of
    that mode and the top-2 margin at the first flip; then at 2 layers in
    float32 each mode's tokens through the kernels equal its tokens
    through the plain versions, and on the CPU tests' reduced config,
    settings and workload every mode emits the same tokens, as the
    reference does there.  -> launch counts summed over its runs."""
    cfg = dataclasses.replace(model.cfg, kv_cache_quant=True)
    layers = cfg.num_layers
    qmodel = Model(cfg, device=device)
    launches = dict.fromkeys(ops.launch_counts(), 0)

    ops.reset_launch_counts()
    for path, rel in (
            ("paged", model_parity(torch, device, qmodel, params, ops, ref,
                                   ragged_dispatch)),
            ("slot", slot_model_parity(torch, device, qmodel, params, ops,
                                       ref, write_slot, decode_steps=2))):
        log(f"model qwen3-0.6b bf16 {layers} layers int8 KV cache {path} path, "
            f"int8 kernels vs int8 plain versions: prefill rel_err="
            f"{rel['prefill']:.3e} decode rel_err={rel['decode']:.3e}")
        assert max(rel.values()) <= MODEL_TOL["bfloat16"], (path, rel)
    counts = ops.launch_counts()
    assert prefill_launches(counts) == counts["paged_attention"] == 0, counts
    # the paged path's pool entry, the slot path's contiguous one
    assert counts["paged_prefill_pool_int8"] > 0, counts
    assert counts["paged_prefill_int8"] > 0, counts

    q_bytes, d_bytes = kv_bytes_per_token(qmodel), kv_bytes_per_token(model)
    log(f"int8 KV cache qwen3-0.6b {layers} layers: {q_bytes:,} K/V bytes a "
        f"token (int8 values and float32 scales) against {d_bytes:,} in "
        f"bf16 ({q_bytes / d_bytes:.3f}x)")
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    assert q_bytes == layers * kv * (2 * hd + 2 * 4), q_bytes
    assert d_bytes == layers * kv * 2 * hd * 2, d_bytes

    def engine_args(flags):
        if flags is None:
            args = serve.make_parser().parse_args(SLOT_ARGV)
            serve.check_args(args)
            return args
        return mode_args(serve, **flags)

    def drive(m, args):
        """One timed run of ``m`` on the smoke prompts (a warm-up first,
        for the int8 model) -> (outs, secs, counts, stats, run,
        dispatches)."""
        if m is qmodel:
            run_engine(serve.build_engine(args, m, params), prompts[:2], 2,
                       sync)
        engine = serve.build_engine(args, m, params)
        run = {}
        with counting_dispatches(m) as d:
            ops.reset_launch_counts()
            outs, secs = run_engine(engine, prompts, args.max_new, sync, run)
            counts = ops.launch_counts()
        return outs, secs, counts, validate(engine.stats()), run, dict(d)

    for mode, flags in INT8_MODES.items():
        args = engine_args(flags)
        outs, secs, counts, stats, run, d = drive(qmodel, args)
        for k, n in counts.items():
            launches[k] += n
        ntok = sum(len(t) for t in outs.values())
        log(f"engine qwen3-0.6b bf16 {layers} layers int8 KV cache {mode}: "
            f"{len(outs)} requests, {ntok} tokens in {secs:.3f}s "
            f"({ntok / secs:.1f} tok/s; {smi}), {run['steps']} steps, "
            f"preemptions={stats.get('preemptions', 0)} "
            f"decode_kernel={stats.get('decode_kernel', 0)} "
            f"dispatches={d} launches={counts}")
        assert len(outs) == len(prompts)
        assert all(len(t) == args.max_new for t in outs.values())
        assert prefill_launches(counts) == counts["paged_attention"] == 0, \
            counts
        if flags is None:
            adm = stats["admissions"]
            want = {"flash_attention": layers * adm,
                    "paged_prefill_int8": layers * (run["steps"] - adm),
                    "paged_prefill_pool_int8": 0,
                    "paged_attention_int8": 0}
        else:
            want = {"flash_attention": 0, "paged_prefill_int8": 0,
                    "paged_prefill_pool_int8": layers * d["prefill_paged"],
                    "paged_attention_int8": layers * d["decode_step_paged"]}
            if mode != "fusion off":
                assert d["decode_step_paged"] == 0, d
            else:
                assert d["decode_step_paged"] > 0, d
                # the gauge reads the int8 launches: 1 where the
                # reference's reads 0 (its kernel reads no int8 pool)
                assert stats["decode_kernel"] == 1, stats
            if mode != "ngram k=4":
                assert stats["preemptions"] >= 1, \
                    "the pool must be tight enough to preempt"
        got = {k: counts[k] for k in want}
        assert got == want, (mode, got, want)

        # a reading: the bf16 cache's run of the same mode
        bf_outs, bf_secs = drive(model, args)[:2]
        shared = sum(first_flip(outs[r], bf_outs[r]) for r in outs)
        flips = [r for r in sorted(outs) if outs[r] != bf_outs[r]]
        line = (f"  {mode}: the bf16 cache's run just after it "
                f"{sum(map(len, bf_outs.values())) / bf_secs:.1f} tok/s; "
                f"{shared} of {ntok} tokens shared with it before each "
                "request's first flip")
        if flips:
            r = flips[0]
            i = first_flip(outs[r], bf_outs[r])
            margin, top1, top2 = logit_margin(torch, model, params,
                                              prompts[r - 1], outs[r][:i])
            line += (f"; first flip req {r} token {i}: int8 {outs[r][i]}, "
                     f"bf16 {bf_outs[r][i]}, top-2 margin {margin:.4f} "
                     f"({top1} vs {top2})")
        log(line)

    # 2 layers, float32: kernels against plain versions, mode by mode
    small_q = Model(dataclasses.replace(small_model.cfg, kv_cache_quant=True),
                    device=device)
    tokens = {}
    for mode, flags in INT8_MODES.items():
        args = engine_args(flags)
        for arm, ctx in (("kernels", contextlib.nullcontext()),
                         ("plain", plain_ops(ops, ref))):
            with ctx:
                engine = serve.build_engine(args, small_q, small_params)
                tokens[mode, arm], _ = run_engine(engine, prompts,
                                                  args.max_new, sync)
        assert tokens[mode, "kernels"] == tokens[mode, "plain"], mode
    same = {(a, b): tokens[a, "kernels"] == tokens[b, "kernels"]
            for a in INT8_MODES for b in INT8_MODES if a < b}
    assert same == {(a, b): tokens[a, "plain"] == tokens[b, "plain"]
                    for a, b in same}
    log("engine qwen3-0.6b float32 2 layers int8 KV cache: each mode's "
        f"tokens through the kernels equal its plain versions'; modes "
        f"agreeing: {sorted(k for k, v in same.items() if v)}")
    # a reading (ROADMAP Queue 3 record item 8): where a mode parts from
    # fusion on, the first differing token and the top-2 margin of the
    # full-precision logits there (a whole-prompt prefill of the prompt
    # and the tokens both emitted)
    base = tokens["fusion on", "kernels"]
    for mode in INT8_MODES:
        got = tokens[mode, "kernels"]
        flips = [r for r in sorted(got) if got[r] != base[r]]
        if not flips:
            continue
        r = flips[0]
        i = first_flip(got[r], base[r])
        margin, top1, top2 = logit_margin(torch, small_q, small_params,
                                          prompts[r - 1], got[r][:i])
        log(f"  {mode} parts from fusion on in {len(flips)} of {len(got)} "
            f"requests; first at req {r} token {i}: {got[r][i]} against "
            f"{base[r][i]}, full-precision top-2 margin {margin:.3e} "
            f"({top1} vs {top2})")

    # the CPU tests' reduced config, settings and workload: every mode
    # emits the same tokens through the kernels (as the reference does)
    from repro_torch.configs.base import get_config
    from repro_torch.serving.loadgen import shared_prefix_workload
    from repro_torch.serving.server import LLMEngine, PagedLLMEngine

    red = Model(dataclasses.replace(get_config("qwen3-0.6b").reduced(),
                                    kv_cache_quant=True), device=device)
    red_params = red.init(seed=0)
    wl = shared_prefix_workload(num_requests=6, prefix_len=10, suffix_len=7,
                                vocab_size=red.cfg.vocab_size,
                                num_prefixes=2, seed=4)
    bursts, news = [wl.prompts[:3], wl.prompts[3:]], [[8] * 3, [8] * 3]
    outs = {mode: drive_steps(PagedLLMEngine(red, red_params,
                                             **{**INT8_TIGHT, **kw}),
                              bursts, news)
            for mode, kw in INT8_CPU_MODES.items()}
    outs["slot"] = drive_steps(LLMEngine(red, red_params, num_slots=8,
                                         cache_max=64), bursts, news)
    assert all(o == outs["fused"] for o in outs.values()), \
        {m: o == outs["fused"] for m, o in outs.items()}
    log(f"engine qwen3-0.6b reduced float32 int8 KV cache, the CPU tests' "
        f"settings: {sorted(outs)} token-identical")
    del qmodel, small_q, red, red_params
    return launches


# ---------------------------------------------------------------- dense


# phase 4d: each config at its published width, or cut in depth where its
# weights outgrow one card; the engine modes each runs
DENSE_CONFIGS = (("phi4-mini-3.8b", None, ("on", "off", "slot")),
                 ("qwen1.5-110b", 4, ("on",)))


def seeded_qkv_bias(torch, params, seed):
    """Draw every ``bq``/``bk``/``bv`` leaf (the init's zeros) from
    N(0, 0.5), in place, in sorted key order."""
    gen = None

    def walk(node):
        nonlocal gen
        for key in sorted(node):
            leaf = node[key]
            if isinstance(leaf, dict):
                walk(leaf)
            elif key in ("bq", "bk", "bv"):
                gen = gen or torch.Generator(device=leaf.device).manual_seed(
                    seed)
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device=leaf.device) * 0.5)

    walk(params)
    return params


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def dense_phase(torch, device, ops, ref, serve, Model, ragged_dispatch,
                write_slot, validate, sync, smi) -> dict:
    """Phase 4d: phi4-mini-3.8b at its published width (32 layers) and
    qwen1.5-110b at 4 full-width layers (seeded non-zero q/k/v biases),
    bf16, seeded weights: model parity kernels vs plain on the paged and
    slot paths, then the serve path's engines on the smoke prompts with
    exact launch counts, and the card's memory high-water mark.  ->
    launch counts summed over its engine runs."""
    from repro_torch.configs.base import get_config

    launches = dict.fromkeys(ops.launch_counts(), 0)
    for arch, depth, modes in DENSE_CONFIGS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        args = mode_args(serve, arch=arch)
        if depth is None:
            cfg, model, params = serve.build_model(args)
        else:
            cfg = dataclasses.replace(get_config(arch), num_layers=depth)
            model = Model(cfg, device=device)
            params = model.init(seed=args.seed)
        if cfg.qkv_bias:
            seeded_qkv_bias(torch, params, seed=1)
        init_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        layers = cfg.num_layers
        what = f"{arch} {cfg.dtype} {layers} layers"
        if depth is not None:
            what += f" (cut from {get_config(arch).num_layers})"
        log(f"dense {what}: {tree_bytes(params) / 2**30:.2f} GiB of "
            f"weights, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.resolved_head_dim}, d_model {cfg.d_model}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied "
            f"{cfg.tie_embeddings}, qkv bias {cfg.qkv_bias}")
        for path, rel in (
                ("paged", model_parity(torch, device, model, params, ops,
                                       ref, ragged_dispatch)),
                ("slot", slot_model_parity(torch, device, model, params,
                                           ops, ref, write_slot))):
            log(f"model {what} {path} path, kernels vs plain: prefill "
                f"rel_err={rel['prefill']:.3e} decode "
                f"rel_err={rel['decode']:.3e}")
            assert max(rel.values()) <= MODEL_TOL["bfloat16"], (path, rel)

        prompts = smoke_workload(cfg.vocab_size)
        for mode in modes:
            if mode == "slot":
                a = serve.make_parser().parse_args(SLOT_ARGV)
                a.arch = arch
            else:
                a = mode_args(serve, arch=arch, decode_fusion=mode)
            run_engine(serve.build_engine(a, model, params), prompts[:2], 2,
                       sync)                                  # warm-up
            engine = serve.build_engine(a, model, params)
            run = {}
            ops.reset_launch_counts()
            with counting_dispatches(model) as d:
                outs, secs = run_engine(engine, prompts, a.max_new, sync, run)
            counts = ops.launch_counts()
            for k, n in counts.items():
                launches[k] += n
            stats = validate(engine.stats())
            ntok = sum(len(t) for t in outs.values())
            log(f"engine {what} "
                f"{'slot' if mode == 'slot' else 'decode_fusion=' + mode}: "
                f"{len(outs)} requests, {ntok} tokens in {secs:.3f}s "
                f"({ntok / secs:.1f} tok/s; {smi}), {run['steps']} steps, "
                f"preemptions={stats['preemptions']} "
                f"admissions={stats['admissions']} "
                f"dispatches={dict(d)} launches={counts}")
            assert len(outs) == len(prompts)
            assert all(len(t) == a.max_new for t in outs.values())
            if mode == "slot":
                # one flash_attention a layer per admission; decode
                # through paged_prefill
                assert counts["flash_attention"] == \
                    layers * stats["admissions"] == layers * len(prompts)
                assert counts["paged_prefill"] > 0
                assert counts["paged_attention"] == 0
                assert counts["paged_prefill_pool"] == 0
            elif mode == "on":
                assert d == {"prefill_paged": run["steps"],
                             "decode_step_paged": 0}, d
                assert counts["paged_prefill_pool"] == layers * run["steps"]
                assert counts["paged_attention"] == 0
            else:
                assert counts["paged_attention"] == \
                    layers * d["decode_step_paged"] > 0
                assert counts["paged_prefill_pool"] == \
                    layers * d["prefill_paged"]
            if mode != "slot":
                assert counts["paged_prefill"] == \
                    counts["flash_attention"] == 0
        log(f"dense {what}: memory high-water mark (torch.cuda."
            f"max_memory_allocated; {smi}) while drawing the weights "
            f"{init_peak / 2**30:.2f} GiB (each leaf drawn in float32), "
            f"then through parity and the engines "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, params, engine
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- gemma3


# phase 4e: gemma3-4b at its published width (34 layers: 5 windowed
# ``attn_local`` layers of 1,024 to each global one, 8 / 4 heads of 256,
# GeGLU, tied 262,144 vocab), bf16.  The engines get the smoke prompts and
# two prompts past the window; the pool holds both long prompts whole
GEMMA3_ARGV = ["--arch", "gemma3-4b", "--no-reduced", "--num-blocks", "400",
               "--block-size", "16", "--cache-max", "2304", "--max-new",
               "16", "--prefix-cache", "on"]
GEMMA3_SLOT_ARGV = ["--arch", "gemma3-4b", "--no-reduced", "--engine",
                    "slot", "--slots", "4", "--cache-max", "2304",
                    "--max-new", "16"]
GEMMA3_LONG = (1100, 2000)      # long prompts' lengths: seeded in between
# gemma3-4b's attention heads (query, KV, head_dim) and its local window
GEMMA3_HEADS = dict(h=8, kv=4, hd=256)
GEMMA3_WINDOW = 1024
# the kernels' hd-256 shapes: paged_prefill at the fused decode dispatch
# (8 rows, one lane, 512 prefix lanes), a chunk (4 rows, S=256, 512 prefix
# lanes) and a chunk whose queries sit past position 1,024 (2 rows, S=64,
# cursors in [1,100, 1,536]); paged_attention over tables of 16 and of
# 128 blocks of 16 (rows past position 1,024); flash_attention at one
# causal row of S=512 and S=2048: (name, prefill/decode case kwargs)
GEMMA3_PP_SHAPES = (("fused decode", dict(b=8, s=1)),
                    ("chunk", dict(b=4, s=256)),
                    ("chunk past 1,024", dict(b=2, s=64, prefix=1536,
                                              min_start=1100)))
GEMMA3_PA_SHAPES = ((16, (5,)), (128, (2,)))        # (table blocks, nulls)
GEMMA3_FA_SHAPES = (512, 2048)


def gemma3_kernel_parity(torch, device, ops, ref):
    """Phase 4e, kernels: the three attention kernels at head_dim 256 and
    gemma3-4b's 8 / 4 heads (``GEMMA3_*_SHAPES``), bfloat16 and float32,
    window 0 and 1,024, against their plain versions.  -> {kernel: max
    abs error over its bfloat16 cases}."""
    gen = torch.Generator(device=device).manual_seed(11)
    errs = dict.fromkeys(("paged_attention", "paged_prefill",
                          "flash_attention"), 0.0)

    def check(kernel, dtype_name, what, out, plain):
        torch.cuda.synchronize()
        err = (out.float() - plain.float()).abs().max().item()
        torch.testing.assert_close(out.float(), plain.float(),
                                   **KERNEL_TOL[kernel, dtype_name])
        log(f"parity {kernel} {dtype_name} head_dim 256 {what}: "
            f"max_abs_err={err:.3e}")
        if dtype_name == "bfloat16":
            errs[kernel] = max(errs[kernel], err)

    for dtype_name in ("bfloat16", "float32"):
        dt = getattr(torch, dtype_name)
        for window in (0, GEMMA3_WINDOW):
            for what, kw in GEMMA3_PP_SHAPES:
                args = prefill_case(torch, gen, device, dt, **kw,
                                    **GEMMA3_HEADS)
                lanes = prefill_visible(torch, args[3], args[4],
                                        window).any(-1)
                check("paged_prefill", dtype_name,
                      f"{what} ({kw['b']} rows, S={kw['s']}, "
                      f"L={args[1].shape[1]}) window={window} tile="
                      f"{pp_tile(args[0], args[1].shape[2], dtype_name)}",
                      ops.paged_prefill(*args, window=window)[lanes],
                      ref.paged_prefill_ref(*args, window=window)[lanes])
            for nb, nulls in GEMMA3_PA_SHAPES:
                args = decode_case(torch, gen, device, dt, nb=nb,
                                   null_rows=nulls, **GEMMA3_HEADS)
                out = ops.paged_attention(*args, window=window)
                assert all(torch.all(out[r] == 0) for r in nulls)
                check("paged_attention", dtype_name,
                      f"8 rows x {nb} blocks (positions to "
                      f"{int(args[5].max())}) window={window}", out,
                      ref.paged_attention_ref(*args, window=window))
            for s in GEMMA3_FA_SHAPES:
                q, k, v = flash_case(torch, gen, device, dt, sq=s,
                                     **GEMMA3_HEADS)
                check("flash_attention", dtype_name,
                      f"one causal row of S={s} window={window}",
                      ops.flash_attention(q, k, v, window=window),
                      ref.flash_attention_ref(q, k, v, window=window))
    return errs


def gemma3_model_parity(torch, device, model, params, ops, ref,
                        ragged_dispatch):
    """Phase 4e, model: kernels vs plain versions past the window.  Paged:
    two rows' prefixes of 1,400 and 900 tokens written through the
    kernels, then one ragged dispatch of chunks of 100 and 64 tokens
    (every lane's logits) and one decode step at positions 1,500 and 964
    over identical pools.  Slot: a whole prompt of 1,500 tokens (the
    local layers' 1,024-lane rings wrap), then 2 decode steps.  -> {path:
    {"prefill": rel_err, "decode": rel_err}}."""
    cfg = model.cfg
    gen = torch.Generator(device=device).manual_seed(12)
    bs, prefix, chunk = 16, [1400, 900], [100, 64]
    rows = len(prefix)
    nb = -(-max(p + c + 1 for p, c in zip(prefix, chunk)) // bs)
    pools = model.pool_init(rows * nb + 1, bs)
    bt = (torch.arange(rows * nb, device=device, dtype=torch.int32)
          .reshape(rows, nb) + 1)

    def tokens(b, n):
        return torch.randint(1, cfg.vocab_size, (b, n), generator=gen,
                             device=device, dtype=torch.int32)

    def i32(x):
        return torch.tensor(x, dtype=torch.int32, device=device)

    ragged_dispatch(model, params, pools, tokens(rows, max(prefix)), bt,
                    i32([0] * rows), i32(prefix), block_size=bs,
                    all_logits=False)
    toks = tokens(rows, max(chunk))
    logits = {}
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_ops(ops, ref))):
        with ctx:
            logits[name], _ = model.prefill_paged(
                params, {"tokens": toks}, pools, bt, i32(prefix),
                seq_len=i32(chunk), all_logits=True)
    lanes = torch.arange(toks.shape[1], device=device)[None, :] < \
        i32(chunk)[:, None]
    out = {"paged": {"prefill": _rel_err(torch, logits["kernel"][lanes],
                                         logits["plain"][lanes])}}
    pos = i32([p + c for p, c in zip(prefix, chunk)])
    step = tokens(rows, 1)
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_ops(ops, ref))):
        step_pools = _clone(pools)
        with ctx:
            logits[name], _ = model.decode_step_paged(
                params, step_pools, bt, step, pos,
                torch.ones(rows, dtype=torch.bool, device=device))
        del step_pools
    out["paged"]["decode"] = _rel_err(torch, logits["kernel"],
                                      logits["plain"])
    del pools

    prompt = tokens(1, 1500)
    arms = (contextlib.nullcontext(), plain_ops(ops, ref))
    last, cache = [], None
    for ctx in arms:
        with ctx:
            lg, c = model.prefill(params, {"tokens": prompt}, cache_max=2304)
        last.append(lg)
        cache = c if cache is None else cache   # the kernels' caches
    out["slot"] = {"prefill": _rel_err(torch, last[0], last[1])}
    # a local layer keeps a ring of the window's lanes, a global one the
    # whole strip
    assert cache["periods"]["slot0"]["k"].shape[2] == GEMMA3_WINDOW
    assert cache["periods"]["slot5"]["k"].shape[2] == 2304
    steps = tokens(2, 1)
    dec = ([], [])
    for arm, ctx in enumerate(arms):
        c = _clone(cache)
        for i in range(2):
            with ctx:
                lg, c = model.decode_step(params, c, steps[i:i + 1],
                                          i32([1500 + i]))
            dec[arm].append(lg)
    out["slot"]["decode"] = _rel_err(torch, torch.stack(dec[0]),
                                     torch.stack(dec[1]))
    return out


def gemma3_workload(vocab_size):
    """The 8 smoke prompts, then two seeded prompts of
    ``GEMMA3_LONG`` lengths (past the 1,024-token window)."""
    import numpy as np

    rng = np.random.default_rng(22)
    longs = [rng.integers(1, vocab_size, int(n)).astype(np.int32)
             for n in rng.integers(*GEMMA3_LONG, size=2)]
    return smoke_workload(vocab_size) + longs


def gemma3_phase(torch, device, ops, ref, serve, ragged_dispatch, validate,
                 sync, smi) -> tuple:
    """Phase 4e: gemma3-4b at its published width through the serve
    path: kernel parity at head_dim 256, model parity past the window,
    the paged engine (fusion on and off) and the slot engine on prompts
    past the window with exact launch counts, a profile of the fused
    engine, weight bytes and memory high-water marks.  -> (launch counts
    summed over its engine runs, {kernel: max abs error})."""
    lap = lapper("4e")
    errs = gemma3_kernel_parity(torch, device, ops, ref)
    lap("kernel parity at head_dim 256")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = serve.make_parser().parse_args(GEMMA3_ARGV)
    serve.check_args(args)
    cfg, model, params = serve.build_model(args)
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    layers = cfg.num_layers
    kinds = cfg.kinds_for_layers
    what = f"gemma3-4b {cfg.dtype} {layers} layers"
    log(f"{what}: {tree_bytes(params) / 2**30:.2f} GiB of weights, "
        f"{kinds.count('attn_local')} attn_local layers (window "
        f"{cfg.sliding_window}, RoPE base {cfg.rope_theta_local:g}) and "
        f"{kinds.count('attn')} attn layers (base {cfg.rope_theta:g}), "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_model {cfg.d_model}, d_ff {cfg.d_ff} "
        f"({cfg.mlp_kind}), vocab {cfg.vocab_size}, tied "
        f"{cfg.tie_embeddings}")
    for path, rel in gemma3_model_parity(torch, device, model, params, ops,
                                         ref, ragged_dispatch).items():
        log(f"model {what} {path} path past the window, kernels vs plain: "
            f"prefill rel_err={rel['prefill']:.3e} decode "
            f"rel_err={rel['decode']:.3e}")
        assert max(rel.values()) <= MODEL_TOL["bfloat16"], (path, rel)
    parity_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lap("weights and model parity")

    prompts = gemma3_workload(cfg.vocab_size)
    launches = dict.fromkeys(ops.launch_counts(), 0)
    outs_by_mode = {}
    for mode in ("on", "off", "slot"):
        if mode == "slot":
            a = serve.make_parser().parse_args(GEMMA3_SLOT_ARGV)
        else:
            a = serve.make_parser().parse_args(GEMMA3_ARGV)
            a.decode_fusion = mode
        serve.check_args(a)
        run_engine(serve.build_engine(a, model, params), prompts[:2], 2,
                   sync)                                      # warm-up
        engine = serve.build_engine(a, model, params)
        run = {}
        ops.reset_launch_counts()
        with counting_dispatches(model) as d:
            outs, secs = run_engine(engine, prompts, a.max_new, sync, run)
        counts = ops.launch_counts()
        for k, n in counts.items():
            launches[k] += n
        stats = validate(engine.stats())
        ntok = sum(len(t) for t in outs.values())
        log(f"engine {what} "
            f"{'slot' if mode == 'slot' else 'decode_fusion=' + mode}: "
            f"{len(outs)} requests ({len(prompts) - 2} of 32-200 tokens, "
            f"2 of {len(prompts[-2])} and {len(prompts[-1])}), {ntok} "
            f"tokens in {secs:.3f}s ({ntok / secs:.1f} tok/s; {smi}), "
            f"{run['steps']} steps, preemptions={stats['preemptions']} "
            f"admissions={stats['admissions']} "
            f"hit_rate={stats.get('hit_rate', 0.0):.2f} "
            f"window_blocks_freed={stats.get('window_blocks_freed', 0)} "
            f"dispatches={dict(d)} launches={counts}")
        assert len(outs) == len(prompts)
        assert all(len(t) == a.max_new for t in outs.values())
        # window accounting is inert: the global layers read every block
        assert stats.get("window_blocks_freed", 0) == 0
        if mode == "slot":
            # one flash_attention a layer per admission, one
            # paged_prefill a layer per decode step
            assert counts["flash_attention"] == \
                layers * stats["admissions"] == layers * len(prompts)
            assert counts["paged_prefill"] == \
                layers * (run["steps"] - stats["admissions"]) > 0
            assert counts["paged_attention"] == 0
            assert counts["paged_prefill_pool"] == 0
        elif mode == "on":
            assert d == {"prefill_paged": run["steps"],
                         "decode_step_paged": 0}, d
            assert counts["paged_prefill_pool"] == layers * run["steps"]
            assert counts["paged_attention"] == 0
        else:
            assert counts["paged_attention"] == \
                layers * d["decode_step_paged"] > 0
            assert counts["paged_prefill_pool"] == \
                layers * d["prefill_paged"]
        if mode != "slot":
            assert counts["paged_prefill"] == counts["flash_attention"] == 0
        outs_by_mode[mode] = outs
    shared = {m: sum(sum(1 for x, y in zip(outs_by_mode[m][r],
                                           outs_by_mode["on"][r]) if x == y)
                     for r in outs_by_mode["on"]) for m in ("off", "slot")}
    log(f"engine {what}: tokens equal to decode_fusion=on's at the same "
        f"lane (bf16; exact identity is a float32 fact): {shared} of "
        f"{sum(map(len, outs_by_mode['on'].values()))}")

    a = serve.make_parser().parse_args(GEMMA3_ARGV)
    engine = serve.build_engine(a, model, params)
    secs, busy, rows = profile_engine(
        torch, lambda: run_engine(engine, prompts, a.max_new, sync)[1])
    log(f"profile engine {what} decode_fusion=on: wall {secs:.3f}s under "
        f"the profiler, device busy {busy:.3f}s "
        f"({100 * busy / secs:.1f}%)")
    for us, n, key in rows[:12]:
        log(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:90]}")
    # the attention kernels beside the gathers and concatenations left in
    # the step: the attention reads its pool through the table, so what
    # these still count (each kernel named below) is the rest of the
    # model's and the engine's (the chunk scatter, the embedding, RoPE's
    # halves, the argmax's lane pick)
    sums = {}
    for name, pat in (("paged_prefill (tile and combine)", "paged_prefill"),
                      ("gathers", "gather_kernel"),
                      ("concatenations", "CatArrayBatchedCopy")):
        sel = [(us, n, key) for us, n, key in rows if pat in key]
        sums[name] = (sum(r[0] for r in sel) / 1e3, sum(r[1] for r in sel))
        for us, n, key in sel[:4]:
            log(f"  {name}: {us / 1e3:.2f} ms {n}x  {key[:110]}")
    log("profile engine " + what + " decode_fusion=on, device ms "
        "(launches): " + ", ".join(f"{k} {ms:.2f} ({n})"
                                   for k, (ms, n) in sums.items()))
    lap("engines and the profile")
    log(f"gemma3-4b memory high-water marks (torch.cuda.max_memory_"
        f"allocated; {smi}): drawing the weights {init_peak / 2**30:.2f} "
        f"GiB (each leaf in float32 before its cast), model parity "
        f"{parity_peak / 2**30:.2f} GiB, the engines and the profile "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, params, engine
    torch.cuda.empty_cache()
    return launches, errs


# ---------------------------------------------------------------- frontends


# phase 4h: whisper-tiny (4 + 4 layers, 1,500 frames, 6 heads of 64) and
# paligemma-3b (18 layers, 256 patches, 8 query heads over 1 KV head of
# 256), uncut, bf16, seeded weights and frontend embeddings, through
# Model.prefill and Model.decode_step: each smoke prompt prefilled alone,
# then the 8 caches decoding FRONTEND_NEW greedy tokens as one batch
FRONTEND_ARCHS = ("whisper-tiny", "paligemma-3b")
FRONTEND_NEW = 16


def frontend_launches(cfg) -> dict:
    """Kernel launches of a prefill (B = 1) and of a decode step: whisper's
    encoder, decoder self- and cross-attention each one ``flash_attention``
    a layer at prefill, its decode step a cross ``flash_attention`` and a
    slot ``paged_prefill`` a layer; paligemma one ``flash_attention`` a
    layer at prefill (the prefix-LM), one ``paged_prefill`` a decode
    step."""
    if cfg.is_encoder_decoder:
        return ({"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers},
                {"flash_attention": cfg.num_layers,
                 "paged_prefill": cfg.num_layers})
    return ({"flash_attention": cfg.num_layers},
            {"paged_prefill": cfg.num_layers})


def splice_row(big, one, row):
    """Copy whisper's batch-1 decoder caches (every leaf batch-first)
    into row ``row`` of batched ones, in place (a stack's caches go
    through ``kvcache.write_slot``)."""
    for k, v in one.items():
        if isinstance(v, dict):
            splice_row(big[k], v, row)
        else:
            big[k][row] = v[0]


def frontend_run(torch, model, params, prompts, embeds, new, teacher=None,
                 counts=None, step_secs=None):
    """Each prompt prefilled alone with its row of ``embeds``, its cache
    spliced into row i of one batch, then ``new`` decode steps over the
    batch at each row's own positions, greedy or fed ``teacher`` (new, B)
    tokens.  ``counts`` collects each call's launches, ``step_secs`` each
    decode step's seconds.  -> (prefill logits (B,V), step logits (new,
    B,V), tokens fed (new, B))."""
    from repro_torch.kernels import ops
    from repro_torch.serving.kvcache import write_slot

    cfg = model.cfg
    device = model.device
    splice = splice_row if cfg.is_encoder_decoder else write_slot
    n = cfg.num_prefix_tokens if cfg.frontend == "vision" else 0
    lens = [len(p) for p in prompts]
    cache_max = n + max(lens) + new
    cache = model.cache_init(len(prompts), cache_max)
    first = []
    with torch.inference_mode():
        for i, p in enumerate(prompts):
            ops.reset_launch_counts()
            toks = torch.from_numpy(p[None]).to(device)
            lg, c1 = model.prefill(params, {"tokens": toks,
                                            "embeds": embeds[i:i + 1]},
                                   cache_max=cache_max)
            if counts is not None:
                counts["prefill"].append(ops.launch_counts())
            first.append(lg[0, -1])
            splice(cache, c1, i)
        logits = torch.stack(first)
        fed, steps = [], []
        pos = torch.tensor([n + m for m in lens], dtype=torch.int32,
                           device=device)
        for t in range(new):
            tok = (logits.argmax(-1) if teacher is None
                   else teacher[t]).to(torch.int32)
            fed.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.reset_launch_counts()
            lg, cache = model.decode_step(params, cache, tok[:, None],
                                          pos + t)
            torch.cuda.synchronize()
            if step_secs is not None:
                step_secs.append(time.perf_counter() - t0)
            if counts is not None:
                counts["decode"].append(ops.launch_counts())
            logits = lg[:, 0]
            steps.append(logits)
    return torch.stack(first), torch.stack(steps), torch.stack(fed)


def frontend_card_vs_cpu(torch, device, Model, fe, arch):
    """The reduced config (float32, TF32 off): 2 prompts prefilled and 4
    greedy tokens decoded on the card (kernels) and on the CPU (plain
    versions) from one weight draw: logits within ``MODEL_TOL`` float32,
    the same tokens.  -> (rel_err prefill, rel_err decode)."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.optim.optimizers import tree_map

    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu")
    params = cpu.init(seed=0)
    card = Model(cfg, device=device)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 13)]
    emb = fe.fake_embeds(cfg, 2, cfg.dtype, seed=2, device="cpu")
    got = frontend_run(torch, card, tree_map(lambda t: t.to(device), params),
                       prompts, emb.to(device), 4)
    want = frontend_run(torch, cpu, params, prompts, emb, 4,
                        teacher=got[2].cpu())
    choice = torch.cat([want[0][None], want[1][:-1]]).argmax(-1)
    assert torch.equal(choice, want[2]), "card and CPU tokens differ"
    return (_rel_err(torch, got[0].cpu(), want[0]),
            _rel_err(torch, got[1].cpu(), want[1]))


def frontend_phase(torch, device, ops, ref, Model, smi) -> dict:
    """Phase 4h: whisper-tiny and paligemma-3b uncut, bf16, one after the
    other: the smoke prompts (each with its own seeded frontend
    embeddings) prefilled and decoded ``FRONTEND_NEW`` greedy tokens
    through the kernels, exactly ``frontend_launches`` a call; the plain
    versions fed the kernels' tokens, logits within ``MODEL_TOL``, the
    tokens each greedy step shares and the top-2 margin at each first
    flip; ``Model.forward`` against ``forward_train``; the median decode
    step and memory high-water marks; the reduced configs in float32,
    card against CPU.  -> the launch counts of the kernel runs (the
    kernels' errors are phase 2's)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import frontend as fe
    import statistics

    lap = lapper("4h")
    launches = dict.fromkeys(ops.launch_counts(), 0)
    for arch in FRONTEND_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        model = Model(cfg, device=device)
        params = model.init(seed=0)
        init_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        what = f"{arch} {cfg.dtype}"
        shape = (f"{cfg.encoder_layers} + {cfg.num_layers} layers, "
                 f"{cfg.encoder_frames} frames" if cfg.is_encoder_decoder
                 else f"{cfg.num_layers} layers, {cfg.num_prefix_tokens} "
                 f"patches of {fe.VISION_WIDTH} projected")
        log(f"{what}: {tree_bytes(params) / 2**30:.2f} GiB of weights, "
            f"{shape}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.resolved_head_dim}, d_model {cfg.d_model}, d_ff "
            f"{cfg.d_ff} ({cfg.mlp_kind}), {cfg.pos_kind} positions, vocab "
            f"{cfg.vocab_size}")
        prompts = smoke_workload(cfg.vocab_size)
        embeds = fe.fake_embeds(cfg, len(prompts), cfg.dtype, seed=1,
                                device=device)
        counts = {"prefill": [], "decode": []}
        secs = []
        frontend_run(torch, model, params, prompts[:1], embeds[:1],
                     2)                                         # warm-up
        got = frontend_run(torch, model, params, prompts, embeds,
                           FRONTEND_NEW, counts=counts, step_secs=secs)
        want_pre, want_dec = frontend_launches(cfg)
        for kind, want in (("prefill", want_pre), ("decode", want_dec)):
            for c in counts[kind]:
                assert c == {k: want.get(k, 0) for k in c}, (kind, c, want)
                for k, n in c.items():
                    launches[k] += n
        with plain_ops(ops, ref):
            plain = frontend_run(torch, model, params, prompts, embeds,
                                 FRONTEND_NEW, teacher=got[2])
        rel_pre = _rel_err(torch, got[0], plain[0])
        rel_dec = _rel_err(torch, got[1], plain[1])
        # the plain versions' greedy choice at each step against the
        # kernels' token there; the kernels' top-2 margin at each row's
        # first flip
        choice = torch.cat([plain[0][None], plain[1][:-1]]).argmax(-1)
        agree = choice == got[2]
        margins = []
        for row in range(len(prompts)):
            bad = (~agree[:, row]).nonzero()
            if len(bad):
                t = int(bad[0])
                lg = (got[0] if t == 0 else got[1][t - 1])[row].float()
                top = torch.topk(lg, 2).values
                margins.append((row, t, (top[0] - top[1]).item()))
        log(f"model {what} kernels vs plain, {len(prompts)} prompts of "
            f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
            f"{FRONTEND_NEW} greedy steps: prefill rel_err={rel_pre:.3e} "
            f"decode rel_err={rel_dec:.3e}; tokens the plain versions "
            f"choose alike {int(agree.sum())} of {agree.numel()}, first "
            f"flips (row, step, kernels' top-2 margin): {margins}; launches "
            f"a prefill {counts['prefill'][0]}, a decode step "
            f"{counts['decode'][0]}")
        assert max(rel_pre, rel_dec) <= MODEL_TOL["bfloat16"], \
            (rel_pre, rel_dec)
        assert torch.isfinite(got[1]).all()
        step = statistics.median(secs)
        lap(f"{arch} prompts, kernels and plain")

        with torch.inference_mode():
            toks = torch.from_numpy(prompts[0][None]).to(device)
            batch = {"tokens": toks, "embeds": embeds[:1]}
            ops.reset_launch_counts()
            logits = model.forward(params, batch)
            fwd_counts = ops.launch_counts()
            train_logits, _ = model.forward_train(params, batch)
        rel = _rel_err(torch, logits, train_logits)
        log(f"model {what}: Model.forward (launches {fwd_counts}) against "
            f"forward_train (q-chunked, no kernel) over a "
            f"{len(prompts[0])}-token prompt: rel_err {rel:.3e}")
        assert rel <= MODEL_TOL["bfloat16"], rel
        assert fwd_counts == {k: want_pre.get(k, 0) for k in fwd_counts}
        del logits, train_logits
        log(f"{what}: median decode step over the batch of "
            f"{len(prompts)}: {1e3 * step:.2f} ms (first "
            f"{1e3 * secs[0]:.2f}, {smi}); memory high-water (torch.cuda."
            f"max_memory_allocated): drawing the weights "
            f"{init_peak / 2**30:.2f} GiB, the prompts, decode and "
            f"forwards {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del model, params, embeds, got, plain
        lap(f"{arch} forward against forward_train")

        rel_pre, rel_dec = frontend_card_vs_cpu(torch, device, Model, fe,
                                                arch)
        log(f"model {arch} reduced float32, card (kernels) vs CPU (plain "
            f"versions), 2 prompts and 4 greedy tokens: prefill rel_err="
            f"{rel_pre:.3e} decode rel_err={rel_dec:.3e}, tokens identical")
        assert max(rel_pre, rel_dec) <= MODEL_TOL["float32"], \
            (rel_pre, rel_dec)
        lap(f"{arch} reduced float32 card vs CPU")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------- MoE, mamba


# phase 4f: the MoE and hybrid configs at their published widths, cut in
# depth to fit one card (bf16 weights: dbrx 26.6 GiB at 4 of 40 layers,
# grok 21.3 at 2 of 64, jamba 44.7 at 5 of 72: mamba, mamba + MoE, mamba,
# mamba + MoE, attention), one after another; the engine modes each runs
MOE_CONFIGS = (("dbrx-132b", 4, ("on", "slot")),
               ("grok-1-314b", 2, ("on",)),
               ("jamba-1.5-large-398b", 5, ("on", "off", "slot")))


def perturb_mamba(torch, params, seed):
    """Draw the mamba leaves that the init (as the reference's) sets to
    constants, in place: ``dt_bias`` (zeros) N(-1, 0.5), ``a_log`` (ones)
    N(0, 1), so that step sizes and decays differ by channel."""
    gen = None

    def walk(node):
        nonlocal gen
        for key in sorted(node):
            leaf = node[key]
            if isinstance(leaf, dict):
                walk(leaf)
            elif key in ("dt_bias", "a_log"):
                gen = gen or torch.Generator(device=leaf.device).manual_seed(
                    seed)
                new = torch.randn(leaf.shape, generator=gen,
                                  device=leaf.device)
                leaf.copy_(new * 0.5 - 1.0 if key == "dt_bias" else new)

    walk(params)
    return params


def check_launches(cfg, mode, counts, d, run, stats):
    """Exact launches of one engine run: each dispatch launches each
    mamba layer's ``ssm_scan`` once and each attention layer's kernel
    once (fused and prefill dispatches ``paged_prefill``, fusion-off
    decode dispatches ``paged_attention``; the slot engine's admissions
    ``flash_attention``, its decode steps ``paged_prefill``)."""
    kinds = cfg.kinds_for_layers
    mamba, attn = kinds.count("mamba"), kinds.count("attn")
    if mode == "slot":
        steps, adm = run["steps"], stats["admissions"]
        want = {"ssm_scan": mamba * steps, "flash_attention": attn * adm,
                "paged_prefill": attn * (steps - adm),
                "paged_prefill_pool": 0, "paged_attention": 0}
    else:
        want = {"ssm_scan": mamba * (d["prefill_paged"]
                                     + d["decode_step_paged"]),
                "paged_prefill": 0,
                "paged_prefill_pool": attn * d["prefill_paged"],
                "paged_attention": attn * d["decode_step_paged"],
                "flash_attention": 0}
        if mode == "on":
            assert d == {"prefill_paged": run["steps"],
                         "decode_step_paged": 0}, d
    got = {k: counts[k] for k in want}
    assert got == want, (mode, got, want)
    assert counts["rwkv6_scan"] == 0, counts


def moe_config(torch, device, ops, ref, serve, Model, ragged_dispatch,
               write_slot, validate, sync, smi, arch, depth, modes) -> dict:
    """Phase 4f for one config (``MOE_CONFIGS``).  -> launch counts
    summed over its engine runs."""
    from repro_torch.configs.base import get_config

    launches = dict.fromkeys(ops.launch_counts(), 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_config(arch), num_layers=depth)
    model = Model(cfg, device=device)
    params = perturb_mamba(torch, model.init(seed=0), seed=1)
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    what = (f"{arch} {cfg.dtype} {depth} layers (cut from "
            f"{get_config(arch).num_layers})")
    sigs = [("mamba" if k == "mamba" else "attn")
            + ("+MoE" if cfg.layer_is_moe(i) else "")
            for i, k in enumerate(cfg.kinds_for_layers)]
    log(f"moe {what}: {tree_bytes(params) / 2**30:.2f} GiB of weights, "
        f"layers {sigs}, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok} ({cfg.mlp_kind}, d_ff {cfg.d_ff}, "
        f"capacity factor {cfg.moe_capacity_factor}), "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.resolved_head_dim}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}, {cfg.norm_kind}, pos {cfg.pos_kind}")
    mamba = "mamba" in cfg.kinds_for_layers
    for path, rel in (
            ("paged", model_parity(torch, device, model, params, ops,
                                   ref, ragged_dispatch)),
            ("slot", slot_model_parity(torch, device, model, params,
                                       ops, ref, write_slot))):
        log(f"model {what} {path} path, kernels vs plain: prefill "
            f"rel_err={rel['prefill']:.3e} decode "
            f"rel_err={rel['decode']:.3e}"
            + (" (a reading: the gate holds routing, below)" if mamba
               else ""))
        if not mamba:
            assert max(rel.values()) <= MODEL_TOL["bfloat16"], (path, rel)
    if mamba:
        # the gate where mamba layers feed the routers: the scan's
        # rounding-level differences flip near-tie routers' choices
        # (jamba's free prefill reading is ~6x its routing-held one;
        # PERF.md §6), so the kernel arm takes the plain arm's experts and
        # gates and is held to MODEL_TOL so
        pin = PinnedRouting(ops, ref)
        for path, rel in (
                ("paged", model_parity(
                    torch, device, model, params, ops, ref, ragged_dispatch,
                    arms=(("plain", pin.plain), ("kernel", pin.kernel)))),
                ("slot", slot_model_parity(
                    torch, device, model, params, ops, ref, write_slot,
                    arms=(pin.plain, pin.kernel)))):
            log(f"model {what} {path} path, kernels vs plain with the "
                f"plain path's routing: prefill rel_err="
                f"{rel['prefill']:.3e} decode rel_err={rel['decode']:.3e}")
            assert max(rel.values()) <= MODEL_TOL["bfloat16"], (path, rel)
        assert not pin.seen, "routing recorded and not taken back"
    # a reading beside the gate: the same weights under dropless capacity,
    # where a routing flip drops no later token of its row
    dropless = Model(dataclasses.replace(
        cfg, moe_capacity_factor=cfg.num_experts / cfg.num_experts_per_tok),
        device=device)
    rel = model_parity(torch, device, dropless, params, ops, ref,
                       ragged_dispatch)
    log(f"model {what} paged path at dropless capacity (a reading, no "
        f"limit), kernels vs plain: prefill rel_err={rel['prefill']:.3e} "
        f"decode rel_err={rel['decode']:.3e}")
    if "mamba" in cfg.kinds_for_layers:
        # another reading: the kernels with the scan taken in float64
        # (nearer the exact scan than either float32 version) against the
        # plain path, so what rounding-level differences in the scan alone
        # do to the logits, through the routers' near ties
        with mock.patch.object(ops, "ssm_scan", float64_ssm_scan(ref)):
            rel = model_parity(torch, device, model, params, ops, ref,
                               ragged_dispatch)
        log(f"model {what} paged path with the scan in float64 (a reading, "
            f"no limit), vs plain: prefill rel_err={rel['prefill']:.3e} "
            f"decode rel_err={rel['decode']:.3e}")

    prompts = smoke_workload(cfg.vocab_size)
    for mode in modes:
        if mode == "slot":
            a = serve.make_parser().parse_args(SLOT_ARGV)
            a.arch = arch
        else:
            a = mode_args(serve, arch=arch, decode_fusion=mode)
        run_engine(serve.build_engine(a, model, params), prompts[:2], 2,
                   sync)                                  # warm-up
        engine = serve.build_engine(a, model, params)
        run = {}
        peak = [0]

        def note(engine=engine, peak=peak):
            peak[0] = max(peak[0], engine.stats().get(
                "state_slots_used", 0))

        ops.reset_launch_counts()
        with counting_dispatches(model) as d:
            outs, secs = run_engine(engine, prompts, a.max_new, sync,
                                    run, after_step=note)
        counts = ops.launch_counts()
        for k, n in counts.items():
            launches[k] += n
        stats = validate(engine.stats())
        ntok = sum(len(t) for t in outs.values())
        log(f"engine {what} "
            f"{'slot' if mode == 'slot' else 'decode_fusion=' + mode}: "
            f"{len(outs)} requests, {ntok} tokens in {secs:.3f}s "
            f"({ntok / secs:.1f} tok/s; {smi}), {run['steps']} steps, "
            f"preemptions={stats['preemptions']} "
            f"admissions={stats['admissions']} state_slots_used peak "
            f"{peak[0]} dispatches={dict(d)} launches={counts}")
        assert len(outs) == len(prompts)
        assert all(len(t) == a.max_new for t in outs.values())
        check_launches(cfg, mode, counts, d, run, stats)
        if mode != "slot" and "mamba" in cfg.kinds_for_layers:
            assert peak[0] >= 2 and stats["prefix_cache"] == 0
    if "mamba" in cfg.kinds_for_layers:
        a = mode_args(serve, arch=arch, decode_fusion="on")
        engine = serve.build_engine(a, model, params)
        secs, busy, rows = profile_engine(torch, lambda: run_engine(
            engine, prompts, a.max_new, sync)[1])
        log(f"profile engine {what} decode_fusion=on: wall {secs:.3f}s "
            f"under the profiler, device busy {busy:.3f}s "
            f"({100 * busy / secs:.1f}%)")
        for us, n, key in rows[:12]:
            log(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:90]}")
        # cuBLAS's GEMMs on Hopper run as ``nvjet_*`` kernels
        for label, pats in (("ssm_scan", ("ssm_scan",)),
                            ("paged_prefill", ("paged_prefill",)),
                            ("GEMMs (cuBLAS nvjet / gemm)",
                             ("nvjet", "gemm"))):
            sel = [r for r in rows if any(p in r[2].lower() for p in pats)]
            log(f"  {label}: {sum(r[0] for r in sel) / 1e3:.2f} ms in "
                f"{sum(r[1] for r in sel)} launches "
                f"({100 * sum(r[0] for r in sel) / max(busy * 1e6, 1):.1f}"
                f"% of busy)")
    log(f"moe {what}: memory high-water mark (torch.cuda."
        f"max_memory_allocated; {smi}) while drawing the weights "
        f"{init_peak / 2**30:.2f} GiB (each leaf drawn in float32), "
        f"then through parity and the engines "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def moe_phase(torch, device, ops, ref, serve, Model, ragged_dispatch,
              write_slot, validate, sync, smi) -> tuple:
    """Phase 4f: dbrx-132b, grok-1-314b and jamba-1.5-large-398b, cut in
    depth, every width published, bf16, seeded weights (mamba's constant
    leaves drawn): model parity kernels vs plain on the paged and slot
    paths; the serve path's engines on the smoke prompts with exact
    launches per dispatch, tokens/s, steps, preemptions, the peak of
    ``state_slots_used``, memory high-water marks; a profile of jamba's
    fused engine; then the reduced configs in float32 under dropless
    capacity: paged fusion on and off and slot emit the same tokens.
    -> launch counts summed over its bf16 engine runs."""
    from repro_torch.configs.base import get_config

    launches = dict.fromkeys(ops.launch_counts(), 0)
    for arch, depth, modes in MOE_CONFIGS:
        # one config at a time: its weights die with the call's frame
        for k, n in moe_config(torch, device, ops, ref, serve, Model,
                               ragged_dispatch, write_slot, validate, sync,
                               smi, arch, depth, modes).items():
            launches[k] += n
        gc.collect()
        torch.cuda.empty_cache()

    # float32 identity at the reduced configs under dropless capacity
    for arch, _, _ in MOE_CONFIGS:
        red = get_config(arch).reduced()
        red = dataclasses.replace(
            red, moe_capacity_factor=red.num_experts / red.num_experts_per_tok)
        small = Model(red, device=device)
        small_params = perturb_mamba(torch, small.init(seed=0), seed=1)
        work = smoke_workload(red.vocab_size)
        tokens = {}
        for mode in ("on", "off", "slot"):
            if mode == "slot":
                a = serve.make_parser().parse_args(SLOT_ARGV)
                a.arch = arch
            else:
                a = mode_args(serve, arch=arch, decode_fusion=mode)
            tokens[mode], _ = run_engine(serve.build_engine(a, small,
                                                            small_params),
                                         work, a.max_new, sync)
        assert tokens["on"] == tokens["off"] == tokens["slot"], arch
        log(f"engine {red.name} float32 dropless: paged fusion on/off and "
            f"slot token-identical ({sum(map(len, tokens['on'].values()))} "
            f"tokens)")
        del small, small_params
    return launches


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


# ---------------------------------------------------------------- training


def assert_wgrad_close(torch, got, want, dtype_name) -> float:
    """``WGRAD_TOL`` -> max abs error."""
    tol = WGRAD_TOL[dtype_name]
    scale = want.float().abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                               atol=tol["scaled_atol"] * scale)
    return (got.float() - want.float()).abs().max().item()


def wgrad_parity(torch, device, ops, ref) -> float:
    """Phase 6b: ``conv2d_wgrad`` against its plain version over
    ``CONV_SHAPES``, the training step's B=64 and 320, in float32 and
    bfloat16 (inputs as ``conv2d_parity`` draws them, dy N(0, 1)); a
    second launch must give the same bits; then ``ops.conv2d``'s dx and
    dw against autograd through ``conv2d_ref``.  -> max abs error of the
    kernel over the float32 cases."""
    gen = torch.Generator(device=device).manual_seed(6)
    worst = 0.0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for b, h, w, cin, k, cout in CONV_SHAPES + ((64, 28, 28, 1, 3, 32),
                                                    (320, 28, 28, 1, 3, 32)):
            draw = torch.rand if (h, cin, k) == (28, 1, 3) else torch.randn
            x = draw(b, h, w, cin, generator=gen, device=device).to(dtype)
            dy = torch.randn(b, h - k + 1, w - k + 1, cout, generator=gen,
                             device=device).to(dtype)
            out = ops.conv2d_wgrad(x, dy, k, k)
            again = ops.conv2d_wgrad(x, dy, k, k)
            plain = ref.conv2d_wgrad_ref(x, dy, k, k)
            torch.cuda.synchronize()
            assert torch.equal(out, again), "conv2d_wgrad repeat differs"
            err = assert_wgrad_close(torch, out, plain, dtype_name)
            log(f"parity conv2d_wgrad {dtype_name} x ({b},{h},{w},{cin}) dy "
                f"({b},{h - k + 1},{w - k + 1},{cout}): max_abs_err="
                f"{err:.3e} (max |dw| {plain.float().abs().max().item():.1f}"
                "), repeat bit-identical")
            if dtype_name == "float32":
                worst = max(worst, err)
            # the autograd Function's gradients, kernels vs plain path
            wt = (torch.randn(k, k, cin, cout, generator=gen, device=device)
                  * 0.2).to(dtype)
            grads = []
            for fn in (ops.conv2d, ref.conv2d_ref):
                xg, wg = x.clone().requires_grad_(), wt.clone().requires_grad_()
                fn(xg, wg).backward(dy)
                grads.append((xg.grad, wg.grad))
            torch.cuda.synchronize()
            errs = [assert_wgrad_close(torch, got, want, dtype_name)
                    for got, want in zip(*grads)]
            log(f"  autograd Function vs plain autograd: dx max_abs_err "
                f"{errs[0]:.3e}, dw {errs[1]:.3e}")
    return worst


def pool_routing(torch, cfg, params, images):
    """The element each 2x2 max-pool window of the CNN picks, and the gap
    between its top two values (the kernel path's conv)."""
    from repro_torch.models.cnn import conv2d_valid

    with torch.inference_mode():
        y = torch.relu(conv2d_valid(images, params["conv_w"])
                       + params["conv_b"])
    b, h, w, c = y.shape
    p = cfg.pool
    win = (y[:, : h - h % p, : w - w % p, :]
           .reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
           .reshape(b, h // p, w // p, c, p * p))
    top2 = win.topk(2, -1).values
    return win.argmax(-1), top2[..., 0] - top2[..., 1]


def model_gradients(torch, device, ops, ref):
    """Phase 6b: ``cnn_loss``'s gradients for the six parameters at B=64,
    through the kernels and through the plain versions, on seeded weights
    with drawn biases."""
    from repro_torch.configs.mnist_cnn import CONFIG
    from repro_torch.models.cnn import cnn_loss, cnn_schema
    from repro_torch.models.module import init_params

    gen = torch.Generator(device=device).manual_seed(7)
    params = init_params(cnn_schema(CONFIG), 7, "float32", device)
    for name in ("conv_b", "dense1_b", "dense2_b"):
        params[name] = torch.randn(params[name].shape, generator=gen,
                                   device=device) * 0.1
    x = torch.rand(64, 28, 28, 1, generator=gen, device=device)
    labels = torch.randint(0, 10, (64,), generator=gen, device=device,
                           dtype=torch.int32)
    grads = {}
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_ops(ops, ref))):
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        with ctx:
            loss, _ = cnn_loss(leaves, CONFIG, x, labels)
            loss.backward()
            routing = pool_routing(torch, CONFIG, params, x)
        grads[name] = ({k: v.grad for k, v in leaves.items()}, routing,
                       loss.item())
    (kg, (kr, _), kl), (pg, (pr, gap), pl) = grads["kernel"], grads["plain"]
    moved = kr != pr
    assert bool((gap[moved] < GRAD_TIE_MARGIN).all()), "pool routing"
    errs = {k: _rel_err(torch, kg[k], pg[k]) for k in params}
    log(f"model mnist-cnn cnn_loss gradients B=64, kernels vs plain: loss "
        f"{kl:.6f} / {pl:.6f}, pool windows routed apart "
        f"{int(moved.sum())} (each within {GRAD_TIE_MARGIN}), relative L2 "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
    for k in params:
        if int(moved.sum()) == 0 or k.startswith("dense"):
            torch.testing.assert_close(kg[k], pg[k], **GRAD_TOL)


def training_phase(torch, device, ops, ref, smi) -> tuple:
    """Phase 6b: the paper's digit pipeline trained on the card.  -> (max
    abs error of ``conv2d_wgrad`` vs plain in float32, {kernel: launches}
    of the budget run)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.pipeline import StratusPipeline
    from repro_torch.data import mnist

    err = wgrad_parity(torch, device, ops, ref)
    model_gradients(torch, device, ops, ref)

    # kernels vs plain versions, 4 sync rounds from one seed
    hist = {}
    for name, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_ops(ops, ref))):
        with ctx:
            res = StratusPipeline(seed=0, device=device).train(
                train_n=TRAIN_BUDGET["train_n"], rounds=4)
        hist[name] = [h["loss"] for h in res["history"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(hist["kernel"],
                                               hist["plain"])]
    log(f"train sync 4 rounds, loss kernels {hist['kernel']} plain "
        f"{hist['plain']}: worst relative difference {max(rel):.2e}")
    assert max(rel) <= TRAIN_LOSS_RTOL, rel

    # the paper's budget, sync over 5 workers
    with tempfile.TemporaryDirectory() as root:
        pipe = StratusPipeline(seed=0, device=device, ckpt_dir=root)
        ops.reset_launch_counts()
        res = pipe.train(**TRAIN_BUDGET)
        ev = pipe.evaluate()
        counts = ops.launch_counts()
        with plain_ops(ops, ref):
            ev_plain = pipe.evaluate()
        last = res["history"][-1]["loss"]
        log(f"train sync 5 workers {TRAIN_BUDGET}: {res['seconds']:.3f}s, "
            f"last loss {last:.4f}, test accuracy "
            f"{ev['test_accuracy']:.4f}, canvas {ev['canvas_accuracy']:.4f} "
            f"(plain path on the same weights: test "
            f"{ev_plain['test_accuracy']:.4f}, canvas "
            f"{ev_plain['canvas_accuracy']:.4f}); launches conv2d="
            f"{counts['conv2d']} conv2d_wgrad={counts['conv2d_wgrad']} | "
            f"{smi}")
        steps = (pipe.num_workers * TRAIN_BUDGET["rounds"]
                 * TRAIN_BUDGET["steps_per_round"])
        assert counts["conv2d"] == steps + 2, counts
        assert counts["conv2d_wgrad"] == steps, counts
        assert ev["test_accuracy"] >= TRAIN_MIN_ACCURACY, ev
        served = StratusPipeline(seed=1, device=device)
        step, tree = CheckpointManager(root).restore_latest(
            {"params": served.params})
    assert step == TRAIN_BUDGET["rounds"]
    for name, t in tree["params"].items():
        assert torch.equal(t, pipe.params[name]), name
    served.params = tree["params"]
    images, labels = mnist.canvas_digits(20, seed=42)
    plain_digits, tie, _, _ = digit_predictions(torch, ops, ref, served,
                                                images)
    digits = served.predict_fn()(images).argmax(-1).tolist()
    log(f"  restored checkpoint, 20 canvas digits: {digits} (labels "
        f"{labels.tolist()})")
    assert all(d == p or t for d, p, t in zip(digits, plain_digits, tie))

    for strategy in ("local_sgd", "elastic"):
        pipe = StratusPipeline(seed=0, device=device, strategy=strategy)
        res = pipe.train(**STRATEGY_BUDGET)
        ev = pipe.evaluate(test_n=1_000, canvas_n=400)
        log(f"train {strategy} 5 workers {STRATEGY_BUDGET}: "
            f"{res['seconds']:.3f}s, last loss "
            f"{res['history'][-1]['loss']:.4f}, test accuracy "
            f"{ev['test_accuracy']:.4f}, canvas {ev['canvas_accuracy']:.4f}")
        assert ev["test_accuracy"] >= TRAIN_MIN_ACCURACY, (strategy, ev)
    del pipe, served
    torch.cuda.empty_cache()
    return err, counts


# ---------------------------------------------------------------- LLM training


# phase 6c: the LLM train CLI (``launch/train.py``) at qwen3-0.6b's
# published width, bf16, its defaults otherwise (batch 8, seq 128, a
# checkpoint every steps / 4) but 20 steps, not 100, for the script's
# time limit (LEARNING asks the last 5 losses' mean 0.2 under the first
# 5's; 12.14 -> 9.31 by step 20 on an H100)
TRAIN_ARGV = ["--arch", "qwen3-0.6b", "--no-reduced", "--steps", "20"]
# a run restarted from the step-15 checkpoint against the first run's
# losses at the same steps: its first step reads bit-equal weights and
# the same batch (a forward: no atomics); later steps follow weights
# that CUDA's embedding backward (atomic adds, in no fixed order) moved
# by rounding, which bf16 rounding of each update can widen to an ulp
RESUME_FIRST_ATOL = 1e-3
RESUME_ATOL = 2e-2
# 2 layers of qwen3-0.6b in float32, TF32 off, the card against the same
# port on the CPU: the loss, and each gradient leaf within this many times
# its max|g| (the CPU tests' tolerances against jax.value_and_grad)
TRAIN_LOSS_ATOL = 1e-5
TRAIN_GRAD_REL = 1e-4
# configs at their published widths cut in depth, a few steps each:
# (arch, layers, batch, seq, steps).  gemma3-4b's 6 layers are 5 windowed
# (1,024) and 1 global, and seq 2,048 makes two query chunks of 1,024
# that the window cuts across, at head_dim 256; dbrx-132b's one layer
# (4.5 B parameters, 16 experts) puts the router term in the loss;
# jamba-1.5-large-398b's first layer (a mamba layer and its dense MLP,
# 2.1 B parameters) runs ``ssm_scan`` and ``ssm_scan_bwd`` at d_inner
# 16,384 over 2,048 steps; whisper-tiny (4 + 4 layers, its encoder over
# 1,500 frames a row) and paligemma-3b (18 layers, 2.5 B parameters, 256
# patches before each row's 128 tokens) uncut, each step's frontend
# embeddings drawn from its own seed, as the CLI draws them
TRAIN_CUTS = (("gemma3-4b", 6, 2, 2048, 10), ("dbrx-132b", 1, 8, 128, 10),
              ("jamba-1.5-large-398b", 1, 2, 2048, 10),
              ("whisper-tiny", 4, 8, 128, 10),
              ("paligemma-3b", 18, 8, 128, 10))
# rwkv6-1.6b uncut through the CLI at its defaults but 20 steps (batch 8
# x seq 128): 24 rwkv6 layers, each a remat period of its own
RWKV_TRAIN_ARGV = ["--arch", "rwkv6-1.6b", "--no-reduced", "--steps", "20"]


def train_launches(cfg, steps: int) -> dict:
    """The kernel launches ``steps`` training steps of ``cfg`` make: per
    rwkv6 / mamba layer and step one backward scan, and one forward scan,
    or two in a remat period (recomputed in the backward pass); attention
    launches none (the q-chunked branch)."""
    from repro_torch.models import transformer

    p, n_per, _ = transformer.layout(cfg)
    want = {}
    for i, kind in enumerate(transformer.layer_kinds(cfg)):
        scan = {"rwkv6": "rwkv6_scan", "mamba": "ssm_scan"}.get(kind)
        if scan:
            fwd = 2 if i < p * n_per else 1
            want[scan] = want.get(scan, 0) + fwd * steps
            want[scan + "_bwd"] = want.get(scan + "_bwd", 0) + steps
    return want


def _loss_and_grads(torch, model, params, batch):
    """-> (loss, metrics, gradient leaves in ``tree_leaves`` order)."""
    from repro_torch.core.strategies import _value_and_grad
    from repro_torch.optim.optimizers import tree_leaves

    loss, metrics, grads = _value_and_grad(
        lambda p, b: model.loss(p, b), params, batch)
    return loss, metrics, tree_leaves(grads)


def _leaf_paths(tree, prefix=""):
    """The leaves' paths, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [q for k, v in tree.items()
                for q in _leaf_paths(v, f"{prefix}/{k}")]
    return [prefix]


def card_vs_cpu_gradients(torch, device, ops, cfg, label, seq,
                          perturb=False) -> dict:
    """``cfg`` (float32, TF32 off) on the card against the same port on
    the CPU, from one seed-0 draw (``perturb``: the rwkv6 leaves the init
    zeroes drawn) and the token stream's first batch of 2 rows: the loss
    within ``TRAIN_LOSS_ATOL`` and every gradient leaf within
    ``TRAIN_GRAD_REL`` x its max|g|; beside it, a reading of each run's
    leaves against the same weights in a float64 model on the CPU (a
    frontend config: with seeded embeddings of 2 rows, float64 in the
    float64 model).  -> the card run's launch counts."""
    from repro_torch.data.tokens import make_stream
    from repro_torch.models import frontend as fe
    from repro_torch.models.api import Model
    from repro_torch.optim.optimizers import tree_map

    cpu_model = Model(cfg, device="cpu")
    cpu_params = cpu_model.init(seed=0)
    if perturb:
        perturb_zero_init(torch, cpu_params, 1)
    card_model = Model(cfg, device=device)
    card_params = tree_map(lambda t: t.to(device), cpu_params)
    nb = make_stream(cfg.vocab_size, seq, 2, 0).batch(0)
    if cfg.frontend != "none":
        nb["embeds"] = fe.fake_embeds(cfg, 2, cfg.dtype, seed=0,
                                      device="cpu").numpy()
    secs = [time.perf_counter()]
    ops.reset_launch_counts()
    got = _loss_and_grads(torch, card_model, card_params,
                          {k: torch.from_numpy(v).to(device)
                           for k, v in nb.items()})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    secs.append(time.perf_counter())
    want = _loss_and_grads(torch, cpu_model, cpu_params,
                           {k: torch.from_numpy(v) for k, v in nb.items()})
    secs.append(time.perf_counter())
    # a reading of float32 rounding alone: the same weights in a float64
    # model on the CPU (every layer, scan and sum in float64), against
    # which the CPU's float32 run and the card's are each read
    exact = _loss_and_grads(
        torch, Model(dataclasses.replace(cfg, dtype="float64"),
                     device="cpu"),
        tree_map(lambda t: t.double(), cpu_params),
        {k: (torch.from_numpy(v).double() if k == "embeds"
             else torch.from_numpy(v)) for k, v in nb.items()})
    secs.append(time.perf_counter())

    # a leaf whose float64 gradient is 0 to 1e-9 of the largest leaf's
    # (whisper's self-attention ``bk``: it shifts every score of a query
    # alike) holds rounding noise on both sides: it is read against the
    # largest leaf's max|g|, every other leaf against its own
    top = max(e.abs().max().item() for e in exact[2])
    null = [e.abs().max().item() <= 1e-9 * top for e in exact[2]]

    def rel(a, b, i):
        return (a.cpu().double() - b.double()).abs().max().item() / max(
            top if null[i] else b.abs().max().item(), 1e-30)

    loss_diff = abs(float(got[0]) - float(want[0]))
    worst, leaf = max((rel(g, w, i), i)
                      for i, (g, w) in enumerate(zip(got[2], want[2])))
    cpu_err, cpu_leaf = max((rel(g, e, i), i)
                            for i, (g, e) in enumerate(zip(want[2],
                                                           exact[2])))
    card_err = max(rel(g, e, i)
                   for i, (g, e) in enumerate(zip(got[2], exact[2])))
    paths = _leaf_paths(cpu_params)
    log(f"train {label} float32, card vs CPU: loss {float(got[0]):.6f} vs "
        f"{float(want[0]):.6f} (|diff| {loss_diff:.2e}), worst gradient "
        f"leaf |diff| / max|g| {worst:.2e} ({paths[leaf]}) over "
        f"{len(want[2])} leaves; card launches "
        f"{({k: n for k, n in counts.items() if n})}")
    log(f"train {label} against float64 on the CPU (float32 rounding, a "
        f"reading): CPU float32 loss |diff| "
        f"{abs(float(want[0]) - float(exact[0])):.2e}, worst leaf "
        f"{cpu_err:.2e} ({paths[cpu_leaf]}), {paths[leaf]} "
        f"{rel(want[2][leaf], exact[2][leaf], leaf):.2e}; card worst leaf "
        f"{card_err:.2e}, {paths[leaf]} "
        f"{rel(got[2][leaf], exact[2][leaf], leaf):.2e}; seconds: card "
        f"{secs[1] - secs[0]:.1f}, CPU float32 {secs[2] - secs[1]:.1f}, CPU "
        f"float64 {secs[3] - secs[2]:.1f}")
    assert loss_diff <= TRAIN_LOSS_ATOL, loss_diff
    assert worst <= TRAIN_GRAD_REL, worst
    del card_params, got, exact
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def llm_training_phase(torch, device, ops, ref, smi) -> dict:
    """Phase 6c: LLM training through ``launch/train.py``'s path.
    qwen3-0.6b at its published width trains for ``TRAIN_ARGV``'s steps with
    every loss and grad norm finite, its LEARNING verdict, no kernel
    launched, the step-20 checkpoint restoring bit-equal weights and
    optimizer state and a restart from step 15 repeating the losses; the
    median step time and the memory high-water mark; its training
    forward's logits (q-chunked attention, no kernel) against
    ``Model.forward``'s (``flash_attention``); a profile of 3 steps; 2
    layers in float32, loss and every gradient leaf on the card against
    the CPU; rwkv6-1.6b uncut through the CLI at its defaults (the
    ``rwkv6_scan`` kernels forward, in the remat recompute and backward:
    launches exact, LEARNING); the card against the CPU at rwkv6's 2
    layers and jamba's reduced config (dropless) in float32; then
    gemma3-4b, dbrx-132b and jamba-1.5-large-398b at their published
    widths cut in depth, whisper-tiny and paligemma-3b uncut
    (``TRAIN_CUTS``), a few steps each, losses finite and falling,
    launches exact; the card against the CPU at whisper's and
    paligemma's reduced configs in float32.  -> the launches of the training runs
    (the CLI's and the cuts').  Each sub-step's seconds are logged."""
    import os
    import statistics

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.core.trainer import make_train_step
    from repro_torch.data.tokens import make_stream
    from repro_torch.launch import train
    from repro_torch.models.api import Model
    from repro_torch.optim.optimizers import tree_leaves

    def cli_log(line):
        log(f"  train: {line}")

    lap = lapper("6c")
    launches = dict.fromkeys(ops.launch_counts(), 0)

    def expect(cfg, steps, counts):
        want = train_launches(cfg, steps)
        assert counts == {k: want.get(k, 0) for k in counts}, (counts, want)
        for k, n in counts.items():
            launches[k] += n

    args = train.make_parser().parse_args(TRAIN_ARGV)
    cfg = train.config_for(args)
    with tempfile.TemporaryDirectory() as root:
        args.ckpt_dir = os.path.join(root, "run")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = train.run(args, log=cli_log)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        losses, gnorms = out["losses"], out["grad_norms"]
        median = statistics.median(out["step_seconds"])
        log(f"train qwen3-0.6b bf16 {cfg.num_layers} layers, batch "
            f"{args.batch} x seq {args.seq}, {args.steps} steps: median step "
            f"{1e3 * median:.1f} ms (first {1e3 * out['step_seconds'][0]:.1f}"
            f" ms), memory high-water {peak:.2f} GiB, loss {losses[0]:.4f} "
            f"-> {losses[-1]:.4f}, grad_norm {gnorms[0]:.3f} -> "
            f"{gnorms[-1]:.3f}, {out['verdict']}; launches {counts} | {smi}")
        assert len(losses) == len(gnorms) == args.steps
        assert all(map(math.isfinite, losses + gnorms)), (losses, gnorms)
        assert out["verdict"] == "LEARNING", out["verdict"]
        expect(cfg, args.steps, counts)
        lap(f"qwen3-0.6b {args.steps} steps")

        ckpt = CheckpointManager(args.ckpt_dir)
        step, tree = ckpt.restore_latest({"params": out["params"],
                                          "opt": out["opt_state"]})
        assert step == args.steps, step
        pairs = list(zip(tree_leaves(tree),
                         tree_leaves({"params": out["params"],
                                      "opt": out["opt_state"]})))
        assert all(torch.equal(a, b) for a, b in pairs)
        log(f"  checkpoint step {step} restored: {len(pairs)} leaves of "
            "params and optimizer state bit-equal")
        del tree, pairs
        mid = 3 * args.steps // 4
        resume = os.path.join(root, "resume")
        os.makedirs(resume)
        os.replace(ckpt.dir_for(mid), os.path.join(resume, f"step_{mid}"))
        shutil.rmtree(args.ckpt_dir)
        args.ckpt_dir = resume
        again = train.run(args, log=cli_log)
        assert again["start"] == mid, again["start"]
        diffs = [abs(a - b) for a, b in zip(again["losses"], losses[mid:])]
        log(f"  restarted from step {mid}: {len(diffs)} steps, first loss "
            f"{again['losses'][0]:.6f} against {losses[mid]:.6f} "
            f"(|diff| {diffs[0]:.2e}), largest |diff| {max(diffs):.2e}")
        assert len(diffs) == args.steps - mid
        assert diffs[0] <= RESUME_FIRST_ATOL, diffs
        assert max(diffs) <= RESUME_ATOL, diffs
        del again
        lap(f"qwen3-0.6b restore and restart from step {mid}")

    # the training forward against the draft's inference forward, on the
    # trained weights
    model = Model(cfg, device=device)
    params, opt_state = out["params"], out["opt_state"]
    del out
    stream = make_stream(cfg.vocab_size, args.seq, args.batch, args.seed)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in stream.batch(args.steps).items()}
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits, _ = model.forward_train(params, batch)
        train_counts = ops.launch_counts()
        ops.reset_launch_counts()
        draft = model.forward(params, batch)
        draft_counts = ops.launch_counts()
    rel = _rel_err(torch, logits, draft)
    log(f"train qwen3-0.6b bf16: forward_train logits (q-chunked, launches "
        f"{sum(train_counts.values())}) against Model.forward "
        f"(flash_attention x {draft_counts['flash_attention']}): rel_err "
        f"{rel:.3e}")
    assert rel <= MODEL_TOL["bfloat16"], rel
    assert not any(train_counts.values()), train_counts
    assert draft_counts["flash_attention"] == cfg.num_layers, draft_counts
    del logits, draft
    lap("qwen3-0.6b forward_train against Model.forward")

    # where a step's time goes: 3 more donated steps under the profiler
    step_fn = make_train_step(lambda p, b: model.loss(p, b),
                              train.optimizer_for(args), clip=1.0)

    def steps(n):
        nonlocal params, opt_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            float(metrics["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    steps(1)
    secs, busy, rows = profile_engine(torch, lambda: steps(3))
    log(f"profile train qwen3-0.6b bf16, 3 steps: wall {secs:.3f}s under "
        f"the profiler, device busy {busy:.3f}s ({100 * busy / secs:.1f}%), "
        f"{sum(r[1] for r in rows)} kernels")
    for us, n, key in rows[:8]:
        log(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:90]}")
    del model, params, opt_state, step_fn
    lap("qwen3-0.6b profile of 3 steps")

    # 2 layers, float32 (TF32 off): the card against the CPU
    card_vs_cpu_gradients(
        torch, device, ops, dataclasses.replace(cfg, num_layers=2,
                                                dtype="float32"),
        "qwen3-0.6b 2 layers", args.seq)
    lap("qwen3-0.6b 2 layers card vs CPU")

    # rwkv6-1.6b uncut through the CLI
    args = train.make_parser().parse_args(RWKV_TRAIN_ARGV)
    cfg = train.config_for(args)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.run(args, log=cli_log)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses, gnorms = out["losses"], out["grad_norms"]
    log(f"train rwkv6-1.6b bf16 {cfg.num_layers} layers, batch {args.batch} "
        f"x seq {args.seq}, {args.steps} steps: median step "
        f"{1e3 * statistics.median(out['step_seconds']):.1f} ms (first "
        f"{1e3 * out['step_seconds'][0]:.1f} ms), memory high-water "
        f"{peak:.2f} GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"grad_norm {gnorms[0]:.3f} -> {gnorms[-1]:.3f}, {out['verdict']}; "
        f"launches {({k: n for k, n in counts.items() if n})} | {smi}")
    assert len(losses) == len(gnorms) == args.steps
    assert all(map(math.isfinite, losses + gnorms)), (losses, gnorms)
    assert out["verdict"] == "LEARNING", out["verdict"]
    expect(cfg, args.steps, counts)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    lap(f"rwkv6-1.6b {args.steps} steps")

    # the scans' backward kernels inside Model.loss: the card against the
    # CPU at rwkv6's 2 layers and jamba's reduced config, float32
    jamba = get_config("jamba-1.5-large-398b").reduced()
    jamba = dataclasses.replace(
        jamba, moe_capacity_factor=jamba.num_experts
        / jamba.num_experts_per_tok)                    # dropless
    for small, label, seq in (
            (dataclasses.replace(cfg, num_layers=2, dtype="float32"),
             "rwkv6-1.6b 2 layers", args.seq),
            (jamba, "jamba-1.5-large-398b reduced (dropless)", args.seq),
            (get_config("whisper-tiny").reduced(), "whisper-tiny reduced",
             args.seq),
            (get_config("paligemma-3b").reduced(), "paligemma-3b reduced",
             args.seq)):
        counts = card_vs_cpu_gradients(torch, device, ops, small, label, seq,
                                       perturb=True)
        want = train_launches(small, 1)
        assert counts == {k: want.get(k, 0) for k in counts}, (counts, want)
        lap(f"{label} card vs CPU")

    for arch, layers, b, s, steps in TRAIN_CUTS:
        full = get_config(arch)
        cut = dataclasses.replace(full, num_layers=layers)
        a = train.make_parser().parse_args(
            ["--arch", arch, "--no-reduced", "--batch", str(b), "--seq",
             str(s), "--steps", str(steps), "--log-every", "1"])
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = train.run(a, cfg=cut, log=cli_log)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ls = res["losses"]
        depth = (f"uncut ({layers} layers"
                 + (f" + {full.encoder_layers} encoder layers"
                    if full.is_encoder_decoder else "") + ")"
                 if layers == full.num_layers else
                 f"cut to {layers} of {full.num_layers} layers "
                 f"({', '.join(cut.kinds_for_layers)})")
        log(f"train {arch} bf16 at its published widths, {depth}, "
            f"batch {b} x seq {s}, {steps} steps: median step "
            f"{1e3 * statistics.median(res['step_seconds']):.1f} ms, memory "
            f"high-water {peak:.2f} GiB, loss {ls[0]:.4f} -> {ls[-1]:.4f}, "
            f"router loss {res['aux'][0]:.4f} -> {res['aux'][-1]:.4f}; "
            f"launches {({k: n for k, n in counts.items() if n})} | {smi}")
        assert all(map(math.isfinite, ls + res["grad_norms"])), ls
        assert ls[-1] < ls[0], ls
        expect(cut, steps, counts)
        if any(cut.layer_is_moe(i) for i in range(layers)):
            assert min(res["aux"]) > 0, res["aux"]
        del res
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"{arch} {layers} layers {steps} steps")
    return launches


# ---------------------------------------------------------------- timing


PHASE8_PREFILL = (8, 2048)          # rows x tokens of the timed prefill


def roofline_phase(torch, device, Model, smi) -> dict:
    """8. The dry-run (``launch/dryrun.py``) and the roofline of a whole
    step.  qwen3-0.6b train_4k as rank 0 of the (16, 16) production mesh
    under ``tp``, on a fake process group in this process (shapes only,
    on the host): its per-device memory and roofline terms.  Then
    qwen3-0.6b's whole-prompt prefill at full width in bf16 on the card
    (8 x 2,048 tokens, ``flash_attention`` in every layer), the median of
    5 timed calls after a warm-up, held against the assembled per-device
    FLOPs and bytes of the same shape on a (1, 1) fake mesh: its share of
    bf16 peak; then one prefill under the profiler (device time by
    kernel, busy share).  -> the numbers logged."""
    import statistics

    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    lap = lapper("8")
    res = dryrun.run_combo("qwen3-0.6b", "train_4k", variant="tp",
                           with_cost=True, verbose=False)
    mem, terms = res["memory"], res["assembled"]["terms"]
    per = res["assembled"]["per_device"]
    log(f"dry-run qwen3-0.6b train_4k {res['mesh']} {res['variant']} "
        f"(fake process group, rank 0): argument {mem['argument_gib']:.3f} "
        f"GiB, output {mem['output_gib']:.3f} GiB, peak "
        f"{mem['peak_gib']:.3f} GiB, fits {mem['fits']}; per device "
        f"{per['flops']:.4e} FLOPs, {per['bytes']:.4e} bytes (unfused), "
        f"collectives {res['assembled']['coll_by_kind']}; compute "
        f"{terms['compute_s'] * 1e3:.3f} ms, memory "
        f"{terms['memory_s'] * 1e3:.3f} ms, collective "
        f"{terms['collective_s'] * 1e3:.3f} ms, dominant "
        f"{terms['dominant']}; useful ratio "
        f"{res['assembled']['useful_ratio']:.4f}; lowered in "
        f"{res['lower_seconds']} s")
    assert mem["argument_gib"] > 0 and mem["peak_gib"] > 0
    assert terms["compute_s"] > 0 and res["assembled"]["useful_ratio"] > 0
    lap("dry-run qwen3-0.6b train_4k")

    b, s = PHASE8_PREFILL
    shape = InputShape(f"prefill_{b}x{s}", s, b, "prefill")
    cfg = get_config("qwen3-0.6b")
    one = make_mesh((1, 1), ("data", "model"))
    asm = dryrun.assemble_cost(Model(cfg, "cpu"), shape, one, "tp")
    whole = dryrun.lower_step(Model(cfg, "cpu"), shape, one, "tp")
    dist.destroy_process_group()
    lap("assembled cost of the prefill on (1, 1)")

    model = Model(cfg, device)
    params = model.init(seed=0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=device, dtype=torch.int32)
    secs = []
    with torch.inference_mode():
        logits, _ = model.prefill(params, {"tokens": tokens}, cache_max=s)
        assert logits.shape == (b, 1, cfg.vocab_size)
        assert bool(torch.isfinite(logits.float()).all())
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            model.prefill(params, {"tokens": tokens}, cache_max=s)
            e1.record()
            torch.cuda.synchronize()
            secs.append(e0.elapsed_time(e1) / 1e3)
    med = statistics.median(secs)
    flops, nbytes = asm["per_device"]["flops"], asm["per_device"]["bytes"]
    t = asm["terms"]
    out = {"seconds": med, "flops": flops, "bytes": nbytes,
           "compute_s": t["compute_s"], "memory_s": t["memory_s"],
           "share_of_bf16_peak": flops / med / PEAK_FLOPS["bfloat16"],
           "whole_step_flops": whole.cost["flops"]}
    log(f"roofline qwen3-0.6b prefill {b}x{s} bf16 on {smi}: measured "
        f"{med * 1e3:.3f} ms (median of 5: "
        f"{', '.join(f'{x * 1e3:.3f}' for x in secs)}); assembled "
        f"{flops:.4e} FLOPs, {nbytes:.4e} bytes (unfused) -> compute "
        f"{t['compute_s'] * 1e3:.3f} ms, memory {t['memory_s'] * 1e3:.3f} "
        f"ms at the datasheet rates; share of bf16 peak "
        f"{out['share_of_bf16_peak']:.4f} (the whole step's own count, "
        f"which unembeds the last token only: {whole.cost['flops']:.4e} "
        f"FLOPs, {whole.cost['flops'] / med / PEAK_FLOPS['bfloat16']:.4f}); "
        f"useful ratio {asm['useful_ratio']:.4f}")
    lap("timed prefill")

    def one_prefill():
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.prefill(params, {"tokens": tokens}, cache_max=s)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall, busy, rows = profile_engine(torch, one_prefill)
    log(f"profile qwen3-0.6b prefill {b}x{s} bf16: wall {wall:.4f}s under "
        f"the profiler, device busy {busy:.4f}s "
        f"({100 * busy / wall:.1f}%), {sum(r[1] for r in rows)} kernels")
    for us, n, key in rows[:8]:
        log(f"  {us / 1e3:9.3f} ms {n:6d}x  {key[:90]}")
    out["busy_share"] = busy / wall
    del model, params, tokens, logits
    gc.collect()
    torch.cuda.empty_cache()
    lap("profile of one prefill")
    return out


def profile_engine(torch, run):
    """Device time by kernel over one engine run under torch.profiler.
    -> (wall seconds under the profiler, device-busy seconds,
    [(device us, launches, kernel name)] largest first)."""
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the rows are kernels, and host-op events (every
    # eager op of an engine run) cost tens of seconds to fold up
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


GRAPH_PAIRS = 50              # (flush, fn) pairs in one captured graph
GRAPH_REPLAYS = 7


def graph_ms(torch, fn, n=GRAPH_PAIRS, replays=GRAPH_REPLAYS):
    """Device time of one ``fn`` from CUDA-graph replay: ``n`` pairs of
    (L2 flush, ``fn``) captured into one graph, minus a graph of the same
    ``n`` flushes alone, over ``n``; the median of ``replays`` replays of
    each, taken in turns.  The capture runs on the stream the warm-up
    ran on, so per-stream state a kernel keeps (``conv2d_wgrad``'s ticket
    counter) is made before it, not inside the graph.  No host launch
    and no event lies between the pairs, so this reads below
    ``time_ms``'s floor: what remains beside the device work is the
    graph's own gap between nodes, which the floor row (one launch on one
    element) shows."""
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up, as capture asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graphs = []
    for with_fn in (True, False):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            for _ in range(n):
                flush.zero_()
                if with_fn:
                    fn()
        graphs.append(g)
    times = ([], [])
    for _ in range(replays):
        for g, acc in zip(graphs, times):
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            acc.append(start.elapsed_time(end))
    med = [sorted(t)[len(t) // 2] for t in times]
    del graphs
    return (med[0] - med[1]) / n


def sdpa_backend(torch, q, k, v, mask=None, causal=False) -> str:
    """The backend ``sdpa`` runs on these inputs: SDPA's own choice
    function (flash, memory-efficient, cuDNN or math)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, attn_mask=mask, dropout_p=0.0, is_causal=causal,
        enable_gqa=True)).name


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


# forced piece lengths of paged_attention's block tables (table width:
# blocks per piece), at most 8 pieces: decode_case's 32 blocks and the
# fusion-off engine's 16
PIECE_SWEEP = {32: (4, 8, 11, 14, 16, 32), 16: (2, 4, 7, 8, 16)}


def piece_sweep(torch, device, ops, pa_mod):
    """paged_attention in bf16 at decode_case's rows with each piece
    length of ``PIECE_SWEEP`` forced -> {(table width, blocks per piece):
    ms}, what the planner's constants are read from (``fit_planner``).
    Its own generator, so the other rows keep their inputs."""
    gen = torch.Generator(device=device).manual_seed(5)
    sweep = {}
    for nb, lengths in PIECE_SWEEP.items():
        args = decode_case(torch, gen, device, torch.bfloat16, nb=nb)
        for c in lengths:
            with mock.patch.object(pa_mod, "plan", lambda b, kv, n, s, c=c:
                                   pa_mod.Plan(c, -(-n // c))):
                sweep[nb, c] = time_ms(torch,
                                       lambda: ops.paged_attention(*args))
    return sweep


def fit_planner(sweep, split, b=8, kv=8, sms=132):
    """Least-squares fit of the makespan model (``attention_split.makespan``
    in block times, over a grid of its three constants, time = base + tau
    x makespan) to a piece sweep -> (residual ms, fixed, combine,
    ctas_per_sm, tau ms, base ms), the best first."""
    fits = []
    for fixed in range(1, 25):
        for combine in range(21):
            for per_sm in (1.0, 1.25, 1.5, 2.0, 3.0):
                xs = [split.makespan([nb], c, b * kv, sms, fixed=fixed,
                                     combine=combine, ctas_per_sm=per_sm)
                      for nb, c in sweep]
                ys = list(sweep.values())
                mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
                sxx = sum((x - mx) ** 2 for x in xs)
                if sxx == 0:
                    continue
                tau = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sxx
                base = my - tau * mx
                res = (sum((base + tau * x - y) ** 2 for x, y in zip(xs, ys))
                       / len(xs)) ** 0.5
                fits.append((res, fixed, combine, per_sm, tau, base))
    return min(fits)


# forced launch plans of conv2d at the paper's shape (batch: (band rows,
# CTAs per SM, ring slots)), beside the planner's own: what its constants
# (ITEM_ROWS, CTAS_PER_SM, STAGES) are read from
CONV_SWEEP = {32: ((1, 4, 8), (2, 2, 8), (4, 2, 8), (4, 4, 8), (2, 4, 2)),
              2000: ((4, 4, 8), (13, 4, 8), (26, 1, 8), (26, 2, 8),
                     (26, 4, 2))}
CONV_SWEEP_ARGS = ("band_rows", "ctas_per_sm", "stages")
# forced launch plans of conv2d_wgrad (batch: (CTAs per SM, cluster, most
# ring slots, pairs a slot, consumer warps)), the planner's own first: how
# its time moves with the CTAs, the merge (cluster 1: the last CTA sums
# every CTA's partial; clusters of 4 leave SMs unused), the bytes in
# flight and the warps
WGRAD_SWEEP = {
    64: ((1, 2, 8, 16, 16), (1, 1, 8, 16, 16), (1, 4, 8, 16, 16),
         (2, 2, 8, 8, 8), (2, 1, 8, 8, 8), (1, 2, 8, 12, 12),
         (1, 2, 8, 16, 8)),
    320: ((1, 2, 8, 16, 16), (1, 1, 8, 16, 16), (2, 2, 8, 8, 8),
          (1, 2, 2, 16, 16), (1, 2, 8, 32, 16), (1, 2, 8, 12, 12)),
    2000: ((1, 2, 8, 16, 16), (1, 1, 8, 16, 16), (1, 4, 8, 16, 16),
           (2, 2, 8, 8, 8), (2, 1, 8, 8, 8), (3, 2, 8, 8, 8),
           (1, 2, 2, 16, 16), (1, 2, 8, 32, 16), (1, 2, 8, 12, 12),
           (1, 2, 8, 16, 8))}
WGRAD_SWEEP_ARGS = ("ctas_per_sm", "cluster", "stages", "slot_pairs",
                    "warps")
WGRAD_BATCHES = (64, 320, 2000)   # a worker's microbatch, five folded into
                                  # one, evaluation's batch


def plan_sweep(torch, mod, fn, names, forced):
    """``fn`` timed with ``mod.plan`` forced to each tuple of ``forced``
    (values of the plan's keyword arguments ``names``) -> {tuple: (event
    ms, graph-replayed ms)}."""
    plan = mod.plan
    sweep = {}
    for key in forced:
        with mock.patch.object(mod, "plan", functools.partial(
                plan, **dict(zip(names, key)))):
            sweep[key] = (time_ms(torch, fn), graph_ms(torch, fn))
    return sweep


def int8_kernel_times(torch, device, ops, ref):
    """Phase 7, the int8 KV cache's variants in bfloat16 at phase 2's
    shapes: ``paged_attention_int8`` at the decode shape (8 rows x 32
    blocks of 16) and at the dense configs' and gemma3-4b's heads (tables
    of 16 blocks); ``paged_prefill_int8`` at a chunk (4 rows, S=256, an
    int8 prefix of 512), fused decode (8 rows, S=1), slot decode (4 slots
    of 256 int8 lanes) and spec verify, and fused decode at the dense and
    gemma3-4b heads.  Each by events and by graph replay, beside the bf16
    kernel on the same keys dequantized (the float entry), its int8 plain
    version, and SDPA over the dequantized bf16 keys as a yardstick (no
    PyTorch call reads int8 K/V, so no library time).  Bytes: q read and
    the output written, the int8 K/V and their scales of the visible
    prefix keys (the decode: of the live blocks, with their kpos lanes,
    the table and pos), the chunk's visible bf16 K/V, kpos and qpos; the
    operations as the float rows'.  -> {key: record}."""
    gen = torch.Generator(device=device).manual_seed(2)
    spec_gen = torch.Generator(device=device).manual_seed(6)
    dt = torch.bfloat16
    elt = 2
    out = {}

    def record(key, what, int8_args, bytes_, flops, sdpa_call):
        base = "paged_attention" if len(int8_args) == 8 else "paged_prefill"
        kernel = getattr(ops, f"{base}_int8")
        plain = getattr(ref, f"{base}_int8_ref")
        dense = dequantized_args(torch, ref, int8_args)
        fn = lambda a=int8_args: kernel(*a)                    # noqa: E731
        bf = lambda a=dense: getattr(ops, base)(*a)            # noqa: E731
        out[key] = dict(
            kernel=f"{base}_int8", what=what,
            ms=time_ms(torch, fn), graph_ms=graph_ms(torch, fn),
            bf16_ms=time_ms(torch, bf), bf16_graph_ms=graph_ms(torch, bf),
            plain_ms=time_ms(torch, lambda a=int8_args: plain(*a)),
            sdpa_ms=time_ms(torch, sdpa_call),
            sdpa_graph_ms=graph_ms(torch, sdpa_call),
            library_ms=None, bytes=bytes_, flops=flops)

    def decode(key, what, args):
        q, k, v, kp, bt, pos = args
        b, h, hd = q.shape
        bs, kv = k.shape[1], k.shape[2]
        vis = decode_visible(torch, kp, bt, pos, 0)
        live = int(vis.reshape(b, -1, bs).any(-1).sum())
        i8 = int8_decode_args(args)
        deq = dequantized_args(torch, ref, i8)
        gk = deq[1][bt.long()].reshape(b, -1, kv, hd).transpose(1, 2)
        gv = deq[2][bt.long()].reshape(b, -1, kv, hd).transpose(1, 2)
        record(key, what, i8,
               2 * q.numel() * elt + bt.numel() * 4 + pos.numel() * 4
               + live * (2 * bs * kv * hd + 2 * bs * kv * 4 + bs * 4),
               4 * hd * h * int(vis.sum()),
               lambda q=q, gk=gk, gv=gv, mask=vis[:, None, None, :]:
               sdpa(torch, q[:, :, None], gk, gv, mask))

    def prefill(key, what, args, lp):
        q, k, v, kpos, qpos = args
        b, s, h, hd = q.shape
        kv = k.shape[2]
        vis = prefill_visible(torch, kpos, qpos, 0)
        seen = vis.any(1)                                    # (B, L)
        i8 = int8_prefill_args(args, lp)
        deq = dequantized_args(torch, ref, i8)
        record(key, what, i8,
               2 * q.numel() * elt + kpos.numel() * 4 + qpos.numel() * 4
               + int(seen[:, :lp].sum()) * 2 * kv * (hd + 4)
               + int(seen[:, lp:].sum()) * 2 * kv * hd * elt,
               4 * hd * h * int(vis.sum()),
               lambda d=deq, mask=vis[:, None]:
               sdpa(torch, *(t.transpose(1, 2) for t in d[:3]), mask))

    decode("paged_attention_int8", "paged decode (8 rows, 32 blocks of "
           "16, 16/8 heads)", decode_case(torch, gen, device, dt))
    prefill("paged_prefill_int8", "a chunk (4 rows, S=256, an int8 "
            "prefix of 512)", prefill_case(torch, gen, device, dt), 512)
    prefill("paged_prefill_int8_s1", "fused decode (8 rows, S=1, an int8 "
            "prefix of 512)", prefill_case(torch, gen, device, dt, b=8,
                                           s=1), 512)
    prefill("paged_prefill_int8_slot", "slot decode (4 slots of 256 int8 "
            "lanes, no chunk keys)",
            slot_decode_case(torch, gen, device, dt), 256)
    prefill("paged_prefill_int8_verify", "spec verify (16 rows, S=16, an "
            "int8 prefix of 256)", verify_case(torch, spec_gen, device, dt),
            256)
    heads = {arch: dict(h=h, kv=kv) for arch, (h, kv) in DENSE_HEADS.items()}
    heads["gemma3-4b"] = GEMMA3_HEADS
    for arch, kw in heads.items():
        n = f"{kw['h']}/{kw['kv']}" + (f" of {kw['hd']}" if "hd" in kw
                                       else "")
        decode(f"paged_attention_int8_{arch}", f"paged decode (8 rows, 16 "
               f"blocks of 16) at {arch}'s heads ({n})",
               decode_case(torch, gen, device, dt, nb=16, null_rows=(2,),
                           **kw))
        prefill(f"paged_prefill_int8_s1_{arch}", f"fused decode (8 rows, "
                f"S=1, an int8 prefix of 512) at {arch}'s heads ({n})",
                prefill_case(torch, gen, device, dt, b=8, s=1, **kw), 512)
    for rec in out.values():
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rec["flops"] / PEAK_FLOPS["bfloat16"] * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def pool_timing_cases(torch, device):
    """Phase 7's pool shapes in bfloat16, the prefix in pool blocks of 16
    (the engine's): ``paged_prefill_pool`` at a chunk (4 rows, S=256, 512
    prefix lanes), the fused decode dispatch (8 rows, S=1), the spec
    verify dispatch (16 rows, S=16, 256 prefix lanes), then
    ``paged_prefill_pool_int8`` at the same three, then the float entry
    at gemma3-4b's three ``GEMMA3_PP_SHAPES`` (window 0 and, where the
    band cuts, 1,024).  Yields (key, what, window, ``pool_case``
    operands), the same inputs on every call."""
    gen = torch.Generator(device=device).manual_seed(2)
    spec_gen = torch.Generator(device=device).manual_seed(6)
    ggen = torch.Generator(device=device).manual_seed(13)
    dt = torch.bfloat16
    for int8 in (False, True):
        tag = "_int8" if int8 else ""
        for key, what, case, prefix in (
                ("", "a chunk (4 rows, S=256, 512 prefix lanes)",
                 prefill_case(torch, gen, device, dt), 512),
                ("_s1", "fused decode (8 rows, S=1, 512 prefix lanes)",
                 prefill_case(torch, gen, device, dt, b=8, s=1), 512),
                ("_verify", "spec verify (16 rows, S=16, 256 prefix lanes)",
                 verify_case(torch, spec_gen, device, dt), 256)):
            yield (f"paged_prefill_pool{tag}{key}", what, 0,
                   pool_case(torch, gen, device, case, prefix, 16, int8))
    for what, kw in GEMMA3_PP_SHAPES:
        case = prefill_case(torch, ggen, device, dt, **kw, **GEMMA3_HEADS)
        prefix = kw.get("prefix", 512)
        for window in (0, GEMMA3_WINDOW) if kw.get("min_start") else (0,):
            yield (f"paged_prefill_pool_hd256_{what}_w{window}",
                   f"{what} ({kw['b']} rows, S={kw['s']}, {prefix} prefix "
                   f"lanes) at gemma3-4b's heads (8/4 of 256), window "
                   f"{window}", window,
                   pool_case(torch, gen, device, case, prefix))


def pool_kernel_times(torch, device, ops, ref):
    """Phase 7, the pool entries at ``pool_timing_cases``: each by events
    and by graph replay beside the parent's composed path (the gather
    through the table, the cursor guard, the concatenation and the
    contiguous entry; int8: the gather, the guard and
    ``paged_prefill_int8``), its plain version, and SDPA over the
    gathered keys (dequantized for int8) as a yardstick.  Bytes: q read
    and the output written, the visible prefix rows (each K/V row read
    once: bf16, or int8 with its float32 scale), the chunk's K/V, its
    kpos and qpos, the table, the cursors and every table lane's
    position; operations 4 hd a visible (query head, key) pair.  ->
    {key: record}."""
    from repro_torch.kernels import attention_split
    from repro_torch.kernels import paged_prefill as pp_mod

    elt = 2
    sms = attention_split.sm_count(device)
    out = {}
    for key, what, window, pc in pool_timing_cases(torch, device):
        q, leaves, pos_pool, bt, starts, k, v, kpos, qpos = pc
        b, s, h, hd = q.shape
        kv, bs = k.shape[2], pos_pool.shape[1]
        prefix, int8 = bt.shape[1] * bs, len(leaves) == 4
        keys = pool_keys(torch, ref, pc)
        vis = prefill_visible(torch, keys[2], qpos, window)      # (B,S,L)
        seen = vis.any(1)
        row = kv * (hd + 4) if int8 else kv * hd * elt
        nbytes = (2 * q.numel() * elt + int(seen[:, :prefix].sum()) * 2 * row
                  + 2 * k.numel() * elt
                  + 4 * (kpos.numel() + qpos.numel() + bt.numel()
                         + starts.numel() + bt.numel() * bs))
        fn = lambda pc=pc: pool_call(ops, pc, window)        # noqa: E731
        comp = (lambda pc=pc: composed_call(torch, ops, ref,  # noqa: E731
                                            pc, window))
        lib = (lambda keys=keys, q=q, mask=vis[:, None]:      # noqa: E731
               sdpa(torch, q.transpose(1, 2), keys[0].transpose(1, 2),
                    keys[1].transpose(1, 2), mask))
        out[key] = dict(
            kernel="paged_prefill_pool" + ("_int8" if int8 else ""),
            what=what, window=window,
            ms=time_ms(torch, fn), graph_ms=graph_ms(torch, fn),
            composed_ms=time_ms(torch, comp),
            composed_graph_ms=graph_ms(torch, comp),
            plain_ms=time_ms(torch, lambda pc=pc: pool_plain(ref, pc,
                                                             window)),
            library_ms=time_ms(torch, lib), library_graph_ms=graph_ms(
                torch, lib),
            bytes=nbytes, flops=4 * hd * h * int(vis.sum()),
            split=pp_mod.plan(b, s, prefix + s, h, kv, sms).split,
            tile=pp_tile(q, kv))
    for rec in out.values():
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rec["flops"] / PEAK_FLOPS["bfloat16"] * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def kernel_times(torch, device, ops, ref):
    """Phase 7, at the parity phase's main-path shapes, the attention
    kernels in bfloat16 with window 0, ``rwkv6_scan``, ``ssm_scan`` and
    ``conv2d`` in float32.  -> {kernel: record}."""
    from repro_torch.kernels import attention_split
    from repro_torch.kernels import conv2d as cv_mod
    from repro_torch.kernels import conv2d_wgrad as wg_mod
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import paged_prefill as pp_mod

    gen = torch.Generator(device=device).manual_seed(2)
    spec_gen = torch.Generator(device=device).manual_seed(6)
    dt = torch.bfloat16
    elt = 2
    sms = attention_split.sm_count(device)
    out = {}
    split_fns = {}                  # key -> the kernel call, bf16 attention
    calls = {}                      # key -> (kernel call, library call)

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
    pl = pa_mod.plan(b, kv, bt.shape[1], sms)
    split_fns["paged_attention"] = (
        lambda q=q, k=k, v=v, kp=kp, bt=bt, pos=pos:
        ops.paged_attention(q, k, v, kp, bt, pos))
    calls["paged_attention"] = (
        split_fns["paged_attention"],
        lambda q=q, gk=gk, gv=gv, mask=mask: sdpa(torch, q[:, :, None], gk,
                                                  gv, mask))
    out["paged_attention"] = dict(
        ms=time_ms(torch, split_fns["paged_attention"]),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(
            q, k, v, kp, bt, pos)),
        library_ms=time_ms(torch, calls["paged_attention"][1]),
        bytes=nbytes, flops=flops, split=pl.split, ctas=pl.ctas(b, kv))
    out["paged_attention"]["sweep"] = piece_sweep(torch, device, ops, pa_mod)

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
    split_fns["paged_prefill"] = (lambda q=q, k=k, v=v, kpos=kpos, qpos=qpos:
                                  ops.paged_prefill(q, k, v, kpos, qpos))
    calls["paged_prefill"] = (split_fns["paged_prefill"],
                              lambda qt=qt, kt=kt, vt=vt, mask=mask:
                              sdpa(torch, qt, kt, vt, mask))
    out["paged_prefill"] = dict(
        ms=time_ms(torch, split_fns["paged_prefill"]),
        plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
            q, k, v, kpos, qpos)),
        library_ms=time_ms(torch, calls["paged_prefill"][1]),
        bytes=nbytes, flops=flops,
        split=pp_mod.plan(b, s, k.shape[1], h, kv, sms).split,
        tile=pp_tile(q, kv))

    # one query lane per row: the fused decode dispatch (8 rows, 512
    # prefix lanes) and slot decode (4 slots of 256 lanes); then the spec
    # engine's verify dispatch (8 windows of 5 lanes beside 2 chunk rows,
    # 16 rows of 16 lanes over 256 prefix lanes)
    for key, args in (
            ("paged_prefill_s1",
             prefill_case(torch, gen, device, dt, b=8, s=1)),
            ("paged_prefill_slot",
             slot_decode_case(torch, gen, device, dt)),
            ("paged_prefill_verify",
             verify_case(torch, spec_gen, device, dt))):
        q, k, v, kpos, qpos = args
        vis = prefill_visible(torch, kpos, qpos, 0)
        nbytes = (2 * q.numel() * elt + kpos.numel() * 4 + qpos.numel() * 4
                  + int(vis.any(1).sum()) * 2 * kv * hd * elt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        split_fns[key] = (lambda q=q, k=k, v=v, kpos=kpos, qpos=qpos:
                          ops.paged_prefill(q, k, v, kpos, qpos))
        calls[key] = (split_fns[key],
                      lambda qt=qt, kt=kt, vt=vt, mask=vis[:, None]:
                      sdpa(torch, qt, kt, vt, mask))
        out[key] = dict(
            ms=time_ms(torch, split_fns[key]),
            plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
                q, k, v, kpos, qpos)),
            library_ms=time_ms(torch, calls[key][1]),
            bytes=nbytes, flops=4 * hd * h * int(vis.sum()),
            split=pp_mod.plan(q.shape[0], q.shape[1], k.shape[1], h, kv,
                              sms).split, tile=pp_tile(q, kv))

    # the slot engine's whole-prompt prefill: one row, causal, window 0
    for s in (512, 2048):
        q, k, v = flash_case(torch, gen, device, dt, sq=s)
        b, h, _, hd = q.shape
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * elt
        key = f"flash_attention_{s}"
        split_fns[key] = (lambda q=q, k=k, v=v:
                          ops.flash_attention(q, k, v))
        calls[key] = (split_fns[key], lambda q=q, k=k, v=v:
                      sdpa(torch, q, k, v, causal=True))
        out[key] = dict(
            ms=time_ms(torch, split_fns[key]),
            plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v)),
            library_ms=time_ms(torch, calls[key][1]),
            bytes=nbytes, flops=4 * hd * h * b * (s * (s + 1) // 2),
            split=fa_mod.plan(b, h, k.shape[1], s, s, True, 0, sms).split)

    # the draft model's forwards: one row, causal, at its padded lengths
    for s, valid in DRAFT_SHAPES:
        q, k, v = draft_case(torch, spec_gen, device, dt, s, valid)
        b, h, _, hd = q.shape
        key = f"flash_attention_draft_{s}"
        split_fns[key] = (lambda q=q, k=k, v=v:
                          ops.flash_attention(q, k, v))
        calls[key] = (split_fns[key], lambda q=q, k=k, v=v:
                      sdpa(torch, q, k, v, causal=True))
        out[key] = dict(
            ms=time_ms(torch, split_fns[key]),
            plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v)),
            library_ms=time_ms(torch, calls[key][1]),
            bytes=(2 * q.numel() + k.numel() + v.numel()) * elt,
            flops=4 * hd * h * b * (s * (s + 1) // 2),
            split=fa_mod.plan(b, h, k.shape[1], s, s, True, 0, sms).split)

    # the rwkv6 slot path: a prompt row of S=200 and a decode step over 4
    # slots, float32; bytes: r, k, v, w read and out written (B,H,S,hd), u,
    # s0 read and s_final written; operations: the least the recurrence
    # needs, 5 hd^2 + 5 hd per (row, head, step) (r.S and the state update
    # per (i, j), the bonus term per i / j)
    for b, s in ((1, 200), (4, 1)):
        r, k, v, w, u, s0 = rwkv_case(torch, gen, device, b=b, s=s)
        _, h, _, hd = r.shape
        key = f"rwkv6_scan_{b}x{s}"
        calls[key] = (lambda r=r, k=k, v=v, w=w, u=u, s0=s0:
                      ops.rwkv6_scan(r, k, v, w, u, s0), None)
        out[key] = dict(
            ms=time_ms(torch, calls[key][0]),
            plain_ms=time_ms(torch, lambda: ref.rwkv6_scan_ref(
                r, k, v, w, u, s0)),
            library_ms=None, dtype="float32",
            bytes=4 * (5 * r.numel() + u.numel() + 2 * s0.numel()),
            flops=(5 * hd * hd + 5 * hd) * b * h * s)

    # mamba's selective scan at jamba's width (``SSM_TIMED``), x and y in
    # float32 and in bf16 (what jamba runs), from a generator of its own
    # (the conv cases keep earlier inputs); bytes: dt read (B,S,di) float32,
    # x read and y written (B,S,di) in x's dtype, bm, cm (B,S,N), a (di,N),
    # h0 read and h_final written (B,di,N) float32; operations: 7 N + 1 per
    # (row, step, channel): dt a, its exponential, the decay and input
    # products and their sum, the output term and its sum, dt x; the SFU
    # floor: the N exponentials per (row, step, channel) at
    # ``SFU_EX2_PER_CLOCK`` a clock per SM at the card's top SM clock
    from repro_torch.kernels import ssm_scan as ss_mod

    ssm_gen = torch.Generator(device=device).manual_seed(9)
    clock_hz = sm_clock_max_mhz() * 1e6
    for b, s in SSM_TIMED:
        args = list(ssm_case(torch, ssm_gen, device, b, s))
        di, n = args[4].shape
        for suffix, xdt in (("", torch.float32), ("_bf16", torch.bfloat16)):
            args[3] = args[3].to(xdt)
            xs = args[3].element_size()
            key = f"ssm_scan_{b}x{s}{suffix}"
            calls[key] = (lambda args=tuple(args): ops.ssm_scan(*args), None)
            out[key] = dict(
                ms=time_ms(torch, calls[key][0]),
                plain_ms=time_ms(torch, lambda args=tuple(args):
                                 ref.ssm_scan_ref(*args)),
                library_ms=None, dtype="float32", x_dtype=str(xdt),
                bytes=(4 * (b * s * di + 2 * b * s * n + di * n
                            + 2 * b * di * n) + 2 * xs * b * s * di),
                flops=(7 * n + 1) * b * s * di,
                sfu_ms=b * s * di * n / (SFU_EX2_PER_CLOCK * sms
                                         * clock_hz) * 1e3,
                slot=(f"{ss_mod.slot_steps(b, di, xs, sms)}-step ring "
                      "slots" if s > 1 else "no ring (decode)"))

    # the two backward kernels at their training shapes
    # (``SCAN_BWD_SHAPES``), from a generator of their own; bytes: each
    # input read once and each gradient written once (rwkv6: r, k, v, w,
    # dout and dr, dk, dv, dw (B,H,S,hd), u and du, s0, ds_final and ds0;
    # mamba: dt, ddt, x, dy, dx (B,S,di), bm, cm, dbm, dcm, a, da, h0,
    # dh_final, dh0; the training forward's checkpoints, made before the
    # timing, are scratch of this design and not counted); operations: 14 a (row, head, step, i, j) and 18 a
    # (row, step, channel, state), as the sources' notes count them; the
    # SFU floor: one exponential a (row, step, channel, state)
    from repro_torch.kernels import rwkv6_scan_bwd as rwb_mod
    from repro_torch.kernels import ssm_scan_bwd as ssb_mod

    bwd_gen = torch.Generator(device=device).manual_seed(13)
    for b, s in SCAN_BWD_SHAPES["rwkv6_scan_bwd"]:
        args = list(rwkv_case(torch, bwd_gen, device, b=b, s=s))
        _, h, _, hd = args[0].shape
        dout = torch.randn(b, s, h, hd, generator=bwd_gen,
                           device=device).transpose(1, 2)
        dsf = torch.randn(args[5].shape, generator=bwd_gen, device=device)
        key = f"rwkv6_scan_bwd_{b}x{s}"
        calls[key] = (lambda args=tuple(args), dout=dout, dsf=dsf:
                      rwb_mod.rwkv6_scan_bwd(*args, dout, dsf), None)
        n = b * h * s * hd
        out[key] = dict(
            ms=time_ms(torch, calls[key][0]),
            plain_ms=time_ms(torch, lambda args=tuple(args), dout=dout,
                             dsf=dsf: ref.rwkv6_scan_bwd_ref(*args, dout,
                                                              dsf), iters=5),
            library_ms=None, dtype="float32",
            bytes=4 * (9 * n + 2 * h * hd + 3 * b * h * hd * hd),
            flops=14 * n * hd)
    for b, s, xdt in SCAN_BWD_SHAPES["ssm_scan_bwd"]:
        args = list(ssm_case(torch, bwd_gen, device, b, s))
        args[3] = args[3].to(getattr(torch, xdt))
        di, n_st = args[4].shape
        xs = args[3].element_size()
        dy = torch.randn(b, s, di, generator=bwd_gen,
                         device=device).to(args[3].dtype)
        dhf = torch.randn(args[5].shape, generator=bwd_gen, device=device)
        ck = ss_mod.ssm_scan(*args, checkpoints=True)[2]
        key = f"ssm_scan_bwd_{b}x{s}_{xdt}"
        calls[key] = (lambda args=tuple(args), dy=dy, dhf=dhf, ck=ck:
                      ssb_mod.ssm_scan_bwd(*args, dy, dhf, ckpt=ck), None)
        n = b * s * di
        out[key] = dict(
            ms=time_ms(torch, calls[key][0]),
            plain_ms=time_ms(torch, lambda args=tuple(args), dy=dy, dhf=dhf:
                             ref.ssm_scan_bwd_ref(*args, dy, dhf),
                             iters=5 if s <= 256 else 2),
            library_ms=None, dtype="float32", x_dtype=xdt,
            bytes=(4 * (2 * n + 4 * b * s * n_st + 2 * di * n_st
                        + 3 * b * di * n_st) + 3 * xs * n),
            flops=18 * n * n_st,
            sfu_ms=n * n_st / (SFU_EX2_PER_CLOCK * sms * clock_hz) * 1e3)

    # the digit CNN's conv layer in float32 (the model's dtype) at the
    # consumer's batches of 1 and 32 and evaluation's 2,000 test digits;
    # bytes: x and w read, the output written (28x the input here);
    # library: cuDNN on the NCHW / OIHW views, TF32 off (``main``)
    import torch.nn.functional as F

    for b in (1, 32, 2000):
        x = torch.rand(b, 28, 28, 1, generator=gen, device=device)
        w = torch.randn(3, 3, 1, 32, generator=gen, device=device)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        key = f"conv2d_{b}"
        calls[key] = (lambda x=x, w=w: ops.conv2d(x, w),
                      lambda xn=xn, wn=wn: F.conv2d(xn, wn))
        out[key] = dict(
            ms=time_ms(torch, calls[key][0]),
            plain_ms=time_ms(torch, lambda: ref.conv2d_ref(x, w)),
            library_ms=time_ms(torch, calls[key][1]),
            dtype="float32",
            bytes=4 * (x.numel() + w.numel() + b * 26 * 26 * 32),
            flops=2 * b * 26 * 26 * 3 * 3 * 32)
        if b in CONV_SWEEP:
            out[key]["sweep"] = plan_sweep(torch, cv_mod, calls[key][0],
                                           CONV_SWEEP_ARGS, CONV_SWEEP[b])

    # the filter gradient in float32 at the training step's B=64, the five
    # workers' microbatches as one (320) and 2,000; bytes: x and dy read,
    # dw written; library: cuDNN's weight gradient on NCHW copies made
    # here, TF32 off (``main``)
    from torch.nn.grad import conv2d_weight

    for b in WGRAD_BATCHES:
        x = torch.rand(b, 28, 28, 1, generator=gen, device=device)
        dy = torch.randn(b, 26, 26, 32, generator=gen, device=device)
        xn = x.permute(0, 3, 1, 2).contiguous()
        dyn = dy.permute(0, 3, 1, 2).contiguous()
        key = f"conv2d_wgrad_{b}"
        calls[key] = (lambda x=x, dy=dy: ops.conv2d_wgrad(x, dy, 3, 3),
                      lambda xn=xn, dyn=dyn: conv2d_weight(xn, (32, 1, 3, 3),
                                                           dyn))
        torch.testing.assert_close(
            calls[key][1]().permute(2, 3, 1, 0), calls[key][0](),
            rtol=1e-5, atol=1e-5 * calls[key][0]().abs().max().item())
        out[key] = dict(
            ms=time_ms(torch, calls[key][0]),
            plain_ms=time_ms(torch, lambda: ref.conv2d_wgrad_ref(x, dy, 3, 3)),
            library_ms=time_ms(torch, calls[key][1]),
            # what reading dy alone takes here (one reduction over it)
            read_ms=graph_ms(torch, lambda dy=dy: dy.sum()),
            dtype="float32",
            bytes=4 * (x.numel() + dy.numel() + 3 * 3 * 32),
            flops=2 * b * 26 * 26 * 3 * 3 * 32,
            plan=wg_mod.launch_plan(x.shape, 3, 3, 32, sms),
            sweep=plan_sweep(torch, wg_mod, calls[key][0], WGRAD_SWEEP_ARGS,
                             WGRAD_SWEEP[b]))

    # the dense configs' heads (``DENSE_HEADS``) at the engines' shapes,
    # counted as the rows above: the fused decode dispatch and a chunk of
    # paged_prefill, paged decode over tables of 16 blocks, and S=512
    hgen = torch.Generator(device=device).manual_seed(8)
    for arch, (h, kv) in DENSE_HEADS.items():
        for key, args in (
                (f"paged_prefill_s1_{arch}",
                 prefill_case(torch, hgen, device, dt, b=8, s=1, h=h, kv=kv)),
                (f"paged_prefill_{arch}",
                 prefill_case(torch, hgen, device, dt, h=h, kv=kv))):
            q, k, v, kpos, qpos = args
            b, s, _, hd = q.shape
            vis = prefill_visible(torch, kpos, qpos, 0)
            split_fns[key] = (lambda q=q, k=k, v=v, kpos=kpos, qpos=qpos:
                              ops.paged_prefill(q, k, v, kpos, qpos))
            calls[key] = (split_fns[key],
                          lambda q=q, k=k, v=v, mask=vis[:, None]:
                          sdpa(torch, *(t.transpose(1, 2) for t in (q, k, v)),
                               mask))
            out[key] = dict(
                ms=time_ms(torch, split_fns[key]),
                plain_ms=time_ms(torch, lambda: ref.paged_prefill_ref(
                    q, k, v, kpos, qpos)),
                library_ms=time_ms(torch, calls[key][1]),
                bytes=(2 * q.numel() * elt + kpos.numel() * 4
                       + qpos.numel() * 4
                       + int(vis.any(1).sum()) * 2 * kv * hd * elt),
                flops=4 * hd * h * int(vis.sum()),
                split=pp_mod.plan(b, s, k.shape[1], h, kv, sms).split,
                tile=pp_tile(q, kv))

        q, k, v, kp, bt, pos = decode_case(torch, hgen, device, dt, h=h,
                                           kv=kv, nb=16, null_rows=(2,))
        b, _, hd = q.shape
        bs = k.shape[1]
        vis = decode_visible(torch, kp, bt, pos, 0)
        live = int(vis.reshape(b, -1, bs).any(-1).sum())
        gk = k[bt.long()].reshape(b, -1, kv, hd).transpose(1, 2)
        gv = v[bt.long()].reshape(b, -1, kv, hd).transpose(1, 2)
        key = f"paged_attention_{arch}"
        pl = pa_mod.plan(b, kv, bt.shape[1], sms)
        split_fns[key] = (lambda q=q, k=k, v=v, kp=kp, bt=bt, pos=pos:
                          ops.paged_attention(q, k, v, kp, bt, pos))
        calls[key] = (split_fns[key],
                      lambda q=q, gk=gk, gv=gv, mask=vis[:, None, None, :]:
                      sdpa(torch, q[:, :, None], gk, gv, mask))
        out[key] = dict(
            ms=time_ms(torch, split_fns[key]),
            plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(
                q, k, v, kp, bt, pos)),
            library_ms=time_ms(torch, calls[key][1]),
            bytes=(2 * q.numel() * elt + bt.numel() * 4 + pos.numel() * 4
                   + live * (2 * bs * kv * hd * elt + bs * 4)),
            flops=4 * hd * h * int(vis.sum()), split=pl.split,
            ctas=pl.ctas(b, kv))

        q, k, v = flash_case(torch, hgen, device, dt, h=h, kv=kv, sq=512)
        b, _, s, hd = q.shape
        key = f"flash_attention_512_{arch}"
        split_fns[key] = lambda q=q, k=k, v=v: ops.flash_attention(q, k, v)
        calls[key] = (split_fns[key], lambda q=q, k=k, v=v:
                      sdpa(torch, q, k, v, causal=True))
        out[key] = dict(
            ms=time_ms(torch, split_fns[key]),
            plain_ms=time_ms(torch, lambda: ref.flash_attention_ref(q, k, v)),
            library_ms=time_ms(torch, calls[key][1]),
            bytes=(2 * q.numel() + k.numel() + v.numel()) * elt,
            flops=4 * hd * h * b * (s * (s + 1) // 2),
            split=fa_mod.plan(b, h, kv, s, s, True, 0, sms).split)

    # gemma3-4b's heads at head_dim 256 (``GEMMA3_*_SHAPES``), window 0
    # and, where the band cuts, 1,024; bytes and operations count only the
    # keys inside each query's band; SDPA with ``enable_gqa`` and, for a
    # windowed row, the band as an explicit mask (``backend``: the one it
    # ran)
    ggen = torch.Generator(device=device).manual_seed(13)
    for what, kw in GEMMA3_PP_SHAPES:
        args = prefill_case(torch, ggen, device, dt, **kw, **GEMMA3_HEADS)
        q, k, v, kpos, qpos = args
        b, s, h, hd = q.shape
        kv = k.shape[2]
        for window in (0, GEMMA3_WINDOW) if kw.get("min_start") else (0,):
            vis = prefill_visible(torch, kpos, qpos, window)
            key = f"paged_prefill_hd256_{what}_w{window}"
            split_fns[key] = (lambda args=args, window=window:
                              ops.paged_prefill(*args, window=window))
            calls[key] = (split_fns[key],
                          lambda q=q, k=k, v=v, mask=vis[:, None]:
                          sdpa(torch, *(t.transpose(1, 2) for t in (q, k, v)),
                               mask))
            out[key] = dict(
                ms=time_ms(torch, split_fns[key]),
                plain_ms=time_ms(torch, lambda args=args, window=window:
                                 ref.paged_prefill_ref(*args, window=window)),
                library_ms=time_ms(torch, calls[key][1]),
                bytes=(2 * q.numel() * elt + kpos.numel() * 4
                       + qpos.numel() * 4
                       + int(vis.any(1).sum()) * 2 * kv * hd * elt),
                flops=4 * hd * h * int(vis.sum()),
                split=pp_mod.plan(b, s, k.shape[1], h, kv, sms).split,
                tile=pp_tile(q, kv),
                backend=sdpa_backend(torch, *(t.transpose(1, 2)
                                              for t in (q, k, v)),
                                     vis[:, None]),
                kernel="paged_prefill", window=window,
                what=f"{what} ({b} rows, S={s}, {k.shape[1] - s} prefix "
                     "lanes)")
    for nb, nulls in GEMMA3_PA_SHAPES:
        q, k, v, kp, bt, pos = decode_case(torch, ggen, device, dt, nb=nb,
                                           null_rows=nulls, **GEMMA3_HEADS)
        b, h, hd = q.shape
        bs, kv = k.shape[1], k.shape[2]
        gk = k[bt.long()].reshape(b, -1, kv, hd).transpose(1, 2)
        gv = v[bt.long()].reshape(b, -1, kv, hd).transpose(1, 2)
        pl = pa_mod.plan(b, kv, bt.shape[1], sms)
        for window in (0, GEMMA3_WINDOW) if nb * bs > GEMMA3_WINDOW \
                else (0,):
            vis = decode_visible(torch, kp, bt, pos, window)
            live = int(vis.reshape(b, -1, bs).any(-1).sum())
            key = f"paged_attention_hd256_{nb}_w{window}"
            split_fns[key] = (lambda q=q, k=k, v=v, kp=kp, bt=bt, pos=pos,
                              window=window: ops.paged_attention(
                                  q, k, v, kp, bt, pos, window=window))
            calls[key] = (split_fns[key],
                          lambda q=q, gk=gk, gv=gv,
                          mask=vis[:, None, None, :]:
                          sdpa(torch, q[:, :, None], gk, gv, mask))
            out[key] = dict(
                ms=time_ms(torch, split_fns[key]),
                plain_ms=time_ms(torch, lambda q=q, k=k, v=v, kp=kp, bt=bt,
                                 pos=pos, window=window:
                                 ref.paged_attention_ref(
                                     q, k, v, kp, bt, pos, window=window)),
                library_ms=time_ms(torch, calls[key][1]),
                bytes=(2 * q.numel() * elt + bt.numel() * 4
                       + pos.numel() * 4
                       + live * (2 * bs * kv * hd * elt + bs * 4)),
                flops=4 * hd * h * int(vis.sum()), split=pl.split,
                ctas=pl.ctas(b, kv), kernel="paged_attention",
                backend=sdpa_backend(torch, q[:, :, None], gk, gv,
                                     vis[:, None, None, :]),
                window=window,
                what=f"paged decode (8 rows, {nb} blocks of 16)")
    for s in GEMMA3_FA_SHAPES:
        q, k, v = flash_case(torch, ggen, device, dt, sq=s, **GEMMA3_HEADS)
        b, h, _, hd = q.shape
        kv = k.shape[1]
        for window in (0, GEMMA3_WINDOW) if s > GEMMA3_WINDOW else (0,):
            i = torch.arange(s, device=device)
            band = i[None, :] <= i[:, None]
            if window:
                band &= i[:, None] - i[None, :] < window
            key = f"flash_attention_hd256_{s}_w{window}"
            split_fns[key] = (lambda q=q, k=k, v=v, window=window:
                              ops.flash_attention(q, k, v, window=window))
            calls[key] = (split_fns[key],
                          (lambda q=q, k=k, v=v, mask=band[None, None]:
                           sdpa(torch, q, k, v, mask)) if window else
                          (lambda q=q, k=k, v=v:
                           sdpa(torch, q, k, v, causal=True)))
            out[key] = dict(
                ms=time_ms(torch, split_fns[key]),
                plain_ms=time_ms(torch, lambda q=q, k=k, v=v, window=window:
                                 ref.flash_attention_ref(q, k, v,
                                                         window=window)),
                library_ms=time_ms(torch, calls[key][1]),
                bytes=(2 * q.numel() + k.numel() + v.numel()) * elt,
                flops=4 * hd * h * b * int(band.sum()),
                split=fa_mod.plan(b, h, kv, s, s, True, window, sms).split,
                backend=(sdpa_backend(torch, q, k, v, band[None, None])
                         if window else
                         sdpa_backend(torch, q, k, v, causal=True)),
                kernel="flash_attention", window=window,
                what=f"one causal row of S={s}")

    # whisper-tiny's and paligemma-3b's shapes (phase 2's): the encoder,
    # the cross-attention and the prefix-LM; SDPA with the prefix mask as
    # a boolean mask, its backend named; the slot decode of both
    fgen = torch.Generator(device=device).manual_seed(12)
    for name, shape in FRONTEND_FA_SHAPES.items():
        b, h, kv, sq, sk, hd, causal, prefix = shape
        q, k, v = frontend_fa_case(torch, fgen, device, dt, shape)
        i, j = (torch.arange(n, device=device) for n in (sq, sk))
        seen = ((j[None] <= i[:, None]) | (j[None] < prefix) if causal
                else torch.ones(sq, sk, dtype=torch.bool, device=device))
        key = f"flash_attention_fe_{name}"
        split_fns[key] = (lambda q=q, k=k, v=v, c=causal, p=prefix:
                          ops.flash_attention(q, k, v, causal=c, prefix=p))
        calls[key] = (split_fns[key],
                      (lambda q=q, k=k, v=v, mask=seen[None, None]:
                       sdpa(torch, q, k, v, mask)) if causal else
                      (lambda q=q, k=k, v=v: sdpa(torch, q, k, v)))
        out[key] = dict(
            ms=time_ms(torch, split_fns[key]),
            plain_ms=time_ms(torch, lambda q=q, k=k, v=v, c=causal,
                             p=prefix: ref.flash_attention_ref(
                                 q, k, v, causal=c, prefix=p)),
            library_ms=time_ms(torch, calls[key][1]),
            bytes=(2 * q.numel() + k.numel() + v.numel()) * elt,
            flops=4 * hd * h * b * int(seen.sum()),
            split=fa_mod.plan(b, h, kv, sq, sk, causal, 0, sms,
                              prefix).split,
            backend=(sdpa_backend(torch, q, k, v, seen[None, None])
                     if causal else sdpa_backend(torch, q, k, v)),
            kernel="flash_attention", what=f"{name} {shape[:6]} "
            f"causal={causal} prefix={prefix}")
    for name, shape in FRONTEND_PP_SHAPES.items():
        q, k, v, kpos, qpos = frontend_pp_case(torch, fgen, device, dt,
                                               shape)
        b, _, h, hd = q.shape
        kv = k.shape[2]
        vis = prefill_visible(torch, kpos, qpos, 0)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        key = f"paged_prefill_fe_{name}"
        split_fns[key] = (lambda q=q, k=k, v=v, kpos=kpos, qpos=qpos:
                          ops.paged_prefill(q, k, v, kpos, qpos))
        calls[key] = (split_fns[key],
                      lambda qt=qt, kt=kt, vt=vt, mask=vis[:, None]:
                      sdpa(torch, qt, kt, vt, mask))
        out[key] = dict(
            ms=time_ms(torch, split_fns[key]),
            plain_ms=time_ms(torch, lambda q=q, k=k, v=v, kpos=kpos,
                             qpos=qpos: ref.paged_prefill_ref(
                                 q, k, v, kpos, qpos)),
            library_ms=time_ms(torch, calls[key][1]),
            bytes=(2 * q.numel() * elt + kpos.numel() * 4
                   + qpos.numel() * 4
                   + int(vis.any(1).sum()) * 2 * kv * hd * elt),
            flops=4 * hd * h * int(vis.sum()),
            split=pp_mod.plan(b, 1, k.shape[1], h, kv, sms).split,
            tile=pp_tile(q, kv),
            backend=sdpa_backend(torch, qt, kt, vt, vis[:, None]),
            kernel="paged_prefill", what=f"{name} slot decode {shape}")

    # the bf16 attention shapes whose key ranges the planners split, timed
    # again with every range whole (one piece, no combine); the flash
    # planner's cache is passed by
    for key, fn in split_fns.items():
        if out[key]["split"]:
            with mock.patch.object(
                    attention_split, "plan", lambda ranges, c, n, **kw:
                    attention_split.Plan(1 << 30, (1,) * len(ranges))), \
                    mock.patch.object(fa_mod, "plan",
                                      fa_mod.plan.__wrapped__), \
                    mock.patch.object(pa_mod, "plan", lambda b, kv, nb, n:
                                      pa_mod.Plan(nb, 1)):
                out[key]["whole_ms"] = time_ms(torch, fn)

    # graph replay: every kernel row and its library call (the plain
    # versions keep the event timing)
    for key, (fn, lib) in calls.items():
        out[key]["graph_ms"] = graph_ms(torch, fn)
        out[key]["library_graph_ms"] = (None if lib is None
                                        else graph_ms(torch, lib))

    for rec in out.values():
        t_bytes = rec["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = rec["flops"] / PEAK_FLOPS[rec.get("dtype", "bfloat16")] * 1e3
        rec["bound_ms"] = max(t_bytes, t_ops)
        rec["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


# ---------------------------------------------------------------- main


def sm_clock_max_mhz() -> float:
    """The card's top SM clock, as ``nvidia-smi`` reads it."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(res.stdout.strip().splitlines()[0])


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_entries(build, libs):
    """``ptxas -v`` of the libraries ``libs`` -> [(function, its "Used
    ..." line, its spill line)], names demangled by ``cu++filt`` where the
    toolkit has it."""
    import re
    import shutil

    entries = []
    for lib in libs:
        text = (build.BUILD_DIR / f"{lib}.log").read_text().splitlines()
        fn = spill = None
        for line in text:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spill = m.group(1), None
            elif fn and "spill" in line:
                spill = line.strip()
            elif fn and "Used" in line and "registers" in line:
                entries.append((fn, line.split(":", 1)[-1].strip(), spill))
                fn = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if Path(filt).exists() and entries:
        res = subprocess.run([filt], input="\n".join(e[0] for e in entries),
                             capture_output=True, text=True, timeout=60)
        names = res.stdout.splitlines()
        if len(names) == len(entries):
            entries = [(n, u, s) for n, (_, u, s) in zip(names, entries)]
    return entries


def int8_ptxas(build):
    """``ptxas -v`` of the int8 KV cache's instantiations (the pools'
    element type ``signed char``, ``paged_prefill``'s kQuant ones)."""
    return [e for e in ptxas_entries(build, ("paged_attention_int8",
                                             "paged_prefill_int8"))
            if "signed char" in e[0] or "(bool)1>" in e[0]
            or ", true>" in e[0]]


def prefix_ptxas(build):
    """``ptxas -v`` of ``flash_attention``'s prefix-LM instantiations (the
    last template argument, kPrefix, true) and of the bf16 tile's others
    at head_dim 256, beside them."""
    def keep(name):
        if "<" not in name:                 # not demangled
            return "Lb1EEEv" in name or "ILi256E" in name
        args = name[name.index("<") + 1:name.rindex(">")].split(", ")
        return args[-1] in ("(bool)1", "true") or args[0] in ("(int)256",
                                                               "256")

    return [e for e in ptxas_entries(build, ("flash_attention",))
            if keep(e[0])]


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
    global HBM_BYTES_PER_S, PEAK_FLOPS
    from repro_torch.configs.base import get_config
    from repro_torch.launch.mesh import HBM_BYTES_PER_S, PEAK_FLOPS
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
    t_start = time.perf_counter()

    t_phase = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        log(f"phase {name} done at {now - t_start:.1f}s (took "
            f"{now - t_phase[0]:.1f}s)")
        t_phase[0] = now
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
    for fn, used, spill in int8_ptxas(build):
        log(f"  ptxas int8 instantiation {fn}: {used}; {spill}")
    for fn, used, spill in prefix_ptxas(build):
        log(f"  ptxas flash_attention {fn}: {used}; {spill}")
    from repro_torch.kernels import paged_attention as pa_mod
    from repro_torch.kernels import paged_prefill as pp_mod

    for h, kv, hd in ((16, 8, 128), (64, 8, 128), (8, 4, 256)):
        tq = min(pp_mod.ROWS_PER_CTA // (h // kv), 256)
        log(f"  dynamic shared memory at {h}/{kv} heads of {hd}, bf16 "
            f"(float entry / int8 entry): paged_attention "
            f"{pa_mod.KERNEL.smem_bytes(1, h, kv, hd, 16)} / "
            f"{pa_mod.KERNEL_INT8.smem_bytes(1, h, kv, hd, 16)} bytes, "
            f"paged_prefill {pp_mod.KERNEL.smem_bytes(1, h, kv, hd, tq)} / "
            f"{pp_mod.KERNEL_INT8.smem_bytes(1, h, kv, hd, tq)}")

    phase_done("1")

    # 2. kernel parity, then at the dense configs' heads
    errs = kernel_parity(torch, device, ops, ref)
    for k, err in dense_head_parity(torch, device, ops, ref).items():
        errs[k] = max(errs[k], err)
    for k, err in frontend_kernel_parity(torch, device, ops, ref).items():
        errs[k] = max(errs[k], err)
    errs.update(int8_kernel_parity(torch, device, ops, ref))
    errs.update(pool_kernel_parity(torch, device, ops, ref))
    errs["ssm_scan"] = ssm_parity(torch, device, ops, ref)
    errs.update(scan_backward_parity(torch, device, ops, ref))

    phase_done("2")
    for tile in pp_mod.TILE_LAUNCHES:
        pp_mod.TILE_LAUNCHES[tile] = 0

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

    phase_done("3")

    # 4. engine through the serve path
    lap = lapper("4")
    args = serve.make_parser().parse_args(SERVE_ARGV)
    serve.check_args(args)
    cfg, model, params = serve.build_model(args)
    prompts = smoke_workload(cfg.vocab_size)
    sync = torch.cuda.synchronize
    launches = dict.fromkeys(ops.launch_counts(), 0)
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
        # the paged engine's attention reads its pool through the table
        assert counts["paged_prefill"] == 0, counts
        if fusion == "on":
            assert counts["paged_prefill_pool"] > 0
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
    assert counts["paged_prefill_pool"] == 0, counts
    for k, n in counts.items():
        launches[k] += n
    lap("engines: paged fusion on and off, slot")

    # the profiles take PROFILE_NEW tokens a prompt: the profiler's
    # fold-up, not the run, costs most of their time
    args.decode_fusion = "on"
    engine = serve.build_engine(args, model, params)
    secs, busy, rows = profile_engine(
        torch, lambda: run_engine(engine, prompts, PROFILE_NEW, sync)[1])
    ours = sum(us for us, _, key in rows if "paged_" in key) / 1e6
    log(f"profile engine bf16 28 layers decode_fusion=on: wall {secs:.3f}s "
        f"under the profiler, device busy {busy:.3f}s "
        f"({100 * busy / secs:.1f}%), attention kernels {ours:.3f}s "
        f"({100 * ours / max(busy, 1e-9):.1f}% of busy)")
    for us, n, key in rows[:10]:
        log(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:90]}")
    combine = [r for r in rows if "combine" in r[2]]
    assert combine, "the split decode steps must run the combine pass"
    for us, n, key in combine:
        log(f"  combine pass: {us / 1e3:.2f} ms {n}x  {key[:90]}")
    # decode fusion off: every decode step through paged_attention
    args.decode_fusion = "off"
    engine = serve.build_engine(args, model, params)
    secs, busy, rows = profile_engine(
        torch, lambda: run_engine(engine, prompts, PROFILE_NEW, sync)[1])
    decode = [r for r in rows if "paged_attention_kernel" in r[2]]
    assert decode, "the fusion-off decode steps must run paged_attention"
    log(f"profile engine bf16 28 layers decode_fusion=off: wall {secs:.3f}s "
        f"under the profiler, device busy {busy:.3f}s "
        f"({100 * busy / secs:.1f}%), paged_attention "
        f"{sum(r[0] for r in decode) / 1e3:.2f} ms in "
        f"{sum(r[1] for r in decode)} launches")
    for us, n, key in rows[:6]:
        log(f"  {us / 1e3:9.2f} ms {n:6d}x  {key[:90]}")
    lap("profiles of fusion on and off")

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
    lap("float32 2 layers, three engines")

    phase_done("4")

    # 4b. the serial scheduler, speculative decoding, observability
    for k, n in engine_features_phase(torch, ops, ref, serve, model, params,
                                      small_model, small_params, prompts,
                                      sync, validate, smi).items():
        launches[k] += n

    phase_done("4b")

    # 4c. the cluster tier: replicas of the one qwen3-0.6b weight copy
    for k, n in cluster_phase(torch, ops, serve, model, params, small_model,
                              small_params, prompts, sync, validate,
                              smi).items():
        launches[k] += n

    phase_done("4c")

    # 4g. the int8 KV cache on the same qwen3-0.6b weights (run here, while
    # they are loaded)
    for k, n in int8_phase(torch, device, ops, ref, serve, Model,
                           ragged_dispatch, write_slot, validate, sync, smi,
                           model, params, small_model, small_params,
                           prompts).items():
        launches[k] += n

    phase_done("4g")

    # 4d. phi4-mini-3.8b and qwen1.5-110b, the qwen3 models freed first
    del model, params, small_model, small_params, engine
    torch.cuda.empty_cache()
    for k, n in dense_phase(torch, device, ops, ref, serve, Model,
                            ragged_dispatch, write_slot, validate, sync,
                            smi).items():
        launches[k] += n

    phase_done("4d")

    # 4e. gemma3-4b at its published width: windowed layers, head_dim 256
    g_launches, g_errs = gemma3_phase(torch, device, ops, ref, serve,
                                      ragged_dispatch, validate, sync, smi)
    for k, n in g_launches.items():
        launches[k] += n
    for k, err in g_errs.items():
        errs[k] = max(errs[k], err)

    phase_done("4e")

    # 4f. dbrx-132b, grok-1-314b and jamba-1.5-large-398b: MoE and mamba
    for k, n in moe_phase(torch, device, ops, ref, serve, Model,
                          ragged_dispatch, write_slot, validate, sync,
                          smi).items():
        launches[k] += n

    phase_done("4f")

    # 4h. whisper-tiny and paligemma-3b: the encoder-decoder and prefix-LM
    for k, n in frontend_phase(torch, device, ops, ref, Model, smi).items():
        launches[k] += n

    phase_done("4h")

    # 5. rwkv6-1.6b through the slot and paged engines
    launches["rwkv6_scan"] += rwkv6_phase(torch, device, ops, ref, serve,
                                          Model, write_slot, validate, sync)

    phase_done("5")

    # 6. the paper's digit pipeline
    errs["conv2d"], launches["conv2d"] = digit_phase(torch, device, ops, ref)

    phase_done("6")

    # 6b. the digit pipeline trained on the card
    errs["conv2d_wgrad"], train_counts = training_phase(torch, device, ops,
                                                        ref, smi)
    log(f"conv2d launches: serving {launches['conv2d']}, training budget "
        f"run {train_counts['conv2d']}")
    launches["conv2d"] += train_counts["conv2d"]
    launches["conv2d_wgrad"] = train_counts["conv2d_wgrad"]

    phase_done("6b")

    # 6c. LLM training through the train CLI's path
    for k, n in llm_training_phase(torch, device, ops, ref, smi).items():
        launches[k] += n

    phase_done("6c")

    # bf16 paged_prefill launches of every entry by tile, phases 3-6c
    log(f"paged_prefill bf16 launches by tile over phases 3-6c: Hopper "
        f"tile {pp_mod.TILE_LAUNCHES['wgmma']}, kWarpKeys mma.sync tile "
        f"{pp_mod.TILE_LAUNCHES['mma']}")
    assert min(pp_mod.TILE_LAUNCHES.values()) > 0, pp_mod.TILE_LAUNCHES

    # 7. times
    lap = lapper("7")
    times = kernel_times(torch, device, ops, ref)
    lap("kernel_times")
    int8_times = int8_kernel_times(torch, device, ops, ref)
    lap("int8_kernel_times")
    pool_times = pool_kernel_times(torch, device, ops, ref)
    lap("pool_kernel_times")
    phase_done("7")

    # 8. the dry-run and the roofline of a whole step
    roofline_phase(torch, device, Model, smi)

    phase_done("8")
    one = torch.zeros(1, device=device)
    log(f"time floor: one launch on one element (add_), same timing: "
        f"{time_ms(torch, lambda: one.add_(1)):.4f} ms; graph-replayed: "
        f"{graph_ms(torch, lambda: one.add_(1)):.4f} ms")
    for name, key, what in (
            ("flash_attention", "flash_attention_512",
             "one causal row of S=512"),
            ("flash_attention", "flash_attention_2048",
             "one causal row of S=2048"),
            ("paged_prefill", "paged_prefill",
             "a chunk (4 rows, S=256, 512 prefix lanes)"),
            ("paged_prefill", "paged_prefill_s1",
             "fused decode (8 rows, S=1, 512 prefix lanes)"),
            ("paged_prefill", "paged_prefill_slot",
             "slot decode (4 slots, S=1, 256 lanes)"),
            ("paged_prefill", "paged_prefill_verify",
             "spec verify (16 rows: 8 windows of 5 lanes, 2 chunks, S=16, "
             "256 prefix lanes)"),
            *(("flash_attention", f"flash_attention_draft_{s}",
               f"a draft forward (one causal row of S={s})")
              for s, _ in DRAFT_SHAPES),
            ("paged_attention", "paged_attention",
             "paged decode (8 rows, 32 blocks of 16, 16/8 heads)"),
            *((kernel, f"{prefix}{arch}", f"{what} at {arch}'s heads "
               f"({h}/{kv})")
              for arch, (h, kv) in DENSE_HEADS.items()
              for kernel, prefix, what in (
                  ("paged_prefill", "paged_prefill_s1_",
                   "fused decode (8 rows, S=1, 512 prefix lanes)"),
                  ("paged_prefill", "paged_prefill_",
                   "a chunk (4 rows, S=256, 512 prefix lanes)"),
                  ("paged_attention", "paged_attention_",
                   "paged decode (8 rows, 16 blocks of 16)"),
                  ("flash_attention", "flash_attention_512_",
                   "one causal row of S=512")))):
        t = times[key]
        split = (f", key ranges split={t['split']}" if "split" in t
                 else "")
        if "tile" in t:
            split += f", tile {t['tile']}"
        if "ctas" in t:
            split += f" ({t['ctas']} CTAs)"
        if "whole_ms" in t:
            split += f" (whole ranges: {t['whole_ms']:.4f} ms)"
        log(f"time {name} bf16 "
            f"at {what}: {t['ms']:.4f} ms (graph-replayed "
            f"{t['graph_ms']:.4f}), bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), plain {t['plain_ms']:.4f} ms, sdpa "
            f"{t['library_ms']:.4f} ms (graph-replayed "
            f"{t['library_graph_ms']:.4f}), kernel / sdpa "
            f"{t['ms'] / t['library_ms']:.2f}{split}")
    for key, t in times.items():
        if "_hd256_" not in key:
            continue
        split = f", key ranges split={t['split']}"
        if "tile" in t:
            split += f", tile {t['tile']}"
        if "ctas" in t:
            split += f" ({t['ctas']} CTAs)"
        if "whole_ms" in t:
            split += f" (whole ranges: {t['whole_ms']:.4f} ms)"
        log(f"time {t['kernel']} bf16 at {t['what']} at gemma3-4b's heads "
            f"(8/4 of 256), window {t['window']}: {t['ms']:.4f} ms "
            f"(graph-replayed {t['graph_ms']:.4f}), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms "
            f"(graph-replayed {t['library_graph_ms']:.4f}; backend "
            f"{t['backend']}), kernel / sdpa "
            f"{t['ms'] / t['library_ms']:.2f}{split}")
    for key, t in times.items():
        if "_fe_" not in key:
            continue
        split = f", key ranges split={t['split']}"
        if "tile" in t:
            split += f", tile {t['tile']}"
        if "whole_ms" in t:
            split += f" (whole ranges: {t['whole_ms']:.4f} ms)"
        log(f"time {t['kernel']} bf16 at {t['what']}: {t['ms']:.4f} ms "
            f"(graph-replayed {t['graph_ms']:.4f}), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}), plain "
            f"{t['plain_ms']:.4f} ms, sdpa {t['library_ms']:.4f} ms "
            f"(graph-replayed {t['library_graph_ms']:.4f}; backend "
            f"{t['backend']}), kernel / sdpa "
            f"{t['ms'] / t['library_ms']:.2f}{split}")
    records = []
    for name, key, replaces in (
            ("flash_attention", "flash_attention_512",
             "src/repro/kernels/flash_attention.py:92"),
            ("paged_attention", "paged_attention",
             "src/repro/kernels/paged_attention.py:96"),
            ("paged_prefill", "paged_prefill",
             "src/repro/kernels/ops.py:87")):
        t = times[key]
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "graph_ms": t["graph_ms"]})
    for key, t in int8_times.items():
        log(f"time {t['kernel']} bf16 at {t['what']}: {t['ms']:.4f} ms "
            f"(graph-replayed {t['graph_ms']:.4f}), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes), "
            f"the bf16 kernel on the dequantized keys {t['bf16_ms']:.4f} ms "
            f"(graph-replayed {t['bf16_graph_ms']:.4f}; int8 / bf16 graph "
            f"{t['graph_ms'] / t['bf16_graph_ms']:.2f}), plain "
            f"{t['plain_ms']:.4f} ms, no library call reads int8 K/V (SDPA "
            f"over the dequantized bf16 keys {t['sdpa_ms']:.4f} ms, "
            f"graph-replayed {t['sdpa_graph_ms']:.4f})")
    for name, key, replaces in (
            ("paged_attention_int8", "paged_attention_int8",
             "src/repro/kernels/paged_attention.py:96"),
            ("paged_prefill_int8", "paged_prefill_int8",
             "src/repro/kernels/ops.py:87")):
        t = int8_times[key]
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "graph_ms": t["graph_ms"]})
    for key, t in pool_times.items():
        log(f"time {t['kernel']} bf16 at {t['what']}: {t['ms']:.4f} ms "
            f"(graph-replayed {t['graph_ms']:.4f}); the parent's composed "
            f"path (gather, cursor guard, concat, contiguous entry) "
            f"{t['composed_ms']:.4f} ms (graph-replayed "
            f"{t['composed_graph_ms']:.4f}; pool / composed graph "
            f"{t['graph_ms'] / t['composed_graph_ms']:.2f}), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes), "
            f"plain {t['plain_ms']:.4f} ms, sdpa on the gathered keys "
            f"{t['library_ms']:.4f} ms (graph-replayed "
            f"{t['library_graph_ms']:.4f}), key ranges split={t['split']}, "
            f"tile {t['tile']}")
    for name in ("paged_prefill_pool", "paged_prefill_pool_int8"):
        t = pool_times[name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/" + ("paged_prefill_int8.cu"
                                                 if name.endswith("int8")
                                                 else "paged_prefill.cu"),
            "replaces": "src/repro/kernels/ops.py:87",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None if name.endswith("int8")
            else t["library_ms"],
            "graph_ms": t["graph_ms"], "composed_ms": t["composed_ms"],
            "composed_graph_ms": t["composed_graph_ms"]})
    t = times["paged_attention"]
    sweep = ", ".join(f"{nb} blocks / {c}: {ms:.4f}"
                      for (nb, c), ms in t["sweep"].items())
    log(f"time paged_attention bf16 by blocks per piece (table width / "
        f"blocks per piece: ms): {sweep}")
    from repro_torch.kernels import attention_split
    from repro_torch.kernels import conv2d as cv_mod
    from repro_torch.kernels import paged_attention as pa_mod
    res, fixed, combine, per_sm, tau, base = fit_planner(t["sweep"],
                                                         attention_split)
    log(f"planner fit to that sweep: fixed={fixed} combine={combine} "
        f"ctas_per_sm={per_sm} (block time {tau:.5f} ms, base {base:.4f} "
        f"ms, rms residual {res:.5f} ms); in use: fixed="
        f"{pa_mod.FIXED_BLOCKS:g} combine={pa_mod.COMBINE_BLOCKS:g} "
        f"ctas_per_sm={pa_mod.CTAS_PER_SM:g}")
    for key, what in (("rwkv6_scan_1x200", "one prompt row of S=200"),
                      ("rwkv6_scan_4x1", "a decode step over 4 slots")):
        t = times[key]
        log(f"time rwkv6_scan float32 at {what} (32 heads of 64): "
            f"{t['ms']:.4f} ms (graph-replayed {t['graph_ms']:.4f}), "
            f"bound {t['bound_ms']:.4f} ms "
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
        "bound_by": t["bound_by"], "library_ms": None,
        "graph_ms": t["graph_ms"]})
    for b, s in SSM_TIMED:
        for suffix, what in (("", "float32"), ("_bf16", "bf16 x and y")):
            t = times[f"ssm_scan_{b}x{s}{suffix}"]
            log(f"time ssm_scan {what} at {b} rows S={s} (d_inner "
                f"{SSM_D_INNER}, 16 states): {t['ms']:.4f} ms (graph-"
                f"replayed {t['graph_ms']:.4f}), bound {t['bound_ms']:.4f} "
                f"ms ({t['bound_by']}: {t['bytes']} bytes), SFU floor "
                f"{t['sfu_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, no "
                f"library call; {t['slot']}")
    t = times["ssm_scan_8x256_bf16"]    # a whole chunk of 8 rows, as jamba
    records.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/models/ssm.py:113",
        "launches": launches["ssm_scan"],
        "max_abs_err": errs["ssm_scan"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "graph_ms": t["graph_ms"]})
    for key, t in times.items():
        if not key.startswith(("rwkv6_scan_bwd_", "ssm_scan_bwd_")):
            continue
        sfu = (f", SFU floor {t['sfu_ms']:.4f} ms" if "sfu_ms" in t else "")
        log(f"time {key} (float32{', x ' + t['x_dtype'] if 'x_dtype' in t else ''}): "
            f"{t['ms']:.4f} ms (graph-replayed {t['graph_ms']:.4f}), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes, "
            f"{t['flops']} FLOP){sfu}, plain {t['plain_ms']:.4f} ms, no "
            "library call (no PyTorch call computes the scan's VJP)")
    for name, key, replaces in (
            ("rwkv6_scan_bwd", "rwkv6_scan_bwd_8x128",
             "src/repro/models/rwkv6.py:190"),
            ("ssm_scan_bwd", "ssm_scan_bwd_8x128_bfloat16",
             "src/repro/models/ssm.py:134")):
        t = times[key]                  # the training shapes
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "graph_ms": t["graph_ms"]})
    for b in (1, 32, 2000):
        t = times[f"conv2d_{b}"]
        pl = cv_mod.launch_plan((b, 28, 28, 1), (3, 3, 1, 32), torch.float32,
                                attention_split.sm_count(device))
        log(f"time conv2d float32 at B={b} (28x28x1 images, 32 filters of "
            f"3x3): {t['ms']:.4f} ms (graph-replayed {t['graph_ms']:.4f}), "
            f"bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} bytes read and written), "
            f"plain {t['plain_ms']:.4f} ms, cudnn {t['library_ms']:.4f} ms "
            f"(graph-replayed {t['library_graph_ms']:.4f}; TF32 off); {pl}")
        if "sweep" in t:
            log(f"time conv2d float32 at B={b} by forced plan ((band rows, "
                f"CTAs per SM, ring slots): event / graph-replayed ms): "
                + ", ".join(f"{k}: {e:.4f} / {g:.4f}"
                            for k, (e, g) in t["sweep"].items()))
    t = times["conv2d_32"]              # the micro-batched consumer's batch
    records.append({
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d.py:37",
        "launches": launches["conv2d"], "max_abs_err": errs["conv2d"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "graph_ms": t["graph_ms"]})
    for b in WGRAD_BATCHES:
        t = times[f"conv2d_wgrad_{b}"]
        log(f"time conv2d_wgrad float32 at B={b} (28x28x1 images, 32 "
            f"filters of 3x3): {t['ms']:.4f} ms (graph-replayed "
            f"{t['graph_ms']:.4f}), bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} bytes read and written), plain "
            f"{t['plain_ms']:.4f} ms, torch.nn.grad.conv2d_weight "
            f"{t['library_ms']:.4f} ms (graph-replayed "
            f"{t['library_graph_ms']:.4f}; TF32 off), dy.sum() over the "
            f"same dy {t['read_ms']:.4f} ms graph-replayed; {t['plan']}")
        log(f"time conv2d_wgrad float32 at B={b} by forced plan ((CTAs per "
            f"SM, cluster, most ring slots, pairs a slot, consumer warps): "
            f"event / graph-replayed ms): "
            + ", ".join(f"{k}: {e:.4f} / {g:.4f}"
                        for k, (e, g) in t["sweep"].items()))
    t = times["conv2d_wgrad_64"]        # one worker's training microbatch
    records.append({
        "name": "conv2d_wgrad", "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_wgrad.cu",
        "replaces": "src/repro/models/cnn.py:43",
        "launches": launches["conv2d_wgrad"],
        "max_abs_err": errs["conv2d_wgrad"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "graph_ms": t["graph_ms"]})
    unlaunched = [r["name"] for r in records if r["launches"] < 1]
    assert not unlaunched, f"the main paths never launched {unlaunched}"
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
