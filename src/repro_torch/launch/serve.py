"""Serving launcher: continuous-batching LLM inference through the paged
engine (default) or the fixed-slot engine (``--engine slot``), on the
card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
        --no-reduced --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --engine slot \\
        --slots 4 --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --no-reduced
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch jamba-1.5-large-398b --device cpu --engine slot
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \\
        --no-reduced --cache-max 2304

Takes the flags of ``repro.launch.serve`` and prints the same ``req N:
[...]`` lines.  ``--reduced`` (the default, as in the reference) serves
the CPU-smoke variant of the config in float32; ``--no-reduced`` serves
the published width in the config's dtype.  Weights are drawn from
``--seed`` by the port's own initialiser, so tokens agree with other runs
of this launcher, not with the reference's.  ``--decode-fusion on``
(default) runs decode rows through the ragged prefill dispatch
(``paged_prefill`` kernel); ``off`` runs the separate decode dispatch
(``paged_attention`` kernel).  The slot engine prefills each prompt
whole (``flash_attention`` kernel) and decodes every slot through
``paged_prefill`` with one query lane; as in the reference, it takes
``--slots`` and ``--cache-max`` and ignores the paged-only flags.
``--engine`` defaults to paged for every stack that pages (all the
port carries), as in the reference.  Recurrent stacks serve on both
engines: rwkv6-1.6b's recurrence in the ``rwkv6_scan`` kernel, jamba's
mamba layers in ``ssm_scan``, their states in per-request slots beside
the paged pool; the prefix cache is off for them and ``--spec-decode``
is refused, as in the reference.  dbrx-132b, grok-1-314b and jamba's
MoE FFNs serve on both engines (at full width, cut in depth to fit a
card: see ``chip_smoke.py``).

``--scheduler serial`` admits one request a step, prefills its whole
prompt (``paged_prefill``) and decodes in the separate dispatch
(``paged_attention``).  ``--spec-decode ngram`` drafts up to
``--spec-k`` tokens per request by prompt lookup, ``--spec-decode
draft`` with the target's first ``--draft-layers`` layers (their
forwards through ``flash_attention``); the target verifies each window
in the ragged ``paged_prefill`` dispatch, token-identical to ``off``.
``--metrics`` prints the Prometheus text page at exit, ``--trace-out
PATH`` writes a Chrome trace-event JSON of the run.

gemma3-4b mixes sliding-window (``attn_local``, window 1,024) and global
layers; both engines serve it, its head_dim 256 in the same three
kernels.  ``--window-accounting on`` (default) frees a request's blocks
once they slide out of the window where every layer is windowed; as in
the reference it is inert on every stock architecture (gemma3-4b's
global layers read the whole prefix), and ``off`` keeps the
window-blind accounting.  The gauge line shows ``wfreed=`` once a block
was so freed.

``--replicas N`` (N > 1, paged engine only) serves through the cluster
tier (``serving/cluster.py``): N broker-fed paged-engine replicas behind
the occupancy-aware balancer, sharing one copy of the weights, each with
its own block pool.  ``--affinity on`` (default) routes each request to
the replica already holding its longest cached prefix, ``off`` leaves
routing to the balancer's policy; saturation rejects a submission with a
counted 429.  The workload is the reference CLI's: half of each prompt is
one of up to 4 tenant prefixes, drawn from ``--seed``.  It prints the
``[cluster]`` and ``[lb]`` gauge lines and ``req N: ... rM via
affinity|policy`` routing tags; ``--metrics`` prints the replicas'
registries merged into one page.

    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \\
        --replicas 2 --affinity on --requests 8 --prompt-len 32

Flags of features the port does not carry yet are refused with a
message: ``--decode-kernel off``.  ``--replicas`` and ``--spec-decode`` with
``--engine slot`` exit with the reference's "needs the paged engine", and
``--trace-out`` with ``--replicas`` with its "per-engine" refusal.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models.api import Model
from repro_torch.obs import Observability
from repro_torch.serving.cluster import Rejected, ServingCluster
from repro_torch.serving.server import LLMEngine, PagedLLMEngine
from repro_torch.serving.spec_decode import layer_truncated_draft


def _fmt_stats(stats: dict) -> str:
    """Render the stats-schema gauges (``serving/stats_schema.py``) or,
    for a balancer snapshot (``LoadBalancer.stats()``), its dispatch
    counters with each replica's engine gauges."""
    if "replica_loads" in stats:
        line = (f"[lb] picks={stats.get('picks', 0)} "
                f"rejections={stats.get('rejections', 0)} "
                f"releases={stats.get('releases', 0)} "
                f"imbalance={stats.get('imbalance', 0.0):.2f} "
                f"loads={stats.get('replica_loads', [])}")
        for rid, es in sorted(stats.get("engines", {}).items()):
            line += f"\n  r{rid} " + _fmt_stats(es)
        return line
    if stats.get("engine") == "cluster":
        return (f"[cluster] replicas={stats.get('replicas', 0)} "
                f"affinity={'on' if stats.get('affinity') else 'off'} "
                f"hits={stats.get('affinity_hits', 0)} "
                f"misses={stats.get('affinity_misses', 0)} "
                f"429={stats.get('rejected_429', 0)} "
                f"submitted={stats.get('submitted', 0)} "
                f"finished={stats.get('finished', 0)}")
    line = (f"[{stats.get('engine', '?')}] "
            f"queue={stats.get('queue_depth', 0)} "
            f"active={stats.get('active', 0)} "
            f"blocks={stats.get('used_blocks', 0)}"
            f"/{stats.get('total_blocks', 0)} "
            f"occ={stats.get('pool_occupancy', 0.0):.2f} "
            f"preempt={stats.get('preemptions', 0)} "
            f"finished={stats.get('finished', 0)} "
            f"compiles={stats.get('prefill_compiles', 0)}"
            f"p/{stats.get('decode_compiles', 0)}d")
    if stats.get("prefix_cache"):
        line += (f" hit={stats.get('hit_rate', 0.0):.2f} "
                 f"cached={stats.get('cached_blocks', 0)} "
                 f"evict={stats.get('evictions', 0)}")
    if stats.get("window_blocks_freed"):
        line += f" wfreed={stats.get('window_blocks_freed', 0)}"
    return line


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the CPU-smoke variant (default); "
                         "--no-reduced serves the published width")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--engine", choices=("paged", "slot"), default=None,
                    help="paged: block-paged continuous batching; slot: "
                         "fixed cache slots, whole-prompt prefill "
                         "(default: paged where the stack pages)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4,
                    help="cache slots of the slot engine")
    ap.add_argument("--num-blocks", type=int, default=32)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="on",
                    help="radix-tree block reuse across shared prompt "
                         "prefixes")
    ap.add_argument("--decode-kernel", choices=("auto", "on", "off"),
                    default="auto",
                    help="auto/on: the decode dispatch reads through the "
                         "paged_attention kernel (off is not ported)")
    ap.add_argument("--prefill-buckets", default="auto",
                    help="prefill length bucketing: auto (powers of two), "
                         "off (exact shapes), or a comma list like 8,16,64")
    ap.add_argument("--scheduler", choices=("continuous", "serial"),
                    default="continuous",
                    help="continuous: multi-admission + chunked prefill "
                         "interleaved with decode; serial: one whole-"
                         "prompt admission per step (paged engine only)")
    ap.add_argument("--prefill-chunk", type=int, default=256,
                    help="prompt tokens per prefill chunk (snapped to a "
                         "length bucket and capped by --cache-max)")
    ap.add_argument("--step-token-budget", type=int, default=None,
                    help="max prompt tokens prefilled per engine step "
                         "(default: one chunk)")
    ap.add_argument("--spec-decode", choices=("off", "ngram", "draft"),
                    default="off",
                    help="speculative decoding: ngram = prompt-lookup "
                         "drafting, draft = the target's first "
                         "--draft-layers layers; tokens stay identical to "
                         "off (paged engine, continuous scheduler only)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max drafted tokens per request per step")
    ap.add_argument("--decode-fusion", choices=("on", "off"), default="on",
                    help="run decode through the fused ragged dispatch as "
                         "length-1 windows (on) or the separate decode "
                         "dispatch (off)")
    ap.add_argument("--window-accounting", choices=("on", "off"),
                    default="on",
                    help="eagerly free KV blocks that slide out of a "
                         "bounded attention window (stacks with no global "
                         "layer; off = window-blind block accounting)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through the cluster tier with N broker-"
                         "fed engine replicas (paged engine only)")
    ap.add_argument("--affinity", choices=("on", "off"), default="on",
                    help="prefix-affinity routing: send each request to "
                         "the replica already holding its longest cached "
                         "prefix (cluster tier only)")
    ap.add_argument("--draft-layers", type=int, default=1,
                    help="layers kept in the --spec-decode draft "
                         "truncation")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-max", type=int, default=128,
                    help="per-request cache strip (slot) / max_len (paged)")
    ap.add_argument("--stats-every", type=int, default=16)
    ap.add_argument("--metrics", action="store_true",
                    help="print the Prometheus text exposition at exit")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(open in Perfetto)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def check_args(args) -> None:
    """Refuse what the reference CLI refuses, and flags of features the
    port does not carry yet."""
    if args.engine == "slot":
        if args.replicas > 1:
            raise SystemExit("--replicas needs the paged engine")
        if args.spec_decode != "off":
            raise SystemExit("--spec-decode needs the paged engine")
    if args.replicas > 1 and args.trace_out:
        raise SystemExit("--trace-out is per-engine; not supported "
                         "with --replicas")
    if args.decode_kernel == "off":
        raise SystemExit("--decode-kernel off: the plain decode gather is "
                         "not ported to repro_torch yet")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is "
                         "False (pass --device cpu to run on the CPU)")


def build_model(args):
    """-> (cfg, model, params) for ``args.arch`` at the chosen width,
    weights drawn from ``args.seed``; an unset ``--engine`` resolves to
    paged where the stack pages, as in the reference CLI, which refuses
    the frontend configs (whisper-tiny, paligemma-3b) after reading
    them."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend != "none" or cfg.is_encoder_decoder:
        raise SystemExit(f"{cfg.name}: serve CLI drives text-only decode; "
                         "use examples/serve_digits.py for the full app")
    model = Model(cfg, device=args.device)
    if args.engine is None:
        args.engine = "paged" if model.supports_paged else "slot"
    return cfg, model, model.init(args.seed)


def build_engine(args, model, params, obs=None):
    if args.engine == "slot":
        return LLMEngine(model, params, num_slots=args.slots,
                         cache_max=args.cache_max, obs=obs)
    buckets = args.prefill_buckets
    if buckets not in ("auto", "off"):
        buckets = [int(b) for b in buckets.split(",")]
    draft_model = draft_params = None
    if args.spec_decode == "draft":
        draft_model, draft_params = layer_truncated_draft(
            model, params, args.draft_layers)
    return PagedLLMEngine(model, params, num_blocks=args.num_blocks,
                          block_size=args.block_size,
                          max_batch=args.max_batch,
                          max_len=args.cache_max,
                          prefix_cache=args.prefix_cache == "on",
                          prefill_buckets=buckets,
                          scheduler=args.scheduler,
                          prefill_chunk=args.prefill_chunk,
                          step_token_budget=args.step_token_budget,
                          spec_decode=args.spec_decode,
                          spec_k=args.spec_k,
                          draft_model=draft_model,
                          draft_params=draft_params,
                          decode_fusion=args.decode_fusion == "on",
                          window_accounting=args.window_accounting == "on",
                          obs=obs)


def main(argv=None):
    args = make_parser().parse_args(argv)
    check_args(args)
    cfg, model, params = build_model(args)
    if args.replicas > 1:
        _serve_cluster(args, cfg, model, params)
        return
    obs = None
    if args.metrics or args.trace_out:
        obs = Observability.create(trace=args.trace_out is not None)
    engine = build_engine(args, model, params, obs=obs)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=(args.prompt_len,)).astype(np.int32)
        engine.submit(prompt, max_new=args.max_new, now=time.time() - t0)

    finished = []
    steps = 0
    while not engine.idle:
        finished.extend(engine.step(now=time.time() - t0))
        steps += 1
        if args.stats_every and steps % args.stats_every == 0:
            print(_fmt_stats(engine.stats()))
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in finished)
    print(f"{len(finished)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s, {steps} engine steps, "
          f"engine={args.engine}, device={args.device})")
    print(_fmt_stats(engine.stats()))
    for r in finished[:3]:
        print(f"  req {r.rid}: {len(r.out_tokens)} tokens "
              f"{r.out_tokens[:8]}...")
    if obs is not None and args.trace_out:
        n = obs.trace.export(args.trace_out)
        print(f"trace: {n} events -> {args.trace_out}")
    if obs is not None and args.metrics:
        print(obs.metrics.render(), end="")


def _serve_cluster(args, cfg, model, params):
    """Drive ``--requests`` prompts through the cluster tier, as the
    reference CLI does: half of each prompt is one of a few tenant
    prefixes, so ``--affinity on`` has something to route on, and a
    saturated cluster counts 429s instead of stalling.  Every replica is
    built from the one ``(model, params)``."""
    cluster = ServingCluster(
        lambda i: build_engine(args, model, params),
        args.replicas, affinity=args.affinity == "on",
        seed=args.seed, obs=args.metrics)
    rng = np.random.default_rng(args.seed)
    tenants = [rng.integers(1, cfg.vocab_size,
                            max(args.prompt_len // 2, 1)).astype(np.int32)
               for _ in range(min(4, args.requests))]
    t0 = time.time()
    rejected = 0
    for i in range(args.requests):
        tail = rng.integers(1, cfg.vocab_size,
                            size=(max(args.prompt_len
                                      - len(tenants[0]), 1),))
        prompt = np.concatenate([tenants[i % len(tenants)],
                                 tail.astype(np.int32)])
        try:
            cluster.submit(prompt, max_new=args.max_new,
                           now=time.time() - t0)
        except Rejected:
            rejected += 1
    finished = []
    steps = 0
    while not cluster.idle:
        finished.extend(cluster.step(now=time.time() - t0))
        steps += 1
        if args.stats_every and steps % args.stats_every == 0:
            print(_fmt_stats(cluster.stats()))
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in finished)
    print(f"{len(finished)} requests ({rejected} rejected 429), "
          f"{total_new} tokens in {dt:.2f}s ({total_new/dt:.1f} tok/s, "
          f"{steps} cluster steps, replicas={args.replicas}, "
          f"device={args.device})")
    print(_fmt_stats(cluster.stats()))
    print(_fmt_stats(cluster.balancer.stats()))
    for r in sorted(finished, key=lambda r: r.cid)[:3]:
        print(f"  req {r.cid}: {len(r.out_tokens)} tokens "
              f"{r.out_tokens[:8]}... r{r.replica} via {r.routed_by}")
    if args.metrics:
        print(cluster.merged_metrics().render(), end="")


if __name__ == "__main__":
    main()
