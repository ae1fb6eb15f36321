"""Canonical ``stats()`` gauge-key schema for the serving engines.

The port keeps its own copy of ``repro.serving.stats_schema`` (the port
imports nothing of ``repro``): the keys, kinds and types are the same,
so a ``PagedLLMEngine.stats()`` dict from either package validates
against either copy.  ``launch/serve.py`` renders it (``_fmt_stats``).

Consumers must still read snapshots with ``.get()``: dicts persisted by
*older* engines may omit newer keys.  ``validate`` is strict in the
other direction — a *current* engine must emit exactly the keys its
kind declares here, no more and no fewer.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

BOTH = ("slot", "paged")
PAGED = ("paged",)
CLUSTER = ("cluster",)
#: every stats() producer kind: the two engines plus the multi-replica
#: serving tier (``serving/cluster.py``)
KINDS = BOTH + CLUSTER

NUM = (int, float)


@dataclasses.dataclass(frozen=True)
class GaugeSpec:
    doc: str
    engines: Tuple[str, ...] = BOTH
    types: tuple = NUM


SCHEMA = {
    "engine": GaugeSpec('"slot" | "paged" | "cluster"', KINDS,
                        types=(str,)),
    "queue_depth": GaugeSpec("requests waiting for admission"),
    "active": GaugeSpec("requests currently decoding"),
    "prefilling": GaugeSpec("admitted requests still streaming prompt "
                            "chunks into the pool", PAGED),
    "free_blocks": GaugeSpec("unallocated pool blocks (slot engine: "
                             "1 slot == 1 block)"),
    "used_blocks": GaugeSpec("allocated pool blocks"),
    "total_blocks": GaugeSpec("usable pool capacity"),
    "pool_occupancy": GaugeSpec("used_blocks / total_blocks"),
    "admissions": GaugeSpec("lifetime admissions"),
    "preemptions": GaugeSpec("lifetime preempt-and-requeues"),
    "finished": GaugeSpec("lifetime completed requests",
                          BOTH + CLUSTER),
    "peak_active": GaugeSpec("high-water concurrent requests", PAGED),
    "prefill_tokens": GaugeSpec("prompt tokens actually computed", PAGED),
    "prefix_cache": GaugeSpec("1 when the radix prefix cache is on",
                              PAGED),
    "hit_rate": GaugeSpec("prompt tokens served from cache / all prompt "
                          "tokens", PAGED),
    "cached_blocks": GaugeSpec("blocks currently held by the radix tree",
                               PAGED),
    "evictions": GaugeSpec("prefix-cache LRU evictions (lifetime)",
                           PAGED),
    "cow_copies": GaugeSpec("copy-on-write block copies (lifetime)",
                            PAGED),
    "prefill_compiles": GaugeSpec("distinct prefill shapes traced so far "
                                  "(stays O(#buckets) with bucketing on)"),
    "decode_compiles": GaugeSpec("distinct decode shapes traced so far"),
    "decode_kernel": GaugeSpec("1 when decode attention actually ran "
                               "through the paged-attention kernel", PAGED),
    "decode_fusion": GaugeSpec("1 when spec-off decode rides the fused "
                               "ragged dispatch as length-1 verify "
                               "windows (one dispatch per step)",
                               PAGED),
    "admission_skips": GaugeSpec("head-of-line skips: admissions where a "
                                 "blocked queue head was passed over for "
                                 "a later admissible request (lifetime)",
                                 PAGED),
    "spec_decode": GaugeSpec('speculative decoding drafter: "off" | '
                             '"ngram" | "draft"', PAGED, types=(str,)),
    "spec_k": GaugeSpec("max drafted tokens per request per step "
                        "(0 when spec decoding is off)", PAGED),
    "accepted_tokens_per_step": GaugeSpec(
        "mean tokens emitted per verify row (accepted drafts + bonus); "
        "1.0 == plain decode, the speculative speedup upper bound",
        PAGED),
    "draft_hit_rate": GaugeSpec("drafted tokens accepted / drafted "
                                "tokens proposed", PAGED),
    "spec_rollbacks": GaugeSpec("verify rows that discarded "
                                "speculatively written lanes (lifetime)",
                                PAGED),
    "window_blocks_freed": GaugeSpec(
        "blocks eagerly released after sliding wholly out of the live "
        "attention window (lifetime; 0 when some layer is global or "
        "window accounting is off)", PAGED),
    "state_slots_used": GaugeSpec(
        "recurrent-state slots held by admitted requests (hybrid "
        "mamba/rwkv6 stacks; 0 for pure-attention stacks)", PAGED),
    # ---- cluster tier (``serving/cluster.py``) ----
    "replicas": GaugeSpec("engine replicas in the fleet", CLUSTER),
    "affinity": GaugeSpec("1 when prefix-affinity routing is on",
                          CLUSTER),
    "affinity_hits": GaugeSpec("dispatches routed to the replica "
                               "already holding the request's longest "
                               "cached prefix (lifetime)", CLUSTER),
    "affinity_misses": GaugeSpec("dispatches with no usable prefix "
                                 "owner — fell back to the balancer "
                                 "policy (lifetime)", CLUSTER),
    "rejected_429": GaugeSpec("submissions refused with backpressure: "
                              "balancer saturated or broker partition "
                              "full (lifetime)", CLUSTER),
    "submitted": GaugeSpec("submissions accepted into the broker "
                           "(lifetime)", CLUSTER),
}


def validate(stats: dict) -> dict:
    """Raise ``ValueError`` unless ``stats`` carries exactly the keys
    its engine kind declares, each with a schema-conformant type.
    Returns ``stats`` unchanged so calls chain."""
    engine = stats.get("engine")
    if engine not in KINDS:
        raise ValueError(f"stats['engine'] must be one of {KINDS}, "
                         f"got {engine!r}")
    missing = [k for k, spec in SCHEMA.items()
               if engine in spec.engines and k not in stats]
    if missing:
        raise ValueError(f"{engine} stats missing keys: {missing}")
    unknown = [k for k in stats
               if k not in SCHEMA or engine not in SCHEMA[k].engines]
    if unknown:
        raise ValueError(f"{engine} stats has undeclared keys: {unknown} "
                         "(add them to serving/stats_schema.py first)")
    bad = [k for k in stats if not isinstance(stats[k], SCHEMA[k].types)]
    if bad:
        raise ValueError(
            f"{engine} stats type mismatch: "
            + ", ".join(f"{k}={stats[k]!r}" for k in bad))
    return stats
