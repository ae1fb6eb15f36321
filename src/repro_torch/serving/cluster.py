"""Cluster serving tier: broker-fed paged-engine replicas behind one
load balancer, with prefix-affinity routing.

The port of ``repro.serving.cluster`` (it imports nothing of ``repro``).
The paper's stack is NGINX -> Kafka -> model replicas; here the
balancer (``serving/balancer.py``), the broker (``serving/broker.py``)
and N ``PagedLLMEngine`` replicas make one running system:

    client ──submit──> LoadBalancer (occupancy-aware p2c + affinity)
                │            │ pick replica r (or 429)
                └────────────▼
                Broker partition r  (bounded: full -> 429)
                        │ poll/commit, at-least-once
                        ▼
                PagedLLMEngine replica r   (x N, stepped in order)

* **One broker partition per replica.**  The balancer picks the
  replica and ``Broker.produce(partition=r)`` pins the record to its
  partition.  ``step()`` pumps each partition into its engine and
  commits offsets only once the engine has accepted the records, so a
  record is delivered at least once.
* **Backpressure is a 429 at submit**, never a drop: ``Overloaded``
  from the balancer or ``PartitionFull`` from the broker surfaces as
  ``Rejected``, and in both cases nothing was enqueued (a full
  partition cancels the balancer's hold).
* **Prefix-affinity routing.**  Each prompt is hashed per prefix block
  with the per-block token tuples the radix prefix cache keys on
  (``prefix_cache.chain_hashes``); a map remembers which replica last
  wrote each chain hash, and a request goes to the replica holding its
  longest hashed prefix, else to the balancer's policy.  On a cold map
  every replica's radix tree is probed (``prefix_probe``, free of side
  effects).  Routing only picks a replica: the replica's radix tree
  still compares exact tokens, so a hash collision costs a miss, never
  wrong KV.
* **Deterministic.**  ``step()`` pumps every partition, then steps
  every engine, in fixed replica order; the balancer's rng is seeded.
  The same submissions give the same ``route_log`` and tokens.

Replicas made by one ``make_engine`` from one ``(model, params)`` share
those parameters (one copy of the weights on the card); each owns its
block pool.  Each replica gets its own ``Observability`` bundle with
``replica``-labelled engine metrics; ``merged_metrics()`` folds them
with the registry's exact ``merge()``.  ``stats()`` follows the
``cluster`` kind of ``serving/stats_schema.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import MetricsRegistry, Observability
from repro_torch.serving.balancer import LoadBalancer, Overloaded
from repro_torch.serving.broker import Broker, PartitionFull
from repro_torch.serving.prefix_cache import chain_hashes


class Rejected(Exception):
    """Backpressure: the cluster refused a submission (HTTP-429
    semantics — the paper's locust runs count exactly these)."""

    status = 429


@dataclasses.dataclass
class ClusterRequest:
    """One client request's cluster-side ticket: routing decision at
    submit, outputs filled in when the owning replica finishes it."""

    cid: int
    prompt: np.ndarray
    max_new: int
    replica: int
    routed_by: str                     # "affinity" | "policy"
    submitted: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class ServingCluster:
    """N broker-fed ``PagedLLMEngine`` replicas behind one balancer.

    ``make_engine(i)`` builds replica ``i`` (all replicas must share
    ``block_size`` — the affinity chain hashes assume one block
    geometry fleet-wide).  ``queue_limit`` bounds how far each
    replica's in-flight count may exceed its engine's ``max_batch``
    before the balancer 429s; ``broker_depth`` bounds each partition.
    ``affinity=False`` keeps the map off — every dispatch goes through
    the balancer policy alone (the control arm).
    """

    GROUP = "cluster"

    def __init__(self, make_engine: Callable[[int], object],
                 num_replicas: int = 2, *, affinity: bool = True,
                 policy: str = "power_of_two", queue_limit: int = 16,
                 broker_depth: int = 256, seed: int = 0,
                 obs: bool = True):
        if num_replicas < 1:
            raise ValueError(f"num_replicas must be >= 1, "
                             f"got {num_replicas}")
        self.engines = [make_engine(i) for i in range(num_replicas)]
        sizes = {e.block_size for e in self.engines}
        if len(sizes) != 1:
            raise ValueError(f"replicas disagree on block_size: {sizes} "
                             "(affinity hashes need one geometry)")
        self.block_size = sizes.pop()
        self.affinity = bool(affinity)
        self.balancer = LoadBalancer(
            num_replicas,
            concurrency=min(e.max_batch for e in self.engines),
            queue_limit=queue_limit, policy=policy, seed=seed)
        for i, e in enumerate(self.engines):
            self.balancer.attach_engine_stats(e.stats, rid=i)
        self.broker = Broker(num_replicas, broker_depth, seed)
        self.replica_obs: List[Observability] = []
        if obs:
            self.attach_obs()
        # chain hash -> replica that last wrote that prefix block
        self._prefix_owner: Dict[int, int] = {}
        self._tickets: Dict[int, ClusterRequest] = {}
        # (replica, engine rid) -> ticket, while in an engine
        self._pending: Dict[Tuple[int, int], ClusterRequest] = {}
        self.route_log: List[Tuple[int, int, str]] = []
        self._cid = 0
        self.submitted = 0
        self.finished_count = 0
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.rejected_429 = 0

    # ------------------------------------------------------------ obs
    def attach_obs(self) -> None:
        """(Re-)bind a fresh per-replica ``Observability`` bundle to
        every engine, replica-labeled.  A caller that measures calls
        this between a warm-up pass and the measured one, so the merged
        histograms cover exactly one pass."""
        self.replica_obs = [Observability.create() for _ in self.engines]
        for i, (e, o) in enumerate(zip(self.engines, self.replica_obs)):
            e.attach_obs(o, replica=i)

    def merged_metrics(self) -> MetricsRegistry:
        """One fleet registry: every replica's snapshot folded in with
        the exact element-wise ``merge()`` (identical fixed histogram
        bounds make the add lossless).  Replica-labeled engine metrics
        stay distinguishable; the unlabeled ``request_*`` histograms
        sum into single fleet-wide latency distributions."""
        merged = MetricsRegistry()
        for o in self.replica_obs:
            merged.merge(o.metrics.snapshot())
        return merged

    # ------------------------------------------------------------ route
    def _affinity_candidate(self, prompt: np.ndarray,
                            hashes: List[int]) -> Optional[int]:
        """Replica holding the request's longest cached prefix, or
        None.  Fast path: walk the chain hashes longest-first through
        the owner map.  Cold map (e.g. nothing registered yet): probe
        every replica's radix tree directly — ``prefix_probe`` is
        side-effect free, so routing reads never perturb LRU order or
        hit-rate gauges."""
        for h in reversed(hashes):
            rid = self._prefix_owner.get(h)
            if rid is not None:
                return rid
        best, best_cov = None, 0
        for i, e in enumerate(self.engines):
            cov = e.prefix_probe(prompt)
            if cov > best_cov:
                best, best_cov = i, cov
        return best

    def submit(self, prompt, max_new: int = 16, now: float = 0.0) -> int:
        """Route one request: affinity lookup -> balancer pick ->
        broker produce, returning the cluster request id.  Raises
        ``Rejected`` (429) when the balancer is saturated or the picked
        replica's partition is full — in both cases NOTHING was
        enqueued, so a rejected request is never half-accepted."""
        prompt = np.asarray(prompt, np.int32)
        prefer = None
        hashes: List[int] = []
        if self.affinity:
            # the last token is reserved by the engines' own match path
            # (its logits produce the first output token)
            hashes = chain_hashes(prompt[:-1], self.block_size)
            prefer = self._affinity_candidate(prompt, hashes)
        try:
            rep = self.balancer.pick(prefer=prefer)
        except Overloaded:
            self.rejected_429 += 1
            raise Rejected("all replicas saturated") from None
        self._cid += 1
        cid = self._cid
        try:
            self.broker.produce({"cid": cid, "prompt": prompt,
                                 "max_new": int(max_new)},
                                timestamp=now, partition=rep.rid)
        except PartitionFull:
            self.balancer.cancel(rep)
            self.rejected_429 += 1
            raise Rejected(f"replica {rep.rid} partition full") from None
        routed = "affinity" if prefer is not None and rep.rid == prefer \
            else "policy"
        if self.affinity:
            if routed == "affinity":
                self.affinity_hits += 1
            else:
                self.affinity_misses += 1
            for h in hashes:
                self._prefix_owner[h] = rep.rid
        cr = ClusterRequest(cid, prompt, int(max_new), rep.rid, routed,
                            submitted=now)
        self._tickets[cid] = cr
        self.route_log.append((cid, rep.rid, routed))
        self.submitted += 1
        return cid

    # ------------------------------------------------------------ drive
    def _room(self, engine) -> int:
        """Admission headroom: keep at most ``max_batch`` runnable
        requests inside the engine; the rest of the backlog stays in
        the broker (committed only once pumped)."""
        inside = len(engine.queue) + len(engine.active) + \
            len(engine.prefilling)
        return max(0, engine.max_batch - inside)

    def step(self, now: float = 0.0) -> List[ClusterRequest]:
        """One cluster step, deterministic: pump every partition into
        its replica (bounded by the replica's headroom, committing the
        consumed offsets), then step every non-idle engine once, in
        fixed replica order.  Returns finished cluster requests."""
        for p, engine in enumerate(self.engines):
            room = self._room(engine)
            if room <= 0:
                continue
            records = self.broker.poll(self.GROUP, p, room)
            for rec in records:
                erid = engine.submit(rec.value["prompt"],
                                     rec.value["max_new"],
                                     now=rec.timestamp)
                self._pending[(p, erid)] = self._tickets[rec.value["cid"]]
            if records:
                self.broker.commit(self.GROUP, p, records[-1].offset + 1)
        done: List[ClusterRequest] = []
        for p, engine in enumerate(self.engines):
            if engine.idle:
                continue
            for r in engine.step(now=now):
                cr = self._pending.pop((p, r.rid))
                cr.out_tokens = list(r.out_tokens)
                cr.first_token_at = r.first_token_at
                cr.finished_at = now
                self.balancer.release(self.balancer.replicas[p])
                self.finished_count += 1
                done.append(cr)
        return done

    @property
    def idle(self) -> bool:
        return not self._pending and \
            self.broker.total_depth(self.GROUP) == 0 and \
            all(e.idle for e in self.engines)

    def drain(self, now: float = 0.0,
              max_steps: int = 10_000) -> List[ClusterRequest]:
        """Step until idle (test/CLI convenience; a live clock drives
        ``step()`` itself)."""
        done: List[ClusterRequest] = []
        for _ in range(max_steps):
            if self.idle:
                break
            done.extend(self.step(now))
        assert self.idle, "cluster failed to drain"
        return done

    # ------------------------------------------------------------ gauges
    def stats(self) -> Dict[str, float]:
        """Cluster-kind gauges per ``serving/stats_schema.py``.
        Per-replica engine gauges ride ``balancer.stats()["engines"]``."""
        return {
            "engine": "cluster",
            "replicas": len(self.engines),
            "affinity": int(self.affinity),
            "affinity_hits": self.affinity_hits,
            "affinity_misses": self.affinity_misses,
            "rejected_429": self.rejected_429,
            "submitted": self.submitted,
            "finished": self.finished_count,
        }
