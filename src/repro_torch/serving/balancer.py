"""Replica load balancing — the NGINX analogue.

The port's copy of ``repro.serving.balancer`` (framework-free; the port
imports nothing of ``repro``).

The paper fronts its site with 3 NGINX replicas behind a K8s service.
Reproduced as policy objects over a replica pool with live in-flight
accounting; ``power_of_two`` is the beyond-paper addition (NGINX itself
only gained p2c in Plus) and is what the §Perf serving iteration measures.

Replicas have a concurrency limit and a bounded wait queue; dispatching to
a saturated pool raises ``Overloaded`` (the 429 path in the paper's
locust runs).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Optional


class Overloaded(Exception):
    pass


@dataclasses.dataclass
class Replica:
    rid: int
    concurrency: int          # simultaneous requests it can serve
    queue_limit: int          # waiting slots beyond that
    in_flight: int = 0
    served: int = 0

    @property
    def load(self) -> int:
        return self.in_flight

    @property
    def full(self) -> bool:
        return self.in_flight >= self.concurrency + self.queue_limit


class LoadBalancer:
    """policy in {"round_robin", "random", "least_loaded", "power_of_two"}."""

    def __init__(self, num_replicas: int = 3, concurrency: int = 4,
                 queue_limit: int = 16, policy: str = "round_robin",
                 seed: int = 0, metrics=None):
        self.replicas = [Replica(i, concurrency, queue_limit)
                         for i in range(num_replicas)]
        self.policy = policy
        self._rr = 0
        self._rng = random.Random(seed)
        self.dispatched = 0
        self.rejected = 0
        self.released = 0
        self.cancelled = 0
        self.affinity_picks = 0
        self._replica_stats: dict = {}    # rid -> stats() gauge source
        self._m_picks = self._m_rejections = self._m_releases = None
        self._m_load = []
        if metrics is not None:
            lab = {"policy": policy}
            self._m_picks = metrics.counter(
                "balancer_picks_total", "successful replica picks", lab)
            self._m_rejections = metrics.counter(
                "balancer_rejections_total",
                "picks rejected with all replicas saturated", lab)
            self._m_releases = metrics.counter(
                "balancer_releases_total", "requests released", lab)
            self._m_load = [
                metrics.gauge("balancer_replica_in_flight",
                              "requests in flight on one replica",
                              {"replica": str(i)})
                for i in range(num_replicas)]

    def _score(self, r: Replica) -> tuple:
        """Dispatch comparison key for one replica.  With no gauge
        source attached this is plain in-flight load (the classic p2c/
        least-loaded signal).  With ``attach_engine_stats(fn, rid=...)``
        it becomes occupancy-aware: backend queue depth adds to the
        load (a replica with a deep admission backlog is busier than
        its in-flight count shows) and free KV blocks break ties (more
        headroom admits a new request sooner)."""
        fn = self._replica_stats.get(r.rid)
        if fn is None:
            return (r.load, 0)
        s = fn()
        return (r.load + s.get("queue_depth", 0),
                -s.get("free_blocks", 0))

    def pick(self, prefer: Optional[int] = None) -> Replica:
        """Pick a replica; ``prefer`` is the affinity hook — when that
        replica is not saturated it wins outright (the caller knows it
        holds cached state worth more than a marginally lower load),
        otherwise the configured policy decides among the non-full
        replicas.  Raises ``Overloaded`` when every replica is full."""
        cand = [r for r in self.replicas if not r.full]
        if not cand:
            self.rejected += 1
            if self._m_rejections:
                self._m_rejections.inc()
            raise Overloaded("all replicas saturated")
        if prefer is not None and not self.replicas[prefer].full:
            r = self.replicas[prefer]
            self.affinity_picks += 1
        elif self.policy == "round_robin":
            for _ in range(len(self.replicas)):
                r = self.replicas[self._rr % len(self.replicas)]
                self._rr += 1
                if not r.full:
                    break
        elif self.policy == "random":
            r = self._rng.choice(cand)
        elif self.policy == "least_loaded":
            r = min(cand, key=self._score)
        elif self.policy == "power_of_two":
            a, b = self._rng.choice(cand), self._rng.choice(cand)
            r = a if self._score(a) <= self._score(b) else b
        else:
            raise ValueError(self.policy)
        r.in_flight += 1
        self.dispatched += 1
        if self._m_picks:
            self._m_picks.inc()
            self._m_load[r.rid].set(r.in_flight)
        return r

    def release(self, r: Replica) -> None:
        r.in_flight -= 1
        r.served += 1
        self.released += 1
        if self._m_releases:
            self._m_releases.inc()
            self._m_load[r.rid].set(r.in_flight)

    def cancel(self, r: Replica) -> None:
        """Undo a pick whose dispatch then failed downstream (e.g. the
        broker partition was full): the request never ran, so drop the
        in-flight hold WITHOUT counting it served/released — served
        counts feed the imbalance gauge and must only see real work."""
        r.in_flight -= 1
        self.cancelled += 1
        if self._m_load:
            self._m_load[r.rid].set(r.in_flight)

    def attach_engine_stats(self, fn, rid: Optional[int] = None) -> None:
        """Register a gauge source (e.g. ``PagedLLMEngine.stats``) so
        balancer snapshots carry backend queue/pool occupancy — the
        signal an occupancy-aware dispatch policy needs.  With ``rid``
        the source is per-replica: ``pick()``'s least-loaded and
        power-of-two scoring then consume that replica's queue-depth
        and free-block gauges (the cluster tier attaches one engine per
        replica); without it the single source only annotates
        ``stats()`` snapshots, exactly as before."""
        if rid is None:
            self._engine_stats = fn
        else:
            self._replica_stats[int(rid)] = fn

    def stats(self) -> dict:
        """Dispatch counters + per-replica load, plus the attached
        engine's queue/pool occupancy gauges when present.
        ``picks``/``rejections``/``releases`` are the lifetime counter
        names; ``dispatched``/``rejected`` stay as aliases for older
        snapshot consumers."""
        out = {
            "picks": self.dispatched,
            "rejections": self.rejected,
            "releases": self.released,
            "dispatched": self.dispatched,
            "rejected": self.rejected,
            "imbalance": round(self.imbalance(), 4),
            "replica_loads": [r.load for r in self.replicas],
        }
        if self.cancelled:
            out["cancelled"] = self.cancelled
        fn = getattr(self, "_engine_stats", None)
        if fn is not None:
            out["engine"] = dict(fn())
        if self._replica_stats:
            out["engines"] = {rid: dict(f())
                              for rid, f in sorted(self._replica_stats
                                                   .items())}
        return out

    def max_load(self) -> int:
        return max(r.load for r in self.replicas)

    def imbalance(self) -> float:
        loads = [r.served for r in self.replicas]
        mean = sum(loads) / len(loads)
        return (max(loads) - min(loads)) / max(mean, 1.0)
