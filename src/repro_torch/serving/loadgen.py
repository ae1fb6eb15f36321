"""Closed-loop load generator — the locust analogue (paper §III.B/C,
Appendix B).

Reproduces locust's model: ``users`` concurrent simulated users spawned at
``spawn_rate`` users/second; each user loops {issue request -> wait for
completion -> think}.  Statistics match what locust's web UI reports
(total requests, failure %, mean/median/p95 response time, RPS timeline),
so the benchmark tables line up with the paper's Figures 6-20.

The port of ``repro.serving.loadgen``'s ``LoadReport`` and
``LoadGenerator``; the LLM prompt workloads of that module are not
ported yet.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List

from repro_torch.obs.metrics import Histogram
from repro_torch.serving.server import Outcome
from repro_torch.serving.sim import Clock


@dataclasses.dataclass
class LoadReport:
    kind: str
    users: int
    spawn_rate: float
    duration: float
    total: int
    failures: int
    mean_ms: float
    median_ms: float
    p95_ms: float
    rps: float
    per_status: Dict[int, int]

    @property
    def failure_pct(self) -> float:
        return 100.0 * self.failures / max(self.total, 1)

    def row(self) -> str:
        return (f"{self.kind:4s} users={self.users:3d} total={self.total:5d} "
                f"fail={self.failure_pct:5.1f}% mean={self.mean_ms:8.0f}ms "
                f"median={self.median_ms:8.0f}ms p95={self.p95_ms:8.0f}ms "
                f"rps={self.rps:5.2f}")


class LoadGenerator:
    def __init__(self, clock: Clock, issue: Callable[[Callable[[Outcome], None]], None],
                 *, users: int, spawn_rate: float, duration: float,
                 think_min: float = 0.5, think_max: float = 1.5,
                 seed: int = 0, kind: str = "GET", metrics=None):
        self.clock = clock
        self.issue = issue
        self.users = users
        self.spawn_rate = spawn_rate
        self.duration = duration
        self.think = (think_min, think_max)
        self.kind = kind
        self._rng = random.Random(seed)
        self.outcomes: List[Outcome] = []
        # optional obs feed: per-kind latency histogram + failure counter
        # (the table itself keeps exact percentiles over the outcome list
        # — locust parity — while scrapes see the mergeable histogram)
        self._m_latency = self._m_failures = None
        if metrics is not None:
            lab = {"kind": kind}
            self._m_latency = metrics.histogram(
                "http_request_seconds", "client-observed request latency",
                lab)
            self._m_failures = metrics.counter(
                "http_failures_total", "non-2xx client outcomes", lab)

    def run(self) -> LoadReport:
        for u in range(self.users):
            delay = u / self.spawn_rate
            self.clock.schedule(delay, self._user_loop)
        self.clock.run(until=self.duration)
        return self._report()

    def _user_loop(self) -> None:
        if self.clock.now >= self.duration:
            return

        def done(outcome: Outcome):
            self.outcomes.append(outcome)
            if self._m_latency:
                self._m_latency.observe(outcome.latency)
                if not outcome.ok:
                    self._m_failures.inc()
            think = self._rng.uniform(*self.think)
            self.clock.schedule(think, self._user_loop)

        self.issue(done)

    def _report(self) -> LoadReport:
        # percentiles come from the same fixed-bucket histogram the
        # metrics endpoint would scrape (the mean stays exact — sum and
        # count are tracked exactly), so the locust-style table and the
        # obs layer can never disagree about the run.
        hist = self._m_latency or Histogram()
        if not self._m_latency:
            for o in self.outcomes:
                hist.observe(o.latency)
        fails = sum(1 for o in self.outcomes if not o.ok)
        per_status: Dict[int, int] = {}
        for o in self.outcomes:
            per_status[o.status] = per_status.get(o.status, 0) + 1
        return LoadReport(
            kind=self.kind, users=self.users, spawn_rate=self.spawn_rate,
            duration=self.duration, total=len(self.outcomes),
            failures=fails,
            mean_ms=hist.mean * 1e3,
            median_ms=hist.quantile(0.5) * 1e3,
            p95_ms=hist.quantile(0.95) * 1e3,
            rps=len(self.outcomes) / self.duration,
            per_status=per_status)
