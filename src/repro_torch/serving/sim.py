"""Minimal discrete-event engine for the serving benchmarks.

The port's copy of ``repro.serving.sim`` (framework-free; the port
imports nothing of ``repro``).

Thread-based load tests would measure scheduler noise, not system
behaviour.  Instead the serving stack runs under virtual time:
components are real (the broker holds real arrays, the model really
executes inside the consumer), but waiting happens on an event heap.
Model execution cost is *measured* (wall time of the model call, which
returns host arrays, so the device has finished) and charged to the
virtual clock, so capacity effects are faithful while runs stay
deterministic.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Tuple


class QueuedResource:
    """Concurrency-limited resource with a bounded FIFO wait queue (an
    NGINX worker pool / Flask WSGI server under virtual time)."""

    def __init__(self, clock: "Clock", concurrency: int, queue_limit: int,
                 metrics=None, name: str = "resource"):
        self.clock = clock
        self.concurrency = concurrency
        self.queue_limit = queue_limit
        self.busy = 0
        self._waiting: List[Tuple[float, Callable, float]] = []
        self.served = 0
        self.rejected = 0
        self._m_served = self._m_rejected = self._m_wait = None
        if metrics is not None:
            lab = {"resource": name}
            self._m_served = metrics.counter(
                "resource_served_total", "jobs completed", lab)
            self._m_rejected = metrics.counter(
                "resource_rejected_total",
                "jobs refused with pool + queue full", lab)
            self._m_wait = metrics.histogram(
                "resource_wait_seconds",
                "sim-time spent in the wait queue", lab)

    @property
    def load(self) -> int:
        return self.busy + len(self._waiting)

    def submit(self, duration: float, done: Callable[[], None]) -> bool:
        """Returns False (reject) when pool + queue are full."""
        if self.busy < self.concurrency:
            if self._m_wait:
                self._m_wait.observe(0.0)
            self._start(duration, done)
            return True
        if len(self._waiting) < self.queue_limit:
            self._waiting.append((duration, done, self.clock.now))
            return True
        self.rejected += 1
        if self._m_rejected:
            self._m_rejected.inc()
        return False

    def _start(self, duration: float, done: Callable) -> None:
        self.busy += 1

        def finish():
            self.busy -= 1
            self.served += 1
            if self._m_served:
                self._m_served.inc()
            done()
            if self._waiting and self.busy < self.concurrency:
                d, cb, enq = self._waiting.pop(0)
                if self._m_wait:
                    self._m_wait.observe(self.clock.now - enq)
                self._start(d, cb)

        self.clock.schedule(duration, finish)


class Clock:
    def __init__(self):
        self._now = 0.0
        self._heap: List[Tuple[float, int, Callable]] = []
        self._seq = itertools.count()

    @property
    def now(self) -> float:
        return self._now

    def schedule(self, delay: float, fn: Callable) -> None:
        heapq.heappush(self._heap, (self._now + max(delay, 0.0),
                                    next(self._seq), fn))

    def run(self, until: Optional[float] = None, max_events: int = 10_000_000
            ) -> None:
        n = 0
        while self._heap and n < max_events:
            t, _, fn = self._heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(self._heap)
            self._now = t
            fn()
            n += 1
        if until is not None and (not self._heap or self._now < until):
            self._now = until
