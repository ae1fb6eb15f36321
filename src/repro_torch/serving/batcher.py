"""Micro-batching consumer policy, the port of ``repro.serving.batcher``.

The paper's consumer classifies one Kafka message at a time; batching
requests into one accelerator call is the standard production fix.  The
policy is the usual two-knob one: flush when ``max_batch`` requests are
waiting or when the oldest has waited ``max_wait`` seconds.  Plain
Python, no tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional


@dataclasses.dataclass
class _Pending:
    item: Any
    arrived: float


class MicroBatcher:
    def __init__(self, max_batch: int = 32, max_wait: float = 0.01):
        self.max_batch = max_batch
        self.max_wait = max_wait
        self._pending: List[_Pending] = []
        self.flushes = 0
        self.batched_items = 0

    def add(self, item: Any, now: float) -> None:
        self._pending.append(_Pending(item, now))

    def ready(self, now: float) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.max_batch:
            return True
        return now - self._pending[0].arrived >= self.max_wait

    def next_deadline(self, now: float) -> Optional[float]:
        """Seconds until the oldest item's wait runs out (0 once it has),
        or None with nothing pending."""
        if not self._pending:
            return None
        return max(self._pending[0].arrived + self.max_wait - now, 0.0)

    def flush(self) -> List[Any]:
        """Up to ``max_batch`` items, oldest first."""
        take = self._pending[: self.max_batch]
        self._pending = self._pending[self.max_batch:]
        self.flushes += 1
        self.batched_items += len(take)
        return [p.item for p in take]

    def __len__(self) -> int:
        return len(self._pending)
