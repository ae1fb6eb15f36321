"""Partitioned message log — the Kafka/ZooKeeper analogue.

The port's copy of ``repro.serving.broker`` (framework-free; the port
imports nothing of ``repro``).

The paper runs 3 Kafka brokers + 1 ZooKeeper and has Flask publish each
canvas drawing to "a randomly assigned broker"; a consumer job reads and
classifies.  The transferable semantics reproduced here:

  * N partitions, each an append-only offset-indexed log,
  * producer-side partition assignment (random, like the paper, or keyed),
  * consumer groups with per-partition committed offsets,
  * at-least-once delivery: un-committed polls are re-delivered,
  * bounded partitions: produce to a full partition fails (backpressure —
    this is what turns overload into fast 429s in the load tests, the
    behaviour the paper measured at 50 users).
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import Any, Dict, List, Optional, Tuple


class PartitionFull(Exception):
    pass


@dataclasses.dataclass
class Record:
    offset: int
    key: Optional[str]
    value: Any
    timestamp: float


class Broker:
    def __init__(self, num_partitions: int = 3, max_depth: int = 1024,
                 seed: int = 0, metrics=None):
        self.num_partitions = num_partitions
        self.max_depth = max_depth
        self._logs: List[List[Record]] = [[] for _ in range(num_partitions)]
        self._start: List[int] = [0] * num_partitions   # truncation base
        self._committed: Dict[Tuple[str, int], int] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.produced = 0
        self.rejected = 0
        self._m_produced = self._m_rejected = self._m_polls = None
        self._m_depth = []
        if metrics is not None:
            self._m_produced = metrics.counter(
                "broker_produced_total", "records appended")
            self._m_rejected = metrics.counter(
                "broker_rejected_total", "produces refused (backpressure)")
            self._m_polls = metrics.counter(
                "broker_polls_total", "consumer poll calls")
            self._m_depth = [
                metrics.gauge("broker_partition_depth",
                              "retained records in one partition",
                              {"partition": str(p)})
                for p in range(num_partitions)]

    # ------------------------------------------------------------ produce
    def partition_for(self, key: Optional[str]) -> int:
        if key is None:
            return self._rng.randrange(self.num_partitions)
        return hash(key) % self.num_partitions

    def produce(self, value: Any, key: Optional[str] = None,
                timestamp: float = 0.0,
                partition: Optional[int] = None) -> Tuple[int, int]:
        """-> (partition, offset); raises PartitionFull on backpressure.
        ``partition`` overrides key/random assignment — the cluster
        tier routes by replica affinity, where the *balancer* picks the
        partition and the broker must not re-shuffle it."""
        with self._lock:
            p = self.partition_for(key) if partition is None \
                else int(partition)
            if not 0 <= p < self.num_partitions:
                raise ValueError(f"partition {p} out of range "
                                 f"[0, {self.num_partitions})")
            if len(self._logs[p]) >= self.max_depth:
                # capacity pressure: truncate what every known group has
                # consumed (Kafka-style retention — never on commit, so a
                # late-joining group still sees retained records).
                self._gc(p)
            log = self._logs[p]
            if len(log) >= self.max_depth:
                self.rejected += 1
                if self._m_rejected:
                    self._m_rejected.inc()
                raise PartitionFull(f"partition {p} at depth {len(log)}")
            offset = self._start[p] + len(log)
            log.append(Record(offset, key, value, timestamp))
            self.produced += 1
            if self._m_produced:
                self._m_produced.inc()
                self._m_depth[p].set(len(log))
            return p, offset

    def _groups(self):
        return {g for (g, _p) in self._committed}

    # ------------------------------------------------------------ consume
    def poll(self, group: str, partition: int, max_records: int = 64
             ) -> List[Record]:
        """Read from the group's committed offset (at-least-once: the same
        records come back until committed)."""
        with self._lock:
            if self._m_polls:
                self._m_polls.inc()
            base = self._committed.get((group, partition),
                                       self._start[partition])
            log = self._logs[partition]
            lo = base - self._start[partition]
            return list(log[lo : lo + max_records])

    def commit(self, group: str, partition: int, offset: int) -> None:
        """Commit offsets < ``offset`` as consumed, then GC fully-consumed
        prefixes."""
        with self._lock:
            cur = self._committed.get((group, partition),
                                      self._start[partition])
            self._committed[(group, partition)] = max(cur, offset)

    def _gc(self, p: int) -> None:
        groups = self._groups()
        if not groups:
            return
        low = min(self._committed.get((g, p), self._start[p]) for g in groups)
        drop = low - self._start[p]
        if drop > 0:
            self._logs[p] = self._logs[p][drop:]
            self._start[p] = low

    # ------------------------------------------------------------ stats
    def depth(self, partition: int, group: Optional[str] = None) -> int:
        with self._lock:
            if group is None:
                return len(self._logs[partition])
            base = self._committed.get((group, partition),
                                       self._start[partition])
            return self._start[partition] + len(self._logs[partition]) - base

    def total_depth(self, group: Optional[str] = None) -> int:
        return sum(self.depth(p, group) for p in range(self.num_partitions))
