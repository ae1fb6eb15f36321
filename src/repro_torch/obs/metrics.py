"""Dependency-free metrics: counters, gauges, fixed-bucket histograms.

The port's copy of ``repro.obs.metrics`` (the port imports nothing of
``repro``): the bucket bounds are the same, so histograms and snapshots
from either package merge exactly.

Design constraints, in order:

  * **Exact merging.**  Every ``Histogram`` uses the same fixed
    log-spaced bucket bounds (``DEFAULT_BUCKETS``: 8 buckets per decade
    from 100 µs to 100 s) unless a caller overrides them, so merging
    snapshots across engine replicas or benchmark runs is an exact
    element-wise add — never a re-binning approximation.
  * **One source of truth for percentiles.**  ``Histogram.quantile``
    interpolates inside the containing bucket; benchmark tables and
    runtime metrics read the *same* histogram, so they can't disagree
    (``summarize_latencies`` is the shared reporting helper).
  * **Low overhead.**  ``observe``/``inc``/``set`` are a bisect and two
    adds — safe inside the engine step loop.

``MetricsRegistry`` is the container: get-or-create instruments by
``(name, labels)``, Prometheus text exposition via ``render()``, and a
JSON-able ``snapshot()`` / ``merge()`` pair for cross-process
aggregation.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple


def log_bucket_bounds(lo_exp: int = -4, hi_exp: int = 2,
                      per_decade: int = 8) -> Tuple[float, ...]:
    """Log-spaced histogram bounds, ``10**lo_exp`` .. ``10**hi_exp``
    seconds with ``per_decade`` buckets per decade.  Deterministic, so
    two processes computing the same spec can merge exactly."""
    return tuple(10.0 ** (e / per_decade)
                 for e in range(lo_exp * per_decade,
                                hi_exp * per_decade + 1))


#: THE shared latency bounds: 100 µs .. 100 s, ~1.33x per bucket.
DEFAULT_BUCKETS = log_bucket_bounds()


class Counter:
    """Monotone counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Point-in-time value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def dec(self, n: float = 1.0) -> None:
        self.value -= n


class Histogram:
    """Fixed-bound histogram with Prometheus ``le`` (cumulative <=)
    semantics: ``counts[i]`` holds observations ``<= bounds[i]`` and
    ``> bounds[i-1]``; ``counts[-1]`` is the +Inf overflow bucket."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BUCKETS):
        bounds = tuple(float(b) for b in bounds)
        if not bounds or any(a >= b for a, b in zip(bounds, bounds[1:])):
            raise ValueError(f"bounds must be ascending, got {bounds!r}")
        self.bounds = bounds
        self.counts: List[int] = [0] * (len(bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """q-quantile estimate: find the containing bucket, then
        interpolate linearly inside it (bucket resolution is the error
        bound — ~1.33x with the default log bounds, much tighter after
        interpolation).  The overflow bucket clamps to the top bound."""
        if not self.count:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= target:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[min(i, len(self.bounds) - 1)]
                frac = min(max((target - cum) / c, 0.0), 1.0)
                return lo + frac * (hi - lo)
            cum += c
        return self.bounds[-1]

    def merge(self, other: "Histogram") -> None:
        if tuple(other.bounds) != self.bounds:
            raise ValueError("cannot merge histograms with different "
                             "bucket bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count


def _label_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


def _label_str(label_key: Tuple) -> str:
    if not label_key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in label_key) + "}"


def _num(v: float) -> str:
    """Prometheus-friendly number rendering (ints stay integral)."""
    return str(int(v)) if float(v).is_integer() else f"{v:.9g}"


class MetricsRegistry:
    """Named instruments, get-or-create by ``(name, labels)``.

    One metric name has one type and one help string; re-requesting an
    existing instrument returns the same object (so modules can share
    instruments without threading references around)."""

    def __init__(self):
        # name -> (type_str, help); (name, label_key) -> instrument
        self._meta: Dict[str, Tuple[str, str]] = {}
        self._metrics: Dict[Tuple[str, Tuple], object] = {}

    # ------------------------------------------------------------ create
    def _get(self, kind: str, name: str, help: str,
             labels: Optional[Dict[str, str]], factory):
        meta = self._meta.get(name)
        if meta is not None and meta[0] != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{meta[0]}, not {kind}")
        if meta is None:
            self._meta[name] = (kind, help)
        key = (name, _label_key(labels))
        inst = self._metrics.get(key)
        if inst is None:
            inst = self._metrics[key] = factory()
        return inst

    def counter(self, name: str, help: str = "",
                labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get("counter", name, help, labels, Counter)

    def gauge(self, name: str, help: str = "",
              labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get("gauge", name, help, labels, Gauge)

    def histogram(self, name: str, help: str = "",
                  labels: Optional[Dict[str, str]] = None,
                  bounds: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get("histogram", name, help, labels,
                         lambda: Histogram(bounds))

    def get(self, name: str, labels: Optional[Dict[str, str]] = None):
        """Existing instrument or None (no create)."""
        return self._metrics.get((name, _label_key(labels)))

    # ------------------------------------------------------------ export
    def render(self) -> str:
        """Prometheus text exposition format (the ``--metrics`` dump;
        an HTTP scrape endpoint would serve exactly this string)."""
        by_name: Dict[str, List[Tuple[Tuple, object]]] = {}
        for (name, lk), inst in self._metrics.items():
            by_name.setdefault(name, []).append((lk, inst))
        lines = []
        for name in sorted(by_name):
            kind, help = self._meta[name]
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")
            for lk, inst in sorted(by_name[name]):
                if kind in ("counter", "gauge"):
                    lines.append(f"{name}{_label_str(lk)} "
                                 f"{_num(inst.value)}")
                    continue
                cum = 0
                for bound, c in zip(inst.bounds, inst.counts):
                    cum += c
                    blk = _label_str(lk + (("le", _num(bound)),))
                    lines.append(f"{name}_bucket{blk} {cum}")
                blk = _label_str(lk + (("le", "+Inf"),))
                lines.append(f"{name}_bucket{blk} {inst.count}")
                lines.append(f"{name}_sum{_label_str(lk)} {_num(inst.sum)}")
                lines.append(f"{name}_count{_label_str(lk)} {inst.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able state dump; feed to ``merge`` on another registry
        (or persist beside a benchmark report)."""
        out: dict = {"counters": [], "gauges": [], "histograms": []}
        for (name, lk), inst in sorted(self._metrics.items()):
            entry = {"name": name, "labels": dict(lk),
                     "help": self._meta[name][1]}
            kind = self._meta[name][0]
            if kind == "histogram":
                entry.update(bounds=list(inst.bounds),
                             counts=list(inst.counts),
                             sum=inst.sum, count=inst.count)
            else:
                entry["value"] = inst.value
            out[kind + "s"].append(entry)
        return out

    def merge(self, snap: dict) -> None:
        """Fold a snapshot in: counters and histograms add exactly
        (identical fixed bounds make the histogram add lossless);
        gauges are point-in-time, so the incoming value wins."""
        for e in snap.get("counters", []):
            self.counter(e["name"], e.get("help", ""),
                         e["labels"] or None).inc(e["value"])
        for e in snap.get("gauges", []):
            self.gauge(e["name"], e.get("help", ""),
                       e["labels"] or None).set(e["value"])
        for e in snap.get("histograms", []):
            h = self.histogram(e["name"], e.get("help", ""),
                               e["labels"] or None,
                               bounds=tuple(e["bounds"]))
            other = Histogram(tuple(e["bounds"]))
            other.counts = list(e["counts"])
            other.sum, other.count = e["sum"], e["count"]
            h.merge(other)


def summarize_latencies(metrics: MetricsRegistry) -> dict:
    """THE serving-latency summary — every benchmark table reads the
    engines' shared ``request_*`` histograms through this one helper,
    so benchmark percentiles and runtime metrics can never disagree
    (they are literally the same buckets)."""
    ttft = metrics.histogram("request_ttft_seconds")
    e2e = metrics.histogram("request_e2e_seconds")
    gap = metrics.histogram("request_intertoken_seconds")
    return {
        "requests": ttft.count,
        "mean_ttft_s": round(ttft.mean, 6),
        "p95_ttft_s": round(ttft.quantile(0.95), 6),
        "mean_e2e_s": round(e2e.mean, 6),
        "p95_e2e_s": round(e2e.quantile(0.95), 6),
        "intertoken_p50_s": round(gap.quantile(0.5), 6),
        "intertoken_p95_s": round(gap.quantile(0.95), 6),
        "decode_gap_p95_over_median": round(
            gap.quantile(0.95) / max(gap.quantile(0.5), 1e-9), 3)
        if gap.count else 0.0,
    }
