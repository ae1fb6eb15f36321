"""Dependency-free observability: metrics + tracing (the port's copy of
``repro.obs``, which it does not import).

``Observability`` is the bundle the serving stack threads around — a
``MetricsRegistry`` (always) plus an optional ``TraceRecorder``.  The
engines wrap it in ``EngineObs`` (``obs/engine.py``) so the step loop
pays one attribute check when instrumentation is off.

    from repro_torch.obs import Observability
    obs = Observability.create(trace=True)          # wall-clock trace
    engine = PagedLLMEngine(model, params, obs=obs)
    ...
    print(obs.metrics.render())                     # Prometheus text
    obs.trace.export("trace.json")                  # open in Perfetto
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.engine import EngineObs
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     log_bucket_bounds, summarize_latencies)
from repro_torch.obs.trace import (TraceRecorder, span_report,
                                   validate_chrome_trace)

__all__ = [
    "Observability", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "TraceRecorder", "EngineObs", "DEFAULT_BUCKETS", "log_bucket_bounds",
    "summarize_latencies", "span_report", "validate_chrome_trace",
]


@dataclasses.dataclass
class Observability:
    """Metrics registry + optional trace recorder, passed as one unit."""

    metrics: MetricsRegistry
    trace: Optional[TraceRecorder] = None

    @classmethod
    def create(cls, trace: bool = False,
               trace_mode: str = "wall") -> "Observability":
        """``trace_mode="sim"`` zeroes measured wall durations so
        exports under the discrete-event clock are deterministic."""
        return cls(MetricsRegistry(),
                   TraceRecorder(mode=trace_mode) if trace else None)
