"""Observability: the metrics registry (a copy of ``repro.obs.metrics``)."""
