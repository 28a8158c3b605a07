"""Observability: the labeled metrics registry ``placement/telemetry.py``
builds on."""

from repro_torch.obs.metrics import DEFAULT_BUCKETS, MetricsRegistry

__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS"]
