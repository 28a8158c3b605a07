"""Fabric observatory (port of ``repro.obs``): span tracer, labeled metrics
registry, Eq.-1 drift ledger, and per-page heat map.

``metrics`` is imported eagerly — it has no ``repro_torch`` dependencies and
``placement/telemetry.py`` builds on it. Everything else loads lazily
(PEP 562): the tracer/ledger/heat modules import placement internals, and
resolving them at package-import time would cycle back into a partially
initialized ``repro_torch.placement.telemetry``.
"""

from repro_torch.obs.metrics import DEFAULT_BUCKETS, MetricsRegistry

_LAZY = {
    "SpanTracer": "repro_torch.obs.trace",
    "DriftLedger": "repro_torch.obs.drift",
    "PageHeat": "repro_torch.obs.heat",
    "Observatory": "repro_torch.obs.observatory",
}

__all__ = ["MetricsRegistry", "DEFAULT_BUCKETS", "SpanTracer",
           "DriftLedger", "PageHeat", "Observatory"]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
