"""Labeled metrics registry: counters, gauges, histograms (DESIGN.md §10).

The fabric observatory's storage layer. A :class:`MetricsRegistry` owns a
set of metric *families*; each family fans out into children keyed by a
label-value tuple (tenant, domain, priority class, tier, ...). Two export
surfaces:

- :meth:`MetricsRegistry.prometheus_text` — the Prometheus text exposition
  format (``# HELP`` / ``# TYPE`` + one sample line per child; histograms
  emit cumulative ``_bucket`` series plus ``_sum`` / ``_count``).
- :meth:`MetricsRegistry.snapshot` — a JSON-ready dict mirror of the same
  state for benchmarks and tests.

This module is deliberately dependency-free within ``repro`` (numpy only):
``placement/telemetry.py`` imports it to back its counters, so it must sit
below every other layer.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

# log-spread seconds buckets: 10 µs .. 10 s covers virtual-clock latencies
DEFAULT_BUCKETS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2,
                   1e-1, 3e-1, 1.0, 3.0, 10.0)


def _escape(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels_text(names: Sequence[str], values: Sequence,
                 extra: tuple = ()) -> str:
    pairs = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def _fmt(value: float) -> str:
    if isinstance(value, bool):
        return str(int(value))
    f = float(value)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Child:
    """One (family, label-values) time series."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, value: float) -> None:
        self.value = float(value)


class _HistogramChild:
    """Cumulative-bucket histogram series (Prometheus semantics)."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: np.ndarray):
        self.bounds = bounds                       # finite upper edges
        self.counts = np.zeros(len(bounds) + 1, dtype=np.int64)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[int(np.searchsorted(self.bounds, v, side="left"))] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        """Linear interpolation inside the bucket holding the q-th sample
        (the classic Prometheus ``histogram_quantile`` estimate). The +Inf
        bucket clamps to the largest finite edge."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            nxt = cum + int(c)
            if nxt >= rank and c > 0:
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])
                if i >= len(self.bounds):
                    return float(hi)
                frac = (rank - cum) / c
                return float(lo + (hi - lo) * frac)
            cum = nxt
            lo = self.bounds[i] if i < len(self.bounds) else lo
        return float(self.bounds[-1])


class _Family:
    """One named metric with a fixed label schema."""

    def __init__(self, name: str, help_text: str, kind: str,
                 labelnames: Sequence[str], buckets=None):
        self.name = name
        self.help = help_text
        self.kind = kind                           # counter|gauge|histogram
        self.labelnames = tuple(labelnames)
        self.buckets = (np.asarray(buckets, dtype=np.float64)
                        if kind == "histogram" else None)
        self._children: dict[tuple, object] = {}

    def labels(self, *values):
        assert len(values) == len(self.labelnames), \
            (self.name, self.labelnames, values)
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            child = (_HistogramChild(self.buckets)
                     if self.kind == "histogram" else _Child())
            self._children[key] = child
        return child

    # unlabeled convenience: families with no labels act like one child
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def value(self, *values) -> float:
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        return float(child.value) if child is not None else 0.0

    def total(self) -> float:
        return float(sum(c.value for c in self._children.values()))

    # -- export ---------------------------------------------------------------

    def prometheus_lines(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, child in self._children.items():
            if self.kind == "histogram":
                cum = 0
                for i, edge in enumerate(child.bounds):
                    cum += int(child.counts[i])
                    lt = _labels_text(self.labelnames, key,
                                      (("le", _fmt(edge)),))
                    lines.append(f"{self.name}_bucket{lt} {cum}")
                lt = _labels_text(self.labelnames, key, (("le", "+Inf"),))
                lines.append(f"{self.name}_bucket{lt} {child.count}")
                lt = _labels_text(self.labelnames, key)
                lines.append(f"{self.name}_sum{lt} {_fmt(child.sum)}")
                lines.append(f"{self.name}_count{lt} {child.count}")
            else:
                lt = _labels_text(self.labelnames, key)
                lines.append(f"{self.name}{lt} {_fmt(child.value)}")
        return lines

    def snapshot(self) -> dict:
        series = []
        for key, child in self._children.items():
            row: dict = {"labels": dict(zip(self.labelnames, key))}
            if self.kind == "histogram":
                row.update(sum=child.sum, count=child.count,
                           p50=child.quantile(0.5),
                           p95=child.quantile(0.95))
            else:
                row["value"] = child.value
            series.append(row)
        return {"type": self.kind, "help": self.help,
                "label_names": list(self.labelnames), "series": series}


class MetricsRegistry:
    """Registry of metric families; registration is idempotent by name
    (re-registering returns the existing family, schema must match)."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _register(self, name: str, help_text: str, kind: str,
                  labelnames, buckets=None) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            assert fam.kind == kind and fam.labelnames == tuple(labelnames), \
                f"metric {name!r} re-registered with a different schema"
            return fam
        fam = _Family(name, help_text, kind, labelnames, buckets)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help_text: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._register(name, help_text, "counter", labelnames)

    def gauge(self, name: str, help_text: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._register(name, help_text, "gauge", labelnames)

    def histogram(self, name: str, help_text: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        assert all(b > a for a, b in zip(buckets, buckets[1:])), \
            "histogram buckets must be strictly increasing"
        assert all(math.isfinite(b) for b in buckets), \
            "histogram buckets must be finite (+Inf is implicit)"
        return self._register(name, help_text, "histogram", labelnames,
                              buckets)

    def get(self, name: str) -> _Family | None:
        return self._families.get(name)

    def prometheus_text(self) -> str:
        lines: list[str] = []
        for fam in self._families.values():
            lines.extend(fam.prometheus_lines())
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> dict:
        return {name: fam.snapshot()
                for name, fam in self._families.items()}
