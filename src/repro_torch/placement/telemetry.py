"""Per-domain placement telemetry: counters + ring-buffer samples.

One :class:`DomainTelemetry` instance rides along with each page pool (and is
shared with its MigrationExecutor). Counters are cumulative since creation;
sample streams (latency, per-domain stall time) live in fixed-size ring
buffers so a long-running engine never grows memory. ``snapshot()`` is what
``ServeEngine.step()`` surfaces and what benchmarks/placement_bench.py dumps.

Since the fabric observatory (DESIGN.md §10) every counter here is *backed
by* the labeled metrics registry in :mod:`repro.obs.metrics`: each
``record_*`` call lands both in the legacy arrays (the ``snapshot()``
contract the whole test surface reads) and in a registry family with
domain/class/tier labels, so ``telemetry.metrics.prometheus_text()``
exposes the same state in Prometheus text format.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry


class Ring:
    """Fixed-capacity overwrite-oldest sample buffer."""

    def __init__(self, capacity: int = 128):
        assert capacity > 0
        self._buf = np.zeros(capacity, dtype=np.float64)
        self._next = 0
        self._count = 0

    def push(self, value: float) -> None:
        self._buf[self._next] = float(value)
        self._next = (self._next + 1) % len(self._buf)
        self._count = min(self._count + 1, len(self._buf))

    def values(self) -> np.ndarray:
        """Samples oldest-first."""
        if self._count < len(self._buf):
            return self._buf[:self._count].copy()
        return np.roll(self._buf, -self._next)

    def mean(self) -> float:
        return float(self.values().mean()) if self._count else 0.0

    def last(self) -> float:
        return float(self._buf[(self._next - 1) % len(self._buf)]) \
            if self._count else 0.0

    def quantile(self, q: float) -> float:
        """q-th sample quantile (linear interpolation) over the window;
        0.0 when empty. ``quantile(0.5)``/``quantile(0.95)`` are the
        p50/p95 the drift ledger and engine snapshots report."""
        assert 0.0 <= q <= 1.0, q
        if self._count == 0:
            return 0.0
        if self._count < len(self._buf):
            window = self._buf[:self._count]
        else:
            window = self._buf            # full ring: order is irrelevant
        return float(np.quantile(window, q))

    def __len__(self) -> int:
        return self._count


class ClassSloCounters:
    """Per-priority-class SLO accounting (scheduler subsystem, DESIGN.md §5).

    One row per class: request lifecycle counts, deadline hits/misses, token
    throughput, and swap traffic attributed to the class. The scheduler's
    :class:`repro.scheduler.slo.SloTracker` drives these; they surface in the
    owning pool's ``DomainTelemetry.snapshot()`` so engine telemetry carries
    SLO state alongside placement state. With a ``registry`` they also back
    the ``repro_slo_events_total{cls,field}`` counter family.
    """

    FIELDS = ("submitted", "completed", "preemptions", "ttft_met",
              "ttft_missed", "tpot_met", "tpot_missed", "goodput_tokens",
              "swap_out_pages", "swap_in_pages")

    def __init__(self, registry: MetricsRegistry | None = None):
        self._rows: dict[str, dict[str, int]] = {}
        self._family = registry.counter(
            "repro_slo_events_total",
            "Per-priority-class SLO lifecycle counters.",
            ("cls", "field")) if registry is not None else None

    def _row(self, cls: str) -> dict[str, int]:
        if cls not in self._rows:
            self._rows[cls] = {f: 0 for f in self.FIELDS}
        return self._rows[cls]

    def add(self, cls: str, field: str, n: int = 1) -> None:
        assert field in self.FIELDS, field
        self._row(cls)[field] += n
        if self._family is not None:
            self._family.labels(cls, field).inc(n)

    def get(self, cls: str, field: str) -> int:
        return self._row(cls)[field]

    @property
    def classes(self) -> list[str]:
        return sorted(self._rows)

    def snapshot(self) -> dict:
        return {cls: dict(row) for cls, row in sorted(self._rows.items())}


class DomainTelemetry:
    """Placement event counters for one pool's memory domains.

    Per-domain: allocs, frees, migrations in/out, bytes in/out, and a ring of
    analytic stall-time samples (the Eq.-1 per-domain read time the engine
    computes each step). Global: a latency ring and planned-vs-executed
    migration counts (the tuner plans logical moves at cycle resolution; the
    executor reports physically moved pages). When a scheduler rides on the
    pool it attaches :class:`ClassSloCounters` (``slo``) and swap totals.
    Everything mirrors into ``self.metrics`` (labeled registry).
    """

    TIER_OPS = ("demote", "promote", "restore", "evict")

    def __init__(self, domain_names: Sequence[str], ring_capacity: int = 128):
        self.domain_names = list(domain_names)
        n = len(self.domain_names)
        self.allocs = np.zeros(n, dtype=np.int64)
        self.frees = np.zeros(n, dtype=np.int64)
        self.migrations_in = np.zeros(n, dtype=np.int64)
        self.migrations_out = np.zeros(n, dtype=np.int64)
        self.bytes_in = np.zeros(n, dtype=np.int64)
        self.bytes_out = np.zeros(n, dtype=np.int64)
        self.stall = [Ring(ring_capacity) for _ in range(n)]
        self.latency = Ring(ring_capacity)
        self.planned_moves = 0
        self.executed_moves = 0
        self.rebalances = 0
        self.swap_outs = 0           # preemption swap round-trips (pages)
        self.swap_ins = 0
        self.swap_seconds = 0.0      # Eq.-1 transfer time spent swapping
        # speculative decode (DESIGN.md §7): one verify step replaces up to
        # 1 + accepted decode steps; acceptance rate is the fraction of
        # drafted tokens the model's own argmax confirmed
        self.spec_steps = 0          # verify steps with at least one draft
        self.spec_drafted = 0        # draft tokens proposed
        self.spec_accepted = 0       # draft tokens accepted
        self.spec_emitted = 0        # tokens emitted by verify steps
        # persistent tier (DESIGN.md §9): demote = swap slot -> tier,
        # promote = tier -> fast domain (through the swap forwarding map),
        # restore = prefix-store re-import into a fresh fabric,
        # evict = LRU drop of a pinned chain at the prefix store's cap
        self.tier_pages = {op: 0 for op in self.TIER_OPS}
        self.tier_seconds = {op: 0.0 for op in self.TIER_OPS}
        self.tier_occupancy: dict[str, dict[str, int]] = {}
        # event-bus subscribers that raised (fabric.emit isolates them so
        # a broken observer never aborts the alloc/free hot path)
        self.subscriber_errors = 0
        self.slo: ClassSloCounters | None = None
        self._init_metrics(ring_capacity)

    def _init_metrics(self, ring_capacity: int) -> None:
        """Registry families mirroring the legacy counters. Per-domain
        children are pre-resolved into lists so the hot-path mirror is one
        list index + one float add."""
        m = self.metrics = MetricsRegistry()
        names = self.domain_names

        def per_domain(family):
            return [family.labels(nm) for nm in names]

        self._m_allocs = per_domain(m.counter(
            "repro_pages_allocated_total",
            "Pages allocated per domain (speculative rollback decrements).",
            ("domain",)))
        self._m_frees = per_domain(m.counter(
            "repro_pages_freed_total", "Pages freed per domain.",
            ("domain",)))
        migr = m.counter(
            "repro_migrated_pages_total",
            "Pages physically migrated, per domain and direction.",
            ("domain", "direction"))
        self._m_migr_in = [migr.labels(nm, "in") for nm in names]
        self._m_migr_out = [migr.labels(nm, "out") for nm in names]
        mb = m.counter(
            "repro_migrated_bytes_total",
            "Bytes physically migrated, per domain and direction.",
            ("domain", "direction"))
        self._m_bytes_in = [mb.labels(nm, "in") for nm in names]
        self._m_bytes_out = [mb.labels(nm, "out") for nm in names]
        stall = m.histogram(
            "repro_stall_seconds",
            "Eq.-1 per-domain read-time samples.", ("domain",))
        self._m_stall = [stall.labels(nm) for nm in names]
        self._m_latency = m.histogram(
            "repro_latency_seconds", "Per-step engine latency samples.")
        self._m_planned = m.counter(
            "repro_planned_moves_total", "Tuner-planned logical moves.")
        self._m_executed = m.counter(
            "repro_executed_moves_total", "Executor-moved physical pages.")
        self._m_rebalances = m.counter(
            "repro_rebalances_total", "Arbiter capacity rebalances.")
        swap = m.counter(
            "repro_swap_pages_total",
            "Preemption swap traffic in pages, by direction.",
            ("direction",))
        self._m_swap = {"out": swap.labels("out"), "in": swap.labels("in")}
        self._m_swap_seconds = m.counter(
            "repro_swap_seconds_total", "Eq.-1 seconds spent swapping.")
        spec = m.counter(
            "repro_spec_tokens_total",
            "Speculative decode token counts, by outcome.", ("outcome",))
        self._m_spec = {o: spec.labels(o)
                        for o in ("drafted", "accepted", "emitted")}
        self._m_spec_steps = m.counter(
            "repro_spec_steps_total", "Verify steps with >= 1 draft token.")
        tier_p = m.counter(
            "repro_tier_pages_total",
            "Pages moved by persistent-tier ops.", ("op",))
        tier_s = m.counter(
            "repro_tier_seconds_total",
            "Eq.-1 seconds spent on persistent-tier ops.", ("op",))
        self._m_tier_pages = {op: tier_p.labels(op) for op in self.TIER_OPS}
        self._m_tier_seconds = {op: tier_s.labels(op)
                                for op in self.TIER_OPS}
        self._m_tier_occ = m.gauge(
            "repro_tier_occupancy_pages",
            "Pages resident per placement tier right now.",
            ("tier", "kind"))
        self._m_sub_errors = m.counter(
            "repro_subscriber_errors_total",
            "Fabric event-bus subscribers that raised (isolated).",
            ("event",))

    # -- event hooks --------------------------------------------------------

    def record_alloc(self, domain: int, pages: int = 1) -> None:
        self.allocs[domain] += pages
        self._m_allocs[domain].inc(pages)

    def record_free(self, domain: int, pages: int = 1) -> None:
        self.frees[domain] += pages
        self._m_frees[domain].inc(pages)

    def record_migration(self, src_domain: int, dst_domain: int,
                         pages: int, nbytes: int) -> None:
        self.migrations_out[src_domain] += pages
        self.migrations_in[dst_domain] += pages
        self.bytes_out[src_domain] += nbytes
        self.bytes_in[dst_domain] += nbytes
        self._m_migr_out[src_domain].inc(pages)
        self._m_migr_in[dst_domain].inc(pages)
        self._m_bytes_out[src_domain].inc(nbytes)
        self._m_bytes_in[dst_domain].inc(nbytes)
        self.record_executed(pages)

    def record_executed(self, pages: int) -> None:
        """Physical pages the migration executor moved (also reached via
        :meth:`record_migration` when per-pair attribution is known)."""
        self.executed_moves += pages
        self._m_executed.inc(pages)

    def record_plan(self, num_moves: int) -> None:
        self.planned_moves += num_moves
        self._m_planned.inc(num_moves)

    def record_latency(self, seconds: float) -> None:
        self.latency.push(seconds)
        self._m_latency.observe(seconds)

    def record_stall(self, domain: int, seconds: float) -> None:
        self.stall[domain].push(seconds)
        self._m_stall[domain].observe(seconds)

    def record_rebalance(self) -> None:
        self.rebalances += 1
        self._m_rebalances.inc()

    def record_swap(self, direction: str, pages: int,
                    seconds: float) -> None:
        assert direction in ("out", "in")
        if direction == "out":
            self.swap_outs += pages
        else:
            self.swap_ins += pages
        self.swap_seconds += float(seconds)
        self._m_swap[direction].inc(pages)
        self._m_swap_seconds.inc(float(seconds))

    def record_tier(self, op: str, pages: int, seconds: float) -> None:
        """One persistent-tier transfer (Eq.-1 priced, see bwmodel)."""
        assert op in self.TIER_OPS, op
        self.tier_pages[op] += int(pages)
        self.tier_seconds[op] += float(seconds)
        self._m_tier_pages[op].inc(int(pages))
        self._m_tier_seconds[op].inc(float(seconds))

    def record_tier_occupancy(self, tier: str, used: int,
                              capacity: int) -> None:
        """Gauge: pages resident in one placement tier right now."""
        self.tier_occupancy[tier] = {"used": int(used),
                                     "capacity": int(capacity)}
        self._m_tier_occ.labels(tier, "used").set(used)
        self._m_tier_occ.labels(tier, "capacity").set(capacity)

    def record_spec(self, drafted: int, accepted: int,
                    emitted: int) -> None:
        """One speculative verify step's draft/accept/emit totals."""
        self.spec_steps += 1
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted
        self._m_spec_steps.inc()
        self._m_spec["drafted"].inc(drafted)
        self._m_spec["accepted"].inc(accepted)
        self._m_spec["emitted"].inc(emitted)

    def record_subscriber_error(self, event: str) -> None:
        """A fabric event-bus subscriber raised; ``MemoryFabric.emit``
        isolated it so the alloc/free hot path survived."""
        self.subscriber_errors += 1
        self._m_sub_errors.labels(event).inc()

    def attach_slo(self) -> ClassSloCounters:
        """Create (or return) the per-class SLO counter block."""
        if self.slo is None:
            self.slo = ClassSloCounters(self.metrics)
        return self.slo

    # -- reporting ----------------------------------------------------------

    @property
    def bytes_moved(self) -> int:
        return int(self.bytes_in.sum())

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()

    def snapshot(self) -> dict:
        domains = {}
        for i, name in enumerate(self.domain_names):
            domains[name] = {
                "allocs": int(self.allocs[i]),
                "frees": int(self.frees[i]),
                "migr_in": int(self.migrations_in[i]),
                "migr_out": int(self.migrations_out[i]),
                "bytes_in": int(self.bytes_in[i]),
                "bytes_out": int(self.bytes_out[i]),
                "stall_mean_s": self.stall[i].mean(),
                "stall_p95_s": self.stall[i].quantile(0.95),
            }
        out = {
            "domains": domains,
            "latency_mean_s": self.latency.mean(),
            "latency_last_s": self.latency.last(),
            "latency_p50_s": self.latency.quantile(0.5),
            "latency_p95_s": self.latency.quantile(0.95),
            "planned_moves": self.planned_moves,
            "executed_moves": self.executed_moves,
            "bytes_moved": self.bytes_moved,
            "rebalances": self.rebalances,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "swap_seconds": self.swap_seconds,
            "subscriber_errors": self.subscriber_errors,
            "spec": {
                "steps": self.spec_steps,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "emitted": self.spec_emitted,
                "acceptance_rate": (self.spec_accepted
                                    / max(self.spec_drafted, 1)),
            },
            "tiers": {
                "ops": {op: {"pages": self.tier_pages[op],
                             "seconds": self.tier_seconds[op]}
                        for op in self.TIER_OPS},
                "occupancy": {k: dict(v)
                              for k, v in self.tier_occupancy.items()},
            },
        }
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        return out
