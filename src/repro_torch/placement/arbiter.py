"""Multi-tenant domain arbiter (paper §III-B3 as a runtime service).

Several co-located applications share one machine's memory domains. The
arbiter is the *policy brain* over one
:class:`~repro_torch.placement.fabric.MemoryFabric`: it partitions every
domain's pages among registered tenants as fabric-view quotas, assigns
each tenant a disjoint *home* (worker) domain by priority (high-priority
tenants claim the fastest unclaimed domain), and
redistributes quota when tenants join or leave — pure ledger arithmetic on
the shared pool, no array rebuilds, no page-id remapping (the rebalance
copies and ``attach_engine`` back-channels of the pre-fabric design are
gone; engines find their priority class and co-tuning through their view).

Because every tenant's view shares the fabric's physical pool and prefix
trie, the arbiter also brokers the two cross-tenant resources the fabric
exists for: the **read-only prefix tier** (same-model tenants opt in via
``share_prefix`` and their prompt pages physically dedupe across views) and
**swap-slot loans** (idle reservations of one tenant absorb another's burst
through the fabric's loan ledger).

Best-effort tenants are tuned by the paper's two-stage
:class:`CoScheduledTuner`: stage 1 raises the tenant's DWP while the
high-priority tenants' latency stream keeps improving (pulling the tenant's
pages out of the high-priority home domains), freezing a lower bound when it
stabilises; stage 2 hill-climbs the tenant's own latency, never dropping
below the bound. ``observe()`` is the single entry point — feed it each
tenant's per-step latency and the arbiter routes the streams; cycle moves
re-home live sequences through the view's assignment-change subscription
(the scheduler registers itself — the dependency points serve → placement,
never the reverse).

Port of ``repro.placement.arbiter`` (numpy, the same ledger arithmetic).
The fabric's pool lives on ``device`` (default ``"cuda"``).
``pin_hot_preambles`` comes with the persistence tier
(``placement/persist.py``), which the port does not have yet.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np

from repro_torch.core import interleave
from repro_torch.core.dwp import CoScheduledTuner, DWPConfig
from repro_torch.placement.fabric import FabricView, MemoryFabric
from repro_torch.placement.pool import MemoryDomain
from repro_torch.placement.telemetry import Ring


class Priority(enum.Enum):
    HIGH = "high"
    BEST_EFFORT = "best_effort"


@dataclasses.dataclass(frozen=True)
class DomainSpec:
    """One physical memory domain managed by the arbiter."""

    name: str
    total_pages: int
    read_bw: float       # GB/s toward the worker chips


@dataclasses.dataclass
class Tenant:
    name: str
    priority: Priority
    share: float
    quotas: np.ndarray                 # pages per domain owned by this tenant
    home: tuple[int, ...]              # worker-domain indices
    view: FabricView
    cotuner: CoScheduledTuner | None = None
    latency: Ring = dataclasses.field(default_factory=lambda: Ring(64))

    @property
    def dwp(self) -> float:
        return self.view.dwp


class DomainArbiter:
    """Quota ledger + tuner router for N tenants over one shared fabric."""

    def __init__(self, specs: Sequence[DomainSpec], page_size: int = 8,
                 seed: int = 0, device="cuda"):
        self.specs = list(specs)
        self.page_size = page_size
        self.seed = seed
        self.free = np.asarray([s.total_pages for s in self.specs],
                               dtype=np.int64)
        self.bw = np.asarray([s.read_bw for s in self.specs])
        self.tenants: dict[str, Tenant] = {}
        self._claimed_homes: set[int] = set()
        self.device = device
        self.fabric: MemoryFabric | None = None
        self._cfg = None

    # -- registration --------------------------------------------------------

    def _pick_home(self, priority: Priority) -> int:
        """Fastest domain not yet claimed as another tenant's home; HIGH
        tenants pick before best-effort ones simply by registering first."""
        for d in np.argsort(-self.bw, kind="stable"):
            if int(d) not in self._claimed_homes:
                return int(d)
        raise RuntimeError("more tenants than domains: no free home domain")

    def _ensure_fabric(self, cfg) -> MemoryFabric:
        if self.fabric is None:
            fastest = int(np.argmax(self.bw))
            domains = [MemoryDomain(s.name, s.total_pages, s.read_bw,
                                    i == fastest)
                       for i, s in enumerate(self.specs)]
            self.fabric = MemoryFabric(cfg, domains,
                                       page_size=self.page_size,
                                       seed=self.seed, device=self.device)
            self._cfg = cfg
        else:
            assert cfg is self._cfg or cfg == self._cfg, (
                "one fabric serves one model group: tenants of a different "
                "model need their own fabric — physical page sharing "
                "requires identical page geometry. Co-locate heterogeneous "
                "groups through placement.zoo.PageFabricZoo, whose capacity "
                "market trades funding between per-group fabrics in bytes "
                "(DESIGN.md §12)")
        return self.fabric

    #: tenant priority -> scheduler class level (HIGH preempts best-effort)
    PRIORITY_LEVELS = {Priority.HIGH: 10, Priority.BEST_EFFORT: 0}

    def register(self, name: str, cfg, *, priority: Priority,
                 share: float, dwp_config: DWPConfig | None = None,
                 share_prefix: bool = True) -> Tenant:
        """Carve ``share`` of every domain's remaining pages as a new
        tenant's view quota (and build its co-scheduled tuner if
        best-effort). ``share_prefix=False`` keeps the tenant out of the
        cross-tenant read-only prefix tier."""
        assert name not in self.tenants, f"tenant {name!r} already registered"
        assert 0.0 < share <= 1.0
        fabric = self._ensure_fabric(cfg)
        totals = np.asarray([s.total_pages for s in self.specs])
        quotas = np.minimum(np.floor(totals * share).astype(np.int64),
                            self.free)
        if quotas.sum() == 0:
            raise RuntimeError("no capacity left for tenant " + name)
        home = self._pick_home(priority)
        self._claimed_homes.add(home)
        cotuner = None
        if priority is Priority.BEST_EFFORT:
            canonical = interleave.normalize(self.bw)
            cotuner = CoScheduledTuner(
                canonical, [home], num_pages=4096,
                config=dwp_config or DWPConfig(n=4, c=1,
                                               rel_tolerance=0.02),
                on_migrate=lambda plan: fabric.telemetry.record_plan(
                    plan.num_moves))
        view = fabric.view(name, quota=quotas, home=(home,),
                           level=self.PRIORITY_LEVELS[priority],
                           share_prefix=share_prefix, tuner=cotuner,
                           dwp_config=dwp_config)
        tenant = Tenant(name=name, priority=priority, share=share,
                        quotas=quotas, home=(home,), view=view,
                        cotuner=cotuner)
        self.free -= quotas
        self.tenants[name] = tenant
        return tenant

    def unregister(self, name: str) -> dict[str, np.ndarray]:
        """Release a tenant's quota and grow the remaining tenants'
        views proportionally to their shares. Pure ledger arithmetic on
        the shared pool: no live page moves, no id remapping — pages the
        leaving tenant shared into the prefix tier survive under their
        surviving holders. Returns the per-tenant page grants."""
        gone = self.tenants.pop(name)
        self._claimed_homes.discard(gone.home[0])
        released = self.fabric.unregister(name)
        self.free += released
        grants: dict[str, np.ndarray] = {}
        rest = list(self.tenants.values())
        if not rest:
            return grants
        total_share = sum(t.share for t in rest)
        remaining = released.copy()
        for i, t in enumerate(rest):
            if i == len(rest) - 1:                    # remainder to the last
                grant = remaining.copy()
            else:
                grant = np.minimum(
                    np.floor(released * (t.share / total_share)).astype(
                        np.int64),
                    remaining)
            remaining -= grant
            t.view.quota += grant
            t.quotas = t.quotas + grant
            self.free -= grant
            grants[t.name] = grant
        return grants

    # -- tuning --------------------------------------------------------------

    def observe(self, name: str, latency: float) -> bool:
        """Feed one tenant's per-step latency sample. For best-effort
        tenants this drives the two-stage co-scheduled search: stall_a is
        the freshest high-priority latency, stall_b the tenant's own. When
        the tuner moves the allocation cycle, the view's assignment-change
        subscribers (the tenant's scheduler) re-home live sequences and
        True is returned."""
        t = self.tenants[name]
        t.latency.push(latency)
        # (not pushed into fabric telemetry: the engine already records its
        # wall+sim latency there; mixing in this analytic stream would
        # average incommensurate quantities)
        if t.priority is not Priority.BEST_EFFORT or t.cotuner is None:
            return False
        high = [o.latency.last() for o in self.tenants.values()
                if o.priority is Priority.HIGH and len(o.latency)]
        stall_a = float(np.mean(high)) if high else 0.0
        return t.view.drive_cotuner(stall_a, latency)

    # -- interference model --------------------------------------------------

    def interference(self, name: str, scale: float = 1.0) -> float:
        """Analytic cross-tenant contention on ``name``'s home domains
        (Eq.-1 shape): other tenants' resident bytes there, divided by the
        domain bandwidth. The CPU host has no real memory domains, so this
        term supplies the co-location signal the paper reads from stall
        counters — same role as the engine's expected_read_time."""
        t = self.tenants[name]
        total = 0.0
        for d in t.home:
            for o in self.tenants.values():
                if o.name == name:
                    continue
                pages = int(o.view.used_pages()[d])
                total += pages * o.view.page_bytes / (self.bw[d] * 1e9)
        return scale * total

    # -- cross-tenant loans (delegated to the fabric broker) ------------------

    def loan_stats(self) -> list[dict]:
        if self.fabric is None:
            return []
        return self.fabric.stats()["loans"]

    # -- reporting ------------------------------------------------------------

    def stats(self) -> dict:
        out = {}
        for t in self.tenants.values():
            entry = {
                "priority": t.priority.value,
                "home": [self.specs[d].name for d in t.home],
                "quota_pages": int(t.quotas.sum()),
                "dwp": t.dwp,
                "latency_mean_s": t.latency.mean(),
                "occupancy": t.view.occupancy(),
            }
            if t.cotuner is not None:
                entry["stage"] = t.cotuner.stage
                entry["dwp_lower_bound"] = t.cotuner.dwp_lower_bound
            out[t.name] = entry
        if self.fabric is not None:
            out["_fabric"] = {
                "cross_shared_pages": self.fabric.cross_shared_pages(),
                "loans": self.fabric.stats()["loans"],
            }
        return out
