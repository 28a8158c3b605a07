"""Memory fabric: one placement surface for pool, page table, swap, arbiter.

BWAP's thesis is that placement must be tuned per co-located application
partition (paper §III-B3); before this layer the runtime's placement state
was smeared across four subsystems glued by ad-hoc attach calls
(``pool.table``, ``arbiter.attach_engine``, ``telemetry.attach_pagetable``,
``swap → pool.set_reserved_counts``). The fabric replaces those pairwise
back-channels with a single owner (DESIGN.md §8):

- :class:`MemoryFabric` owns the memory domains, the physical page pool
  (one array set per model group — which is what makes *cross-tenant*
  physical page sharing possible at all), the logical page table, the
  per-tenant quota/reservation ledgers, the swap-slot loan broker, the
  Eq.-1 calibration state, the persistent third tier
  (:class:`~repro.placement.persist.PersistentTier`, DESIGN.md §9), and an
  event bus (``on_alloc/on_free/on_migrate/on_share/on_latency`` plus the
  tier's ``on_demote/on_promote/on_restore``).
- :class:`FabricView` is a tenant-scoped handle — the **only** API the
  serve/scheduler layers touch. Page lifetime (``alloc``/``free``/CoW/
  prefix sharing), swap reservations and loans, migration, Eq.-1 cost
  queries, and the K/V data plane all go through the view, which charges
  every physical page to its tenant's ledger.

Tenants of one fabric share one physical pool and one prefix trie, so a
view's ``probe_prefix`` can map another tenant's registered prompt pages
into its own sequences (the arbiter-brokered read-only prefix tier;
``share_prefix`` gates it per view), and idle swap reservations can be
loaned across tenants (``request_loan``/``recall_loans``) with Eq.-1
stall-cost accounting on the reclaim path.

``as_view(pool)`` adopts a bare :class:`BwapPagePool` into a single-view
fabric whose placement decisions delegate to the pool's own tuner/cycle —
bit-identical to the pre-fabric behavior — so single-tenant callers keep
constructing pools directly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import bwmodel, interleave
from repro_torch.core.dwp import DWPConfig, DWPTuner
from repro_torch.placement import policy as placement_policy
from repro_torch.placement.pool import BwapPagePool, MemoryDomain
from repro_torch.placement.telemetry import DomainTelemetry

EVENTS = ("alloc", "free", "migrate", "share", "latency",
          "demote", "promote", "restore",
          "evict", "export_skip", "link_send", "link_recv")

# The event payload contract: every ``emit(event, ...)`` call site carries
# AT LEAST these keyword fields (tests/test_obs.py asserts it statically
# over the source and dynamically on a live fabric), so tracer/metrics
# subscribers can rely on them. ``share`` fans out by ``kind``.
EVENT_FIELDS: dict[str, tuple[str, ...]] = {
    "alloc": ("view", "page", "domain"),
    "free": ("view", "page", "domain"),      # view None: owner already gone
    "migrate": ("view", "src", "dst"),       # one physical page id pair
    "share": ("kind",),                      # + SHARE_KIND_FIELDS[kind]
    "latency": ("view", "seconds"),
    "demote": ("view", "pages", "handles", "seconds"),
    "promote": ("view", "pages", "seconds"),
    "restore": ("view", "pages", "seconds"),
    "evict": ("view", "pages", "chains"),        # LRU prefix-store eviction
    "export_skip": ("view", "pages", "chains"),  # over-cap chains dropped
    "link_send": ("view", "bytes", "chunks", "seconds"),
    "link_recv": ("view", "pages", "bytes", "seconds"),
}
SHARE_KIND_FIELDS: dict[str, tuple[str, ...]] = {
    "prefix": ("page", "owner", "view"),     # view = the borrowing reader
    "loan": ("lender", "borrower", "slots"),
    "reclaim": ("lender", "borrower", "slots", "seconds"),
}


@dataclasses.dataclass
class SlotLoan:
    """One cross-tenant swap-slot loan (arbiter-brokered)."""

    lender: str
    borrower: str
    slots: list[int]                     # outstanding loaned slot ids
    granted: int = 0                     # cumulative slots ever granted
    reclaimed: int = 0                   # cumulative slots reclaimed
    reclaim_seconds: float = 0.0         # Eq.-1 time spent vacating

    def as_dict(self) -> dict:
        return {
            "lender": self.lender, "borrower": self.borrower,
            "outstanding": len(self.slots), "granted": self.granted,
            "reclaimed": self.reclaimed,
            "reclaim_seconds": self.reclaim_seconds,
        }


class MemoryFabric:
    """Owner of one model group's placement state; hands out views."""

    def __init__(self, cfg, domains: Sequence[MemoryDomain], *,
                 page_size: int = 16, seed: int = 0,
                 policy: str = "bwap_dwp",
                 telemetry: DomainTelemetry | None = None,
                 calibration_alpha: float = 0.25,
                 geometry=None, group: str = "", device="cuda"):
        self.cfg = cfg
        self.seed = seed
        self.policy_name = policy
        # model-group label (zoo member fabrics set it; "" = single-group,
        # which keeps every metric label bit-identical to pre-zoo runs)
        self.group = group
        self.pool = BwapPagePool(cfg, domains, page_size=page_size,
                                 seed=seed, policy=policy,
                                 telemetry=telemetry, geometry=geometry,
                                 device=device)
        self.table = self.pool.table
        self.telemetry = self.pool.telemetry
        self.views: dict[str, FabricView] = {}
        self.owner: dict[int, str] = {}        # live physical page -> view
        self._subs: dict[str, list[Callable]] = {e: [] for e in EVENTS}
        self._providers: dict[str, object] = {}   # view -> slot provider
        self.loans: list[SlotLoan] = []
        self.persist = None                    # PersistentTier (third tier)
        self.obs = None                        # Observatory (DESIGN.md §10)
        self._adopted = False
        # Eq.-1 calibration (EWMA over measured per-domain transfer times);
        # starts at the analytic bandwidths and is shared by every view's
        # stall_cost / expected_read_time / swap-transfer estimate
        self._alpha = calibration_alpha
        self._bw_cal = np.asarray(self.pool.bw, dtype=np.float64).copy()
        self.calibration_samples = 0

    # -- adoption (single-view compat over a bare pool) ----------------------

    @classmethod
    def adopt(cls, pool: BwapPagePool) -> "MemoryFabric":
        """Wrap an existing pool in a single-view fabric. Placement
        decisions (allocation cycle, weights, migration targets, tuner)
        delegate to the pool itself, so adopted behavior is bit-identical
        to driving the pool directly."""
        fab = cls.__new__(cls)
        fab.cfg = pool.cfg
        fab.seed = 0
        fab.policy_name = "adopted"
        fab.group = ""
        fab.pool = pool
        fab.table = pool.table
        fab.telemetry = pool.telemetry
        fab.views = {}
        fab.owner = {}
        fab._subs = {e: [] for e in EVENTS}
        fab._providers = {}
        fab.loans = []
        fab.persist = None
        fab.obs = None
        fab._adopted = True
        fab._alpha = 0.25
        fab._bw_cal = np.asarray(pool.bw, dtype=np.float64).copy()
        fab.calibration_samples = 0
        quota = np.asarray([d.num_pages for d in pool.domains],
                           dtype=np.int64)
        view = FabricView(fab, "default", quota=quota, home=pool.workers,
                          adopted=True)
        fab.views["default"] = view
        return fab

    # -- persistent tier (third tier below the swap slots) ---------------------

    def attach_persist(self, tier) -> None:
        """Own a :class:`~repro.placement.persist.PersistentTier`. Its
        demote/promote/restore events route into the telemetry tier
        counters, and each event refreshes the per-tier occupancy gauges
        (fast domains / swap slots / persistent tier)."""
        assert self.persist is None, "fabric already owns a persistent tier"
        self.persist = tier
        tier.bind(self)
        for ev in ("demote", "promote", "restore", "evict"):
            self.subscribe(ev, self._tier_recorder(ev))
        self.refresh_tier_gauges()

    def _tier_recorder(self, event: str) -> Callable:
        def record(pages: int = 0, seconds: float = 0.0, **_) -> None:
            self.telemetry.record_tier(event, int(pages), float(seconds))
            self.refresh_tier_gauges()
        return record

    def refresh_tier_gauges(self) -> None:
        """Occupancy gauges for the three placement tiers (DESIGN.md §9)."""
        tel, pool = self.telemetry, self.pool
        reserved = int(pool.reserved.sum())
        tel.record_tier_occupancy("fast_domains",
                                  int(pool.used_pages().sum()),
                                  pool.total_pages - reserved)
        parked = sum(len(p.parked_ids())
                     for p in self._providers.values())
        tel.record_tier_occupancy("swap_slots", parked, reserved)
        if self.persist is not None:
            tel.record_tier_occupancy(self.persist.name,
                                      self.persist.used_pages(),
                                      self.persist.capacity_pages)

    # -- event bus ------------------------------------------------------------

    def subscribe(self, event: str, fn: Callable) -> None:
        """Register ``fn`` on one of the fabric events (``alloc``, ``free``,
        ``migrate``, ``share``, ``latency``, the tier's ``demote``/
        ``promote``/``restore``/``evict``/``export_skip``, or the cluster
        wire's ``link_send``/``link_recv``). Callbacks receive keyword
        arguments only; unknown keys must be tolerated (``**_``)."""
        assert event in EVENTS, f"unknown fabric event {event!r}"
        self._subs[event].append(fn)

    def emit(self, event: str, **kw) -> None:
        """Fan one event out to its subscribers. A raising subscriber is
        isolated — emit sits on the alloc/free hot path, and a broken
        observer must never abort placement — and counted in
        ``telemetry.subscriber_errors`` (labeled per event in the metrics
        registry)."""
        for fn in self._subs[event]:
            try:
                fn(**kw)
            except Exception:
                self.telemetry.record_subscriber_error(event)

    def attach_obs(self, obs) -> None:
        """Register the fabric observatory (``repro.obs.Observatory``);
        scheduler/engine/swap hot paths find it via ``view.fabric.obs``."""
        assert self.obs is None, "fabric already has an observatory"
        self.obs = obs

    # -- views ----------------------------------------------------------------

    def view(self, name: str, *, quota: Sequence[int],
             home: Sequence[int], level: int = 0,
             share_prefix: bool = True, tuner=None,
             dwp_config: DWPConfig | None = None) -> "FabricView":
        """Create a tenant view: ``quota`` pages per domain (the view's
        ledger ceiling), ``home`` worker domains (its placement target),
        ``level`` its scheduling priority, ``share_prefix`` its membership
        in the cross-tenant read-only prefix tier. ``tuner`` overrides the
        view's DWP tuner (the arbiter passes a CoScheduledTuner for
        best-effort tenants)."""
        assert name not in self.views, f"view {name!r} already registered"
        assert not self._adopted, "adopted fabrics are single-view"
        quota = np.asarray(quota, dtype=np.int64)
        assert quota.shape == (len(self.pool.domains),)
        v = FabricView(self, name, quota=quota, home=tuple(home),
                       level=level, share_prefix=share_prefix,
                       tuner=tuner, dwp_config=dwp_config)
        self.views[name] = v
        return v

    def unregister(self, name: str) -> np.ndarray:
        """Remove a view. Remaining holds are force-released (a drained
        tenant has none); pages that survive because other views hold them
        are re-owned by a surviving holder, so nothing leaks and nothing a
        live tenant reads is freed. Returns the view's per-domain quota for
        the caller (arbiter) to redistribute — pure ledger arithmetic, no
        array rebuild, no id remapping. The view's swap manager (if any)
        is closed first: loans settle and its reservation returns to the
        allocator."""
        v = self.views[name]
        prov = self._providers.get(name)
        if prov is not None and hasattr(prov, "close"):
            prov.close()
        for pid in [p for p, c in list(v._held.items()) for _ in range(c)]:
            if pid < 0:                 # persisted handle: no free-list id
                v.drop_parked_ref(pid)
                if pid not in self.table.ref and self.persist is not None:
                    self.persist.forget(pid)
                continue
            v._drop(pid)
            dead = self.table.release([pid])
            for d in dead:
                self._on_free(d)
        for pid, owner in list(self.owner.items()):
            if owner == name:            # shared pages another view holds
                self._reassign_owner(pid, exclude=name)
        del self.views[name]
        self._providers.pop(name, None)
        assert not any(ln.slots for ln in self.loans
                       if name in (ln.lender, ln.borrower)), \
            "unregistered view still party to an outstanding loan"
        assert not any(o == name for o in self.owner.values()), \
            "unregistered view still owns pages"
        return v.quota.copy()

    # -- ledger hooks (views call these; nothing else should) -----------------

    def _own(self, view: "FabricView", pid: int) -> None:
        self.owner[pid] = view.name
        view.used[self.pool.domain_of(pid)] += 1
        self.emit("alloc", view=view.name, page=pid,
                  domain=self.pool.domain_of(pid))

    def _on_alloc(self, view: "FabricView", pid: int) -> None:
        self._own(view, pid)
        view._hold(pid)

    def _on_free(self, pid: int) -> None:
        name = self.owner.pop(pid, None)
        if name is not None and name in self.views:
            self.views[name].used[self.pool.domain_of(pid)] -= 1
        self.emit("free", view=name, page=pid,
                  domain=self.pool.domain_of(pid))

    def _on_undo(self, view: "FabricView", pid: int) -> None:
        """Speculative-allocation rollback: ownership reverts with no free
        event (rejected speculation is not page churn)."""
        if self.owner.pop(pid, None) is not None:
            view.used[self.pool.domain_of(pid)] -= 1

    def _reassign_owner(self, pid: int, exclude: str) -> None:
        for v in self.views.values():
            if v.name != exclude and v._held.get(pid, 0) > 0:
                old = self.owner.get(pid)
                if old is not None and old in self.views:
                    self.views[old].used[self.pool.domain_of(pid)] -= 1
                self.owner[pid] = v.name
                v.used[self.pool.domain_of(pid)] += 1
                return
        # nobody else holds it: the caller is about to free it

    # -- swap-slot loan broker -------------------------------------------------

    def offer_slots(self, view: "FabricView", provider) -> None:
        """A view's swap manager registers as a slot provider. Protocol:
        ``lendable_count(domains=None)``, ``lend_slots(n, domains) ->
        ids``, ``take_slots(ids)``, ``yield_slots(ids) -> (ids,
        seconds)``, ``idle_count(ids)``, ``parked_ids()``."""
        self._providers[view.name] = provider

    def withdraw_slots(self, view: "FabricView") -> None:
        """Remove a view's slot provider (its swap manager closed)."""
        self._providers.pop(view.name, None)

    def borrowable(self, borrower: "FabricView") -> int:
        """Idle slots other views could lend right now — counting only
        domains the borrower can actually park in (its slow set), so the
        promise matches what ``request_loan`` can deliver."""
        want = set(borrower.slow_domains)
        return sum(p.lendable_count(want)
                   for name, p in self._providers.items()
                   if name != borrower.name)

    def recallable(self, lender: "FabricView") -> int:
        """Loaned-out slots of ``lender`` that are instantly reclaimable
        (idle at the borrower); parked loaned slots may still vacate on
        demand but are not promised here."""
        n = 0
        for loan in self.loans:
            if loan.lender != lender.name or not loan.slots:
                continue
            p = self._providers.get(loan.borrower)
            if p is not None:
                n += p.idle_count(loan.slots)
        return n

    def request_loan(self, borrower: "FabricView", n: int) -> int:
        """Broker up to ``n`` idle reserved slots from other views into the
        borrower's swap manager. Slots stay charged to the lender's
        reservation ledger (the loan is temporary occupancy, not a quota
        transfer). Returns the number of slots granted."""
        taker = self._providers.get(borrower.name)
        if taker is None or n <= 0:
            return 0
        want_domains = set(borrower.slow_domains)
        granted = 0
        for name, p in self._providers.items():
            if granted >= n or name == borrower.name:
                continue
            ids = p.lend_slots(min(n - granted,
                                   p.lendable_count(want_domains)),
                               want_domains)
            if not ids:
                continue
            taker.take_slots(ids)
            loan = self._loan(name, borrower.name)
            loan.slots.extend(ids)
            loan.granted += len(ids)
            granted += len(ids)
            self.emit("share", kind="loan", lender=name,
                      borrower=borrower.name, slots=list(ids))
        return granted

    def recall_loans(self, lender: "FabricView",
                     need: int) -> tuple[int, float]:
        """Reclaim up to ``need`` loaned-out slots for ``lender``. Borrowers
        vacate on demand: idle slots return instantly; parked slots
        relocate into the borrower's remaining reservation (one batched
        copy, Eq.-1 stall-cost accounted on the loan record). Returns
        ``(slots_returned, seconds)``."""
        back = self._providers.get(lender.name)
        returned, seconds = 0, 0.0
        if back is None:
            return returned, seconds
        for loan in self.loans:
            if returned >= need or loan.lender != lender.name \
                    or not loan.slots:
                continue
            holder = self._providers.get(loan.borrower)
            if holder is None:
                continue
            # ask idle slots first: a parked slot the borrower cannot
            # vacate must not shadow reclaimable idle ones further down
            idle = [p for p in loan.slots if holder.idle_count([p])]
            parked = [p for p in loan.slots if p not in idle]
            ask = (idle + parked)[:need - returned]
            got, secs = holder.yield_slots(list(ask))
            for pid in got:
                loan.slots.remove(pid)
            back.take_slots(got)
            loan.reclaimed += len(got)
            loan.reclaim_seconds += secs
            returned += len(got)
            seconds += secs
            self.emit("share", kind="reclaim", lender=lender.name,
                      borrower=loan.borrower, slots=list(got),
                      seconds=secs)
        return returned, seconds

    def _loan(self, lender: str, borrower: str) -> SlotLoan:
        for loan in self.loans:
            if loan.lender == lender and loan.borrower == borrower:
                return loan
        loan = SlotLoan(lender, borrower, [])
        self.loans.append(loan)
        return loan

    def settle_loans(self, view: "FabricView") -> None:
        """Close out every loan touching ``view`` (its swap manager is
        shutting down). Borrowed slots go back to their lenders (the
        closing manager holds no parked KV, so they are idle). Lent-out
        slots are recalled; any the borrower cannot vacate transfer their
        reservation charge to the borrower — occupancy must stay
        consistent even if the lender leaves."""
        name = view.name
        for loan in self.loans:
            if loan.borrower == name and loan.slots:
                holder = self._providers.get(name)
                lender = self._providers.get(loan.lender)
                got, _ = holder.yield_slots(list(loan.slots))
                assert len(got) == len(loan.slots), \
                    "closing borrower still parks KV in loaned slots"
                loan.slots.clear()
                loan.reclaimed += len(got)
                if lender is not None:
                    lender.take_slots(got)
                else:                     # lender view already gone
                    for q in got:
                        self.pool.unreserve_page(q)
            if loan.lender == name and loan.slots:
                self.recall_loans(view, len(loan.slots))
                for q in list(loan.slots):
                    d = self.pool.domain_of(q)
                    assert view.reserved[d] > 0
                    view.reserved[d] -= 1
                    borrower = self.views.get(loan.borrower)
                    if borrower is not None:
                        borrower.reserved[d] += 1
                    loan.slots.remove(q)

    # -- Eq.-1 calibration -----------------------------------------------------

    @property
    def bw_effective(self) -> np.ndarray:
        """Per-domain bandwidths every Eq.-1 consumer reads: the analytic
        profile until ``calibrate`` feeds measurements, then the EWMA of
        measured transfer rates (ROADMAP real-machine calibration)."""
        return self._bw_cal

    def calibrate(self, measured_s: Sequence[float | None],
                  *, page_bytes: int | None = None) -> np.ndarray:
        """Fold one measured sample per domain into the effective
        bandwidths: ``measured_s[d]`` is the observed seconds to transfer
        one page (``page_bytes`` overrides the pool's page size) from
        domain ``d``; ``None`` skips a domain. EWMA with the fabric's
        ``calibration_alpha``; returns the updated effective GB/s."""
        nbytes = page_bytes if page_bytes is not None \
            else self.pool.page_bytes
        for d, s in enumerate(measured_s):
            if s is None:
                continue
            assert s > 0, "measured transfer time must be positive"
            sample = nbytes / float(s) / 1e9
            self._bw_cal[d] = ((1 - self._alpha) * self._bw_cal[d]
                               + self._alpha * sample)
        self.calibration_samples += 1
        return self._bw_cal.copy()

    # -- invariants / reporting ------------------------------------------------

    def cross_shared_pages(self) -> int:
        """Physical pages currently held by two or more distinct views —
        the cross-tenant prefix tier's footprint saving."""
        n = 0
        views = list(self.views.values())
        for pid in self.table.ref:
            holders = sum(1 for v in views if v._held.get(pid, 0) > 0)
            n += holders >= 2
        return n

    def check_invariants(self) -> None:
        """Fabric-wide consistency (the hypothesis property test drives
        this after every operation): refcounts == view holds, ownership
        ledgers == live allocations, parked pages accounted, page ids
        conserved."""
        held: dict[int, int] = {}
        for v in self.views.values():
            for pid, c in v._held.items():
                assert c > 0, f"non-positive hold {pid} in {v.name}"
                held[pid] = held.get(pid, 0) + c
        assert held == dict(self.table.ref), \
            f"view holds {held} != table refcounts {dict(self.table.ref)}"
        per_view = {n: np.zeros(len(self.pool.domains), dtype=np.int64)
                    for n in self.views}
        for pid, name in self.owner.items():
            assert name in self.views, f"page {pid} owned by ghost {name!r}"
            per_view[name][self.pool.domain_of(pid)] += 1
        for name, v in self.views.items():
            np.testing.assert_array_equal(
                v.used, per_view[name],
                err_msg=f"view {name!r} ledger != ownership map")
        parked = set()
        for p in self._providers.values():
            parked |= set(p.parked_ids())
        persisted = set(self.persist.persisted_ids()) \
            if self.persist is not None else set()
        for pid in self.table.ref:
            assert pid in self.owner or pid in parked \
                or pid in persisted, \
                f"live page {pid} neither owned, parked, nor persisted"
        if self.persist is not None:
            per = self.persist.per_view_counts()
            for name, v in self.views.items():
                assert int(v.persisted) == per.get(name, 0), \
                    f"view {name!r} persisted ledger != tier contents"
            for h in persisted:
                assert h <= -2, f"persisted handle {h} collides with ids"
                assert h not in self.owner, \
                    f"persisted handle {h} owned as a live page"
        free = sum(len(f) for f in self.pool.free)
        assert free + len(self.owner) + int(self.pool.reserved.sum()) \
            == self.pool.total_pages, "page ids not conserved"
        # byte-denominated ledger balance (DESIGN.md §12): every page of
        # this fabric carries the group geometry's page_bytes, so view
        # byte ledgers must sum to exactly the owned physical bytes
        pb = int(self.pool.page_bytes)
        assert sum(v.used_bytes() for v in self.views.values()) \
            == len(self.owner) * pb, "view byte ledgers != owned bytes"
        assert (free + int(self.pool.reserved.sum())) * pb \
            + sum(v.used_bytes() for v in self.views.values()) \
            == self.pool.total_pages * pb, "fabric bytes not conserved"

    def stats(self) -> dict:
        out = {
            "views": {},
            "cross_shared_pages": self.cross_shared_pages(),
            "calibration_samples": self.calibration_samples,
            "bw_effective_gbps": self._bw_cal.tolist(),
            "loans": [ln.as_dict() for ln in self.loans],
        }
        if self.persist is not None:
            out["persist"] = self.persist.stats()
        for name, v in self.views.items():
            out["views"][name] = {
                "quota": v.quota.tolist(),
                "used": v.used.tolist(),
                "reserved": v.reserved.tolist(),
                "quota_bytes": v.quota_bytes(),
                "used_bytes": v.used_bytes(),
                "held_logical": int(sum(v._held.values())),
                "persisted": int(v.persisted),
                "level": v.level,
                "share_prefix": v.share_prefix,
                "dwp": v.dwp,
            }
        return out


class FabricView:
    """Tenant-scoped placement handle — the only surface serve/scheduler
    layers may touch. Wraps page lifetime, sharing, reservations, loans,
    migration, Eq.-1 costs, and the K/V data plane, charging everything to
    this tenant's ledger."""

    def __init__(self, fabric: MemoryFabric, name: str, *,
                 quota: np.ndarray, home: Sequence[int], level: int = 0,
                 share_prefix: bool = True, tuner=None,
                 dwp_config: DWPConfig | None = None,
                 adopted: bool = False):
        self.fabric = fabric
        self.name = name
        # private copy: the arbiter mutates view quotas on rebalance and
        # keeps its own ledger — aliasing would double-apply grants
        self.quota = np.array(quota, dtype=np.int64)
        self.home = tuple(home)
        self.level = level
        self.share_prefix = share_prefix
        self._adopted = adopted
        self.used = np.zeros(len(fabric.pool.domains), dtype=np.int64)
        self.reserved = np.zeros(len(fabric.pool.domains), dtype=np.int64)
        self.persisted = 0             # this view's pages in the third tier
        self._held: dict[int, int] = {}
        self._assignment_cbs: list[Callable] = []
        self._page_remap_cbs: list[Callable] = []
        pool = fabric.pool
        if adopted:
            self._cotuned = False
            self.tuner = None            # property delegates to the pool
            self._policy = None
        else:
            self._policy = placement_policy.resolve(fabric.policy_name)
            canonical = placement_policy.weights(
                "bwap_canonical", self._ctx(0.0))
            self._cotuned = tuner is not None
            self.tuner = tuner if tuner is not None else DWPTuner(
                canonical, list(self.home), num_pages=4096,
                config=dwp_config or DWPConfig(n=8, c=2),
                on_migrate=lambda plan: fabric.telemetry.record_plan(
                    plan.num_moves))
            self._cycle_pos = 0
            self._perm = np.random.default_rng(
                fabric.seed + len(fabric.views)).permutation(
                len(self.tuner.assignment))

    # -- config / topology ----------------------------------------------------

    @property
    def pool(self) -> BwapPagePool:
        return self.fabric.pool

    @property
    def table(self):
        return self.fabric.table

    @property
    def telemetry(self) -> DomainTelemetry:
        return self.fabric.telemetry

    @property
    def page_size(self) -> int:
        return self.pool.page_size

    @property
    def page_bytes(self) -> int:
        return self.pool.page_bytes

    @property
    def geometry(self):
        """This group's :class:`~repro.placement.geometry.PageGeometry`
        (growth law, shareability class, bytes per page)."""
        return self.pool.geometry

    def quota_bytes(self) -> int:
        """Byte-denominated funding of this view (DESIGN.md §12) — the
        ledger unit the capacity market trades in."""
        return int(self.quota.sum()) * int(self.page_bytes)

    def used_bytes(self) -> int:
        """Bytes of physical pages currently charged to this view."""
        return int(self.used.sum()) * int(self.page_bytes)

    @property
    def domains(self):
        return self.pool.domains

    @property
    def bw(self) -> np.ndarray:
        """Effective (calibrated) per-domain bandwidths."""
        return self.fabric.bw_effective

    @property
    def slow_domains(self) -> tuple[int, ...]:
        """Domains outside this view's home set — where its KV parks."""
        if self._adopted:
            return self.pool.slow_domains
        return tuple(d for d in range(len(self.pool.domains))
                     if d not in self.home)

    def domain_of(self, pid: int) -> int:
        return self.pool.domain_of(pid)

    @property
    def placement_policy(self) -> placement_policy.PlacementPolicy:
        """The resolved policy instance steering this view — carries the
        execution-mode flags (``micro_batch``/``rehome``) the scheduler
        and engine read. Adopted views delegate to the pool's policy."""
        return self.pool.policy if self._adopted else self._policy

    def capacity(self) -> int:
        """Pages this view may ever hold at once (its quota)."""
        return int(self.quota.sum())

    # -- allocation ------------------------------------------------------------

    def _headroom(self, d: int) -> int:
        return int(self.quota[d] - self.used[d] - self.reserved[d])

    def _alloc_physical(self) -> int:
        """Next physical page id under this view's placement cycle and
        quota ledger (adopted views delegate to the pool's own cycle)."""
        pool = self.pool
        if self._adopted:
            return pool.alloc_page()
        cycle = self.tuner.assignment
        for _ in range(len(cycle)):
            want = int(cycle[self._perm[self._cycle_pos % len(self._perm)]])
            self._cycle_pos += 1
            if pool.free[want] and self._headroom(want) > 0:
                self.telemetry.record_alloc(want)
                return pool.free[want].pop()
        for d in pool._bw_order:
            if pool.free[d] and self._headroom(d) > 0:
                self.telemetry.record_alloc(d)
                return pool.free[d].pop()
        raise RuntimeError(
            f"fabric quota exhausted for view {self.name!r}")

    def alloc(self) -> int:
        """One fresh page charged to this view (no table reference — use
        ``append_page`` for sequence views)."""
        pid = self._alloc_physical()
        self.fabric._own(self, pid)
        return pid

    def free(self, pages: Sequence[int]) -> None:
        """Return raw (table-less) pages from ``alloc``."""
        self.pool.free_pages(pages)
        for pid in pages:
            self.fabric._on_free(pid)

    def alloc_marker(self) -> int:
        """Allocation-cycle position for speculative rollback."""
        return self.pool.alloc_marker() if self._adopted else self._cycle_pos

    def undo_alloc(self, pid: int, marker_before: int,
                   marker_after: int) -> None:
        """Rollback of a speculative allocation: free-list LIFO return,
        cycle rewind, alloc-count revert, ledger revert — as if the
        allocation never happened."""
        if self._adopted:
            self.pool.undo_alloc(pid, marker_before, marker_after)
        else:
            self.pool.return_speculative(pid)
            if self._cycle_pos == marker_after:
                self._cycle_pos = marker_before
        self.fabric._on_undo(self, pid)

    def free_count(self) -> int:
        """Pages this view can still allocate right now."""
        if self._adopted:
            return self.pool.free_count()
        return int(sum(min(len(self.pool.free[d]),
                           max(0, self._headroom(d)))
                       for d in range(len(self.pool.domains))))

    # -- page-table lifetime (refcounts ride the view ledger) ------------------

    def _hold(self, pid: int) -> None:
        self._held[pid] = self._held.get(pid, 0) + 1

    def _drop(self, pid: int) -> None:
        n = self._held.get(pid, 0) - 1
        if n > 0:
            self._held[pid] = n
            return
        self._held.pop(pid, None)
        if self.fabric.owner.get(pid) == self.name \
                and self.table.ref.get(pid, 0) > 1:
            # our last hold leaves, others still read it: ownership (and
            # the quota charge) moves to a surviving holder
            self.fabric._reassign_owner(pid, exclude=self.name)

    def _on_remap(self, old: int, new: int) -> None:
        """A mover (swap/migrate) relocated bytes this view holds."""
        n = self._held.pop(old, 0)
        if n:
            self._held[new] = self._held.get(new, 0) + n

    def append_page(self, pages: list) -> int:
        pid = self.table.append_page(pages, alloc=self._alloc_physical)
        self.fabric._on_alloc(self, pid)
        return pid

    def grow(self, pages: list, n: int) -> None:
        for _ in range(n):
            self.append_page(pages)

    def pop_page(self, pages: list) -> int:
        pid = self.table.pop_page(pages)
        self._drop(pid)
        return pid

    def release(self, pages: Sequence[int]) -> None:
        for pid in pages:
            self._drop(pid)
        for pid in self.table.release(pages):
            self.fabric._on_free(pid)

    def drop_parked_ref(self, pid: int) -> None:
        """Discard a dead sequence's reference to a *parked* page: the
        reserved slot keeps its identity (it is not on the free lists, so
        a normal release would corrupt the allocator) — only the table
        reference and this view's hold go away."""
        self._drop(pid)
        n = self.table.ref[pid] - 1
        if n:
            self.table.ref[pid] = n
        else:
            del self.table.ref[pid]
            self.table._unregister(pid)

    def shared(self, pid: int) -> bool:
        return self.table.shared(pid)

    def exclusive(self, pages: Sequence[int]) -> list[int]:
        return self.table.exclusive(pages)

    def fork_for_write(self, pages: list, idx: int) -> int:
        old = pages[idx]
        new = self.table.fork_for_write(pages, idx,
                                        alloc=self._alloc_physical)
        if new != old:
            self.fabric._on_alloc(self, new)
            self._drop(old)
        return new

    def ensure_writable(self, pages: list, lo_tok: int,
                        hi_tok: int) -> None:
        ps = self.page_size
        for idx in range(lo_tok // ps, -(-hi_tok // ps)):
            self.fork_for_write(pages, idx)

    def fork_sequence(self, pages: Sequence[int]) -> list[int]:
        """Geometry-aware whole-sequence fork (DESIGN.md §12).

        Shareable geometries fork lazily: every page's refcount bumps and
        later writes go through the normal ``fork_for_write`` CoW path.
        Non-shareable constant state (SSM) forks eagerly — recurrent
        state is mutated in place every step, so a CoW chain would alias
        live state; the clone gets fresh pages with the state bytes
        copied now through the migration executor."""
        if self.geometry.shareable:
            out = list(pages)
            for pid in out:
                self.table.ref[pid] += 1
                self._hold(pid)
            return out
        out: list[int] = []
        for pid in pages:
            self.append_page(out)
        if out:
            self.execute_copy(list(pages), out)
        return out

    # -- prefix sharing ---------------------------------------------------------

    def _may_match(self, pid: int) -> bool:
        owner = self.fabric.owner.get(pid)
        if owner is None or owner == self.name:
            return True
        other = self.fabric.views.get(owner)
        return (self.share_prefix and other is not None
                and other.share_prefix)

    def probe_prefix(self, tokens: Sequence[int], pages: list, *,
                     count: bool = True) -> int:
        """Trie probe scoped to this view: matches pages of its own tenant
        plus — when both sides opted in — the cross-tenant prefix tier.
        Matched pages join the view's holds; cross-tenant hits emit
        ``share`` events."""
        before = len(pages)
        n = self.table.match_prefix(tokens, pages, count=count,
                                    allow=self._may_match)
        for pid in pages[before:]:
            self._hold(pid)
            owner = self.fabric.owner.get(pid)
            if owner is not None and owner != self.name:
                self.fabric.emit("share", kind="prefix", page=pid,
                                 owner=owner, view=self.name)
        return n

    def peek_prefix(self, tokens: Sequence[int]) -> int:
        """Side-effect-free probe: tokens the trie would cover for this
        view right now (trie-aware admission reads this at submit time)."""
        return self.table.peek_prefix(tokens, allow=self._may_match)

    def register_prefix(self, tokens: Sequence[int], pages: Sequence[int],
                        upto_tokens: int) -> int:
        return self.table.register_prefix(tokens, pages, upto_tokens)

    # -- swap reservations / loans ----------------------------------------------

    def free_domain_count(self, d: int) -> int:
        """Pages this view could still take from domain ``d``."""
        n = len(self.pool.free[d])
        return n if self._adopted else min(n, max(0, self._headroom(d)))

    def reserve(self, domain: int, n: int) -> list[int]:
        """Take ``n`` parking slots out of ``domain`` for this view's swap
        manager; the fabric ledgers them against the view's quota and the
        pool's allocator (and capacity-aware policies) never see them as
        allocatable."""
        assert self._adopted or self._headroom(domain) >= n, \
            f"view {self.name!r} quota cannot cover {n} reserved slots"
        ids = self.pool.reserve_pages(domain, n)
        self.reserved[domain] += n
        self._refresh_tuner_capacity()
        return ids

    def unreserve(self, pid: int) -> None:
        """Return one reserved slot to the shared allocator."""
        dom = self.pool.domain_of(pid)
        self.pool.unreserve_page(pid)
        assert self.reserved[dom] > 0
        self.reserved[dom] -= 1
        self._refresh_tuner_capacity()

    def _refresh_tuner_capacity(self) -> None:
        if self._adopted or self._cotuned \
                or not hasattr(self.tuner, "set_capacity_fractions"):
            return
        caps = (self.quota - self.reserved).astype(np.float64)
        allocatable = float(caps.sum())
        if allocatable <= 0:
            return
        frac = np.where(self.reserved > 0, caps / allocatable, np.inf)
        self.tuner.set_capacity_fractions(frac)

    def offer_slots(self, provider) -> None:
        self.fabric.offer_slots(self, provider)

    def withdraw_slots(self) -> None:
        self.fabric.withdraw_slots(self)

    def settle_loans(self) -> None:
        self.fabric.settle_loans(self)

    def borrowable(self) -> int:
        return self.fabric.borrowable(self)

    def request_loan(self, n: int) -> int:
        return self.fabric.request_loan(self, n)

    def recallable(self) -> int:
        return self.fabric.recallable(self)

    def recall_loans(self, need: int) -> tuple[int, float]:
        return self.fabric.recall_loans(self, need)

    # -- movement ----------------------------------------------------------------

    @property
    def weights(self) -> np.ndarray:
        if self._adopted:
            return self.pool.weights
        return self._policy.weights(self._ctx(float(self.dwp)))

    def _ctx(self, dwp: float) -> placement_policy.PlacementContext:
        pool = self.pool
        return placement_policy.PlacementContext(
            bandwidths=np.asarray([d.read_bw for d in pool.domains]),
            num_pages=int(self.quota.sum()),
            workers=self.home,
            dwp=dwp,
            capacities=(self.quota - self.reserved).astype(np.float64))

    def migrate(self, pages: list[int]) -> list[int]:
        """Re-place a sequence's pages per this view's current weights
        (§III-B2 incremental migration): shared pages are pinned, copies
        batch through the executor, table references and view holds follow
        the bytes, and (non-adopted) destination choice respects the
        view's quota headroom."""
        pool = self.pool
        if self._adopted:
            new_ids = pool.migrate_sequence(pages, table=self.table)
        else:
            target = interleave.weighted_interleave(len(pages), self.weights)
            new_ids, src, dst = [], [], []
            for pid, dom in zip(pages, target):
                dom = int(dom)
                cur = pool.domain_of(pid)
                if self.table.shared(pid) or cur == dom \
                        or not pool.free[dom] or self._headroom(dom) <= 0:
                    new_ids.append(int(pid))
                    continue
                nid = pool.free[dom].pop()
                src.append(int(pid))
                dst.append(nid)
                new_ids.append(nid)
            if src:
                pool.executor.execute(
                    (pool.k_pool, pool.v_pool), src, dst,
                    src_domains=[pool.domain_of(p) for p in src],
                    dst_domains=[pool.domain_of(p) for p in dst])
                for s, d in zip(src, dst):
                    if s in self.table.ref:
                        self.table.remap_physical(s, d)
                    pool.free[pool.domain_of(s)].append(s)
        for old, new in zip(pages, new_ids):
            if old != new:
                self._ledger_remap(old, new)
                self.fabric.emit("migrate", view=self.name, src=old,
                                 dst=new)
        return new_ids

    def _ledger_remap(self, old: int, new: int) -> None:
        """Ownership + holds follow a moved page (same view, new id)."""
        fab = self.fabric
        name = fab.owner.pop(old, None)
        if name is not None and name in fab.views:
            v = fab.views[name]
            v.used[self.pool.domain_of(old)] -= 1
            v.used[self.pool.domain_of(new)] += 1
            fab.owner[new] = name
        for v in fab.views.values():
            v._on_remap(old, new)

    # -- heat-driven re-homing (DESIGN.md §11) ---------------------------------

    def rehome_candidates(self, heat, *, min_heat: float = 1e-6
                          ) -> list[tuple[int, float, float]]:
        """Hot shared pages worth pulling into this view's fast domains.

        ``migrate`` pins shared pages (moving one holder's copy would
        strand the others), so a hot prefix allocated while the fast
        domains were full stays in a slow domain forever — the exact
        pages whose Eq.-1 read cost every sharer pays every step.
        Re-homing lifts them with an *all-holders* remap instead.

        Candidates are live pages owned by this view with refcount>1,
        resident outside the home (fast) set, with resolved ``heat``
        above ``min_heat``. Returns ``(pid, heat, heat * save_s)`` sorted
        by expected near-future saving (descending): heat is a decayed
        read count, so it is the natural estimate of how many more times
        the page will be read; ``save_s`` is the per-read Eq.-1 saving of
        serving it from the fastest home domain instead."""
        pool = self.pool
        fast = set(self.home)
        bw = self.fabric.bw_effective
        pb = float(self.page_bytes)
        best = max(fast, key=lambda d: bw[d])
        out = []
        for pid in self.table.ref:
            if self.fabric.owner.get(pid) != self.name:
                continue                     # parked, persisted, or foreign
            if not self.table.shared(pid):
                continue
            src = pool.domain_of(pid)
            if src in fast:
                continue
            save = (pb / (bw[src] * 1e9)) - (pb / (bw[best] * 1e9))
            if save <= 0:
                continue
            h = float(heat.value(pid))
            if h <= min_heat:
                continue
            out.append((pid, h, h * save))
        out.sort(key=lambda t: (-t[2], t[0]))
        return out

    def rehome_hot(self, heat, *, budget_s: float,
                   max_pages: int | None = None
                   ) -> tuple[dict[int, int], float]:
        """Migrate the most profitable ``rehome_candidates`` into home
        domains under an Eq.-1 move budget.

        Selection walks candidates best-first, pricing the growing batch
        with :func:`bwmodel.move_cost` (reads overlap across source
        domains; every byte funnels into the destination). A candidate is
        taken only if (a) the batch still fits ``budget_s`` and (b) its
        *marginal* cost is covered by its expected saving ``heat *
        save_s`` — so migration never exceeds the stall it saves.

        The move itself is one batched executor copy followed by the
        all-holders bookkeeping: ``table.remap_physical`` carries the
        refcount and trie node, ``_ledger_remap`` carries ownership and
        every view's holds, the vacated slow pages return to the shared
        allocator, and every view's ``on_page_remap`` subscribers receive
        the ``{old: new}`` map so schedulers can patch sequence page
        lists. Emits one ``migrate`` event per page. Returns ``(moves,
        seconds)``."""
        pool = self.pool
        bw = self.fabric.bw_effective
        pb = float(self.page_bytes)
        nd = len(pool.domains)
        fast_order = sorted(self.home, key=lambda d: -bw[d])
        moves: dict[int, int] = {}
        bytes_by_src = np.zeros(nd)
        cost = 0.0
        for pid, h, _rank in self.rehome_candidates(heat):
            if max_pages is not None and len(moves) >= max_pages:
                break
            dst_dom = next(
                (d for d in fast_order
                 if pool.free[d]
                 and (self._adopted or self._headroom(d) > 0)), None)
            if dst_dom is None:
                break                        # fast domains full: try later
            trial = bytes_by_src.copy()
            trial[pool.domain_of(pid)] += pb
            new_cost = bwmodel.move_cost(trial, bw, dst_dom)
            if new_cost > budget_s:
                break
            marginal = new_cost - cost
            save = (pb / (bw[pool.domain_of(pid)] * 1e9)
                    - pb / (bw[dst_dom] * 1e9))
            if h * save < marginal:
                continue                     # not worth the transfer
            moves[pid] = pool.free[dst_dom].pop()
            bytes_by_src = trial
            cost = new_cost
        if not moves:
            return {}, 0.0
        src = list(moves)
        dst = [moves[s] for s in src]
        self.execute_copy(src, dst)
        for s, d in zip(src, dst):
            self.table.remap_physical(s, d)
            self._ledger_remap(s, d)
            pool.free[pool.domain_of(s)].append(s)
            self.fabric.emit("migrate", view=self.name, src=s, dst=d)
        for v in self.fabric.views.values():
            for cb in v._page_remap_cbs:
                cb(dict(moves))
        return moves, cost

    def on_page_remap(self, cb: Callable) -> None:
        """Subscribe to all-holders re-homing: ``cb(moves)`` receives the
        ``{old_pid: new_pid}`` map after physical ids change under live
        sequences, so holders can patch their page lists."""
        self._page_remap_cbs.append(cb)

    def execute_copy(self, src: list[int], dst: list[int]) -> None:
        """Batched physical copy through the migration executor (swap
        transfers); ledger updates are the caller's via the park/unpark
        primitives."""
        pool = self.pool
        pool.executor.execute(
            (pool.k_pool, pool.v_pool), src, dst,
            src_domains=[pool.domain_of(p) for p in src],
            dst_domains=[pool.domain_of(p) for p in dst])

    def park_pages(self, movable: list[int], dst: list[int]) -> None:
        """Swap-out data move: copy live pages into reserved slots (one
        batched gather/scatter), drop their trie entries (a parked page
        must not be matched — its id changes again on swap-in), carry table
        refs and view holds onto the slots, end the live allocations, and
        return the vacated source pages to the shared allocator."""
        self.execute_copy(movable, dst)
        for s, d in zip(movable, dst):
            if s in self.table.ref:
                self.table.unregister(s)
                self.table.remap_physical(s, d)
            self.fabric._on_free(s)
            for v in self.fabric.views.values():
                v._on_remap(s, d)
        self.pool.free_pages(movable)

    def unpark_pages(self, parked: list[int]) -> list[int]:
        """Swap-in data move: allocate live destinations under this view's
        placement policy, copy the parked bytes over, and carry refs/holds/
        ownership onto the live pages. Returns the new ids (slot ids are
        the caller's to return to its reservation)."""
        dst = [self._alloc_physical() for _ in parked]
        self.execute_copy(parked, dst)
        for s, d in zip(parked, dst):
            if s in self.table.ref:
                self.table.remap_physical(s, d)
            self.fabric._own(self, d)
            for v in self.fabric.views.values():
                v._on_remap(s, d)
        return dst

    def repark_pages(self, src: list[int], dst: list[int]) -> None:
        """Loan-reclaim data move: parked bytes relocate between reserved
        slots (no live allocation on either side)."""
        self.execute_copy(src, dst)
        for s, d in zip(src, dst):
            if s in self.table.ref:
                self.table.remap_physical(s, d)
            for v in self.fabric.views.values():
                v._on_remap(s, d)

    # -- cost model ---------------------------------------------------------------

    def footprint(self, pages: Sequence[int]) -> np.ndarray:
        """Per-domain resident bytes of a page set (Eq.-1 input). Pages
        demoted to the persistent tier (negative handle ids) are not in any
        domain — ``tier_bytes`` accounts them."""
        out = np.zeros(len(self.pool.domains))
        pb = self.page_bytes
        for pid in pages:
            if pid >= 0:
                out[self.pool.domain_of(pid)] += pb
        return out

    def tier_bytes(self, pages: Sequence[int]) -> float:
        """Bytes of this page set resident in the persistent tier."""
        return float(self.page_bytes) * sum(1 for p in pages if p < 0)

    def stall_cost(self, pages: Sequence[int]) -> float:
        """Eq.-1 max-parallel-transfer read time of a page set under the
        *effective* (calibrated) bandwidths; demoted pages contribute the
        tier's bandwidth row."""
        tb = self.tier_bytes(pages)
        tier = self.fabric.persist
        return bwmodel.stall_cost(
            self.footprint(pages), self.fabric.bw_effective,
            tier_bytes=tb if tier is not None else 0.0,
            tier_bw_gbps=tier.bw_gbps if tier is not None else None)

    def stall_seconds(self, bytes_per_domain: np.ndarray) -> float:
        return bwmodel.stall_cost(bytes_per_domain,
                                  self.fabric.bw_effective)

    def expected_read_time(self, pages: Sequence[int]) -> float:
        """``stall_cost`` + per-domain stall telemetry (the engine's
        per-step latency signal)."""
        per_domain = self.footprint(pages)
        times = per_domain / (self.fabric.bw_effective * 1e9)
        for d, t in enumerate(times):
            self.telemetry.record_stall(d, float(t))
        return bwmodel.stall_cost(per_domain, self.fabric.bw_effective)

    # -- tuning --------------------------------------------------------------------

    @property
    def dwp(self) -> float:
        t = self.pool.tuner if self._adopted else self.tuner
        return float(t.dwp)

    def record_latency(self, seconds: float) -> bool:
        """Per-step latency sample: logs it, drives the view's own DWP
        tuner (co-tuned views are driven by the arbiter through
        ``drive_cotuner`` instead), returns True when the allocation cycle
        moved (callers then re-home live sequences)."""
        self.fabric.emit("latency", view=self.name, seconds=seconds)
        if self._adopted:
            return self.pool.record_latency(seconds)
        self.telemetry.record_latency(seconds)
        if self._cotuned:
            return False
        before = self.tuner.assignment.copy()
        self.tuner.record(seconds)
        return not np.array_equal(before, self.tuner.assignment)

    def drive_cotuner(self, stall_a: float, stall_b: float) -> bool:
        """Arbiter entry point for best-effort tenants: feed the two-stage
        co-scheduled search; on an allocation-cycle move, fire the view's
        assignment-change subscribers (the scheduler re-homes live
        sequences) and return True."""
        assert self._cotuned, "view has no co-scheduled tuner"
        before = self.tuner.assignment.copy()
        self.tuner.record(stall_a, stall_b)
        changed = not np.array_equal(before, self.tuner.assignment)
        if changed:
            for cb in self._assignment_cbs:
                cb()
        return changed

    def on_assignment_change(self, cb: Callable) -> None:
        self._assignment_cbs.append(cb)

    # -- data plane ------------------------------------------------------------------

    # read-only: the pool tensors are written in place, so every holder of
    # ``view.k_pool`` sees each write; no caller rebinds them
    @property
    def k_pool(self):
        return self.pool.k_pool

    @property
    def v_pool(self):
        return self.pool.v_pool

    def write_token(self, layer_slot_kv: tuple, page_id: int, slot: int):
        self.pool.write_token(layer_slot_kv, page_id, slot)

    def write_decode_batch(self, layer: int, page_ids, slots, k, v):
        self.pool.write_decode_batch(layer, page_ids, slots, k, v)

    # -- reporting --------------------------------------------------------------------

    def occupancy(self) -> dict[str, float]:
        if self._adopted:
            return self.pool.occupancy()
        out = {}
        for i, d in enumerate(self.pool.domains):
            cap = int(self.quota[i] - self.reserved[i])
            out[d.name] = int(self.used[i]) / max(cap, 1)
        return out

    def used_pages(self) -> np.ndarray:
        return self.pool.used_pages() if self._adopted \
            else self.used.copy()

    def attach_slo(self):
        return self.telemetry.attach_slo()

    def snapshot(self) -> dict:
        """Engine-facing telemetry: domain counters + page-table sharing
        state + loan ledger, one dict (replaces the old
        ``telemetry.attach_pagetable`` back-channel). Cross-tenant
        sharing counts live in ``fabric.stats()`` — computing them is an
        O(live pages) scan that does not belong on the per-step path."""
        tel = self.telemetry.snapshot()
        tel["pagetable"] = self.table.stats()
        tel["fabric"] = {
            "view": self.name,
            "loans": [ln.as_dict() for ln in self.fabric.loans],
        }
        return tel


def as_view(pool_or_view) -> FabricView:
    """Normalize the serve/scheduler entry points: a FabricView passes
    through; a bare BwapPagePool is adopted into a cached single-view
    fabric (placement bit-identical to driving the pool directly)."""
    if isinstance(pool_or_view, FabricView):
        return pool_or_view
    view = getattr(pool_or_view, "_fabric_view", None)
    if view is None:
        view = MemoryFabric.adopt(pool_or_view).views["default"]
        pool_or_view._fabric_view = view
    return view
