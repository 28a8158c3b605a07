"""BWAP-paged KV cache: weighted page placement across memory domains.

The paper's mechanism, applied to serving: decode-time KV pages live in a
pool that spans memory *domains* of asymmetric bandwidth (local HBM, pod-peer
HBM over ICI, cross-pod HBM over DCI, host DRAM — topology.tpu_domains_topology).
Placement of new pages follows a policy from the placement registry
(default ``bwap_dwp``: Eq. 2/5 canonical weights scaled by the DWP tuner's
online proximity estimate); migrations between domains execute as batched
gather/scatter through placement.executor, exactly like mbind page migration
but one gather and one scatter per batch instead of one copy per page.

Physically the pool is one tensor [total_pages, page_size, nkv, hd] per
layer, on the pool's device and written in place;
domain d owns the contiguous page-id range [offset_d, offset_d + n_d), so the
paged_attention kernel (kernels/paged_attention) is domain-oblivious and the
page table *is* the placement. Per-domain counters and stall samples are
collected in placement.telemetry (DESIGN.md §3.4).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import bwmodel, interleave
from repro_torch.core.dwp import DWPConfig, DWPTuner
from repro_torch.device import dtype_of, resolve
from repro_torch.models.config import ModelConfig
from repro_torch.placement import policy as placement_policy
from repro_torch.placement.executor import MigrationExecutor
from repro_torch.placement.geometry import PageGeometry, geometry_for
from repro_torch.placement.pagetable import PageTable
from repro_torch.placement.telemetry import DomainTelemetry


@dataclasses.dataclass(frozen=True)
class MemoryDomain:
    name: str
    num_pages: int
    read_bw: float       # GB/s toward the worker chips
    is_worker: bool      # counts as "worker node" for DWP


def default_domains(total_pages: int) -> list[MemoryDomain]:
    """A 2-pod serving deployment's domain mix (DESIGN.md §2 table)."""
    from repro_torch.core import topology as topo
    n = total_pages
    return [
        MemoryDomain("hbm_local", int(n * 0.35), topo.V5E_HBM_BW, True),
        MemoryDomain("hbm_peer_1hop", int(n * 0.25), topo.V5E_ICI_BW, False),
        MemoryDomain("hbm_peer_2hop", int(n * 0.20), topo.V5E_ICI_BW / 2,
                     False),
        MemoryDomain("hbm_pod1", int(n * 0.10), topo.V5E_DCI_BW, False),
        MemoryDomain("host_dram", n - int(n * 0.35) - int(n * 0.25)
                     - int(n * 0.20) - int(n * 0.10), topo.V5E_PCIE_BW,
                     False),
    ]


class BwapPagePool:
    """Paged KV storage with policy-driven placement. One pool per model
    (layers stacked on axis 0 so a layer's pool is pool[l]).

    ``tuner`` may be supplied externally (the domain arbiter passes a
    CoScheduledTuner for best-effort tenants); anything with ``.assignment``
    and ``.dwp`` works. When external, ``record_latency`` does not feed it —
    the owner (arbiter) drives it with the right stall streams.
    """

    def __init__(self, cfg: ModelConfig, domains: Sequence[MemoryDomain],
                 page_size: int = 16, dwp_config: DWPConfig | None = None,
                 seed: int = 0, policy: str = "bwap_dwp",
                 tuner=None, telemetry: DomainTelemetry | None = None,
                 geometry: PageGeometry | None = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        self.domains = list(domains)
        self.page_size = page_size
        self.policy = placement_policy.resolve(policy)
        self.total_pages = sum(d.num_pages for d in self.domains)
        self.offsets = np.cumsum([0] + [d.num_pages for d in self.domains])
        # what one page *is* for this model group (DESIGN.md §12); the
        # default resolved from cfg reproduces the historical dense
        # [nl, pages, page_size, nkv, hd] layout bit-for-bit
        self.geometry = geometry if geometry is not None \
            else geometry_for(cfg, page_size)
        # the growth unit is the geometry's (identical for the default
        # paged layout; constant-footprint geometries pin their own)
        self.page_size = self.geometry.page_size
        cdt = dtype_of(cfg.compute_dtype)
        k_shape, v_shape = self.geometry.array_shapes(self.total_pages)
        self.k_pool = torch.zeros(k_shape, dtype=cdt, device=self.device)
        self.v_pool = torch.zeros(v_shape, dtype=cdt, device=self.device)
        self.free: list[list[int]] = [
            list(range(self.offsets[i], self.offsets[i + 1]))
            for i in range(len(self.domains))]
        # swap-slot reservations per domain (reserve_pages): off the free
        # lists AND off the capacities any placement decision sees
        self.reserved = np.zeros(len(self.domains), dtype=np.int64)

        self.bw = np.asarray([d.read_bw for d in self.domains])
        # bandwidth-descending fallback order for exhausted allocation cycles
        # (computed once; alloc_page is on the decode hot path)
        self._bw_order = [int(i) for i in np.argsort(-self.bw, kind="stable")]
        self.workers = tuple(i for i, d in enumerate(self.domains)
                             if d.is_worker)
        # canonical weights over domains (Eq. 2: single worker group)
        self.canonical = placement_policy.weights(
            "bwap_canonical", self._ctx(0.0))
        self.telemetry = telemetry or DomainTelemetry(
            [d.name for d in self.domains])
        self.executor = MigrationExecutor(telemetry=self.telemetry)
        # logical→physical indirection: refcounts, prefix trie, CoW forks.
        # The pool stays the *physical* allocator; the serving stack (engine,
        # scheduler, swap) goes through the fabric view for page lifetime.
        self.table = PageTable(self)
        self._external_tuner = tuner is not None
        self.tuner = tuner if tuner is not None else DWPTuner(
            self.canonical, list(self.workers),
            num_pages=4096,  # allocation-cycle resolution
            config=dwp_config or DWPConfig(n=8, c=2),
            on_migrate=self._on_tuner_plan)
        self._cycle_pos = 0
        # Alg. 1 lays sub-ranges out contiguously (uniform region first); an
        # allocation cycle must be stationary, so walk it in a fixed shuffle
        # (sized to the tuner's actual cycle — external tuners may differ
        # from the internal 4096-slot resolution).
        self._perm = np.random.default_rng(seed).permutation(
            len(self.tuner.assignment))

    # -- placement ----------------------------------------------------------

    def _ctx(self, dwp: float) -> placement_policy.PlacementContext:
        # effective capacities: swap reservations are parking space, not
        # allocatable pages — policies must not count them
        return placement_policy.PlacementContext(
            bandwidths=np.asarray([d.read_bw for d in self.domains]),
            num_pages=self.total_pages,
            workers=tuple(i for i, d in enumerate(self.domains)
                          if d.is_worker),
            dwp=dwp,
            capacities=np.asarray([d.num_pages for d in self.domains])
            - self.reserved)

    @property
    def weights(self) -> np.ndarray:
        return self.policy.weights(self._ctx(float(self.tuner.dwp)))

    def _on_tuner_plan(self, plan: interleave.MigrationPlan) -> None:
        self.telemetry.record_plan(plan.num_moves)

    def domain_of(self, page_id: int) -> int:
        return int(np.searchsorted(self.offsets, page_id, side="right") - 1)

    def alloc_page(self) -> int:
        """Next page id, following the weighted allocation cycle (Alg. 1
        pattern over the tuner's current assignment); falls back to the
        closest domain with free pages (precomputed bandwidth order)."""
        cycle = self.tuner.assignment
        for _ in range(len(cycle)):
            want = int(cycle[self._perm[self._cycle_pos % len(self._perm)]])
            self._cycle_pos += 1
            if self.free[want]:
                self.telemetry.record_alloc(want)
                return self.free[want].pop()
        for i in self._bw_order:
            if self.free[i]:
                self.telemetry.record_alloc(i)
                return self.free[i].pop()
        raise RuntimeError("KV pool exhausted")

    def free_pages(self, pages: Sequence[int]):
        for pid in pages:
            dom = self.domain_of(pid)
            self.free[dom].append(int(pid))
            self.telemetry.record_free(dom)

    # -- speculative allocation rollback --------------------------------------

    def alloc_marker(self) -> int:
        """Opaque allocation-cycle position; bracket a speculative
        ``alloc_page`` with markers to make it undoable (``undo_alloc``)."""
        return self._cycle_pos

    def return_speculative(self, pid: int) -> None:
        """Free-list LIFO return + alloc-count revert — the cycle-agnostic
        half of a speculative rollback, shared by the pool's own
        ``undo_alloc`` and fabric views' per-view cycle rollback."""
        dom = self.domain_of(pid)
        self.free[dom].append(int(pid))
        self.telemetry.record_alloc(dom, -1)

    def undo_alloc(self, pid: int, marker_before: int,
                   marker_after: int) -> None:
        """Return a speculatively-allocated page as if the allocation never
        happened: the page goes back on *top* of its free list (LIFO — the
        next alloc re-issues the same id), and when no allocation happened
        since (``marker_after`` is still current) the weighted allocation
        cycle rewinds too, so future placement matches a run that never
        allocated. The telemetry alloc count reverts rather than logging a
        free — rejected speculation is not page churn."""
        self.return_speculative(pid)
        if self._cycle_pos == marker_after:
            self._cycle_pos = marker_before

    def reserve_pages(self, domain: int, n: int) -> list[int]:
        """Take ``n`` free pages out of ``domain``'s free list without
        counting them as allocations: the scheduler's swap manager holds
        them as parking slots for preempted KV state, so ``alloc_page``
        never hands them to live sequences. The reservation also leaves the
        domain's *capacity* as the DWP tuner sees it (swap-aware DWP)."""
        if n > len(self.free[domain]):
            raise RuntimeError(
                f"cannot reserve {n} pages in domain "
                f"{self.domains[domain].name!r}: {len(self.free[domain])} "
                "free")
        taken = [self.free[domain].pop() for _ in range(n)]
        self.reserved[domain] += n
        self._refresh_tuner_capacity()
        return taken

    def unreserve_page(self, pid: int) -> None:
        """Return one reserved slot to the allocator (inverse of a single
        page of ``reserve_pages``): the page rejoins its domain's free list
        and the reservation ledger and tuner capacity follow. Reservations
        only ever change through ``reserve_pages``/``unreserve_page`` — the
        old bulk ``set_reserved_counts`` resync back-channel is gone."""
        dom = self.domain_of(pid)
        self.free[dom].append(int(pid))
        assert self.reserved[dom] > 0, "unreserve without a reservation"
        self.reserved[dom] -= 1
        self._refresh_tuner_capacity()

    def _refresh_tuner_capacity(self) -> None:
        """Feed the tuner the *effective* (unreserved) capacities so its
        allocation cycle never promises a reserved-away page. Domains with
        no reservation stay uncapped (np.inf) — canonical over-weighting of
        a small fast domain is a policy choice the fallback order absorbs;
        promising pages a reservation holds is simply wrong."""
        if self._external_tuner or not hasattr(self.tuner,
                                               "set_capacity_fractions"):
            return
        caps = np.asarray([d.num_pages for d in self.domains],
                          dtype=np.float64) - self.reserved
        allocatable = float(caps.sum())
        if allocatable <= 0:
            return
        frac = np.where(self.reserved > 0, caps / allocatable, np.inf)
        self.tuner.set_capacity_fractions(frac)

    def free_count(self) -> int:
        """Pages currently allocatable (reserved swap slots excluded —
        they are not on the free lists)."""
        return sum(len(f) for f in self.free)

    @property
    def slow_domains(self) -> tuple[int, ...]:
        """Non-worker domains — where preempted KV state parks."""
        return tuple(i for i, d in enumerate(self.domains)
                     if not d.is_worker)

    def bytes_per_domain(self, page_ids: Sequence[int]) -> np.ndarray:
        """Per-domain resident bytes of a page set (Eq.-1 input)."""
        out = np.zeros(len(self.domains))
        for pid in page_ids:
            out[self.domain_of(pid)] += self.page_bytes
        return out

    # -- data path ------------------------------------------------------------

    def write_token(self, layer_slot_kv: tuple, page_id: int, slot: int):
        """Write one token's K/V across all layers, in place:
        layer_slot_kv = (k [L,nkv,hd], v [L,nkv,hd])."""
        k, v = layer_slot_kv
        self.k_pool[:, page_id, slot] = k
        self.v_pool[:, page_id, slot] = v

    def write_decode_batch(self, layer: int, page_ids, slots, k, v):
        """Scatter a whole decode batch's K/V for one layer in one op, in
        place: page_ids/slots [B] (int64 tensors on the pool's device),
        k/v [B, nkv, hd]."""
        self.k_pool[layer, page_ids, slots] = k
        self.v_pool[layer, page_ids, slots] = v

    # -- DWP tuning / migration -------------------------------------------------

    def record_latency(self, seconds: float) -> bool:
        """Feed a decode-step latency sample; returns True when the tuner
        moved the allocation cycle (callers then migrate live sequences).
        Externally-tuned pools (arbiter tenants) only log the sample — the
        arbiter feeds the co-scheduled tuner with the right stall streams."""
        self.telemetry.record_latency(seconds)
        if self._external_tuner:
            return False
        before = self.tuner.assignment.copy()
        self.tuner.record(seconds)
        return not np.array_equal(before, self.tuner.assignment)

    def migrate_sequence(self, page_ids: list[int],
                         table: PageTable | None = None) -> list[int]:
        """Re-place an existing sequence's pages per the current weights
        (the incremental migration of §III-B2): returns new page ids.
        All physical copies happen in one batched gather/scatter.

        Shared pages (refcount > 1 under ``table``, defaulting to this
        pool's own table) are *pinned* — the caller speaks for only one of
        their holders — and moved table-tracked pages are remapped so
        refcounts and trie nodes follow. Pages the table never saw (raw
        callers that allocate via ``alloc_page`` directly) move with no
        bookkeeping, as before."""
        tbl = table if table is not None else self.table
        target = interleave.weighted_interleave(len(page_ids), self.weights)
        new_ids: list[int] = []
        src: list[int] = []
        dst: list[int] = []
        for pid, dom in zip(page_ids, target):
            cur = self.domain_of(pid)
            if tbl.shared(pid) or cur == int(dom) or not self.free[int(dom)]:
                new_ids.append(int(pid))
                continue
            nid = self.free[int(dom)].pop()
            src.append(int(pid))
            dst.append(nid)
            new_ids.append(nid)
        if src:
            self.executor.execute(
                (self.k_pool, self.v_pool), src, dst,
                src_domains=[self.domain_of(p) for p in src],
                dst_domains=[self.domain_of(p) for p in dst])
            for s, d in zip(src, dst):
                if s in tbl.ref:
                    tbl.remap_physical(s, d)
                self.free[self.domain_of(s)].append(s)  # after batched copy
        return new_ids

    # -- capacity (arbiter rebalancing) ---------------------------------------

    def live_pages(self) -> list[list[int]]:
        """Allocated page ids per domain, ascending."""
        out = []
        for i in range(len(self.domains)):
            free = set(self.free[i])
            out.append([p for p in range(self.offsets[i], self.offsets[i + 1])
                        if p not in free])
        return out

    def rebalance(self, new_sizes: Sequence[int]) -> np.ndarray:
        """Resize per-domain capacity (tenant join/leave): rebuilds the pool
        arrays at the new sizes, carrying live pages over in one batched
        copy. Live pages that no longer fit their domain spill to the
        fastest domain with room. Returns ``id_map`` (old page id -> new page
        id, -1 for pages that were free) so engines can remap page tables."""
        new_sizes = [int(n) for n in new_sizes]
        assert len(new_sizes) == len(self.domains)
        live = self.live_pages()
        new_offsets = np.cumsum([0] + new_sizes)
        placed: list[list[int]] = [[] for _ in self.domains]  # old ids per new domain
        overflow: list[int] = []
        for d, pages in enumerate(live):
            placed[d] = pages[:new_sizes[d]]
            overflow.extend(pages[new_sizes[d]:])
        for pid in overflow:
            for d in self._bw_order:
                if len(placed[d]) < new_sizes[d]:
                    placed[d].append(pid)
                    break
            else:
                raise ValueError("rebalance: live pages exceed new capacity")
        old_ids: list[int] = []
        new_ids: list[int] = []
        for d, pages in enumerate(placed):
            old_ids.extend(pages)
            new_ids.extend(range(int(new_offsets[d]),
                                 int(new_offsets[d]) + len(pages)))
        total = int(new_offsets[-1])
        k_shape, v_shape = self.geometry.array_shapes(total)
        new_k = torch.zeros(k_shape, dtype=self.k_pool.dtype,
                            device=self.device)
        new_v = torch.zeros(v_shape, dtype=self.v_pool.dtype,
                            device=self.device)
        (self.k_pool, self.v_pool), _ = self.executor.copy(
            (self.k_pool, self.v_pool), (new_k, new_v), old_ids, new_ids)
        id_map = np.full(self.total_pages, -1, dtype=np.int64)
        id_map[np.asarray(old_ids, dtype=np.int64)] = new_ids
        self.domains = [dataclasses.replace(d, num_pages=n)
                        for d, n in zip(self.domains, new_sizes)]
        self.total_pages = total
        self.offsets = new_offsets
        taken = [set(range(int(new_offsets[d]),
                           int(new_offsets[d]) + len(placed[d])))
                 for d in range(len(self.domains))]
        self.free = [[p for p in range(int(new_offsets[d]),
                                       int(new_offsets[d + 1]))
                      if p not in taken[d]]
                     for d in range(len(self.domains))]
        self.table.remap(id_map)
        self.telemetry.record_rebalance()
        return id_map

    # -- analytics ---------------------------------------------------------------

    def occupancy(self) -> dict[str, float]:
        """Live-allocated fraction of each domain's *allocatable* capacity.

        Reserved swap slots are parking space, not allocatable pages: they
        belong in neither the numerator (they hold no live sequence) nor the
        denominator. The old ``used / num_pages`` ratio kept reserved slots
        in the denominator, so a fully-allocated domain reported < 1.0 —
        phantom free headroom that made capacity-reading consumers (the DWP
        waterfill among them) over-allocate into a domain that had nothing
        left (regression: tests/test_fabric.py)."""
        out = {}
        for i, d in enumerate(self.domains):
            cap = d.num_pages - int(self.reserved[i])
            used = cap - len(self.free[i])
            out[d.name] = used / max(cap, 1)
        return out

    def used_pages(self) -> np.ndarray:
        """Live-allocated pages per domain (reserved parking slots are not
        live allocations and are excluded, matching ``occupancy``)."""
        return np.asarray([d.num_pages - int(self.reserved[i])
                           - len(self.free[i])
                           for i, d in enumerate(self.domains)])

    @property
    def page_bytes(self) -> int:
        """Bytes of one page across all layers, K+V — from the geometry,
        never from ``2 * page_size * nkv * hd`` (wrong for MLA latent
        caches with asymmetric k/v widths, and for SSM state pages)."""
        return self.geometry.page_bytes

    def expected_read_time(self, page_ids: Sequence[int]) -> float:
        """Analytic per-token KV read time for a sequence (the max-parallel-
        transfer model of Eq. 1, ``core.bwmodel.stall_cost``). Feeds
        per-domain stall samples into telemetry."""
        per_domain = self.bytes_per_domain(page_ids)
        times = per_domain / (self.bw * 1e9)
        for d, t in enumerate(times):
            self.telemetry.record_stall(d, float(t))
        return bwmodel.stall_cost(per_domain, self.bw)
