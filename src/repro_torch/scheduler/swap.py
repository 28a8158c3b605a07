"""KV swap manager: park preempted sequences' pages in slow domains.

The paper's Observation 1 — slow domains are wasted capacity unless placement
uses them — applies twice in serving. Live decode pages spread per BWAP
weights, and *cold* pages (sequences preempted by the scheduler) should not
occupy fast-HBM capacity at all: they park in reserved slots carved out of
the slow domains, freeing fast pages for the running batch. That is what
lets total live KV exceed ``hbm_local`` capacity.

All placement access goes through a :class:`repro.placement.fabric.FabricView`
(DESIGN.md §8): the view hands out reserved slots (``view.reserve``), moves
bytes (``park_pages``/``unpark_pages``), and keeps the fabric's ownership
and refcount ledgers consistent. A swap-out distributes a victim's pages
over the view's slow domains through a policy from the placement registry —
``bwap_canonical`` (weights ∝ slow-domain bandwidth) by default, ``uniform``
/ ``local_first`` as the baselines ``benchmarks/scheduler_bench.py``
compares — and executes the copies as one batched gather/scatter per pool
array. Swap-in allocates destinations through the view's live placement
policy and returns the vacated slots to the reservation.

**Cross-tenant slot loans** (ROADMAP arbiter-level swap): the manager
registers as a slot provider on its view. When a bursty tenant runs out of
reserved slots, ``swap_out`` borrows idle slots from co-tenant reservations
through the fabric's loan broker; when a lender runs short, its shortfall
recalls the loans — borrowers return idle slots instantly and vacate parked
ones by relocating the bytes into their remaining reservation (one batched
copy whose Eq.-1 time is charged to the loan record and to the reclaiming
swap-out).

Transfer cost is the Eq.-1 max-parallel-transfer time of the slower side of
the copy under the fabric's *effective* (calibrated) bandwidths; the engine
folds it into the step latency, which is how swap-placement quality reaches
goodput.
"""

from __future__ import annotations

import numpy as np

from repro_torch.placement import policy as placement_policy
from repro_torch.placement.fabric import as_view


class KVSwapManager:
    """Swap-slot reservation + bandwidth-aware swap placement for one
    fabric view (a bare pool is adopted into a single-view fabric)."""

    def __init__(self, pool, *, placement: str = "bwap_canonical",
                 reserve_fraction: float = 0.5,
                 reserve_pages: dict[str, int] | None = None,
                 lend: bool = True, borrow: bool = True):
        """``reserve_fraction`` of every slow (non-home) domain's currently
        free pages is reserved, unless ``reserve_pages`` gives explicit
        per-domain counts (by domain name; missing names reserve zero).
        ``lend``/``borrow`` opt this tenant in or out of the fabric's
        cross-tenant slot-loan broker."""
        self.view = as_view(pool)
        self.placement = placement_policy.resolve(placement)
        self.slow = list(self.view.slow_domains)
        assert self.slow, "swap needs at least one non-home domain"
        self.lend = lend
        self.borrow = borrow
        self.slots: dict[int, list[int]] = {}
        for d in self.slow:
            if reserve_pages is not None:
                n = int(reserve_pages.get(self.view.domains[d].name, 0))
            else:
                n = int(self.view.free_domain_count(d) * reserve_fraction)
            self.slots[d] = self.view.reserve(d, n)
        self.reserved_total = sum(len(s) for s in self.slots.values())
        self._out: set[int] = set()   # slot ids currently holding parked KV
        self._borrowed: set[int] = set()   # slots on loan from co-tenants
        self._lent: set[int] = set()       # own slots currently loaned out
        self._moved: dict[int, int] = {}   # parked-page forwarding (vacate)
        self._demoted: set[int] = set()    # tier handles (persist demotion)
        self._park_order: dict[int, int] = {}   # slot -> park stamp (cold)
        self._park_stamp = 0
        self.view.offer_slots(self)

    @property
    def persist(self):
        """The fabric's persistent tier, if one is attached — looked up
        live so a tier attached after this manager was built still counts
        as demotion headroom."""
        return self.view.fabric.persist

    # -- capacity ------------------------------------------------------------

    def slots_free(self) -> int:
        return sum(len(s) for s in self.slots.values())

    def can_swap_out(self, num_pages: int) -> bool:
        """Counts slots in hand plus what the loan broker could actually
        deliver — borrowable idle co-tenant slots in *this tenant's* slow
        domains and instantly-recallable slots this tenant has on loan —
        plus slots the persistent tier could vacate by demoting the
        coldest parked pages."""
        avail = self.slots_free()
        if self.borrow:
            avail += self.view.borrowable()
        if self._lent:
            avail += self.view.recallable()
        if self.persist is not None:
            avail += min(len(self._out), self.persist.capacity_left())
        return avail >= num_pages

    def parked_count(self, page_ids) -> int:
        """How many of a view's pages currently sit in reserved slots (the
        ones swap-in must re-allocate; pinned shared pages never parked)."""
        return sum(1 for p in page_ids if self._resolve(p) in self._out)

    def promotable_count(self, page_ids) -> int:
        """Pages swap-in must re-allocate: parked in reserved slots *plus*
        demoted into the persistent tier — admission sizes a swapped
        sequence's resume footprint with this, not ``parked_count``."""
        n = 0
        for p in page_ids:
            q = self._resolve(p)
            n += q in self._out or q in self._demoted
        return n

    def demoted_count(self) -> int:
        return len(self._demoted)

    def _resolve(self, pid: int) -> int:
        """Chase the forwarding chain of a parked page that a loan reclaim
        relocated after its sequence recorded the id."""
        while pid in self._moved:
            pid = self._moved[pid]
        return pid

    def _ensure_slots(self, n: int) -> float:
        """Make ``n`` slots available, borrowing from co-tenants,
        recalling own loans, and finally demoting the coldest parked pages
        into the persistent tier. Returns the Eq.-1 seconds spent vacating
        recalled slots and demoting (charged to this swap-out)."""
        seconds = 0.0
        short = n - self.slots_free()
        if short > 0 and self.borrow:
            short -= self.view.request_loan(short)
        if short > 0 and self._lent:
            _, secs = self.view.recall_loans(short)
            seconds += secs
        short = n - self.slots_free()
        if short > 0 and self.persist is not None:
            _, secs = self.demote_cold(short)
            seconds += secs
        return seconds

    def demote_cold(self, n: int) -> tuple[int, float]:
        """Vacate up to ``n`` reserved slots by demoting the
        longest-parked (coldest) pages into the persistent tier. Eq.-1
        priced through the tier's bandwidth row; the freed slots rejoin
        the reservation and the forwarding map chases slot -> handle, so
        a later ``swap_in`` promotes transparently. Returns
        ``(pages_demoted, seconds)``."""
        tier = self.persist
        if tier is None or not self._out or n <= 0:
            return 0, 0.0
        n = min(n, len(self._out), tier.capacity_left())
        if n <= 0:
            return 0, 0.0
        cold = sorted(self._out,
                      key=lambda p: self._park_order.get(p, 0))[:n]
        handles, seconds = tier.demote(self.view, cold)
        for p, h in zip(cold, handles):
            self._out.discard(p)
            self._park_order.pop(p, None)
            self.slots[self.view.domain_of(p)].append(int(p))
            self._moved[p] = h
            self._demoted.add(h)
        return len(cold), seconds

    # -- loan-broker provider protocol (fabric calls these) --------------------

    def lendable_count(self, domains=None) -> int:
        """Idle own slots the broker may take — optionally restricted to
        ``domains`` (a borrower can only park in its own slow domains, so
        an unfiltered count would over-promise)."""
        if not self.lend:
            return 0
        return sum(1 for d in self.slots
                   if domains is None or d in domains
                   for p in self.slots[d] if p not in self._borrowed)

    def idle_count(self, ids) -> int:
        free = {p for s in self.slots.values() for p in s}
        return sum(1 for p in ids if p in free)

    def lend_slots(self, n: int, domains) -> list[int]:
        """Hand up to ``n`` idle own slots in ``domains`` to the broker."""
        out: list[int] = []
        if not self.lend:
            return out
        for d in self.slots:
            if d not in domains:
                continue
            keep = [p for p in self.slots[d] if p in self._borrowed]
            own = [p for p in self.slots[d] if p not in self._borrowed]
            while own and len(out) < n:
                out.append(own.pop())
            self.slots[d] = keep + own
        self._lent.update(out)
        return out

    def take_slots(self, ids) -> None:
        """Receive slots from the broker: a granted loan, or own slots
        coming back from a reclaim."""
        for p in ids:
            d = self.view.domain_of(p)
            self.slots.setdefault(d, []).append(int(p))
            if p in self._lent:
                self._lent.discard(p)
            else:
                self._borrowed.add(int(p))

    def yield_slots(self, ids) -> tuple[list[int], float]:
        """Give back loaned slots on recall. Idle ones return instantly;
        parked ones vacate by relocating their bytes into this manager's
        remaining slots (one batched copy, Eq.-1 cost). Slots that cannot
        vacate (no room left) stay borrowed."""
        returned: list[int] = []
        ids = set(ids)
        for d in self.slots:
            stay = []
            for p in self.slots[d]:
                if p in ids and len(returned) < len(ids):
                    returned.append(p)
                else:
                    stay.append(p)
            self.slots[d] = stay
        seconds = 0.0
        parked = [p for p in ids if p in self._out]
        if parked:
            src, dst = [], []
            for p in parked:
                home = None
                for d in self.slots:
                    spare = [q for q in self.slots[d]
                             if q not in ids and q not in dst]
                    if spare:
                        home = spare[-1]
                        break
                if home is None:
                    continue            # nowhere to vacate: stays borrowed
                self.slots[self.view.domain_of(home)].remove(home)
                src.append(p)
                dst.append(home)
            if src:
                self.view.repark_pages(src, dst)
                for s, t in zip(src, dst):
                    self._out.discard(s)
                    self._out.add(t)
                    self._moved[s] = t
                    if s in self._park_order:
                        self._park_order[t] = self._park_order.pop(s)
                    returned.append(s)
                seconds = self._transfer_seconds(
                    [self.view.domain_of(s) for s in src],
                    [self.view.domain_of(t) for t in dst])
        for p in returned:
            self._borrowed.discard(p)
        return returned, seconds

    def parked_ids(self):
        return set(self._out)

    # -- teardown --------------------------------------------------------------

    def release_parked(self, page_ids) -> list[int]:
        """A swapped-out sequence died: discard its parked KV in place (no
        copies) — the slots rejoin the reservation, the table references
        drop. Returns the page ids that were *not* parked (live shared
        pages the caller releases normally)."""
        live: list[int] = []
        for p in page_ids:
            q = self._forward(p)         # retire the chain: the slot may
            if q in self._out:           # be re-lent and re-parked later
                self._out.discard(q)
                self._park_order.pop(q, None)
                self.slots[self.view.domain_of(q)].append(int(q))
                self.view.drop_parked_ref(q)
            elif q in self._demoted:     # died cold: drop the tier bytes
                self._demoted.discard(q)
                self.view.drop_parked_ref(q)
                if q not in self.view.table.ref:
                    self.persist.forget(q)
            else:
                live.append(q)
        return live

    def close(self) -> None:
        """Tear down the reservation (tenant leaving): loans settle
        through the fabric (borrowed slots go home, lent slots come back
        or transfer their charge), then every remaining slot returns to
        the allocator. Requires no parked KV — swap sequences in or
        ``release_parked`` them first."""
        assert not self._out, "close() with parked KV still in slots"
        assert not self._demoted, "close() with KV still in the tier"
        self.view.settle_loans()
        for d in list(self.slots):
            for p in self.slots[d]:
                self.view.unreserve(p)
            self.slots[d] = []
        self.reserved_total = 0
        self._borrowed.clear()
        self._lent.clear()
        self.view.withdraw_slots()

    # -- placement over the slow-domain subspace ------------------------------

    def _slot_domains(self) -> list[int]:
        return sorted(self.slots)

    def _slot_counts(self, num_pages: int) -> np.ndarray:
        """How many of ``num_pages`` go to each slow domain (policy-weighted,
        clamped to available slots; order = ``_slot_domains``)."""
        doms = self._slot_domains()
        ctx = placement_policy.PlacementContext(
            bandwidths=np.asarray([self.view.domains[d].read_bw
                                   for d in doms]),
            num_pages=num_pages,
            capacities=np.asarray([len(self.slots[d]) for d in doms]))
        return self.placement.counts(ctx)

    # -- the round-trip -------------------------------------------------------

    def swap_out(self, page_ids: list[int],
                 table=None) -> tuple[list[int], float]:
        """Move a sequence's pages into reserved slow-domain slots; frees
        the sources back to the fabric. Returns ``(new_page_ids, seconds)``
        with page order preserved (the view stays positional). ``table`` is
        accepted for backward compatibility and must be the view's own
        page table — pinning and remapping always ride the fabric now.

        Pages with refcount > 1 are *pinned*: other live sequences read
        them, so they keep their fast-domain homes and only this sequence's
        exclusive pages park. Moved pages leave the prefix trie (a parked
        page must not be matched — its id changes again on swap-in) and the
        fabric carries refcounts and holds onto the slots."""
        assert table is None or table is self.view.table, \
            "swap rides the fabric view's own page table"
        movable = [p for p in page_ids if not self.view.shared(p)]
        n = len(movable)
        if n == 0:
            return list(page_ids), 0.0
        loan_seconds = self._ensure_slots(n)
        assert self.slots_free() >= n, "not enough reserved swap slots"
        counts = self._slot_counts(n)
        dst: list[int] = []
        for d, c in zip(self._slot_domains(), counts):
            dst.extend(self.slots[d].pop() for _ in range(int(c)))
        src_doms = [self.view.domain_of(p) for p in movable]
        dst_doms = [self.view.domain_of(p) for p in dst]
        self.view.park_pages(movable, dst)
        moved = dict(zip(movable, dst))
        self._out.update(dst)
        for p in dst:                      # park order drives cold demotion
            self._park_stamp += 1
            self._park_order[p] = self._park_stamp
        seconds = self._transfer_seconds(src_doms, dst_doms) + loan_seconds
        self.view.telemetry.record_swap("out", n, seconds)
        return [moved.get(p, p) for p in page_ids], seconds

    def swap_in(self, page_ids: list[int],
                table=None) -> tuple[list[int], float]:
        """Bring parked pages back through the view's live placement
        policy; vacated slots rejoin the reservation. Pages that demoted
        to the persistent tier promote back through the same forwarding
        map, bit-exactly. Pages of the view that never parked (pinned
        shared pages) pass through untouched. Caller guarantees the view
        has enough allocatable pages (the scheduler checks against the
        promotable count)."""
        assert table is None or table is self.view.table, \
            "swap rides the fabric view's own page table"
        page_ids = [self._forward(p) for p in page_ids]
        parked = [p for p in page_ids if p in self._out]
        demoted = [p for p in page_ids if p in self._demoted]
        if not parked and not demoted:
            return list(page_ids), 0.0
        moved: dict[int, int] = {}
        seconds = 0.0
        if parked:
            src_doms = [self.view.domain_of(p) for p in parked]
            dst = self.view.unpark_pages(parked)
            dst_doms = [self.view.domain_of(p) for p in dst]
            moved.update(zip(parked, dst))
            for pid in parked:
                self._out.discard(pid)
                self._park_order.pop(pid, None)
                self.slots[self.view.domain_of(pid)].append(int(pid))
            secs = self._transfer_seconds(src_doms, dst_doms)
            self.view.telemetry.record_swap("in", len(parked), secs)
            seconds += secs
        if demoted:
            dst, secs = self.persist.promote(self.view, demoted)
            moved.update(zip(demoted, dst))
            self._demoted.difference_update(demoted)
            seconds += secs
        return [moved.get(p, p) for p in page_ids], seconds

    def _forward(self, pid: int) -> int:
        """Resolve (and retire) the forwarding chain for one page id."""
        out = pid
        while out in self._moved:
            out = self._moved.pop(out)
        return out

    def _transfer_seconds(self, src_doms, dst_doms) -> float:
        """Eq.-1 cost of the copy under the fabric's effective bandwidths:
        reads and writes overlap across domains, so the transfer takes the
        slower of the two sides. Sized per geometry — ``view.page_bytes``
        comes from the group's :class:`PageGeometry` (DESIGN.md §12), so
        swapping an MLA latent page bills its true (much smaller) byte
        cost, not the dense-transformer constant."""
        nd = len(self.view.domains)
        pb = self.view.page_bytes
        read = np.bincount(src_doms, minlength=nd) * pb
        write = np.bincount(dst_doms, minlength=nd) * pb
        secs = max(self.view.stall_seconds(read),
                   self.view.stall_seconds(write))
        obs = self.view.fabric.obs
        if obs is not None:
            # Eq.-1 prediction vs measurement (observatory drift ledger):
            # the transfer touches both page sets, read side + write side
            obs.observe_transfer(read + write, secs)
        return secs
