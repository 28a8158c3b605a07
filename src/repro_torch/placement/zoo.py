"""The page-fabric zoo: heterogeneous model groups over one byte arena,
with a capacity market between them (DESIGN.md §12).

One :class:`MemoryFabric` serves one model group — every page in it has
that group's :class:`~repro_torch.placement.geometry.PageGeometry`, so the
paged-attention kernels stay oblivious and intra-group ledgers stay in
page units.  Serving the *zoo* (chat transformer + MLA tenant + SSM
tenant + ASR encoder tier on one machine) therefore needs a layer above
the fabric whose currency is the only unit all geometries share:
**bytes per physical memory domain**.

:class:`PageFabricZoo` owns that byte ledger.  Each registered group
gets its own fabric whose pool *address space* spans the full domain
capacity in the group's own page units (so a group could, if funded,
hold a whole domain), while the group's single view is *funded* with
``floor(share * domain_bytes / page_bytes)`` pages — the view quota is
the funding, and the fabric's ``_headroom`` gate makes residency follow
funding.  Quota moves between groups are pure ledger arithmetic: no
array rebuild, no page-id remapping, no data motion.

The market prices a funded page by the paper's Eq. 1: the marginal
value of one more funded byte to group *g* is the stall it would shave
off *g*'s next step — zero while *g* has free funding or no demand,
and ``D_g / (bw_home(g) * 1e9)`` seconds (its unfunded demand streamed
at its home domain's bandwidth) while it is starved.  A trade happens
exactly when one group's marginal value strictly exceeds another's —
in practice: a chat burst annexes idle ASR/SSM funding and repays it
when the lender's own demand returns or the burst drains.

Because lender and borrower page sizes differ, every trade quantizes
down to whole pages on both sides and escrows the remainder bytes in
the lease itself; repayment restores the lender's exact original page
count, so repeated annex/repay cycles leak nothing.  The zoo-level
invariant — per domain, funded + escrowed + free bytes == capacity —
is checked together with every member fabric's own page/byte
invariants by :meth:`PageFabricZoo.check_invariants`.

Port of ``repro.placement.zoo``: the byte ledger and the market are a
numpy copy; each member fabric's pool lives on the zoo's ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.dwp import DWPConfig
from repro_torch.placement.fabric import MemoryFabric
from repro_torch.placement.geometry import PageGeometry, geometry_for
from repro_torch.placement.pool import MemoryDomain


@dataclasses.dataclass(frozen=True)
class ByteDomain:
    """One physical memory domain as the zoo sees it: a byte capacity
    and a read bandwidth — page counts are per-group derived quantities."""

    name: str
    capacity_bytes: int
    read_bw: float                       # GB/s toward the workers
    is_worker: bool = False


@dataclasses.dataclass
class Lease:
    """One outstanding capacity-market trade, byte-exact.

    The lender released ``lender_pages[d] * lender_bpp`` bytes in domain
    ``d``; the borrower was funded ``borrower_pages[d] * borrower_bpp``
    of them; the difference sits in ``escrow_bytes[d]`` until repayment
    (page sizes rarely divide each other, and the remainder must not be
    double-spent by a concurrent trade)."""

    lender: str
    borrower: str
    lender_pages: np.ndarray             # int64 per domain
    borrower_pages: np.ndarray           # int64 per domain
    escrow_bytes: np.ndarray             # int64 per domain
    granted_bytes: int = 0               # cumulative borrower funding
    repaid_bytes: int = 0                # cumulative funding returned

    def outstanding_bytes(self) -> int:
        return self.granted_bytes - self.repaid_bytes

    def as_dict(self) -> dict:
        return {
            "lender": self.lender, "borrower": self.borrower,
            "granted_bytes": int(self.granted_bytes),
            "repaid_bytes": int(self.repaid_bytes),
            "outstanding_bytes": int(self.outstanding_bytes()),
            "escrow_bytes": int(self.escrow_bytes.sum()),
        }


@dataclasses.dataclass
class ZooGroup:
    """One model group: its config, geometry, fabric, and funded view."""

    name: str
    cfg: object
    geometry: PageGeometry
    fabric: MemoryFabric
    view: object                          # FabricView
    demand_bytes: int = 0                 # unfunded demand (market input)

    @property
    def page_bytes(self) -> int:
        return self.geometry.page_bytes

    def funded_bytes(self) -> np.ndarray:
        return self.view.quota.astype(np.int64) * self.page_bytes

    def idle_pages(self) -> np.ndarray:
        """Funded-but-unused pages per domain — what the group could
        lend without touching anything resident."""
        return (self.view.quota - self.view.used
                - self.view.reserved).astype(np.int64)


class PageFabricZoo:
    """Byte arena + capacity market over per-group member fabrics."""

    def __init__(self, domains: Sequence[ByteDomain], *, seed: int = 0,
                 device="cuda"):
        self.domains = list(domains)
        self.device = device
        self.capacity_bytes = np.asarray(
            [d.capacity_bytes for d in self.domains], dtype=np.int64)
        self.seed = seed
        self.groups: dict[str, ZooGroup] = {}
        self.leases: list[Lease] = []
        self.trades = 0                   # cumulative grant events

    # -- registration ----------------------------------------------------------

    def register(self, name: str, cfg, *, share: float,
                 page_size: int = 4, geometry: PageGeometry | None = None,
                 policy: str = "bwap_dwp", level: int = 0,
                 dwp_config: DWPConfig | None = None,
                 share_prefix: bool = True) -> ZooGroup:
        """Stand up one model group: a fabric whose address space spans
        the full arena in the group's own page units, and a view funded
        with ``share`` of every domain's bytes."""
        assert name not in self.groups, f"group {name!r} already registered"
        assert 0.0 < share <= 1.0
        geom = geometry if geometry is not None \
            else geometry_for(cfg, page_size)
        bpp = geom.page_bytes
        space = [MemoryDomain(d.name, int(d.capacity_bytes // bpp),
                              d.read_bw, d.is_worker)
                 for d in self.domains]
        assert all(s.num_pages > 0 for s in space), \
            f"group {name!r}: page_bytes {bpp} exceeds a domain's capacity"
        fabric = MemoryFabric(cfg, space, page_size=geom.page_size,
                              seed=self.seed, policy=policy,
                              geometry=geom, group=name,
                              device=self.device)
        funded = self._affordable(share, bpp)
        assert int(funded.sum()) > 0, f"group {name!r}: share funds 0 pages"
        home = tuple(i for i, d in enumerate(self.domains) if d.is_worker) \
            or (int(np.argmax([d.read_bw for d in self.domains])),)
        view = fabric.view(name, quota=funded, home=home, level=level,
                           share_prefix=share_prefix and geom.shareable,
                           dwp_config=dwp_config)
        group = ZooGroup(name=name, cfg=cfg, geometry=geom,
                         fabric=fabric, view=view)
        self.groups[name] = group
        assert (self._funded_total() <= self.capacity_bytes).all(), \
            "group shares oversubscribe the arena"
        return group

    def _affordable(self, share: float, bpp: int) -> np.ndarray:
        return np.asarray(
            [int(share * c) // bpp for c in self.capacity_bytes],
            dtype=np.int64)

    def unregister(self, name: str) -> np.ndarray:
        """Drop a group; its funding returns to the arena. All leases it
        is party to must be repaid first — the market cannot price pages
        of a tenant that no longer exists."""
        assert not any(ln.outstanding_bytes() for ln in self.leases
                       if name in (ln.lender, ln.borrower)), \
            f"group {name!r} still party to an outstanding lease"
        group = self.groups[name]
        freed = group.funded_bytes()
        group.fabric.unregister(name)
        del self.groups[name]
        return freed

    # -- the market ------------------------------------------------------------

    def observe_demand(self, name: str, demand_bytes: int) -> None:
        """Report a group's *unfunded* demand: bytes it wants resident
        beyond its current free funding (0 = satisfied/idle)."""
        self.groups[name].demand_bytes = max(0, int(demand_bytes))

    def page_value(self, name: str) -> float:
        """Marginal value of one more funded page to this group, in
        Eq.-1 stall-seconds saved per byte times its unfunded demand:
        ``D_g / (bw_home * 1e9)`` while starved, 0 while satisfied.
        (A group with free funding left is never starved — its next
        page is already paid for.)"""
        g = self.groups[name]
        if g.demand_bytes <= 0 or g.view.free_count() * g.page_bytes \
                >= g.demand_bytes:
            return 0.0
        bw = max(self.domains[h].read_bw for h in g.view.home)
        return g.demand_bytes / (bw * 1e9)

    def market_tick(self) -> dict:
        """One pricing round: repay leases whose borrowers are idle (or
        whose lenders are starved), then fund starved groups from the
        cheapest idle funding on the market. Returns a summary of byte
        flows this round."""
        repaid = self._repay_round()
        granted = self._annex_round()
        return {"granted_bytes": granted, "repaid_bytes": repaid}

    def _annex_round(self) -> int:
        total = 0
        values = {n: self.page_value(n) for n in self.groups}
        for bname, bval in sorted(values.items(), key=lambda kv: -kv[1]):
            if bval <= 0.0:
                continue
            borrower = self.groups[bname]
            want = borrower.demand_bytes \
                - borrower.view.free_count() * borrower.page_bytes
            # cheapest funding first: idle groups before busy ones
            for lname in sorted(values, key=lambda n: values[n]):
                if want <= 0:
                    break
                if lname == bname or values[lname] >= bval:
                    continue
                total += self._grant(self.groups[lname], borrower, want)
                want = borrower.demand_bytes \
                    - borrower.view.free_count() * borrower.page_bytes
        return total

    def _grant(self, lender: ZooGroup, borrower: ZooGroup,
               want_bytes: int) -> int:
        """Move idle funding lender -> borrower, domain by domain,
        quantized to whole pages on both sides; remainder bytes escrow
        in the lease. Returns borrower bytes funded."""
        lb, bb = lender.page_bytes, borrower.page_bytes
        lease = self._lease(lender.name, borrower.name)
        granted = 0
        idle = lender.idle_pages()
        for d in range(len(self.domains)):
            if want_bytes <= 0:
                break
            n_l = min(int(idle[d]), -(-int(want_bytes) // lb))
            if n_l <= 0:
                continue
            released = n_l * lb
            n_b = released // bb
            if n_b <= 0:
                continue                  # lender page too small to fund one
            funded = n_b * bb
            lender.view.quota[d] -= n_l
            borrower.view.quota[d] += n_b
            lease.lender_pages[d] += n_l
            lease.borrower_pages[d] += n_b
            lease.escrow_bytes[d] += released - funded
            lease.granted_bytes += funded
            granted += funded
            want_bytes -= funded
            self.trades += 1
            borrower.fabric.emit(
                "share", kind="loan", lender=lender.name,
                borrower=borrower.name, slots=int(n_b))
        return granted

    def _repay_round(self) -> int:
        """Unwind leases whose borrower is idle in a domain (or whose
        lender is starved while the borrower has free funding): restore
        the lender's exact original page count, release the escrow."""
        total = 0
        for lease in self.leases:
            if lease.outstanding_bytes() <= 0:
                continue
            borrower = self.groups[lease.borrower]
            lender = self.groups[lease.lender]
            borrower_busy = borrower.demand_bytes > 0 \
                and self.page_value(borrower.name) \
                >= self.page_value(lender.name)
            if borrower_busy:
                continue
            b_idle = borrower.idle_pages()
            for d in range(len(self.domains)):
                n_b = int(lease.borrower_pages[d])
                if n_b == 0 or b_idle[d] < n_b:
                    continue              # annexed pages still resident
                n_l = int(lease.lender_pages[d])
                borrower.view.quota[d] -= n_b
                lender.view.quota[d] += n_l
                repaid = n_b * borrower.page_bytes
                lease.repaid_bytes += repaid
                lease.borrower_pages[d] = 0
                lease.lender_pages[d] = 0
                lease.escrow_bytes[d] = 0
                total += repaid
                lender.fabric.emit(
                    "share", kind="reclaim", lender=lease.lender,
                    borrower=lease.borrower, slots=int(n_b),
                    seconds=0.0)
        return total

    def _lease(self, lender: str, borrower: str) -> Lease:
        for ln in self.leases:
            if (ln.lender, ln.borrower) == (lender, borrower):
                return ln
        nd = len(self.domains)
        ln = Lease(lender=lender, borrower=borrower,
                   lender_pages=np.zeros(nd, dtype=np.int64),
                   borrower_pages=np.zeros(nd, dtype=np.int64),
                   escrow_bytes=np.zeros(nd, dtype=np.int64))
        self.leases.append(ln)
        return ln

    def outstanding_bytes(self) -> int:
        return sum(ln.outstanding_bytes() for ln in self.leases)

    # -- accounting ------------------------------------------------------------

    def _funded_total(self) -> np.ndarray:
        out = np.zeros(len(self.domains), dtype=np.int64)
        for g in self.groups.values():
            out += g.funded_bytes()
        return out

    def _escrow_total(self) -> np.ndarray:
        out = np.zeros(len(self.domains), dtype=np.int64)
        for ln in self.leases:
            out += ln.escrow_bytes
        return out

    def free_bytes(self) -> np.ndarray:
        """Per-domain bytes funded to nobody (unsold arena capacity)."""
        return self.capacity_bytes - self._funded_total() \
            - self._escrow_total()

    def check_invariants(self) -> None:
        """Zoo-wide byte balance: per domain, every capacity byte is
        funded to exactly one group, escrowed in exactly one lease, or
        free — plus every member fabric's own page/byte invariants."""
        funded = self._funded_total()
        escrow = self._escrow_total()
        free = self.free_bytes()
        assert (free >= 0).all(), \
            f"arena oversubscribed: funded {funded} escrow {escrow} " \
            f"capacity {self.capacity_bytes}"
        np.testing.assert_array_equal(
            funded + escrow + free, self.capacity_bytes,
            err_msg="zoo byte ledger does not balance")
        for g in self.groups.values():
            assert (g.view.quota >= g.view.used + g.view.reserved).all(), \
                f"group {g.name!r} residency exceeds funding"
            np.testing.assert_array_equal(
                g.funded_bytes(),
                g.view.quota.astype(np.int64) * g.page_bytes,
                err_msg=f"group {g.name!r} byte funding drifted")
            g.fabric.check_invariants()

    def stats(self) -> dict:
        return {
            "capacity_bytes": self.capacity_bytes.tolist(),
            "free_bytes": self.free_bytes().tolist(),
            "trades": self.trades,
            "leases": [ln.as_dict() for ln in self.leases],
            "groups": {
                n: {
                    "kind": g.geometry.kind,
                    "page_bytes": g.page_bytes,
                    "funded_bytes": g.funded_bytes().tolist(),
                    "used_bytes": g.view.used_bytes(),
                    "demand_bytes": g.demand_bytes,
                } for n, g in self.groups.items()
            },
        }
