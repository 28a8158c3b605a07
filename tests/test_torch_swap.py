"""repro_torch's KV swap (``scheduler/swap.py`` over the fabric's
park/unpark data moves) against the reference: random swap-out/swap-in
interleavings keep every sequence's K/V bytes, keep ``check_invariants()``
after each operation, give the same page ids as the reference, and drain
the ledgers to zero.

``tests/test_scheduler.py::test_swap_random_interleavings_preserve_kv``
fails on the reference with "KV pool exhausted" (e.g. footprints
[1, 3, 6, 6]): its generator asks for more pages than the pool can hand
out once the swap manager has reserved 80 % of the slow domains. The port,
whose control plane is the same code, fails the same way on those inputs
(pinned below). The property here draws footprints within the allocatable
capacity and holds both packages to the stated invariants.

Cold demotion into a persistent tier runs only with a tier attached.
``_StandInTier`` below follows the reference tier's
``demote``/``promote``/``forget`` contract
(``src/repro/placement/persist.py:219-290``) in a few lines, and the same
sequences run again on the port's ``placement/persist.PersistentTier``
(the ``_on_the_persistent_tier`` cases). The port departs from the
reference here (``scheduler/swap.py``'s module docstring): the reference
forwards a demoted slot's id to its tier handle and, once ``swap_out``
reuses the slot, forwards the newcomer too. The two falsifying sequences of
``tests/test_persist.py::test_property_demote_interleavings`` are fixed
cases below; what they assert is invariants, not the reference's
behaviour.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="parity with the reference needs jax")

from repro.configs import registry  # noqa: E402
from repro.placement import pool as r_pool  # noqa: E402
from repro.scheduler.swap import KVSwapManager as RSwap  # noqa: E402
from repro_torch.core.dwp import DWPConfig  # noqa: E402
from repro_torch.models import config as t_config  # noqa: E402
from repro_torch.placement import pool as t_pool  # noqa: E402
from repro_torch.scheduler.swap import KVSwapManager as TSwap  # noqa: E402


def _rig(port: bool):
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    mod = t_pool if port else r_pool
    if port:
        cfg = t_config.ModelConfig(**dataclasses.asdict(cfg))
    domains = [mod.MemoryDomain("hbm_local", 8, 819.0, True),
               mod.MemoryDomain("hbm_peer", 10, 0.05, False),
               mod.MemoryDomain("host", 24, 0.016, False)]
    pool = mod.BwapPagePool(cfg, domains, page_size=4,
                            dwp_config=DWPConfig(n=100, c=1),
                            **({"device": "cpu"} if port else {}))
    swap = (TSwap if port else RSwap)(pool, reserve_fraction=0.8)
    return pool, swap


def _fill(pool, pages, value, port):
    if port:
        pool.k_pool[:, pages] = value
        pool.v_pool[:, pages] = -value
    else:
        pool.k_pool = pool.k_pool.at[:, pages].set(value)
        pool.v_pool = pool.v_pool.at[:, pages].set(-value)


def _kv(pool, pages, port):
    if port:
        return pool.k_pool[:, pages].numpy(), pool.v_pool[:, pages].numpy()
    return (np.asarray(pool.k_pool)[:, pages],
            np.asarray(pool.v_pool)[:, pages])


def _interleave(footprints, seed, port):
    pool, swap = _rig(port)
    rng = np.random.default_rng(seed)
    seqs, trail = [], []
    for i, n in enumerate(footprints):
        pages: list[int] = []
        swap.view.grow(pages, n)             # table-tracked, as the engine
        _fill(pool, pages, float(i + 1), port)
        seqs.append({"pages": pages, "fill": float(i + 1), "parked": False})
    for _ in range(12):                      # random preemption points
        s = seqs[int(rng.integers(len(seqs)))]
        if s["parked"]:
            s["pages"], _ = swap.swap_in(s["pages"])
        elif swap.can_swap_out(len(s["pages"])):
            s["pages"], _ = swap.swap_out(s["pages"])
        else:
            continue
        s["parked"] = not s["parked"]
        swap.view.fabric.check_invariants()
        trail.append([list(q["pages"]) for q in seqs])
    for s in seqs:
        k, v = _kv(pool, s["pages"], port)
        assert (k == s["fill"]).all() and (v == -s["fill"]).all()
    # drain: everything back in, freed, reservation closed
    for s in seqs:
        if s["parked"]:
            s["pages"], _ = swap.swap_in(s["pages"])
        swap.view.release(s["pages"])
    swap.close()
    swap.view.fabric.check_invariants()
    assert int(pool.reserved.sum()) == 0
    assert pool.free_count() == pool.total_pages
    return trail


@pytest.mark.parametrize("seed", range(8))
def test_swap_interleavings_preserve_kv_and_match_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    pool, _ = _rig(port=True)
    cap = pool.free_count()                  # allocatable after reservation
    footprints = []
    while len(footprints) < 5:
        n = int(rng.integers(1, 7))
        if sum(footprints) + n > cap:
            break
        footprints.append(n)
    got = _interleave(footprints, seed, port=True)
    want = _interleave(footprints, seed, port=False)
    assert got == want                       # same page ids, every op
    assert len(got) > 0


def test_over_capacity_footprints_fail_alike():
    """The reference property's falsifying inputs exhaust both pools."""
    for port in (False, True):
        with pytest.raises(RuntimeError, match="KV pool exhausted"):
            _interleave([1, 3, 6, 6], 0, port)


# -- cold demotion into a persistent tier ---------------------------------------

class _StandInTier:
    """A persistent tier for the port's swap manager, after the reference
    tier's contract: ``demote`` copies parked pages' bytes out and carries
    their table references and view holds onto fresh negative handles
    (``remap_physical`` + ``_on_remap``); ``promote`` allocates live pages
    through the view's placement cycle and copies the bytes back;
    ``forget`` drops a dead handle. Eq.-1 seconds are the bytes over the
    tier's bandwidth."""

    name = "persist"

    def __init__(self, capacity_pages=32, bw_gbps=0.008):
        self.capacity_pages = capacity_pages
        self.bw_gbps = bw_gbps
        self.fabric = None
        self._entries: dict[int, tuple] = {}
        self._next = -2

    def bind(self, fabric):
        self.fabric = fabric

    def persisted_ids(self):
        return set(self._entries)

    def used_pages(self):
        return len(self._entries)

    def capacity_left(self):
        return self.capacity_pages - len(self._entries)

    def per_view_counts(self):
        out: dict[str, int] = {}
        for *_, owner in self._entries.values():
            out[owner] = out.get(owner, 0) + 1
        return out

    def _seconds(self, view, n):
        return n * view.page_bytes / (self.bw_gbps * 1e9)

    def demote(self, view, slot_ids):
        slot_ids = [int(s) for s in slot_ids]
        assert len(slot_ids) <= self.capacity_left()
        k = view.pool.k_pool[:, slot_ids].clone()
        v = view.pool.v_pool[:, slot_ids].clone()
        handles = []
        for i, sid in enumerate(slot_ids):
            h = self._next
            self._next -= 1
            self._entries[h] = (k[:, i], v[:, i], view.name)
            view.persisted += 1
            view.table.remap_physical(sid, h)
            for vv in self.fabric.views.values():
                vv._on_remap(sid, h)
            handles.append(h)
        seconds = self._seconds(view, len(handles))
        self.fabric.emit("demote", view=view.name, pages=len(handles),
                         handles=list(handles), seconds=seconds)
        return handles, seconds

    def promote(self, view, handles):
        handles = [int(h) for h in handles]
        dst = [view._alloc_physical() for _ in handles]
        pool = view.pool
        pool.k_pool[:, dst] = torch.stack([self._entries[h][0]
                                           for h in handles], 1)
        pool.v_pool[:, dst] = torch.stack([self._entries[h][1]
                                           for h in handles], 1)
        for h, d in zip(handles, dst):
            *_, owner = self._entries.pop(h)
            self.fabric.views[owner].persisted -= 1
            view.table.remap_physical(h, d)
            self.fabric._own(view, d)
            for vv in self.fabric.views.values():
                vv._on_remap(h, d)
        seconds = self._seconds(view, len(handles))
        self.fabric.emit("promote", view=view.name, pages=len(handles),
                         seconds=seconds)
        return dst, seconds

    def forget(self, handle):
        entry = self._entries.pop(handle, None)
        if entry is not None:
            self.fabric.views[entry[2]].persisted -= 1


def _persistent_tier():
    from repro_torch.placement.persist import PersistentTier
    return PersistentTier(bw_gbps=0.008, capacity_pages=32)


def _demote_rig(make_tier=_StandInTier):
    """``tests/test_persist.py``'s rig and property setup on the port: a
    pool of 12/12/16 pages of 4 tokens, a tier (the stand-in unless
    ``make_tier`` builds another), half the slow domains reserved, three
    sequences of two pages with known bytes."""
    cfg = t_config.ModelConfig(**dataclasses.asdict(dataclasses.replace(
        registry.get_smoke_config("qwen2-0.5b"), num_layers=1,
        compute_dtype="float32")))
    pool = t_pool.BwapPagePool(cfg, [
        t_pool.MemoryDomain("hbm_local", 12, 819.0, True),
        t_pool.MemoryDomain("hbm_peer", 12, 0.05, False),
        t_pool.MemoryDomain("host", 16, 0.016, False),
    ], page_size=4, dwp_config=DWPConfig(n=10 ** 6, c=1), device="cpu")
    tier = make_tier()
    swap = TSwap(pool, reserve_fraction=0.5)
    swap.view.fabric.attach_persist(tier)
    seqs = []
    for s in range(3):
        pages: list[int] = []
        for i in range(2):
            swap.view.append_page(pages)
            pool.k_pool[:, pages[-1]] = float(10 * s + i)
            pool.v_pool[:, pages[-1]] = -float(10 * s + i)
        seqs.append(pages)
    return pool, swap, tier, seqs


def _run_demote_ops(ops, make_tier=_StandInTier):
    """Park / demote / promote / free interleavings: ``check_invariants``
    after every op, each live sequence's bytes intact at the end, and the
    tier, the reservation and the ledgers drained to zero."""
    pool, swap, tier, seqs = _demote_rig(make_tier)
    view = swap.view
    state = ["live"] * 3
    for act, s in ops:
        if act == "out" and state[s] == "live":
            seqs[s], _ = swap.swap_out(seqs[s])
            state[s] = "parked"
        elif act == "demote":
            swap.demote_cold(2)
        elif act == "in" and state[s] == "parked":
            seqs[s], _ = swap.swap_in(seqs[s])
            state[s] = "live"
        elif act == "free" and state[s] != "freed":
            if state[s] == "parked":
                assert swap.release_parked(seqs[s]) == []
            else:
                view.release(seqs[s])
            state[s] = "freed"
        view.fabric.check_invariants()
    for s in range(3):
        if state[s] == "parked":
            seqs[s], _ = swap.swap_in(seqs[s])
            state[s] = "live"
        if state[s] == "live":
            for i, p in enumerate(seqs[s]):
                assert bool((pool.k_pool[:, p] == 10 * s + i).all()), (s, i)
                assert bool((pool.v_pool[:, p] == -(10 * s + i)).all())
            view.release(seqs[s])
        view.fabric.check_invariants()
    swap.close()
    assert tier.used_pages() == 0
    assert int(view.used.sum()) == 0 and int(pool.reserved.sum()) == 0
    assert pool.free_count() == pool.total_pages
    view.fabric.check_invariants()


# the reference property's falsifying examples (ROADMAP.md §3): a slot that
# demote_cold vacated is parked into again by the next swap_out
DEMOTE_FALSIFIERS = [
    [("out", 1), ("demote", 0), ("out", 0)],
    [("out", 2), ("demote", 0), ("out", 0), ("demote", 0), ("in", 2)],
]


@pytest.mark.parametrize("ops", DEMOTE_FALSIFIERS)
def test_demoted_slot_reuse_keeps_each_sequences_kv(ops):
    _run_demote_ops(ops)


@pytest.mark.parametrize("seed", range(8))
def test_demote_interleavings_preserve_kv(seed):
    """Seeded random interleavings of the four ops over three sequences."""
    _run_demote_ops(_demote_seeded(seed))


def _demote_seeded(seed):
    rng = np.random.default_rng(2000 + seed)
    acts = ("out", "demote", "in", "free")
    return [(acts[int(rng.integers(4))], int(rng.integers(3)))
            for _ in range(int(rng.integers(3, 13)))]


@pytest.mark.parametrize("ops", DEMOTE_FALSIFIERS)
def test_demoted_slot_reuse_keeps_each_sequences_kv_on_the_persistent_tier(
        ops):
    _run_demote_ops(ops, _persistent_tier)


@pytest.mark.parametrize("seed", range(8))
def test_demote_interleavings_preserve_kv_on_the_persistent_tier(seed):
    _run_demote_ops(_demote_seeded(seed), _persistent_tier)


def test_demoted_list_names_its_tier_handles(make_tier=_StandInTier):
    """Demotion rewrites the owner's list in place: the sequence's list
    holds the tier handles, and a newcomer parked into the vacated slots
    holds the slot ids, with no id shared between the two."""
    pool, swap, tier, seqs = _demote_rig(make_tier)
    parked, _ = swap.swap_out(seqs[1])
    n, _ = swap.demote_cold(2)
    assert n == 2 and all(p <= -2 for p in parked)
    assert swap.promotable_count(parked) == 2 and swap.parked_count(
        parked) == 0
    newcomer, _ = swap.swap_out(seqs[0])
    assert not set(newcomer) & set(parked)
    assert swap.parked_count(newcomer) == 2
    back, _ = swap.swap_in(parked)
    for i, p in enumerate(back):
        assert bool((pool.k_pool[:, p] == 10 + i).all())



def test_demoted_list_names_its_tier_handles_on_the_persistent_tier():
    test_demoted_list_names_its_tier_handles(_persistent_tier)

def test_loan_reclaim_rewrites_the_borrowers_list_in_place():
    """``tests/test_fabric.py``'s loan cycle on the port: B parks a
    sequence in slots borrowed from A; A recalls one; B vacates it into its
    own reservation, and the list ``swap_out`` returned names the new slot
    in place of the returned one, so swap-in finds the bytes intact."""
    from repro_torch.placement.fabric import MemoryFabric
    cfg = t_config.ModelConfig(**dataclasses.asdict(dataclasses.replace(
        registry.get_smoke_config("qwen2-0.5b"), num_layers=1,
        compute_dtype="float32")))
    fab = MemoryFabric(cfg, [t_pool.MemoryDomain("hbm_local", 32, 819.0,
                                                 True),
                             t_pool.MemoryDomain("hbm_peer", 24, 50.0, False),
                             t_pool.MemoryDomain("host", 24, 16.0, False)],
                       page_size=4, seed=0, device="cpu")
    a = fab.view("A", quota=(20, 16, 16), home=(0,), level=10)
    b = fab.view("B", quota=(10, 8, 8), home=(1,), level=0)
    swap_a = TSwap(a, reserve_fraction=0.5)
    swap_b = TSwap(b, reserve_pages={"host": 2})
    s1, s2 = [], []
    b.grow(s1, 2)
    b.grow(s2, 3)
    fab.pool.k_pool[:, s2] = 7.25
    p1, _ = swap_b.swap_out(list(s1))
    p2, _ = swap_b.swap_out(list(s2))            # borrows 3 slots from A
    loan = fab.loans[0]
    assert loan.granted == 3
    before = list(p2)
    s1b, _ = swap_b.swap_in(p1)
    got, secs = a.recall_loans(1)
    assert got == 1 and secs > 0.0
    fab.check_invariants()
    gone = set(before) - set(p2)                 # the slot A took back
    assert len(gone) == 1 and not gone & set(swap_b.parked_ids())
    assert swap_b.parked_count(p2) == 3
    s2b, _ = swap_b.swap_in(p2)
    assert bool((fab.pool.k_pool[:, s2b] == 7.25).all())
    b.release(s1b)
    b.release(s2b)
    a.recall_loans(99)
    fab.check_invariants()
