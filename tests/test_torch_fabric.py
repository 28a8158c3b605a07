"""``tests/test_fabric.py``'s API boundary and its multi-tenant invariant
property, for the port: the port's ``serve/`` (the zoo drivers included)
and ``scheduler/`` touch placement only through ``FabricView`` (grep
enforced), no attach back-channel is defined or called in
``src/repro_torch``, and random interleavings of alloc / cross-tenant
share / swap (loan) / reclaim / migrate / release hold the fabric
invariants after every operation on both packages and leave the same page
lists, parked flags and ownership on both. The property runs
derandomized, with no example database."""

import dataclasses
import pathlib
import re

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from _torch_parity import both  # noqa: E402
from repro.configs import registry  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"
DOMAINS = (("hbm_local", 32, 819.0, True), ("hbm_peer", 24, 50.0, False),
           ("host", 24, 16.0, False))


def test_serve_scheduler_layers_only_touch_fabric_views():
    """No module of the port's serve/ or scheduler/ imports the pool or
    page-table internals: all placement access goes through FabricView."""
    banned = re.compile(
        r"from repro_torch\.placement\.(pool|pagetable) import"
        r"|import repro_torch\.placement\.(pool|pagetable)\b"
        r"|from repro_torch\.placement import .*\b(pool|pagetable)\b"
        r"|BwapPagePool\(")
    files = [f for pkg in ("serve", "scheduler")
             for f in sorted((SRC / pkg).glob("*.py"))]
    assert SRC / "serve" / "zoo.py" in files
    for f in files:
        m = banned.search(f.read_text())
        assert m is None, f"{f} touches pool internals: {m.group(0)!r}"


def test_attach_backchannels_are_gone():
    """attach_engine / attach_pagetable / set_reserved_counts are neither
    defined nor called anywhere in the port."""
    pat = re.compile(
        r"def (attach_engine|attach_pagetable|set_reserved_counts)\b"
        r"|\.(attach_engine|attach_pagetable|set_reserved_counts)\(")
    hits = [f"{f}: {m.group(0)}" for f in SRC.rglob("*.py")
            if (m := pat.search(f.read_text()))]
    assert not hits, f"back-channel survives: {hits}"


def _interleave(pkg, ops, seed) -> list:
    """``test_fabric.py``'s interleaving on one package; returns what each
    operation left behind."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    fab = pkg.fabric(cfg, DOMAINS, page_size=4, seed=0)
    views = {
        "A": fab.view("A", quota=(12, 9, 9), home=(0,)),
        "B": fab.view("B", quota=(12, 9, 9), home=(1,)),
    }
    swaps = {n: pkg.KVSwapManager(v, reserve_pages={"host": 2})
             for n, v in views.items()}
    rng = np.random.default_rng(seed)
    ps = fab.pool.page_size
    streams = {g: list(range(1000 * (g + 1), 1000 * (g + 1) + 3 * ps))
               for g in range(3)}
    seqs = []                              # {view, pages, parked}
    trail = []

    def pick_view():
        return "A" if rng.integers(2) == 0 else "B"

    for op, arg in ops:
        name = pick_view()
        v, sw = views[name], swaps[name]
        mine = [s for s in seqs if s["view"] == name]
        if op == 0:                        # alloc a fresh sequence
            if v.free_count() < 3:
                continue
            pages = []
            v.grow(pages, int(rng.integers(1, 4)))
            seqs.append({"view": name, "pages": pages, "parked": False})
        elif op == 1:                      # share: probe + register prefix
            toks = streams[arg % 3]
            if v.free_count() < 3:
                continue
            pages = []
            matched = v.probe_prefix(toks, pages) // ps
            for _ in range(matched, 3):
                v.append_page(pages)
            v.register_prefix(toks, pages, 3 * ps)
            seqs.append({"view": name, "pages": pages, "parked": False})
        elif op == 2 and mine:             # swap out (may borrow slots)
            s = mine[arg % len(mine)]
            if s["parked"]:
                continue
            excl = len(v.exclusive(s["pages"]))
            if excl and sw.can_swap_out(excl):
                s["pages"], _ = sw.swap_out(s["pages"])
                s["parked"] = True
        elif op == 3 and mine:             # swap in / lender reclaim
            s = mine[arg % len(mine)]
            if s["parked"]:
                if v.free_count() >= sw.parked_count(s["pages"]):
                    s["pages"], _ = sw.swap_in(s["pages"])
                    s["parked"] = False
            else:
                v.recall_loans(int(rng.integers(1, 4)))
        elif op == 4 and mine:             # migrate live pages
            s = mine[arg % len(mine)]
            if not s["parked"]:
                s["pages"] = v.migrate(s["pages"])
        elif op == 5 and mine:             # release
            s = mine[arg % len(mine)]
            if not s["parked"]:
                v.release(s["pages"])
                seqs.remove(s)
        fab.check_invariants()
        trail.append(([(s["view"], list(s["pages"]), s["parked"])
                       for s in seqs], sorted(fab.owner.items()),
                      {n: x.used.tolist() for n, x in views.items()}))

    for s in [s for s in seqs if s["view"] == "B"]:
        if s["parked"]:
            if views["B"].free_count() >= swaps["B"].parked_count(
                    s["pages"]):
                s["pages"], _ = swaps["B"].swap_in(s["pages"])
                s["parked"] = False
            else:
                live = swaps["B"].release_parked(s["pages"])
                views["B"].release(live)
                seqs.remove(s)
                continue
        views["B"].release(s["pages"])
        seqs.remove(s)
    fab.check_invariants()
    fab.unregister("B")
    assert all(o == "A" for o in fab.owner.values())
    a_parked = set(swaps["A"].parked_ids())
    for pid in fab.table.ref:
        held = views["A"]._held.get(pid, 0)
        assert held > 0 or pid in a_parked, f"page {pid} leaked"
    assert not any(ln.slots for ln in fab.loans), "loan slots dangling"
    trail.append(sorted(fab.owner.items()))
    return trail


@given(st.lists(st.tuples(st.integers(0, 5), st.integers(0, 10 ** 6)),
                min_size=1, max_size=40),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
@settings(max_examples=25, deadline=None, derandomize=True, database=None)
def test_fabric_invariants_under_random_interleavings(ops, seed):
    """Random multi-tenant interleavings hold the fabric invariants after
    every operation on both packages, with equal page lists, parked flags
    and ownership, and unregister leaks nothing."""
    both(_interleave, ops, seed)


# ---------------------------------------------------------------------------
# the rest of ``tests/test_fabric.py`` on both packages
# (``_torch_parity.both``): view quotas, adoption of a bare pool,
# ownership, the cross-tenant prefix tier and its share events, the
# swap-slot loan cycle and its opt-out, Eq.-1 calibration, reservation-aware
# occupancy and trie-aware admission. Each returns a record (page ids,
# ledgers, loans, seconds, pool bits, tokens) that must be equal on both.
# ---------------------------------------------------------------------------

from _torch_parity import both_close, smoke_pair  # noqa: E402

CFG = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                          num_layers=1, compute_dtype="float32")


def _doms(fast=32, peer=24, host=24):
    return (("hbm_local", fast, 819.0, True), ("hbm_peer", peer, 50.0, False),
            ("host", host, 16.0, False))


def _two_views(pkg, *, share_prefix=True, quota_a=(24, 18, 18),
               quota_b=(8, 6, 6)):
    fab = pkg.fabric(CFG, _doms(), page_size=4, seed=0)
    a = fab.view("A", quota=quota_a, home=(0,), level=10,
                 share_prefix=share_prefix)
    b = fab.view("B", quota=quota_b, home=(1,), level=0,
                 share_prefix=share_prefix)
    return fab, a, b


def _ledgers(fab) -> dict:
    return {"owner": dict(fab.owner), "ref": dict(fab.table.ref),
            "free": [list(f) for f in fab.pool.free],
            "reserved": fab.pool.reserved.tolist(),
            "views": {n: (v.used.tolist(), v.reserved.tolist())
                      for n, v in fab.views.items()}}


def test_view_quota_caps_allocation():
    def case(pkg):
        fab, a, b = _two_views(pkg, quota_b=(2, 1, 1))
        pages = []
        for _ in range(4):
            b.append_page(pages)
        assert b.free_count() == 0
        with pytest.raises(RuntimeError, match="quota exhausted"):
            b.append_page(pages)
        other = []
        a.append_page(other)
        fab.check_invariants()
        state = _ledgers(fab)
        b.release(pages)
        a.release(other)
        fab.check_invariants()
        assert not fab.owner and not fab.table.ref
        return pages, other, state, _ledgers(fab)
    both(case)


def test_adopted_pool_matches_direct_driving():
    def case(pkg):
        def mk():
            return pkg.pool(CFG, _doms(), page_size=4, seed=0,
                            dwp_config=pkg.dwp.DWPConfig())
        direct, adopted = mk(), mk()
        view = pkg.as_view(adopted)
        assert pkg.as_view(adopted) is view
        want = [direct.alloc_page() for _ in range(20)]
        got, pages = [], []
        for _ in range(20):
            got.append(view.append_page(pages))
        assert got == want
        view.fabric.check_invariants()
        return got
    both(case)


def test_ownership_follows_last_holder():
    def case(pkg):
        fab, a, b = _two_views(pkg)
        ps = fab.pool.page_size
        tokens = list(range(100, 100 + ps))
        pages_a = []
        a.append_page(pages_a)
        a.register_prefix(tokens, pages_a, ps)
        pages_b = []
        assert b.probe_prefix(tokens, pages_b) == ps
        pid = pages_b[0]
        assert fab.owner[pid] == "A"
        a.release(pages_a)
        assert fab.owner[pid] == "B"
        assert fab.table.ref[pid] == 1
        fab.check_invariants()
        state = _ledgers(fab)
        b.release(pages_b)
        assert pid not in fab.table.ref
        fab.check_invariants()
        return pid, state, _ledgers(fab)
    both(case)


def test_cross_tenant_prefix_sharing_is_gated():
    def case(pkg):
        ps = 4
        tokens = list(range(7, 7 + 2 * ps))
        out = []
        for share in (True, False):
            fab, a, b = _two_views(pkg, share_prefix=share)
            pages_a = []
            a.append_page(pages_a)
            a.append_page(pages_a)
            a.register_prefix(tokens, pages_a, 2 * ps)
            pages_b = []
            matched = b.probe_prefix(tokens, pages_b)
            if share:
                assert matched == 2 * ps and pages_b == pages_a
                assert fab.cross_shared_pages() == 2
                fab.check_invariants()
            else:
                assert matched == 0 and not pages_b
                assert fab.cross_shared_pages() == 0
            out.append((matched, pages_a, pages_b, _ledgers(fab)))
        return out
    both(case)


def test_share_events_fire_on_cross_tenant_match():
    def case(pkg):
        fab, a, b = _two_views(pkg)
        events = []
        fab.subscribe("share", lambda **kw: events.append(kw))
        ps = fab.pool.page_size
        tokens = list(range(50, 50 + ps))
        pages_a = []
        a.append_page(pages_a)
        a.register_prefix(tokens, pages_a, ps)
        pages_b = []
        b.probe_prefix(tokens, pages_b)
        assert [e for e in events if e.get("kind") == "prefix"
                and e["owner"] == "A" and e["view"] == "B"]
        return events
    both(case)


def test_loan_cycle_grant_use_reclaim():
    def case(pkg):
        fab, a, b = _two_views(pkg, quota_a=(20, 16, 16),
                               quota_b=(10, 8, 8))
        swap_a = pkg.KVSwapManager(a, reserve_fraction=0.5)
        swap_b = pkg.KVSwapManager(b, reserve_pages={"host": 2})
        lender_free = swap_a.slots_free()
        assert b.borrowable() > 0
        s1, s2 = [], []
        for _ in range(2):
            b.append_page(s1)
        for _ in range(3):
            b.append_page(s2)
        pkg.put(fab.pool, s2, 7.25)
        trail = []
        p1, _ = swap_b.swap_out(list(s1))
        assert swap_a.slots_free() == lender_free
        assert swap_b.can_swap_out(3)
        p2, _ = swap_b.swap_out(list(s2))
        assert swap_a.slots_free() == lender_free - 3
        loan = fab.loans[0]
        assert (loan.lender, loan.borrower) == ("A", "B")
        assert loan.granted == 3 and len(loan.slots) == 3
        fab.check_invariants()
        # copies: the port rewrites a parked list in place when a reclaim
        # moves its bytes (``scheduler/swap.py``), the reference forwards
        trail.append((list(p1), list(p2), list(loan.slots), _ledgers(fab)))
        assert sum(1 for p in p2 if p in swap_b._borrowed) > 0
        s1b, _ = swap_b.swap_in(p1)
        got, secs = a.recall_loans(1)
        assert got == 1 and secs > 0.0
        assert loan.reclaimed == 1 and loan.reclaim_seconds == secs
        assert len(loan.slots) == 2
        fab.check_invariants()
        trail.append((s1b, got, secs, list(loan.slots), _ledgers(fab)))
        s2b, _ = swap_b.swap_in(p2)
        assert (pkg.host(fab.pool.k_pool)[:, s2b] == 7.25).all()
        fab.check_invariants()
        got, secs = a.recall_loans(99)
        assert got == 2 and secs == 0.0
        assert not loan.slots and swap_a.slots_free() == lender_free
        b.release(s1b)
        b.release(s2b)
        fab.check_invariants()
        trail.append((s2b, got, secs, _ledgers(fab),
                      pkg.kv(fab.pool, range(fab.pool.total_pages))))
        return trail
    both(case)


def test_loans_respect_lend_optout():
    def case(pkg):
        fab, a, b = _two_views(pkg)
        pkg.KVSwapManager(a, reserve_fraction=0.5, lend=False)
        pkg.KVSwapManager(b, reserve_pages={"host": 1})
        assert b.borrowable() == 0
        assert fab.request_loan(b, 4) == 0
        return _ledgers(fab)
    both(case)


def test_calibrate_ewma_tracks_measured_transfer_times():
    def case(pkg):
        fab = pkg.fabric(CFG, _doms(), page_size=4, seed=0,
                         calibration_alpha=0.5)
        view = fab.view("t", quota=(8, 8, 8), home=(0,))
        pages = []
        for _ in range(3):
            view.append_page(pages)
        analytic = view.stall_cost(pages)
        assert analytic == pytest.approx(pkg.bwmodel.stall_cost(
            view.footprint(pages), np.asarray([819.0, 50.0, 16.0])))
        measured = [10 * fab.pool.page_bytes / (bw * 1e9)
                    for bw in (819.0, 50.0, 16.0)]
        trail, prev = [analytic], analytic
        for _ in range(12):
            fab.calibrate(measured)
            cur = view.stall_cost(pages)
            assert cur >= prev - 1e-18
            prev = cur
            trail.append(cur)
        assert view.stall_cost(pages) == pytest.approx(10 * analytic,
                                                       rel=0.01)
        bw_before = fab.bw_effective.copy()
        fab.calibrate([None, measured[1], None])
        assert fab.bw_effective[0] == bw_before[0]
        assert fab.bw_effective[2] == bw_before[2]
        sw = pkg.KVSwapManager(view, reserve_fraction=0.2)
        secs = sw._transfer_seconds([1], [2])
        assert secs == pytest.approx(
            fab.pool.page_bytes / (fab.bw_effective[2] * 1e9), rel=1e-6)
        return trail, fab.bw_effective, secs
    both(case)


def test_occupancy_counts_reserved_pages_per_domain():
    def case(pkg):
        pool = pkg.pool(CFG, _doms(peer=20), page_size=4,
                        dwp_config=pkg.dwp.DWPConfig())
        pool.reserve_pages(1, 10)
        assert pool.occupancy()["hbm_peer"] == 0.0
        assert pool.used_pages()[1] == 0
        taken = [pool.free[1].pop() for _ in range(len(pool.free[1]))]
        assert pool.occupancy()["hbm_peer"] == 1.0
        assert pool.used_pages()[1] == len(taken)
        return taken, pool.occupancy(), pool.used_pages()
    both(case)


def test_trie_aware_admission_admits_shared_prefix_concurrently():
    smoke = smoke_pair()

    def case(pkg):
        cfg, params = smoke[pkg.port]
        ps = 4
        prefix = list(range(1, 1 + 8 * ps))

        def run(reuse: bool):
            pool = pkg.pool(CFG, _doms(fast=8, peer=4, host=4),
                            page_size=ps, dwp_config=pkg.dwp.DWPConfig())
            sched = pkg.sched.RequestScheduler(pool, max_batch=2,
                                               default_max_new=8,
                                               conservative_admission=True)
            eng = pkg.engine(cfg, params, pool, scheduler=sched,
                             wall_clock=False, sim_step_s=0.001,
                             prefix_reuse=reuse)
            eng.submit(prefix + [7, 7])
            eng.submit(prefix + [9, 9])
            peak = steps = 0
            trail = []
            while (eng.active or eng.waiting) and steps < 200:
                eng.step()
                steps += 1
                peak = max(peak, len(eng.scheduler.running))
                trail.append([(s.sid, list(s.pages)) for s in eng.active])
            assert len(eng.finished) == 2
            eng.view.fabric.check_invariants()
            return (peak, steps, pool.table.prefix_hit_pages, trail,
                    {s.sid: s.tokens for s in eng.finished}), \
                [pkg.host(pool.k_pool), pkg.host(pool.v_pool)]

        (on, kv_on), (off, kv_off) = run(True), run(False)
        assert on[0] == 2 and on[2] >= 8
        assert off[0] == 1
        assert on[1] < off[1]
        return (on, off), kv_on + kv_off
    both_close(case)
