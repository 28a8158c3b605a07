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
