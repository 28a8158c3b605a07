"""The port's multi-tenant domain arbiter (``repro_torch.placement.arbiter``)
against the reference's (``repro.placement.arbiter``): the arbiter cases of
``tests/test_placement.py`` on both packages with the same inputs (pin
selection into the persistence tier included), then
``fabric_compare`` (two tenants on one fabric vs isolated partitions;
``benchmarks/scheduler_bench.py`` against
``benchmarks/torch_scheduler_bench.py``) equal to the reference's live run
and to ``BENCH_fabric.json``'s counters."""

import json
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

import repro.placement.arbiter as r_arbiter  # noqa: E402
import repro_torch.placement.arbiter as t_arbiter  # noqa: E402
from _torch_parity import engines_of, smoke_pair, tokens_of  # noqa: E402
from benchmarks import scheduler_bench as r_bench  # noqa: E402
from benchmarks import torch_scheduler_bench as t_bench  # noqa: E402
from repro.core.dwp import DWPConfig as RDWPConfig  # noqa: E402
from repro_torch.core.dwp import DWPConfig as TDWPConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF = types.SimpleNamespace(arb=r_arbiter, dwp=RDWPConfig, port=False)
PORT = types.SimpleNamespace(arb=t_arbiter, dwp=TDWPConfig, port=True)


@pytest.fixture(scope="module")
def smoke():
    return smoke_pair()


def _arbiter(pkg):
    m = pkg.arb
    specs = [m.DomainSpec("hbm_local", 64, 819.0),
             m.DomainSpec("hbm_peer", 48, 50.0),
             m.DomainSpec("host", 64, 16.0)]
    return m.DomainArbiter(specs, page_size=4,
                           **({"device": "cpu"} if pkg.port else {}))


def _both(fn):
    return fn(REF), fn(PORT)


def test_arbiter_partitions_capacity_and_homes(smoke):
    def run(pkg):
        cfg = smoke[pkg.port][0]
        arb = _arbiter(pkg)
        a = arb.register("A", cfg, priority=pkg.arb.Priority.HIGH,
                         share=0.5)
        b = arb.register("B", cfg, priority=pkg.arb.Priority.BEST_EFFORT,
                         share=0.5)
        assert a.view.pool is b.view.pool
        np.testing.assert_array_equal(a.view.quota, a.quotas)
        stats = arb.stats()
        return (a.quotas.tolist(), b.quotas.tolist(), arb.free.tolist(),
                a.home, b.home, a.cotuner is None, b.cotuner is not None,
                a.view.capacity(), a.view.free_count(), stats)
    ref, port = _both(run)
    assert port == ref
    qa, qb, free, home_a, home_b, *_ = port
    assert (np.add(qa, qb) <= [64, 48, 64]).all() and min(free) >= 0
    assert (home_a, home_b) == ((0,), (1,))


def test_arbiter_runs_two_stage_search_from_latency_streams(smoke):
    def run(pkg):
        cfg = smoke[pkg.port][0]
        arb = _arbiter(pkg)
        arb.register("A", cfg, priority=pkg.arb.Priority.HIGH, share=0.4)
        b = arb.register("B", cfg, priority=pkg.arb.Priority.BEST_EFFORT,
                         share=0.4, dwp_config=pkg.dwp(n=2, c=0))
        trail = []
        for _ in range(200):
            if b.cotuner.done:
                break
            d = b.dwp
            arb.observe("A", max(1.0 - 2 * d, 0.6))
            trail.append((d, arb.observe("B", (d - 0.1) ** 2 + 1.0)))
        return (trail, b.cotuner.done, b.cotuner.dwp_lower_bound, b.dwp,
                arb.interference("A"), arb.interference("B"))
    ref, port = _both(run)
    assert port == ref
    _, done, bound, dwp, *_ = port
    assert done and bound >= 0.2 - 1e-9 and dwp >= bound - 1e-9


def test_arbiter_observe_rehomes_view_sequences(smoke):
    def run(pkg):
        cfg = smoke[pkg.port][0]
        arb = _arbiter(pkg)
        arb.register("A", cfg, priority=pkg.arb.Priority.HIGH, share=0.4)
        b = arb.register("B", cfg, priority=pkg.arb.Priority.BEST_EFFORT,
                         share=0.4, dwp_config=pkg.dwp(n=2, c=0))
        seq = types.SimpleNamespace(pages=[])
        for _ in range(6):
            b.view.append_page(seq.pages)
        b.view.on_assignment_change(
            lambda: setattr(seq, "pages", b.view.migrate(seq.pages)))
        moved_any, pages = False, []
        for _ in range(40):
            arb.observe("A", 1.0 - 0.5 * b.dwp)
            moved_any |= arb.observe("B", 1.0)
            pages.append(list(seq.pages))
            if b.dwp >= 0.5:
                break
        arb.fabric.check_invariants()
        b.view.release(seq.pages)
        arb.fabric.check_invariants()
        grants = arb.unregister("A")
        return (moved_any, pages, {k: v.tolist() for k, v in grants.items()},
                arb.free.tolist(), b.quotas.tolist())
    ref, port = _both(run)
    assert port == ref
    assert port[0]


def test_arbiter_pins_hottest_preambles(smoke):
    """Pin selection ranks cross-tenant chains by refcount × heat and pins
    the winners into the persistence tier; re-selection refreshes the LRU
    stamp instead of duplicating pins."""
    def run(pkg):
        if pkg.port:
            from repro_torch.obs.observatory import Observatory
            from repro_torch.placement.persist import PersistentTier
        else:
            from repro.obs.observatory import Observatory
            from repro.placement.persist import PersistentTier
        cfg = smoke[pkg.port][0]
        arb = _arbiter(pkg)
        a = arb.register("A", cfg, priority=pkg.arb.Priority.HIGH,
                         share=0.4)
        b = arb.register("B", cfg, priority=pkg.arb.Priority.BEST_EFFORT,
                         share=0.4)
        tier = PersistentTier(capacity_pages=64)
        arb.fabric.attach_persist(tier)
        obs = Observatory(arb.fabric, tracer=False, drift=False)

        def chain(toks):
            pages = []
            for _ in range(len(toks) // 4):
                a.view.append_page(pages)
            a.view.register_prefix(list(toks), pages, len(toks))
            return pages

        cold = chain(list(range(100, 108)))   # cross-tenant shared, cool
        hot = chain(list(range(200, 208)))    # cross-tenant shared, hot
        private = chain(list(range(300, 308)))    # only tenant A: ref 1
        for toks in (list(range(100, 108)), list(range(200, 208))):
            got = []
            assert b.view.probe_prefix(toks, got) == 8   # B shares
        for _ in range(5):
            obs.heat.touch(hot)
        keys = arb.pin_hot_preambles(top_k=1, min_ref=2)
        assert len(keys) == 1 and keys[0] in tier._pins
        assert tier.pinned_pages() == set(hot)  # heat broke the ref tie
        assert not (set(private) & tier.pinned_pages())
        stamp0 = tier._pins[keys[0]]["stamp"]
        assert arb.pin_hot_preambles(top_k=1, min_ref=2) == keys
        assert tier._pins[keys[0]]["stamp"] > stamp0   # touched
        keys2 = arb.pin_hot_preambles(top_k=3, min_ref=2)
        assert tier.pinned_pages() == set(hot) | set(cold)
        assert len(keys2) == 2
        arb.fabric.check_invariants()
        return keys, keys2, sorted(tier.pinned_pages()), tier.stats()
    ref, port = _both(run)
    assert port == ref


def test_fabric_compare_equals_the_reference_and_bench_fabric_json(smoke):
    with engines_of(r_bench) as r_engines:
        ref = r_bench.fabric_compare()
    with engines_of(t_bench) as t_engines:
        port = t_bench.fabric_compare(params=smoke[True][1],
                                      device="cpu")
    assert len(t_engines) == len(r_engines) == 4
    assert tokens_of(t_engines) == tokens_of(r_engines)
    assert port == ref                      # every counter, exactly
    bench = json.loads((ROOT / "BENCH_fabric.json").read_text())
    for run in ("fabric", "isolated"):
        for k in ("steps", "a_finished", "b_finished", "b_preemptions",
                  "peak_cross_shared_pages", "loans_granted",
                  "loans_reclaimed"):
            assert port[run][k] == bench[run][k], (run, k)
    assert (port["fabric"]["loans_granted"],
            port["fabric"]["peak_cross_shared_pages"]) == (6, 64)
