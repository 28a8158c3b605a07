"""``tests/test_scheduler.py``'s cases on both packages: workload kinds and
shared prefixes, the SLO tracker, the swap manager (exact round trip,
placement by policy, unreserve), the chunked-prefill budget, priority
preemption, an oversubscribed run, infeasible submits, joint exhaustion,
stall preemption, swap-aware DWP, preempted decode against an unpressured
run, forced preemption at decode steps 0, 2 and 5, and fabric views as
priority classes.

Each case runs the reference's assertions on each package and returns a
record (traces, SLO summaries, page ids, free lists, refcounts, scheduler
queues, swap counters, tokens, pool bits where the test wrote them) that
must be equal on both (``_torch_parity.both``); where the model wrote the
K/V, the bytes are held within 2e-5 (``both_close``: the two packages'
fp32 arithmetic rounds differently) and everything else exactly. Engines
run the one-layer fp32 smoke qwen2 on both sides.

``test_swap_random_interleavings_preserve_kv`` is not held again here:
``test_torch_swap.py`` pins the port to its invariants and to the
reference's failure on over-capacity footprints."""

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import (both, both_close, smoke_pair,  # noqa: E402
                          table_state)
from repro.configs import registry  # noqa: E402

CFG = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                          num_layers=1, compute_dtype="float32")


@pytest.fixture(scope="module")
def smoke():
    return smoke_pair()


def _pool(pkg, fast=8, peer=8, host=60, page_size=4, n=100):
    return pkg.pool(CFG, (("hbm_local", fast, 819.0, True),
                          ("hbm_peer", peer, 0.05, False),
                          ("host", host, 0.016, False)),
                    page_size=page_size,
                    dwp_config=pkg.dwp.DWPConfig(n=n, c=1))


def _drain(eng, max_steps=500):
    steps = 0
    while (eng.active or eng.waiting) and steps < max_steps:
        eng.step()
        steps += 1
    return steps


def _trace(trace) -> list:
    return [dataclasses.astuple(r) for r in trace]


def _pool_state(pkg, pool) -> dict:
    return table_state(pool) | {
        "reserved": pool.reserved.tolist(),
        "swaps": (pool.telemetry.swap_outs, pool.telemetry.swap_ins)}


def _run_record(pkg, eng, pool):
    """(exact record, K/V arrays) of a drained engine."""
    return ({"tokens": {s.sid: list(s.tokens) for s in eng.finished},
             "classes": {s.sid: s.cls for s in eng.finished},
             "clock": eng.scheduler.now, "decode_steps": eng.decode_steps,
             "pool": _pool_state(pkg, pool)},
            [pkg.host(pool.k_pool), pkg.host(pool.v_pool)])


# ---------------------------------------------------------------------------
# workload generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["poisson", "bursty", "heavy_tail"])
def test_workload_deterministic_and_bounded(kind):
    def case(pkg):
        s = pkg.sched
        spec = s.WorkloadSpec(kind=kind, num_requests=40, prompt_mean=10,
                              prompt_max=32, vocab_size=500, seed=3,
                              class_mix=(("a", 0.5), ("b", 0.5)))
        t1, t2 = s.generate(spec), s.generate(spec)
        assert t1 == t2
        assert t1 != s.generate(dataclasses.replace(spec, seed=4))
        arr = [r.arrival_s for r in t1]
        assert arr == sorted(arr) and arr[0] >= 0
        for r in t1:
            assert 1 <= len(r.prompt) <= 32
            assert all(1 <= t < 500 for t in r.prompt)
            assert r.cls in ("a", "b")
        pages = s.total_kv_pages(t1, 4)
        assert pages == sum(-(-(len(r.prompt) + r.max_new) // 4)
                            for r in t1)
        return _trace(t1), pages
    both(case)


def test_workload_kind_shapes():
    def case(pkg):
        s = pkg.sched
        n, mean = 200, 0.1
        bursty = s.generate(s.WorkloadSpec(kind="bursty", num_requests=n,
                                           mean_interarrival_s=mean, seed=0,
                                           burst_len=4, burst_factor=8.0))
        gaps = np.diff([0.0] + [r.arrival_s for r in bursty])
        assert np.percentile(gaps, 50) < mean
        assert gaps.max() > 2 * mean
        heavy = s.generate(s.WorkloadSpec(kind="heavy_tail", num_requests=n,
                                          prompt_mean=8, prompt_max=64,
                                          seed=0))
        lens = np.asarray([len(r.prompt) for r in heavy])
        assert lens.max() > 4 * np.percentile(lens, 50)
        return _trace(bursty), _trace(heavy)
    both(case)


def test_workload_shared_prefixes():
    def case(pkg):
        s = pkg.sched
        spec = s.WorkloadSpec(kind="heavy_tail", num_requests=40,
                              prompt_mean=6, prompt_max=24, vocab_size=500,
                              seed=2, prefix_len=12, prefix_groups=2,
                              prefix_frac=0.8)
        t1 = s.generate(spec)
        assert t1 == s.generate(spec)
        heads: dict = {}
        for r in t1:
            heads[r.prompt[:12]] = heads.get(r.prompt[:12], 0) + 1
        shared = sorted(heads.values(), reverse=True)[:2]
        assert sum(shared) >= 0.5 * len(t1)
        assert len([h for h, c in heads.items() if c > 1]) <= 2
        base = s.WorkloadSpec(kind="heavy_tail", num_requests=8, seed=3)
        assert s.generate(base) == s.generate(dataclasses.replace(
            base, prefix_groups=4, prefix_frac=0.5))
        return _trace(t1), sorted(heads.items())
    both(case)


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------

def test_slo_tracker_deadlines_and_goodput():
    def case(pkg):
        s = pkg.sched
        tr = s.SloTracker({"fast": s.SloSpec(ttft_s=1.0, tpot_s=0.5),
                           "free": s.SloSpec()})
        tr.on_submit(0, "fast", arrival_s=0.0)
        tr.on_first_token(0, now=0.5)
        tr.on_finish(0, now=2.0, produced=4)
        tr.on_submit(1, "fast", arrival_s=0.0)
        tr.on_first_token(1, now=3.0)
        tr.on_finish(1, now=4.0, produced=2)
        tr.on_submit(2, "free", arrival_s=0.0)
        tr.on_first_token(2, now=9.0)
        tr.on_finish(2, now=10.0, produced=3)
        summ = tr.summary(now=10.0)
        fast = summ["classes"]["fast"]
        assert fast["completed"] == 2 and fast["good"] == 1
        assert math.isclose(fast["ttft_mean_s"], (0.5 + 3.0) / 2)
        assert summ["classes"]["free"]["good"] == 1
        assert summ["good_tokens"] == 4 + 3
        assert math.isclose(summ["goodput_tok_s"], 7 / 10.0)
        assert tr.counters.get("fast", "ttft_missed") == 1
        assert tr.counters.get("fast", "goodput_tokens") == 4
        return summ, tr.counters.snapshot()
    both(case)


# ---------------------------------------------------------------------------
# swap manager: reservation, placement, exact round-trips
# ---------------------------------------------------------------------------

def test_swap_roundtrip_preserves_exact_kv():
    def case(pkg):
        pool = _pool(pkg, fast=8, peer=8, host=16)
        swap = pkg.KVSwapManager(pool, reserve_fraction=0.5)
        reserved = swap.reserved_total
        assert reserved > 0
        assert pool.free_count() + reserved == pool.total_pages
        pages = [pool.alloc_page() for _ in range(5)]
        rng = np.random.default_rng(0)
        shape = tuple(pool.k_pool.shape[2:])
        for p in pages:
            pkg.put(pool, [p], rng.normal(size=shape).astype(np.float32))
            pkg.put(pool, [p], rng.normal(size=shape).astype(np.float32),
                    "v")
        k_ref, v_ref = pkg.kv(pool, pages)
        free_before = pool.free_count()
        parked, secs_out = swap.swap_out(list(pages))
        assert secs_out > 0
        assert pool.free_count() == free_before + len(pages)
        for p in parked:
            assert pool.domain_of(p) in pool.slow_domains
        k, v = pkg.kv(pool, parked)
        assert np.array_equal(k, k_ref) and np.array_equal(v, v_ref)
        back, secs_in = swap.swap_in(parked)
        assert secs_in > 0
        assert swap.slots_free() == reserved
        k, v = pkg.kv(pool, back)
        assert np.array_equal(k, k_ref) and np.array_equal(v, v_ref)
        tel = pool.telemetry.snapshot()
        assert tel["swap_outs"] == 5 and tel["swap_ins"] == 5
        return (pages, parked, back, secs_out, secs_in, _pool_state(pkg, pool),
                pkg.kv(pool, range(pool.total_pages)))
    both(case)


def test_swap_placement_follows_policy():
    def case(pkg):
        bwap = pkg.KVSwapManager(_pool(pkg, fast=4, peer=24, host=24),
                                 placement="bwap_canonical",
                                 reserve_fraction=0.9)
        counts = bwap._slot_counts(20)
        assert counts.sum() == 20
        assert counts[0] > 2 * counts[1]
        lf = pkg.KVSwapManager(_pool(pkg, fast=4, peer=24, host=24),
                               placement="local_first",
                               reserve_fraction=0.9)
        counts2 = lf._slot_counts(10)
        assert counts2[0] == 10 and counts2[1] == 0
        return counts, counts2
    both(case)


def test_unreserve_returns_slots_to_allocator():
    def case(pkg):
        pool = _pool(pkg, fast=8, peer=8, host=8)
        swap = pkg.KVSwapManager(pool, reserve_fraction=1.0)
        assert swap.reserved_total == 16
        view = swap.view
        free_before = view.free_count()
        give_back = [swap.slots[1].pop() for _ in range(4)]
        for pid in give_back:
            view.unreserve(pid)
        swap.reserved_total -= 4
        assert view.free_count() == free_before + 4
        assert int(pool.reserved.sum()) == 12
        assert swap.slots_free() == 12
        assert swap.can_swap_out(12) and not swap.can_swap_out(13)
        assert swap._slot_counts(12).sum() == 12
        return give_back, _pool_state(pkg, pool), swap._slot_counts(12)
    both(case)


# ---------------------------------------------------------------------------
# scheduler: chunked prefill, priority, capacity preemption
# ---------------------------------------------------------------------------

def test_chunked_prefill_respects_token_budget():
    def case(pkg):
        pool = _pool(pkg, fast=32, peer=8, host=8)
        pool.table.prefix_reuse = False
        sched = pkg.sched.RequestScheduler(pool, max_batch=4,
                                           prefill_token_budget=5,
                                           default_max_new=4)
        sched.submit(list(range(1, 18)))
        sched.submit(list(range(1, 8)))
        seen, chunks = [], []
        for _ in range(10):
            plan = sched.schedule()
            total = sum(hi - lo for _, lo, hi in plan.prefill_chunks)
            assert total <= 5
            seen.append(total)
            chunks.append([(r.sid, lo, hi, list(r.pages))
                           for r, lo, hi in plan.prefill_chunks])
            for r, lo, hi in plan.prefill_chunks:
                r.length = hi
            if not sched.queued and not sched.prefilling:
                break
        assert sum(seen) == 16 + 6
        assert len(sched.running) == 2
        return seen, chunks
    both(case)


def test_priority_class_preempts_lower(smoke):
    def case(pkg):
        cfg, params = smoke[pkg.port]
        s = pkg.sched
        pool = _pool(pkg, fast=8, peer=8, host=60)
        swap = pkg.KVSwapManager(pool, reserve_fraction=0.9)
        sched = s.RequestScheduler(
            pool, max_batch=4, prefill_token_budget=64,
            classes=[s.PriorityClass("hi", 5, s.SloSpec(1.0, 1.0)),
                     s.PriorityClass("lo", 0)],
            default_class="lo", default_max_new=6, swap=swap)
        eng = pkg.engine(cfg, params, pool, scheduler=sched,
                         wall_clock=False, sim_step_s=0.01)
        rng = np.random.default_rng(0)
        for _ in range(4):
            eng.submit(rng.integers(1, CFG.vocab_size, 10).tolist(),
                       cls="lo")
        eng.step()
        assert len(sched.running) == 4
        eng.submit(rng.integers(1, CFG.vocab_size, 10).tolist(), cls="hi")
        eng.step()
        assert any(r.cls == "hi" for r in sched.running)
        assert len(sched.swapped) >= 1
        assert all(r.cls == "lo" for r in sched.swapped)
        swapped = [(r.sid, list(r.pages)) for r in sched.swapped]
        _drain(eng)
        assert len(eng.finished) == 5
        eng.view.fabric.check_invariants()
        slo = pool.telemetry.snapshot()["slo"]
        assert slo["lo"]["preemptions"] >= 1
        assert slo["hi"]["preemptions"] == 0
        assert slo["hi"]["swap_out_pages"] == 0
        rec, kv = _run_record(pkg, eng, pool)
        return (rec, swapped, slo), kv
    both_close(case)


def test_oversubscribed_completes_with_zero_failures(smoke):
    def case(pkg):
        cfg, params = smoke[pkg.port]
        s = pkg.sched
        pool = _pool(pkg, fast=10, peer=10, host=50)
        swap = pkg.KVSwapManager(pool, reserve_fraction=0.9)
        sched = s.RequestScheduler(pool, max_batch=6,
                                   prefill_token_budget=24,
                                   default_max_new=8, swap=swap)
        eng = pkg.engine(cfg, params, pool, scheduler=sched,
                         wall_clock=False, sim_step_s=0.01)
        trace = s.generate(s.WorkloadSpec(
            kind="bursty", num_requests=12, mean_interarrival_s=0.005,
            prompt_mean=12, prompt_max=20, max_new=8,
            vocab_size=CFG.vocab_size, seed=1))
        assert s.total_kv_pages(trace, pool.page_size) > 10
        for t in trace:
            eng.submit(t.prompt, max_new=t.max_new, arrival_s=t.arrival_s)
        _drain(eng)
        assert len(eng.finished) == len(trace)
        assert all(r.produced == r.max_new for r in eng.finished)
        assert pool.telemetry.swap_outs > 0
        assert pool.telemetry.swap_outs == pool.telemetry.swap_ins
        assert pool.free_count() + swap.reserved_total == pool.total_pages
        assert swap.slots_free() == swap.reserved_total
        eng.view.fabric.check_invariants()
        rec, kv = _run_record(pkg, eng, pool)
        return (rec, _trace(trace)), kv
    both_close(case)


def test_infeasible_request_rejected_at_submit():
    def case(pkg):
        s = pkg.sched
        sched = s.RequestScheduler(_pool(pkg, fast=2, peer=1, host=1),
                                   max_batch=2, default_max_new=4)
        with pytest.raises(ValueError, match="allocatable") as e1:
            sched.submit(list(range(1, 40)))
        pool2 = _pool(pkg, fast=4, peer=8, host=8)
        swap = pkg.KVSwapManager(pool2, reserve_fraction=1.0)
        sched2 = s.RequestScheduler(pool2, max_batch=2, default_max_new=4,
                                    swap=swap)
        assert sched2.allocatable_pages() == 4
        with pytest.raises(ValueError, match="allocatable") as e2:
            sched2.submit(list(range(1, 20)))
        return str(e1.value), str(e2.value), sched2.allocatable_pages()
    both(case)


def test_joint_exhaustion_raises_not_spins():
    def case(pkg):
        pool = _pool(pkg, fast=4, peer=2, host=2)
        sched = pkg.sched.RequestScheduler(pool, max_batch=2,
                                           prefill_token_budget=6,
                                           default_max_new=20)
        sched.submit(list(range(1, 14)))
        sched.submit(list(range(1, 14)))
        steps = []
        with pytest.raises(RuntimeError, match="exhausted|grow") as e:
            for _ in range(60):
                plan = sched.schedule()
                steps.append([(r.sid, r.length, list(r.pages))
                              for r in plan.batch])
                for r in plan.batch:
                    if r.length % pool.page_size == 0:
                        r.pages.append(pool.alloc_page())
                    r.tokens.append(1)
                    r.length += 1
        return steps, str(e.value)
    both(case)


def test_stall_preemption_evicts_read_time_hog():
    def case(pkg):
        def setup(frac):
            pool = _pool(pkg, fast=16, peer=12, host=12)
            swap = pkg.KVSwapManager(pool, reserve_fraction=0.8)
            sched = pkg.sched.RequestScheduler(
                pool, max_batch=4, prefill_token_budget=64,
                default_max_new=8, swap=swap, stall_preempt_fraction=frac,
                stall_preempt_cooldown_s=10.0)
            sched.submit([1, 2, 3, 4, 5])
            sched.submit([6, 7, 8, 9, 10])
            plan = sched.schedule()
            for r, lo, hi in plan.prefill_chunks:
                r.length = hi
            hog, other = sched.running
            new = [pool.free[2].pop() for _ in hog.pages]
            for old, n in zip(hog.pages, new):
                pool.free[pool.domain_of(old)].append(old)
                pool.table.remap_physical(old, n)
            hog.pages[:] = new
            return pool, sched, hog, other

        pool, sched, hog, other = setup(0.5)
        sched.schedule()
        assert hog in sched.swapped
        assert other in sched.running
        assert hog.resume_after > sched.now
        parked = list(hog.pages)
        sched.schedule()
        assert hog in sched.swapped
        pool2, sched2, hog2, _ = setup(None)
        sched2.schedule()
        assert hog2 in sched2.running
        return (parked, hog.resume_after, sched.now, _pool_state(pkg, pool),
                list(hog2.pages), _pool_state(pkg, pool2))
    both(case)


def test_swap_aware_dwp_respects_reservation():
    def case(pkg):
        pool = _pool(pkg, fast=8, peer=8, host=8, n=4)
        assert pool.tuner.capacity_fractions is None
        swap = pkg.KVSwapManager(pool, reserve_fraction=1.0)
        assert swap.reserved_total == 16
        np.testing.assert_array_equal(pool.reserved, [0, 8, 8])
        np.testing.assert_array_equal(pool._ctx(0.0).capacities, [8, 0, 0])
        assert set(int(d) for d in pool.tuner.assignment) == {0}
        pool2 = _pool(pkg, fast=8, peer=8, host=8, n=4)
        pkg.KVSwapManager(pool2, reserve_pages={"hbm_peer": 6})
        np.testing.assert_array_equal(pool2.reserved, [0, 6, 0])
        np.testing.assert_array_equal(pool2._ctx(0.0).capacities, [8, 2, 8])
        frac = pool2.tuner.capacity_fractions
        assert frac is not None and frac[1] == pytest.approx(2 / 18)
        assert np.isinf(frac[0]) and np.isinf(frac[2])
        return (pool.tuner.assignment, pool2.tuner.assignment, frac,
                _pool_state(pkg, pool), _pool_state(pkg, pool2))
    both(case)


# ---------------------------------------------------------------------------
# preemption round-trip: decode must be bit-exact
# ---------------------------------------------------------------------------

def test_preempted_decode_matches_unpressured_reference(smoke):
    def case(pkg):
        cfg, params = smoke[pkg.port]
        s = pkg.sched
        rng = np.random.default_rng(7)
        prompts = [rng.integers(1, CFG.vocab_size, int(n)).tolist()
                   for n in (9, 14, 5, 11, 7, 13)]

        def run(pressured):
            if pressured:
                pool = _pool(pkg, fast=8, peer=8, host=60)
                swap = pkg.KVSwapManager(pool, reserve_fraction=0.85)
                sched = s.RequestScheduler(pool, max_batch=6,
                                           prefill_token_budget=7,
                                           default_max_new=8, swap=swap)
            else:
                pool = _pool(pkg, fast=64, peer=16, host=16)
                sched = s.RequestScheduler(pool, max_batch=6,
                                           prefill_token_budget=256,
                                           default_max_new=8)
            eng = pkg.engine(cfg, params, pool, scheduler=sched,
                             wall_clock=False)
            for p in prompts:
                eng.submit(list(p))
            _drain(eng)
            assert len(eng.finished) == len(prompts)
            eng.view.fabric.check_invariants()
            return _run_record(pkg, eng, pool)

        (want, kv_w), (got, kv_g) = run(False), run(True)
        assert got["pool"]["swaps"][0] > 0
        assert got["tokens"] == want["tokens"]
        return (want, got), kv_w + kv_g
    both_close(case)


_UNPRESSURED: dict = {}


@pytest.mark.parametrize("preempt_step", [0, 2, 5])
def test_forced_preemption_at_point_is_exact(smoke, preempt_step):
    prompt, max_new = [3, 17, 29, 5, 41, 11], 8

    def reference(pkg):
        """The unpressured run's tokens (the same for every step: made
        once a package)."""
        if pkg.port not in _UNPRESSURED:
            cfg, params = smoke[pkg.port]
            eng = pkg.engine(cfg, params, _pool(pkg, fast=64, peer=8, host=8),
                             max_batch=1, max_new=max_new)
            eng.submit(list(prompt))
            _drain(eng)
            _UNPRESSURED[pkg.port] = list(eng.finished[0].tokens)
        return _UNPRESSURED[pkg.port]

    def case(pkg):
        cfg, params = smoke[pkg.port]
        pool = _pool(pkg, fast=16, peer=8, host=40)
        swap = pkg.KVSwapManager(pool, reserve_fraction=0.8)
        sched = pkg.sched.RequestScheduler(pool, max_batch=1,
                                           prefill_token_budget=64,
                                           default_max_new=max_new,
                                           swap=swap)
        eng = pkg.engine(cfg, params, pool, scheduler=sched,
                         wall_clock=False)
        eng.submit(list(prompt))
        for _ in range(preempt_step + 1):
            eng.step()
        victim = sched.running[0]
        before = list(victim.pages)
        sched._swap_out(victim)
        assert victim.state is pkg.sched.State.SWAPPED
        parked = list(victim.pages)
        _drain(eng)
        assert len(eng.finished) == 1
        assert eng.finished[0].tokens == reference(pkg)
        eng.view.fabric.check_invariants()
        rec, kv = _run_record(pkg, eng, pool)
        return (rec, before, parked), kv
    both_close(case)


# ---------------------------------------------------------------------------
# arbiter integration: tenants as priority classes
# ---------------------------------------------------------------------------

def test_fabric_views_register_tenants_as_priority_classes(smoke):
    def case(pkg):
        cfg, params = smoke[pkg.port]
        s, m = pkg.sched, pkg.arbiter
        arb = m.DomainArbiter([m.DomainSpec("hbm_local", 48, 819.0),
                               m.DomainSpec("hbm_peer", 32, 0.05),
                               m.DomainSpec("host", 64, 0.016)],
                              page_size=4,
                              **({"device": "cpu"} if pkg.port else {}))
        ta = arb.register("prod", cfg, priority=m.Priority.HIGH, share=0.5)
        tb = arb.register("bulk", cfg, priority=m.Priority.BEST_EFFORT,
                          share=0.5)
        sched_a = s.RequestScheduler(
            ta.view, max_batch=2, default_max_new=4,
            classes=[s.PriorityClass("prod", 0,
                                     s.SloSpec(ttft_s=0.5, tpot_s=0.1))])
        eng_a = pkg.engine(cfg, params, ta.view, scheduler=sched_a)
        eng_b = pkg.engine(cfg, params, tb.view, max_batch=2, max_new=4)
        assert eng_a.scheduler.classes["prod"].level \
            > eng_b.scheduler.classes["bulk"].level
        assert eng_a.scheduler.default_class == "prod"
        assert eng_a.scheduler.classes["prod"].slo.ttft_s == 0.5
        assert eng_a.scheduler.slo.specs["prod"].tpot_s == 0.1
        eng_a.submit([5, 9, 2])
        eng_b.submit([7, 1, 8])
        _drain(eng_a)
        _drain(eng_b)
        assert eng_a.finished[0].cls == "prod"
        assert eng_b.finished[0].cls == "bulk"
        snap = ta.view.snapshot()
        assert sorted(snap.get("slo", {})) == ["bulk", "prod"]
        arb.fabric.check_invariants()
        return ({n: (c.level, c.slo.ttft_s, c.slo.tpot_s)
                 for e in (eng_a, eng_b)
                 for n, c in e.scheduler.classes.items()},
                eng_a.finished[0].tokens, eng_b.finished[0].tokens,
                sorted(snap["slo"]))
    both(case)
