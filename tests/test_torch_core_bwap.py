"""``tests/test_core_bwap.py``'s cases on both packages: the Machine A/B
topologies and their asymmetry ratios, the Eq.-2/5 closed form, the
water-filling contention model, the canonical tuner (symmetry dedup, the
install round trip), the DWP tuner and the two-stage co-scheduled tuner,
and the simulator's headline results (BWAP beats uniform-workers and
first-touch on Machine A; gains shrink with more workers). Each case runs
the reference's assertions on each package (``_torch_parity.both``) and
returns a record of weights, grants, tuner trajectories and run times that
must be equal: the core is numpy on both sides, so they are equal exactly.
"""

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import both  # noqa: E402


def _machine(pkg, name):
    t = getattr(pkg.topology, name)()
    t.validate()
    return t


# -- topology reconstruction matches the paper's stated ratios --------------

def test_machine_a_asymmetry_ratios():
    def case(pkg):
        m = _machine(pkg, "machine_a")
        local = m.bw.diagonal().max()
        off = m.bw[~np.eye(8, dtype=bool)]
        assert local / off.min() == pytest.approx(5.8, rel=0.02)
        assert local / off.max() == pytest.approx(1.7, rel=0.05)
        assert (np.abs(m.bw - m.bw.T) > 1e-6).any()
        return m.bw, m.mc_bw, local / off.min(), local / off.max()
    both(case)


def test_machine_b_asymmetry_ratios():
    def case(pkg):
        m = _machine(pkg, "machine_b")
        local = m.bw.diagonal().max()
        off = m.bw[~np.eye(4, dtype=bool)]
        assert local / off.min() == pytest.approx(2.3, rel=0.02)
        assert local / off.max() == pytest.approx(1.8, rel=0.05)
        return m.bw, m.mc_bw, local / off.min(), local / off.max()
    both(case)


# -- Eq. 2/5 closed form ------------------------------------------------------

PROF = np.array([[10.0], [5.0], [2.5], [2.0]])


def test_optimal_weights_equalize_transfer_times():
    def case(pkg):
        w = pkg.bwmodel.optimal_weights(PROF)
        times = w / PROF[:, 0]
        np.testing.assert_allclose(times, times[0])
        return w, times
    both(case)


def test_optimal_weights_beat_uniform_in_model():
    def case(pkg):
        bw = pkg.bwmodel
        w_opt = bw.optimal_weights(PROF)
        t_opt = bw.transfer_time(1.0, w_opt, PROF)
        t_uni = bw.transfer_time(1.0, np.full(4, 0.25), PROF)
        assert t_opt < t_uni
        return t_opt, t_uni
    both(case)


def test_multiworker_uses_minbw():
    def case(pkg):
        prof = np.array([[10.0, 2.0], [5.0, 5.0]])
        m = pkg.bwmodel.minbw(prof)
        np.testing.assert_allclose(m, [2.0, 5.0])
        w = pkg.bwmodel.optimal_weights(prof)
        np.testing.assert_allclose(w, [2 / 7, 5 / 7])
        return m, w
    both(case)


# -- contention model ---------------------------------------------------------

def _grants(pkg, demands):
    bw = pkg.bwmodel
    m = _machine(pkg, "machine_a")
    g = bw.effective_bandwidth(m, [bw.Demand(*d) for d in demands])
    return m, g


def test_waterfill_respects_path_caps():
    def case(pkg):
        m, g = _grants(pkg, [(0, 1, 1e9), (1, 1, 1e9)])
        assert g[(0, 1)] <= m.bw[0, 1] + 1e-9
        assert g[(1, 1)] <= m.bw[1, 1] + 1e-9
        return sorted(g.items())
    both(case)


def test_waterfill_respects_controller_cap():
    def case(pkg):
        m, g = _grants(pkg, [(0, dst, 1e9) for dst in range(8)])
        assert sum(g.values()) <= m.mc_bw[0] + 1e-6
        return sorted(g.items())
    both(case)


def test_waterfill_fair_share_under_contention():
    def case(pkg):
        _, g = _grants(pkg, [(0, 0, 1e9), (0, 1, 1e9)])
        assert g[(0, 0)] >= g[(0, 1)]
        return sorted(g.items())
    both(case)


# -- canonical tuner ----------------------------------------------------------

def test_canonical_weights_sum_to_one_and_favour_fast_nodes():
    def case(pkg):
        tuner = pkg.canonical.CanonicalTuner(_machine(pkg, "machine_a"))
        e = tuner.weights_for([0, 1])
        assert e.weights.sum() == pytest.approx(1.0)
        assert (e.weights > 0).all()
        assert e.weights[0] >= e.weights.max() * 0.5
        assert e.weights.std() > 0.01
        return e.weights, tuple(e.workers)
    both(case)


def test_canonical_symmetry_dedup():
    def case(pkg):
        tuner = pkg.canonical.CanonicalTuner(_machine(pkg, "machine_b"))
        sets = tuner.plausible_worker_sets(max_size=2)
        assert (0,) in sets
        assert (2,) not in sets
        assert (0, 1) in sets and (2, 3) not in sets
        return [tuple(s) for s in sets]
    both(case)


def test_canonical_install_roundtrip(tmp_path):
    def case(pkg):
        tuner = pkg.canonical.CanonicalTuner(_machine(pkg, "machine_b"))
        path = tmp_path / f"weights_{pkg.port}.json"
        n = tuner.install(path, max_size=2)
        assert n >= 2
        loaded = pkg.canonical.CanonicalTuner.load(path)
        for ws, w in loaded.items():
            np.testing.assert_allclose(w, tuner.weights_for(ws).weights)
        return n, sorted((tuple(ws), w) for ws, w in loaded.items()), \
            path.read_bytes()
    both(case)


# -- DWP tuner ----------------------------------------------------------------

def _drive(tuner, stall_of_dwp, max_periods=50):
    periods = 0
    while not tuner.done and periods < max_periods:
        for _ in range(tuner.cfg.n):
            tuner.record(stall_of_dwp(tuner.dwp))
        periods += 1
    return tuner


def _trajectory(t) -> list:
    return [(s.dwp, s.stall_rate, s.migrated_pages) for s in t.history]


CANON4 = np.asarray([3.0, 2, 1, 1])


def test_dwp_tuner_finds_convex_optimum():
    def case(pkg):
        rng = np.random.default_rng(0)
        canon = pkg.interleave.normalize(CANON4)

        def stall(d):
            return (d - 0.3) ** 2 + 1.0 + rng.normal(0, 1e-4)

        t = pkg.dwp.DWPTuner(canon, workers=[0, 1], num_pages=2048)
        _drive(t, stall)
        assert t.done
        assert abs(t.dwp - 0.3) <= t.cfg.x + 1e-9
        return t.dwp, _trajectory(t), t.assignment
    both(case)


def _monotone(pkg, stall, want):
    canon = pkg.interleave.normalize(CANON4)
    t = pkg.dwp.DWPTuner(canon, workers=[0, 1], num_pages=1024)
    _drive(t, stall)
    assert t.done and t.dwp == pytest.approx(want)
    return t.dwp, _trajectory(t), t.assignment


def test_dwp_tuner_monotone_decreasing_goes_to_one():
    both(_monotone, lambda d: 2.0 - d, 1.0)


def test_dwp_tuner_stays_at_zero_when_increase_hurts():
    both(_monotone, lambda d: 1.0 + d, 0.0)


def test_dwp_tuner_migrations_preserve_fractions():
    def case(pkg):
        il = pkg.interleave
        canon = il.normalize(np.asarray([5.0, 3, 2, 1, 1, 1, 1, 1]))
        moved = []
        t = pkg.dwp.DWPTuner(canon, workers=[0, 1], num_pages=4096,
                             on_migrate=lambda p: moved.append(p))
        _drive(t, lambda d: (d - 0.45) ** 2)
        frac = il.page_fractions(t.assignment, 8)
        target = il.dwp_weights(canon, [0, 1], t.dwp)
        np.testing.assert_allclose(frac, target, atol=0.01)
        assert moved
        return frac, target, [(p.moves, p.num_moves) for p in moved]
    both(case)


def test_coscheduled_two_stage():
    def case(pkg):
        canon = pkg.interleave.normalize(CANON4)
        t = pkg.dwp.CoScheduledTuner(canon, workers_b=[0, 1],
                                     num_pages=2048)
        periods, trail = 0, []
        while not t.done and periods < 60:
            for _ in range(t.cfg.n):
                t.record(max(1.0 - 2 * t.dwp, 0.6),
                         (t.dwp - 0.1) ** 2 + 1.0)
            trail.append((t.stage, t.dwp, t.dwp_lower_bound))
            periods += 1
        assert t.done
        assert t.dwp_lower_bound >= 0.2 - 1e-9
        assert t.dwp >= t.dwp_lower_bound - 1e-9
        return trail
    both(case)


# -- simulator: the paper's headline qualitative results ---------------------

def _sim(pkg):
    m = _machine(pkg, "machine_a")
    sim = pkg.simulator
    return (sim.NumaSimulator(m), pkg.canonical.CanonicalTuner(m),
            sim.PAPER_WORKLOADS["SC"])


def test_bwap_beats_uniform_workers_on_machine_a():
    def case(pkg):
        sim, tuner, app = _sim(pkg)
        workers = [0, 1]
        canon = tuner.weights_for(workers).weights
        t_bwap = sim.run(app, workers, "weighted", canon).time
        t_uw = sim.run(app, workers, "uniform_workers").time
        t_ft = sim.run(app, workers, "first_touch").time
        assert t_bwap < t_uw
        assert t_bwap < t_ft
        assert t_ft > t_uw
        return t_bwap, t_uw, t_ft
    both(case)


def test_uniform_all_beats_uniform_workers_for_bw_bound():
    def case(pkg):
        sim, _, app = _sim(pkg)
        t_ua = sim.run(app, [0, 1], "uniform_all").time
        t_uw = sim.run(app, [0, 1], "uniform_workers").time
        assert t_ua < t_uw
        return t_ua, t_uw
    both(case)


def test_gains_shrink_with_more_workers():
    def case(pkg):
        sim, tuner, app = _sim(pkg)

        def gain(workers):
            canon = tuner.weights_for(workers).weights
            t_b = sim.run(app, workers, "weighted", canon).time
            t_u = sim.run(app, workers, "uniform_workers").time
            return t_u / t_b

        g2, g8 = gain([0, 1]), gain(list(range(8)))
        assert g2 > g8 - 1e-9
        return g2, g8
    both(case)
