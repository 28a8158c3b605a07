"""The paper's evidence on both packages: ``repro_torch.core.canonical`` and
``repro_torch.core.simulator`` against ``repro.core``'s, the port of
``benchmarks/paper_claims.py`` against the reference's, and
``examples/torch_quickstart.py`` against ``examples/quickstart.py``.

Every case of ``tests/test_core_bwap.py``'s canonical-tuner, co-scheduled
and simulator sections and ``tests/test_system.py``'s first two cases runs
on each package, keeps the reference test's assertions, and returns a
record (weights, times, stall rates, tuner trajectories) that must be
equal to the last bit: the modules are numpy copies that draw their random
numbers in the reference's order. The installed canonical weight file is
byte-equal, and every ``paper_claims`` dict is equal at seed 0."""

import contextlib
import dataclasses
import importlib
import io
import runpy
from pathlib import Path

import numpy as np
import pytest

from _torch_parity import equal

ROOT = Path(__file__).resolve().parents[1]


class Core:
    """One package's core modules."""

    def __init__(self, port: bool):
        root = "repro_torch" if port else "repro"
        for name in ("canonical", "dwp", "interleave", "simulator",
                     "topology"):
            setattr(self, name, importlib.import_module(
                f"{root}.core.{name}"))
        self.CanonicalTuner = self.canonical.CanonicalTuner
        self.NumaSimulator = self.simulator.NumaSimulator
        self.WORKLOADS = self.simulator.PAPER_WORKLOADS


CORES = (Core(False), Core(True))


def both(case, *a):
    """``case(core, ...)`` on the reference and on the port: the port's
    record must equal the reference's."""
    ref, port = (case(c, *a) for c in CORES)
    assert equal(port, ref)
    return port


def _entry(e) -> dict:
    return {"workers": e.workers, "weights": e.weights,
            "bw_profiled": e.bw_profiled, "minbw": e.minbw}


def _result(r) -> tuple:
    return (r.time, r.stall_rate, r.t_bw, r.t_lat, r.per_worker_time)


# -- canonical tuner -------------------------------------------------------

def test_canonical_weights_sum_to_one_and_favour_fast_nodes():
    def case(c):
        tuner = c.CanonicalTuner(c.topology.machine_a())
        e = tuner.weights_for([0, 1])
        assert e.weights.sum() == pytest.approx(1.0)
        assert (e.weights > 0).all()
        assert e.weights[0] >= e.weights.max() * 0.5
        assert e.weights.std() > 0.01
        return _entry(e), e.worker_mass
    both(case)


def test_canonical_symmetry_dedup():
    def case(c):
        tuner = c.CanonicalTuner(c.topology.machine_b())
        sets = tuner.plausible_worker_sets(max_size=2)
        assert (0,) in sets
        assert (2,) not in sets
        assert (0, 1) in sets and (2, 3) not in sets
        return sets, c.CanonicalTuner(
            c.topology.machine_a()).plausible_worker_sets()
    both(case)


@pytest.mark.parametrize("machine,max_size", [("machine_a", 2),
                                              ("machine_b", 2),
                                              ("machine_a", None)])
def test_canonical_install_writes_the_reference_bytes(tmp_path, machine,
                                                      max_size):
    """``install`` writes the reference's file byte for byte; ``load``
    gives back its weights (the install round trip of both tests)."""
    def case(c):
        tuner = c.CanonicalTuner(getattr(c.topology, machine)())
        path = tmp_path / c.canonical.__name__ / "weights.json"
        n = tuner.install(path, max_size=max_size)
        assert n >= 2
        loaded = c.CanonicalTuner.load(path)
        for ws, w in loaded.items():
            np.testing.assert_allclose(w, tuner.weights_for(ws).weights)
            assert abs(w.sum() - 1.0) < 1e-9 and (w > 0).all()
        return n, path.read_bytes(), loaded
    both(case)


# -- co-scheduled tuner ------------------------------------------------------

def test_coscheduled_two_stage():
    def case(c):
        canon = c.interleave.normalize(np.asarray([3.0, 2, 1, 1]))
        t = c.dwp.CoScheduledTuner(canon, workers_b=[0, 1], num_pages=2048)

        def stall_a(d):
            return max(1.0 - 2 * d, 0.6)

        def stall_b(d):
            return (d - 0.1) ** 2 + 1.0

        trail, periods = [], 0
        while not t.done and periods < 60:
            for _ in range(t.cfg.n):
                t.record(stall_a(t.dwp), stall_b(t.dwp))
            trail.append((t.stage, t.dwp, t.dwp_lower_bound))
            periods += 1
        assert t.done
        assert t.dwp_lower_bound >= 0.2 - 1e-9
        assert t.dwp >= t.dwp_lower_bound - 1e-9
        return trail, t.assignment
    both(case)


# -- simulator -----------------------------------------------------------------

def test_bwap_beats_uniform_workers_on_machine_a():
    def case(c):
        mach = c.topology.machine_a()
        sim = c.NumaSimulator(mach)
        app = c.WORKLOADS["SC"]
        workers = [0, 1]
        canon = c.CanonicalTuner(mach).weights_for(workers).weights
        r_b = sim.run(app, workers, "weighted", canon)
        r_uw = sim.run(app, workers, "uniform_workers")
        r_ft = sim.run(app, workers, "first_touch")
        assert r_b.time < r_uw.time and r_b.time < r_ft.time
        assert r_ft.time > r_uw.time
        return [_result(r) for r in (r_b, r_uw, r_ft)]
    both(case)


def test_uniform_all_beats_uniform_workers_for_bw_bound():
    def case(c):
        sim = c.NumaSimulator(c.topology.machine_a())
        app = c.WORKLOADS["SC"]
        r_ua = sim.run(app, [0, 1], "uniform_all")
        r_uw = sim.run(app, [0, 1], "uniform_workers")
        assert r_ua.time < r_uw.time
        return _result(r_ua), _result(r_uw)
    both(case)


def test_gains_shrink_with_more_workers():
    def case(c):
        mach = c.topology.machine_a()
        sim = c.NumaSimulator(mach)
        tuner = c.CanonicalTuner(mach)
        app = c.WORKLOADS["SC"]

        def gain(workers):
            canon = tuner.weights_for(workers).weights
            t_b = sim.run(app, workers, "weighted", canon).time
            t_u = sim.run(app, workers, "uniform_workers").time
            return t_u / t_b

        g2, g8 = gain([0, 1]), gain(list(range(8)))
        assert g2 > g8 - 1e-9
        return g2, g8
    both(case)


@pytest.mark.parametrize("app", ["OC", "ON", "SP.B", "SC", "FT.C"])
def test_every_policy_and_the_noisy_draws_match(app):
    """Each paper workload under every policy on both machines, noisy
    runs, a stall stream and a tuned run: the simulator's draws come in
    the reference's order."""
    def case(c):
        out = []
        for mach, workers in ((c.topology.machine_a(), [0, 1]),
                              (c.topology.machine_b(), [0])):
            sim = c.NumaSimulator(mach, seed=3)
            w = c.WORKLOADS[app]
            canon = c.CanonicalTuner(mach).weights_for(workers).weights
            for pol in ("first_touch", "autonuma", "uniform_workers",
                        "uniform_all"):
                out.append(_result(sim.run(w, workers, pol)))
            out.append(_result(sim.run(w, workers, "weighted", canon,
                                       noise=0.02)))
            out.append(sim.stall_stream(w, workers, canon, 5))
            t, d, tuner = sim.run_with_tuner(
                w, workers, canon, c.dwp.DWPConfig(n=8, c=2, t=0.05))
            out.append((t, d, [dataclasses.astuple(h)
                               for h in tuner.history]))
        return out
    both(case)


def test_ndim_hill_climb_matches():
    def case(c):
        mach = c.topology.machine_a()
        sim = c.NumaSimulator(mach)
        return c.simulator.ndim_hill_climb(sim, c.WORKLOADS["SP.B"], [0, 1],
                                           iters=60, seed=5)
    both(case)


# -- tests/test_system.py's first two cases --------------------------------

def test_full_bwap_pipeline_beats_baselines():
    def case(c):
        mach = c.topology.machine_a()
        sim = c.NumaSimulator(mach)
        app = c.WORKLOADS["SC"]
        workers = [0, 1]
        canon = c.CanonicalTuner(mach).weights_for(workers).weights
        tuner = c.dwp.DWPTuner(canon, workers, num_pages=4096,
                               config=c.dwp.DWPConfig(n=6, c=1,
                                                      rel_tolerance=0.02))
        stalls = []
        while not tuner.done:
            w = c.interleave.dwp_weights(canon, workers, tuner.dwp)
            stall = sim.run(app, workers, "weighted", w,
                            noise=0.01).stall_rate
            stalls.append(stall)
            tuner.record(stall)
        w = c.interleave.dwp_weights(canon, workers, tuner.dwp)
        t_bwap = sim.run(app, workers, "weighted", w).time
        assert t_bwap <= sim.run(app, workers, "uniform_workers").time
        assert t_bwap <= sim.run(app, workers, "first_touch").time
        frac = c.interleave.page_fractions(tuner.assignment, mach.num_nodes)
        np.testing.assert_allclose(frac, w, atol=0.01)
        return stalls, tuner.dwp, t_bwap, tuner.assignment
    both(case)


def test_canonical_install_sweep_covers_plausible_sets(tmp_path):
    def case(c):
        tuner = c.CanonicalTuner(c.topology.machine_a())
        path = tmp_path / c.canonical.__name__ / "w.json"
        n = tuner.install(path, max_size=2)
        assert n >= 3
        loaded = c.CanonicalTuner.load(path)
        for ws, w in loaded.items():
            assert abs(w.sum() - 1.0) < 1e-9
            assert (w > 0).all()
        return n, loaded
    both(case)


# -- benchmarks/paper_claims.py and examples/quickstart.py ---------------------

@pytest.mark.parametrize("claim", [
    "fig1b_placement", "fig23_speedups", "table2_dwp", "fig4_dwp_curve",
    "overhead", "observation3_scaling"])
def test_paper_claims_equal_the_reference(claim):
    from benchmarks import paper_claims, torch_paper_claims
    ref = getattr(paper_claims, claim)(0)
    port = getattr(torch_paper_claims, claim)(0)
    assert getattr(torch_paper_claims, claim) in torch_paper_claims.CLAIMS
    assert equal(port, ref)
    assert port == ref


def test_torch_quickstart_prints_the_reference_lines():
    def output(name):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(ROOT / "examples" / name),
                           run_name="__main__")
        return buf.getvalue()
    ref = output("quickstart.py")
    assert "slower than BWAP" in ref
    assert output("torch_quickstart.py") == ref
