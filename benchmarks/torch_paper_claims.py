"""Paper-claims reproduction on the PyTorch port's core: Figs. 1b/2/3/4,
Table II, overhead (§IV). The port of ``benchmarks/paper_claims.py``.

The BWAP algorithms under test are the port's copies in
``repro_torch.core``; the physical NUMA machines are replaced by the
simulator built from the paper's own performance model (DESIGN.md §3).
Each function returns the reference function's dict, equal to the last
bit (pure numpy, the same draws in the same order).

    PYTHONPATH=src python -m benchmarks.torch_paper_claims
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.core import interleave, topology
from repro_torch.core.canonical import CanonicalTuner
from repro_torch.core.dwp import DWPConfig
from repro_torch.core.simulator import (PAPER_WORKLOADS, NumaSimulator,
                                        ndim_hill_climb)

POLICIES = ["first_touch", "autonuma", "uniform_workers", "uniform_all"]


def _scenarios(mach):
    if mach.num_nodes == 8:        # machine A
        return [[0, 1], [0, 1, 2, 3]], [[0], [0, 1], [0, 1, 2, 3]]
    return [[0]], [[0], [0, 1]]    # machine B


def fig1b_placement(seed: int = 0) -> dict:
    """Baseline policies vs offline N-dim hill climbing (2 workers, mach A).
    Paper: uniform-* improve on first-touch but stay clearly short of the
    hill-climbed optimum."""
    mach = topology.machine_a()
    sim = NumaSimulator(mach, seed)
    workers = [0, 1]
    out = {}
    for name, app in PAPER_WORKLOADS.items():
        best_w, best_t, traj = ndim_hill_climb(sim, app, workers,
                                               iters=180, seed=seed)
        row = {"hill_climb_time": best_t, "iters": len(traj) - 1}
        for pol in POLICIES:
            t = sim.run(app, workers, pol).time
            row[pol] = best_t / t         # performance normalized to optimum
        out[name] = row
    return out


def fig23_speedups(seed: int = 0) -> dict:
    """Speedup vs uniform-workers for BWAP / BWAP-uniform / baselines in the
    co-scheduled scenario, machines A and B, various worker counts."""
    results = {}
    for mach in (topology.machine_a(), topology.machine_b()):
        sim = NumaSimulator(mach, seed)
        tuner = CanonicalTuner(mach)
        co_sets = _scenarios(mach)[0] if mach.num_nodes == 8 else [[0], [0, 1]]
        for workers in co_sets:
            key = f"{mach.name}/{len(workers)}w"
            results[key] = {}
            for name, app in PAPER_WORKLOADS.items():
                t_uw = sim.run(app, workers, "uniform_workers").time
                t_ua = sim.run(app, workers, "uniform_all").time
                t_ft = sim.run(app, workers, "first_touch").time
                canon = tuner.weights_for(workers).weights
                t_bwap, dwp_b, _ = sim.run_with_tuner(
                    app, workers, canon, DWPConfig(n=8, c=2, t=0.05, rel_tolerance=0.02))
                uniform_all = sim.placement("uniform_all", workers)
                t_bwu, dwp_u, _ = sim.run_with_tuner(
                    app, workers, uniform_all, DWPConfig(n=8, c=2, t=0.05, rel_tolerance=0.02))
                results[key][name] = {
                    "bwap": t_uw / t_bwap,
                    "bwap_uniform": t_uw / t_bwu,
                    "uniform_all": t_uw / t_ua,
                    "first_touch": t_uw / t_ft,
                    "autonuma": t_uw / sim.run(app, workers,
                                               "autonuma").time,
                    "dwp_bwap": dwp_b,
                }
    return results


def table2_dwp(seed: int = 0) -> dict:
    """Ideal DWP values found by the iterative search (co-scheduled)."""
    out = {}
    for mach in (topology.machine_a(), topology.machine_b()):
        sim = NumaSimulator(mach, seed)
        tuner = CanonicalTuner(mach)
        sets = ([[0], [0, 1], [0, 1, 2, 3]] if mach.num_nodes == 8
                else [[0], [0, 1]])
        for workers in sets:
            canon = tuner.weights_for(workers).weights
            key = f"{mach.name}/{len(workers)}w"
            out[key] = {}
            for name, app in PAPER_WORKLOADS.items():
                _, dwp, _ = sim.run_with_tuner(app, workers, canon,
                                               DWPConfig(n=8, c=2, t=0.05, rel_tolerance=0.02))
                out[key][name] = round(dwp, 2)
    return out


def fig4_dwp_curve(seed: int = 0) -> dict:
    """Static-DWP sweep for Streamcluster on machine A (1 and 2 workers):
    checks (a) stall rate tracks execution time, (b) near-convexity, and
    (c) the tuner stops within one step of the static optimum."""
    mach = topology.machine_a()
    sim = NumaSimulator(mach, seed)
    tuner = CanonicalTuner(mach)
    app = PAPER_WORKLOADS["SC"]
    out = {}
    for workers in ([0], [0, 1]):
        canon = tuner.weights_for(workers).weights
        grid = np.round(np.arange(0.0, 1.0001, 0.1), 2)
        times, stalls = [], []
        for d in grid:
            w = interleave.dwp_weights(canon, workers, float(d))
            r = sim.run(app, workers, "weighted", w)
            times.append(r.time)
            stalls.append(r.stall_rate)
        _, dwp_found, _ = sim.run_with_tuner(app, workers, canon,
                                             DWPConfig(n=8, c=2, t=0.05, rel_tolerance=0.02))
        opt = float(grid[int(np.argmin(times))])
        corr = float(np.corrcoef(times, stalls)[0, 1])
        out[f"{len(workers)}w"] = {
            "grid": grid.tolist(), "times": times, "stalls": stalls,
            "static_opt_dwp": opt, "tuner_dwp": dwp_found,
            "within_one_step": abs(dwp_found - opt) <= 0.1 + 1e-9,
            "time_stall_correlation": corr,
        }
    return out


def overhead(seed: int = 0) -> dict:
    """DWP-tuner overhead vs running statically at the found optimum.
    Paper §IV-B: max 4% across apps."""
    mach = topology.machine_a()
    sim = NumaSimulator(mach, seed)
    tuner = CanonicalTuner(mach)
    out = {}
    for name, app in PAPER_WORKLOADS.items():
        workers = [0, 1]
        canon = tuner.weights_for(workers).weights
        t_tuned, dwp, _ = sim.run_with_tuner(app, workers, canon,
                                             DWPConfig(n=8, c=2, t=0.05, rel_tolerance=0.02))
        w = interleave.dwp_weights(canon, workers, dwp)
        t_static = sim.run(app, workers, "weighted", w).time
        out[name] = {"with_tuner": t_tuned, "static_at_found_dwp": t_static,
                     "overhead_pct": 100.0 * (t_tuned / t_static - 1.0)}
    return out


def observation3_scaling(seed: int = 0) -> dict:
    """Observation 3: scaling per-cluster weights between the best
    distributions of two apps reduces per-node variance by ~1/3."""
    mach = topology.machine_a()
    sim = NumaSimulator(mach, seed)
    workers = [0, 1]
    best = {}
    for name in ("SC", "SP.B", "OC"):
        w, _, _ = ndim_hill_climb(sim, PAPER_WORKLOADS[name], workers,
                                  iters=180, seed=seed)
        best[name] = w
    mask = np.zeros(mach.num_nodes, bool)
    mask[workers] = True
    cvs_raw, cvs_scaled = [], []
    names = list(best)
    for a in range(len(names)):
        for b_ in range(a + 1, len(names)):
            wa, wb = best[names[a]], best[names[b_]]
            raw = np.std(wa - wb) / max(np.mean(np.abs(wb)), 1e-9)
            parts = []
            for m in (mask, ~mask):
                scale = wa[m].sum() / max(wb[m].sum(), 1e-9)
                parts.append(np.std(wa[m] - wb[m] * scale))
            scaled = np.mean(parts) / max(np.mean(np.abs(wb)), 1e-9)
            cvs_raw.append(raw)
            cvs_scaled.append(scaled)
    return {"cv_raw": float(np.mean(cvs_raw)),
            "cv_scaled": float(np.mean(cvs_scaled)),
            "reduction": 1.0 - float(np.mean(cvs_scaled))
            / max(float(np.mean(cvs_raw)), 1e-9)}


CLAIMS = (fig1b_placement, fig23_speedups, table2_dwp, fig4_dwp_curve,
          overhead, observation3_scaling)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for fn in CLAIMS:
        print(f"== {fn.__name__}")
        print(json.dumps(fn(args.seed), indent=1, sort_keys=True,
                         default=float))


if __name__ == "__main__":
    main()
