"""NUMA memory-throughput simulator — the paper's model, made executable.

This is the *substrate* for the faithful reproduction: the container has no
8-node Opteron, so the machine is replaced by the paper's own system model
(§III-A) plus the standard contention refinements the paper cites
(memory-controller saturation [30], interconnect congestion [24]). The BWAP
*algorithms* under test (canonical tuner, DWP tuner, Alg. 1) are the real
implementations from ``repro_torch.core`` — only the hardware is simulated.

Model of one application run:

  T = T_compute + (1 - lam) * T_bw + lam * T_lat

  T_bw  — bandwidth-bound stall time: per worker node, the slowest parallel
          transfer of its read volume from each memory node (Eq. 3), with
          effective bandwidths from water-filling all concurrent demands
          (paper §III-A3 contention phenomena).
  T_lat — latency-bound stall time: volume-weighted mean relative access
          latency of the placement (remote hops cost more), scaled by the
          app's latency sensitivity ``lam`` (paper Obs. 2: some apps are
          BW-bound, others latency-sensitive).

Stall rate (what the DWP tuner measures) = (T - T_compute) / T.

Port of ``repro.core.simulator``: a numpy copy, the random draws in the
reference's order, so every run is equal to the reference's to the last
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import bwmodel, interleave
from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class Workload:
    """A memory-intensive application (paper Table I characterization).

    read_gbps/write_gbps: aggregate demand of one fully-loaded worker node.
    private_frac: fraction of accesses to thread-private pages.
    latency_sensitivity: lam in the execution-time model.
    dataset_gb: shared + private resident set (fits one node, §IV).
    compute_time: non-memory execution time at the reference thread count.
    parallel_fraction: Amdahl fraction for scaling compute_time with workers.
    """

    name: str
    read_gbps: float
    write_gbps: float
    private_frac: float
    latency_sensitivity: float
    dataset_gb: float
    compute_time: float
    parallel_fraction: float = 0.95


# The five paper benchmarks (Table I, machine B, one full worker node).
# latency_sensitivity is a free parameter of the model, set per the paper's
# qualitative findings (SC is latency-leaning — Table II shows high optimal
# DWP; OC/ON are BW-bound — optimal DWP ~0).
PAPER_WORKLOADS: dict[str, Workload] = {
    "OC": Workload("Ocean_cp", 17.576, 6.492, 0.793, 0.05, 3.5, 6.0),
    "ON": Workload("Ocean_ncp", 16.053, 5.578, 0.867, 0.05, 3.5, 6.0),
    "SP.B": Workload("SP.B", 11.962, 5.352, 0.199, 0.20, 1.2, 8.0),
    "SC": Workload("Streamcluster", 10.055, 0.070, 0.002, 0.12, 0.8, 10.0),
    "FT.C": Workload("FT.C", 5.585, 4.715, 0.950, 0.04, 5.0, 9.0),
}

DEMAND_EXCESS = 1.8   # want/achieved ratio (see run())
LAT_COEF = 0.35       # latency-stall scale vs compute time

#: Relative access-latency multiplier per path, derived from the bandwidth
#: matrix (lower-BW paths are longer paths; calibrated so that local=1 and the
#: farthest machine-A hop ~2.5, in line with measured NUMA latency ratios).
def _latency_matrix(topo: Topology) -> np.ndarray:
    rel = topo.bw.diagonal()[None, :] / topo.bw  # >= 1 off-diagonal
    return 1.0 + 0.45 * (rel.T - 1.0)            # lat[src->dst] indexed [src,dst]


@dataclasses.dataclass(frozen=True)
class RunResult:
    time: float
    stall_rate: float
    t_bw: float
    t_lat: float
    per_worker_time: np.ndarray


class NumaSimulator:
    def __init__(self, topo: Topology, seed: int = 0):
        self.topo = topo
        self.lat = _latency_matrix(topo)
        self.rng = np.random.default_rng(seed)

    # -- placement policies (paper §II/§IV baselines) -----------------------

    def placement(self, policy: str, workers: Sequence[int],
                  weights: np.ndarray | None = None) -> np.ndarray:
        """Per-node page fractions for the *shared* segment."""
        n = self.topo.num_nodes
        w = np.zeros(n)
        if policy == "first_touch":
            w[workers[0]] = 1.0       # initializing thread's node (§IV-A)
        elif policy in ("uniform_workers", "autonuma"):
            # autonuma converges to locality-driven placement on the worker
            # set (it migrates pages toward accessing threads, §V)
            w[list(workers)] = 1.0 / len(workers)
        elif policy == "uniform_all":
            w[:] = 1.0 / n
        elif policy == "weighted":
            assert weights is not None
            w = interleave.normalize(weights)
        else:
            raise ValueError(policy)
        return w

    def private_placement(self, policy: str, workers: Sequence[int],
                          weights: np.ndarray | None = None) -> np.ndarray:
        """(W, N) page fractions of each worker's private pages.

        first_touch places private pages locally (ideal for them); the
        interleaving policies spread them like shared pages — including BWAP,
        which by design does not distinguish page classes (§IV-A discussion).
        """
        n = self.topo.num_nodes
        out = np.zeros((len(workers), n))
        if policy in ("first_touch", "autonuma"):
            for k, wnode in enumerate(workers):
                out[k, wnode] = 1.0   # autonuma places private pages locally
        else:
            shared = self.placement(policy, workers, weights)
            out[:] = shared[None, :]
        return out

    # -- execution model -----------------------------------------------------

    def run(self, app: Workload, workers: Sequence[int], policy: str,
            weights: np.ndarray | None = None, noise: float = 0.0,
            threads_per_worker: int | None = None) -> RunResult:
        topo = self.topo
        n = topo.num_nodes
        W = len(workers)
        tpw = threads_per_worker or topo.cores_per_node
        load = tpw / topo.cores_per_node          # node load factor

        shared_w = self.placement(policy, workers, weights)
        priv_w = self.private_placement(policy, workers, weights)

        # Per-worker read volume (GB) over the run: demand x stall-free time.
        # Splitting by Table-I private/shared ratios.
        vol = app.read_gbps * load * app.compute_time
        vol_shared = vol * (1.0 - app.private_frac)
        vol_priv = vol * app.private_frac
        vol_write = app.write_gbps * load * app.compute_time

        # Concurrent demand matrix: worker dst pulls from src at a rate
        # proportional to the bytes placed there (writes count toward
        # controller pressure on the destination node of the write).
        # Demands are the app's ACTUAL rates — an unsaturated machine has no
        # bandwidth stall (latency then dominates; Obs. 2's two regimes).
        # Table-I rates are *achieved* under the machine's constraints;
        # unconstrained demand is higher (DEMAND_EXCESS calibrated so
        # machine A saturates and machine B sits near the knee, per the
        # paper's relative gains)
        demand_rate = (app.read_gbps + app.write_gbps * 0.5) * load \
            * DEMAND_EXCESS
        demands = []
        bytes_from = np.zeros((W, n))
        want = np.zeros((W, n))
        for k, dst in enumerate(workers):
            bytes_from[k] = vol_shared * shared_w + vol_priv * priv_w[k] \
                + vol_write * shared_w * 0.5   # write-allocate traffic share
            total_k = max(bytes_from[k].sum(), 1e-12)
            for src in range(n):
                if bytes_from[k, src] > 1e-12:
                    want[k, src] = demand_rate * bytes_from[k, src] / total_k
                    demands.append(bwmodel.Demand(
                        src=src, dst=dst, gbps=float(want[k, src])))
        grant = bwmodel.effective_bandwidth(topo, demands)

        # BW stall: extra transfer time beyond the requested rate
        per_worker = np.zeros(W)
        for k, dst in enumerate(workers):
            t = 0.0
            for src in range(n):
                b = bytes_from[k, src]
                if b <= 1e-12:
                    continue
                g = max(grant[(src, dst)], 1e-9)
                t = max(t, b / g - b / max(want[k, src], 1e-9))
            per_worker[k] = max(t, 0.0)
        t_bw = float(per_worker.max()) if W else 0.0

        # Latency stall time: excess mean access latency vs all-local.
        t_lat = 0.0
        for k, dst in enumerate(workers):
            frac = (vol_shared * shared_w + vol_priv * priv_w[k])
            frac = frac / max(frac.sum(), 1e-12)
            mean_lat = float((frac * self.lat[:, dst]).sum())
            t_lat = max(t_lat, app.compute_time * LAT_COEF
                        * (mean_lat - 1.0))
        # compute scales with workers (Amdahl)
        speedup = 1.0 / ((1 - app.parallel_fraction)
                         + app.parallel_fraction / max(W * load, 1e-9))
        t_c = app.compute_time / min(speedup, W * load if W else 1)

        lam = app.latency_sensitivity
        total = t_c + (1 - lam) * t_bw + lam * t_lat
        if noise:
            total *= float(1.0 + self.rng.normal(0.0, noise))
        stall = (total - t_c) / total if total > 0 else 0.0
        return RunResult(time=total, stall_rate=stall, t_bw=t_bw, t_lat=t_lat,
                         per_worker_time=per_worker)

    # -- stall-rate stream for the DWP tuner ---------------------------------

    def stall_stream(self, app: Workload, workers: Sequence[int],
                     weights: np.ndarray, n_samples: int,
                     noise: float = 0.02) -> list[float]:
        base = self.run(app, workers, "weighted", weights).stall_rate
        return [float(base * (1.0 + self.rng.normal(0.0, noise)))
                for _ in range(n_samples)]


    # -- full BWAP run: canonical start + online DWP tuning -------------------

    def run_with_tuner(self, app: Workload, workers, canonical: np.ndarray,
                       dwp_config=None, noise: float = 0.01,
                       migration_bw: float = 12.0):
        """Simulated execution with the DWP tuner in the loop.

        Work model: the app needs 1 unit of work; at placement w it
        progresses at rate 1/T(w). Each tuner period costs n*t wall seconds
        at the current rate; page migrations cost moved_fraction *
        dataset_gb / migration_bw. Returns (total_time, final_dwp, tuner).
        """
        from repro_torch.core import dwp as dwp_mod
        cfg = dwp_config or dwp_mod.DWPConfig()
        migration_cost = [0.0]

        def on_migrate(plan):
            migration_cost[0] += plan.moved_fraction() * app.dataset_gb \
                / migration_bw

        tuner = dwp_mod.DWPTuner(canonical, workers, num_pages=4096,
                                 config=cfg, on_migrate=on_migrate)
        work_done = 0.0
        elapsed = 0.0
        period_s = cfg.n * cfg.t
        while not tuner.done and work_done < 1.0:
            w = interleave.dwp_weights(canonical, tuner.workers, tuner.dwp)
            t_here = self.run(app, workers, "weighted", w).time
            rate = 1.0 / t_here
            stall = self.run(app, workers, "weighted", w).stall_rate
            for _ in range(cfg.n):
                tuner.record(stall * (1.0 + self.rng.normal(0.0, noise)))
            work_done += rate * period_s
            elapsed += period_s
        if work_done < 1.0:
            w = interleave.dwp_weights(canonical, tuner.workers, tuner.dwp)
            t_final = self.run(app, workers, "weighted", w).time
            elapsed += (1.0 - work_done) * t_final
        return elapsed + migration_cost[0], tuner.dwp, tuner


# ---------------------------------------------------------------------------
# Offline N-dimensional hill climbing (the paper's 15-hour baseline, §II)
# ---------------------------------------------------------------------------

def ndim_hill_climb(sim: NumaSimulator, app: Workload,
                    workers: Sequence[int], iters: int = 180,
                    step: float = 0.05, seed: int = 0,
                    top_k: int = 10) -> tuple[np.ndarray, float, list[float]]:
    """The paper's offline search (§II): hill climbing over the
    N-dimensional weight space, starting from uniform-workers. Candidate
    moves mix informed shaves (take weight from the node with the longest
    transfer time, give it to the shortest — the §III-A2 argument) with
    random mass moves. Returns the mean of the top-k weight vectors, the
    best time, and the trajectory."""
    rng = np.random.default_rng(seed)
    n = sim.topo.num_nodes
    start_points = [
        interleave.normalize(sim.placement("uniform_workers", workers)
                             + 1e-3),
        sim.placement("uniform_all", workers),
    ]
    seen: list[tuple[float, np.ndarray]] = []
    traj: list[float] = []

    def transfer_times(w):
        r = sim.run(app, workers, "weighted", w)
        # per-node worst-case transfer proxy: weight / minbw to workers
        mb = np.asarray([min(sim.topo.bw[i, d] for d in workers)
                         for i in range(n)])
        return r.time, w / mb

    per_seed = max(iters // len(start_points), 1)
    for cur in start_points:
        cur = cur.copy()
        cur_t = sim.run(app, workers, "weighted", cur).time
        seen.append((cur_t, cur.copy()))
        traj.append(min(traj[-1], cur_t) if traj else cur_t)
        for it in range(per_seed):
            cand = cur.copy()
            if it % 2 == 0:   # informed shave
                _, tt = transfer_times(cand)
                i = int(np.argmax(tt))
                j = int(np.argmin(tt + (cand <= 0) * 1e9))
            else:             # random exploration
                i, j = rng.integers(0, n, size=2)
            delta = min(step * rng.uniform(0.2, 1.0), cand[i])
            cand[i] -= delta
            cand[j] += delta
            cand = interleave.normalize(np.maximum(cand, 0.0))
            t = sim.run(app, workers, "weighted", cand).time
            seen.append((t, cand.copy()))
            if t < cur_t:
                cur, cur_t = cand, t
            traj.append(min(traj[-1], cur_t))
    seen.sort(key=lambda x: x[0])
    top = np.stack([w for _, w in seen[:top_k]], axis=0).mean(axis=0)
    top = interleave.normalize(top)
    return top, seen[0][0], traj
