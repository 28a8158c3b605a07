"""Bandwidth estimation and the paper's throughput model (Eqs. 1-5).

The canonical tuner needs ``bw(n_src -> n_dst)`` under the *demand of a
BW-intensive canonical application* (paper §III-A3): nominal link numbers are
wrong because memory-controller saturation and interconnect congestion reshape
effective bandwidth. The paper profiles a canonical benchmark with hardware
counters; we reproduce that procedure against the contention model below
(`profile_bw`), which plays the role of the physical machine. On a real
deployment the same interface is fed by measured counters instead.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class Demand:
    """Aggregate read demand placed by worker node ``dst`` on memory node
    ``src`` (GB/s requested, before contention)."""

    src: int
    dst: int
    gbps: float


def effective_bandwidth(
    topo: Topology,
    demands: Sequence[Demand],
) -> dict[tuple[int, int], float]:
    """Contention model: progressive filling of links and memory controllers.

    Each (src, dst) path is capped by its nominal link bandwidth
    ``topo.bw[src, dst]``; each memory controller ``src`` caps the *sum* of
    granted bandwidth over all paths out of it to ``topo.mc_bw[src]``
    (cross-node contention on the controller, paper §III-A3); links shared
    between paths (``topo.link_groups``) cap the sum over the group.

    Water-filling: repeatedly grant each unfrozen path its fair share of the
    most-constrained resource until all paths are frozen. This mirrors how
    hardware arbitration equalises throughput between same-priority readers.
    """
    paths = [(d.src, d.dst) for d in demands]
    want = {(d.src, d.dst): d.gbps for d in demands}
    grant = {p: 0.0 for p in paths}
    frozen: set[tuple[int, int]] = set()

    link_of = topo.link_groups or {}

    def resources() -> list[tuple[str, object, float, list[tuple[int, int]]]]:
        """(kind, key, capacity, member paths) for every constrained resource."""
        out = []
        # per-path nominal link cap
        for p in paths:
            out.append(("path", p, float(topo.bw[p[0], p[1]]), [p]))
        # memory controllers
        for src in topo.nodes():
            members = [p for p in paths if p[0] == src]
            if members:
                out.append(("mc", src, float(topo.mc_bw[src]), members))
        # shared links
        groups: dict[object, list[tuple[int, int]]] = {}
        for p in paths:
            if p in link_of:
                groups.setdefault(link_of[p], []).append(p)
        for key, members in groups.items():
            cap = min(float(topo.bw[m[0], m[1]]) for m in members)
            out.append(("link", key, cap, members))
        return out

    for _ in range(len(paths) + 2):  # converges in <= #paths rounds
        active = [p for p in paths if p not in frozen]
        if not active:
            break
        # headroom per resource divided by its number of active members
        fair = {p: float("inf") for p in active}
        for _, _, cap, members in resources():
            used = sum(grant[m] for m in members)
            live = [m for m in members if m not in frozen]
            if not live:
                continue
            share = max(cap - used, 0.0) / len(live)
            for m in live:
                fair[m] = min(fair[m], share)
        progressed = False
        for p in active:
            head = min(fair[p], want[p] - grant[p])
            if head <= 1e-9:
                frozen.add(p)
                continue
            grant[p] += head
            progressed = True
            if grant[p] >= want[p] - 1e-9:
                frozen.add(p)
        if not progressed:
            break
    return grant


def profile_bw(
    topo: Topology,
    workers: Sequence[int],
) -> np.ndarray:
    """The paper's profiling procedure (§III-A3), simulated.

    Deploy the canonical benchmark (random traversal of a shared array,
    uniform-all interleave, one thread per hardware thread of the worker set)
    and record per-(src,dst) achieved throughput. The canonical application is
    *extremely* BW-intensive (paper §III-A1), so every path is driven to
    saturation and the achieved per-path throughput — which is what hardware
    counters report and what the paper feeds into Eq. 5 — reflects contended
    path capacity, not nominal link numbers.

    Returns an (N, W) matrix of profiled bandwidths bw[src, worker_index].
    """
    n = topo.num_nodes
    saturating = 1e9  # canonical app requests far more than any path can give
    demands = [Demand(src=src, dst=dst, gbps=saturating)
               for dst in workers for src in range(n)]
    grant = effective_bandwidth(topo, demands)
    out = np.zeros((n, len(workers)))
    for j, dst in enumerate(workers):
        for src in range(n):
            out[src, j] = grant[(src, dst)]
    return out


def minbw(bw_profiled: np.ndarray) -> np.ndarray:
    """Eq. 4's minbw: per memory node, the weakest path to any worker.

    ``bw_profiled`` is (N, W): rows = memory nodes, cols = worker nodes.
    """
    return bw_profiled.min(axis=1)


def optimal_weights(bw_profiled: np.ndarray) -> np.ndarray:
    """Eq. 5 (Eq. 2 when W=1): weights proportional to minbw."""
    m = minbw(bw_profiled)
    total = m.sum()
    assert total > 0
    return m / total


def stall_cost(bytes_per_domain: np.ndarray,
               bandwidths_gbps: np.ndarray,
               *,
               tier_bytes: float = 0.0,
               tier_bw_gbps: float | None = None,
               link_bytes: np.ndarray | None = None,
               link_bw_gbps: np.ndarray | None = None,
               link_latency_s: np.ndarray | None = None) -> float:
    """Eq. 1's max-parallel-transfer time for one access batch.

    ``bytes_per_domain[d]`` bytes stream from domain ``d`` at
    ``bandwidths_gbps[d]`` GB/s; transfers from distinct domains overlap, so
    the stall is the slowest domain's transfer. This single scalar is what
    the serving stack scores with: the engine's per-step KV read time, the
    swap manager's transfer estimates, and the scheduler's victim selection
    all call it with different byte vectors.

    ``tier_bytes``/``tier_bw_gbps`` append one extra row for the persistent
    tier below the memory domains, so demotion/promotion/restore transfers
    are priced by the same max — the tier is just one more (slow) domain in
    Eq. 1, not a special case.

    ``link_bytes``/``link_bw_gbps``/``link_latency_s`` append one row per
    *cluster interconnect link* (prefill/decode disaggregation,
    DESIGN.md §13): a striped KV handoff streams ``link_bytes[l]`` over
    link ``l`` concurrently with the domain rows, each paying a fixed
    propagation latency on top of its serialization time — so a page wire
    is priced like any other asymmetric domain read, latency included.
    """
    b = np.asarray(bytes_per_domain, dtype=np.float64)
    bw = np.asarray(bandwidths_gbps, dtype=np.float64)
    assert b.shape == bw.shape and (bw > 0).all()
    lat = np.zeros_like(b)
    if tier_bytes > 0:
        assert tier_bw_gbps is not None and tier_bw_gbps > 0
        b = np.append(b, float(tier_bytes))
        bw = np.append(bw, float(tier_bw_gbps))
        lat = np.append(lat, 0.0)
    if link_bytes is not None:
        lb = np.asarray(link_bytes, dtype=np.float64)
        lbw = np.asarray(link_bw_gbps, dtype=np.float64)
        llat = (np.zeros_like(lb) if link_latency_s is None
                else np.asarray(link_latency_s, dtype=np.float64))
        assert lb.shape == lbw.shape == llat.shape and (lbw > 0).all()
        # latency applies only to rows that actually move bytes
        b = np.append(b, lb)
        bw = np.append(bw, lbw)
        lat = np.append(lat, np.where(lb > 0, llat, 0.0))
    if b.sum() <= 0:
        return 0.0
    return float((b / (bw * 1e9) + lat).max())


def move_cost(bytes_per_src_domain: np.ndarray,
              bandwidths_gbps: np.ndarray,
              dst_domain: int) -> float:
    """Eq.-1 price of re-homing a batch of pages into ``dst_domain``.

    ``bytes_per_src_domain[d]`` bytes are read out of source domain ``d``;
    reads from distinct sources overlap (the same max-parallel-transfer
    shape as :func:`stall_cost`), while every moved byte funnels into the
    one destination, so the write side is the *total* over the destination
    bandwidth. The slower side gates. Re-homing targets fast domains, so
    the read out of the slow source is normally the bottleneck — but a
    many-source batch into a modest destination flips that, and this max
    keeps the budget honest either way.
    """
    b = np.asarray(bytes_per_src_domain, dtype=np.float64)
    bw = np.asarray(bandwidths_gbps, dtype=np.float64)
    assert b.shape == bw.shape and (bw > 0).all()
    if b.sum() <= 0:
        return 0.0
    read = float((b / (bw * 1e9)).max())
    write = float(b.sum()) / (bw[dst_domain] * 1e9)
    return max(read, write)


def transfer_time(
    shared_gb: float,
    weights: np.ndarray,
    bw_profiled: np.ndarray,
) -> float:
    """Eq. 3: execution time of the canonical application = the slowest
    parallel transfer experienced by the slowest worker."""
    n, w = bw_profiled.shape
    t = 0.0
    for j in range(w):
        for i in range(n):
            if weights[i] <= 0:
                continue
            t = max(t, shared_gb * float(weights[i]) / float(bw_profiled[i, j]))
    return t
