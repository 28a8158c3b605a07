"""Weighted page interleaving (paper Alg. 1) + page tables + migration plans.

Mainstream kernels (and XLA's GSPMD, analogously) only provide *uniform*
interleaving over a node set. Alg. 1 emulates arbitrary weights by splitting
a segment into sub-ranges and uniformly interleaving sub-range k over the
nodes whose weight exceeds the k-th smallest weight; sub-range sizes are
chosen so aggregate per-node ratios match the target weights.

We implement it at page granularity: the unit is a page index, the output is
a page table ``assignment[page] -> node``. The same code places 4 KB NUMA
pages in the simulator and KV-cache / optimizer-state pages across TPU memory
domains.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


def normalize(weights: np.ndarray) -> np.ndarray:
    w = np.asarray(weights, dtype=np.float64)
    assert (w >= 0).all(), "weights must be non-negative"
    s = w.sum()
    assert s > 0, "at least one positive weight"
    return w / s


def uniform_interleave(num_pages: int, nodes: Sequence[int],
                       start_page: int = 0) -> np.ndarray:
    """Round-robin pages over ``nodes`` (the mbind/MPOL_INTERLEAVE analogue)."""
    nodes = np.asarray(list(nodes), dtype=np.int64)
    idx = (start_page + np.arange(num_pages)) % len(nodes)
    return nodes[idx]


def weighted_interleave(num_pages: int, weights: np.ndarray) -> np.ndarray:
    """Alg. 1: user-level weighted interleaving approximation.

    Walks nodes from the lowest weight upward; at each step, a sub-range of
    ``len(remaining) * (w_k - w_{k-1}) * num_pages`` pages is uniformly
    interleaved over the remaining node set, then the minimum-weight node is
    dropped. Telescoping guarantees the sub-range sizes sum to num_pages and
    per-node totals are proportional to the weights.
    """
    w = normalize(weights)
    n = len(w)
    order = np.argsort(w, kind="stable")           # getNodeWithMinWeight
    assignment = np.full(num_pages, -1, dtype=np.int64)
    remaining = list(order)                        # nodes, min weight first
    address = 0
    w_prev = 0.0
    exact = 0.0                                    # running exact boundary
    for k in range(n):
        node = remaining[0]
        step = float(w[node]) - w_prev
        exact += len(remaining) * step * num_pages
        size = (min(int(round(exact)), num_pages) - address) if k < n - 1 \
            else num_pages - address
        if size > 0:
            live = sorted(remaining)
            assignment[address:address + size] = uniform_interleave(
                size, live, start_page=address)
            address += size
        remaining.pop(0)
        w_prev = float(w[node])
    assert address == num_pages and (assignment >= 0).all()
    return assignment


def page_fractions(assignment: np.ndarray, num_nodes: int) -> np.ndarray:
    counts = np.bincount(assignment, minlength=num_nodes).astype(np.float64)
    return counts / max(len(assignment), 1)


# ---------------------------------------------------------------------------
# DWP-scaled weights and incremental migration (paper §III-B1/2)
# ---------------------------------------------------------------------------

def dwp_weights(canonical: np.ndarray, workers: Sequence[int],
                dwp: float) -> np.ndarray:
    """Scale the canonical distribution by the data-to-worker-proximity scalar.

    DWP=0 -> canonical weights. DWP=1 -> all pages on the worker set. The
    scaling preserves *relative* weights inside the worker and non-worker
    clusters (Observation 3): worker weights are multiplied by a common
    coefficient, and likewise the non-worker weights.
    """
    assert 0.0 <= dwp <= 1.0
    w = normalize(canonical)
    mask = np.zeros(len(w), dtype=bool)
    mask[list(workers)] = True
    ww = w[mask].sum()
    target_ww = ww + dwp * (1.0 - ww)
    out = np.zeros_like(w)
    if ww > 0:
        # divide first: w[mask]/ww is well-conditioned even for subnormal
        # cluster masses (target_ww/ww can overflow to inf)
        out[mask] = (w[mask] / ww) * target_ww
    else:  # degenerate: canonical put nothing on workers
        out[mask] = target_ww / mask.sum()
    nw = 1.0 - ww
    if nw > 0:
        out[~mask] = (w[~mask] / nw) * (1.0 - target_ww)
    return normalize(np.maximum(out, 0.0))  # guard fp cancellation at dwp=1


def capacity_capped_weights(weights: np.ndarray,
                            capacity_fractions: np.ndarray) -> np.ndarray:
    """Clamp a weight vector to per-node capacity fractions, water-filling
    the excess onto unclamped nodes (∝ their remaining weight).

    ``capacity_fractions[d]`` is node d's share of the *allocatable* pool
    (capacities sum to 1). The result never asks a node for more than its
    share — the swap-aware DWP fix: a high DWP must not promise fast-domain
    pages that a swap reservation (or small domain) cannot supply.
    """
    w = normalize(weights)
    cap = np.asarray(capacity_fractions, dtype=np.float64)
    assert w.shape == cap.shape and (cap >= 0).all()
    if cap.sum() < 1.0 - 1e-9:          # infeasible: fill to capacity shape
        return normalize(cap)
    fixed = np.zeros(len(w), dtype=bool)
    for _ in range(len(w)):
        over = (w > cap + 1e-12) & ~fixed
        if not over.any():
            break
        excess = float((w[over] - cap[over]).sum())
        w = w.copy()
        w[over] = cap[over]
        fixed |= over
        free = ~fixed
        mass = float(w[free].sum())
        if mass > 0:
            w[free] += excess * w[free] / mass
        else:                            # zero-weight free nodes: fill by
            head = cap[free] - w[free]   # remaining capacity headroom
            if np.isinf(head).any():     # uncapped nodes split it evenly
                even = np.isinf(head).astype(np.float64)
                w[free] += excess * even / even.sum()
            else:
                w[free] += excess * head / max(float(head.sum()), 1e-300)
    return normalize(w)


@dataclasses.dataclass(frozen=True)
class MigrationPlan:
    """Pages to move when re-interleaving from one weight vector to another.

    ``moves[i] = (page, src_node, dst_node)``. The plan is *incremental*: only
    pages whose assignment changed are touched (mbind MPOL_MF_MOVE semantics).
    """

    moves: np.ndarray            # (M, 3) int64
    old_assignment: np.ndarray
    new_assignment: np.ndarray

    @property
    def num_moves(self) -> int:
        return int(self.moves.shape[0])

    def moved_fraction(self) -> float:
        return self.num_moves / max(len(self.old_assignment), 1)


def plan_migration(old_assignment: np.ndarray,
                   new_weights: np.ndarray) -> MigrationPlan:
    """Re-run Alg. 1 for the new weights and diff the page tables."""
    new_assignment = weighted_interleave(len(old_assignment), new_weights)
    changed = np.nonzero(new_assignment != old_assignment)[0]
    moves = np.stack([changed, old_assignment[changed],
                      new_assignment[changed]], axis=1)
    return MigrationPlan(moves=moves, old_assignment=old_assignment,
                         new_assignment=new_assignment)
