"""BWAP-weighted optimizer-state placement (weighted ZeRO).

Two placement problems from the paper mapped onto the optimizer state:

1. **Tiered placement** (Yu et al. [43], the work BWAP generalizes): shard
   optimizer pages between per-chip HBM (fast, scarce) and host DRAM over
   PCIe (slow, abundant). Eq. 1's max-parallel-transfer time says the split
   should follow w_d ∝ bw_d, NOT all-HBM-until-full: streaming the update
   from both tiers concurrently hides the slower tier behind the faster one.

2. **Heterogeneous rank weighting** (Eq. 5): when DP ranks see asymmetric
   bandwidth toward a worker partition (co-scheduled neighbours, cross-pod
   ranks), per-rank shard sizes follow minbw(rank) — Alg. 1 assigns pages.

Both emit page tables consumed by the update step; `stream_update_time`
is the Eq.-1 cost model used by benchmarks/bwap_tpu.py, and
`weighted_allgather` is a runnable demonstration (tests run it on 8 gloo
ranks).

Port of ``repro.sharding.zero``: the page tables are numpy on the port's
``placement.policy``, equal to the reference's; ``weighted_allgather`` is
the reference's masked ``psum`` as a masked ``torch.distributed.
all_reduce``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import interleave
from repro_torch.placement import policy as placement_policy


@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    bw_gbps: float        # stream bandwidth toward the compute chip
    capacity_pages: int


def _ctx(num_pages: int, tiers: list[TierSpec],
         dwp: float = 0.0) -> placement_policy.PlacementContext:
    return placement_policy.PlacementContext(
        bandwidths=np.asarray([t.bw_gbps for t in tiers]),
        num_pages=num_pages, workers=(0,), dwp=dwp,
        capacities=np.asarray([t.capacity_pages for t in tiers]))


def weighted_page_partition(num_pages: int, weights) -> np.ndarray:
    """Alg. 1 page table: page -> owner (tier or rank)."""
    return interleave.weighted_interleave(num_pages,
                                          interleave.normalize(weights))


def tier_split(num_pages: int, tiers: list[TierSpec],
               dwp: float = 0.0) -> np.ndarray:
    """Optimizer pages over memory tiers: the registry's ``bwap_dwp`` policy
    (canonical weights ∝ bw, DWP shifts mass toward tier 0 — the
    worker-local HBM); capacity overflow spills ∝ bandwidth, keeping Eq.-1
    transfer times balanced under pressure."""
    return placement_policy.assign("bwap_dwp", _ctx(num_pages, tiers, dwp))


def stream_update_time(assignment: np.ndarray, tiers: list[TierSpec],
                       page_bytes: int) -> float:
    """Eq. 1: the update step streams pages from all tiers in parallel;
    completion = the slowest tier's transfer (read + write back)."""
    t = 0.0
    for i, tier in enumerate(tiers):
        n = int((assignment == i).sum())
        t = max(t, 2.0 * n * page_bytes / (tier.bw_gbps * 1e9))
    return t


def uniform_split(num_pages: int, tiers: list[TierSpec]) -> np.ndarray:
    """The uniform-workers analogue: spread evenly over tiers (subject to
    capacity), ignoring bandwidth."""
    return placement_policy.assign("uniform", _ctx(num_pages, tiers))


def hbm_first_split(num_pages: int, tiers: list[TierSpec]) -> np.ndarray:
    """The first-touch analogue: fill the fastest tier, then spill."""
    return placement_policy.assign("local_first", _ctx(num_pages, tiers))


# ---------------------------------------------------------------------------
# Runnable weighted all-gather (masked all-reduce): heterogeneous rank shards
# ---------------------------------------------------------------------------

def weighted_allgather(x_pages, owner: np.ndarray, group=None):
    """All-gather pages whose ownership follows a weighted page table.

    x_pages: [num_pages, page] tensor (each rank holds its owned pages,
    others zero); owner: [num_pages] rank ids (ranks of ``group``, the
    default process group when None). Returns the full table on every
    rank. Implementation: masked sum — communication volume is
    proportional to the pages actually owned, so weighted tables shift
    traffic exactly as the placement dictates.
    """
    rank = dist.get_rank(group)
    mine = torch.as_tensor(np.asarray(owner) == rank,
                           device=x_pages.device)[:, None]
    out = x_pages * mine.to(x_pages.dtype)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
