"""Placement policy registry: one protocol, many weight distributions.

Every layer of the stack that spreads pages over memory domains — KV pages
(serve/kvcache), ZeRO optimizer shards (sharding/zero), checkpoint staging
buffers (checkpoint/ckpt) — used to hand-roll its own weighted-interleave
variant. They now all ask this registry for a :class:`PlacementPolicy` and
feed the resulting weights to Alg. 1 (core/interleave).

A policy maps a :class:`PlacementContext` (domain bandwidths, capacities,
worker set, DWP) to a normalized weight vector; ``counts``/``assign`` turn
that into capacity-respecting integer page counts and a page table.

Built-in policies (DESIGN.md §3.1):

==================  =========================================================
``uniform``         equal mass on every domain (mbind MPOL_INTERLEAVE)
``bwap_canonical``  w_d ∝ bw_d — the paper's Eq. 2 single-worker closed form
``bwap_dwp``        canonical scaled by data-to-worker proximity (§III-B1)
``local_first``     fill domains fastest-first up to capacity (first-touch /
                    HBM-spill analogue; the baseline BWAP beats)
``coda``            ``bwap_dwp`` placement + compute-follows-data execution:
                    per-domain micro-batch decode and heat-driven re-homing
                    of hot shared pages (DESIGN.md §11)
==================  =========================================================
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import interleave


@dataclasses.dataclass(frozen=True)
class PlacementContext:
    """Everything a policy may look at when distributing pages.

    Attributes:
      bandwidths: (D,) per-domain read bandwidth toward the workers (GB/s).
      num_pages: number of pages being placed.
      workers: indices of worker-local domains (DWP shifts mass here).
      dwp: data-to-worker proximity in [0, 1]; ignored by DWP-free policies.
      capacities: optional (D,) per-domain page capacities. ``None`` means
        uncapped; policies that *require* capacities (local_first) treat
        ``None`` as infinite everywhere but the fastest domain still wins.
    """

    bandwidths: np.ndarray
    num_pages: int
    workers: tuple[int, ...] = (0,)
    dwp: float = 0.0
    capacities: np.ndarray | None = None

    def __post_init__(self):
        object.__setattr__(self, "bandwidths",
                           np.asarray(self.bandwidths, dtype=np.float64))
        if self.capacities is not None:
            object.__setattr__(self, "capacities",
                               np.asarray(self.capacities, dtype=np.int64))
        object.__setattr__(self, "workers", tuple(self.workers))

    @property
    def num_domains(self) -> int:
        return int(len(self.bandwidths))


class PlacementPolicy:
    """Base class: subclasses define ``weights``; ``counts`` derives
    capacity-clamped integer page counts from them."""

    name: str = "?"
    # execution-mode flags (DESIGN.md §11): a policy can ask the serving
    # stack to *place work*, not just pages. ``micro_batch`` makes the
    # scheduler partition each decode batch into per-domain launches;
    # ``rehome`` makes the engine migrate hot shared pages into fast
    # domains under an Eq.-1 budget. Placement-only policies leave both
    # off; scheduler/engine read them via ``FabricView.placement_policy``.
    micro_batch: bool = False
    rehome: bool = False

    def weights(self, ctx: PlacementContext) -> np.ndarray:
        raise NotImplementedError

    def counts(self, ctx: PlacementContext) -> np.ndarray:
        w = interleave.normalize(self.weights(ctx))
        target = np.floor(w * ctx.num_pages).astype(np.int64)
        # hand out rounding remainders by largest fractional part
        rem = ctx.num_pages - int(target.sum())
        if rem > 0:
            frac = w * ctx.num_pages - target
            for i in np.argsort(-frac)[:rem]:
                target[int(i)] += 1
        if ctx.capacities is None:
            return target
        return clamp_to_capacity(target, ctx.capacities, w)


_REGISTRY: dict[str, PlacementPolicy] = {}


def register(cls: type[PlacementPolicy]) -> type[PlacementPolicy]:
    """Class decorator: instantiate and index by ``cls.name``."""
    assert cls.name not in _REGISTRY, f"duplicate policy {cls.name!r}"
    _REGISTRY[cls.name] = cls()
    return cls


def get(name: str) -> PlacementPolicy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown placement policy {name!r}; "
                       f"available: {sorted(_REGISTRY)}") from None


def available() -> list[str]:
    return sorted(_REGISTRY)


def resolve(policy: str | PlacementPolicy) -> PlacementPolicy:
    return get(policy) if isinstance(policy, str) else policy


# ---------------------------------------------------------------------------
# capacity handling (shared by every policy — was private to sharding/zero)
# ---------------------------------------------------------------------------

def clamp_to_capacity(target: np.ndarray, capacities: np.ndarray,
                      spill_weights: np.ndarray) -> np.ndarray:
    """Clip per-domain page counts to capacity; overflow spills to domains
    with room, proportional to ``spill_weights`` (keeps Eq.-1 transfer times
    balanced under capacity pressure). Integer waterfill: terminates because
    every round places at least one page."""
    caps = np.asarray(capacities, dtype=np.int64)
    want = np.asarray(target, dtype=np.int64)
    total = int(want.sum())
    if total > int(caps.sum()):
        raise ValueError(f"placing {total} pages exceeds aggregate capacity "
                         f"{int(caps.sum())}")
    counts = np.minimum(want, caps)
    deficit = total - int(counts.sum())
    sw = np.asarray(spill_weights, dtype=np.float64)
    while deficit > 0:
        room = caps - counts
        w = np.where(room > 0, np.maximum(sw, 0.0), 0.0)
        if w.sum() <= 0:
            w = np.where(room > 0, 1.0, 0.0)
        give = np.minimum(room, np.floor(deficit * w / w.sum()).astype(
            np.int64))
        if give.sum() == 0:  # fractional shares all rounded to zero
            give = np.zeros_like(counts)
            give[int(np.argmax(np.where(room > 0, w, -1.0)))] = 1
        counts += give
        deficit -= int(give.sum())
    return counts


# ---------------------------------------------------------------------------
# built-in policies
# ---------------------------------------------------------------------------

@register
class Uniform(PlacementPolicy):
    """Equal weight on every domain — the MPOL_INTERLEAVE baseline."""

    name = "uniform"

    def weights(self, ctx: PlacementContext) -> np.ndarray:
        return np.full(ctx.num_domains, 1.0 / ctx.num_domains)


@register
class BwapCanonical(PlacementPolicy):
    """w_d ∝ bw_d (Eq. 2): equalizes per-domain transfer times when every
    worker reads through the same domain list (degenerate-NUMA TPU case)."""

    name = "bwap_canonical"

    def weights(self, ctx: PlacementContext) -> np.ndarray:
        return interleave.normalize(ctx.bandwidths)


@register
class BwapDwp(PlacementPolicy):
    """Canonical weights scaled by DWP (§III-B1): worker-domain mass grows
    from its canonical share (dwp=0) to 1.0 (dwp=1), preserving relative
    weights inside the worker / non-worker clusters (Observation 3)."""

    name = "bwap_dwp"

    def weights(self, ctx: PlacementContext) -> np.ndarray:
        canon = interleave.normalize(ctx.bandwidths)
        return interleave.dwp_weights(canon, list(ctx.workers), ctx.dwp)


@register
class LocalFirst(PlacementPolicy):
    """Fill the fastest domain to capacity, then spill to the next — the
    first-touch / HBM-until-full baseline the paper's placement beats."""

    name = "local_first"

    def weights(self, ctx: PlacementContext) -> np.ndarray:
        c = self.counts(ctx)
        return interleave.normalize(np.maximum(c, 1e-9))

    def counts(self, ctx: PlacementContext) -> np.ndarray:
        caps = (ctx.capacities if ctx.capacities is not None
                else np.full(ctx.num_domains, ctx.num_pages, dtype=np.int64))
        counts = np.zeros(ctx.num_domains, dtype=np.int64)
        left = ctx.num_pages
        for i in np.argsort(-ctx.bandwidths, kind="stable"):
            take = min(left, int(caps[int(i)]))
            counts[int(i)] = take
            left -= take
            if left <= 0:
                break
        if left > 0:
            raise ValueError("local_first: pages exceed aggregate capacity")
        return counts


@register
class Coda(BwapDwp):
    """Compute-follows-data (DESIGN.md §11): ``bwap_dwp`` page placement
    plus work placement — the scheduler partitions each decode step into
    per-domain micro-batches (step stall = max over per-launch Eq.-1
    bottlenecks instead of one global max) and the engine re-homes hot
    shared pages (refcount>1, ranked by observatory heat) into fast
    domains with an all-holders remap, budgeted so migration never
    exceeds the stall it saves."""

    name = "coda"
    micro_batch = True
    rehome = True


# ---------------------------------------------------------------------------
# page-table helpers
# ---------------------------------------------------------------------------

def assign(policy: str | PlacementPolicy, ctx: PlacementContext) -> np.ndarray:
    """Page table ``page -> domain`` honouring the policy's counts (Alg. 1
    interleaves by the count vector, so fractions match exactly even after
    capacity clamping)."""
    c = resolve(policy).counts(ctx)
    return interleave.weighted_interleave(ctx.num_pages,
                                          np.maximum(c, 0) + 1e-9)


def weights(policy: str | PlacementPolicy,
            ctx: PlacementContext) -> np.ndarray:
    return interleave.normalize(resolve(policy).weights(ctx))
