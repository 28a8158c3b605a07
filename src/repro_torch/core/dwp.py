"""DWP tuner (paper §III-B): online 1-D hill climbing on a stall-rate stream.

The tuner is deliberately decoupled from *what* is being measured: the paper
reads hardware stall-cycle counters; our TPU serving integration feeds decode
step latencies; the simulator feeds modelled stall rates. Parameters follow
the paper (§IV): n=20 measurements per period, discard first/last c=5 as
outliers, t=0.2 s sampling interval, step x=10%.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import interleave


class Phase(enum.Enum):
    MEASURING = "measuring"
    DONE = "done"


@dataclasses.dataclass
class DWPConfig:
    n: int = 20            # samples per measurement period
    c: int = 5             # discard the c smallest and c largest samples
    t: float = 0.2         # seconds between samples (informational on TPU)
    x: float = 0.10        # DWP step
    rel_tolerance: float = 0.0  # stall-rate must drop by > tol to continue


def filtered_mean(samples: Sequence[float], c: int) -> float:
    """Sort, drop the first and last c, average the rest (paper §III-B1)."""
    s = np.sort(np.asarray(samples, dtype=np.float64))
    if len(s) > 2 * c:
        s = s[c:len(s) - c]
    return float(s.mean())


@dataclasses.dataclass
class TunerStep:
    dwp: float
    stall_rate: float
    migrated_pages: int


class DWPTuner:
    """Incremental hill climbing over DWP, migrating pages at each step.

    Usage::

        tuner = DWPTuner(canonical_weights, workers, num_pages)
        while not tuner.done:
            tuner.record(measure_stall_rate())   # n times per period
        placement = tuner.assignment             # final page table

    ``on_migrate`` is called with each MigrationPlan so the embedding system
    (simulator page tables, KV-cache pools, ZeRO shards) can execute it.

    ``capacity_fractions`` (optional) are per-node shares of the allocatable
    pool; when set, every assignment the tuner produces is clamped to them
    (``interleave.capacity_capped_weights``) — the swap-aware fix: a page
    pool holding a swap reservation feeds its *effective* capacities here so
    a high DWP cannot promise pages the reservation took away.
    """

    def __init__(
        self,
        canonical_weights: np.ndarray,
        workers: Sequence[int],
        num_pages: int,
        config: DWPConfig | None = None,
        on_migrate: Callable[[interleave.MigrationPlan], None] | None = None,
        start_dwp: float = 0.0,
        min_dwp: float = 0.0,
        capacity_fractions: np.ndarray | None = None,
    ):
        self.cfg = config or DWPConfig()
        self.canonical = interleave.normalize(canonical_weights)
        self.workers = tuple(workers)
        self.on_migrate = on_migrate
        self.min_dwp = min_dwp
        self.dwp = max(start_dwp, min_dwp)
        self.capacity_fractions = capacity_fractions
        self.assignment = interleave.weighted_interleave(
            num_pages, self._capped(interleave.dwp_weights(
                self.canonical, self.workers, self.dwp)))
        self.phase = Phase.MEASURING
        self._samples: list[float] = []
        self._prev_rate: float | None = None
        self._prev_assignment: np.ndarray | None = None
        self.history: list[TunerStep] = []

    # -- measurement stream -------------------------------------------------

    @property
    def done(self) -> bool:
        return self.phase is Phase.DONE

    def record(self, stall_rate: float) -> None:
        """Feed one stall-rate sample; advances DWP when a period completes."""
        if self.done:
            return
        self._samples.append(float(stall_rate))
        if len(self._samples) >= self.cfg.n:
            rate = filtered_mean(self._samples, self.cfg.c)
            self._samples = []
            self._on_period(rate)

    # -- hill climbing --------------------------------------------------------

    def _on_period(self, rate: float) -> None:
        if self._prev_rate is not None and not self._improved(rate):
            # Local optimum found. Roll back the last (non-improving) step:
            # the paper stops at the previous DWP ("maximum error margin of
            # 1 iterative step", §IV-B); migration both ways is supported in
            # our implementation (unlike mbind), so we restore it.
            if self._prev_assignment is not None:
                self._apply_assignment(self._prev_assignment)
                self.dwp = self._prev_dwp
            self.phase = Phase.DONE
            return
        migrated = 0
        if self.dwp + self.cfg.x <= 1.0 + 1e-9:
            self._prev_rate = rate
            self._prev_assignment = self.assignment.copy()
            self._prev_dwp = self.dwp
            self.dwp = min(self.dwp + self.cfg.x, 1.0)
            migrated = self._migrate_to(self.dwp)
        else:
            self.phase = Phase.DONE
        self.history.append(TunerStep(self.dwp, rate, migrated))

    def _improved(self, rate: float) -> bool:
        assert self._prev_rate is not None
        return rate < self._prev_rate * (1.0 - self.cfg.rel_tolerance)

    def _capped(self, weights: np.ndarray) -> np.ndarray:
        if self.capacity_fractions is None:
            return weights
        return interleave.capacity_capped_weights(weights,
                                                  self.capacity_fractions)

    def set_capacity_fractions(self, fractions: np.ndarray) -> int:
        """Effective capacities changed (a swap reservation was carved out
        or released): re-clamp the current assignment. Returns pages moved
        (delivered to ``on_migrate`` like any tuner step)."""
        self.capacity_fractions = np.asarray(fractions, dtype=np.float64)
        return self._migrate_to(self.dwp)

    def _migrate_to(self, dwp: float) -> int:
        new_w = self._capped(
            interleave.dwp_weights(self.canonical, self.workers, dwp))
        plan = interleave.plan_migration(self.assignment, new_w)
        self.assignment = plan.new_assignment
        if self.on_migrate:
            self.on_migrate(plan)
        return plan.num_moves

    def _apply_assignment(self, assignment: np.ndarray) -> None:
        changed = np.nonzero(assignment != self.assignment)[0]
        moves = np.stack([changed, self.assignment[changed],
                          assignment[changed]], axis=1)
        plan = interleave.MigrationPlan(
            moves=moves, old_assignment=self.assignment,
            new_assignment=assignment)
        self.assignment = assignment
        if self.on_migrate:
            self.on_migrate(plan)


# ---------------------------------------------------------------------------
# Co-scheduled variant (paper §III-B3): 2-stage search
# ---------------------------------------------------------------------------

class CoScheduledTuner:
    """Two applications in disjoint partitions: a high-priority A (not
    memory-intensive) and a best-effort B (memory-intensive, uses BWAP).

    Stage 1: increase B's DWP while *A's* stall rate keeps decreasing; when A
    stabilises we have a lower bound on B's DWP (B must not push more pages
    onto A's nodes than that). Stage 2: standard DWP search for B, starting
    at — and never going below — the bound.
    """

    def __init__(self, canonical_weights: np.ndarray, workers_b: Sequence[int],
                 num_pages: int, config: DWPConfig | None = None,
                 on_migrate=None):
        self.cfg = config or DWPConfig()
        self.stage = 1
        self._tuner = DWPTuner(canonical_weights, workers_b, num_pages,
                               config=self.cfg, on_migrate=on_migrate)
        self._samples_a: list[float] = []
        self._prev_a: float | None = None
        self.dwp_lower_bound = 0.0

    @property
    def done(self) -> bool:
        return self.stage == 2 and self._tuner.done

    @property
    def dwp(self) -> float:
        return self._tuner.dwp

    @property
    def assignment(self) -> np.ndarray:
        return self._tuner.assignment

    def record(self, stall_a: float, stall_b: float) -> None:
        if self.done:
            return
        if self.stage == 1:
            self._samples_a.append(stall_a)
            if len(self._samples_a) >= self.cfg.n:
                rate_a = filtered_mean(self._samples_a, self.cfg.c)
                self._samples_a = []
                improving = self._prev_a is None or rate_a < self._prev_a * \
                    (1.0 - self.cfg.rel_tolerance)
                self._prev_a = rate_a
                if improving and self._tuner.dwp + self.cfg.x <= 1.0:
                    self._tuner.dwp += self.cfg.x
                    self._tuner._migrate_to(self._tuner.dwp)
                else:
                    # A stabilised: freeze the bound, hand over to stage 2.
                    self.dwp_lower_bound = self._tuner.dwp
                    self._tuner.min_dwp = self.dwp_lower_bound
                    self._tuner._prev_rate = None
                    self._tuner._prev_assignment = None
                    self.stage = 2
        else:
            self._tuner.record(stall_b)
