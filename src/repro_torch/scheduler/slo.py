"""SLO accounting: TTFT, TPOT, and goodput under per-class deadlines.

Serving quality is not mean latency: a request is *good* only if its time to
first token (TTFT) and time per output token (TPOT) both meet the deadlines
of its priority class. Goodput — the metric the scheduler optimizes and
``benchmarks/scheduler_bench.py`` compares swap placements on — counts only
tokens from requests that met both deadlines, per unit time.

All times are scheduler-clock seconds (virtual time on CPU hosts: measured
wall plus the Eq.-1 analytic components — decode KV reads and swap
transfers — that supply the memory-domain asymmetry the host lacks).
Counters live in ``placement.telemetry.ClassSloCounters`` so the pool's
telemetry snapshot carries SLO state alongside placement state.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.placement.telemetry import ClassSloCounters


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """Per-class deadlines, seconds. ``inf`` = unconstrained."""

    ttft_s: float = math.inf
    tpot_s: float = math.inf


@dataclasses.dataclass
class RequestRecord:
    rid: int
    cls: str
    arrival_s: float
    first_token_s: float | None = None
    finish_s: float | None = None
    produced: int = 0
    preemptions: int = 0

    @property
    def ttft(self) -> float | None:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def tpot(self) -> float | None:
        """Mean inter-token time after the first token."""
        if self.finish_s is None or self.first_token_s is None:
            return None
        if self.produced <= 1:
            return 0.0
        return (self.finish_s - self.first_token_s) / (self.produced - 1)


class SloTracker:
    """Request lifecycle observer for one scheduler.

    ``counters`` is the pool telemetry's per-class block (attach_slo), so
    engine snapshots surface the same numbers ``summary()`` reports.
    """

    def __init__(self, specs: dict[str, SloSpec] | None = None,
                 counters: ClassSloCounters | None = None):
        self.specs = dict(specs or {})
        self.counters = counters or ClassSloCounters()
        self.records: dict[int, RequestRecord] = {}

    def spec(self, cls: str) -> SloSpec:
        return self.specs.get(cls, SloSpec())

    # -- lifecycle hooks (driven by the scheduler) ---------------------------

    def on_submit(self, rid: int, cls: str, arrival_s: float) -> None:
        self.records[rid] = RequestRecord(rid, cls, arrival_s)
        self.counters.add(cls, "submitted")

    def on_first_token(self, rid: int, now: float) -> None:
        r = self.records[rid]
        if r.first_token_s is None:
            r.first_token_s = now
            spec = self.spec(r.cls)
            met = (now - r.arrival_s) <= spec.ttft_s
            self.counters.add(r.cls, "ttft_met" if met else "ttft_missed")

    def on_finish(self, rid: int, now: float, produced: int) -> None:
        r = self.records[rid]
        r.finish_s = now
        r.produced = produced
        self.counters.add(r.cls, "completed")
        spec = self.spec(r.cls)
        tpot = r.tpot
        met = tpot is not None and tpot <= spec.tpot_s
        self.counters.add(r.cls, "tpot_met" if met else "tpot_missed")
        if self.is_good(r):
            self.counters.add(r.cls, "goodput_tokens", produced)

    def on_preempt(self, rid: int, pages: int) -> None:
        r = self.records[rid]
        r.preemptions += 1
        self.counters.add(r.cls, "preemptions")
        self.counters.add(r.cls, "swap_out_pages", pages)

    def on_resume(self, rid: int, pages: int) -> None:
        self.counters.add(self.records[rid].cls, "swap_in_pages", pages)

    # -- reporting ------------------------------------------------------------

    def is_good(self, r: RequestRecord) -> bool:
        """Completed and met both deadlines."""
        spec = self.spec(r.cls)
        return (r.finish_s is not None and r.ttft is not None
                and r.ttft <= spec.ttft_s
                and r.tpot is not None and r.tpot <= spec.tpot_s)

    def summary(self, now: float) -> dict:
        """Per-class metrics plus aggregate goodput over [0, now]."""
        per_cls: dict[str, list[RequestRecord]] = {}
        for r in self.records.values():
            per_cls.setdefault(r.cls, []).append(r)
        out: dict = {"classes": {}, "elapsed_s": now}
        total_good_tokens = 0
        total_completed = 0
        for cls, recs in sorted(per_cls.items()):
            done = [r for r in recs if r.finish_s is not None]
            good = [r for r in done if self.is_good(r)]
            ttfts = [r.ttft for r in done if r.ttft is not None]
            tpots = [r.tpot for r in done if r.tpot is not None]
            good_tokens = sum(r.produced for r in good)
            total_good_tokens += good_tokens
            total_completed += len(done)
            out["classes"][cls] = {
                "submitted": len(recs),
                "completed": len(done),
                "good": len(good),
                "slo_attainment": len(good) / max(len(done), 1),
                "ttft_mean_s": float(np.mean(ttfts)) if ttfts else 0.0,
                "ttft_p95_s": float(np.percentile(ttfts, 95))
                if ttfts else 0.0,
                "tpot_mean_s": float(np.mean(tpots)) if tpots else 0.0,
                "preemptions": sum(r.preemptions for r in recs),
                "goodput_tokens": good_tokens,
            }
        out["completed"] = total_completed
        out["good_tokens"] = total_good_tokens
        out["goodput_tok_s"] = total_good_tokens / max(now, 1e-9)
        # TTFT-weighted goodput: good tokens per second, discounted by the
        # aggregate mean TTFT — the figure of merit for prefill/decode
        # disaggregation (scheduler_bench.disagg_compare), where the win is
        # first tokens arriving sooner at equal token throughput
        all_ttfts = [r.ttft for r in self.records.values()
                     if r.ttft is not None]
        ttft_mean = float(np.mean(all_ttfts)) if all_ttfts else 0.0
        out["ttft_mean_s"] = ttft_mean
        out["ttft_weighted_goodput"] = (
            out["goodput_tok_s"] / max(ttft_mean, 1e-9))
        return out
