"""Observability benchmarks of the PyTorch port (``src/repro_torch``): the
ports of ``benchmarks/obs_bench.py``'s ``calibration_loop`` (global and
micro-batch decode) and ``overhead``, on the same traces, pools and gates.

1. **Calibration loop.** The pool's bandwidth profile is planted wrong
   (``hbm_peer_1hop`` 2x optimistic, ``host_dram`` 2x pessimistic); a
   drift-ledger probe supplies per-domain transfer times at the true
   bandwidths; after the run ``bw_effective`` must sit within 10 % of the
   truth on every domain that carried traffic. Virtual clock: the counters
   match the reference's ``BENCH_obs.json`` on any params.
2. **Tracing overhead.** The scheduler-bench workload with the full
   observatory (tracer, metrics, heat) and without, interleaved pairs, best
   of ``repeats``: token-identical outputs, and the traced run must cost
   < 5 % more host wall time (a wall-time gate: it lives here, not in the
   tests).

Params and devices as in ``benchmarks/torch_scheduler_bench.py`` (default
``"cuda"``). Run as a module, it writes ``BENCH_torch_obs.json`` at the
repo root:

    PYTHONPATH=src python -m benchmarks.torch_obs_bench --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from benchmarks import artifacts
from benchmarks.torch_scheduler_bench import _domains, smoke
from repro_torch.core.dwp import DWPConfig
from repro_torch.obs import Observatory
from repro_torch.placement.pool import BwapPagePool, MemoryDomain
from repro_torch.scheduler import (KVSwapManager, PriorityClass,
                                   RequestScheduler, SloSpec, WorkloadSpec,
                                   generate)
from repro_torch.serve.engine import ServeEngine

# ground truth the probe measures against; the profile handed to the pool
# is planted wrong on the slow domains
BW_PROFILE = {"hbm_local": 819.0, "hbm_peer_1hop": 0.0025,
              "host_dram": 0.0004}
BW_TRUE = {"hbm_local": 819.0, "hbm_peer_1hop": 0.00125,
           "host_dram": 0.0008}
CAL_TOL = 0.10
OVERHEAD_TOL = 0.05
MIN_SAMPLES = 5          # a domain needs this many probe samples to gate


def calibration_loop(seed: int = 0, check: bool = True,
                     micro_batch: bool = False, *, params=None,
                     device="cuda") -> dict:
    """``micro_batch=True`` runs per-domain decode launches: the ledger
    bills each launch only for the domains it read
    (``DriftLedger.observe_launches``)."""
    cfg, params = smoke(params, device=device)
    names = list(BW_PROFILE)
    domains = [
        MemoryDomain(names[0], 10, BW_PROFILE[names[0]], True),
        MemoryDomain(names[1], 24, BW_PROFILE[names[1]], False),
        MemoryDomain(names[2], 60, BW_PROFILE[names[2]], False),
    ]
    pool = BwapPagePool(cfg, domains, page_size=4,
                        dwp_config=DWPConfig(n=10 ** 6, c=1), device=device)
    bw_true = np.asarray([BW_TRUE[n] for n in names])
    bw_profile = np.asarray([BW_PROFILE[n] for n in names])

    def probe(kind, bytes_per_domain):
        # "hardware counters": per-domain seconds under the true bandwidths
        return np.asarray(bytes_per_domain) / (bw_true * 1e9)

    swap = KVSwapManager(pool, placement="bwap_canonical",
                         reserve_fraction=0.9)
    sched = RequestScheduler(pool, max_batch=4, prefill_token_budget=32,
                             default_max_new=12, swap=swap,
                             micro_batch=micro_batch)
    eng = ServeEngine(cfg, params, pool, scheduler=sched,
                      wall_clock=False, sim_step_s=0.01, rehome=False,
                      device=device)
    obs = Observatory(pool, tracer=False, heat=False, probe=probe,
                      calibrate_every=2)
    trace = generate(WorkloadSpec(
        kind="poisson", num_requests=10, mean_interarrival_s=0.004,
        prompt_mean=14, prompt_max=28, max_new=12,
        vocab_size=cfg.vocab_size, seed=seed))
    for t in trace:
        eng.submit(t.prompt, max_new=t.max_new, arrival_s=t.arrival_s)
    steps = multi = 0
    while (eng.active or eng.waiting) and steps < 1500:
        info = eng.step()
        if info.get("launches", 0) > 1:
            multi += 1
        steps += 1

    s = obs.drift.summary()
    bw_eff = np.asarray(s["bw_effective_gbps"])
    rel_err = np.abs(bw_eff - bw_true) / bw_true
    err_before = np.abs(bw_profile - bw_true) / bw_true
    gated = [i for i in range(len(names))
             if s["domain_samples"][i] >= MIN_SAMPLES]
    row = {
        "domains": names,
        "bw_profile_gbps": [float(b) for b in bw_profile],
        "bw_true_gbps": [float(b) for b in bw_true],
        "bw_effective_gbps": [float(b) for b in bw_eff],
        "rel_err_before": [float(e) for e in err_before],
        "rel_err_after": [float(e) for e in rel_err],
        "gated_domains": [names[i] for i in gated],
        "observations": s["observations"],
        "calibrations": s["calibrations"],
        "domain_samples": s["domain_samples"],
        "ratio_p50": s["kinds"]["batch_read"]["ratio_p50"],
        "ratio_p95": s["kinds"]["batch_read"]["ratio_p95"],
        "finished": len(eng.finished),
        "requests": len(trace),
        "micro_batch": micro_batch,
        "multi_launch_steps": multi,
        "tolerance": CAL_TOL,
    }
    mode = "micro-batch" if micro_batch else "global"
    print(f"calibration ({mode}): {s['calibrations']} calibrations over "
          f"{s['observations']} observations, {len(eng.finished)}/"
          f"{len(trace)} requests"
          + (f", {multi} multi-launch steps" if micro_batch else ""))
    for i, n in enumerate(names):
        mark = "gated" if i in gated else f"{s['domain_samples'][i]} samples"
        print(f"  {n:14s} profile {bw_profile[i]:.5g} true {bw_true[i]:.5g} "
              f"-> effective {bw_eff[i]:.5g} GB/s  err "
              f"{err_before[i]:.0%} -> {rel_err[i]:.2%}  ({mark})")
    if check:
        assert len(eng.finished) == len(trace), "calibration run failed"
        assert {names[1], names[2]} <= set(row["gated_domains"]), \
            f"planted domains not exercised: {row['gated_domains']}"
        if micro_batch:
            assert multi > 0, \
                "micro-batch calibration never partitioned a step"
        for i in gated:
            assert err_before[i] <= CAL_TOL or rel_err[i] < err_before[i], \
                f"{names[i]}: calibration made the error worse"
            assert rel_err[i] <= CAL_TOL, \
                (f"{names[i]}: bw_effective {bw_eff[i]:.5g} not within "
                 f"{CAL_TOL:.0%} of ground truth {bw_true[i]:.5g} "
                 f"(err {rel_err[i]:.1%})")
    return row


def overhead_trace(vocab_size: int, seed: int = 0) -> list:
    return generate(WorkloadSpec(
        kind="bursty", num_requests=10, mean_interarrival_s=0.01,
        prompt_mean=24, prompt_max=40, max_new=16, vocab_size=vocab_size,
        class_mix=(("interactive", 0.25), ("batch", 0.75)), seed=seed))


def overhead_run(cfg, params, trace, *, with_obs: bool, device="cuda"):
    """One scheduler-bench-shaped run; returns (wall_s, tokens, obs)."""
    pool = BwapPagePool(cfg, _domains(), page_size=4,
                        dwp_config=DWPConfig(n=10 ** 6, c=1), device=device)
    swap = KVSwapManager(pool, placement="bwap_canonical",
                         reserve_fraction=0.95)
    sched = RequestScheduler(
        pool, max_batch=6, prefill_token_budget=32,
        classes=[PriorityClass("interactive", 2,
                               SloSpec(ttft_s=0.3, tpot_s=0.03)),
                 PriorityClass("batch", 0,
                               SloSpec(ttft_s=1.5, tpot_s=0.06))],
        default_class="batch", default_max_new=16, swap=swap)
    eng = ServeEngine(cfg, params, pool, scheduler=sched,
                      wall_clock=False, sim_step_s=0.005, device=device)
    # no drift probe: the virtual clock (and thus the schedule) must be
    # bit-identical with and without the observatory
    obs = Observatory(pool, drift=False) if with_obs else None
    for t in trace:
        eng.submit(t.prompt, cls=t.cls, max_new=t.max_new,
                   arrival_s=t.arrival_s)
    t0 = time.monotonic()
    steps = 0
    while (eng.active or eng.waiting) and steps < 3000:
        eng.step()
        steps += 1
    wall = time.monotonic() - t0
    tokens = [tuple(s.tokens) for s in sorted(eng.finished,
                                              key=lambda s: s.sid)]
    return wall, tokens, obs


def overhead(seed: int = 0, repeats: int = 3, check: bool = True, *,
             params=None, device="cuda") -> dict:
    cfg, params = smoke(params, device=device)
    trace = overhead_trace(cfg.vocab_size, seed)
    overhead_run(cfg, params, trace, with_obs=False, device=device)  # warm
    base, traced = [], []
    tokens_base = tokens_traced = obs = None
    for _ in range(repeats):                            # interleaved pairs
        w, tokens_base, _n = overhead_run(cfg, params, trace,
                                          with_obs=False, device=device)
        base.append(w)
        w, tokens_traced, obs = overhead_run(cfg, params, trace,
                                             with_obs=True, device=device)
        traced.append(w)
    best_base, best_traced = min(base), min(traced)
    pct = (best_traced - best_base) / best_base * 100.0
    identical = tokens_base == tokens_traced
    tracer = obs.tracer
    preempted = sorted({e["tid"] - 1 for e in tracer.spans("swap_out")})
    span_counts = {n: len(tracer.spans(n))
                   for n in ("admit", "queued", "prefill", "decode",
                             "swap_out", "swap_in", "finish")}
    row = {
        "base_s": best_base, "traced_s": best_traced,
        "overhead_pct": pct, "token_identical": identical,
        "trace_events": len(tracer.events),
        "span_counts": span_counts,
        "preempted_requests": preempted,
        "heat_live_pages": obs.heat.live_pages(),
        "repeats": repeats, "tolerance_pct": OVERHEAD_TOL * 100.0,
    }
    print(f"overhead: base {best_base * 1e3:.0f} ms, traced "
          f"{best_traced * 1e3:.0f} ms ({pct:+.2f}%; best of {repeats}); "
          f"{row['trace_events']} trace events, token_identical="
          f"{identical}")
    print("  spans: " + " ".join(f"{k}={v}"
                                 for k, v in span_counts.items()))
    if check:
        assert identical, "tracing changed the decoded tokens"
        assert pct < OVERHEAD_TOL * 100.0, \
            f"tracing overhead {pct:.2f}% exceeds {OVERHEAD_TOL:.0%}"
        assert preempted, "workload produced no preemption to trace"
        sid = preempted[0]
        for name in ("admit", "prefill", "decode", "swap_out", "swap_in",
                     "finish"):
            assert tracer.spans(name, sid=sid), \
                f"preempted request {sid} missing {name!r} span"
    return row


def suite(seed: int = 0, check: bool = True, device="cuda") -> dict:
    return {"calibration": calibration_loop(seed, check, device=device),
            "calibration_micro": calibration_loop(seed, check, True,
                                                  device=device),
            "overhead": overhead(seed, check=check, device=device)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the pools and params live (cuda or cpu)")
    args = ap.parse_args(argv)
    artifacts.dump("BENCH_torch_obs.json",
                   suite(seed=args.seed, check=not args.no_check,
                         device=args.device))


if __name__ == "__main__":
    main()
