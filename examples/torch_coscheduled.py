"""Co-scheduled serving over one memory fabric (paper §III-B3 + DESIGN.md §8)
on the PyTorch port, on the card unless ``--device cpu`` is given: two
ServeEngine tenants share one machine's memory domains as views of a
single MemoryFabric, brokered by the placement arbiter. The port of
``examples/coscheduled.py`` (params drawn by ``torch.Generator`` from
seed 0).

Tenant A is high-priority (claims the fastest domain as its home); tenant B
is best-effort, bursty, and quota-starved. The run demonstrates the two
cross-tenant features the fabric API exists for:

- **Read-only prefix tier** — both tenants serve prompts that open with the
  same system preamble; A's prefilled pages register in the shared trie and
  B's requests map them straight into their views (shared physical pages
  across tenants > 0, physical footprint < logical).
- **Swap-slot loans** — B's own swap reservation is 2 slots, far below
  what preempting its bulk batch for a mid-run interactive burst needs;
  the fabric loans it A's idle reserved slots (grant), B parks preempted
  KV in them (use), and A reclaims them afterwards (reclaim, Eq.-1
  accounted). On isolated partitions the same burst cannot preempt —
  interactive requests wait in queue and B's makespan stretches.

Both features are placement-only: the same workload replayed on *isolated*
partitions (sharing and loans disabled) produces token-identical outputs —
asserted at the end — it just burns more physical pages and more waiting.

The arbiter still drives B with the two-stage co-scheduled DWP search
(stage 1 raises B's DWP while A's latency stream keeps improving, stage 2
optimizes B's own latency above the frozen bound); cycle moves re-home B's
live pages through the view's assignment-change subscription. When B
leaves, its quota redistributes to A as pure ledger arithmetic — no pool
rebuild, no page-id remapping.

    PYTHONPATH=src python examples/torch_coscheduled.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.dwp import DWPConfig
from repro_torch.device import resolve
from repro_torch.models.lm import LM
from repro_torch.placement.arbiter import DomainArbiter, DomainSpec, Priority
from repro_torch.scheduler import (KVSwapManager, PriorityClass,
                                   RequestScheduler)
from repro_torch.serve.engine import ServeEngine

INTERFERENCE_SCALE = 2e5   # maps resident-byte contention to the ms scale
A_BASE = 0.020             # A's isolated per-step stall baseline
A_HEADROOM = 0.25          # fraction of B's pages on A's home that A's
                           # controllers absorb: below it A is compute-bound
                           # and stops improving (the §III-B3 saturation
                           # that freezes the stage-1 bound)

SPECS = [
    DomainSpec("hbm_local", 192, 819.0),
    DomainSpec("hbm_peer_1hop", 160, 50.0),
    DomainSpec("hbm_pod1_dci", 96, 12.5),
    DomainSpec("host_dram", 256, 16.0),
]


def stall_a(arb):
    """A's stall stream: rises with the *fraction* of B's resident pages
    sitting on A's home domain (stationary under B's load growth),
    saturating at A's controller headroom."""
    used_b = arb.tenants["B"].view.used_pages()
    frac_on_a = used_b[arb.tenants["A"].home[0]] / max(used_b.sum(), 1)
    return A_BASE + 0.5 * max(0.0, float(frac_on_a) - A_HEADROOM)


def stall_b(arb, eng_b):
    """B's stall stream: Eq.-1 read time of its active pages plus the
    interference it sees on its own home domain."""
    pages = [p for s in eng_b.active for p in s.pages]
    return (arb.tenants["B"].view.expected_read_time(pages)
            + arb.interference("B", scale=INTERFERENCE_SCALE))


def build(cfg, params, shared: bool, device):
    """Two tenants over one fabric. ``shared=False`` keeps the same quotas
    but disables the prefix tier and the loan broker — isolated
    partitions, the baseline the fabric run must match token-for-token."""
    arb = DomainArbiter(SPECS, page_size=4, device=device)
    ta = arb.register("A", cfg, priority=Priority.HIGH, share=0.5,
                      share_prefix=shared)
    tb = arb.register("B", cfg, priority=Priority.BEST_EFFORT, share=0.07,
                      share_prefix=shared,
                      dwp_config=DWPConfig(n=6, c=1, rel_tolerance=0.0))
    swap_a = KVSwapManager(ta.view, reserve_fraction=0.5,
                           lend=shared, borrow=shared)
    # B owns just 2 parking slots: preempting one bulk victim (~5
    # exclusive pages) already needs the loan broker
    swap_b = KVSwapManager(tb.view, reserve_pages={"host_dram": 2},
                           lend=shared, borrow=shared)
    eng_a = ServeEngine(cfg, params, ta.view, wall_clock=False,
                        sim_step_s=0.01, device=device,
                        scheduler=RequestScheduler(
                            ta.view, max_batch=3, default_max_new=16,
                            swap=swap_a))
    # within B: an "interactive" class above the bulk default — its
    # mid-run burst is what forces preemption (and therefore parking)
    eng_b = ServeEngine(cfg, params, tb.view, wall_clock=False,
                        sim_step_s=0.01, device=device,
                        scheduler=RequestScheduler(
                            tb.view, max_batch=6, default_max_new=16,
                            swap=swap_b,
                            classes=[PriorityClass("B_hi", 5)]))
    return arb, (ta, eng_a, swap_a), (tb, eng_b, swap_b)


def workload(cfg, rng):
    """Fixed trace: a common 8-token system preamble (2 fabric pages),
    then per-request suffixes. A serves 3 requests; B a 6-request bulk
    batch plus a 3-request interactive burst injected mid-run."""
    preamble = rng.integers(1, cfg.vocab_size, 8).tolist()
    a_prompts = [preamble + rng.integers(1, cfg.vocab_size, 6).tolist()
                 for _ in range(3)]
    b_bulk = [preamble + rng.integers(1, cfg.vocab_size, 4).tolist()
              for _ in range(6)]
    b_hi = [preamble + rng.integers(1, cfg.vocab_size, 2).tolist()
            for _ in range(3)]
    return a_prompts, b_bulk, b_hi


def run(cfg, params, shared: bool, verbose: bool, device) -> dict:
    arb, (ta, eng_a, _), (tb, eng_b, swap_b) = build(cfg, params, shared,
                                                     device)
    a_prompts, b_bulk, b_hi = workload(cfg, np.random.default_rng(0))
    for p in a_prompts:
        eng_a.submit(list(p))
    for p in b_bulk:
        eng_b.submit(list(p))

    peak_shared = peak_borrowed_parked = step = 0
    while (eng_a.active or eng_a.waiting or eng_b.active
           or eng_b.waiting) and step < 400:
        if step == 12:                 # the interactive burst arrives
            for p in b_hi:
                eng_b.submit(list(p), cls="B_hi", max_new=8)
        if eng_a.active or eng_a.waiting:
            eng_a.step()
        if eng_b.active or eng_b.waiting:
            eng_b.step()
        step += 1
        arb.observe("A", stall_a(arb))
        arb.observe("B", stall_b(arb, eng_b))
        peak_shared = max(peak_shared, arb.fabric.cross_shared_pages())
        peak_borrowed_parked = max(
            peak_borrowed_parked,
            sum(1 for p in swap_b._out if p in swap_b._borrowed))
        if verbose and step % 10 == 0:
            b_on_a = int(tb.view.used_pages()[ta.home[0]])
            print(f"  step {step:3d} stage={tb.cotuner.stage} "
                  f"dwp={tb.dwp:.1f} "
                  f"bound={tb.cotuner.dwp_lower_bound:.1f} "
                  f"xshared={arb.fabric.cross_shared_pages():3d}p "
                  f"borrowed-parked={peak_borrowed_parked:2d} "
                  f"B-pages-on-A-home={b_on_a}")

    # loan cycle epilogue: A reclaims everything it lent out
    outstanding = sum(len(ln.slots) for ln in arb.fabric.loans
                      if ln.lender == "A")
    reclaimed, secs = ta.view.recall_loans(outstanding) \
        if outstanding else (0, 0.0)
    tokens = {
        "A": [list(s.tokens) for s in sorted(eng_a.finished,
                                             key=lambda s: s.sid)],
        "B": [list(s.tokens) for s in sorted(eng_b.finished,
                                             key=lambda s: s.sid)],
    }
    slo_b = eng_b.scheduler.slo.summary(eng_b.scheduler.now)["classes"]
    arb.fabric.check_invariants()
    return {
        "arb": arb, "ta": ta, "tb": tb, "eng_a": eng_a, "eng_b": eng_b,
        "tokens": tokens, "steps": step, "peak_shared": peak_shared,
        "peak_borrowed_parked": peak_borrowed_parked,
        "reclaimed": reclaimed, "reclaim_s": secs,
        "loans": [dataclasses.asdict(ln) for ln in arb.fabric.loans],
        "b_makespan": eng_b.scheduler.now,
        "b_hi_ttft": slo_b["B_hi"]["ttft_mean_s"],
        "b_hi_preempts_bulk": slo_b["B"]["preemptions"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the pools and params live (cuda or cpu)")
    dev = resolve(ap.parse_args(argv).device)
    cfg = registry.get_smoke_config("qwen2-0.5b")
    cfg = dataclasses.replace(cfg, num_layers=2, compute_dtype="float32")
    params = LM(cfg).init(torch.Generator(device=dev).manual_seed(0),
                          device=dev)

    print("one fabric, two tenant views (A high-priority, B best-effort "
          "burst):")
    fab = run(cfg, params, shared=True, verbose=True, device=dev)
    ta, tb, arb = fab["ta"], fab["tb"], fab["arb"]

    print(f"\ncross-tenant prefix tier: peak {fab['peak_shared']} physical "
          f"pages shared across tenants "
          f"(trie hits {arb.fabric.table.stats()['prefix_hit_pages']}p)")
    for ln in fab["loans"]:
        print(f"swap-slot loan {ln['lender']}->{ln['borrower']}: "
              f"granted {ln['granted']} slots, peak parked-in-borrowed "
              f"{fab['peak_borrowed_parked']}, reclaimed {ln['reclaimed']} "
              f"({ln['reclaim_seconds'] * 1e3:.1f} ms Eq.-1 vacate), "
              f"outstanding {len(ln['slots'])}")
    print(f"interactive burst: {fab['b_hi_preempts_bulk']} bulk "
          f"preemptions into borrowed slots, B_hi mean TTFT "
          f"{fab['b_hi_ttft'] * 1e3:.0f} ms")
    print(f"stage-1 lower bound on B's DWP: "
          f"{tb.cotuner.dwp_lower_bound:.1f} (protects A); "
          f"final DWP {tb.dwp:.1f} "
          f"({'done' if tb.cotuner.done else 'still searching'})")

    print("\nreplay on isolated partitions (no prefix tier, no loans):")
    iso = run(cfg, params, shared=False, verbose=False, device=dev)
    identical = fab["tokens"] == iso["tokens"]
    print(f"  isolated: 0 shared pages (peak {iso['peak_shared']}), "
          f"loans {len(iso['loans'])}, 0 preemptions "
          f"({iso['b_hi_preempts_bulk']}): the burst waits — B_hi mean "
          f"TTFT {iso['b_hi_ttft'] * 1e3:.0f} ms vs fabric "
          f"{fab['b_hi_ttft'] * 1e3:.0f} ms")
    print(f"  token-identical outputs fabric vs isolated: {identical}")
    assert identical, "fabric sharing/loans must not change tokens"
    assert fab["peak_shared"] > 0, "no cross-tenant sharing demonstrated"
    assert any(ln["granted"] > 0 for ln in fab["loans"]), \
        "no swap-slot loan demonstrated"

    # -- tenant B leaves: quota redistributes as ledger arithmetic ----------
    quota_before = int(ta.quotas.sum())
    grants = arb.unregister("B")
    print(f"\nB left; A's quota {quota_before} -> "
          f"{int(ta.quotas.sum())} pages "
          f"(granted per domain: {grants['A'].tolist()}; no pool rebuild, "
          f"no page remapping)")
    eng_a = fab["eng_a"]
    eng_a.submit(np.random.default_rng(1).integers(
        1, cfg.vocab_size, 8).tolist())
    while eng_a.active or eng_a.waiting:
        eng_a.step()
    print(f"A finished {len(eng_a.finished)} sequences end-to-end; "
          "occupancy "
          + " ".join(f"{k}={v:.0%}" for k, v in ta.view.occupancy().items()))


if __name__ == "__main__":
    main()
