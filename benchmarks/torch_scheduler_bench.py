"""Scheduler benchmarks of the PyTorch port (``src/repro_torch``): the
ports of ``benchmarks/scheduler_bench.py``'s ``run_config`` / ``compare``,
``prefix_compare``, ``fabric_compare``, ``persist_compare``,
``coda_compare`` and ``disagg_compare``, on the same traces, pools and
gates.

Everything runs on the virtual clock (``wall_clock=False``), so the
counters — steps, swaps, re-homed pages, makespan, goodput — are a property
of the schedule and match the reference's ``BENCH_*.json`` on any params.
The params are the one-layer fp32 qwen2 smoke config's, drawn by
``torch.Generator`` from seed 0 unless the caller passes some (the tests
pass the reference's, crossed through numpy, and then tokens match too).
Each function builds its pools on ``device`` (default ``"cuda"``, as every
entry point of the port; ``device="cpu"`` runs them where the reference's
benchmarks run) and writes nothing; run as a module, it writes
``BENCH_torch_scheduler.json``, ``BENCH_torch_prefix.json``,
``BENCH_torch_fabric.json``, ``BENCH_torch_persist.json``,
``BENCH_torch_coda.json`` and ``BENCH_torch_disagg.json`` at the repo root
(``persist_compare``'s prefix store goes to a temporary directory):

    PYTHONPATH=src python -m benchmarks.torch_scheduler_bench --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmarks import artifacts
from repro_torch.configs import registry
from repro_torch.core.dwp import DWPConfig
from repro_torch.models.lm import LM
from repro_torch.placement.pool import BwapPagePool, MemoryDomain
from repro_torch.scheduler import (KVSwapManager, PriorityClass,
                                   RequestScheduler, SloSpec, WorkloadSpec,
                                   generate, total_kv_pages)
from repro_torch.serve.engine import ServeEngine

PLACEMENTS = ("bwap_canonical", "local_first", "uniform")


def smoke(params=None, *, device="cuda"):
    """The benchmarks' model: the qwen2 smoke config cut to one fp32 layer;
    ``params`` as given, else drawn from seed 0 on ``device``."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    if params is None:
        params = LM(cfg).init(torch.Generator().manual_seed(0),
                              device=device)
    return cfg, params


def _domains():
    """``scheduler_bench._domains``: slow bandwidths scaled so one
    sequence's swap transfer is commensurate with a few decode steps."""
    return [
        MemoryDomain("hbm_local", 20, 819.0, True),
        MemoryDomain("hbm_peer_1hop", 30, 0.00125, False),
        MemoryDomain("hbm_pod1_dci", 30, 0.000325, False),
        MemoryDomain("host_dram", 80, 0.0004, False),
    ]


def run_config(placement: str, cfg, params, trace, *, max_new: int,
               sim_step_s: float = 0.005, device="cuda") -> dict:
    pool = BwapPagePool(cfg, _domains(), page_size=4,
                        dwp_config=DWPConfig(n=10 ** 6, c=1), device=device)
    swap = KVSwapManager(pool, placement=placement, reserve_fraction=0.95)
    sched = RequestScheduler(
        pool, max_batch=6, prefill_token_budget=32,
        classes=[PriorityClass("interactive", 2,
                               SloSpec(ttft_s=0.3, tpot_s=0.03)),
                 PriorityClass("batch", 0,
                               SloSpec(ttft_s=1.5, tpot_s=0.06))],
        default_class="batch", default_max_new=max_new, swap=swap)
    eng = ServeEngine(cfg, params, pool, scheduler=sched, wall_clock=False,
                      sim_step_s=sim_step_s, device=device)
    for t in trace:
        eng.submit(t.prompt, cls=t.cls, max_new=t.max_new,
                   arrival_s=t.arrival_s)
    steps = 0
    while (eng.active or eng.waiting) and steps < 3000:
        eng.step()
        steps += 1
    tel = pool.telemetry.snapshot()
    slo = sched.slo.summary(sched.now)
    return {
        "placement": placement,
        "finished": len(eng.finished),
        "requests": len(trace),
        "failed": len(trace) - len(eng.finished),
        "steps": steps,
        "makespan_s": sched.now,
        "swap_pages": tel["swap_outs"],
        "swap_seconds": tel["swap_seconds"],
        "goodput_tok_s": slo["goodput_tok_s"],
        "good_tokens": slo["good_tokens"],
        "classes": slo["classes"],
    }


def compare(requests: int = 12, max_new: int = 24, seed: int = 0,
            check: bool = True, *, params=None, device="cuda") -> dict:
    """Every swap placement on one oversubscribed bursty trace; gates: no
    failed request, something swapped, BWAP-weighted swap beats
    ``local_first`` on goodput."""
    cfg, params = smoke(params, device=device)
    trace = generate(WorkloadSpec(
        kind="bursty", num_requests=requests,
        mean_interarrival_s=0.01, prompt_mean=24, prompt_max=40,
        max_new=max_new, vocab_size=cfg.vocab_size,
        class_mix=(("interactive", 0.25), ("batch", 0.75)), seed=seed))
    hbm = _domains()[0].num_pages
    footprint = total_kv_pages(trace, 4)
    print(f"workload: {len(trace)} requests, KV footprint {footprint} pages "
          f"vs hbm_local {hbm} (x{footprint / hbm:.1f} oversubscribed)")
    rows = {}
    for placement in PLACEMENTS:
        r = run_config(placement, cfg, params, trace, max_new=max_new,
                       device=device)
        rows[placement] = r
        print(f"  {placement:15s} goodput {r['goodput_tok_s']:7.1f} tok/s  "
              f"makespan {r['makespan_s']:.2f}s  swaps {r['swap_pages']:3d} "
              f"pages ({r['swap_seconds'] * 1e3:6.0f} ms)  "
              f"failed {r['failed']}")
    bwap = rows["bwap_canonical"]["goodput_tok_s"]
    lf = rows["local_first"]["goodput_tok_s"]
    print(f"-> BWAP-weighted swap vs local_first: "
          f"{bwap / max(lf, 1e-9):.3f}x goodput")
    if check:
        for placement, r in rows.items():
            assert r["failed"] == 0, \
                f"{placement}: {r['failed']} requests failed under swap"
        assert rows["bwap_canonical"]["swap_pages"] > 0, \
            "benchmark exerted no memory pressure — nothing was swapped"
        assert bwap > lf, (
            f"BWAP swap placement must beat local_first on goodput "
            f"(got {bwap:.1f} vs {lf:.1f} tok/s)")
    return rows


def prefix_compare(requests: int = 12, max_new: int = 8, seed: int = 0,
                   check: bool = True, *, params=None,
                   device="cuda") -> dict:
    """Prefix reuse on/off over a shared-prefix heavy-tail trace; gates:
    >= 1.5x peak physical footprint reduction with reuse on, fewer prefill
    forward tokens, token-identical outputs."""
    cfg, params = smoke(params, device=device)
    trace = generate(WorkloadSpec(
        kind="heavy_tail", num_requests=requests,
        mean_interarrival_s=0.002, prompt_mean=6, prompt_max=24,
        max_new=max_new, vocab_size=cfg.vocab_size, seed=seed,
        prefix_len=32, prefix_groups=2, prefix_frac=0.9))

    def run(reuse: bool) -> dict:
        domains = [MemoryDomain("hbm_local", 96, 819.0, True),
                   MemoryDomain("hbm_peer_1hop", 96, 0.05, False),
                   MemoryDomain("host_dram", 96, 0.016, False)]
        pool = BwapPagePool(cfg, domains, page_size=4,
                            dwp_config=DWPConfig(n=10 ** 6, c=1),
                            device=device)
        sched = RequestScheduler(pool, max_batch=requests,
                                 prefill_token_budget=64,
                                 default_max_new=max_new)
        eng = ServeEngine(cfg, params, pool, scheduler=sched,
                          wall_clock=False, sim_step_s=0.005,
                          prefix_reuse=reuse, device=device)
        for t in trace:
            eng.submit(t.prompt, max_new=t.max_new, arrival_s=t.arrival_s)
        peak_phys = peak_logical = steps = 0
        while (eng.active or eng.waiting) and steps < 3000:
            info = eng.step()
            pt = info.get("pagetable", {})
            peak_phys = max(peak_phys, pt.get("physical_pages", 0))
            peak_logical = max(peak_logical, pt.get("logical_pages", 0))
            steps += 1
        slo = sched.slo.summary(sched.now)
        return {
            "prefix_reuse": reuse,
            "finished": len(eng.finished),
            "steps": steps,
            "peak_physical_pages": peak_phys,
            "peak_logical_pages": peak_logical,
            "prefill_tokens_computed": eng.prefill_tokens_computed,
            "cow_faults": pool.table.cow_faults,
            "prefix_hit_pages": pool.table.prefix_hit_pages,
            "makespan_s": sched.now,
            "goodput_tok_s": slo["goodput_tok_s"],
            "tokens": {s.sid: list(s.tokens) for s in eng.finished},
        }

    on, off = run(True), run(False)
    ratio = off["peak_physical_pages"] / max(on["peak_physical_pages"], 1)
    for r in (on, off):
        print(f"  prefix_reuse={str(r['prefix_reuse']):5s} "
              f"peak phys {r['peak_physical_pages']:4d} pages "
              f"(logical {r['peak_logical_pages']:4d})  prefill fwd "
              f"{r['prefill_tokens_computed']:5d} tok  goodput "
              f"{r['goodput_tok_s']:7.1f} tok/s  cow {r['cow_faults']}")
    print(f"-> prefix reuse shrinks peak physical KV footprint {ratio:.2f}x")
    if check:
        assert on["finished"] == off["finished"] == len(trace)
        assert on["tokens"] == off["tokens"], \
            "prefix sharing changed generated tokens"
        assert ratio >= 1.5, (
            f"prefix reuse must cut peak physical footprint >= 1.5x "
            f"(got {ratio:.2f}x)")
        assert on["prefill_tokens_computed"] < off["prefill_tokens_computed"]
    return {"reuse_on": {k: v for k, v in on.items() if k != "tokens"},
            "reuse_off": {k: v for k, v in off.items() if k != "tokens"},
            "footprint_reduction": ratio}


def fabric_compare(seed: int = 0, check: bool = True, *, params=None,
                   device="cuda") -> dict:
    """Two tenants on one arbiter's fabric (cross-tenant prefix tier and
    swap-slot loans) vs isolated partitions with the same quotas; gates:
    token-identical outputs, no failure, a loan cycle and cross-tenant
    sharing, best-effort goodput >= 1.2x isolated, the priority tenant's
    goodput and TTFT p95 within 2 %."""
    from repro_torch.placement.arbiter import (DomainArbiter, DomainSpec,
                                               Priority)

    cfg, params = smoke(params, device=device)
    specs = [DomainSpec("hbm_local", 144, 819.0),
             DomainSpec("hbm_peer_1hop", 96, 0.05),
             DomainSpec("hbm_pod1_dci", 72, 0.0125),
             DomainSpec("host_dram", 192, 0.016)]
    # every best-effort request opens with a different system preamble,
    # each registered by a long-running priority request
    groups = 10
    rng = np.random.default_rng(seed)
    preambles = [rng.integers(1, cfg.vocab_size, 32).tolist()
                 for _ in range(groups)]
    a_prompts = [preambles[g] + rng.integers(1, cfg.vocab_size, 4).tolist()
                 for g in range(groups)]
    b_bulk = [(preambles[i]
               + rng.integers(1, cfg.vocab_size, 4).tolist())
              for i in range(groups)]
    b_hi = [(preambles[i]
             + rng.integers(1, cfg.vocab_size, 2).tolist())
            for i in range(3)]

    def run(shared: bool) -> dict:
        arb = DomainArbiter(specs, page_size=4, seed=seed, device=device)
        ta = arb.register("A", cfg, priority=Priority.HIGH, share=0.55,
                          share_prefix=shared)
        tb = arb.register("B", cfg, priority=Priority.BEST_EFFORT,
                          share=0.12, share_prefix=shared,
                          dwp_config=DWPConfig(n=10 ** 6, c=1))
        swap_a = KVSwapManager(ta.view, reserve_fraction=0.3,
                               lend=shared, borrow=shared)
        swap_b = KVSwapManager(tb.view, reserve_pages={"host_dram": 2},
                               lend=shared, borrow=shared)
        eng_a = ServeEngine(cfg, params, ta.view, wall_clock=False,
                            sim_step_s=0.005, device=device,
                            scheduler=RequestScheduler(
                                ta.view, max_batch=groups,
                                default_max_new=40, swap=swap_a,
                                conservative_admission=True,
                                classes=[PriorityClass(
                                    "A", 10,
                                    SloSpec(ttft_s=1.0, tpot_s=0.1))]))
        eng_b = ServeEngine(cfg, params, tb.view, wall_clock=False,
                            sim_step_s=0.005, device=device,
                            scheduler=RequestScheduler(
                                tb.view, max_batch=8, default_max_new=12,
                                swap=swap_b,
                                conservative_admission=True,
                                classes=[PriorityClass("B_hi", 5)]))
        for p in a_prompts:
            eng_a.submit(list(p))
        for _ in range(3):             # A prefills + registers the tier
            eng_a.step()
        for p in b_bulk:
            eng_b.submit(list(p))
        peak_shared = step = 0
        while (eng_a.active or eng_a.waiting or eng_b.active
               or eng_b.waiting) and step < 2000:
            if step == 6:              # interactive burst mid-bulk
                for p in b_hi:
                    eng_b.submit(list(p), cls="B_hi", max_new=8)
            if eng_a.active or eng_a.waiting:
                eng_a.step()
            if eng_b.active or eng_b.waiting:
                eng_b.step()
            step += 1
            peak_shared = max(peak_shared, arb.fabric.cross_shared_pages())
        # loan-cycle epilogue: the lender recalls everything it lent
        outstanding = sum(len(ln.slots) for ln in arb.fabric.loans
                          if ln.lender == "A")
        if outstanding:
            got, _ = ta.view.recall_loans(outstanding)
            assert got == outstanding, "idle loaned slots must all return"
        arb.fabric.check_invariants()
        slo_a = eng_a.scheduler.slo.summary(eng_a.scheduler.now)
        slo_b = eng_b.scheduler.slo.summary(eng_b.scheduler.now)
        loans = arb.fabric.stats()["loans"]
        return {
            "shared": shared,
            "steps": step,
            "a_finished": len(eng_a.finished),
            "b_finished": len(eng_b.finished),
            "a_goodput_tok_s": slo_a["goodput_tok_s"],
            "a_ttft_p95_s": slo_a["classes"]["A"]["ttft_p95_s"],
            "b_goodput_tok_s": slo_b["goodput_tok_s"],
            "b_makespan_s": eng_b.scheduler.now,
            "b_hi_ttft_mean_s": slo_b["classes"]["B_hi"]["ttft_mean_s"],
            "b_preemptions": slo_b["classes"]["B"]["preemptions"],
            "peak_cross_shared_pages": peak_shared,
            "loans_granted": sum(ln["granted"] for ln in loans),
            "loans_reclaimed": sum(ln["reclaimed"] for ln in loans),
            "tokens": {
                "A": [list(s.tokens) for s in
                      sorted(eng_a.finished, key=lambda s: s.sid)],
                "B": [list(s.tokens) for s in
                      sorted(eng_b.finished, key=lambda s: s.sid)],
            },
        }

    fab, iso = run(True), run(False)
    ratio = fab["b_goodput_tok_s"] / max(iso["b_goodput_tok_s"], 1e-9)
    for r in (fab, iso):
        mode = "fabric " if r["shared"] else "isolated"
        print(f"  {mode} B goodput {r['b_goodput_tok_s']:7.1f} tok/s "
              f"(makespan {r['b_makespan_s']:.2f}s, "
              f"B_hi ttft {r['b_hi_ttft_mean_s'] * 1e3:5.1f} ms, "
              f"preempts {r['b_preemptions']})  A goodput "
              f"{r['a_goodput_tok_s']:6.1f}  xshared "
              f"{r['peak_cross_shared_pages']:3d}p  loans "
              f"{r['loans_granted']}")
    print(f"-> fabric vs isolated: {ratio:.2f}x best-effort goodput")
    if check:
        assert fab["tokens"] == iso["tokens"], \
            "fabric sharing/loans changed generated tokens"
        assert fab["a_finished"] == iso["a_finished"] == len(a_prompts)
        assert fab["b_finished"] == iso["b_finished"] \
            == len(b_bulk) + len(b_hi)
        assert fab["peak_cross_shared_pages"] > 0, \
            "no cross-tenant prefix sharing happened"
        assert fab["loans_granted"] > 0 and fab["loans_reclaimed"] > 0, \
            "no swap-slot loan cycle happened"
        assert iso["loans_granted"] == 0
        assert ratio >= 1.2, (
            f"fabric must lift best-effort goodput >= 1.2x isolated "
            f"(got {ratio:.2f}x)")
        assert fab["a_goodput_tok_s"] >= 0.98 * iso["a_goodput_tok_s"], \
            "priority-tenant goodput regressed under the fabric"
        assert fab["a_ttft_p95_s"] <= 1.02 * iso["a_ttft_p95_s"] + 1e-9, \
            "priority-tenant TTFT p95 regressed under the fabric"
    return {"fabric": {k: v for k, v in fab.items() if k != "tokens"},
            "isolated": {k: v for k, v in iso.items() if k != "tokens"},
            "best_effort_goodput_ratio": ratio}


# persist_compare's setup (persist_trace, persist_run), shared with
# chip_smoke.py's full-width persistence phase
PERSIST_DOMAINS = (("hbm_local", 64, 819.0, True),
                   ("hbm_peer_1hop", 48, 0.05, False),
                   ("host_dram", 64, 0.016, False))
PERSIST_TIER_GBPS = 0.008


def persist_trace(vocab_size: int, seed: int = 0) -> tuple[list, list,
                                                           list]:
    """(preambles, warmup prompts, phase-2 prompts): two 48-token system
    preambles, one warmup request per preamble, then 8 requests cycling
    the two preambles with 2-5 own tokens."""
    rng = np.random.default_rng(seed)
    groups, requests = 2, 8
    preambles = [rng.integers(1, vocab_size, 48).tolist()
                 for _ in range(groups)]
    warmup = [preambles[g] + rng.integers(1, vocab_size, 4).tolist()
              for g in range(groups)]
    phase2 = [preambles[i % groups]
              + rng.integers(1, vocab_size, 2 + i % 4).tolist()
              for i in range(requests)]
    return preambles, warmup, phase2


def persist_run(cfg, params, store, *, seed: int = 0, bw_scale: float = 1,
                hook=None, device="cuda") -> dict:
    """``persist_compare``'s three engines, its domains' and tier's
    bandwidths times ``bw_scale``, the prefix store under ``store``:
    engine ``oracle`` serves the warmup, pins and exports the preamble
    chains, then serves phase 2 uninterrupted; ``warm`` is a restart that
    imports the store; ``cold`` a restart without one. ``hook(name,
    engine)``, when given, sees each engine once it is built (its tier
    attached), before it serves. Returns each engine's record (tokens
    included), the export's manifest, and the pages and Eq.-1 seconds the
    import restored."""
    from repro_torch.placement.fabric import as_view
    from repro_torch.placement.persist import PersistentTier

    preambles, warmup, phase2 = persist_trace(cfg.vocab_size, seed)
    store = Path(store)
    store.mkdir(parents=True, exist_ok=True)

    def boot(name, tier):
        pool = BwapPagePool(cfg, [MemoryDomain(n, pages, bw * bw_scale, fast)
                                  for n, pages, bw, fast in PERSIST_DOMAINS],
                            page_size=4, dwp_config=DWPConfig(n=10 ** 6, c=1),
                            device=device)
        view = as_view(pool)
        if tier is not None:
            view.fabric.attach_persist(tier)
        sched = RequestScheduler(pool, max_batch=len(phase2),
                                 prefill_token_budget=16,
                                 default_max_new=8)
        eng = ServeEngine(cfg, params, pool, scheduler=sched,
                          wall_clock=False, sim_step_s=0.005, device=device)
        if hook is not None:
            hook(name, eng)
        return pool, view, eng

    def tier():
        return PersistentTier(bw_gbps=PERSIST_TIER_GBPS * bw_scale,
                              capacity_pages=64, directory=store)

    def drain(eng) -> int:
        steps = 0
        while (eng.active or eng.waiting) and steps < 3000:
            eng.step()
            steps += 1
        return steps

    def run_phase2(eng, pool) -> dict:
        for p in phase2:
            eng.submit(list(p), arrival_s=0.0)
        hits0 = pool.table.prefix_hit_pages
        eng.step()
        first_hits = pool.table.prefix_hit_pages - hits0
        steps = drain(eng) + 1
        slo = eng.scheduler.slo.summary(eng.scheduler.now)
        toks = [list(s.tokens) for s in
                sorted(eng.finished, key=lambda s: s.sid)[-len(phase2):]]
        return {"steps": steps,
                "finished": len(eng.finished),
                "ttft_mean_s": slo["classes"]["default"]["ttft_mean_s"],
                "first_step_prefix_hit_pages": first_hits,
                "tokens": toks}

    # phase 1: serve the preamble groups, then pin + export their chains
    tier_a = tier()
    pool_a, view_a, eng_a = boot("oracle", tier_a)
    for p in warmup:
        eng_a.submit(list(p))
    # pin while the warmup requests are live: the trie drops a chain when
    # its last holder releases, so the pin's own holds must land between
    # prefill (registration) and sequence finish
    pinned = [None] * len(preambles)
    steps = 0
    while (eng_a.active or eng_a.waiting) and steps < 3000:
        eng_a.step()
        steps += 1
        for g, p in enumerate(preambles):
            if pinned[g] is None:
                pinned[g] = tier_a.pin(view_a, p)
    assert all(k is not None for k in pinned), \
        "warmup left no preamble chain to pin"
    manifest = tier_a.export_prefixes(view_a)
    view_a.fabric.check_invariants()

    oracle = run_phase2(eng_a, pool_a)        # A continues uninterrupted

    tier_b = tier()                           # restart: reload the store
    pool_b, view_b, eng_b = boot("warm", tier_b)
    restored, restore_s = tier_b.import_prefixes(view_b)
    view_b.fabric.check_invariants()
    warm = run_phase2(eng_b, pool_b)

    pool_c, view_c, eng_c = boot("cold", None)   # cold restart: empty trie
    cold = run_phase2(eng_c, pool_c)
    return {"oracle": oracle, "warm": warm, "cold": cold,
            "manifest": manifest, "restored": restored,
            "restore_s": restore_s, "phase2": len(phase2)}


def persist_compare(seed: int = 0, check: bool = True, *, params=None,
                    store=None, device="cuda") -> dict:
    """Warm-restart vs cold-restart TTFT over a shared-prefix trace
    (``persist_run``); gates: generated tokens identical across the three
    engines, the warm engine's very first step hits the restored trie, the
    cold one's does not, and cold mean TTFT / warm mean TTFT >= 1.3x. The
    prefix store goes to ``store``, a temporary directory by default."""
    cfg, params = smoke(params, device=device)
    with (tempfile.TemporaryDirectory() if store is None
          else contextlib.nullcontext(store)) as where:
        r = persist_run(cfg, params, where, seed=seed, device=device)
    oracle, warm, cold = r["oracle"], r["warm"], r["cold"]
    manifest, restored, restore_s = r["manifest"], r["restored"], \
        r["restore_s"]
    identical = warm["tokens"] == cold["tokens"] == oracle["tokens"]

    ratio = cold["ttft_mean_s"] / max(warm["ttft_mean_s"], 1e-9)
    for name, row in (("oracle", oracle), ("warm", warm), ("cold", cold)):
        print(f"  {name:7s} ttft_mean {row['ttft_mean_s'] * 1e3:7.1f} ms  "
              f"first-step prefix hits "
              f"{row['first_step_prefix_hit_pages']:3d} pages  steps "
              f"{row['steps']:3d}")
    print(f"-> warm restart ({len(manifest['chains'])} chains, {restored} "
          f"pages, restore {restore_s * 1e3:.2f} ms) vs cold: "
          f"{ratio:.2f}x mean TTFT")
    if check:
        assert identical, "restart (warm or cold) changed generated tokens"
        assert restored > 0, "prefix store restored nothing"
        assert warm["first_step_prefix_hit_pages"] > 0, \
            "first request after warm restart missed the restored trie"
        assert cold["first_step_prefix_hit_pages"] == 0, \
            "cold restart had a non-empty trie — not a restart baseline"
        assert warm["finished"] == cold["finished"] == r["phase2"]
        assert ratio >= 1.3, (
            f"warm restart must beat cold on mean TTFT >= 1.3x "
            f"(got {ratio:.2f}x)")
    return {"oracle": {k: v for k, v in oracle.items() if k != "tokens"},
            "warm": {k: v for k, v in warm.items() if k != "tokens"},
            "cold": {k: v for k, v in cold.items() if k != "tokens"},
            "restored_pages": restored,
            "restore_seconds": restore_s,
            "exported_chains": len(manifest["chains"]),
            "ttft_cold_over_warm": ratio,
            "token_identical": identical}


# coda_compare's setup (coda_trace, CODA_DOMAINS, coda_engine), shared with
# chip_smoke.py's full-width coda phase
CODA_DOMAINS = (("hbm_local", 34, 819.0, True),
                ("hbm_peer_1hop", 24, 0.00125, False),
                ("host_dram", 40, 0.0004, False))


def coda_trace(vocab_size: int, seed: int = 0) -> list:
    """The ``domain_skew`` trace: a back-to-back flood of 48-token prompts
    (decode trimmed to 10 tokens) fills the fast domain, so the steady
    tail's shared 32-token template lands in the slow domains."""
    trace = generate(WorkloadSpec(
        kind="domain_skew", num_requests=6, skew_frac=0.5,
        mean_interarrival_s=0.02, prompt_mean=2, prompt_max=48,
        max_new=32, vocab_size=vocab_size, seed=seed,
        prefix_len=32, prefix_groups=1, prefix_frac=1.0))
    return [dataclasses.replace(t, max_new=10) if len(t.prompt) == 48
            else t for t in trace]


def coda_engine(cfg, params, policy: str, *, observatory: dict | None = None,
                bw_scale: float = 1, device="cuda"):
    """``coda_compare``'s pool, scheduler and engine under ``policy``, the
    domains' bandwidths times ``bw_scale``; with an ``Observatory`` built
    from the keywords ``observatory`` when given. Returns (pool, engine,
    observatory or None)."""
    from repro_torch.obs.observatory import Observatory

    # hbm_local holds the flood's 36 prompt pages while the sharers
    # prefill (template -> slow), and the sharers' whole footprint once
    # the flood drains: only re-homing can move the prefix
    pool = BwapPagePool(cfg, [MemoryDomain(n, pages, bw * bw_scale, fast)
                              for n, pages, bw, fast in CODA_DOMAINS],
                        page_size=4, policy=policy,
                        dwp_config=DWPConfig(n=10 ** 6, c=1), device=device)
    obs = Observatory(pool, **observatory) if observatory is not None \
        else None
    sched = RequestScheduler(pool, max_batch=8, prefill_token_budget=32,
                             default_max_new=32)
    eng = ServeEngine(cfg, params, pool, scheduler=sched, wall_clock=False,
                      sim_step_s=0.01, device=device)
    return pool, eng, obs


def coda_compare(seed: int = 0, check: bool = True, *, params=None,
                 device="cuda") -> dict:
    """Compute-follows-data (``coda``: per-domain decode micro-batches and
    heat-driven re-homing of the hot shared prefix) vs global batching
    (``bwap_dwp``) on the ``domain_skew`` trace; gates: token-identical
    outputs by sid, no failure, clean fabric invariants, ``coda``
    re-homed > 0 pages and partitioned a step, goodput >= 1.15x
    global."""
    cfg, params = smoke(params, device=device)
    trace = coda_trace(cfg.vocab_size, seed)

    def run(policy: str) -> dict:
        # heat for re-homing from an observatory, as the reference's
        pool, eng, _ = coda_engine(cfg, params, policy, device=device,
                                   observatory=dict(tracer=False,
                                                    drift=False))
        view, sched = eng.view, eng.scheduler
        for t in trace:
            eng.submit(t.prompt, max_new=t.max_new, arrival_s=t.arrival_s)
        steps = multi = 0
        while (eng.active or eng.waiting) and steps < 3000:
            info = eng.step()
            if info.get("launches", 0) > 1:
                multi += 1
            steps += 1
        view.fabric.check_invariants()
        slo = sched.slo.summary(sched.now)
        return {
            "policy": policy,
            "finished": len(eng.finished),
            "failed": len(trace) - len(eng.finished),
            "steps": steps,
            "multi_launch_steps": multi,
            "rehomed_pages": eng.rehomed_pages,
            "makespan_s": sched.now,
            "goodput_tok_s": slo["goodput_tok_s"],
            "tokens": {s.sid: list(s.tokens) for s in eng.finished},
        }

    coda, glob = run("coda"), run("bwap_dwp")
    identical = coda["tokens"] == glob["tokens"]
    ratio = coda["goodput_tok_s"] / max(glob["goodput_tok_s"], 1e-9)
    for r in (coda, glob):
        print(f"  {r['policy']:9s} goodput {r['goodput_tok_s']:7.1f} tok/s "
              f"makespan {r['makespan_s']:.3f}s  steps {r['steps']:3d} "
              f"(multi-launch {r['multi_launch_steps']:3d})  rehomed "
              f"{r['rehomed_pages']:2d} pages  failed {r['failed']}")
    print(f"-> compute-follows-data vs global batching: {ratio:.2f}x "
          f"goodput (token-identical: {identical})")
    if check:
        assert identical, \
            "micro-batching/re-homing changed generated tokens"
        assert coda["failed"] == glob["failed"] == 0
        assert coda["rehomed_pages"] > 0, \
            "no hot shared page was re-homed — the scenario lost its teeth"
        assert glob["rehomed_pages"] == 0
        assert coda["multi_launch_steps"] > 0, \
            "coda never partitioned a decode step"
        assert ratio >= 1.15, (
            f"compute-follows-data must beat global batching >= 1.15x "
            f"goodput (got {ratio:.2f}x)")
    return {"coda": {k: v for k, v in coda.items() if k != "tokens"},
            "global": {k: v for k, v in glob.items() if k != "tokens"},
            "goodput_ratio": ratio,
            "token_identical": identical}


# disagg_compare's setup (disagg_prompts, disagg_run), shared with
# chip_smoke.py's full-width disaggregation phase
DISAGG_DOMAINS = (("hbm_local", 96, 819.0, True),
                  ("host_dram", 96, 0.016, False))
DISAGG_TIER_GBPS = 8.0
DISAGG_LINKS = (("nvl", 0.2, 1e-4), ("rdma", 0.05, 5e-4))


def disagg_prompts(vocab_size: int, seed: int = 0) -> list:
    """A prefill-heavy burst: 10 prompts of 40-55 tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab_size, int(n)).tolist()
            for n in rng.integers(40, 56, 10)]


def disagg_run(cfg, params, *, seed: int = 0, bw_scale: float = 1,
               hook=None, device="cuda") -> dict:
    """``disagg_compare``'s two setups, every Eq.-1 bandwidth (domains,
    tiers, the wire's links) and the wire's chunk size times ``bw_scale``
    (a handoff of pages ``bw_scale`` times larger then takes as many
    chunks, so as many link latencies): one host (page 8) serves
    the burst alone; then a prefill host (page 4) admits each prompt with
    ``max_new=1`` and hands its range over the Eq.-5-striped wire to a
    decode host (page 8). ``hook(name, obj)``, when given, sees the
    ``single``, ``prefill`` and ``decode`` engines once built and the
    ``router`` before anything is served. Returns both records (tokens
    included), the router, its channel and the wire."""
    from repro_torch.cluster import (ClusterRouter, Interconnect, Link,
                                     PageChannel)
    from repro_torch.placement.fabric import as_view
    from repro_torch.placement.persist import PersistentTier

    prompts = disagg_prompts(cfg.vocab_size, seed)
    max_new = 6

    def host(name, page_size):
        pool = BwapPagePool(cfg, [MemoryDomain(n, pages, bw * bw_scale, fast)
                                  for n, pages, bw, fast in DISAGG_DOMAINS],
                            page_size=page_size,
                            dwp_config=DWPConfig(n=10 ** 6, c=1),
                            device=device)
        view = as_view(pool)
        view.fabric.attach_persist(PersistentTier(
            bw_gbps=DISAGG_TIER_GBPS * bw_scale, capacity_pages=256))
        sched = RequestScheduler(pool, max_batch=10,
                                 prefill_token_budget=32,
                                 default_max_new=max_new)
        eng = ServeEngine(cfg, params, pool, scheduler=sched,
                          wall_clock=False, sim_step_s=0.005, device=device)
        if hook is not None:
            hook(name, eng)
        return view, eng

    # single host: prefills and decodes share every step
    view_s, eng_s = host("single", 8)
    for p in prompts:
        eng_s.submit(list(p), max_new=max_new)
    steps = 0
    while (eng_s.active or eng_s.waiting) and steps < 3000:
        eng_s.step()
        steps += 1
    slo = eng_s.scheduler.slo.summary(eng_s.scheduler.now)
    single = {
        "finished": len(eng_s.finished),
        "steps": steps,
        "makespan_s": eng_s.scheduler.now,
        "ttft_mean_s": slo["ttft_mean_s"],
        "goodput_tok_s": slo["goodput_tok_s"],
        "ttft_weighted_goodput": slo["ttft_weighted_goodput"],
        "tokens": [list(s.tokens) for s in
                   sorted(eng_s.finished, key=lambda s: s.sid)],
    }

    # cluster: prefill host (ps 4) -> Eq.-5-striped wire -> decode host
    view_p, eng_p = host("prefill", 4)
    view_d, eng_d = host("decode", 8)
    wire = Interconnect([Link(n, bw * bw_scale, latency_s=lat)
                         for n, bw, lat in DISAGG_LINKS])
    channel = PageChannel(wire, chunk_bytes=int((1 << 14) * bw_scale))
    router = ClusterRouter(eng_p, eng_d, channel,
                           saturation_horizon_s=0.25)
    if hook is not None:
        hook("router", router)
    rids = [router.submit(list(p), max_new=max_new) for p in prompts]
    router.drain()
    summ = router.summary()
    view_p.fabric.check_invariants()
    view_d.fabric.check_invariants()
    disagg = {
        "finished": summ["completed"],
        "handoffs": summ["handoffs"],
        "fallbacks": summ["fallbacks"],
        "converted_imports": channel.converted_imports,
        "wire_bytes": wire.sent_bytes,
        "wire_busy_s": wire.busy_seconds,
        "makespan_s": summ["elapsed_s"],
        "ttft_mean_s": summ["ttft_mean_s"],
        "goodput_tok_s": summ["goodput_tok_s"],
        "ttft_weighted_goodput": summ["ttft_weighted_goodput"],
        "tokens": [router.result(r) for r in rids],
    }
    return {"single": single, "disagg": disagg, "prompts": len(prompts),
            "router": router, "channel": channel, "wire": wire}


def disagg_compare(seed: int = 0, check: bool = True, *, params=None,
                   device="cuda") -> dict:
    """Prefill/decode disaggregation over the BWAP-priced page wire vs
    single-host serving (``disagg_run``); gates: token-identical to the
    single host, >= 1.15x TTFT-weighted goodput (goodput / mean TTFT),
    every handoff converted (the hosts' page sizes differ), no fallback,
    both fabrics' ledgers balanced."""
    cfg, params = smoke(params, device=device)
    r = disagg_run(cfg, params, seed=seed, device=device)
    single = {k: v for k, v in r["single"].items() if k != "tokens"}
    disagg = {k: v for k, v in r["disagg"].items() if k != "tokens"}
    identical = r["disagg"]["tokens"] == r["single"]["tokens"]
    ratio = disagg["ttft_weighted_goodput"] \
        / max(single["ttft_weighted_goodput"], 1e-9)
    for name, row in (("single", single), ("disagg", disagg)):
        print(f"  {name:7s} ttft_mean {row['ttft_mean_s'] * 1e3:6.1f} ms  "
              f"goodput {row['goodput_tok_s']:7.1f} tok/s  "
              f"ttft-weighted {row['ttft_weighted_goodput']:9.0f}  "
              f"makespan {row['makespan_s']:.3f}s")
    print(f"-> disaggregated vs single host: {ratio:.2f}x TTFT-weighted "
          f"goodput ({disagg['handoffs']} handoffs, "
          f"{disagg['converted_imports']} converted imports, "
          f"{disagg['wire_bytes'] / 1024:.0f} KiB on the wire; "
          f"token-identical: {identical})")
    if check:
        assert identical, "disaggregation changed generated tokens"
        assert single["finished"] == disagg["finished"] == r["prompts"]
        assert disagg["handoffs"] == r["prompts"] \
            and disagg["fallbacks"] == 0, "the wire saturated mid-benchmark"
        assert disagg["converted_imports"] == disagg["handoffs"], \
            "mismatched page sizes must convert on every import"
        assert ratio >= 1.15, (
            f"disaggregation must lift TTFT-weighted goodput >= 1.15x "
            f"single-host (got {ratio:.2f}x)")
    return {"single": single, "disagg": disagg,
            "ttft_goodput_ratio": ratio,
            "token_identical": identical}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    # the sizes ``benchmarks/run.py`` gives the reference's compare, which
    # wrote BENCH_scheduler.json
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the pools and params live (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = args.device
    artifacts.dump("BENCH_torch_scheduler.json",
                   compare(args.requests, args.new, args.seed, device=dev))
    print("\nprefix sharing — peak KV footprint, reuse on vs off")
    artifacts.dump("BENCH_torch_prefix.json",
                   prefix_compare(seed=args.seed, device=dev))
    print("\nmemory fabric — two tenants, prefix tier + swap loans "
          "vs isolated")
    artifacts.dump("BENCH_torch_fabric.json",
                   fabric_compare(seed=args.seed, device=dev))
    print("\npersistence tier — warm vs cold restart TTFT")
    artifacts.dump("BENCH_torch_persist.json",
                   persist_compare(seed=args.seed, device=dev))
    print("\ncompute-follows-data — micro-batch decode + re-homing "
          "vs global batching")
    artifacts.dump("BENCH_torch_coda.json",
                   coda_compare(seed=args.seed, device=dev))
    print("\ndisaggregated serving — prefill/decode split over the "
          "page wire vs single host")
    artifacts.dump("BENCH_torch_disagg.json",
                   disagg_compare(seed=args.seed, device=dev))


if __name__ == "__main__":
    main()
