"""End-to-end serving driver of the PyTorch port: scheduler-paced requests
over the BWAP pool, on the card unless ``--device cpu`` is given. The port
of ``examples/serve_paged.py``, through the port's engine, swap manager and
persistence tier (params drawn by ``torch.Generator`` from seed 0).

Oversubscribed by construction: the trace's total KV footprint exceeds
``hbm_local`` (and the unreserved pool), so completion *requires* the
scheduler's preemption path — cold sequences park in BWAP-weighted slow
domains (reserved swap slots) and resume later. Priority classes
("interactive" with tight deadlines, "batch" without) drive victim
selection; the run ends with a per-class SLO summary.

    PYTHONPATH=src python examples/torch_serve_paged.py [--requests 10] \
        [--new 12] [--device cpu]

``--restart-demo`` runs the persistence-tier walkthrough instead: pin a
system preamble, export it to the on-disk prefix store, tear the whole
fabric down, and re-import into a fresh engine — the first request after
the "restart" hits the restored trie instead of re-prefilling.

``--trace-out PATH`` attaches the fabric observatory (DESIGN.md §10) and
dumps the run as Chrome/Perfetto trace-event JSON: open ui.perfetto.dev,
"Open trace file", pick the JSON — one track per request (admit, queued,
prefill chunks, decode steps, swap_out/swap_in) on the virtual clock.
Tracing never changes the decoded tokens.
"""

import argparse
import dataclasses
import pathlib

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.dwp import DWPConfig
from repro_torch.device import resolve
from repro_torch.models.lm import LM
from repro_torch.placement.pool import BwapPagePool, MemoryDomain
from repro_torch.scheduler import (KVSwapManager, PriorityClass,
                                   RequestScheduler, SloSpec, WorkloadSpec,
                                   generate, total_kv_pages)
from repro_torch.serve.engine import ServeEngine


def restart_demo(cfg, params, seed: int, device) -> None:
    """Restart-surviving prefix store, end to end (DESIGN.md §9)."""
    from repro_torch.placement.fabric import as_view
    from repro_torch.placement.persist import PersistentTier

    store = (pathlib.Path(__file__).resolve().parent.parent
             / "benchmarks" / "results" / "torch_persist_store_demo")
    rng = np.random.default_rng(seed)
    preamble = rng.integers(1, cfg.vocab_size, 48).tolist()

    def boot(tier):
        pool = BwapPagePool(cfg, [
            MemoryDomain("hbm_local", 48, 819.0, True),
            MemoryDomain("hbm_peer_1hop", 32, 0.05, False),
            MemoryDomain("host_dram", 48, 0.016, False),
        ], page_size=4, dwp_config=DWPConfig(n=10 ** 6, c=1), device=device)
        view = as_view(pool)
        view.fabric.attach_persist(tier)
        sched = RequestScheduler(pool, max_batch=4,
                                 prefill_token_budget=16,
                                 default_max_new=8)
        eng = ServeEngine(cfg, params, pool, scheduler=sched,
                          wall_clock=False, sim_step_s=0.02, device=device)
        return pool, view, eng

    tier = PersistentTier(bw_gbps=0.008, capacity_pages=64,
                          directory=store)
    pool, view, eng = boot(tier)
    eng.submit(preamble + rng.integers(1, cfg.vocab_size, 4).tolist())
    pinned = None
    while eng.active or eng.waiting:
        eng.step()
        if pinned is None:           # pin as soon as prefill registers it
            pinned = tier.pin(view, preamble)
    manifest = tier.export_prefixes(view)
    view.fabric.check_invariants()
    print(f"phase 1: served {len(eng.finished)} request(s), pinned the "
          f"{len(preamble)}-token preamble, exported "
          f"{len(manifest['chains'])} chain(s) "
          f"({sum(c['pages'] for c in manifest['chains'])} pages) to "
          f"{store / 'prefix_store'}")

    # "restart": brand-new pool, fabric, and tier — only the disk store
    # survives the teardown
    tier2 = PersistentTier(bw_gbps=0.008, capacity_pages=64,
                           directory=store)
    pool2, view2, eng2 = boot(tier2)
    restored, secs = tier2.import_prefixes(view2)
    eng2.submit(preamble + rng.integers(1, cfg.vocab_size, 4).tolist())
    hits0 = pool2.table.prefix_hit_pages
    eng2.step()
    hits = pool2.table.prefix_hit_pages - hits0
    while eng2.active or eng2.waiting:
        eng2.step()
    view2.fabric.check_invariants()
    print(f"after restart: {restored} pages re-imported in "
          f"{secs * 1e3:.2f} ms (Eq.-1 tier row); the first request "
          f"matched {hits} pages from the restored trie — prefill skipped "
          f"the whole preamble, computing "
          f"{eng2.prefill_tokens_computed} forward tokens instead of "
          f"{len(preamble) + 4}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--kind", default="bursty",
                    choices=["poisson", "bursty", "heavy_tail",
                             "domain_skew", "hot_prefix"])
    ap.add_argument("--policy", default="bwap_dwp",
                    help="placement policy (see "
                         "repro_torch.placement.policy); "
                         "'coda' adds compute-follows-data execution: "
                         "per-domain micro-batch decode + heat-driven "
                         "re-homing of hot shared pages (DESIGN.md §11)")
    ap.add_argument("--prefix-len", type=int, default=16,
                    help="shared system-prompt length (0 disables)")
    ap.add_argument("--spec", type=int, default=0, metavar="K",
                    help="speculative decode with a K-token prompt-lookup "
                         "drafter (0 disables; outputs stay token-identical "
                         "to greedy)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--restart-demo", action="store_true",
                    help="run the persistence-tier restart walkthrough "
                         "(prefix store export -> teardown -> re-import)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="dump a Chrome/Perfetto trace-event JSON of the "
                         "run (load it in ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda",
                    help="where the pools and params live (cuda or cpu)")
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = registry.get_smoke_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=2, compute_dtype="float32")
    model = LM(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)

    if args.restart_demo:
        restart_demo(cfg, params, args.seed, dev)
        return

    # slow-domain bandwidths scaled into the engine-latency range so the
    # Eq.-1 terms (KV reads, swap transfers) are visible on a CPU host
    domains = [
        MemoryDomain("hbm_local", 12, 819.0, True),
        MemoryDomain("hbm_peer_1hop", 12, 0.05, False),
        MemoryDomain("hbm_pod1_dci", 12, 0.0125, False),
        MemoryDomain("host_dram", 64, 0.016, False),
    ]
    pool = BwapPagePool(cfg, domains, page_size=8,
                        dwp_config=DWPConfig(n=6, c=1),
                        policy=args.policy, device=dev)
    swap = KVSwapManager(pool, placement="bwap_canonical",
                         reserve_fraction=0.95)
    sched = RequestScheduler(
        pool, max_batch=6, prefill_token_budget=32,
        classes=[PriorityClass("interactive", 2, SloSpec(ttft_s=0.5,
                                                         tpot_s=0.1)),
                 PriorityClass("batch", 0)],
        default_class="batch", default_max_new=args.new, swap=swap)
    # virtual clock on the Eq.-1 analytic terms + a 20 ms compute stand-in:
    # wall time would drown the SLO numbers in host noise
    drafter = None
    if args.spec > 0:
        from repro_torch.serve.spec import PromptLookupDrafter
        drafter = PromptLookupDrafter(max_tokens=args.spec, max_ngram=3)
    eng = ServeEngine(cfg, params, pool, scheduler=sched, wall_clock=False,
                      sim_step_s=0.02, drafter=drafter, device=dev)
    obs = None
    if args.trace_out or eng.rehome:
        # --policy coda needs the observatory's heat map to rank re-home
        # candidates; tracing stays opt-in via --trace-out
        from repro_torch.obs import Observatory
        obs = Observatory(pool, drift=False,
                          tracer=bool(args.trace_out))

    trace = generate(WorkloadSpec(
        kind=args.kind, num_requests=args.requests,
        mean_interarrival_s=0.01, prompt_mean=14, prompt_max=40,
        max_new=args.new, vocab_size=cfg.vocab_size,
        class_mix=(("interactive", 0.3), ("batch", 0.7)), seed=args.seed,
        prefix_len=args.prefix_len, prefix_groups=2, prefix_frac=0.7))
    # total_kv_pages counts *logical* pages (every request's full view);
    # with prefix reuse the trie maps identical prompt prefixes onto the
    # same physical pages, so the physical oversubscription is lower —
    # track the peak physical footprint and report both
    footprint = total_kv_pages(trace, pool.page_size)
    print(f"workload: {len(trace)} requests ({args.kind}), logical KV "
          f"footprint {footprint} pages vs hbm_local "
          f"{domains[0].num_pages} "
          f"(oversubscription x{footprint / domains[0].num_pages:.1f}); "
          f"unreserved pool {pool.free_count()}, swap slots "
          f"{swap.reserved_total}")
    for t in trace:
        eng.submit(t.prompt, cls=t.cls, max_new=t.max_new,
                   arrival_s=t.arrival_s)

    step = 0
    peak_phys = peak_logical = multi_launch_steps = 0
    while eng.active or eng.waiting:
        info = eng.step()
        step += 1
        if info.get("launches", 0) > 1:
            multi_launch_steps += 1
        pt = info.get("pagetable", {})
        peak_phys = max(peak_phys, pt.get("physical_pages", 0))
        peak_logical = max(peak_logical, pt.get("logical_pages", 0))
        if step % 8 == 0 or not (eng.active or eng.waiting):
            occ = " ".join(f"{k}={v:.0%}"
                           for k, v in info.get("occupancy", {}).items())
            print(f"step {step:3d} active={info['active']} "
                  f"swapped={info.get('swapped', 0)} "
                  f"lat={info.get('latency', 0) * 1e3:6.1f} ms "
                  f"dwp={info.get('dwp', 0):.1f} "
                  f"shared={pt.get('shared_pages', 0)}  {occ}")
        if step > 800:
            break

    tel = pool.telemetry.snapshot()
    slo = sched.slo.summary(sched.now)
    pt = pool.table.stats()
    print(f"\nfinished {len(eng.finished)}/{len(trace)} sequences in "
          f"{sched.now:.2f} virtual s; swaps {tel['swap_outs']} out / "
          f"{tel['swap_ins']} in ({tel['swap_seconds'] * 1e3:.0f} ms "
          f"transfer); goodput {slo['goodput_tok_s']:.0f} good tok/s")
    if args.spec > 0:
        sp = tel["spec"]
        print(f"speculation: {eng.tokens_emitted} tokens in "
              f"{eng.decode_steps} decode steps "
              f"({eng.tokens_emitted - eng.decode_steps} steps saved); "
              f"acceptance {sp['acceptance_rate']:.0%} "
              f"({sp['accepted']}/{sp['drafted']} drafted)")
    print(f"KV footprint: peak {peak_logical} logical / {peak_phys} "
          f"physical pages "
          f"(x{peak_logical / max(peak_phys, 1):.2f} sharing; "
          f"physical oversubscription vs hbm_local "
          f"x{peak_phys / domains[0].num_pages:.1f}); "
          f"prefix hits {pt['prefix_hit_pages']} pages, "
          f"cow faults {pt['cow_faults']}, prefill fwd tokens "
          f"{eng.prefill_tokens_computed}")
    for cls, row in slo["classes"].items():
        print(f"  {cls:12s} done {row['completed']:3d}/{row['submitted']:3d}"
              f"  good {row['good']:3d}  ttft {row['ttft_mean_s'] * 1e3:7.1f}"
              f" ms (p95 {row['ttft_p95_s'] * 1e3:7.1f})  tpot "
              f"{row['tpot_mean_s'] * 1e3:6.1f} ms  preempted "
              f"{row['preemptions']}")
    if eng.rehome or sched.micro_batch:
        print(f"compute-follows-data ({args.policy}): "
              f"{multi_launch_steps}/{step} steps ran per-domain "
              f"micro-batch launches; {eng.rehomed_pages} hot shared "
              f"pages re-homed into fast domains")
    for s in eng.finished[:3]:
        print(f"  seq {s.sid} [{s.cls}]: {s.tokens[:5]}... -> "
              f"{s.tokens[s.prompt_len:s.prompt_len + 5]}...")
    if obs is not None and obs.tracer is not None:
        path = obs.tracer.export(args.trace_out)
        spans = {n: len(obs.tracer.spans(n))
                 for n in ("prefill", "decode", "swap_out", "swap_in")}
        print(f"\ntrace: {len(obs.tracer.events)} events -> {path} "
              f"({' '.join(f'{k}={v}' for k, v in spans.items())}); "
              f"open ui.perfetto.dev -> 'Open trace file' to view "
              f"(one track per request, virtual-clock timestamps)")


if __name__ == "__main__":
    main()
