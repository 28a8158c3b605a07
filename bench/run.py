"""Run one benchmark cell once on the card and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name (``bench/cell.py``): the cell's entry in
``BENCHMARK.json``, its traffic file, its configuration file and a reader a
metric. The run makes the weights and the traffic from the seed, builds
``repro_torch.serve.engine.ServeEngine`` over a BWAP page pool, warms up
one prefill chunk at the cell's budget and a decode at its batch, runs the
traffic's pre-roll, then measures ``--seconds`` seconds of open-loop
serving. With ``--trace 1`` a sub-window is profiled and the per-layer
metrics are reported instead of the end-to-end ones. After the window, a
sample of the finished requests is held against the float32 reference
(``bench/check.py``). The last line of standard output is the result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()      # the process's start, for setup_s

import argparse        # noqa: E402
import gc              # noqa: E402
import json            # noqa: E402
import math            # noqa: E402
import os              # noqa: E402
import subprocess      # noqa: E402
import sys             # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
TRACE_S = 3.0                # the traced sub-window: the window's last seconds
SERVED_TOKENS = 256          # served tokens the correctness sample holds


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own CUDA libraries go to ``build/kernels`` there already)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def _one_thread() -> None:
    """The engine's host loop is one Python thread; CPU thread pools (torch's
    intra-op pool, OpenMP, BLAS) would only spin beside it on the cores the
    card's host shares, and make the host's pace vary from run to run. Set
    before torch or numpy is imported."""
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def port_config(conf: dict):
    """The program's ``ModelConfig`` for a configuration file, held to the
    file's sizes."""
    import dataclasses
    from repro_torch.configs import registry
    get = registry.get_smoke_config if conf.get("smoke") \
        else registry.get_config
    cfg = dataclasses.replace(get(conf["registry"]), **conf["overrides"])
    m = conf["model"]
    want = {"num_layers": m["num_hidden_layers"], "d_model": m["hidden_size"],
            "num_heads": m["num_attention_heads"],
            "num_kv_heads": m["num_key_value_heads"],
            "d_ff": m["intermediate_size"], "vocab_size": m["vocab_size"],
            "head_dim_": m["hidden_size"] // m["num_attention_heads"],
            "qkv_bias": m["qkv_bias"],
            "tie_embeddings": m["tie_word_embeddings"],
            "rope_theta": m["rope_theta"], "rms_eps": m["rms_norm_eps"],
            "act": m["hidden_act"], "mrope": "mrope_section" in m}
    if "mrope_section" in m:
        want["mrope_sections"] = tuple(m["mrope_section"])
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise ValueError(f"{conf['name']}: the program's config {got} is "
                         f"not the file's {want}")
    return cfg


def pool_domains(conf: dict, traffic: dict):
    """The pool's Eq.-1 domains: ``max_batch`` of the cell's longest
    requests, split by the configuration's shares."""
    from repro_torch.placement.pool import MemoryDomain
    from bench import traffic as gen
    ps = conf["page_size"]
    pages = traffic["scheduler"]["max_batch"] * -(-gen.longest(traffic)
                                                  // ps)
    shares = [d["share"] for d in conf["domains"]]
    counts = [pages * s // sum(shares) for s in shares]
    counts[0] += pages - sum(counts)
    return [MemoryDomain(d["name"], n, d["read_bw_gbs"], d["is_worker"])
            for d, n in zip(conf["domains"], counts)]


def build(conf: dict, traffic: dict, params, device):
    """The engine as the traffic file asks: its ``scheduler`` and ``engine``
    keyword options go to ``RequestScheduler`` and ``ServeEngine`` as they
    are, and each of its ``parts`` (an option that needs an object, such as
    a swap manager or a drafter) is ``parts/<name>.py``, whose
    ``attach(spec, cfg=, pool=, scheduler=, engine=)`` adds to those
    options."""
    from repro_torch.placement.pool import BwapPagePool
    from repro_torch.scheduler.scheduler import RequestScheduler
    from repro_torch.serve.engine import ServeEngine
    from bench import cell as cells
    cfg = port_config(conf)
    pool = BwapPagePool(cfg, pool_domains(conf, traffic),
                        page_size=conf["page_size"],
                        policy=traffic["placement"], device=device)
    sched_kw, eng_kw = dict(traffic["scheduler"]), dict(traffic["engine"])
    for name, spec in traffic.get("parts", {}).items():
        cells.plugin("parts", name).attach(spec, cfg=cfg, pool=pool,
                                           scheduler=sched_kw, engine=eng_kw)
    sched = RequestScheduler(pool, **sched_kw)
    return ServeEngine(cfg, params, pool, scheduler=sched, device=device,
                       **eng_kw)


def warm_up(eng, traffic: dict, vocab: int, seed: int) -> None:
    """One prefill chunk at the cell's budget, then a decode at its batch;
    the requests finish and give their pages back before the pre-roll."""
    import numpy as np
    rng = np.random.default_rng([seed, 1])
    sched = traffic["scheduler"]
    eng.submit(rng.integers(1, vocab, sched["prefill_token_budget"] + 1)
               .tolist(), max_new=2)
    for _ in range(sched["max_batch"]):
        eng.submit(rng.integers(1, vocab, 8).tolist(), max_new=3)
    while eng.scheduler.running or eng.scheduler.pending:
        eng.step()


def device_info(torch, n: int) -> dict:
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        limit = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n, "power_limit": limit}


def run_cell(cell: str, conf: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             fault=None, control: bool = False, trace_s: float = TRACE_S,
             served_tokens: int = SERVED_TOKENS) -> dict:
    """One run of a cell; returns the record the metric readers take, with
    the correctness readings. ``fault(engine)``, where given, breaks the
    timed path before the window (tests: the check must see it). With
    ``control`` the sample is also read with the lower-precision reference
    in the program's place (``bench/control.py``). ``trace_s`` and
    ``served_tokens`` are smaller in the tests' smoke-sized runs."""
    import torch
    from bench import check, traffic as gen, weights
    from bench.loop import OpenLoop
    from bench.trace import Tracer

    m = conf["model"]
    dev = torch.device(device)
    params = weights.make(m, seed, dev)
    eng = build(conf, traffic, params, dev)
    warm_up(eng, traffic, m["vocab_size"], seed)
    if fault is not None:
        fault(eng)
    preroll = traffic["preroll_s"]
    schedule = gen.generate(traffic, seed, preroll + seconds,
                            m["vocab_size"])
    tracer = trace_at = None
    if trace:
        tracer = Tracer(eng, m)
        tracer.warm()
        span = min(trace_s, seconds / 2)
        trace_at = (preroll + seconds - span, span)
    loop = OpenLoop(eng, schedule, preroll, preroll + seconds, tracer,
                    trace_at)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    setup_s = t0 + preroll - T_START
    loop.run(t0, preroll + seconds)
    end = loop.now()
    loop.finish(served_tokens, end + traffic["finish_s"])
    summary = None
    if tracer is not None:
        tracer.uninstall()
        summary = tracer.summary()
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    done = [(list(t.req.tokens[:t.req.prompt_len]),
             list(t.req.tokens[t.req.prompt_len:]))
            for t in loop.tracks if t.req is not None and t.req.done]
    rec = loop.record(end) | {"cell": cell, "setup_s": setup_s,
                              "trace": summary, "memory_peak_bytes": peak,
                              "finished": len(done)}
    del eng, loop, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    picked = check.sample(done, seed, served_tokens)
    gap = [check.gaps(m, params, *done[i]) for i in picked]
    rec["check"] = {"requests": len(picked),
                    "served_tokens": int(sum(len(g) for g in gap)),
                    "max_logit_gap": float(max((g.max() for g in gap),
                                               default=math.inf)),
                    "seconds": time.perf_counter() - t1}
    if control:
        ctl = [check.gaps(m, params, *done[i], quant="fp8") for i in picked]
        rec["check"]["control_max_gap"] = float(
            max((g.max() for g in ctl), default=math.inf))
    return rec


def result(rec: dict, metrics: list[dict], traffic: dict) -> dict:
    from bench import cell as cells
    from bench.readings import window_requests
    win = window_requests(rec)
    out = {}
    for m in metrics:
        v = cells.reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    limit = traffic["limit_max_logit_gap"]
    gap = rec["check"]["max_logit_gap"]
    # no finished request to compare: no number, and not correct
    checks = {"max_logit_gap": {"value": gap if math.isfinite(gap) else None,
                                "limit": limit}}
    return {"correct": bool(gap <= limit), "attempted": len(win),
            "failed": sum(r["refused"] for r in win), "metrics": out,
            "checks": checks}


def _lateness(rec: dict) -> str:
    import numpy as np
    from bench.readings import window_requests
    late = np.array([r["submit"] - r["due"] for r in window_requests(rec)])
    if late.size == 0:
        return "generator lateness: no request due in the window"
    return (f"generator lateness in the window: p50 {np.median(late) * 1e3:.3f}"
            f" ms, p95 {np.percentile(late, 95) * 1e3:.3f} ms, max "
            f"{late.max() * 1e3:.3f} ms over {late.size} requests")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    _caches()
    _one_thread()
    import repro_torch  # noqa: F401  (the program under test: fail early)
    import torch
    torch.set_num_threads(1)
    from bench import cell as cells, readings
    bench = cells.benchmark()
    wl = cells.workload(args.workload, bench)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        log(f"{args.workload} needs {wl['chips']} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, "
            f"count {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    traffic = cells.traffic(wl["name"])
    conf = cells.config(wl["config"])
    metrics = cells.metrics_of(wl["name"], "per_layer" if args.trace
                               else "end_to_end", bench)
    rec = run_cell(wl["name"], conf, traffic, args.seed, args.seconds,
                   bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark must not import JAX or the "
            f"JAX package")
        return 3
    res = result(rec, metrics, traffic)
    info = device_info(torch, wl["chips"])
    res["device"] = info | {"memory_peak_bytes": rec["memory_peak_bytes"]}
    if rec["trace"] is not None:
        tr = rec["trace"]
        res["device"] |= {"busy_s": tr["busy_s"], "window_s": tr["window_s"]}
        res["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
        log("trace: " + json.dumps({k: tr[k] for k in (
            "window_s", "busy_s", "start_s", "kinds", "phase_device_s",
            "phase_host_s",
            "decode_passes", "prefill_tokens", "model_flops")}))
    log(_lateness(rec))
    log(f"steps {len(rec['steps'])}, finished {rec['finished']}, TTFT p50 "
        f"{readings.ttft_ms(rec, 50)} ms, p95 {readings.ttft_ms(rec, 95)} ms "
        f"of window requests, setup {rec['setup_s']:.3f} s, "
        f"reference {rec['check']['seconds']:.1f} s over "
        f"{rec['check']['requests']} requests and "
        f"{rec['check']['served_tokens']} served tokens, power limit "
        f"{info['power_limit']}")
    checks = res.pop("checks")
    res["checks"] = checks                        # the last key
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(res, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
