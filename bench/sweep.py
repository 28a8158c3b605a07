"""Find a cell's knee once, on the card: the highest Poisson rate at which
the pending queue does not grow across the window and no request fails.

    python bench/sweep.py --workload <cell> --rates 4,6,8 [--seconds 20]
        [--preroll 10] [--seed 7]

Each rate runs on a fresh engine (the weights, made once from ``--seed``,
the cell's traffic file at that rate, the cell's pre-roll unless
``--preroll`` is given) and prints one row: decode tokens/s, TTFT and TPOT tails, the mean
decode batch, and the slope of the pending queue over the window. A rate is
sustained when that slope is under 5 % of the rate and nothing failed.
The rates found go into the traffic files as numbers; the table goes into
``PERF.md``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / p)
                for p in ("src", "")]

from bench import run  # noqa: E402

GROWTH = 0.05          # sustained: the queue grows by under 5 % of arrivals


def one_rate(conf, traffic, params, rate, seed, seconds, preroll,
             device) -> dict:
    """One row of the sweep: the cell at ``rate`` requests/s on a fresh
    engine over ``params``."""
    import numpy as np
    import torch
    from bench import readings, traffic as gen
    from bench.loop import OpenLoop
    t = dict(traffic, arrivals=dict(traffic["arrivals"], rate_per_s=rate),
             preroll_s=preroll)
    m = conf["model"]
    eng = run.build(conf, t, params, torch.device(device))
    run.warm_up(eng, t, m["vocab_size"], seed)
    schedule = gen.generate(t, seed, preroll + seconds, m["vocab_size"])
    loop = OpenLoop(eng, schedule, preroll, preroll + seconds)
    loop.run(time.perf_counter(), preroll + seconds)
    rec = loop.record(loop.now())
    steps = readings.window_steps(rec)
    ts = np.array([s["end"] for s in steps])
    pend = np.array([s["pending"] for s in steps])
    slope = float(np.polyfit(ts, pend, 1)[0]) if len(ts) > 2 else 0.0
    win = readings.window_requests(rec)
    failed = sum(r["refused"] for r in win)
    late = [r["submit"] - r["due"] for r in win]
    row = {"rate": rate, "attempted": len(win), "failed": failed,
           "output_tok_s": readings.output_tok_s(rec),
           "prefill_tok_s": sum(s["prefill_tokens"] for s in steps)
           / rec["seconds"],
           "ttft_p95_ms": readings.ttft_ms(rec, 95),
           "tpot_p95_ms": readings.tpot_ms(rec, 95),
           "decode_batch_mean": readings.decode_batch_mean(rec),
           "step_ms": readings.step_ms(rec),
           "lateness_p95_ms": readings.pct_ms(late, 95),
           "pending_start": int(pend[0]) if len(pend) else 0,
           "pending_end": int(pend[-1]) if len(pend) else 0,
           "pending_slope_per_s": slope,
           "sustained": bool(slope < GROWTH * rate and failed == 0)}
    del eng, loop
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--preroll", type=float, default=None)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    run._caches()
    import torch
    from bench import cell as cells, weights
    wl = cells.workload(args.workload)
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    traffic = cells.traffic(wl["name"])
    conf = cells.config(wl["config"])
    preroll = traffic["preroll_s"] if args.preroll is None else args.preroll
    params = weights.make(conf["model"], args.seed, torch.device("cuda"))
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        row = one_rate(conf, traffic, params, rate, args.seed, args.seconds,
                       preroll, "cuda")
        rows.append(row)
        print(json.dumps(row), flush=True)
    knee = max((r["rate"] for r in rows if r["sustained"]), default=None)
    print(f"{args.workload}: knee {knee} requests/s of {[r['rate'] for r in rows]}"
          f" ({run.device_info(torch, 1)})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
