"""The correctness check's two readings for a cell, on the card.

    python bench/control.py --workload <cell> --seeds 11,12,13 [--seconds 15]

For each seed one run of the cell at its own load: the sample of finished
requests is read twice, against the float32 reference. The program's widest
logit gap is the lower reading's material; the control (the reference in the
program's place with every product and the cached K/V rounded through
float8 e4m3, ``bench/reference/qwen2.py``) gives the upper one: the gap of
the token it puts first. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / p)
                for p in ("src", "")]

from bench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    run._caches()
    import torch
    from bench import cell as cells
    if not torch.cuda.is_available():
        print("the control needs a CUDA device", file=sys.stderr)
        return 2
    wl = cells.workload(args.workload)
    traffic = cells.traffic(wl["name"])
    conf = cells.config(wl["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = run.run_cell(wl["name"], conf, traffic, seed, args.seconds,
                           False, control=True)
        print(json.dumps({"workload": wl["name"], "seed": seed}
                         | rec["check"]), flush=True)
    print(run.device_info(torch, 1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
