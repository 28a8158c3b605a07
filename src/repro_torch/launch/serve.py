"""Serving launcher: BWAP-paged engine over a smoke config (2 layers, fp32),
on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
        --requests 4 --new 16 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.core.dwp import DWPConfig
    from repro_torch.device import resolve
    from repro_torch.models.lm import LM
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain
    from repro_torch.serve.engine import ServeEngine

    dev = resolve(args.device)
    cfg = registry.get_smoke_config(args.arch)
    cfg = dataclasses.replace(cfg, num_layers=2, compute_dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = LM(cfg).init(gen, device=dev)
    pool = BwapPagePool(cfg, [
        MemoryDomain("hbm_local", 96, 819.0, True),
        MemoryDomain("hbm_peer", 64, 50.0, False),
        MemoryDomain("host", 128, 16.0, False),
    ], page_size=args.page_size, dwp_config=DWPConfig(n=6, c=1), device=dev)
    eng = ServeEngine(cfg, params, pool, max_batch=4, max_new=args.new,
                      device=dev)
    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        eng.submit(rng.integers(1, cfg.vocab_size, 8).tolist())
    steps = 0
    while (eng.active or eng.waiting) and steps < 300:
        eng.step()
        steps += 1
    print(f"served {len(eng.finished)} sequences in {steps} engine steps "
          f"on {dev}; final DWP {pool.tuner.dwp:.1f}; "
          f"occupancy {pool.occupancy()}")
    return eng


if __name__ == "__main__":
    main()
