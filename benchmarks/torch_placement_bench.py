"""Placement runtime microbenchmarks of the PyTorch port: the port of
``benchmarks/placement_bench.py``.

Main event: the batched migration executor (one ``index_select`` and one
``index_copy_`` per array, in place) against the per-page loop (one page
copy at a time), on a migration of ``pages`` pages from the first half of
a pool to the second half, k and v arrays like a KV pool. Batched and
looped must leave equal bits, and the executor must win by >= 5x (the
reference's floor). The times are synchronised wall times on the pools'
device (``torch.cuda.synchronize`` around each call on a card). Also times
policy weight/assignment computation and pool allocation throughput (host
work).

    PYTHONPATH=src python -m benchmarks.torch_placement_bench [--pages 4096] \\
        [--device cpu]

Writes ``BENCH_torch_placement.json`` at the repo root
(``benchmarks.artifacts``).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from benchmarks import artifacts
from repro_torch.device import resolve
from repro_torch.placement import policy as placement_policy
from repro_torch.placement.executor import MigrationExecutor

# the reference benchmark's pool: [layers, pages, page size, kv heads, h]
REFERENCE_GEOMETRY = (1, 2, 1, 8)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(fn, dev: torch.device, repeats: int = 1) -> float:
    """Best of ``repeats`` synchronised wall times of ``fn()``."""
    best = float("inf")
    for _ in range(repeats):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def bench_migration(num_moves: int, *, geometry=REFERENCE_GEOMETRY,
                    dtype=torch.float32, device="cuda") -> dict:
    """Move ``num_moves`` pages from the first half of a pool of
    ``2 * num_moves`` pages to the second half, in k and v arrays of
    ``[layers, pages, page size, kv heads, h]`` (``geometry`` gives all
    but the pages) in ``dtype``: batched (best of 3) and looped (once),
    each on its own copy of the same arrays, which must end equal."""
    dev = resolve(device)
    nl, ps, nkv, hd = geometry
    total = 2 * num_moves
    k = torch.arange(nl * total * ps * nkv * hd, dtype=torch.float32,
                     device=dev).reshape(nl, total, ps, nkv, hd).to(dtype)
    v = k + 1
    src = np.arange(num_moves, dtype=np.int64)
    dst = np.arange(num_moves, dtype=np.int64) + num_moves
    ex = MigrationExecutor()

    batched = (k.clone(), v.clone())
    looped = (k.clone(), v.clone())
    t_batched = _time(lambda: ex.execute(batched, src, dst), dev, repeats=3)
    t_looped = _time(lambda: ex.execute_looped(looped, src, dst), dev)
    _, res = ex.execute(batched, src, dst)
    assert all(torch.equal(b, lp) for b, lp in zip(batched, looped)), \
        "batched executor diverged from the per-page oracle"
    assert torch.equal(batched[0][:, num_moves:], k[:, :num_moves]), \
        "the moved pages do not hold their sources' bytes"
    return {
        "num_moves": num_moves,
        "batched_s": t_batched,
        "per_page_loop_s": t_looped,
        "speedup": t_looped / max(t_batched, 1e-12),
        "bytes_moved": res.bytes_moved,
    }


def bench_policies(num_pages: int = 65536) -> dict:
    ctx = placement_policy.PlacementContext(
        bandwidths=np.asarray([819.0, 50.0, 25.0, 12.5, 16.0]),
        num_pages=num_pages, workers=(0,), dwp=0.4,
        capacities=np.full(5, num_pages, dtype=np.int64))
    out = {}
    for name in placement_policy.available():
        t0 = time.perf_counter()
        a = placement_policy.assign(name, ctx)
        out[name] = {
            "assign_s": time.perf_counter() - t0,
            "fractions": (np.bincount(a, minlength=5) / num_pages).tolist(),
        }
    return out


def bench_alloc(num_pages: int = 4096, *, device="cuda") -> dict:
    """Host throughput of ``alloc_page`` on a pool whose arrays live on
    ``device``; the ids must be unique."""
    from repro_torch.configs import registry
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain

    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    domains = [
        MemoryDomain("hbm_local", num_pages // 2, 819.0, True),
        MemoryDomain("hbm_peer", num_pages // 4, 50.0, False),
        MemoryDomain("host", num_pages - num_pages // 2 - num_pages // 4,
                     16.0, False),
    ]
    pool = BwapPagePool(cfg, domains, page_size=4, device=device)
    t0 = time.perf_counter()
    ids = [pool.alloc_page() for _ in range(num_pages)]
    dt = time.perf_counter() - t0
    assert len(set(ids)) == num_pages
    return {"pages": num_pages, "alloc_s": dt,
            "pages_per_s": num_pages / dt}


def suite(pages: int = 4096, *, device="cuda") -> dict:
    """Run all three microbenchmarks and enforce the executor floor;
    returns the rows ``main`` writes to ``BENCH_torch_placement.json``."""
    print(f"migration executor: batched vs per-page loop "
          f"({pages}-page migration, {device})")
    mig = bench_migration(pages, device=device)
    print(f"  batched   {mig['batched_s'] * 1e3:9.3f} ms")
    print(f"  per-page  {mig['per_page_loop_s'] * 1e3:9.3f} ms")
    print(f"  -> speedup {mig['speedup']:.1f}x (acceptance floor: 5x)")
    assert mig["speedup"] >= 5.0, "batched executor under the 5x floor"

    print("\nplacement policies (65536-page assignment):")
    pol = bench_policies()
    for name, r in pol.items():
        frac = ", ".join(f"{f:.2f}" for f in r["fractions"])
        print(f"  {name:15s} {r['assign_s'] * 1e3:7.2f} ms  [{frac}]")

    print("\npage-pool allocation throughput:")
    al = bench_alloc(device=device)
    print(f"  {al['pages']} pages in {al['alloc_s'] * 1e3:.1f} ms "
          f"({al['pages_per_s']:.0f} pages/s)")
    return {"migration": mig, "policies": pol, "alloc": al}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pages", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="where the pools live (cuda or cpu)")
    args = ap.parse_args(argv)
    artifacts.dump("BENCH_torch_placement.json",
                   suite(args.pages, device=args.device))


if __name__ == "__main__":
    main()
