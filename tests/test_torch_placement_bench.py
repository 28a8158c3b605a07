"""``benchmarks/torch_placement_bench.py`` against
``benchmarks/placement_bench.py`` at ``suite(pages=1024)``'s sizes (what
``benchmarks/run.py`` runs, which wrote ``BENCH_placement.json``), on the
CPU: the policy fractions equal the reference's and the artifact's
exactly, batched moves equal looped ones and the reference executor's
bits, the pool hands out the reference's page ids, and the port's
artifact check (``benchmarks/torch_artifacts.py``) holds each
``BENCH_torch_<x>.json`` to the reference's schema. Wall times are not
gated here (the CPU's timings flake); the 5x executor floor is gated by
``suite`` on the card."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")

from benchmarks import placement_bench as r_bench  # noqa: E402
from benchmarks import torch_artifacts  # noqa: E402
from benchmarks import torch_placement_bench as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PAGES = 1024


def test_policy_fractions_equal_the_reference_and_bench_placement_json():
    ref = r_bench.bench_policies()
    port = t_bench.bench_policies()
    bench = json.loads((ROOT / "BENCH_placement.json").read_text())
    assert list(port) == list(ref) == list(bench["policies"])
    for name in port:
        assert port[name]["fractions"] == ref[name]["fractions"] \
            == bench["policies"][name]["fractions"], name
        assert port[name]["assign_s"] >= 0.0


@pytest.mark.parametrize("geometry,dtype", [
    (t_bench.REFERENCE_GEOMETRY, torch.float32),
    ((2, 4, 2, 16), torch.bfloat16)], ids=["reference", "bf16"])
def test_batched_moves_equal_looped_ones(geometry, dtype):
    r = t_bench.bench_migration(PAGES, geometry=geometry, dtype=dtype,
                                device="cpu")
    assert r["num_moves"] == PAGES
    nl, ps, nkv, hd = geometry
    assert r["bytes_moved"] == 2 * PAGES * nl * ps * nkv * hd \
        * torch.tensor([], dtype=dtype).element_size()
    assert r["batched_s"] > 0 and r["per_page_loop_s"] > 0
    assert math.isfinite(r["speedup"])


def test_batched_moves_equal_the_reference_executor():
    """The port's in-place executor and the reference's functional one
    give the same pool bits for the benchmark's move, and a permutation
    whose sources and destinations overlap."""
    import jax.numpy as jnp
    from repro.placement.executor import MigrationExecutor as RExec
    from repro_torch.placement.executor import MigrationExecutor as TExec

    nl, ps, nkv, hd = t_bench.REFERENCE_GEOMETRY
    total = 2 * PAGES
    base = np.arange(nl * total * ps * nkv * hd, dtype=np.float32).reshape(
        nl, total, ps, nkv, hd)
    rng = np.random.default_rng(0)
    perm = rng.permutation(total)[:PAGES]
    moves = [(np.arange(PAGES), np.arange(PAGES) + PAGES),
             (perm, np.roll(perm, 1))]
    for src, dst in moves:
        (rk, rv), _ = RExec().execute((jnp.asarray(base),
                                       jnp.asarray(base + 1)), src, dst)
        tk, tv = torch.from_numpy(base.copy()), torch.from_numpy(base + 1)
        TExec().execute((tk, tv), src, dst)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_alloc_hands_out_the_reference_ids():
    """``bench_alloc``'s ids are unique, and its pool hands them out in
    the reference pool's order."""
    import dataclasses

    from repro.configs import registry
    from repro.placement.pool import BwapPagePool, MemoryDomain
    from _torch_parity import port_config
    from repro_torch.placement import pool as t_pool

    r = t_bench.bench_alloc(PAGES, device="cpu")
    assert r["pages"] == PAGES and r["pages_per_s"] > 0
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    doms = [("hbm_local", PAGES // 2, 819.0, True),
            ("hbm_peer", PAGES // 4, 50.0, False),
            ("host", PAGES - PAGES // 2 - PAGES // 4, 16.0, False)]
    ref = BwapPagePool(cfg, [MemoryDomain(*d) for d in doms], page_size=4)
    port = t_pool.BwapPagePool(port_config(cfg),
                               [t_pool.MemoryDomain(*d) for d in doms],
                               page_size=4, device="cpu")
    ids = [port.alloc_page() for _ in range(PAGES)]
    assert len(set(ids)) == PAGES
    assert ids == [ref.alloc_page() for _ in range(PAGES)]


def test_port_artifacts_hold_the_reference_schemas(tmp_path):
    """The suite's rows pass the port's artifact check; a missing key, a
    NaN and a missing file each fail it; every expected name is written
    by one of the port's benchmarks."""
    rows = {"migration": t_bench.bench_migration(64, device="cpu"),
            "policies": t_bench.bench_policies(4096),
            "alloc": t_bench.bench_alloc(64, device="cpu")}
    name = "BENCH_torch_placement.json"
    (tmp_path / name).write_text(json.dumps(rows))
    torch_artifacts.check((name,), root=tmp_path)
    assert torch_artifacts.SCHEMAS[name] == ("alloc", "migration",
                                             "policies")
    bad = dict(rows, alloc={"pages_per_s": float("nan")})
    assert torch_artifacts.problems(name, bad)
    assert torch_artifacts.problems(name, {"alloc": 1})
    with pytest.raises(SystemExit, match="missing"):
        torch_artifacts.check(("BENCH_torch_zoo.json",), root=tmp_path)
    writers = "".join((ROOT / "benchmarks" / f).read_text() for f in (
        "torch_scheduler_bench.py", "torch_serve_bench.py",
        "torch_obs_bench.py", "torch_placement_bench.py"))
    assert torch_artifacts.EXPECTED == tuple(torch_artifacts.SCHEMAS)
    assert "BENCH_torch_serve.json" in torch_artifacts.EXPECTED
    for n in torch_artifacts.EXPECTED:
        assert f'"{n}"' in writers, n
