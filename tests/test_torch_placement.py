"""repro_torch.placement against repro.placement: one seeded sequence of
placement operations (allocate, grow, prefix sharing, copy-on-write,
migration, swap park/unpark, speculative undo, DWP latency feedback) runs
on both packages and must leave the same page ids, free lists, refcounts,
ownership and quota ledgers, telemetry counters and pool bytes after every
operation, with ``check_invariants()`` holding on both. The port writes its
pool tensors in place where the reference rebinds arrays.

Also: the port's batched executor against its per-page loop
(``execute_looped``) and against the reference executor.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.placement import executor as r_exec  # noqa: E402
from repro.placement import fabric as r_fab  # noqa: E402
from repro.placement import pool as r_pool  # noqa: E402
from repro_torch.core.dwp import DWPConfig  # noqa: E402
from repro_torch.models import config as t_config  # noqa: E402
from repro_torch.placement import executor as t_exec  # noqa: E402
from repro_torch.placement import fabric as t_fab  # noqa: E402
from repro_torch.placement import pool as t_pool  # noqa: E402


def _cfgs():
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=2, compute_dtype="float32")
    return cfg, t_config.ModelConfig(**dataclasses.asdict(cfg))


def _domains(mod):
    return [mod.MemoryDomain("hbm_local", 24, 819.0, True),
            mod.MemoryDomain("hbm_peer", 16, 50.0, False),
            mod.MemoryDomain("host", 24, 16.0, False)]


class Side:
    """One package's fabric views plus the sequences driven through them."""

    def __init__(self, port: bool, multi: bool):
        cfg, tcfg = _cfgs()
        self.port = port
        pool_m, fab_m = (t_pool, t_fab) if port else (r_pool, r_fab)
        dev = {"device": "cpu"} if port else {}
        if multi:
            self.fabric = fab_m.MemoryFabric(tcfg if port else cfg,
                                             _domains(pool_m), page_size=4,
                                             seed=0, **dev)
            self.views = [
                self.fabric.view("a", quota=[14, 10, 14], home=[0],
                                 dwp_config=DWPConfig(n=3, c=1)),
                self.fabric.view("b", quota=[10, 6, 10], home=[0],
                                 dwp_config=DWPConfig(n=3, c=1))]
        else:
            pool = pool_m.BwapPagePool(tcfg if port else cfg,
                                       _domains(pool_m), page_size=4,
                                       dwp_config=DWPConfig(n=3, c=1), **dev)
            self.views = [fab_m.as_view(pool)]
            self.fabric = self.views[0].fabric
        self.pool = self.fabric.pool
        self.seqs: list[tuple[int, list[int]]] = []   # (view index, pages)
        self.swaps = 0

    def write(self, pid: int, slot: int, k: np.ndarray, v: np.ndarray):
        view = self.views[0]
        if self.port:
            view.write_token((torch.from_numpy(k), torch.from_numpy(v)),
                             pid, slot)
        else:
            view.write_token((jnp.asarray(k), jnp.asarray(v)), pid, slot)

    def kv(self):
        if self.port:
            return self.pool.k_pool.numpy(), self.pool.v_pool.numpy()
        return np.asarray(self.pool.k_pool), np.asarray(self.pool.v_pool)

    def state(self):
        pool, fab = self.pool, self.fabric
        views = [(v.name, v.used.tolist(), v.reserved.tolist(), v.dwp)
                 for v in self.views]
        tel = self.views[0].telemetry.snapshot()
        return {"seqs": [(i, list(p)) for i, p in self.seqs],
                "free": [list(f) for f in pool.free],
                "reserved": pool.reserved.tolist(),
                "ref": dict(self.fabric.table.ref),
                "owner": dict(fab.owner), "views": views,
                "counters": {k: tel[k] for k in sorted(tel)
                             if k not in ("pagetable",)},
                "table": self.fabric.table.stats()}


def _drive(rng, sides, steps=120):
    l, nkv, hd = 2, 2, 16
    ps = 4
    prompts = [list(rng.integers(1, 50, int(rng.integers(4, 13))))
               for _ in range(6)]
    for step in range(steps):
        op = int(rng.integers(0, 8))
        nseq = len(sides[0].seqs)
        if op <= 1 or nseq == 0:                       # new sequence
            vi = int(rng.integers(0, len(sides[0].views)))
            toks = prompts[int(rng.integers(0, len(prompts)))]
            kv = [(rng.standard_normal((l, nkv, hd)).astype(np.float32),
                   rng.standard_normal((l, nkv, hd)).astype(np.float32))
                  for _ in toks]
            for sd in sides:
                view = sd.views[vi]
                pages: list[int] = []
                hit = view.probe_prefix(toks, pages)
                need = -(-len(toks) // ps) - len(pages)
                for _ in range(max(need, 0)):
                    view.append_page(pages)
                view.ensure_writable(pages, hit, len(toks))
                for pos in range(hit, len(toks)):
                    sd.write(pages[pos // ps], pos % ps, *kv[pos])
                view.register_prefix(toks, pages, len(toks))
                sd.seqs.append((vi, pages))
        elif op == 2:                                  # grow
            i = int(rng.integers(0, nseq))
            for sd in sides:
                vi, pages = sd.seqs[i]
                sd.views[vi].append_page(pages)
        elif op == 3:                                  # copy-on-write
            i = int(rng.integers(0, nseq))
            j = int(rng.integers(0, len(sides[0].seqs[i][1])))
            for sd in sides:
                vi, pages = sd.seqs[i]
                sd.views[vi].fork_for_write(pages, j)
        elif op == 4:                                  # migrate
            i = int(rng.integers(0, nseq))
            for sd in sides:
                vi, pages = sd.seqs[i]
                sd.seqs[i] = (vi, sd.views[vi].migrate(pages))
        elif op == 5:                                  # release
            i = int(rng.integers(0, nseq))
            for sd in sides:
                vi, pages = sd.seqs.pop(i)
                sd.views[vi].release(pages)
        elif op == 6:                                  # swap out and back
            i = int(rng.integers(0, nseq))
            for sd in sides:
                vi, pages = sd.seqs[i]
                view = sd.views[vi]
                own = view.exclusive(pages)
                if len(own) != len(pages) or \
                        view.free_domain_count(2) < len(pages):
                    continue
                slots = view.reserve(2, len(pages))
                view.park_pages(list(pages), slots)
                back = view.unpark_pages(slots)
                for s in slots:
                    view.unreserve(s)
                sd.seqs[i] = (vi, back)
                sd.swaps += 1
        else:                                          # speculative undo
            i = int(rng.integers(0, nseq))
            lat = float(rng.uniform(1e-4, 1e-2))
            for sd in sides:
                vi, pages = sd.seqs[i]
                view = sd.views[vi]
                m0 = view.alloc_marker()
                pid = view.append_page(pages)
                m1 = view.alloc_marker()
                assert view.pop_page(pages) == pid
                view.undo_alloc(pid, m0, m1)
                view.record_latency(lat)
        for sd in sides:
            sd.fabric.check_invariants()
        a, b = sides[0], sides[1]
        assert a.state() == b.state(), f"diverged at step {step} (op {op})"
        for x, y in zip(a.kv(), b.kv()):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("multi", [False, True], ids=["adopted", "fabric"])
def test_placement_ops_identical_to_reference(multi):
    sides = [Side(port=False, multi=multi), Side(port=True, multi=multi)]
    _drive(np.random.default_rng(7 + multi), sides)
    # the drive reached the interesting paths
    stats = sides[1].fabric.table.stats()
    assert stats["cow_faults"] > 0 and stats["prefix_hit_pages"] > 0
    doms = sides[1].views[0].telemetry.snapshot()["domains"].values()
    assert sum(d["migr_in"] for d in doms) > 0
    assert sides[0].swaps == sides[1].swaps > 0


def test_executor_batched_equals_looped_and_reference():
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 32, 4, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 32, 4, 2, 8)).astype(np.float32)
    perm = rng.permutation(32)
    src, dst = perm[:10].tolist(), perm[10:20].tolist()
    ex = t_exec.MigrationExecutor()
    batched = [torch.from_numpy(k.copy()), torch.from_numpy(v.copy())]
    looped = [torch.from_numpy(k.copy()), torch.from_numpy(v.copy())]
    out_b, res_b = ex.execute(batched, src, dst)
    out_l, res_l = ex.execute_looped(looped, src, dst)
    assert out_b[0] is batched[0]                     # written in place
    for x, y in zip(out_b, out_l):
        assert torch.equal(x, y)
    assert res_b.bytes_moved == res_l.bytes_moved == 2 * 10 * 4 * 2 * 2 * 8 * 4
    assert res_b.num_moves == res_l.num_moves == 10
    ref_out, ref_res = r_exec.MigrationExecutor().execute(
        (jnp.asarray(k), jnp.asarray(v)), src, dst)
    for x, y in zip(out_b, ref_out):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert ref_res.bytes_moved == res_b.bytes_moved


def test_executor_overlapping_move_reads_sources_first():
    """A move whose sources and destinations overlap (a rotation) must read
    every source before writing: the result equals the gather."""
    a = torch.arange(2 * 6 * 3, dtype=torch.float32).reshape(2, 6, 3)
    want = a.clone()
    src, dst = [0, 1, 2], [1, 2, 0]
    want[:, dst] = a[:, src]
    t_exec.MigrationExecutor().execute([a], src, dst)
    assert torch.equal(a, want)


def test_pool_rebalance_identical_to_reference():
    cfg, tcfg = _cfgs()
    r = r_pool.BwapPagePool(cfg, _domains(r_pool), page_size=4)
    t = t_pool.BwapPagePool(tcfg, _domains(t_pool), page_size=4,
                            device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(20):
        pr, pt = r.alloc_page(), t.alloc_page()
        assert pr == pt
        k = rng.standard_normal((2, 2, 16)).astype(np.float32)
        r.write_token((jnp.asarray(k), jnp.asarray(-k)), pr, 1)
        t.write_token((torch.from_numpy(k), torch.from_numpy(-k)), pt, 1)
    np.testing.assert_array_equal(r.rebalance([20, 12, 30]),
                                  t.rebalance([20, 12, 30]))
    np.testing.assert_array_equal(np.asarray(r.k_pool), t.k_pool.numpy())
    np.testing.assert_array_equal(np.asarray(r.v_pool), t.v_pool.numpy())
    assert [list(f) for f in r.free] == [list(f) for f in t.free]
    assert r.page_bytes == t.page_bytes
