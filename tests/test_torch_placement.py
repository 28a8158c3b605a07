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


# ---------------------------------------------------------------------------
# ``tests/test_placement.py``'s cases on both packages
# (``_torch_parity.both``): the policy registry and its weights and counts,
# the executor against its per-page oracle, the telemetry ring and counters,
# pool migration, fallback and rebalance, the two-stage co-scheduled tuner,
# the arbiter's unregister and interference, and the engine step's
# telemetry. Each returns a record that must be equal on both. The arbiter's
# other cases are in ``test_torch_arbiter.py``, the checkpoint staging
# cases in ``test_torch_ckpt.py``.
# ---------------------------------------------------------------------------

from _torch_parity import both, smoke_pair  # noqa: E402

BWS = (819.0, 50.0, 16.0)


def _pctx(pkg, bws=BWS, pages=1000, workers=(0,), dwp=0.0, caps=None):
    return pkg.policy.PlacementContext(
        bandwidths=np.asarray(bws), num_pages=pages, workers=workers,
        dwp=dwp, capacities=None if caps is None else np.asarray(caps))


def _ppool(pkg, pages=64):
    cfg, _ = _cfgs()
    doms = (("hbm_local", pages // 2, 819.0, True),
            ("hbm_peer", pages // 4, 50.0, False),
            ("host", pages - pages // 2 - pages // 4, 16.0, False))
    return pkg.pool(cfg, doms, page_size=4,
                    dwp_config=pkg.dwp.DWPConfig(n=4, c=1))


def _arr(pkg, a: np.ndarray):
    return torch.from_numpy(a.copy()) if pkg.port else jnp.asarray(a)


# -- policy registry ----------------------------------------------------------

def test_registry_has_all_four_policies():
    def case(pkg):
        assert {"uniform", "bwap_canonical", "bwap_dwp",
                "local_first"} <= set(pkg.policy.available())
        with pytest.raises(KeyError):
            pkg.policy.get("no_such_policy")
        return sorted(pkg.policy.available())
    both(case)


@pytest.mark.parametrize("name,dwp", [("uniform", 0.0),
                                      ("bwap_canonical", 0.0),
                                      ("bwap_dwp", 0.4)],
                         ids=["uniform_weights_are_equal",
                              "canonical_weights_proportional_to_bw",
                              "bwap_dwp_matches_core_dwp_weights"])
def test_policy_weights(name, dwp):
    """``test_uniform_weights_are_equal``,
    ``test_canonical_weights_proportional_to_bw`` and
    ``test_bwap_dwp_matches_core_dwp_weights``."""
    def case(pkg):
        w = pkg.policy.weights(name, _pctx(pkg, dwp=dwp))
        bw = np.asarray(BWS)
        want = {"uniform": np.full(3, 1 / 3), "bwap_canonical": bw / bw.sum(),
                "bwap_dwp": pkg.interleave.dwp_weights(
                    pkg.interleave.normalize(bw), [0], 0.4)}[name]
        np.testing.assert_allclose(w, want)
        return w
    both(case)


def test_local_first_fills_fastest_then_spills():
    def case(pkg):
        c = pkg.policy.get("local_first").counts(
            _pctx(pkg, pages=150, caps=(100, 100, 100)))
        np.testing.assert_array_equal(c, [100, 50, 0])
        return c
    both(case)


def test_counts_respect_capacity_and_total():
    def case(pkg):
        ctx = _pctx(pkg, pages=1000, caps=(100, 600, 600))
        out = {}
        for name in pkg.policy.available():
            c = pkg.policy.get(name).counts(ctx)
            assert int(c.sum()) == 1000, name
            assert (c <= np.asarray([100, 600, 600])).all(), name
            out[name] = c
        return out
    both(case)


def test_counts_raise_when_capacity_exceeded():
    def case(pkg):
        ctx = _pctx(pkg, pages=1000, caps=(100, 100, 100))
        msgs = {}
        for name in pkg.policy.available():
            with pytest.raises(ValueError) as e:
                pkg.policy.get(name).counts(ctx)
            msgs[name] = str(e.value)
        return msgs
    both(case)


def test_assign_fractions_follow_clamped_counts():
    def case(pkg):
        a = pkg.policy.assign("bwap_canonical",
                              _pctx(pkg, pages=1024, caps=(64, 2000, 2000)))
        counts = np.bincount(a, minlength=3)
        assert counts[0] <= 64
        assert counts.sum() == 1024
        assert counts[1] > counts[2]
        return a
    both(case)


# -- migration executor -------------------------------------------------------

def test_executor_matches_per_page_oracle():
    def case(pkg):
        k = np.arange(2 * 16 * 3 * 2 * 4, dtype=np.float32).reshape(
            2, 16, 3, 2, 4)
        src, dst = [0, 3, 5, 7], [8, 9, 12, 15]
        ex = pkg.executor.MigrationExecutor()
        (bk, bv), res = ex.execute((_arr(pkg, k), _arr(pkg, 2 * k)), src,
                                   dst)
        (lk, lv), _ = ex.execute_looped((_arr(pkg, k), _arr(pkg, 2 * k)),
                                        src, dst)
        bk, bv, lk, lv = (pkg.host(x) for x in (bk, bv, lk, lv))
        assert np.array_equal(bk, lk) and np.array_equal(bv, lv)
        assert res.num_moves == 4
        assert res.bytes_moved == 2 * 4 * (2 * 3 * 2 * 4 * 4)
        return bk, bv, res.num_moves, res.bytes_moved
    both(case)


def test_executor_empty_moves_is_noop():
    def case(pkg):
        k = _arr(pkg, np.ones((1, 4, 2), np.float32))
        (out,), res = pkg.executor.MigrationExecutor().execute((k,), [], [])
        assert out is k and res.num_moves == 0
        return res.num_moves, res.bytes_moved, res.pair_pages
    both(case)


def test_executor_copy_across_pools():
    def case(pkg):
        src = np.arange(1 * 8 * 2, dtype=np.float32).reshape(1, 8, 2)
        (out,), res = pkg.executor.MigrationExecutor().copy(
            (_arr(pkg, src),), (_arr(pkg, np.zeros((1, 12, 2), np.float32)),),
            [1, 7], [0, 11])
        out = pkg.host(out)
        assert np.array_equal(out[:, 0], src[:, 1])
        assert np.array_equal(out[:, 11], src[:, 7])
        assert res.num_moves == 2
        return out, res.num_moves, res.bytes_moved
    both(case)


def test_executor_records_pair_telemetry():
    def case(pkg):
        tel = pkg.telemetry.DomainTelemetry(["a", "b"])
        ex = pkg.executor.MigrationExecutor(telemetry=tel)
        ex.execute((_arr(pkg, np.ones((1, 8, 2), np.float32)),), [0, 1, 2],
                   [4, 5, 6], src_domains=[0, 0, 0], dst_domains=[1, 1, 1])
        assert tel.migrations_out[0] == 3
        assert tel.migrations_in[1] == 3
        assert tel.bytes_moved > 0
        return tel.snapshot()
    both(case)


# -- telemetry ----------------------------------------------------------------

def test_ring_overwrites_oldest():
    def case(pkg):
        r = pkg.telemetry.Ring(capacity=3)
        for x in [1.0, 2.0, 3.0, 4.0]:
            r.push(x)
        np.testing.assert_array_equal(r.values(), [2.0, 3.0, 4.0])
        assert r.last() == 4.0
        assert len(r) == 3
        return r.values(), r.last(), len(r)
    both(case)


def test_telemetry_snapshot_counters():
    def case(pkg):
        t = pkg.telemetry.DomainTelemetry(["fast", "slow"], ring_capacity=8)
        t.record_alloc(0, 3)
        t.record_free(0, 1)
        t.record_migration(0, 1, pages=2, nbytes=256)
        t.record_latency(0.5)
        t.record_stall(1, 0.1)
        s = t.snapshot()
        assert s["domains"]["fast"]["allocs"] == 3
        assert s["domains"]["fast"]["migr_out"] == 2
        assert s["domains"]["slow"]["migr_in"] == 2
        assert s["domains"]["slow"]["bytes_in"] == 256
        assert s["latency_last_s"] == 0.5
        assert s["executed_moves"] == 2
        return s
    both(case)


# -- pool on the new runtime --------------------------------------------------

def _pool_record(pkg, pool) -> dict:
    return {"free": [list(f) for f in pool.free],
            "k": pkg.host(pool.k_pool), "v": pkg.host(pool.v_pool),
            "tel": pool.telemetry.snapshot()}


def test_pool_migrate_sequence_is_batched_and_conserves_pages():
    def case(pkg):
        pool = _ppool(pkg, pages=64)
        ids = [pool.alloc_page() for _ in range(12)]
        for pid in ids:
            pkg.put(pool, [pid], float(pid))
        before_total = sum(len(f) for f in pool.free)
        pool.tuner.dwp = 1.0
        new_ids = pool.migrate_sequence(ids)
        assert len(new_ids) == len(ids)
        assert sum(len(f) for f in pool.free) == before_total
        k = pkg.host(pool.k_pool)
        for old, new in zip(ids, new_ids):
            np.testing.assert_allclose(k[:, new], float(old))
        moved = sum(1 for o, n in zip(ids, new_ids) if o != n)
        assert pool.telemetry.snapshot()["executed_moves"] == moved > 0
        return ids, list(new_ids), _pool_record(pkg, pool)
    both(case)


def test_pool_alloc_fallback_uses_precomputed_bw_order():
    def case(pkg):
        pool = _ppool(pkg, pages=16)
        assert pool._bw_order[0] == 0
        pool.free[0] = []
        pid = pool.alloc_page()
        assert pool.domain_of(pid) in (1, 2)
        return list(pool._bw_order), pid
    both(case)


def test_pool_rebalance_grows_capacity_and_remaps():
    def case(pkg):
        pool = _ppool(pkg, pages=32)
        ids = [pool.alloc_page() for _ in range(10)]
        for pid in ids:
            pkg.put(pool, [pid], float(pid) + 1.0)
        id_map = pool.rebalance([24, 12, 12])
        assert pool.total_pages == 48
        assert [d.num_pages for d in pool.domains] == [24, 12, 12]
        k = pkg.host(pool.k_pool)
        for old in ids:
            new = int(id_map[old])
            assert new >= 0
            np.testing.assert_allclose(k[:, new], float(old) + 1.0)
        assert sum(len(p) for p in pool.live_pages()) == 10
        assert sum(len(f) for f in pool.free) == 48 - 10
        nxt = pool.alloc_page()
        assert pool.domain_of(nxt) in (0, 1, 2)
        return id_map, nxt, _pool_record(pkg, pool)
    both(case)


def test_pool_rebalance_spills_overfull_domain():
    def case(pkg):
        pool = _ppool(pkg, pages=32)
        ids = []
        while len(ids) < 12 and pool.free[0]:
            ids.append(pool.free[0].pop())
        id_map = pool.rebalance([8, 20, 4])
        assert (id_map[np.asarray(ids)] >= 0).all()
        doms = [pool.domain_of(int(id_map[p])) for p in ids]
        assert sum(1 for d in doms if d == 0) == 8
        assert all(d == 1 for d in doms if d != 0)
        return id_map, doms, [list(f) for f in pool.free]
    both(case)


def test_pool_rebalance_raises_when_live_exceeds_capacity():
    def case(pkg):
        pool = _ppool(pkg, pages=32)
        ids = [pool.alloc_page() for _ in range(20)]
        with pytest.raises(ValueError) as e:
            pool.rebalance([4, 4, 4])
        return ids, str(e.value)
    both(case)


# -- two-stage co-scheduled search (paper §III-B3) ---------------------------

def _cotune(pkg, stall_a, stall_b, max_periods=60):
    canon = pkg.interleave.normalize(np.asarray([3.0, 2, 1, 1]))
    t = pkg.dwp.CoScheduledTuner(canon, workers_b=[0, 1], num_pages=1024)
    periods, trail = 0, []
    while not t.done and periods < max_periods:
        for _ in range(t.cfg.n):
            t.record(stall_a(t.dwp), stall_b(t.dwp))
        trail.append((t.stage, t.dwp, t.dwp_lower_bound))
        periods += 1
    return t, trail


def test_cotuner_stage1_freezes_bound_where_a_stabilises():
    def case(pkg):
        t, trail = _cotune(pkg, lambda d: max(1.0 - d, 0.7), lambda d: 1.0)
        assert t.stage == 2 or t.done
        assert t.dwp_lower_bound == pytest.approx(0.3, abs=t.cfg.x + 1e-9)
        return trail, t.assignment
    both(case)


def test_cotuner_stage2_respects_floor_when_optimum_below():
    def case(pkg):
        t, trail = _cotune(pkg, lambda d: max(1.0 - d, 0.6),
                           lambda d: 1.0 + d)
        assert t.done
        assert t.dwp_lower_bound >= 0.4 - 1e-9
        assert t.dwp >= t.dwp_lower_bound - 1e-9
        return trail, t.assignment
    both(case)


def test_cotuner_stage2_climbs_above_bound_when_beneficial():
    def case(pkg):
        t, trail = _cotune(pkg, lambda d: 1.0, lambda d: 2.0 - d)
        assert t.done
        assert t.dwp == pytest.approx(1.0)
        assert t.dwp > t.dwp_lower_bound
        return trail, t.assignment
    both(case)


# -- domain arbiter -----------------------------------------------------------

def _arbiter(pkg):
    m = pkg.arbiter
    specs = [m.DomainSpec("hbm_local", 64, 819.0),
             m.DomainSpec("hbm_peer", 48, 50.0),
             m.DomainSpec("host", 64, 16.0)]
    return m.DomainArbiter(specs, page_size=4,
                           **({"device": "cpu"} if pkg.port else {}))


def test_arbiter_unregister_redistributes_quota():
    def case(pkg):
        cfg = pkg.cfg(_cfgs()[0])
        P = pkg.arbiter.Priority
        arb = _arbiter(pkg)
        a = arb.register("A", cfg, priority=P.HIGH, share=0.5)
        b = arb.register("B", cfg, priority=P.BEST_EFFORT, share=0.5)
        pages = []
        for _ in range(5):
            a.view.append_page(pages)
        before = list(pages)
        quota_before, b_quota = a.quotas.copy(), b.quotas.copy()
        grants = arb.unregister("B")
        np.testing.assert_array_equal(a.quotas, quota_before + grants["A"])
        np.testing.assert_array_equal(grants["A"], b_quota)
        np.testing.assert_array_equal(a.view.quota, a.quotas)
        assert pages == before
        assert "B" not in arb.tenants and "B" not in arb.fabric.views
        assert (arb.free == 0).all()
        assert 1 not in arb._claimed_homes
        arb.fabric.check_invariants()
        return pages, a.quotas, grants, arb.free, sorted(arb._claimed_homes)
    both(case)


def test_arbiter_interference_tracks_foreign_residency():
    def case(pkg):
        cfg = pkg.cfg(_cfgs()[0])
        P = pkg.arbiter.Priority
        arb = _arbiter(pkg)
        arb.register("A", cfg, priority=P.HIGH, share=0.4)
        b = arb.register("B", cfg, priority=P.BEST_EFFORT, share=0.4)
        base = arb.interference("A")
        pages = []
        while int(b.view.used_pages()[0]) < 4:
            b.view.append_page(pages)
        grown = arb.interference("A")
        assert grown > base
        b.view.release(pages)
        return base, grown, pages
    both(case)


# -- engine surfaces telemetry ------------------------------------------------

def test_engine_step_reports_telemetry():
    smoke = smoke_pair()

    def case(pkg):
        cfg, params = smoke[pkg.port]
        eng = pkg.engine(cfg, params, _ppool(pkg, pages=64), max_batch=2,
                         max_new=3)
        eng.submit([3, 5, 7, 11])
        info = eng.step()
        tel = info["telemetry"]
        assert sum(d["allocs"] for d in tel["domains"].values()) > 0
        assert tel["latency_last_s"] > 0
        # the wall clock is in the latency: the record leaves it out
        return {k: v for k, v in tel.items() if "latency" not in k}, \
            eng.finished[0].tokens if eng.finished else \
            eng.active[0].tokens
    both(case)
