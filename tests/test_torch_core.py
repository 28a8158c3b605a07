"""repro_torch.core against repro.core: the same inputs give the same Eq.
1/2/5 weights, Alg.-1 interleaves, migration plans and DWP tuner
trajectories, bit for bit (the port carries the numpy modules over
unchanged apart from their imports)."""

import numpy as np
import pytest

from repro.core import bwmodel as r_bw
from repro.core import dwp as r_dwp
from repro.core import interleave as r_il
from repro.core import topology as r_topo
from repro_torch.core import bwmodel as t_bw
from repro_torch.core import dwp as t_dwp
from repro_torch.core import interleave as t_il
from repro_torch.core import topology as t_topo


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("machine", ["machine_a", "machine_b"])
def test_topology_and_eq2_weights_identical(machine):
    r, t = getattr(r_topo, machine)(), getattr(t_topo, machine)()
    t.validate()
    _eq(r.bw, t.bw)
    _eq(r.mc_bw, t.mc_bw)
    workers = [0, 1] if machine == "machine_a" else [0]
    rp, tp = r_bw.profile_bw(r, workers), t_bw.profile_bw(t, workers)
    _eq(rp, tp)
    _eq(r_bw.optimal_weights(rp), t_bw.optimal_weights(tp))
    rt, rn, rw = r_topo.tpu_domains_topology()
    tt, tn, tw = t_topo.tpu_domains_topology()
    _eq(rt.bw, tt.bw)
    assert (rn, rw) == (tn, tw)


def test_stall_and_move_costs_identical():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n = int(rng.integers(2, 7))
        b = rng.integers(0, 10 ** 7, n).astype(np.float64)
        bw = rng.uniform(0.01, 900.0, n)
        assert r_bw.stall_cost(b, bw) == t_bw.stall_cost(b, bw)
        dst = int(rng.integers(0, n))
        assert r_bw.move_cost(b, bw, dst) == t_bw.move_cost(b, bw, dst)


def test_interleave_and_migration_plans_identical():
    rng = np.random.default_rng(1)
    for _ in range(20):
        n = int(rng.integers(2, 6))
        w = rng.dirichlet(np.ones(n))
        pages = int(rng.integers(1, 5000))
        _eq(r_il.weighted_interleave(pages, w),
            t_il.weighted_interleave(pages, w))
        workers = sorted(rng.choice(n, int(rng.integers(1, n)),
                                    replace=False).tolist())
        d = float(rng.uniform(0, 1))
        _eq(r_il.dwp_weights(w, workers, d), t_il.dwp_weights(w, workers, d))
        old = r_il.weighted_interleave(pages, w)
        new = r_il.weighted_interleave(pages, rng.dirichlet(np.ones(n)))
        rp, tp = r_il.plan_migration(old, new), t_il.plan_migration(old, new)
        _eq(rp.moves, tp.moves)
        assert rp.num_moves == tp.num_moves


def test_dwp_tuner_trajectories_identical():
    rng = np.random.default_rng(2)
    canon = np.asarray([0.5, 0.3, 0.15, 0.05])
    cfg_r, cfg_t = r_dwp.DWPConfig(n=4, c=1), t_dwp.DWPConfig(n=4, c=1)
    r = r_dwp.DWPTuner(canon, [0], 1024, config=cfg_r)
    t = t_dwp.DWPTuner(canon, [0], 1024, config=cfg_t)
    for i in range(200):
        # a stall curve with its minimum at dwp 0.6: the tuner climbs
        stall = (r.dwp - 0.6) ** 2 + 0.1 + float(rng.uniform(0, 0.01))
        r.record(stall)
        t.record(stall)
        assert r.dwp == t.dwp and r.phase.name == t.phase.name
        _eq(r.assignment, t.assignment)
        if i == 50:
            frac = np.asarray([0.4, 0.4, np.inf, np.inf])
            assert r.set_capacity_fractions(frac) == \
                t.set_capacity_fractions(frac)
    assert len(r.history) > 2
    assert [(s.dwp, s.stall_rate, s.migrated_pages) for s in r.history] == \
        [(s.dwp, s.stall_rate, s.migrated_pages) for s in t.history]
