"""Compute-follows-data in the port (``coda``: per-domain decode
micro-batches and heat-driven re-homing of hot shared pages) against the
reference: the cases of ``tests/test_coda.py`` run on both packages with
the same inputs (``coda_compare`` is in ``test_torch_coda_compare.py``).

The port runs on the CPU; both engines get the reference's params through
numpy (``repro_torch.convert.params_from_reference``).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="parity with the reference needs jax")

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ModuleNotFoundError:      # bare env: property tests skip individually
    from _hypothesis_stub import given, settings, st

import repro.core.bwmodel as r_bwmodel  # noqa: E402
import repro.obs.drift as r_drift  # noqa: E402
import repro.obs.heat as r_heat  # noqa: E402
import repro.obs.observatory as r_obs  # noqa: E402
import repro.placement.fabric as r_fabric  # noqa: E402
import repro.placement.pool as r_pool  # noqa: E402
import repro.scheduler as r_sched  # noqa: E402
import repro.serve.engine as r_engine  # noqa: E402
import repro_torch.core.bwmodel as t_bwmodel  # noqa: E402
import repro_torch.obs.drift as t_drift  # noqa: E402
import repro_torch.obs.heat as t_heat  # noqa: E402
import repro_torch.obs.observatory as t_obs  # noqa: E402
import repro_torch.placement.fabric as t_fabric  # noqa: E402
import repro_torch.placement.pool as t_pool  # noqa: E402
import repro_torch.scheduler as t_sched  # noqa: E402
import repro_torch.serve.engine as t_engine  # noqa: E402
from _torch_parity import smoke_pair  # noqa: E402
from repro.core.dwp import DWPConfig  # noqa: E402

REF = types.SimpleNamespace(pool=r_pool, fabric=r_fabric, sched=r_sched,
                            engine=r_engine, heat=r_heat, drift=r_drift,
                            obs=r_obs, bwmodel=r_bwmodel, port=False)
PORT = types.SimpleNamespace(pool=t_pool, fabric=t_fabric, sched=t_sched,
                             engine=t_engine, heat=t_heat, drift=t_drift,
                             obs=t_obs, bwmodel=t_bwmodel, port=True)


def _dev(pkg) -> dict:
    return {"device": "cpu"} if pkg.port else {}


@pytest.fixture(scope="module")
def smoke():
    return smoke_pair()


def _pool(pkg, cfg, fast=8, peer=24, host=40, page_size=4,
          policy="bwap_dwp"):
    """``test_coda._pool``: a small fast domain, slow bandwidths in the
    engine-latency range, the tuner frozen."""
    m = pkg.pool
    return m.BwapPagePool(cfg, [
        m.MemoryDomain("hbm_local", fast, 819.0, True),
        m.MemoryDomain("hbm_peer", peer, 0.00125, False),
        m.MemoryDomain("host", host, 0.0004, False),
    ], page_size=page_size, policy=policy,
        dwp_config=DWPConfig(n=10 ** 6, c=1), **_dev(pkg))


def _grow(pool, n):
    pages = []
    pool.table.grow(pages, n)
    return pages


def _both(fn):
    """``fn(pkg)`` on the reference and on the port."""
    return fn(REF), fn(PORT)


# -- bwmodel.move_cost ----------------------------------------------------------

@pytest.mark.parametrize("bytes_, dst", [
    ([2e9, 0.0], 1), ([0.0, 2e9], 0), ([2e9, 1e9], 0), ([0.0, 0.0], 0)])
def test_move_cost_read_and_write_bottlenecks(bytes_, dst):
    bw = np.array([2.0, 1.0])
    got = t_bwmodel.move_cost(np.array(bytes_), bw, dst)
    assert got == r_bwmodel.move_cost(np.array(bytes_), bw, dst)
    assert got == pytest.approx(
        {(2e9, 0.0): 2.0, (0.0, 2e9): 2.0, (2e9, 1e9): 1.5,
         (0.0, 0.0): 0.0}[tuple(bytes_)])


# -- scheduler: launch partitioning + remap patching ----------------------------

def test_launch_groups_partition_by_bottleneck_domain(smoke):
    def run(pkg):
        cfg, _ = smoke[pkg.port]
        pool = _pool(pkg, cfg, fast=4, peer=8, host=8)
        sched = pkg.sched.RequestScheduler(pool, max_batch=8,
                                           default_max_new=4,
                                           micro_batch=True)
        fast_pages = _grow(pool, 4)              # fills hbm_local exactly
        slow_pages = _grow(pool, 3)              # spills to a slow domain
        assert {pool.domain_of(p) for p in fast_pages} == {0}
        assert 0 not in {pool.domain_of(p) for p in slow_pages}
        reqs = [types.SimpleNamespace(pages=p, i=i) for i, p in
                enumerate((fast_pages, slow_pages, []))]

        def groups(*idx):
            g = sched._launch_groups([reqs[i] for i in idx])
            return None if g is None else [(d, [r.i for r in grp])
                                           for d, grp in g]
        return (fast_pages, slow_pages, groups(0, 1), groups(0, 0),
                groups(0, 2))
    ref, port = _both(run)
    assert port == ref
    fast, slow, split, same, empty = port
    assert len(split) == 2 and dict(split)[0] == [0]
    assert [1] in [g for d, g in split if d != 0]
    assert same is None and empty is None


def test_apply_page_remap_patches_every_queue(smoke):
    def run(pkg):
        cfg, _ = smoke[pkg.port]
        sched = pkg.sched.RequestScheduler(_pool(pkg, cfg), max_batch=4,
                                           default_max_new=4)
        mk = lambda *pages: types.SimpleNamespace(pages=list(pages))  # noqa
        a, b, c, d = mk(1, 2), mk(2, 3), mk(7), mk()
        sched.queued, sched.prefilling = [a], [b]
        sched.running, sched.swapped = [c], [d]
        sched._apply_page_remap({2: 20, 7: 70})
        return [r.pages for r in (a, b, c, d)]
    ref, port = _both(run)
    assert port == ref == [[1, 20], [20, 3], [70], []]


# -- fabric: re-home candidate ranking + budgeted migration ---------------------

def _shared_slow_setup(pkg, cfg, *, n_prefix=3):
    """``test_coda._shared_slow_setup``: fast filled with exclusive pages,
    a shared prefix chain in the slow domains, all through the view."""
    pool = _pool(pkg, cfg, fast=4, peer=16, host=16)
    view = pkg.fabric.as_view(pool)
    ps = pool.page_size
    filler: list = []
    view.grow(filler, 4)
    prefix: list = []
    view.grow(prefix, n_prefix)
    assert all(pool.domain_of(p) != 0 for p in prefix)
    tokens = list(range(1, 1 + n_prefix * ps))
    view.register_prefix(tokens, prefix, len(tokens))
    holder: list = []
    assert view.probe_prefix(tokens, holder) == n_prefix * ps
    assert all(view.shared(p) for p in prefix)
    return pool, view, filler, prefix, holder


def test_rehome_candidates_only_hot_shared_slow_pages(smoke):
    def run(pkg):
        pool, view, filler, prefix, _ = _shared_slow_setup(
            pkg, smoke[pkg.port][0])
        heat = pkg.heat.PageHeat(pool)
        heat.touch(filler)
        heat.touch(prefix[:2], weights=[4.0, 1.0])
        heat.step()
        return prefix, view.rehome_candidates(heat)
    ref, port = _both(run)
    assert port == ref
    prefix, cands = port
    assert [pid for pid, _, _ in cands] == [prefix[0], prefix[1]]
    ranks = [rank for _, _, rank in cands]
    assert ranks == sorted(ranks, reverse=True)


def test_rehome_hot_respects_budget_and_profitability(smoke):
    def run(pkg):
        pool, view, filler, prefix, _ = _shared_slow_setup(
            pkg, smoke[pkg.port][0])
        heat = pkg.heat.PageHeat(pool)
        heat.touch(prefix, weights=[8.0, 8.0, 0.5])
        heat.step()
        bw = view.fabric.bw_effective
        pb = float(view.page_bytes)
        one_page = max(pb / (bw[pool.domain_of(prefix[0])] * 1e9),
                       pb / (bw[0] * 1e9))
        view.release(filler)
        first = view.rehome_hot(heat, budget_s=one_page * 1.5)
        view.fabric.check_invariants()
        second = view.rehome_hot(heat, budget_s=10.0)
        view.fabric.check_invariants()
        return prefix, one_page, first, second
    ref, port = _both(run)
    assert port == ref
    prefix, one_page, (moves, cost), (moves2, _) = port
    assert len(moves) == 1 and cost <= one_page * 1.5
    assert set(moves) <= {prefix[0], prefix[1]}
    assert set(moves) | set(moves2) == {prefix[0], prefix[1]}
    assert prefix[2] not in moves2


def test_rehome_hot_all_holders_remap_preserves_kv(smoke):
    cfg = smoke[True][0]
    pool, view, filler, prefix, holder = _shared_slow_setup(PORT, cfg)
    rng = np.random.default_rng(0)
    pool.k_pool.copy_(torch.from_numpy(
        rng.standard_normal(pool.k_pool.shape).astype(np.float32)))
    pool.v_pool.copy_(torch.from_numpy(
        rng.standard_normal(pool.v_pool.shape).astype(np.float32)))
    k0, v0 = pool.k_pool.clone(), pool.v_pool.clone()
    heat = t_heat.PageHeat(pool)
    heat.touch(prefix, weights=[9.0, 9.0, 9.0])
    heat.step()
    seen = []
    # the holders' callback sees the moved bytes before anything else runs
    view.on_page_remap(lambda moves: seen.append(
        (moves, all(torch.equal(pool.k_pool[:, n], k0[:, o])
                    and torch.equal(pool.v_pool[:, n], v0[:, o])
                    for o, n in moves.items()))))
    view.release(filler)
    free0 = pool.free_count()
    k_pool = pool.k_pool
    moves, _ = view.rehome_hot(heat, budget_s=10.0)
    assert pool.k_pool is k_pool                     # written in place
    assert set(moves) == set(prefix)
    assert all(pool.domain_of(new) == 0 for new in moves.values())
    assert seen == [(moves, True)]
    view.fabric.check_invariants()
    assert pool.free_count() == free0                # old ids recycled
    # the reference, same ops: the same page ids move
    r_pool_, r_view, r_filler, r_prefix, _ = _shared_slow_setup(
        REF, smoke[False][0])
    r_heat_ = r_heat.PageHeat(r_pool_)
    r_heat_.touch(r_prefix, weights=[9.0, 9.0, 9.0])
    r_heat_.step()
    r_view.release(r_filler)
    assert r_view.rehome_hot(r_heat_, budget_s=10.0)[0] == moves
    # both holders still release cleanly through the remapped ids
    view.release([moves.get(p, p) for p in holder])
    view.release([moves[p] for p in prefix])
    view.fabric.check_invariants()


# -- drift: per-launch billing --------------------------------------------------

def test_observe_launches_bills_only_read_domains(smoke):
    def run(pkg):
        view = pkg.fabric.as_view(_pool(pkg, smoke[pkg.port][0]))
        led = pkg.drift.DriftLedger(view.fabric, calibrate_every=10 ** 9)
        bw = view.fabric.bw_effective

        def probe(kind, bpd):
            return np.asarray(bpd) / (bw * 1e9)

        launches = [(np.array([4096.0, 0.0, 0.0]), 1e-8),
                    (np.array([0.0, 8192.0, 0.0]), 1e-3),
                    (np.zeros(3), 0.5)]              # zero bytes: skipped
        n = led.observe_launches("batch_read", launches, probe)
        return n, led.summary()
    ref, port = _both(run)
    assert port == ref
    assert port[0] == 2 and port[1]["domain_samples"] == [1, 1, 0]


# -- heat: bytes-weighted touches + Prometheus export ---------------------------

def test_heat_touch_weights(smoke):
    def run(pkg):
        pool = _pool(pkg, smoke[pkg.port][0])
        pages = _grow(pool, 2)
        heat = pkg.heat.PageHeat(pool)
        heat.touch(pages, weights=[1.0, 0.25])
        first = [heat.value(p) for p in pages]
        heat.touch([pages[1]])
        return first, heat.value(pages[1]), heat.snapshot()
    ref, port = _both(run)
    assert port == ref
    assert port[0] == [1.0, 0.25] and port[1] == 1.25


def test_engine_page_read_weights_partial_tail(smoke):
    def run(pkg):
        cfg, params = smoke[pkg.port]
        eng = pkg.engine.ServeEngine(cfg, params, _pool(pkg, cfg),
                                     wall_clock=False, sim_step_s=0.01,
                                     **_dev(pkg))
        seq = types.SimpleNamespace(pages=[10, 11], length=6)
        seq2 = types.SimpleNamespace(pages=[11], length=4)
        return (eng._page_read_weights([seq]),
                eng._page_read_weights([seq, seq2]))
    ref, port = _both(run)
    assert port == ref == ({10: 1.0, 11: 0.5}, {10: 1.0, 11: 1.0})


def test_heat_histograms_in_prometheus_text(smoke):
    def run(pkg):
        pool = _pool(pkg, smoke[pkg.port][0])
        obs = pkg.obs.Observatory(pool, tracer=False, drift=False)
        pages = _grow(pool, 3)
        obs.heat.touch(pages, weights=[2.0, 1.0, 0.5])
        obs.heat.step()
        obs.refresh_heat_gauges()
        return obs.metrics.prometheus_text()
    ref, port = _both(run)
    assert port == ref
    assert 'repro_page_heat{domain="hbm_local",stat="pages"} 3' in port
    assert 'stat="max"' in port and 'stat="p95"' in port


# -- workload: domain_skew and hot_prefix traces --------------------------------

@pytest.mark.parametrize("spec", [
    dict(kind="domain_skew", num_requests=8, skew_frac=0.5,
         mean_interarrival_s=0.02, prompt_mean=4, prompt_max=24, max_new=8,
         vocab_size=500, seed=3, prefix_len=8, prefix_groups=1,
         prefix_frac=1.0),
    dict(kind="hot_prefix", num_requests=6, mean_interarrival_s=0.01,
         prompt_mean=6, prompt_max=40, max_new=4, vocab_size=500, seed=1)],
    ids=["domain_skew", "hot_prefix"])
def test_coda_traces_equal_the_reference(spec):
    ref = r_sched.generate(r_sched.WorkloadSpec(**spec))
    port = t_sched.generate(t_sched.WorkloadSpec(**spec))
    assert [dataclasses.asdict(t) for t in port] \
        == [dataclasses.asdict(t) for t in ref]
    again = t_sched.generate(t_sched.WorkloadSpec(**spec))
    assert [t.prompt for t in again] == [t.prompt for t in port]
    if spec["kind"] == "domain_skew":
        flood, tail = port[:4], port[4:]
        prefix = tail[0].prompt[:8]
        assert all(len(t.prompt) == 24 for t in flood)
        assert all(t.prompt[:8] != prefix for t in flood)
        assert flood[-1].arrival_s < 4 * 0.02 / 50      # gaps at mean/100
        assert all(t.prompt[:8] == prefix for t in tail)
        assert all(len(t.prompt) < 24 for t in tail)
    else:
        head = port[0].prompt[:12]
        assert all(t.prompt[:12] == head for t in port)


# -- engine: micro-batch + re-homing vs the global-batch oracle -----------------

def _contention_trace(vocab, seed=0):
    """``test_coda._contention_trace``: fillers claim the fast domain, the
    sharers of one hot 16-token template arrive while it is full."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, 16).tolist()
    fillers = [(rng.integers(1, vocab, 16).tolist(), 4, 0.0)
               for _ in range(3)]
    sharers = [(prefix + rng.integers(1, vocab, 4).tolist(),
                24, 0.02 + 0.01 * i) for i in range(3)]
    return fillers + sharers


def _run_policy(pkg, smoke, policy, trace, *, invariants_every_step=False):
    cfg, params = smoke[pkg.port]
    pool = _pool(pkg, cfg, fast=8, peer=24, host=40, policy=policy)
    view = pkg.fabric.as_view(pool)
    obs = pkg.obs.Observatory(pool, tracer=False, drift=False)
    sched = pkg.sched.RequestScheduler(pool, max_batch=8,
                                       prefill_token_budget=32,
                                       default_max_new=24)
    eng = pkg.engine.ServeEngine(cfg, params, pool, scheduler=sched,
                                 wall_clock=False, sim_step_s=0.01,
                                 **_dev(pkg))
    free0 = pool.free_count()
    for prompt, max_new, arr in trace:
        eng.submit(list(prompt), max_new=max_new, arrival_s=arr)
    steps, infos = 0, []
    while (eng.active or eng.waiting) and steps < 600:
        info = eng.step()
        infos.append((info.get("launches"), info.get("rehomed")))
        if invariants_every_step:
            view.fabric.check_invariants()
        steps += 1
    view.fabric.check_invariants()
    assert len(eng.finished) == len(trace)
    assert pool.free_count() == free0, "run leaked pages"
    assert pool.table.ref == {}, "run leaked page-table holds"
    return ({s.sid: list(s.tokens) for s in eng.finished}, eng, obs, infos)


def test_coda_token_identical_rehomes_and_counts_launches(smoke):
    trace = _contention_trace(smoke[True][0].vocab_size)
    toks, eng, obs, infos = _run_policy(PORT, smoke, "coda", trace,
                                        invariants_every_step=True)
    toks_glob, eng_glob, _, _ = _run_policy(PORT, smoke, "bwap_dwp", trace)
    r_toks, r_eng, r_obs_, r_infos = _run_policy(REF, smoke, "coda", trace)
    assert toks == toks_glob == r_toks
    assert infos == r_infos                   # launches, re-homed, by step
    assert eng.rehome and eng.scheduler.micro_batch
    assert not eng_glob.rehome and not eng_glob.scheduler.micro_batch
    assert eng.rehomed_pages == r_eng.rehomed_pages > 0
    assert eng_glob.rehomed_pages == 0
    text = obs.metrics.prometheus_text()
    assert text == r_obs_.metrics.prometheus_text()
    assert 'repro_decode_launches_total{view="default",domain=' in text
    assert 'repro_rehomed_pages_total{view="default"}' in text


def _random_schedule_roundtrip(smoke, seed):
    trace = t_sched.generate(t_sched.WorkloadSpec(
        kind="domain_skew", num_requests=5, skew_frac=0.4,
        mean_interarrival_s=0.02, prompt_mean=4, prompt_max=16,
        max_new=6, vocab_size=smoke[True][0].vocab_size, seed=seed,
        prefix_len=8, prefix_groups=1, prefix_frac=1.0))
    rows = [(t.prompt, t.max_new, t.arrival_s) for t in trace]
    toks_coda, *_ = _run_policy(PORT, smoke, "coda", rows,
                                invariants_every_step=True)
    toks_glob, *_ = _run_policy(PORT, smoke, "bwap_dwp", rows)
    assert toks_coda == toks_glob
    return rows, toks_coda


@pytest.mark.parametrize("seed", [1, 7])
def test_coda_random_schedules_match_oracle(smoke, seed):
    rows, toks = _random_schedule_roundtrip(smoke, seed)
    if seed == 1:                             # and the reference's tokens
        assert toks == _run_policy(REF, smoke, "bwap_dwp", rows)[0]


@settings(max_examples=3, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2 ** 20))
def test_coda_random_schedules_match_oracle_property(smoke, seed):
    _random_schedule_roundtrip(smoke, seed)
