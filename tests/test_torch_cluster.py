"""repro_torch's disaggregated serving cluster (``cluster/``: the Eq.-1/Eq.-5
interconnect, the page channel, convert-on-import, the prefill/decode
router) against the reference.

Each case of ``tests/test_cluster.py`` has a case of the same name here,
run on both packages with the same operations: the reference test's claims
hold on each, and the port's results equal the reference's — link prices
and weights, parcels' wire bytes, imported page ids and bytes, observatory
counters, and the router's tokens and summary (the one-layer fp32 smoke
model with the reference's params on both sides).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import BOTH, smoke_pair  # noqa: E402
from _torch_parity import both as _both, equal as _eq  # noqa: E402
from repro.configs import registry  # noqa: E402

CHAT = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                           num_layers=1, compute_dtype="float32")


def _host(pkg, *, page_size=4, pages=96, obs=False, **tier_kw):
    pool = pkg.pool(CHAT, [("hbm_local", pages // 2, 819.0, True),
                           ("host_dram", pages - pages // 2, 0.016, False)],
                    page_size)
    view = pkg.as_view(pool)
    tier_kw.setdefault("bw_gbps", 8.0)
    tier_kw.setdefault("capacity_pages", 256)
    tier = pkg.tier(**tier_kw)
    view.fabric.attach_persist(tier)
    ob = pkg.Observatory(pool) if obs else None
    return pool, view, tier, ob


def _chain(pkg, view, pool, tokens, val=5):
    pages = []
    for i in range(len(tokens) // pool.page_size):
        view.append_page(pages)
        pkg.fill(pool, pages[-1], val + i)
    view.register_prefix(list(tokens), pages, len(tokens))
    return pages


def _wire(pkg, *links, **kw):
    cl = pkg.cluster
    links = links or (("nvl", 0.2, 1e-4), ("rdma", 0.05, 5e-4))
    return cl.Interconnect([cl.Link(*l) for l in links], **kw)


# ---------------------------------------------------------------------------
# Eq. 1 with link rows
# ---------------------------------------------------------------------------

def test_stall_cost_link_rows():
    def case(pkg):
        sc = pkg.bwmodel.stall_cost
        b, bw = np.array([8e9]), np.array([8.0])
        out = [
            sc(b, bw, link_bytes=np.array([8e9]),
               link_bw_gbps=np.array([0.8]), link_latency_s=np.array([0.5])),
            sc(b, bw, link_bytes=np.array([8e9]),
               link_bw_gbps=np.array([800.0]),
               link_latency_s=np.array([0.0])),
            sc(b, bw, link_bytes=np.array([0.0]),
               link_bw_gbps=np.array([0.8]), link_latency_s=np.array([9.9])),
            sc(b, bw, tier_bytes=8e9, tier_bw_gbps=0.4,
               link_bytes=np.array([8e9]), link_bw_gbps=np.array([0.8]),
               link_latency_s=np.array([0.0])),
            sc(np.zeros(0), np.zeros(0), link_bytes=np.array([1e9]),
               link_bw_gbps=np.array([1.0]),
               link_latency_s=np.array([0.25])),
        ]
        assert out == pytest.approx([10.5, 1.0, 1.0, 20.0, 1.25])
        return out
    _both(case)


# ---------------------------------------------------------------------------
# interconnect: Eq.-5 striping, virtual clock, calibration
# ---------------------------------------------------------------------------

def test_interconnect_weights_follow_bandwidth():
    def case(pkg):
        ic = _wire(pkg, ("a", 0.3), ("b", 0.1))
        w = ic.weights()
        assert w == pytest.approx([0.75, 0.25])
        per = ic.stripe(1000)
        assert per.sum() == 1000
        assert per[0] == pytest.approx(750, abs=1)
        return w, per
    _both(case)


def test_interconnect_price_is_slowest_stripe():
    def case(pkg):
        ic = _wire(pkg, ("a", 0.3, 1e-3), ("b", 0.1, 4e-3))
        n = 300_000
        per = ic.stripe(n)
        want = max(per[0] / 0.3e9 + 1e-3, per[1] / 0.1e9 + 4e-3)
        assert ic.transfer_seconds(n) == pytest.approx(want)
        uniform = pkg.bwmodel.stall_cost(
            np.zeros(0), np.zeros(0), link_bytes=np.array([n / 2, n / 2]),
            link_bw_gbps=np.array([0.3, 0.1]),
            link_latency_s=np.array([1e-3, 4e-3]))
        assert ic.transfer_seconds(n) < uniform
        return ic.transfer_seconds(n), uniform
    _both(case)


def test_interconnect_virtual_clock_serializes_sends():
    def case(pkg):
        ic = _wire(pkg, ("a", 0.1))
        s0, d0 = ic.send(100_000, now=0.0)
        s1, d1 = ic.send(100_000, now=0.0)
        assert s0 == 0.0 and s1 == pytest.approx(d0)
        assert ic.busy_until == pytest.approx(d0 + d1)
        assert ic.queue_delay(0.0) == pytest.approx(d0 + d1)
        assert ic.saturated(0.0, horizon_s=d0) \
            and not ic.saturated(d0 + d1, horizon_s=0.0)
        return ic.stats()
    _both(case)


def test_interconnect_calibration_moves_effective_bw():
    def case(pkg):
        ic = _wire(pkg, ("a", 0.1))
        predicted = ic.transfer_seconds(1_000_000)
        ic.calibrate(1_000_000, measured_s=predicted * 2)  # wire is slower
        assert ic.bw_effective[0] < 0.1
        slow = ic.transfer_seconds(1_000_000)
        assert slow > predicted
        ic.calibrate(1_000_000, measured_s=slow / 4)       # now faster
        assert ic.transfer_seconds(1_000_000) < slow
        assert ic.calibration_samples == 2
        return ic.stats()
    _both(case)


# ---------------------------------------------------------------------------
# page channel: wire round-trip, events, drift billing
# ---------------------------------------------------------------------------

def test_channel_roundtrip_same_geometry():
    def case(pkg):
        pool_a, view_a, _, _ = _host(pkg)
        pool_b, view_b, _, _ = _host(pkg)
        toks = list(range(100, 112))
        pages = _chain(pkg, view_a, pool_a, toks, val=7)
        orig = pkg.kv(pool_a, pages)
        events = []
        for ev in ("link_send", "link_recv"):
            for v in (view_a, view_b):
                v.fabric.subscribe(ev, lambda event=ev, **kw:
                                   events.append((event, kw)))
        ch = pkg.cluster.PageChannel(_wire(pkg), chunk_bytes=4096)
        parcel = ch.send(view_a, pages, now=0.0, tokens=toks,
                         ntokens=len(toks))
        assert parcel.chunks == -(-len(parcel.data) // 4096) \
            and parcel.chunks > 1
        assert parcel.arrive_s > 0.0
        new_ids, parcel2, secs = ch.recv(view_b)
        assert parcel2 is parcel and secs > 0.0
        assert ch.converted_imports == 0
        assert _eq(pkg.kv(pool_b, new_ids), orig)
        got = []
        n = view_b.probe_prefix(toks, got, count=False)
        assert n == len(toks) and got == new_ids
        view_b.release(got)
        assert [e for e, _ in events] == ["link_send", "link_recv"]
        assert events[0][1]["bytes"] == len(parcel.data)
        assert events[0][1]["chunks"] == parcel.chunks
        assert events[1][1]["pages"] == len(new_ids)
        view_b.release(new_ids)
        view_a.fabric.check_invariants()
        view_b.fabric.check_invariants()
        return parcel.data, parcel.arrive_s, new_ids, secs, events, \
            ch.stats()
    _both(case)


def test_channel_observatory_counters_and_drift_billing():
    def case(pkg):
        pool_a, view_a, _, obs_a = _host(pkg, obs=True)
        pool_b, view_b, _, obs_b = _host(pkg, obs=True)
        pages = _chain(pkg, view_a, pool_a, list(range(8)), val=3)
        ic = _wire(pkg, ("a", 0.1))

        def probe(kind, nbytes):
            assert kind == "link_transfer"
            return ic.transfer_seconds(nbytes) * 2.0

        ch = pkg.cluster.PageChannel(ic, chunk_bytes=1 << 14, probe=probe)
        parcel = ch.send(view_a, pages, now=0.0, tokens=list(range(8)),
                         ntokens=8)
        new_ids, _, _ = ch.recv(view_b)
        m = obs_a.metrics
        sent = m.get("repro_link_bytes_total").value(view_a.name, "send")
        assert sent == len(parcel.data)
        assert m.get("repro_link_chunks_total").value(
            view_a.name) == parcel.chunks
        assert obs_b.metrics.get("repro_link_bytes_total").value(
            view_b.name, "recv") == len(parcel.data)
        assert len(obs_a.drift.ratio["link_transfer"]) == 1
        assert obs_a.drift.ratio["link_transfer"].last() \
            == pytest.approx(2.0)
        assert ic.calibration_samples == 1 and ic.bw_effective[0] < 0.1
        view_b.release(new_ids)
        return parcel.data, sent, ic.stats()
    _both(case)


def test_channel_convert_on_import_is_token_exact():
    def case(pkg):
        pool_a, view_a, _, _ = _host(pkg, page_size=4)
        pool_b, view_b, _, _ = _host(pkg, page_size=8)
        toks = list(range(200, 214))             # 14 tokens: partial tail
        pages = []
        for _ in range(4):                       # 4 src pages hold 14 valid
            view_a.append_page(pages)
        shape = pkg.page_shape(pool_a, pages)
        rng = np.random.default_rng(0)
        pkg.set(pool_a, pages, rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32))
        kb, vb = pkg.kv(pool_a, pages)
        view_a.register_prefix(toks[:12], pages[:3], 12)
        ch = pkg.cluster.PageChannel(_wire(pkg), chunk_bytes=1 << 15)
        parcel = ch.send(view_a, pages, now=0.0, tokens=toks, ntokens=14)
        new_ids, _, _ = ch.recv(view_b)
        assert ch.converted_imports == 1
        assert len(new_ids) == 2                 # ceil(14 / 8)

        def tokview(a, npages, ps):              # [L, P, ps, ...] -> tokens
            return a.reshape(a.shape[0], npages * ps, *a.shape[3:])

        got_k, got_v = pkg.kv(pool_b, new_ids)
        assert np.array_equal(tokview(got_k, 2, 8)[:, :14],
                              tokview(kb, 4, 4)[:, :14])
        assert np.array_equal(tokview(got_v, 2, 8)[:, :14],
                              tokview(vb, 4, 4)[:, :14])
        got = []
        n = view_b.probe_prefix(toks, got, count=False)
        assert n == 8 and got == new_ids[:1]
        view_b.release(got)
        view_b.release(new_ids)
        view_a.fabric.check_invariants()
        view_b.fabric.check_invariants()
        return parcel.data, new_ids, got_k, got_v
    _both(case)


# ---------------------------------------------------------------------------
# convert_range unit behaviour
# ---------------------------------------------------------------------------

def test_convert_layout_only_mismatch_restamps():
    def case(pkg):
        pool, view, tier, _ = _host(pkg)
        pages = _chain(pkg, view, pool, list(range(8)))
        blob = pkg.persist.deserialize_range(pkg.persist.serialize_range(
            tier.export_range(view, pages, tokens=list(range(8)),
                              ntokens=8)))
        other = pkg.persist.kv_layout_metadata(pool.cfg, pool.page_size,
                                               None)
        other = dict(other, mesh_axes={"data": 8, "model": 1})
        out = pkg.cluster.convert_range(
            blob, geometry=tier._geometry(pool), layout=other)
        assert out["layout"] == other
        assert out["k"] is blob["k"]             # bytes untouched
        assert "converted" not in out
        return pkg.persist.serialize_range(out)
    _both(case)


def test_convert_raises_on_per_token_mismatch():
    def case(pkg):
        pool, view, tier, _ = _host(pkg)
        pages = _chain(pkg, view, pool, list(range(8)))
        blob = tier.export_range(view, pages, tokens=list(range(8)),
                                 ntokens=8)
        errs = []
        bad = dict(tier._geometry(pool))
        bad["num_layers"] = bad["num_layers"] + 1
        with pytest.raises(ValueError, match="recompute, not a re-layout") \
                as e:
            pkg.cluster.convert_range(blob, geometry=bad,
                                      layout=blob["layout"])
        errs.append(str(e.value))
        bad = dict(tier._geometry(pool), page_size=8)
        bad["k_block"] = [8, 99, 99]
        with pytest.raises(ValueError, match="k_block tail") as e:
            pkg.cluster.convert_range(blob, geometry=bad,
                                      layout=blob["layout"])
        errs.append(str(e.value))
        return errs
    _both(case)


# ---------------------------------------------------------------------------
# the router: token identity, overlap, fallback
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    pair = smoke_pair()
    return {p.port: pair[p.port][1] for p in BOTH}


def _engine(pkg, pool, params, *, max_batch=8):
    if pkg.port:
        from repro_torch.scheduler import RequestScheduler
        from repro_torch.serve.engine import ServeEngine
        kw = {"device": "cpu"}
    else:
        from repro.scheduler import RequestScheduler
        from repro.serve.engine import ServeEngine
        kw = {}
    sched = RequestScheduler(pool, max_batch=max_batch,
                             prefill_token_budget=32, default_max_new=8)
    return ServeEngine(pkg.cfg(CHAT), params[pkg.port], pool,
                       scheduler=sched, wall_clock=False, sim_step_s=0.005,
                       **kw)


def _oracle(pkg, params, prompts, max_new):
    pool, _, _, _ = _host(pkg, page_size=8, pages=128)
    eng = _engine(pkg, pool, params)
    for p in prompts:
        eng.submit(list(p), max_new=max_new)
    steps = 0
    while (eng.active or eng.waiting) and steps < 2000:
        eng.step()
        steps += 1
    return [list(s.tokens) for s in sorted(eng.finished,
                                           key=lambda s: s.sid)]


def test_router_disagg_token_identity(params):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, CHAT.vocab_size, n).tolist()
               for n in (12, 17, 9, 20)]

    def case(pkg):
        oracle = _oracle(pkg, params, prompts, max_new=6)
        pool_p, view_p, _, _ = _host(pkg, page_size=4, pages=128)
        pool_d, view_d, _, _ = _host(pkg, page_size=8, pages=128)
        ch = pkg.cluster.PageChannel(_wire(pkg), chunk_bytes=8192)
        router = pkg.cluster.ClusterRouter(
            _engine(pkg, pool_p, params), _engine(pkg, pool_d, params), ch,
            saturation_horizon_s=10.0)
        rids = [router.submit(list(p), max_new=6) for p in prompts]
        router.drain()
        results = [router.result(r) for r in rids]
        assert results == oracle
        assert router.handoffs == len(prompts) and router.fallbacks == 0
        assert ch.converted_imports == len(prompts)  # ps 4 -> 8 each time
        s = router.summary()
        assert s["tokens"] == 6 * len(prompts)    # head token counted once
        assert s["ttft_mean_s"] > 0 and s["ttft_weighted_goodput"] > 0
        view_p.fabric.check_invariants()
        view_d.fabric.check_invariants()
        return results, s
    _both(case)


def test_router_saturated_wire_falls_back_to_single_host(params):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, CHAT.vocab_size, 10).tolist()
               for _ in range(3)]

    def case(pkg):
        oracle = _oracle(pkg, params, prompts, max_new=5)
        pool_p, _, _, _ = _host(pkg, page_size=4, pages=128)
        pool_d, _, _, _ = _host(pkg, page_size=8, pages=128)
        ic = _wire(pkg, ("thin", 1e-6))          # ~nothing gets through
        ic.send(10_000_000, now=0.0)             # pre-existing backlog
        router = pkg.cluster.ClusterRouter(
            _engine(pkg, pool_p, params), _engine(pkg, pool_d, params),
            pkg.cluster.PageChannel(ic), saturation_horizon_s=0.01)
        rids = [router.submit(list(p), max_new=5) for p in prompts]
        router.drain()
        assert router.fallbacks == len(prompts) and router.handoffs == 0
        results = [router.result(r) for r in rids]
        assert results == oracle
        return results, router.summary()
    _both(case)


def test_router_short_requests_serve_locally(params):
    def case(pkg):
        pool_p, _, _, _ = _host(pkg, page_size=4)
        pool_d, _, _, _ = _host(pkg, page_size=8)
        router = pkg.cluster.ClusterRouter(
            _engine(pkg, pool_p, params), _engine(pkg, pool_d, params),
            pkg.cluster.PageChannel(_wire(pkg)), saturation_horizon_s=10.0)
        rid = router.submit([3, 17, 29, 5], max_new=1)   # nothing to hand off
        router.drain()
        assert router.fallbacks == 1 and router.handoffs == 0
        assert len(router.result(rid)) == 5
        return router.result(rid), router.summary()
    _both(case)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_cuda_channel_convert_on_import_bf16(cuda):
    """A bf16 range on the card crosses the channel from page 4 to page 8
    on the card, token for token, and its wire bytes equal the reference's
    for the same bytes."""
    from _torch_parity import Pkg

    cfg = dataclasses.replace(CHAT, compute_dtype="bfloat16")
    toks = list(range(300, 314))
    data = {}
    for pkg in (BOTH[0], Pkg(True, device=cuda)):
        def pool(ps):
            p = pkg.pool(cfg, [("hbm_local", 48, 819.0, True),
                               ("host_dram", 48, 0.016, False)], ps)
            view = pkg.as_view(p)
            view.fabric.attach_persist(pkg.tier(bw_gbps=8.0))
            return p, view
        pool_a, view_a = pool(4)
        pool_b, view_b = pool(8)
        pages = []
        for _ in range(4):
            view_a.append_page(pages)
        shape = pkg.page_shape(pool_a, pages)
        rng = np.random.default_rng(4)
        pkg.set(pool_a, pages, rng.standard_normal(shape).astype(np.float32))
        kb, vb = pkg.kv(pool_a, pages)
        ch = pkg.cluster.PageChannel(_wire(pkg), chunk_bytes=1 << 15)
        data[pkg.port] = ch.send(view_a, pages, now=0.0, tokens=toks,
                                 ntokens=14).data
        new_ids, _, _ = ch.recv(view_b)
        assert ch.converted_imports == 1 and len(new_ids) == 2
        got_k, got_v = pkg.kv(pool_b, new_ids)
        flat = lambda a, n, ps: a.reshape(a.shape[0], n * ps,  # noqa: E731
                                          *a.shape[3:])[:, :14]
        assert np.array_equal(flat(got_k, 2, 8), flat(kb, 4, 4))
        assert np.array_equal(flat(got_v, 2, 8), flat(vb, 4, 4))
    assert data[True] == data[False]
