"""The port's fabric observatory (``src/repro_torch/obs/``: ``SpanTracer``,
``PageHeat``, ``DriftLedger``, ``Observatory``) against the reference's
(``src/repro/obs/``) on the same call sequences, the event-payload contract
over the port's ``emit`` call sites, and ``calibration_loop`` (``benchmarks/obs_bench.py`` against
``benchmarks/torch_obs_bench.py``) in both decode modes against the
reference's live run and ``BENCH_obs.json``. The traced serving run is
in ``test_torch_obs_trace.py``."""

import ast
import json
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

import repro.obs as r_obs_pkg  # noqa: E402
import repro.obs.drift as r_drift  # noqa: E402
import repro.obs.heat as r_heat  # noqa: E402
import repro.obs.observatory as r_observatory  # noqa: E402
import repro.obs.trace as r_trace  # noqa: E402
import repro.placement.fabric as r_fabric  # noqa: E402
import repro.placement.pool as r_pool  # noqa: E402
import repro_torch.obs as t_obs_pkg  # noqa: E402
import repro_torch.obs.drift as t_drift  # noqa: E402
import repro_torch.obs.heat as t_heat  # noqa: E402
import repro_torch.obs.observatory as t_observatory  # noqa: E402
import repro_torch.obs.trace as t_trace  # noqa: E402
import repro_torch.placement.fabric as t_fabric  # noqa: E402
import repro_torch.placement.pool as t_pool  # noqa: E402
from _torch_parity import engines_of, smoke_pair, tokens_of  # noqa: E402
from benchmarks import obs_bench as r_bench  # noqa: E402
from benchmarks import torch_obs_bench as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF = types.SimpleNamespace(pool=r_pool, fabric=r_fabric, heat=r_heat,
                            drift=r_drift, obs=r_observatory, trace=r_trace,
                            port=False)
PORT = types.SimpleNamespace(pool=t_pool, fabric=t_fabric, heat=t_heat,
                             drift=t_drift, obs=t_observatory, trace=t_trace,
                             port=True)


@pytest.fixture(scope="module")
def smoke():
    return smoke_pair()


def _both(fn):
    return fn(REF), fn(PORT)


def _fabric(pkg, smoke):
    """``test_obs._fabric``: one fast and one slow domain, page size 4."""
    m = pkg.pool
    return pkg.fabric.MemoryFabric(smoke[pkg.port][0], [
        m.MemoryDomain("fast", 8, 819.0, True),
        m.MemoryDomain("slow", 16, 0.016, False),
    ], page_size=4, policy="bwap_dwp",
        **({"device": "cpu"} if pkg.port else {}))


def test_lazy_package_exports_match_the_reference():
    assert t_obs_pkg.__all__ == r_obs_pkg.__all__
    for name in ("SpanTracer", "DriftLedger", "PageHeat", "Observatory"):
        cls = getattr(t_obs_pkg, name)
        assert cls.__module__.startswith("repro_torch.obs.")
        assert cls.__name__ == getattr(r_obs_pkg, name).__name__
    with pytest.raises(AttributeError):
        t_obs_pkg.NoSuchThing


# -- span tracer ----------------------------------------------------------------

def test_span_tracer_events_equal_the_reference(tmp_path):
    def run(pkg):
        tr = pkg.trace.SpanTracer()
        tr.on_admit("A", 0, 0.5, "hi")
        tr.on_prefill("A", 0, 0.75, 0.25, 0, 8)
        tr.on_admit("B", 3, 0.1, "lo")
        tr.on_decode("B", 3, 0.2, 0.01, 1)
        tr.on_decode("A", 0, 1.0, 0.01, 1)
        tr.on_swap_out("A", 0, 1.1, 0.05, 4)
        tr.on_swap_in("A", 0, 1.3, 0.02)
        tr.on_fabric("rehome", "A", 1.4, dur_s=0.003, args={"pages": 2})
        tr.on_fabric("demote", "", 1.5, args={"pages": 1})
        tr.on_finish("A", 0, 1.6, 2)
        path = tr.export(tmp_path / f"{pkg.port}.json")
        spans = [tr.spans(n, sid=s) for n in (None, "decode", "queued")
                 for s in (None, 0, 3)]
        return tr.to_dict(), json.loads(path.read_text()), spans
    ref, port = _both(run)
    assert port == ref
    assert port[1]["displayTimeUnit"] == "ms"


# -- page heat -----------------------------------------------------------------

def test_page_heat_values_and_snapshot_equal_the_reference(smoke):
    def run(pkg):
        fab = _fabric(pkg, smoke)
        heat = pkg.heat.PageHeat(fab.pool, decay=0.5)
        heat.touch([0, 1])
        out = [heat.value(0)]
        heat.step()
        out.append(heat.value(0))            # lazy decay on read
        heat.touch([0])
        heat.touch([9, -3, 20], weights=[0.25, 1.0, 2.0])
        heat.step()
        heat.step()
        out.append([heat.value(p) for p in (0, 1, 9, 20, -3)])
        heat.on_free(page=1)
        return (out, heat.live_pages(), heat.hottest(5), heat.per_domain(),
                heat.snapshot())
    ref, port = _both(run)
    assert port == ref
    assert port[0][:2] == [1.0, 0.5] and port[1] == 3


# -- drift ledger ----------------------------------------------------------------

def test_drift_vector_observation_converges_like_the_reference(smoke):
    def run(pkg):
        fab = _fabric(pkg, smoke)
        bw_true = np.array([819.0, 0.032])
        led = pkg.drift.DriftLedger(fab, calibrate_every=1)
        pb = float(fab.pool.page_bytes)
        bpd = np.array([4 * pb, 8 * pb])
        for _ in range(40):
            measured = bpd / (bw_true * 1e9)
            predicted = float((bpd / (fab.bw_effective * 1e9)).max())
            led.observe("batch_read", bpd, predicted, measured)
        return led.summary(), list(fab.bw_effective)
    ref, port = _both(run)
    assert port == ref
    s, bw = port
    assert abs(bw[1] - 0.032) / 0.032 < 0.01
    assert s["calibrations"] == 40 and s["domain_drift"][1] < 1.0


def test_drift_scalar_attribution_and_flush_like_the_reference(smoke):
    def run(pkg):
        fab = _fabric(pkg, smoke)
        led = pkg.drift.DriftLedger(fab, calibrate_every=100)
        before = fab.calibration_samples
        flushed = led.flush()                 # nothing staged: a no-op
        pb = float(fab.pool.page_bytes)
        led.observe("swap_transfer", np.array([pb, 4 * pb]), 0.001, 0.002)
        led.observe_scalar("tier_copy", 0.5, 1.0)
        return (flushed, fab.calibration_samples == before,
                list(led.domain_samples), led.ratio["swap_transfer"].last(),
                led.ratio["tier_copy"].last(), led.summary())
    ref, port = _both(run)
    assert port == ref
    assert port[:5] == (False, True, [0, 1], 2.0, 2.0)


# -- observatory -------------------------------------------------------------------

def test_observatory_bus_counts_and_snapshot_equal_the_reference(smoke):
    def run(pkg):
        fab = _fabric(pkg, smoke)
        obs = pkg.obs.Observatory(fab, drift=False)
        view = fab.view("A", quota=[8, 16], home=(0,))
        pages = []
        for _ in range(2):
            view.append_page(pages)
        obs.heat.touch(pages)
        live = obs.heat.live_pages()
        view.release(pages)                  # free events purge heat
        ev = obs.metrics.get("repro_fabric_events_total")
        with pytest.raises(AssertionError):
            fab.attach_obs(obs)              # one observatory per fabric
        return (live, obs.heat.live_pages(), ev.value("alloc"),
                ev.value("free"), obs.snapshot(),
                obs.metrics.prometheus_text())
    ref, port = _both(run)
    assert port == ref
    assert port[:4] == (2, 0, 2, 2)


def test_observatory_engine_hooks_equal_the_reference(smoke):
    """``on_engine_step`` (global and per launch, with a probe),
    ``on_rehome`` and ``observe_transfer`` on the same inputs."""
    def run(pkg):
        fab = _fabric(pkg, smoke)
        bw = np.array([819.0, 0.008])
        obs = pkg.obs.Observatory(
            fab, probe=lambda kind, bpd: np.asarray(bpd) / (bw * 1e9),
            calibrate_every=2)
        view = fab.view("A", quota=[8, 16], home=(0,))
        pages = []
        for _ in range(10):
            view.append_page(pages)
        seqs = [types.SimpleNamespace(sid=i, produced=i + 1)
                for i in range(3)]
        plan = types.SimpleNamespace(prefill_chunks=[(seqs[2], 0, 8)])
        obs.on_engine_step(view, plan, seqs[:2], pages[:6], 0.01, 0.0,
                           0.02, read_weights={pages[5]: 0.5})
        launches = [(0, pages[:4], 1e-6), (1, pages[8:], 2e-3)]
        obs.on_engine_step(view, plan, seqs, pages, 0.02, 0.02, 0.03,
                           launches=launches)
        obs.on_rehome(view, 0.05, 0.001, 2)
        obs.observe_transfer(view.footprint(pages[8:]), 1e-3)
        obs.observe_transfer(np.zeros(2), 1e-3)
        return (obs.snapshot(), obs.tracer.to_dict(),
                obs.metrics.prometheus_text())
    ref, port = _both(run)
    assert port == ref
    assert port[0]["drift"]["observations"] == 4


# -- event-payload contracts ---------------------------------------------------------

PORT_SRC = ROOT / "src" / "repro_torch"


def _emit_calls(path: Path):
    """Every ``*.emit("<event>", ...)`` call site in one source file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "emit"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            yield path.relative_to(ROOT), node


def test_every_emit_call_site_carries_the_contract_fields():
    sites = [c for f in sorted(PORT_SRC.rglob("*.py"))
             for c in _emit_calls(f)]
    ref_sites = list(_emit_calls(ROOT / "src" / "repro" / "placement"
                                 / "fabric.py"))
    assert len(sites) >= len(ref_sites) >= 8, "emit call sites went missing"
    for fname, call in sites:
        event = call.args[0].value
        assert event in t_fabric.EVENT_FIELDS, \
            f"{fname}:{call.lineno}: undocumented event {event!r}"
        kws = {k.arg for k in call.keywords if k.arg is not None}
        missing = set(t_fabric.EVENT_FIELDS[event]) - kws
        assert not missing, (f"{fname}:{call.lineno}: emit({event!r}) "
                             f"missing contract fields {sorted(missing)}")
        if event == "share":
            kind = next(k.value.value for k in call.keywords
                        if k.arg == "kind")
            assert kind in t_fabric.SHARE_KIND_FIELDS, \
                f"{fname}:{call.lineno}: undocumented share kind {kind!r}"
            assert not set(t_fabric.SHARE_KIND_FIELDS[kind]) - kws
    assert set(t_fabric.EVENT_FIELDS) == set(t_fabric.EVENTS)
    assert t_fabric.EVENT_FIELDS == r_fabric.EVENT_FIELDS
    assert t_fabric.SHARE_KIND_FIELDS == r_fabric.SHARE_KIND_FIELDS


# -- calibration_loop on both packages ---------------------------------------------------

@pytest.mark.parametrize("micro_batch", [False, True],
                         ids=["global", "micro_batch"])
def test_calibration_loop_equals_the_reference_and_bench_obs_json(
        smoke, micro_batch):
    with engines_of(r_bench) as r_engines:
        ref = r_bench.calibration_loop(micro_batch=micro_batch)
    with engines_of(t_bench) as t_engines:
        port = t_bench.calibration_loop(micro_batch=micro_batch,
                                        params=smoke[True][1], device="cpu")
    assert tokens_of(t_engines) == tokens_of(r_engines)
    assert port == ref
    bench = json.loads((ROOT / "BENCH_obs.json").read_text())
    want = bench["calibration_micro" if micro_batch else "calibration"]
    for k in ("calibrations", "observations", "finished", "domain_samples",
              "gated_domains", "multi_launch_steps"):
        assert port[k] == want[k], k
    assert (port["calibrations"], port["observations"]) == (
        (39, 78) if micro_batch else (23, 47))
    assert max(port["rel_err_after"]) <= port["tolerance"]


def test_obs_bench_constants_match_the_reference():
    assert (t_bench.CAL_TOL, t_bench.OVERHEAD_TOL, t_bench.MIN_SAMPLES,
            t_bench.BW_PROFILE, t_bench.BW_TRUE) == (
        r_bench.CAL_TOL, r_bench.OVERHEAD_TOL, r_bench.MIN_SAMPLES,
        r_bench.BW_PROFILE, r_bench.BW_TRUE)
