"""The cases of the reference's ``tests/test_obs.py`` that no other port
test holds, on both packages through ``_torch_parity.both`` (the port's
record must equal the reference's): ``Ring.quantile``; the metrics
registry's counters, gauges, labels, histograms and Prometheus text; the
telemetry's mirror into the registry and its SLO counters; the fabric
bus's isolation of a raising subscriber and its live event contract; the
traced serving scenario of ``test_obs.py``'s ``traced_runs`` (a poisson
trace of 5 requests in two classes over a pool with 90 % of its slow
domains reserved for swap, so a request is preempted), run on both
packages with and without an observatory; and the benchmark artifact
check (``benchmarks/artifacts.py`` against
``benchmarks/torch_artifacts.py``)."""

import json

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

import repro.obs.metrics as r_metrics  # noqa: E402
import repro_torch.obs.metrics as t_metrics  # noqa: E402
from _torch_parity import BOTH, both, smoke_pair  # noqa: E402
from benchmarks import artifacts, torch_artifacts  # noqa: E402


def _metrics(pkg):
    return t_metrics if pkg.port else r_metrics


@pytest.fixture(scope="module")
def smoke():
    return smoke_pair()


# -- Ring.quantile -------------------------------------------------------------

def test_ring_quantile_matches_numpy():
    vals = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0]

    def case(pkg):
        r = pkg.telemetry.Ring(capacity=64)
        for v in vals:
            r.push(v)
        return [r.quantile(q) for q in (0.0, 0.5, 0.95, 1.0)]
    got = both(case)
    assert got == pytest.approx([np.quantile(vals, q)
                                 for q in (0.0, 0.5, 0.95, 1.0)])


def test_ring_quantile_empty_and_wrapped():
    def case(pkg):
        r = pkg.telemetry.Ring(capacity=4)
        empty = r.quantile(0.5)
        for v in range(10):          # wraps: the window is the last 4
            r.push(float(v))
        return empty, r.quantile(0.5), r.quantile(1.0), list(r.values())
    empty, p50, top, window = both(case)
    assert empty == 0.0 and top == 9.0 and window == [6.0, 7.0, 8.0, 9.0]
    assert p50 == pytest.approx(np.quantile([6, 7, 8, 9], 0.5))


# -- the metrics registry --------------------------------------------------------

def test_counter_gauge_labels_and_snapshot():
    def case(pkg):
        m = _metrics(pkg).MetricsRegistry()
        c = m.counter("reqs_total", "Requests.", ("view", "cls"))
        c.labels("A", "hi").inc()
        c.labels("A", "hi").inc(2)
        c.labels("B", "lo").inc(5)
        g = m.gauge("occupancy", "Pages.", ("tier",))
        g.labels("fast").set(7)
        g.labels("fast").set(4)
        same = m.counter("reqs_total", "Requests.", ("view", "cls")) is c
        with pytest.raises(AssertionError):
            m.counter("reqs_total", "Requests.", ("other",))
        return (c.value("A", "hi"), c.value("B", "lo"), c.value("B", "hi"),
                c.total(), g.value("fast"), same, m.snapshot())
    a_hi, b_lo, b_hi, total, fast, same, snap = both(case)
    assert (a_hi, b_lo, b_hi, total, fast, same) == (3, 5, 0, 8, 4, True)
    assert snap["reqs_total"]["type"] == "counter"
    assert {"labels": {"view": "A", "cls": "hi"}, "value": 3.0} \
        in snap["reqs_total"]["series"]


def test_histogram_buckets_and_quantile():
    qs = (0.0, 0.25, 0.5, 0.9, 1.0)

    def case(pkg):
        mod = _metrics(pkg)
        h = mod.MetricsRegistry().histogram("lat", "Latency.",
                                            buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.5, 0.5, 5.0, 50.0):
            h.observe(v)
        child = h.labels()
        return (child.count, child.sum, [int(n) for n in child.counts],
                [child.quantile(q) for q in qs], tuple(mod.DEFAULT_BUCKETS))
    count, total, counts, quant, buckets = both(case)
    assert count == 5 and total == pytest.approx(56.05)
    assert counts == [1, 2, 1, 1]            # the last is the +Inf bucket
    assert 0.1 <= quant[2] <= 1.0 and quant[4] == 10.0
    assert all(b > 0 for b in buckets)


def test_prometheus_text_format():
    def case(pkg):
        m = _metrics(pkg).MetricsRegistry()
        m.counter("a_total", 'Help with "quotes".', ("dom",)).labels(
            'x"y\\z').inc(2)
        m.histogram("h_seconds", "H.", buckets=(1.0, 2.0)).observe(1.5)
        return m.prometheus_text()
    text = both(case)                       # byte-equal
    assert "# HELP a_total" in text and "# TYPE a_total counter" in text
    assert r'a_total{dom="x\"y\\z"} 2' in text
    for line in ('h_seconds_bucket{le="1"} 0', 'h_seconds_bucket{le="2"} 1',
                 'h_seconds_bucket{le="+Inf"} 1', "h_seconds_sum 1.5",
                 "h_seconds_count 1"):
        assert line in text, line


# -- telemetry on the registry ---------------------------------------------------

def test_telemetry_mirrors_registry():
    def case(pkg):
        tel = pkg.telemetry.DomainTelemetry(["fast", "slow"])
        tel.record_alloc(0, 3)
        tel.record_free(1, 2)
        tel.record_migration(0, 1, 4, 4096)
        tel.record_swap("out", 5, 0.25)
        tel.record_latency(0.02)
        tel.record_stall(1, 0.004)
        tel.record_tier("demote", 6, 0.5)
        tel.record_tier_occupancy("fast_domains", 10, 20)
        m = tel.metrics
        values = (m.get("repro_pages_allocated_total").value("fast"),
                  m.get("repro_pages_freed_total").value("slow"),
                  m.get("repro_migrated_pages_total").value("fast", "out"),
                  m.get("repro_migrated_bytes_total").value("slow", "in"),
                  m.get("repro_executed_moves_total").total(),
                  m.get("repro_swap_pages_total").value("out"),
                  m.get("repro_swap_seconds_total").total(),
                  m.get("repro_tier_pages_total").value("demote"),
                  m.get("repro_tier_occupancy_pages").value("fast_domains",
                                                            "used"))
        return values, tel.snapshot(), tel.prometheus_text()
    values, snap, text = both(case)
    assert values[:6] == (3, 2, 4, 4096, 4, 5) and values[7:] == (6, 10)
    assert values[6] == pytest.approx(0.25)
    assert snap["domains"]["fast"]["allocs"] == 3
    assert snap["swap_outs"] == 5 and snap["executed_moves"] == 4
    assert snap["latency_p50_s"] == pytest.approx(0.02)
    assert snap["domains"]["slow"]["stall_p95_s"] == pytest.approx(0.004)
    assert snap["subscriber_errors"] == 0
    assert 'repro_pages_allocated_total{domain="fast"} 3' in text


def test_slo_counters_back_the_registry():
    def case(pkg):
        tel = pkg.telemetry.DomainTelemetry(["d0"])
        slo = tel.attach_slo()
        slo.add("interactive", "submitted")
        slo.add("interactive", "goodput_tokens", 12)
        fam = tel.metrics.get("repro_slo_events_total")
        return (type(slo).__name__, fam.value("interactive", "submitted"),
                fam.value("interactive", "goodput_tokens"), slo.snapshot(),
                tel.prometheus_text())
    kind, submitted, goodput, snap, _ = both(case)
    assert kind == "ClassSloCounters"
    assert (submitted, goodput) == (1, 12)
    assert snap["interactive"]["goodput_tokens"] == 12


# -- the fabric bus --------------------------------------------------------------

def _fabric(pkg, smoke):
    """``test_obs._fabric``: one fast and one slow domain, page size 4."""
    return pkg.fabric(smoke[False][0], [("fast", 8, 819.0, True),
                                        ("slow", 16, 0.016, False)],
                      page_size=4, policy="bwap_dwp")


def test_emit_isolates_raising_subscriber(smoke):
    def case(pkg):
        fab = _fabric(pkg, smoke)
        view = fab.view("A", quota=[8, 16], home=(0,))
        seen = []

        def boom(**kw):
            raise RuntimeError("broken observer")

        fab.subscribe("alloc", boom)
        fab.subscribe("alloc", lambda **kw: seen.append(sorted(kw)))
        pages = []
        view.append_page(pages)      # must not raise through the hot path
        errors = (fab.telemetry.subscriber_errors,
                  fab.telemetry.metrics.get(
                      "repro_subscriber_errors_total").value("alloc"))
        view.release(pages)
        fab.check_invariants()
        return seen, errors, fab.telemetry.snapshot()["subscriber_errors"]
    seen, errors, snap_errors = both(case)
    assert len(seen) == 1                    # later subscribers still ran
    assert errors == (1, 1) and snap_errors == 1


def test_live_events_honor_the_contract(smoke):
    def case(pkg):
        fm = pkg.fabric_mod
        fab = _fabric(pkg, smoke)
        violations, seen = [], []

        def validator(event):
            def check(**kw):
                need = set(fm.EVENT_FIELDS[event])
                if event == "share":
                    need |= set(fm.SHARE_KIND_FIELDS[kw["kind"]])
                seen.append((event, sorted(kw)))
                if not need <= set(kw):
                    violations.append((event, sorted(need - set(kw))))
            return check

        for ev in fm.EVENTS:
            fab.subscribe(ev, validator(ev))
        a = fab.view("A", quota=[8, 16], home=(0,), level=1)
        b = fab.view("B", quota=[0, 0], home=(1,))
        pages = []
        for _ in range(3):
            a.append_page(pages)                   # alloc
        a.register_prefix([1, 2, 3, 4, 5, 6, 7, 8], pages[:2], 8)
        got = []
        b.probe_prefix([1, 2, 3, 4, 5, 6, 7, 8], got)   # share kind=prefix
        a.migrate(pages)                           # migrate
        a.record_latency(0.01)                     # latency
        b.release(got)
        a.release(pages)                           # free
        return violations, seen, fab.telemetry.subscriber_errors
    violations, seen, errors = both(case)
    assert not violations, violations
    assert errors == 0, "a contract validator raised instead of recording"
    assert {"alloc", "share", "latency", "free"} <= {e for e, _ in seen}


# -- the traced serving scenario (test_obs.py's traced_runs) ---------------------

DOMAINS = (("hbm_local", 8, 819.0, True), ("hbm_peer", 8, 0.05, False),
           ("host", 40, 0.016, False))


def _trace(pkg, cfg):
    s = pkg.sched
    return s.generate(s.WorkloadSpec(
        kind="poisson", num_requests=5, mean_interarrival_s=0.005,
        prompt_mean=10, prompt_max=20, max_new=6,
        vocab_size=cfg.vocab_size,
        class_mix=(("hi", 0.4), ("lo", 0.6)), seed=0))


def _traced_run(pkg, smoke, with_obs):
    """``traced_runs``'s ``run``: tokens in sid order, the observatory,
    the pool's swap counts."""
    cfg, params = smoke[False][0], smoke[pkg.port][1]
    s = pkg.sched
    pool = pkg.pool(cfg, DOMAINS, page_size=4)
    swap = s.KVSwapManager(pool, placement="bwap_canonical",
                           reserve_fraction=0.9)
    sched = s.RequestScheduler(
        pool, max_batch=3, prefill_token_budget=16,
        classes=[s.PriorityClass("hi", 2, s.SloSpec(ttft_s=0.5,
                                                    tpot_s=0.1)),
                 s.PriorityClass("lo", 0)],
        default_class="lo", default_max_new=6, swap=swap)
    eng = pkg.engine(cfg, params, pool, scheduler=sched, wall_clock=False,
                     sim_step_s=0.01)
    obs = pkg.Observatory(pool, drift=False) if with_obs else None
    for t in _trace(pkg, cfg):
        eng.submit(t.prompt, cls=t.cls, max_new=t.max_new,
                   arrival_s=t.arrival_s)
    steps = 0
    while (eng.active or eng.waiting) and steps < 300:
        eng.step()
        steps += 1
    tokens = [tuple(int(t) for t in s.tokens)
              for s in sorted(eng.finished, key=lambda s: s.sid)]
    return tokens, obs, (pool.telemetry.swap_outs, pool.telemetry.swap_ins)


@pytest.fixture(scope="module")
def traced(smoke):
    """{port?: {with_obs?: (tokens, observatory, swaps)}}: the reference's
    engine runs once per module here, with and without the observatory,
    and so does the port's on the CPU with the reference's params."""
    return {pkg.port: {w: _traced_run(pkg, smoke, w) for w in (False, True)}
            for pkg in BOTH}


def test_the_scenarios_traces_are_equal(smoke):
    a, b = (_trace(pkg, smoke[False][0]) for pkg in BOTH)
    assert [(t.arrival_s, tuple(t.prompt), t.max_new, t.cls) for t in a] \
        == [(t.arrival_s, tuple(t.prompt), t.max_new, t.cls) for t in b]


def test_tracing_is_token_identical(traced):
    runs = [traced[p][w][0] for p in (False, True) for w in (False, True)]
    assert len(runs[0]) == 5
    assert all(r == runs[0] for r in runs[1:])


def _span_record(obs, swaps):
    tr = obs.tracer
    preempted = sorted({e["tid"] - 1 for e in tr.spans("swap_out")})
    sid = preempted[0] if preempted else None
    names = ("admit", "prefill", "decode", "swap_out", "swap_in", "finish")
    track = sorted(tr.spans(sid=sid), key=lambda e: e["ts"]) \
        if preempted else []
    return (swaps, preempted, {n: len(tr.spans(n, sid=sid)) for n in names},
            [e["dur"] for e in tr.spans("queued")],
            [e["name"] for e in track])


def test_preempted_request_has_full_span_set(traced):
    rec = {p: _span_record(*traced[p][True][1:]) for p in (False, True)}
    assert rec[True] == rec[False]
    (outs, ins), preempted, counts, queued, track = rec[True]
    assert outs > 0 and outs == ins, "the workload must preempt"
    assert preempted
    assert all(counts.values()), \
        f"preempted request {preempted[0]} misses a span: {counts}"
    assert all(d >= 0 for d in queued)
    assert track[0] == "admit" and track[-1] == "finish"


def _perfetto_loadable(data) -> None:
    """The reference case's rules for a trace Perfetto loads."""
    assert data["displayTimeUnit"] == "ms"
    evs = data["traceEvents"]
    assert evs and all("ph" in e and "pid" in e and "tid" in e for e in evs)
    names = {e["name"] for e in evs if e["ph"] == "M"}
    assert "process_name" in names and "thread_name" in names
    for e in evs:
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0


def test_trace_export_is_perfetto_loadable(traced, tmp_path):
    data = {}
    for port in (False, True):
        path = traced[port][True][1].tracer.export(
            tmp_path / f"{'port' if port else 'ref'}" / "trace.json")
        data[port] = json.loads(path.read_text())
        _perfetto_loadable(data[port])
    assert len(data[True]["traceEvents"]) == len(data[False]["traceEvents"])
    for i, (a, b) in enumerate(zip(data[True]["traceEvents"],
                                   data[False]["traceEvents"])):
        assert a == b, f"event {i}: port {a} != reference {b}"
    assert data[True] == data[False]


def test_request_lifecycle_counters(traced):
    def rec(obs):
        req = obs.metrics.get("repro_requests_total")
        lat = obs.metrics.get("repro_step_latency_seconds").labels("default")
        return (sum(req.value("admit", "default", c) for c in ("hi", "lo")),
                sum(req.value("finish", "default", c) for c in ("hi", "lo")),
                lat.count, lat.quantile(0.5), obs.metrics.prometheus_text())
    port, ref = (rec(traced[p][True][1]) for p in (True, False))
    assert port == ref
    admits, finishes, count, p50, _ = port
    assert admits == 5 and finishes == 5
    assert count > 0 and p50 > 0


# -- the benchmark artifact check --------------------------------------------------

ARTIFACT_INPUTS = {
    "missing": None,
    "unparseable": "{nope",
    "missing_key": json.dumps({"calibration": {}}),
    "non_finite": ('{"calibration": {"x": NaN}, "calibration_micro": {}, '
                   '"overhead": {}}'),
    "valid": json.dumps({"calibration": {"x": 1.0}, "calibration_micro": {},
                         "overhead": {"y": 2}}),
}
ARTIFACT_MATCH = {"missing": "missing", "unparseable": "unparseable",
                  "missing_key": "overhead", "non_finite": "non-finite",
                  "valid": None}


@pytest.mark.parametrize("case", list(ARTIFACT_INPUTS))
def test_artifacts_check_validates_schema_and_finiteness(tmp_path, case):
    """Both checks on one input, each under its own name: the same
    outcome and the same message, the port's names read as the
    reference's."""
    name = "BENCH_obs.json"
    out = {}
    for mod, n in ((artifacts, name),
                   (torch_artifacts, torch_artifacts.port_name(name))):
        if ARTIFACT_INPUTS[case] is not None:
            (tmp_path / n).write_text(ARTIFACT_INPUTS[case])
        try:
            mod.check([n], root=tmp_path)
            out[mod] = None
        except SystemExit as e:
            out[mod] = str(e)
    ref, port = out[artifacts], out[torch_artifacts]
    if ARTIFACT_MATCH[case] is None:
        assert ref is None and port is None
    else:
        assert ref is not None and ARTIFACT_MATCH[case] in ref
        assert port is not None
        assert port.replace("BENCH_torch_", "BENCH_") == ref
    assert set(torch_artifacts.EXPECTED) == set(torch_artifacts.SCHEMAS) \
        == {torch_artifacts.port_name(n) for n in artifacts.EXPECTED}
    assert set(artifacts.EXPECTED) == set(artifacts.SCHEMAS)
