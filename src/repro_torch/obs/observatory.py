"""The fabric observatory: one object wiring tracer + metrics + drift
ledger + heat map into a fabric (DESIGN.md §10).

Construction subscribes to every fabric event and registers the
observatory on the fabric (``fabric.attach_obs``), from where the
scheduler, engine, and swap manager find it via ``view.fabric.obs`` —
no plumbing through constructors, and a fabric without an observatory
pays one ``is None`` check per hook site.

    obs = Observatory(pool)                  # or a fabric, or a view
    ... run the engine ...
    obs.tracer.export("trace.json")          # load in ui.perfetto.dev
    print(obs.metrics.prometheus_text())
    obs.drift.summary()                      # Eq.-1 drift + calibration

``probe`` (optional) supplies *measured* transfer times for the drift
ledger: called as ``probe(kind, bytes_per_domain)`` with kind in
``repro_torch.obs.drift.KINDS``; return a scalar (total seconds), a per-domain
vector of seconds, or None to skip. On real NUMA hardware this is where
perf counters plug in; benchmarks use it to plant ground-truth latencies.

Port of ``repro.obs.observatory``: pure Python over the port's fabric.
"""

from __future__ import annotations

import numpy as np

from repro_torch.obs.drift import DriftLedger
from repro_torch.obs.heat import PageHeat
from repro_torch.obs.trace import SpanTracer


def _resolve_fabric(target):
    if hasattr(target, "pool") and hasattr(target, "emit"):
        return target                          # MemoryFabric
    if hasattr(target, "fabric"):
        return target.fabric                   # FabricView
    from repro_torch.placement.fabric import as_view
    return as_view(target).fabric              # bare BwapPagePool


class Observatory:
    def __init__(self, target, *, tracer: bool = True, heat: bool = True,
                 drift: bool = True, probe=None, calibrate_every: int = 4,
                 heat_decay: float = 0.9):
        self.fabric = _resolve_fabric(target)
        # model-group prefix on view labels (DESIGN.md §12): zoo member
        # fabrics carry fabric.group, so one Prometheus scrape over many
        # groups stays unambiguous; single-group fabrics ("", every fabric
        # outside a zoo) keep their labels bit-identical
        self._group = getattr(self.fabric, "group", "")
        self.metrics = self.fabric.telemetry.metrics
        self.tracer = SpanTracer() if tracer else None
        self.heat = PageHeat(self.fabric.pool, decay=heat_decay) if heat \
            else None
        self.drift = DriftLedger(self.fabric,
                                 calibrate_every=calibrate_every) \
            if drift else None
        self.probe = probe
        self._last_now: dict[str, float] = {}
        m = self.metrics
        self._events = m.counter(
            "repro_fabric_events_total",
            "Fabric bus events seen by the observatory.", ("event",))
        self._page_events = m.counter(
            "repro_page_events_total",
            "Page alloc/free events by tenant view and domain.",
            ("event", "view", "domain"))
        self._migrations = m.counter(
            "repro_obs_migrations_total",
            "Single-page migrations seen on the bus, by view.", ("view",))
        self._shares = m.counter(
            "repro_share_events_total",
            "Cross-tenant share events by kind (prefix/loan/reclaim).",
            ("kind",))
        self._tier_ops = m.counter(
            "repro_obs_tier_pages_total",
            "Pages moved by tier ops seen on the bus.", ("op", "view"))
        self._latency_hist = m.histogram(
            "repro_step_latency_seconds",
            "Per-step latency samples by tenant view.", ("view",))
        self._requests = m.counter(
            "repro_requests_total",
            "Request lifecycle transitions by view and priority class.",
            ("event", "view", "cls"))
        self._launches = m.counter(
            "repro_decode_launches_total",
            "Decode launches by view and bottleneck domain ('global' = "
            "one unpartitioned launch).", ("view", "domain"))
        self._rehomed = m.counter(
            "repro_rehomed_pages_total",
            "Hot shared pages re-homed into fast domains, by view.",
            ("view",))
        self._export_skips = m.counter(
            "repro_tier_export_skips_total",
            "Prefix-store chains dropped over the tier's byte cap, by "
            "view (evictions land in repro_obs_tier_pages_total).",
            ("view",))
        self._link_bytes = m.counter(
            "repro_link_bytes_total",
            "Cluster interconnect traffic by view and direction.",
            ("view", "direction"))
        self._link_chunks = m.counter(
            "repro_link_chunks_total",
            "Chunked wire sends on the cluster interconnect, by view.",
            ("view",))
        self._heat_gauge = m.gauge(
            "repro_page_heat",
            "Resolved per-page heat stats by domain "
            "(stat in pages/mean/p50/p95/max).", ("domain", "stat"))
        self._engine_steps = 0
        for ev in self.fabric._subs:
            self.fabric.subscribe(ev, self._bus_handler(ev))
        self.fabric.attach_obs(self)

    def _vlabel(self, view) -> str:
        name = view if isinstance(view, str) else \
            getattr(view, "name", str(view))
        return f"{self._group}/{name}" if self._group else (name or "")

    # -- virtual clock --------------------------------------------------------

    def _note_now(self, view: str, now: float) -> None:
        self._last_now[view] = float(now)

    def _now(self, view: str | None) -> float:
        if view in self._last_now:
            return self._last_now[view]
        return max(self._last_now.values(), default=0.0)

    # -- fabric event bus -----------------------------------------------------

    def _bus_handler(self, event: str):
        def handle(**kw):
            self._events.labels(event).inc()
            view = kw.get("view")
            if event in ("alloc", "free"):
                dom = self.fabric.pool.domains[kw["domain"]].name
                self._page_events.labels(event, self._vlabel(view or ""),
                                         dom).inc()
                if event == "free" and self.heat is not None:
                    self.heat.on_free(page=kw["page"])
            elif event == "migrate":
                self._migrations.labels(self._vlabel(view)).inc()
            elif event == "share":
                self._shares.labels(kw["kind"]).inc()
            elif event == "latency":
                self._latency_hist.labels(
                    self._vlabel(view)).observe(kw["seconds"])
            elif event in ("demote", "promote", "restore", "evict"):
                self._tier_ops.labels(event, self._vlabel(view)).inc(
                    kw["pages"])
                if self.tracer is not None:
                    self.tracer.on_fabric(
                        event, view, self._now(view),
                        dur_s=kw.get("seconds", 0.0),
                        args={"pages": kw["pages"]})
            elif event == "export_skip":
                self._export_skips.labels(self._vlabel(view)).inc(
                    kw["chains"])
                if self.tracer is not None:
                    self.tracer.on_fabric(
                        event, view, self._now(view),
                        args={"pages": kw["pages"],
                              "chains": kw["chains"]})
            elif event in ("link_send", "link_recv"):
                direction = "send" if event == "link_send" else "recv"
                self._link_bytes.labels(self._vlabel(view),
                                        direction).inc(kw["bytes"])
                if event == "link_send":
                    self._link_chunks.labels(self._vlabel(view)).inc(
                        kw["chunks"])
                if self.tracer is not None:
                    self.tracer.on_fabric(
                        event, view, self._now(view),
                        dur_s=kw.get("seconds", 0.0),
                        args={k: kw[k] for k in ("pages", "bytes",
                                                 "chunks") if k in kw})
        return handle

    # -- scheduler lifecycle hooks -------------------------------------------

    def on_admit(self, view, r, now: float) -> None:
        self._note_now(view.name, now)
        self._requests.labels("admit", self._vlabel(view), r.cls).inc()
        if self.tracer is not None:
            self.tracer.on_admit(view.name, r.sid, r.arrival_s, r.cls)

    def on_preempt(self, view, r, now: float, seconds: float,
                   pages: int) -> None:
        self._note_now(view.name, now)
        self._requests.labels("preempt", self._vlabel(view), r.cls).inc()
        if self.tracer is not None:
            self.tracer.on_swap_out(view.name, r.sid, now, seconds, pages)

    def on_resume(self, view, r, now: float, seconds: float) -> None:
        self._note_now(view.name, now)
        self._requests.labels("resume", self._vlabel(view), r.cls).inc()
        if self.tracer is not None:
            self.tracer.on_swap_in(view.name, r.sid, now, seconds)

    def on_finish(self, view, r, now: float) -> None:
        self._note_now(view.name, now)
        self._requests.labels("finish", self._vlabel(view), r.cls).inc()
        if self.tracer is not None:
            self.tracer.on_finish(view.name, r.sid, now, r.produced)

    # -- engine step hook -----------------------------------------------------

    def on_engine_step(self, view, plan, batch, read_pages,
                       predicted_s: float, t0: float, dt: float,
                       launches=None, read_weights=None) -> None:
        """One engine step just advanced the clock from ``t0`` by ``dt``:
        trace spans for its prefill chunks and decode batch, touch heat,
        and (with a probe) feed the drift ledger the batch-read pair(s).

        ``launches`` (micro-batch mode, DESIGN.md §11) is a list of
        ``(domain, launch_read_pages, launch_predicted_s)`` — each launch
        touches heat and bills drift *separately*, so a launch's
        bottleneck time is never credited to domains it did not read.
        ``read_weights`` maps pid -> fraction of the page the gather
        streamed (bytes-weighted heat; a partial tail page is cooler than
        a full interior page)."""
        self._note_now(view.name, t0 + dt)
        self._engine_steps += 1
        rw = read_weights or {}
        if self.heat is not None:
            for pages in ([rp for _, rp, _ in launches]
                          if launches is not None else [read_pages]):
                if pages:
                    self.heat.touch(
                        pages, weights=[rw.get(p, 1.0) for p in pages])
            self.heat.step()
            # periodic Prometheus refresh of the heat histograms — every
            # step would put an O(live pages) scan on the hot path
            if self._engine_steps % 16 == 0:
                self.refresh_heat_gauges()
        if batch:
            if launches is not None:
                for dom, _rp, _t in launches:
                    self._launches.labels(
                        self._vlabel(view),
                        self.fabric.pool.domains[dom].name).inc()
            else:
                self._launches.labels(self._vlabel(view), "global").inc()
        if self.tracer is not None:
            for seq, lo, hi in plan.prefill_chunks:
                self.tracer.on_prefill(view.name, seq.sid, t0, dt, lo, hi)
            for seq in batch:
                self.tracer.on_decode(view.name, seq.sid, t0, dt,
                                      seq.produced)
        if self.drift is not None and self.probe is not None and batch:
            if launches is not None:
                self.drift.observe_launches(
                    "batch_read",
                    [(view.footprint(rp), t) for _, rp, t in launches],
                    self.probe)
            else:
                bpd = view.footprint(read_pages)
                measured = self.probe("batch_read", bpd)
                if measured is not None:
                    self.drift.observe("batch_read", bpd, predicted_s,
                                       measured)

    def on_rehome(self, view, now: float, seconds: float,
                  pages: int) -> None:
        """The engine re-homed ``pages`` hot shared pages (DESIGN.md §11):
        count them and put the migration span on the fabric track."""
        self._note_now(view.name, now + seconds)
        self._rehomed.labels(self._vlabel(view)).inc(pages)
        if self.tracer is not None:
            self.tracer.on_fabric("rehome", view.name, now,
                                  dur_s=seconds, args={"pages": pages})

    # -- swap transfer hook ---------------------------------------------------

    def observe_transfer(self, bytes_per_domain,
                         predicted_s: float) -> None:
        if self.drift is None or self.probe is None:
            return
        bpd = np.asarray(bytes_per_domain, dtype=np.float64)
        if not bpd.any():
            return
        measured = self.probe("swap_transfer", bpd)
        if measured is not None:
            self.drift.observe("swap_transfer", bpd, predicted_s, measured)

    # -- reporting ------------------------------------------------------------

    def refresh_heat_gauges(self) -> None:
        """Fold the heat map's per-domain histograms into the labeled
        ``repro_page_heat`` gauges (Prometheus text export)."""
        if self.heat is None:
            return
        for dom, row in self.heat.per_domain().items():
            for stat, val in row.items():
                self._heat_gauge.labels(dom, stat).set(float(val))

    def snapshot(self) -> dict:
        self.refresh_heat_gauges()
        out = {"metrics": self.metrics.snapshot()}
        if self.drift is not None:
            out["drift"] = self.drift.summary()
        if self.heat is not None:
            out["heat"] = self.heat.snapshot()
        if self.tracer is not None:
            out["trace_events"] = len(self.tracer.events)
        return out
