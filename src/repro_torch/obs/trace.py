"""Per-request span tracer on the virtual clock (DESIGN.md §10).

Records the request lifecycle — admit, queued wait, prefill chunks,
decode steps, preempt/swap-out/swap-in, tier demote/promote/restore,
finish — as Chrome/Perfetto trace events. Export with
:meth:`SpanTracer.export` and load the JSON in ``ui.perfetto.dev`` (or
``chrome://tracing``): one process row per fabric view (tenant), one
thread row per request, plus a ``fabric`` thread carrying migration and
tier activity.

Timestamps are the scheduler's *virtual* seconds converted to trace
microseconds, so a trace from a ``wall_clock=False`` run is byte-stable
across machines.

Port of ``repro.obs.trace``: pure Python, the same code.
"""

from __future__ import annotations

import json
import pathlib

_FABRIC_TID = 0          # per-view bus track; request tids are sid + 1


class SpanTracer:
    """Accumulates Chrome trace events ("X" spans, "i" instants)."""

    def __init__(self):
        self.events: list[dict] = []
        self._pids: dict[str, int] = {}
        self._named_tids: dict[tuple[int, int], str] = {}
        self._admitted: dict[tuple[int, int], float] = {}

    # -- track bookkeeping ----------------------------------------------------

    def _pid(self, view: str) -> int:
        pid = self._pids.get(view)
        if pid is None:
            pid = len(self._pids) + 1
            self._pids[view] = pid
            self.events.append({"ph": "M", "name": "process_name",
                                "pid": pid, "tid": 0,
                                "args": {"name": f"view:{view}"}})
            self._name_tid(pid, _FABRIC_TID, "fabric")
        return pid

    def _name_tid(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) not in self._named_tids:
            self._named_tids[(pid, tid)] = name
            self.events.append({"ph": "M", "name": "thread_name",
                                "pid": pid, "tid": tid,
                                "args": {"name": name}})

    def _req_tid(self, pid: int, sid: int) -> int:
        tid = int(sid) + 1
        self._name_tid(pid, tid, f"req {sid}")
        return tid

    # -- low-level emitters ---------------------------------------------------

    def span(self, name: str, view: str, tid: int, ts_s: float,
             dur_s: float, args: dict | None = None) -> None:
        ev = {"ph": "X", "name": name, "cat": "repro",
              "pid": self._pid(view), "tid": tid,
              "ts": ts_s * 1e6, "dur": max(dur_s, 0.0) * 1e6}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, view: str, tid: int, ts_s: float,
                args: dict | None = None) -> None:
        ev = {"ph": "i", "name": name, "cat": "repro", "s": "t",
              "pid": self._pid(view), "tid": tid, "ts": ts_s * 1e6}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- request lifecycle (driven by the Observatory) ------------------------

    def on_admit(self, view: str, sid: int, ts_s: float, cls: str) -> None:
        pid = self._pid(view)
        tid = self._req_tid(pid, sid)
        self._admitted[(pid, tid)] = ts_s
        self.instant("admit", view, tid, ts_s, {"cls": cls})

    def _close_queued(self, view: str, tid: int, ts_s: float) -> None:
        """First unit of work for a request ends its queued wait."""
        t0 = self._admitted.pop((self._pid(view), tid), None)
        if t0 is not None and ts_s > t0:
            self.span("queued", view, tid, t0, ts_s - t0)

    def on_prefill(self, view: str, sid: int, ts_s: float, dur_s: float,
                   lo: int, hi: int) -> None:
        tid = self._req_tid(self._pid(view), sid)
        self._close_queued(view, tid, ts_s)
        self.span("prefill", view, tid, ts_s, dur_s,
                  {"lo": lo, "hi": hi, "tokens": hi - lo})

    def on_decode(self, view: str, sid: int, ts_s: float, dur_s: float,
                  produced: int) -> None:
        tid = self._req_tid(self._pid(view), sid)
        self._close_queued(view, tid, ts_s)
        self.span("decode", view, tid, ts_s, dur_s,
                  {"produced": produced})

    def on_swap_out(self, view: str, sid: int, ts_s: float, dur_s: float,
                    pages: int) -> None:
        tid = self._req_tid(self._pid(view), sid)
        self.span("swap_out", view, tid, ts_s, dur_s, {"pages": pages})

    def on_swap_in(self, view: str, sid: int, ts_s: float,
                   dur_s: float) -> None:
        tid = self._req_tid(self._pid(view), sid)
        self.span("swap_in", view, tid, ts_s, dur_s)

    def on_finish(self, view: str, sid: int, ts_s: float,
                  produced: int) -> None:
        tid = self._req_tid(self._pid(view), sid)
        self.instant("finish", view, tid, ts_s, {"produced": produced})

    # -- fabric bus activity (migrations, tier moves, shares) -----------------

    def on_fabric(self, name: str, view: str, ts_s: float,
                  dur_s: float = 0.0, args: dict | None = None) -> None:
        view = view or "fabric"
        if dur_s > 0.0:
            self.span(name, view, _FABRIC_TID, ts_s, dur_s, args)
        else:
            self.instant(name, view, _FABRIC_TID, ts_s, args)

    # -- export ---------------------------------------------------------------

    def spans(self, name: str | None = None,
              sid: int | None = None) -> list[dict]:
        """Query helper for tests: "X"/"i" events by name and request."""
        out = []
        for ev in self.events:
            if ev["ph"] not in ("X", "i"):
                continue
            if name is not None and ev["name"] != name:
                continue
            if sid is not None and ev["tid"] != sid + 1:
                continue
            out.append(ev)
        return out

    def to_dict(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_dict()) + "\n")
        return path
