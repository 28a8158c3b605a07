"""The open loop that drives ``ServeEngine``: requests are submitted when
their schedule says they are due, and the engine steps whenever it has
work. Each request is timed from its due time; a step's tokens are on the
host when ``ServeEngine.step`` returns (its own ``argmax(...).cpu()``), and
the loop adds no synchronisation of its own.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.scheduler.scheduler import State


@dataclasses.dataclass(eq=False)
class Track:
    due: float
    req: object = None
    submit: float | None = None
    refused: bool = False
    first_chunk: float | None = None
    first_tok: float | None = None
    seen: int = 0                          # tokens produced so far
    win_first: float | None = None         # token times inside the window
    win_last: float | None = None
    win_n: int = 0


@dataclasses.dataclass
class Step:
    start: float
    end: float
    tokens: int                            # decode tokens committed
    prefill_tokens: int
    used_pages: int
    pending: int


class OpenLoop:
    """Drives ``engine`` through ``schedule`` (``traffic.Arrival``s) with
    times relative to ``t0`` (``time.perf_counter``); the window is
    ``[w0, w1)``."""

    def __init__(self, engine, schedule, w0: float, w1: float,
                 tracer=None, trace_at: tuple[float, float] | None = None):
        """``trace_at``: (when the traced sub-window opens, its seconds)."""
        self.eng = engine
        self.sched = engine.scheduler
        self.schedule = schedule
        self.tracks = [Track(a.due_s) for a in schedule]
        self.w0, self.w1 = w0, w1
        self.steps: list[Step] = []
        self.tracer, self.trace_at = tracer, trace_at
        self._next = 0
        self._live: dict[int, Track] = {}
        self._unstarted: list[Track] = []
        self._n_done = len(self.sched.finished)
        self.capacity = self.eng.view.capacity()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def run(self, t0: float, until: float) -> None:
        """Submit and step until ``until``."""
        self.t0 = t0
        sched = self.sched
        while True:
            now = self.now()
            self._submit(now)
            self._trace_edge(now)
            if now >= until:
                break
            if sched.running or sched.pending:
                self._step()
            else:
                nxt = (self.schedule[self._next].due_s
                       if self._next < len(self.schedule) else until)
                time.sleep(max(0.0, min(nxt, until) - self.now()))
        if self.tracer is not None and self.tracer.active:
            self.tracer.stop()

    def finish(self, served_tokens: int, until: float) -> None:
        """After the run, step without new arrivals until the requests
        finished hold ``served_tokens`` served tokens (the check's sample
        needs finished requests), or until ``until``."""
        def served():
            return sum(t.req.produced for t in self.tracks
                       if t.req is not None and t.req.done)
        while served() < served_tokens and self.now() < until \
                and (self.sched.running or self.sched.pending):
            self._step()

    def record(self, end: float) -> dict:
        """What the metric readers take from the loop: the window, every
        submitted request's times and every step's times and counts."""
        return {"seconds": self.w1 - self.w0, "window": [self.w0, self.w1],
                "end": end, "pool_pages": self.capacity,
                "requests": [vars(t) | {"req": None} for t in self.tracks
                             if t.submit is not None],
                "steps": [vars(s) for s in self.steps]}

    def _trace_edge(self, now: float) -> None:
        """The traced sub-window ends with the measured window, so that
        stopping the profiler stalls nothing inside it."""
        if self.tracer is None or self.trace_at is None:
            return
        at, span = self.trace_at
        if not self.tracer.active and not self.tracer.done and now >= at:
            self.tracer.start()
        elif self.tracer.active and now >= self.w1:
            self.tracer.stop()

    def _submit(self, now: float) -> None:
        while self._next < len(self.schedule) \
                and self.schedule[self._next].due_s <= now:
            a, tr = self.schedule[self._next], self.tracks[self._next]
            self._next += 1
            tr.submit = now
            try:
                sid = self.eng.submit(list(a.prompt), max_new=a.max_new)
            except ValueError:
                tr.refused = True
                continue
            tr.req = self.sched.queued[-1]
            assert tr.req.sid == sid
            self._live[sid] = tr
            self._unstarted.append(tr)

    def _step(self) -> None:
        eng = self.eng
        e0, p0 = eng.tokens_emitted, eng.prefill_tokens_computed
        s0 = self.now()
        if self.tracer is not None:
            with self.tracer.step_range():
                eng.step()
        else:
            eng.step()
        s1 = self.now()
        in_win = self.w0 <= s1 < self.w1
        for r in self.sched.running:
            self._tokens(r, s1, in_win)
        fin = self.sched.finished
        for r in fin[self._n_done:]:
            self._tokens(r, s1, in_win)
            self._live.pop(r.sid, None)
        self._n_done = len(fin)
        still = []
        for tr in self._unstarted:
            if tr.req.length > 0 or tr.req.state is not State.QUEUED:
                tr.first_chunk = s0
            else:
                still.append(tr)
        self._unstarted = still
        self.steps.append(Step(s0, s1, eng.tokens_emitted - e0,
                               eng.prefill_tokens_computed - p0,
                               self.capacity - eng.view.free_count(),
                               len(self.sched.pending)))

    def _tokens(self, r, t: float, in_win: bool) -> None:
        tr = self._live.get(r.sid)
        if tr is None:
            return
        n = r.produced
        if n == tr.seen:
            return
        if tr.first_tok is None:
            tr.first_tok = t
        if in_win:
            if tr.win_first is None:
                tr.win_first = t
            tr.win_last = t
            tr.win_n += n - tr.seen
        tr.seen = n
