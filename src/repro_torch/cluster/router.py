"""Prefill/decode disaggregation router (DESIGN.md §13; port of
``repro.cluster.router``).

*Phoenix* (PAPERS.md) argues placement must be orchestrated with where
compute runs; the router is that decision for a two-host cluster. A
prompt is admitted to the **prefill host** with ``max_new=1`` — its
engine runs prefill-heavy steps with a small resident decode set, so
first tokens surface fast. The moment the first token lands, the
request's prompt KV range is exported over the
:class:`~repro_torch.cluster.transport.PageChannel` and the remainder of the
request is submitted to the **decode host**, arriving (on the decode
clock) only after the wire transfer and import finish — the handoff
overlaps the prefill host's next prompts because the wire runs its own
virtual clock and never blocks the prefill engine.

The decode host's scheduler finds the imported range through the prefix
trie (``import_range`` rebuilds the chain keys), prefills only the
partial tail page, and decodes the remaining ``max_new - 1`` tokens —
token-identical to single-host serving, because prefill KV bytes move
bit-exactly and the tail recompute is deterministic.

When the wire is **saturated** (queueing delay beyond the router's
horizon, per the interconnect's Eq.-1 model), the router falls back to
single-host serving on the decode host — a handoff that arrives later
than local service is a loss, exactly the weighted-placement logic of
the paper applied to admission.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np


class ClusterRouter:
    """Admission + handoff across one prefill engine and one decode
    engine joined by a :class:`PageChannel`."""

    def __init__(self, prefill_engine, decode_engine, channel, *,
                 saturation_horizon_s: float = 0.1, mesh=None):
        self.prefill = prefill_engine
        self.decode = decode_engine
        self.channel = channel
        self.saturation_horizon_s = float(saturation_horizon_s)
        self.mesh = mesh
        self._rids = itertools.count()
        self._by_prefill_sid: dict[int, dict] = {}
        self._by_decode_sid: dict[int, int] = {}     # decode sid -> rid
        self._imports: dict[int, list[int]] = {}     # decode sid -> page ids
        self._results: dict[int, dict | None] = {}   # rid -> result record
        self.handoffs = 0
        self.fallbacks = 0
        prefill_engine.on_request_finish(self._on_prefill_finish)
        decode_engine.on_request_finish(self._on_decode_finish)

    # -- admission -------------------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new: int,
               cls: str | None = None) -> int:
        """Route one prompt. Split serving when the wire has headroom;
        single-host (decode host end-to-end) when a handoff would queue
        past the saturation horizon or there is nothing to hand off."""
        rid = next(self._rids)
        self._results[rid] = None
        now = self.prefill.scheduler.now
        if max_new <= 1 or self.channel.link.saturated(
                now, self.saturation_horizon_s):
            self.fallbacks += 1
            sid = self.decode.submit(list(prompt), max_new=max_new,
                                     cls=cls)
            self._by_decode_sid[sid] = rid
            return rid
        self.handoffs += 1
        sid = self.prefill.submit(list(prompt), max_new=1, cls=cls)
        self._by_prefill_sid[sid] = {
            "rid": rid, "prompt": list(prompt), "max_new": int(max_new),
            "cls": cls,
        }
        return rid

    # -- handoff (prefill-host finish hook) ------------------------------------

    def _on_prefill_finish(self, engine, seq) -> None:
        rec = self._by_prefill_sid.pop(seq.sid, None)
        if rec is None:
            return
        view = engine.view
        ps = view.page_size
        prompt_len = seq.prompt_len
        # after the first decode step KV covers [0, prompt_len): prefill
        # wrote [0, prompt_len-1), the step wrote position prompt_len-1
        pages = list(seq.pages[:-(-prompt_len // ps)])
        parcel = self.channel.send(
            view, pages, now=engine.scheduler.now,
            tokens=rec["prompt"], ntokens=prompt_len, mesh=self.mesh)
        new_ids, parcel, import_s = self.channel.recv(
            self.decode.view, mesh=self.mesh)
        ready = max(self.decode.scheduler.now, parcel.arrive_s) + import_s
        sid = self.decode.scheduler.submit(
            rec["prompt"] + [int(seq.tokens[-1])], cls=rec["cls"],
            max_new=rec["max_new"] - 1, arrival_s=ready)
        self._by_decode_sid[sid] = rec["rid"]
        self._imports[sid] = new_ids
        # the originating request's TTFT is the prefill host's: the user
        # saw the first token there, before the handoff even started
        slo = engine.scheduler.slo.records[seq.sid]
        self._results[rec["rid"]] = {
            "tokens": None, "produced": 1, "ttft": slo.ttft,
            "mode": "handoff", "done": False,    # head token counted here
        }

    # -- completion (decode-host finish hook) ----------------------------------

    def _on_decode_finish(self, engine, seq) -> None:
        rid = self._by_decode_sid.pop(seq.sid, None)
        if rid is None:
            return
        imported = self._imports.pop(seq.sid, None)
        if imported:
            # the channel's import holds end with the request; chain pages
            # the request shares die with its own release right after
            engine.view.release(imported)
        res = self._results.get(rid)
        if res is None:                     # local mode: decode-host TTFT
            slo = engine.scheduler.slo.records[seq.sid]
            res = {"ttft": slo.ttft, "mode": "local", "produced": 0}
        res["tokens"] = list(seq.tokens)
        res["produced"] += int(seq.produced)
        res["done"] = True
        self._results[rid] = res

    # -- driving ---------------------------------------------------------------

    def _has_work(self, engine) -> bool:
        # a queued future arrival counts: the scheduler's own idle-jump
        # advances the clock to it on the next schedule() call
        sch = engine.scheduler
        return bool(sch.running or sch.prefilling or sch.swapped
                    or sch.queued)

    def step(self) -> bool:
        """One router tick: step each engine that has open work (the
        scheduler's idle-jump handles future arrivals). Returns whether
        anything progressed."""
        worked = False
        for engine in (self.prefill, self.decode):
            if self._has_work(engine):
                engine.step()
                worked = True
        return worked

    def all_done(self) -> bool:
        return all(r is not None and r.get("done")
                   for r in self._results.values())

    def drain(self, max_steps: int = 100_000) -> None:
        steps = 0
        while not self.all_done():
            if not self.step():
                raise RuntimeError("cluster drain stalled with open "
                                   "requests")
            steps += 1
            assert steps < max_steps, "cluster drain exceeded step budget"

    # -- reporting -------------------------------------------------------------

    def result(self, rid: int) -> list[int]:
        res = self._results[rid]
        assert res is not None and res.get("done"), f"request {rid} open"
        return list(res["tokens"])

    def summary(self) -> dict:
        done = [r for r in self._results.values()
                if r is not None and r.get("done")]
        ttfts = [r["ttft"] for r in done if r["ttft"] is not None]
        tokens = sum(r["produced"] for r in done)
        elapsed = max(self.prefill.scheduler.now,
                      self.decode.scheduler.now)
        ttft_mean = float(np.mean(ttfts)) if ttfts else 0.0
        goodput = tokens / max(elapsed, 1e-9)
        return {
            "completed": len(done),
            "tokens": tokens,
            "elapsed_s": float(elapsed),
            "ttft_mean_s": ttft_mean,
            "goodput_tok_s": goodput,
            "ttft_weighted_goodput": goodput / max(ttft_mean, 1e-9),
            "handoffs": self.handoffs,
            "fallbacks": self.fallbacks,
            "channel": self.channel.stats(),
        }
