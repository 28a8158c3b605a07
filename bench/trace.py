"""The traced run's instrumentation, from the benchmark's own files: wrappers
around the program's entry points that open ``record_function`` ranges and
note each launch's shapes, and the reduction of a ``torch.profiler`` trace
of a sub-window to a summary (no trace file is written).

Ranges: ``bench/step`` (``ServeEngine.step``), ``bench/schedule``
(``RequestScheduler.schedule``), ``bench/prefill`` and ``bench/decode``
(``PagedDecoder.forward_chunks`` and ``decode_step``), and one range a
launch of the paged walk and of the row-invariant product, named with the
launch's index (``bench/paged.decode#12``), so that the device time of its
kernels pairs with the least time its shapes give.
"""

from __future__ import annotations

import time
from contextlib import nullcontext

import torch

from bench import counts

PHASES = ("bench/decode", "bench/prefill", "bench/schedule", "bench/step")


class Tracer:
    """Installed on one engine; records only while ``active``."""

    def __init__(self, engine, model: dict):
        from repro_torch.kernels.paged_attention import ops as paged_ops
        from repro_torch.kernels.rowwise_matmul import ops as rowwise_ops
        self.model = model
        self.cuda = engine.device.type == "cuda"
        self.active = self.done = False
        self.launches: list[tuple[str, float]] = []   # (kind, least seconds)
        self.tokens = self.keys = self.logit_rows = 0
        self.prefill_tokens = 0
        self.decode_passes = 0
        self._chunks: list[tuple[int, int]] = []      # the pass's (start, t)
        nq, nkv = model["num_attention_heads"], model["num_key_value_heads"]
        hd = model["hidden_size"] // nq
        self._restore = []

        def patch(owner, name, make):
            orig = getattr(owner, name)
            setattr(owner, name, make(orig))
            self._restore.append((owner, name, orig))

        def launch(kind, least):
            i = len(self.launches)
            self.launches.append((kind, least))
            return torch.profiler.record_function(f"bench/{kind}#{i}")

        def walk(kind):
            def make(orig):
                def wrapped(*a, **kw):
                    if not self.active:
                        return orig(*a, **kw)
                    fl, nb = counts.paged_walk(self._chunks, nq, nkv, hd)
                    with launch(kind, counts.least_s(fl, nb)):
                        return orig(*a, **kw)
                return wrapped
            return make

        def product(orig):
            def wrapped(a, w):
                if not self.active:
                    return orig(a, w)
                k, n = w.shape
                fl, nb = counts.rowwise(a.numel() // k, n, k)
                with launch("rowwise", counts.least_s(fl, nb)):
                    return orig(a, w)
            return wrapped

        def phase(name, chunks_of):
            def make(orig):
                def wrapped(*a, **kw):
                    if not self.active:
                        return orig(*a, **kw)
                    self._chunks = chunks_of(*a, **kw)
                    with torch.profiler.record_function(name):
                        return orig(*a, **kw)
                return wrapped
            return make

        def prefill_chunks(chunks, **_):
            out = [(start, len(toks)) for toks, _, start in chunks]
            for start, t in out:
                self.tokens += t
                self.prefill_tokens += t
                self.keys += counts.causal_pairs(start, t)
            return out

        def decode_chunks(seqs):
            out = [(s.length, 1) for s in seqs]
            self.tokens += len(out)
            self.logit_rows += len(out)
            self.keys += sum(start + 1 for start, _ in out)
            self.decode_passes += 1
            return out

        def ranged(name):
            def make(orig):
                def wrapped(*a, **kw):
                    if not self.active:
                        return orig(*a, **kw)
                    with torch.profiler.record_function(name):
                        return orig(*a, **kw)
                return wrapped
            return make

        patch(paged_ops, "paged_attention", walk("paged.decode"))
        patch(paged_ops, "paged_prefill_attention_batch", walk("paged.prefill"))
        patch(rowwise_ops, "rowwise_matmul", product)
        dec = engine.decoder
        patch(dec, "forward_chunks", phase("bench/prefill", prefill_chunks))
        # the decode pass's host lengths come from the engine's launch, the
        # device tensors from the decoder's
        patch(engine, "_decode_launch", phase("bench/decode", decode_chunks))
        patch(engine.scheduler, "schedule", ranged("bench/schedule"))

    def step_range(self):
        return (torch.profiler.record_function("bench/step") if self.active
                else nullcontext())

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._restore):
            setattr(owner, name, orig)

    # -- the sub-window ------------------------------------------------------

    def warm(self) -> None:
        """The profiler's first start in a process sets up its device
        tracing for seconds; pay that in set-up, not in the window."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=acts):
            torch.ones(1, device="cuda" if self.cuda else "cpu").add_(1)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        t = time.perf_counter()
        self.prof.__enter__()
        self.active = True
        self.t0 = time.perf_counter()
        self.start_s = self.t0 - t

    def stop(self) -> None:
        self.active, self.done = False, True
        if self.cuda:
            torch.cuda.synchronize()
        self.window = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict | None:
        """Device time by kernel, by phase and by launch. The profiler
        records each ``bench/`` range twice: on the host, and on the
        device's timeline, spanning the kernels launched inside it; a
        kernel belongs to the device-side ranges that contain it."""
        import bisect
        from torch.autograd import DeviceType
        if not self.done:
            return None
        window = self.window
        kernels, ranges, hosts = [], [], []
        host_s = {p.split("/")[1]: 0.0 for p in PHASES}
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                (ranges if e.name.startswith("bench/") else kernels).append(
                    (a, b, e.name))
            elif e.name in PHASES:
                hosts.append((a, b, e.name))
                host_s[e.name.split("/")[1]] += (b - a) / 1e6
        kernels.sort()
        starts = [k[0] for k in kernels]
        dev_s: dict[int, float] = {}    # launch index -> device seconds
        phase_s = {p.split("/")[1]: 0.0 for p in PHASES}
        for a, b, name in ranges:
            i = bisect.bisect_left(starts, a)
            inside = 0.0
            while i < len(kernels) and kernels[i][0] <= b:
                if kernels[i][1] <= b:
                    inside += kernels[i][1] - kernels[i][0]
                i += 1
            inside /= 1e6
            if "#" in name:
                n = int(name.rsplit("#", 1)[1])
                dev_s[n] = dev_s.get(n, 0.0) + inside
            elif name in PHASES:
                phase_s[name.split("/")[1]] += inside
        by_name: dict[str, float] = {}
        for a, b, name in kernels:
            by_name[name[:96]] = by_name.get(name[:96], 0.0) + (b - a) / 1e6
        busy, gaps = _busy_and_gaps([(a, b) for a, b, _ in kernels])
        kinds: dict[str, dict] = {}
        for i, (kind, least) in enumerate(self.launches):
            k = kinds.setdefault(kind, {"n": 0, "matched": 0,
                                        "least_s": 0.0, "device_s": 0.0})
            k["n"] += 1
            if dev_s.get(i, 0.0) > 0.0:
                k["matched"] += 1
                k["least_s"] += least
                k["device_s"] += dev_s[i]
        return {
            "window_s": window, "busy_s": busy, "start_s": self.start_s,
            "kinds": kinds,
            "phase_device_s": phase_s, "phase_host_s": host_s,
            "decode_passes": self.decode_passes,
            "prefill_tokens": self.prefill_tokens,
            "model_flops": counts.model_flops(self.model, self.tokens,
                                              self.keys, self.logit_rows),
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": _label_gaps(gaps, hosts)[:10],
        }


def _busy_and_gaps(intervals):
    """Seconds covered by the union of device intervals (us), and the gaps
    between them as (start us, seconds)."""
    busy, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, (a - end) / 1e6))
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e6, gaps


def _label_gaps(gaps, hosts):
    """Idle device time summed by the innermost host range open when each
    gap began (outside every range: the benchmark's own loop)."""
    rank = {p: i for i, p in enumerate(PHASES)}
    hosts = sorted(hosts)
    tot: dict[str, list] = {}
    j, open_ = 0, []
    for start, secs in sorted(gaps):
        while j < len(hosts) and hosts[j][0] <= start:
            open_.append(hosts[j])
            j += 1
        open_ = [h for h in open_ if h[1] > start]
        label = min((h[2] for h in open_), key=rank.get,
                    default="bench loop (outside ServeEngine.step)")
        t = tot.setdefault(label, [0.0, 0, 0.0])
        t[0] += secs
        t[1] += 1
        t[2] = max(t[2], secs)
    return sorted(([f"host in {k} ({n} gaps, longest {m:.6f} s)", s]
                   for k, (s, n, m) in tot.items()), key=lambda x: -x[1])
