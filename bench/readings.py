"""What the metric readers share: the run's record reduced to numbers.

A record (``bench/run.py``) holds every submitted request's times, every
step's times and counts, and, in a traced run, the summary of the traced
sub-window (``bench/trace.py``). Times are seconds from the schedule's
start; the window is ``record["window"]``. A reader that finds nothing to
read returns None, and its metric is left out of the result line.
"""

from __future__ import annotations

import numpy as np

from bench import counts


def window_requests(rec):
    w0, w1 = rec["window"]
    return [r for r in rec["requests"] if w0 <= r["due"] < w1]


def window_steps(rec):
    w0, w1 = rec["window"]
    return [s for s in rec["steps"] if w0 <= s["end"] < w1]


def pct_ms(values, q):
    return float(np.percentile(values, q) * 1e3) if values else None


def output_tok_s(rec):
    return sum(s["tokens"] for s in window_steps(rec)) / rec["seconds"]


def _by_end(t, end):
    """A time stamped after the run's end (or never) counts as the end."""
    return end if t is None or t > end else t


def ttft_ms(rec, q):
    """Percentile ``q`` over every request due in the window of the time
    from its due time to the return of the step that gave its first
    token."""
    return pct_ms([_by_end(r["first_tok"], rec["end"]) - r["due"]
                   for r in window_requests(rec)], q)


def tpot_ms(rec, q):
    """Percentile ``q`` over every request with two tokens or more in the
    window of (last - first token time) / (tokens - 1), in the window."""
    return pct_ms([(r["win_last"] - r["win_first"]) / (r["win_n"] - 1)
                   for r in rec["requests"] if r["win_n"] >= 2], q)


def queue_wait_ms(rec, q):
    """Percentile ``q`` over requests due in the window of the time from
    due to the step that ran their first prefill chunk."""
    return pct_ms([_by_end(r["first_chunk"], rec["end"]) - r["due"]
                   for r in window_requests(rec)], q)


def step_ms(rec):
    steps = window_steps(rec)
    if not steps:
        return None
    return 1e3 * sum(s["end"] - s["start"] for s in steps) / len(steps)


def decode_batch_mean(rec):
    n = [s["tokens"] for s in window_steps(rec) if s["tokens"]]
    return float(np.mean(n)) if n else None


def pool_used_pct(rec):
    steps = window_steps(rec)
    if not steps:
        return None
    return 100.0 * max(s["used_pages"] for s in steps) / rec["pool_pages"]


def _trace(rec):
    return rec.get("trace")


def phase_ms(rec, phase):
    tr = _trace(rec)
    if not tr or not tr["decode_passes"]:
        return None
    return 1e3 * tr["phase_device_s"][phase] / tr["decode_passes"]


def prefill_ms_per_ktok(rec):
    tr = _trace(rec)
    if not tr or not tr["prefill_tokens"]:
        return None
    return 1e3 * tr["phase_device_s"]["prefill"] \
        / (tr["prefill_tokens"] / 1e3)


def roofline(rec, kind):
    """Sum of least times over sum of device times of the launches of
    ``kind`` whose device time the trace holds, in %; never 0 for want of
    a launch: None."""
    tr = _trace(rec)
    k = tr["kinds"].get(kind) if tr else None
    if not k or not k["matched"] or k["device_s"] <= 0:
        return None
    return 100.0 * k["least_s"] / k["device_s"]


def idle_pct(rec):
    tr = _trace(rec)
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mfu(rec):
    tr = _trace(rec)
    if not tr or tr["model_flops"] <= 0:
        return None
    return 100.0 * tr["model_flops"] / (tr["window_s"] * counts.PEAK_FLOPS)
