"""Trace-driven workload generation for the request scheduler.

Serving behavior under memory pressure depends on the *shape* of demand, not
just its mean: bursts force preemption, heavy-tailed prompts create the
large-footprint victims swap exists for. Three arrival processes (all
deterministic under a seed):

``poisson``     exponential interarrivals — the steady-state baseline.
``bursty``      on/off: bursts of back-to-back arrivals separated by idle
                gaps (mean rate preserved) — stresses admission + preemption.
``heavy_tail``  Pareto interarrivals and prompt lengths — a few huge
                requests among many small ones, the classic LLM-serving mix.
``domain_skew`` a near-zero-gap flood of long-prompt requests fills the
                fast domains first; a steady tail of short templated
                requests (carrying the shared prefix) arrives while they
                are full, so its pages land in slow domains — the
                contention pattern heat-driven re-homing (DESIGN.md §11)
                exists to fix.
``hot_prefix``  steady arrivals that all share one long hot system
                prompt — the maximally-shared-prefix stress for
                all-holders re-homing and the prefix trie.

``generate`` yields a time-sorted list of :class:`TraceRequest`; the caller
submits each to the scheduler with its arrival timestamp and the scheduler's
virtual clock does the rest.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    arrival_s: float
    prompt: tuple[int, ...]
    max_new: int
    cls: str = "default"


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Knobs shared by all trace kinds.

    ``class_mix`` maps priority-class name -> probability; ``kind``-specific
    parameters are ignored by the other kinds.
    """

    kind: str = "poisson"  # poisson|bursty|heavy_tail|domain_skew|hot_prefix
    num_requests: int = 16
    mean_interarrival_s: float = 0.05
    prompt_mean: int = 12
    prompt_max: int = 64
    max_new: int = 16
    vocab_size: int = 1000
    class_mix: tuple[tuple[str, float], ...] = (("default", 1.0),)
    seed: int = 0
    # bursty
    burst_len: int = 4                  # requests per burst
    burst_factor: float = 8.0           # gap/mean ratio between bursts
    # heavy_tail
    tail_alpha: float = 1.5             # Pareto shape (smaller = heavier)
    # domain_skew: fraction of requests in the leading flood (long prompts,
    # back-to-back, no shared prefix — they claim the fast domains); the
    # rest arrive at the steady rate and carry the prefix machinery
    skew_frac: float = 0.5
    # shared prefixes (any kind): with probability ``prefix_frac`` a request
    # prepends one of ``prefix_groups`` common prefixes of ``prefix_len``
    # tokens — the system prompt / few-shot template pattern that makes
    # prefix-sharing KV caches pay (DESIGN.md §6)
    prefix_len: int = 0
    prefix_groups: int = 1
    prefix_frac: float = 1.0
    # repetition-friendly prompts (any kind): with ``prompt_loop_len > 0``
    # each prompt body is a random motif of that length tiled to the drawn
    # prompt length — the templated / copy-heavy structure that makes
    # n-gram self-drafting (serve/spec.py, DESIGN.md §7) accept at high
    # rates; 0 keeps fully random bodies
    prompt_loop_len: int = 0


def _skew_head(spec: WorkloadSpec) -> int:
    """Requests in the domain_skew leading flood (at least one, and at
    least one steady-tail request remains)."""
    return min(max(1, int(round(spec.num_requests * spec.skew_frac))),
               spec.num_requests - 1)


def _interarrivals(spec: WorkloadSpec, rng: np.random.Generator) -> np.ndarray:
    n, mean = spec.num_requests, spec.mean_interarrival_s
    if spec.kind in ("poisson", "hot_prefix"):
        return rng.exponential(mean, size=n)
    if spec.kind == "domain_skew":
        # leading flood back-to-back, then the steady tail
        gaps = rng.exponential(mean, size=n)
        gaps[:_skew_head(spec)] = mean / 100.0
        return gaps
    if spec.kind == "bursty":
        # within a burst: near-zero gaps; between bursts: one long gap sized
        # so the long-run mean interarrival stays ``mean``
        gaps = np.full(n, mean / spec.burst_factor)
        start = np.arange(n) % spec.burst_len == 0
        per_burst = spec.burst_len * mean \
            - (spec.burst_len - 1) * mean / spec.burst_factor
        gaps[start] = per_burst
        return gaps * rng.uniform(0.8, 1.2, size=n)   # jitter, seeded
    if spec.kind == "heavy_tail":
        # Pareto with E[x] = mean: x = xm * (1 + P(alpha)), xm = mean*(a-1)/a
        a = spec.tail_alpha
        xm = mean * (a - 1.0) / a if a > 1 else mean
        return xm * (1.0 + rng.pareto(a, size=n))
    raise ValueError(f"unknown workload kind {spec.kind!r}")


def _prompt_lengths(spec: WorkloadSpec, rng: np.random.Generator) -> np.ndarray:
    n = spec.num_requests
    if spec.kind == "heavy_tail":
        a = spec.tail_alpha
        xm = max(spec.prompt_mean * (a - 1.0) / a, 1.0) if a > 1 \
            else float(spec.prompt_mean)
        lens = xm * (1.0 + rng.pareto(a, size=n))
    else:
        # lognormal around the mean: multiplicative spread, never < 1
        lens = rng.lognormal(np.log(max(spec.prompt_mean, 1)), 0.4, size=n)
    if spec.kind == "domain_skew":
        # the flood is all long prompts — it must actually fill the fast
        # domains before the steady tail shows up
        lens[:_skew_head(spec)] = spec.prompt_max
    return np.clip(np.round(lens), 1, spec.prompt_max).astype(np.int64)


def generate(spec: WorkloadSpec) -> list[TraceRequest]:
    """Deterministic trace: same spec (including seed) -> same requests."""
    rng = np.random.default_rng(spec.seed)
    arrivals = np.cumsum(_interarrivals(spec, rng))
    lens = _prompt_lengths(spec, rng)
    names = [c for c, _ in spec.class_mix]
    probs = np.asarray([p for _, p in spec.class_mix], dtype=np.float64)
    probs = probs / probs.sum()
    classes = rng.choice(len(names), size=spec.num_requests, p=probs)
    # hot_prefix with no explicit prefix config defaults to one long
    # shared system prompt every request carries
    plen, pgroups, pfrac = (spec.prefix_len, spec.prefix_groups,
                            spec.prefix_frac)
    if spec.kind == "hot_prefix" and plen == 0:
        plen, pgroups, pfrac = 2 * spec.prompt_mean, 1, 1.0
    prefixes = [tuple(int(t) for t in
                      rng.integers(1, spec.vocab_size, plen))
                for _ in range(pgroups)] if plen else []
    skew_head = _skew_head(spec) if spec.kind == "domain_skew" else 0
    out = []
    for i in range(spec.num_requests):
        head: tuple[int, ...] = ()
        # domain_skew: the flood carries no prefix (and consumes no rng
        # draws for it) — only the steady tail shares the template
        if prefixes and i >= skew_head and rng.uniform() < pfrac:
            head = prefixes[int(rng.integers(len(prefixes)))]
        n = int(lens[i])
        if spec.prompt_loop_len > 0:
            motif = rng.integers(1, spec.vocab_size,
                                 min(spec.prompt_loop_len, n))
            body = tuple(int(motif[j % len(motif)]) for j in range(n))
        else:
            body = tuple(int(t) for t in rng.integers(1, spec.vocab_size, n))
        prompt = head + body
        out.append(TraceRequest(arrival_s=float(arrivals[i]), prompt=prompt,
                                max_new=spec.max_new,
                                cls=names[int(classes[i])]))
    return out


def total_kv_pages(trace: list[TraceRequest], page_size: int) -> int:
    """Aggregate page footprint if every request were live at once — the
    oversubscription ratio vs ``hbm_local`` capacity is footprint/capacity."""
    return sum(-(-(len(t.prompt) + t.max_new) // page_size) for t in trace)
