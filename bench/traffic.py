"""The one traffic generator: an open-loop arrival schedule and its requests,
from a cell's traffic file and ``--seed``.

The traffic file names its parts, and each is a module found by that name
(``bench/cell.py``): ``arrivals.process`` is ``arrivals/<process>.py``,
whose ``due_times(spec, rng, horizon_s)`` gives the due times, and
``requests`` is ``requests/<kind>.py``, whose ``make(traffic, rng, n,
vocab_size)`` gives each request's prompt and output length and whose
``longest(traffic)`` bounds prompt plus output (the pool is sized by it).
Length distributions are ``lengths/<dist>.py``. One generator, seeded once,
draws all of it in that order, so the same seed gives the same schedule.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bench import cell


@dataclasses.dataclass(frozen=True)
class Arrival:
    due_s: float                 # seconds after the schedule's start
    prompt: tuple[int, ...]
    max_new: int


def lengths(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` lengths drawn from ``spec``'s distribution (``spec["dist"]``
    names it), as integers clipped to [min, max]."""
    x = cell.plugin("lengths", spec["dist"]).draw(spec, rng, n)
    return np.clip(np.round(x), spec["min"], spec["max"]).astype(np.int64)


def longest(traffic: dict) -> int:
    """The most tokens (prompt and output) one request of the cell holds."""
    return int(cell.plugin("requests", traffic["requests"]).longest(traffic))


def generate(traffic: dict, seed: int, horizon_s: float,
             vocab_size: int) -> list[Arrival]:
    """The schedule of one run up to ``horizon_s``, sorted by due time."""
    rng = np.random.default_rng(seed)
    arr = traffic["arrivals"]
    due = cell.plugin("arrivals", arr["process"]).due_times(arr, rng,
                                                           horizon_s)
    made = cell.plugin("requests", traffic["requests"]).make(
        traffic, rng, len(due), vocab_size)
    return [Arrival(float(t), tuple(p), int(n))
            for t, (p, n) in zip(due, made)]
