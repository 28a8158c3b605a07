"""Poisson arrivals: independent exponential gaps of mean 1 / ``rate_per_s``,
summed (the arithmetic of ``repro_torch.scheduler.workload``'s ``poisson``
kind, frozen here)."""

import numpy as np


def due_times(spec: dict, rng: np.random.Generator,
              horizon_s: float) -> np.ndarray:
    mean = 1.0 / spec["rate_per_s"]
    n = int(horizon_s / mean) + 16
    due = np.cumsum(rng.exponential(mean, size=n))
    while due[-1] < horizon_s:       # a slow draw: go on from its end
        due = np.concatenate([due, due[-1] + np.cumsum(
            rng.exponential(mean, size=n))])
    return due[due < horizon_s]
