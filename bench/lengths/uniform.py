"""Uniform integer lengths between ``min`` and ``max``, both included."""

import numpy as np


def draw(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.integers(spec["min"], spec["max"] + 1, size=n)
