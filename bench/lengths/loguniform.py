"""Log-uniform lengths between ``min`` and ``max``."""

import math

import numpy as np


def draw(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    return np.exp(rng.uniform(math.log(spec["min"]), math.log(spec["max"]),
                              size=n))
