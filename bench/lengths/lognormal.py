"""Log-normal lengths: ``median`` and ``sigma`` (of the log)."""

import math

import numpy as np


def draw(spec: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    return rng.lognormal(math.log(spec["median"]), spec["sigma"], size=n)
