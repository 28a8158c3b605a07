"""Requests that share nothing: each prompt's length is drawn from the
traffic file's ``prompt`` distribution and its tokens uniformly from the
vocabulary (0 left out); each output length from ``output``."""

import numpy as np

from bench import traffic as gen


def longest(traffic: dict) -> int:
    return traffic["prompt"]["max"] + traffic["output"]["max"]


def make(traffic: dict, rng: np.random.Generator, n: int,
         vocab_size: int) -> list[tuple[tuple[int, ...], int]]:
    plen = gen.lengths(traffic["prompt"], rng, n)
    olen = gen.lengths(traffic["output"], rng, n)
    return [(tuple(rng.integers(1, vocab_size, int(p)).tolist()), int(o))
            for p, o in zip(plen, olen)]
