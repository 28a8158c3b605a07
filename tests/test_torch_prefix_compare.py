"""``prefix_compare`` (prefix reuse on vs off over a shared-prefix
heavy-tail trace) on both packages: the reference's live run
(``benchmarks/scheduler_bench.py``) and the port's
(``benchmarks/torch_scheduler_bench.py``, on the CPU, with the reference's
params) give the same tokens and every counter exactly, and those counters
are ``BENCH_prefix.json``'s."""

import json
from pathlib import Path

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import engines_of, smoke_pair, tokens_of  # noqa: E402
from benchmarks import scheduler_bench as r_bench  # noqa: E402
from benchmarks import torch_scheduler_bench as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_prefix_compare_equals_the_reference_and_bench_prefix_json():
    with engines_of(r_bench) as r_engines:
        ref = r_bench.prefix_compare()
    with engines_of(t_bench) as t_engines:
        port = t_bench.prefix_compare(params=smoke_pair()[True][1],
                                      device="cpu")
    assert len(t_engines) == len(r_engines) == 2
    tokens = tokens_of(t_engines)
    assert tokens == tokens_of(r_engines)
    assert tokens[0] == tokens[1]           # reuse on == reuse off
    assert port == ref                      # every counter, exactly
    bench = json.loads((ROOT / "BENCH_prefix.json").read_text())
    assert port == bench
    assert port["footprint_reduction"] >= 1.5
