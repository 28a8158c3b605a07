"""``coda_compare`` (compute-follows-data vs global batching on the
``domain_skew`` trace) on both packages: the reference's live run
(``benchmarks/scheduler_bench.py``) and the port's
(``benchmarks/torch_scheduler_bench.py``, on the CPU, with the reference's
params) give the same tokens and every counter exactly, and those counters
are ``BENCH_coda.json``'s."""

import json
from pathlib import Path

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import engines_of, smoke_pair, tokens_of  # noqa: E402
from benchmarks import scheduler_bench as r_bench  # noqa: E402
from benchmarks import torch_scheduler_bench as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_coda_compare_equals_the_reference_and_bench_coda_json():
    with engines_of(r_bench) as r_engines:
        ref = r_bench.coda_compare()
    with engines_of(t_bench) as t_engines:
        port = t_bench.coda_compare(params=smoke_pair()[True][1],
                                    device="cpu")
    assert len(t_engines) == len(r_engines) == 2
    assert tokens_of(t_engines) == tokens_of(r_engines)
    assert port == ref                      # every counter, exactly
    bench = json.loads((ROOT / "BENCH_coda.json").read_text())
    for run in ("coda", "global"):
        for k, v in bench[run].items():
            assert port[run][k] == v, (run, k)
    assert port["goodput_ratio"] == bench["goodput_ratio"]
    assert (port["coda"]["steps"], port["coda"]["multi_launch_steps"],
            port["coda"]["rehomed_pages"]) == (38, 34, 8)
