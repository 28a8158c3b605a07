"""``compare`` (goodput of the three swap placements on an oversubscribed
bursty trace) on both packages: the reference's live run
(``benchmarks/scheduler_bench.py``) and the port's
(``benchmarks/torch_scheduler_bench.py``, on the CPU, with the reference's
params) give the same tokens and every counter exactly, at the sizes that
wrote ``BENCH_scheduler.json`` (8 requests, 12 new tokens;
``benchmarks/run.py``), and those counters are the artifact's."""

import json
from pathlib import Path

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import engines_of, smoke_pair, tokens_of  # noqa: E402
from benchmarks import scheduler_bench as r_bench  # noqa: E402
from benchmarks import torch_scheduler_bench as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_compare_equals_the_reference_and_bench_scheduler_json():
    with engines_of(r_bench) as r_engines:
        ref = r_bench.compare(requests=8, max_new=12)
    with engines_of(t_bench) as t_engines:
        port = t_bench.compare(requests=8, max_new=12,
                               params=smoke_pair()[True][1], device="cpu")
    assert len(t_engines) == len(r_engines) == 3
    assert tokens_of(t_engines) == tokens_of(r_engines)
    assert port == ref                      # every counter, exactly
    bench = json.loads((ROOT / "BENCH_scheduler.json").read_text())
    assert port == bench
    assert port["bwap_canonical"]["goodput_tok_s"] \
        > port["local_first"]["goodput_tok_s"]
