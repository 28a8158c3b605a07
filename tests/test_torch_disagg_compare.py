"""``disagg_compare`` (a prefill host at page 4 hands finished prompts to a
decode host at page 8 over the Eq.-5-striped page wire, against one host)
on both packages: the reference's live run
(``benchmarks/scheduler_bench.py``) and the port's
(``benchmarks/torch_scheduler_bench.py``, on the CPU, with the reference's
params) give the same tokens on every engine and every counter exactly —
10 handoffs, 10 converted imports, 0 fallbacks, 136099 wire bytes — and
those counters are ``BENCH_disagg.json``'s."""

import json
from pathlib import Path

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import engines_of, smoke_pair, tokens_of  # noqa: E402
from benchmarks import scheduler_bench as r_bench  # noqa: E402
from benchmarks import torch_scheduler_bench as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_disagg_compare_equals_the_reference_and_bench_disagg_json():
    with engines_of(r_bench) as r_engines:
        ref = r_bench.disagg_compare()
    with engines_of(t_bench) as t_engines:
        port = t_bench.disagg_compare(params=smoke_pair()[True][1],
                                      device="cpu")
    assert len(t_engines) == len(r_engines) == 3
    assert tokens_of(t_engines) == tokens_of(r_engines)
    assert port == ref                      # every counter, exactly
    bench = json.loads((ROOT / "BENCH_disagg.json").read_text())
    assert port == bench
    d = port["disagg"]
    assert (d["handoffs"], d["converted_imports"], d["fallbacks"],
            d["wire_bytes"]) == (10, 10, 0, 136099)
    assert port["token_identical"]
