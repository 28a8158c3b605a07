"""``zoo_compare`` (the capacity market vs static partitions across three
page geometries in one byte arena) on both packages: the reference's live
run (``benchmarks/scheduler_bench.py``, run once for the module) and the
port's (``benchmarks/torch_scheduler_bench.py``, on the CPU, with the
reference's params) give the same rows, chat tokens and SSM/ASR state
digests exactly, and the rows are ``BENCH_zoo.json``'s."""

import contextlib
import json
from pathlib import Path

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import engines_of, smoke_pair  # noqa: E402
from benchmarks import scheduler_bench as r_bench  # noqa: E402
from benchmarks import torch_scheduler_bench as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def drivers_of(zoo_module):
    """Record every SSM and ASR driver a run builds (their digests are
    read after the run; the benchmark's rows leave them out)."""
    made = {"ssm": [], "asr": []}
    patched = {}
    for key, name in (("ssm", "SSMStateDriver"), ("asr", "EncoderKVDriver")):
        base = getattr(zoo_module, name)

        def init(self, *a, _base=base, _key=key, **kw):
            _base.__init__(self, *a, **kw)
            made[_key].append(self)
        patched[name] = type(name, (base,), {"__init__": init})
    with pytest.MonkeyPatch.context() as mp:
        for name, cls in patched.items():
            mp.setattr(zoo_module, name, cls)
        yield made


def _run(bench, zoo_module, **kw) -> dict:
    with engines_of(bench) as engines, drivers_of(zoo_module) as drivers:
        rows = bench.zoo_compare(**kw)
    return {"rows": rows,
            "tokens": [[list(s.tokens) for s in
                        sorted(e.finished, key=lambda s: s.sid)]
                       for e in engines],
            "ssm": [d.digests() for d in drivers["ssm"]],
            "asr": [d.digests() for d in drivers["asr"]]}


@pytest.fixture(scope="module")
def runs():
    """(reference, port): each package's zoo_compare, both modes."""
    from repro.serve import zoo as r_zoo
    from repro_torch.serve import zoo as t_zoo
    ref = _run(r_bench, r_zoo)
    port = _run(t_bench, t_zoo, params=smoke_pair()[True][1], device="cpu")
    return ref, port


def test_zoo_compare_rows_equal_the_reference_and_bench_zoo_json(runs):
    ref, port = runs
    assert port["rows"] == ref["rows"]      # every counter and float
    bench = json.loads((ROOT / "BENCH_zoo.json").read_text())
    assert port["rows"] == bench
    mkt, sta = port["rows"]["market"], port["rows"]["static"]
    assert (mkt["steps"], sta["steps"]) == (78, 96)
    assert (mkt["finished"], sta["finished"]) == (12, 12)
    assert mkt["granted_bytes"] == mkt["repaid_bytes"] == 49152
    assert mkt["outstanding_bytes"] == 0 and sta["granted_bytes"] == 0
    assert round(port["rows"]["goodput_ratio"], 4) == 1.2305


def test_zoo_compare_tokens_equal_the_reference(runs):
    ref, port = runs
    assert len(port["tokens"]) == len(ref["tokens"]) == 2
    assert port["tokens"] == ref["tokens"]
    assert port["tokens"][0] == port["tokens"][1]   # market == static
    assert all(len(t) == 12 for t in port["tokens"])


@pytest.mark.parametrize("tenant", ["ssm", "asr"])
def test_zoo_compare_digests_equal_the_reference(runs, tenant):
    """The SSM state and ASR encoder digests, read back from the pools
    (bf16 smoke geometries), equal the reference's bit for bit, in both
    modes."""
    ref, port = runs
    assert len(port[tenant]) == len(ref[tenant]) == 2
    assert port[tenant] == ref[tenant]
    assert port[tenant][0] == port[tenant][1]
    assert all(d != 0.0 for d in port[tenant][0])
