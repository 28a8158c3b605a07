"""``persist_compare`` (warm vs cold restart over a shared-prefix trace) on
both packages: the reference's live run (``benchmarks/scheduler_bench.py``)
and the port's (``benchmarks/torch_scheduler_bench.py``, on the CPU, with
the reference's params) give the same tokens on all three engines, every
counter exactly, and those counters are ``BENCH_persist.json``'s. The two
prefix stores the runs write hold the same chains under the same manifest,
their K/V within the fp32 tolerance (each package's prefill rounds its own
way; the byte-level store format is held in ``test_torch_persist.py``).
Both stores go under the test's temporary directory, never into the
repository."""

import io
import json
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import engines_of, smoke_pair, tokens_of  # noqa: E402
from benchmarks import artifacts  # noqa: E402
from benchmarks import scheduler_bench as r_bench  # noqa: E402
from benchmarks import torch_scheduler_bench as t_bench  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _files(d: Path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_persist_compare_equals_the_reference_and_bench_persist_json(
        tmp_path, monkeypatch):
    # the reference writes its store under artifacts.ROOT
    monkeypatch.setattr(artifacts, "ROOT", tmp_path / "reference")
    with engines_of(r_bench) as r_engines:
        ref = r_bench.persist_compare()
    with engines_of(t_bench) as t_engines:
        port = t_bench.persist_compare(params=smoke_pair()[True][1],
                                       store=tmp_path / "port",
                                       device="cpu")
    assert len(t_engines) == len(r_engines) == 3
    tokens = tokens_of(t_engines)
    assert tokens == tokens_of(r_engines)
    assert tokens[1] == tokens[2]           # warm == cold restart
    assert port == ref                      # every counter, exactly
    bench = json.loads((ROOT / "BENCH_persist.json").read_text())
    assert port == bench
    assert (port["exported_chains"], port["restored_pages"],
            port["warm"]["first_step_prefix_hit_pages"]) == (2, 24, 84)
    r_store = tmp_path / "reference" / "benchmarks" / "results" \
        / "persist_store" / "prefix_store"
    # the chains' K/V come from each package's own fp32 prefill, whose
    # bits differ by rounding: equal names, headers and manifests but for
    # the digests, values within the fp32 tolerance
    got, want = (_files(d) for d in (tmp_path / "port" / "prefix_store",
                                     r_store))
    assert got.keys() == want.keys()
    manifests = [json.loads(f.pop("manifest.json")) for f in (got, want)]
    for m in manifests:
        for ch in m["chains"]:
            del ch["sha256_k"], ch["sha256_v"]
    assert manifests[0] == manifests[1]
    for name in got:
        a, b = (np.load(io.BytesIO(f[name])) for f in (got, want))
        assert got[name][:128] == want[name][:128]      # the npy header
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
