"""The port's last entry points against the reference's:
``benchmarks/torch_bwap_tpu.py`` (``bwap_tpu.py``), ``torch_roofline_table``
(``roofline_table.py``) and ``torch_run`` (``run.py``).
``torch_serve_bench`` is held in ``test_torch_serve.py`` against
``BENCH_serve.json``; here its ``main`` runs as a user runs it, on the
port's own params.

``kv_placement`` and ``optimizer_tiers`` are pure numpy on the port's
``core.topology`` and ``sharding.zero``: their dicts must equal the
reference's to the last bit. ``model_flops`` must equal the reference's
for every arch and ``SHAPES`` row, and ``render`` the reference's text on
the same records (synthetic ones, both modules' ``RESULTS`` pointed at
the test's directory). ``torch_run`` runs its sections on the CPU, its
artifacts and tables written under the test's directory, and must end
with its artifact check passed.
"""

import json

import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")

from benchmarks import artifacts, bwap_tpu, roofline_table  # noqa: E402
from benchmarks import torch_artifacts, torch_bwap_tpu  # noqa: E402
from benchmarks import torch_roofline_table, torch_run  # noqa: E402
from benchmarks import torch_serve_bench  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402


def test_bwap_tpu_equals_the_reference_to_the_last_bit():
    for name in ("kv_placement", "optimizer_tiers"):
        got, want = getattr(torch_bwap_tpu, name)(), getattr(bwap_tpu, name)()
        assert got == want, name
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)


def test_model_flops_equals_the_reference_on_every_cell():
    for arch in r_registry.ARCH_IDS:
        for shape in r_registry.SHAPES:
            assert torch_roofline_table.model_flops(arch, shape) == \
                roofline_table.model_flops(arch, shape), (arch, shape)


def _records():
    """A record of each kind the dry-run writes: OK with roofline terms on
    the single and the multi mesh, SKIP with a long reason, FAIL, and an
    OK one whose arch no config knows (``model_flops`` raises; the table
    prints nan)."""
    def roof(t_c, t_m, t_x, neck, flops, chips):
        return {"t_compute": t_c, "t_memory": t_m, "t_collective": t_x,
                "bottleneck": neck, "flops": flops, "chips": chips}
    return [
        {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "single",
         "status": "OK", "lower_compile_s": 12.34,
         "memory": {"total_bytes_per_device": 3.2e9}, "accum_steps": 2,
         "roofline": roof(0.5, 1.25, 0.1, "memory", 1.7e14, 256)},
        {"arch": "gemma-2b", "shape": "decode_32k", "mesh": "multi",
         "status": "OK", "lower_compile_s": 3.0,
         "memory": {"total_bytes_per_device": 1.1e10},
         "roofline": roof(0.01, 0.02, 0.3, "collective", 2e12, 512)},
        {"arch": "deepseek-v3-671b", "shape": "prefill_32k",
         "mesh": "single", "status": "SKIP",
         "reason": "does not fit: 391.1 GB a device against 80 GB, "
                   "expert-major buffer"},
        {"arch": "hymba-1.5b", "shape": "train_4k", "mesh": "multi",
         "status": "FAIL", "lower_compile_s": 0.5},
        {"arch": "no-such-arch", "shape": "train_4k", "mesh": "single",
         "status": "OK", "lower_compile_s": 1.0,
         "roofline": roof(1.0, 2.0, 0.5, "memory", 1e12, 256)},
    ]


def test_roofline_table_renders_the_reference_text(tmp_path, monkeypatch):
    for i, rec in enumerate(_records()):
        (tmp_path / f"{i:02d}_{rec['arch']}.json").write_text(
            json.dumps(rec))
    monkeypatch.setattr(roofline_table, "RESULTS", tmp_path)
    monkeypatch.setattr(torch_roofline_table, "RESULTS", tmp_path)
    for single in (True, False):
        got = torch_roofline_table.render(single)
        assert got == roofline_table.render(single)
        assert "nan" in got and "SKIP (does not fit" in got
    assert torch_roofline_table.load_cells() == _records()
    monkeypatch.setattr(torch_roofline_table, "RESULTS", tmp_path / "none")
    assert "no dry-run results yet" in torch_roofline_table.render()


def test_torch_run_writes_and_checks_every_artifact(tmp_path, monkeypatch,
                                                    capsys):
    """On one torch thread: beside the other test workers, the sections'
    many small CPU ops otherwise oversubscribe the cores (302 s against
    ~19 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(artifacts, "ROOT", tmp_path)
    monkeypatch.setattr(torch_run, "RESULTS", tmp_path / "results")
    try:
        torch_run.main(["--device", "cpu", "--skip-dryrun-table"])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert f"[port artifacts OK — {len(torch_artifacts.EXPECTED)} checked" \
        in out
    for name in torch_artifacts.EXPECTED:
        assert not torch_artifacts.problems(
            name, json.loads((tmp_path / name).read_text())), name
    assert sorted(p.stem for p in (tmp_path / "results").glob("*.json")) \
        == ["fig1b", "fig23", "fig4", "observation3", "overhead", "table2",
            "tpu_kv", "tpu_opt_tiers"]
    assert json.loads((tmp_path / "results" / "tpu_kv.json").read_text()) \
        == json.loads(json.dumps(bwap_tpu.kv_placement(), default=float))
    assert out.count("[section ") == 17
    serve = json.loads((tmp_path / "BENCH_torch_serve.json").read_text())
    assert serve["token_identical"] is True


def test_serve_bench_main_passes_its_gates_on_its_own_params(tmp_path,
                                                             monkeypatch,
                                                             capsys):
    """``python -m benchmarks.torch_serve_bench --device cpu``: the port's
    seed-0 params, every request finished and speculation token-identical
    (gated), the step ratio printed against the reference's 1.3, and the
    artifact written with the reference's schema. One torch thread, as
    ``test_torch_run_writes_and_checks_every_artifact``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(artifacts, "ROOT", tmp_path)
    try:
        torch_serve_bench.main(["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    assert "not gated on the port's own params" in capsys.readouterr().out
    name = "BENCH_torch_serve.json"
    rows = json.loads((tmp_path / name).read_text())
    assert not torch_artifacts.problems(name, rows)
    assert rows["token_identical"] is True
    for mode in ("greedy", "speculative"):
        assert rows[mode]["failed"] == 0
        assert rows[mode]["finished"] == rows[mode]["requests"] == 6
