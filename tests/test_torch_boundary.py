"""The port's boundary: nothing under ``src/repro_torch/``, in the port's
benchmarks (``benchmarks/torch_*.py``) or in ``chip_smoke.py`` imports JAX,
``ml_dtypes`` or the reference package (the machine with the card has
none of them), every entry point refuses ``device="cuda"`` when no card
is present instead of carrying on on the CPU, and ``chip_smoke.py`` fails
without a card or without the rest of the repository."""

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_BENCHMARKS = sorted((ROOT / "benchmarks").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", PORT_FILES + PORT_BENCHMARKS + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_ast_check_sees_imports():
    assert len(PORT_FILES) > 30
    assert len(PORT_BENCHMARKS) >= 2
    probe = ROOT / "src" / "repro_torch" / "serve" / "engine.py"
    assert "repro_torch" in _imported_roots(probe)
    assert "torch" in _imported_roots(probe)
    # every port module is walked, the persistence tier and cluster too
    names = {p.relative_to(ROOT / "src").as_posix() for p in PORT_FILES}
    assert {"repro_torch/placement/persist.py",
            "repro_torch/checkpoint/ckpt.py",
            "repro_torch/cluster/transport.py",
            "repro_torch/launch/mesh.py",
            "repro_torch/sharding/specs.py"} <= names


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_cuda_entry_points_raise_without_a_card():
    _no_card()
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.convert import params_from_reference
    from repro_torch.device import resolve
    from repro_torch.launch import serve
    from repro_torch.models.lm import LM
    from repro_torch.placement.arbiter import (DomainArbiter, DomainSpec,
                                               Priority)
    from repro_torch.placement.fabric import MemoryFabric
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain
    from repro_torch.serve.engine import ServeEngine

    from benchmarks import torch_obs_bench, torch_scheduler_bench

    cfg = registry.get_smoke_config("qwen2-0.5b")
    doms = [MemoryDomain("hbm_local", 8, 819.0, True)]
    calls = [
        lambda: resolve("cuda"),
        lambda: resolve(),
        lambda: BwapPagePool(cfg, doms),
        lambda: MemoryFabric(cfg, doms),
        lambda: DomainArbiter([DomainSpec("hbm_local", 8, 819.0)]).register(
            "A", cfg, priority=Priority.HIGH, share=1.0),
        lambda: LM(cfg).init(torch.Generator().manual_seed(0)),
        lambda: params_from_reference({"w": np.zeros(3, np.float32)}),
        lambda: serve.main(["--requests", "1", "--new", "1"]),
        lambda: torch_scheduler_bench.main([]),
        lambda: torch_scheduler_bench.coda_compare(),
        lambda: torch_scheduler_bench.persist_compare(),
        lambda: torch_scheduler_bench.disagg_compare(),
        lambda: torch_obs_bench.main([]),
        lambda: torch_obs_bench.calibration_loop(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    pool = BwapPagePool(cfg, doms, device="cpu")
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params, pool)


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    _no_card()
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
