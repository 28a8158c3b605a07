"""The correctness check on the port's CPU path at smoke size: the port
agrees with the float32 reference, and the check comes out false for the
control (the reference in float8) and for each fault planted in the timed
path. Also: the harness refuses to run without a card, and without the
program beside it."""

from __future__ import annotations

import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import run
from bench.tests import smoke_cell

ROOT = Path(run.__file__).resolve().parents[1]
CELLS = ["vl7b.chat", "q05b.longctx"]


def _run(name, fault=None, control=False,
         served=smoke_cell.SERVED_TOKENS):
    from bench import cell
    wl = cell.workload(name)
    t = smoke_cell.traffic(name)
    rec = run.run_cell(name, smoke_cell.config(wl["config"]), t, 2**31 + 9,
                       0.6, False, device="cpu", fault=fault,
                       control=control, trace_s=smoke_cell.TRACE_S,
                       served_tokens=served)
    return rec, t, run.result(rec, cell.metrics_of(name, "end_to_end"), t)


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_and_control_fails(name):
    rec, t, res = _run(name, control=True)
    limit = t["limit_max_logit_gap"]
    assert rec["check"]["served_tokens"] >= smoke_cell.SERVED_TOKENS
    assert res["correct"], rec["check"]
    assert rec["check"]["control_max_gap"] > limit, rec["check"]
    assert list(res)[-1] == "checks"
    assert res["checks"]["max_logit_gap"]["limit"] == limit
    assert {"output_tok_s", "setup_s"} <= set(res["metrics"])


def _token(eng):
    """A token altered where it is produced."""
    dec = eng.decoder
    orig = dec.decode_step
    dec.decode_step = lambda *a: orig(*a).roll(1, dims=-1)


def _state(eng):
    """A step that leaves its state unchanged: decode writes no K/V."""
    eng.view.write_decode_batch = lambda *a, **kw: None


def _half(eng):
    """Half of the batch left out: its rows take the other half's."""
    dec = eng.decoder
    orig = dec.decode_step

    def half(tokens, tables, lens, positions):
        b = tokens.shape[0]
        h = (b + 1) // 2
        out = orig(tokens[:h], tables[:h], lens[:h], positions[:h])
        return torch.cat([out, out[:b - h]])
    dec.decode_step = half


@pytest.mark.parametrize("name", ["vl7b.chat", "q05b.longctx"])
@pytest.mark.parametrize("fault", [_token, _state, _half],
                         ids=["token", "state", "half"])
def test_fault_fails_the_check(name, fault):
    rec, t, res = _run(name, fault=fault, served=40)
    assert rec["check"]["served_tokens"] >= 40     # a comparison was made
    assert not res["correct"], rec["check"]


def test_sweep_runs_one_rate():
    """The knee sweep's row at smoke size: every reading it prints is there
    and prints as JSON. A reading may be None where a loaded host's slow
    steps leave the short window too little to read (no request with two
    tokens in it), never missing or raising."""
    import json
    from bench import cell, sweep, weights
    wl = cell.workload("vl7b.chat")
    conf = smoke_cell.config(wl["config"])
    t = smoke_cell.traffic("vl7b.chat")
    params = weights.make(conf["model"], 5, torch.device("cpu"))
    row = sweep.one_rate(conf, t, params, 4.0, 5, 2.0, 0.3, "cpu")
    assert row["rate"] == 4.0 and row["failed"] == 0 and row["attempted"]
    for k in ("output_tok_s", "prefill_tok_s", "ttft_p95_ms",
              "tpot_p95_ms", "decode_batch_mean", "step_ms",
              "lateness_p95_ms", "pending_slope_per_s"):
        assert row[k] is None or math.isfinite(row[k]), k
    assert row["output_tok_s"] >= 0 and row["ttft_p95_ms"] is not None
    assert isinstance(row["sustained"], bool)
    json.dumps(row, allow_nan=False)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         "vl7b.chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_bench_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: the
    program is missing, and the run says so before it looks for a card."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "vl7b.chat", "--seed",
         "1", "--seconds", "1", "--trace", "0"], capture_output=True,
        text=True, timeout=120, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr


def test_cell_on_the_card():
    """One short run of a cell on the card (run there by
    ``python -m pytest bench/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "q05b.longctx",
         "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
