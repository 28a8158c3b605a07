"""``chip_smoke.py``'s phase 27 on the CPU: the reference's traced serving
scenario (``tests/test_obs.py``'s ``traced_runs``) with a six-layer bf16
smoke model in place of the full-width one, whose pages hold three times
the bytes of the host run's one-layer fp32 pages (so the phase's Eq.-1
scale is 3 here, 48 on the card), and the plain paged versions in place
of the kernels, counted as launches where the query is bf16. Every gate
of the phase runs: equal tokens with and without the observatory, the
preempted request's spans, the Perfetto rules, the trace equal to the
host run's, the lifecycle counters, the bus contract, the Prometheus
lines and the launches equal to the steps' kinds times the layers."""

import dataclasses
import sys
from pathlib import Path

import torch

import repro_torch.kernels.flash_attention.kernel as fk
import repro_torch.kernels.flash_attention.ops as fo
import repro_torch.kernels.paged_attention.kernel as k
import repro_torch.kernels.paged_attention.ops as o
import repro_torch.kernels.rowwise_matmul.kernel as rk
import repro_torch.kernels.rowwise_rmsnorm.kernel as nk
from repro_torch.configs import registry
from repro_torch.models.lm import LM

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _counting(name, fn):
    def wrapped(q, *a, **kw):
        if q.dtype == torch.bfloat16:
            k.LAUNCHES[name] += 1
            k.LAUNCHES[k.instance(q.dtype, q.shape[-1])] += 1
        return fn(q, *a, **kw)
    return wrapped


def test_phase_obs_on_the_host(monkeypatch):
    for name, mod in (("torch", torch), ("kernel", k), ("ops", o),
                      ("fkernel", fk), ("fops", fo), ("rkernel", rk),
                      ("nkernel", nk)):
        monkeypatch.setattr(cs, name, mod, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(cs, "smi_line", lambda: "host")
    monkeypatch.setattr(cs, "CODA_BW_SCALE", 3)
    for name in ("paged_attention", "paged_prefill_attention_batch"):
        monkeypatch.setattr(o, name, _counting(name, getattr(o, name)))
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=6, compute_dtype="bfloat16")
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    out = cs.phase_obs("cpu", cfg, params)["launches"]
    # 5 prefill and 13 decode steps a run, two runs, six layers each
    assert out["paged_prefill_attention_batch"] == 10 * 6
    assert out["paged_attention"] == 26 * 6
    assert out["paged_walk"] == (10 + 26) * 6
