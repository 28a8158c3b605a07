"""``chip_smoke.py``'s phase 23 on the CPU: the six engine scenarios of
the reference's page-table, scheduler and speculation tests
(``phase_contract``) with a two-layer bf16 smoke model in place of the
full-width one and the plain paged versions in place of the kernels,
counted as launches where the query is bf16 (the host runs of the
scenarios, at the fp32 smoke config, launch none). Every gate of the phase
runs: bytes that move or roll back equal bit for bit, the control plane
equal to the smoke run's, the launches equal to the steps' kinds times
the layers. Torch runs on one thread here: beside other test workers its
many small CPU ops otherwise oversubscribe the cores."""

import dataclasses
import sys
from pathlib import Path

import torch

import repro_torch.kernels.flash_attention.kernel as fk
import repro_torch.kernels.flash_attention.ops as fo
import repro_torch.kernels.paged_attention.kernel as k
import repro_torch.kernels.paged_attention.ops as o
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


def test_phase_contract_on_the_host(monkeypatch):
    for name, mod in (("torch", torch), ("kernel", k), ("ops", o),
                      ("fkernel", fk), ("fops", fo)):
        monkeypatch.setattr(cs, name, mod, raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(cs, "smi_line", lambda: "host")
    for name in ("paged_attention", "paged_prefill_attention_batch"):
        monkeypatch.setattr(o, name, _counting(name, getattr(o, name)))
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=2, compute_dtype="bfloat16")
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = cs.phase_contract("cpu", cfg, params)["launches"]
    finally:
        torch.set_num_threads(threads)
    # 24 prefill, 31 verify and 411 decode steps, two layers each
    assert out["paged_prefill_attention_batch"] == (24 + 31) * 2
    assert out["paged_attention"] == 411 * 2
    assert out["paged_walk"] == (24 + 31 + 411) * 2
