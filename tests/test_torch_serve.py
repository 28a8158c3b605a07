"""repro_torch's serving engine against the reference engine at the smoke
config (1 layer, fp32, ``wall_clock=False``) on
``benchmarks/serve_bench.speculative_compare``'s repetition-friendly trace.

Both engines get the same params (drawn by the reference, crossing through
numpy) and the same trace. Greedy and speculative runs must give the same
tokens, decode steps, drafted/accepted tokens, prefill forward tokens,
virtual clock and — step by step — the same page ids.

The reference params are drawn with ``jax.threefry_partitionable(False)``,
the jax PRNG default before jax 0.5, under which ``BENCH_serve.json`` was
recorded; the full-trace test, through the port's benchmark
(``benchmarks/torch_serve_bench.py``), then reproduces that artifact's
counters exactly. The live engine-vs-engine comparison runs a shorter cut
of the same trace: the reference engine recompiles its jitted ops for
every new shape and takes minutes on the full trace. The speculative half
of that comparison is in ``test_torch_spec.py``.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")

from benchmarks import torch_serve_bench  # noqa: E402
import repro.placement.pool as r_pool  # noqa: E402
import repro.scheduler as r_sched  # noqa: E402
import repro.serve.engine as r_engine  # noqa: E402
import repro_torch.placement.pool as t_pool  # noqa: E402
import repro_torch.scheduler as t_sched  # noqa: E402
import repro_torch.serve.engine as t_engine  # noqa: E402
from repro.configs import registry  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro.serve.spec import PromptLookupDrafter  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.dwp import DWPConfig  # noqa: E402
from repro_torch.models import config as t_config  # noqa: E402
from repro_torch.serve import spec as t_spec  # noqa: E402

BENCH = Path(__file__).resolve().parents[1] / "BENCH_serve.json"


def load_smoke():
    """(reference cfg, reference params, port cfg, port params)."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    with jax.threefry_partitionable(False):
        params = LM(cfg).init(jax.random.PRNGKey(0))
    tcfg = t_config.ModelConfig(**dataclasses.asdict(cfg))
    tparams = params_from_reference(jax.tree.map(np.asarray, params),
                                    device="cpu")
    return cfg, params, tcfg, tparams


@pytest.fixture(scope="module")
def setup():
    return load_smoke()


def short_trace_of(cfg):
    """A cut of the trace short enough for the live reference engine that
    still accepts a draft (2 requests, 4 new tokens each)."""
    return _trace(cfg, requests=2, max_new=4)


def _trace(cfg, requests=6, max_new=32):
    return r_sched.generate(r_sched.WorkloadSpec(
        kind="poisson", num_requests=requests, mean_interarrival_s=0.05,
        prompt_mean=16, prompt_max=28, max_new=max_new,
        vocab_size=cfg.vocab_size, seed=0, prompt_loop_len=4))


def _run(port: bool, cfg, params, trace, *, spec: bool, **eng_kw) -> dict:
    """serve_bench._run on either package; records page ids every step."""
    pool_m, sched_m, eng_m = ((t_pool, t_sched, t_engine) if port
                              else (r_pool, r_sched, r_engine))
    dev = {"device": "cpu"} if port else {}
    drafter = None
    if spec:
        drafter = (t_spec.PromptLookupDrafter if port
                   else PromptLookupDrafter)(max_tokens=6, max_ngram=3)
    domains = [pool_m.MemoryDomain("hbm_local", 64, 819.0, True),
               pool_m.MemoryDomain("hbm_peer_1hop", 64, 0.05, False),
               pool_m.MemoryDomain("host_dram", 64, 0.016, False)]
    pool = pool_m.BwapPagePool(cfg, domains, page_size=4,
                               dwp_config=DWPConfig(n=10 ** 6, c=1), **dev)
    sched = sched_m.RequestScheduler(pool, max_batch=len(trace),
                                     prefill_token_budget=64,
                                     default_max_new=32)
    eng = eng_m.ServeEngine(cfg, params, pool, scheduler=sched,
                            wall_clock=False, sim_step_s=0.005,
                            drafter=drafter, **eng_kw, **dev)
    for t in trace:
        eng.submit(t.prompt, max_new=t.max_new, arrival_s=t.arrival_s)
    pages = []
    while eng.active or eng.waiting:
        eng.step()
        pages.append([(s.sid, [int(p) for p in s.pages])
                      for s in eng.active])
        assert len(pages) < 2000
    eng.view.fabric.check_invariants()
    return {"tokens": {s.sid: list(s.tokens) for s in eng.finished},
            "finished": len(eng.finished),
            "decode_steps": eng.decode_steps,
            "prefill_fwd_tokens": eng.prefill_tokens_computed,
            "spec": pool.telemetry.snapshot()["spec"],
            "makespan_s": sched.now, "pages": pages,
            "free": pool.free_count()}


def test_full_trace_reproduces_bench_serve_json(setup):
    """The port's benchmark (``torch_serve_bench.speculative_compare``,
    with the reference's gates on) on the reference's params reproduces
    ``BENCH_serve.json``'s counters exactly."""
    _, _, tcfg, tparams = setup
    bench = json.loads(BENCH.read_text())
    rows = torch_serve_bench.speculative_compare(params=tparams,
                                                 device="cpu")
    greedy, spec = rows["greedy"], rows["speculative"]
    assert rows["token_identical"] is True
    for got, want in ((greedy, bench["greedy"]),
                      (spec, bench["speculative"])):
        assert got["finished"] == want["finished"] == got["requests"] == 6
        assert got["decode_steps"] == want["decode_steps"]
        assert got["prefill_fwd_tokens"] == want["prefill_fwd_tokens"]
        assert got["makespan_s"] == want["makespan_s"]
        for k in ("drafted", "accepted", "emitted", "steps"):
            assert got["spec"][k] == want["spec"][k], k
    assert (greedy["decode_steps"], spec["decode_steps"]) == (65, 48)
    assert (spec["spec"]["drafted"], spec["spec"]["accepted"]) == (267, 84)
    assert greedy["prefill_fwd_tokens"] == spec["prefill_fwd_tokens"] == 94
    assert rows["decode_step_ratio"] == bench["decode_step_ratio"]


def assert_same_run(got: dict, want: dict) -> None:
    assert got["tokens"] == want["tokens"]
    assert got["pages"] == want["pages"]          # page ids, every step
    for k in ("finished", "decode_steps", "prefill_fwd_tokens", "spec",
              "makespan_s", "free"):
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def reference_greedy(setup):
    cfg, params, _, _ = setup
    return _run(False, cfg, params, short_trace_of(cfg), spec=False)


def test_greedy_engine_identical_to_reference_engine(setup,
                                                     reference_greedy):
    _, _, tcfg, tparams = setup
    got = _run(True, tcfg, tparams, short_trace_of(tcfg), spec=False)
    assert_same_run(got, reference_greedy)


def test_recompute_prefill_gives_the_same_tokens(setup, reference_greedy):
    _, _, tcfg, tparams = setup
    got = _run(True, tcfg, tparams, short_trace_of(tcfg), spec=False,
               incremental_prefill=False)
    want = reference_greedy
    assert got["tokens"] == want["tokens"]
    assert got["pages"] == want["pages"]
    assert got["decode_steps"] == want["decode_steps"]
    # recompute bills the whole prefix per chunk: more forward tokens
    assert got["prefill_fwd_tokens"] >= want["prefill_fwd_tokens"]


def test_engine_refuses_what_is_not_ported(setup):
    """Re-homing is ported: ``rehome=True`` and the ``coda`` policy's
    default build an engine. A pool on another device than the engine's
    is still refused."""
    _, _, tcfg, tparams = setup
    pool = t_pool.BwapPagePool(
        tcfg, [t_pool.MemoryDomain("hbm_local", 16, 819.0, True)],
        page_size=4, device="cpu")
    assert t_engine.ServeEngine(tcfg, tparams, pool, rehome=True,
                                device="cpu").rehome
    coda = t_pool.BwapPagePool(
        tcfg, [t_pool.MemoryDomain("hbm_local", 16, 819.0, True)],
        page_size=4, policy="coda", device="cpu")
    eng = t_engine.ServeEngine(tcfg, tparams, coda, device="cpu")
    assert eng.rehome and eng.rehome_budget_frac == 0.5
    with pytest.raises(ValueError, match="pool on cpu"):
        t_engine.ServeEngine(tcfg, tparams, pool, device="meta")
