"""A traced serving run (``benchmarks/obs_bench.py``'s ``_overhead_run``
trace: bursty, 10 requests, preemptions with KV swap) on both packages:
the reference with the observatory, the port
(``benchmarks/torch_obs_bench.py``, on the CPU, with the reference's params)
with and without it. Tokens are identical across the three runs, and the
port's trace events, span counts and observatory snapshot equal the
reference's."""

import dataclasses

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import smoke_pair  # noqa: E402
from benchmarks import obs_bench as r_bench  # noqa: E402
from benchmarks import torch_obs_bench as t_bench  # noqa: E402


@pytest.fixture(scope="module")
def smoke():
    return smoke_pair()


@pytest.fixture(scope="module")
def traced(smoke):
    """``_overhead_run``'s trace: the reference with the observatory, the
    port with and without it."""
    (cfg, params), (tcfg, tparams) = smoke[False], smoke[True]
    trace = t_bench.overhead_trace(tcfg.vocab_size)
    r_trace = r_bench.generate(r_bench.WorkloadSpec(
        kind="bursty", num_requests=10, mean_interarrival_s=0.01,
        prompt_mean=24, prompt_max=40, max_new=16,
        vocab_size=cfg.vocab_size,
        class_mix=(("interactive", 0.25), ("batch", 0.75)), seed=0))
    assert [dataclasses.asdict(t) for t in trace] \
        == [dataclasses.asdict(t) for t in r_trace]
    _, r_tokens, r_obs = r_bench._overhead_run(cfg, params, r_trace,
                                               with_obs=True)
    _, base, _ = t_bench.overhead_run(tcfg, tparams, trace, with_obs=False,
                                      device="cpu")
    _, tokens, obs = t_bench.overhead_run(tcfg, tparams, trace,
                                          with_obs=True, device="cpu")
    return r_tokens, r_obs, base, tokens, obs


def test_traced_run_is_token_identical_to_untraced_and_reference(traced):
    r_tokens, _, base, tokens, _ = traced
    assert tokens == base == r_tokens


def test_traced_run_events_and_spans_equal_the_reference(traced):
    _, r_obs, _, _, obs = traced
    assert obs.tracer.events == r_obs.tracer.events
    names = ("admit", "queued", "prefill", "decode", "swap_out", "swap_in",
             "finish")
    counts = {n: len(obs.tracer.spans(n)) for n in names}
    assert counts == {n: len(r_obs.tracer.spans(n)) for n in names}
    preempted = sorted({e["tid"] - 1 for e in obs.tracer.spans("swap_out")})
    assert preempted, "workload produced no preemption to trace"
    for name in ("admit", "prefill", "decode", "swap_out", "swap_in",
                 "finish"):
        assert obs.tracer.spans(name, sid=preempted[0])
    assert obs.snapshot() == r_obs.snapshot()


