"""repro_torch's speculative decode against the reference engine, live, on
a short cut of ``serve_bench.speculative_compare``'s trace: the same
tokens, decode steps, drafted/accepted tokens, virtual clock and page ids
every step, with the exact rollback leaving the fabric's invariants intact.
Helpers and params come from ``test_torch_serve.py``.
"""

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from test_torch_serve import (_run, assert_same_run,  # noqa: E402
                              load_smoke, short_trace_of)


def test_spec_engine_identical_to_reference_engine():
    cfg, params, tcfg, tparams = load_smoke()
    want = _run(False, cfg, params, short_trace_of(cfg), spec=True)
    got = _run(True, tcfg, tparams, short_trace_of(tcfg), spec=True)
    assert_same_run(got, want)
    assert got["spec"]["accepted"] > 0
    # speculation never changes tokens: the port's greedy run agrees
    greedy = _run(True, tcfg, tparams, short_trace_of(tcfg), spec=False)
    assert greedy["tokens"] == got["tokens"]
    assert got["decode_steps"] < greedy["decode_steps"]
