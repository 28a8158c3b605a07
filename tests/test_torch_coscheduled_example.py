"""``examples/torch_coscheduled.py`` on the CPU (``--device cpu``) against
``examples/coscheduled.py``, run live in the same process: the port prints
every line the reference prints (both run on the virtual clock), and its
own gates hold: token identity with isolated partitions, a loan, and the
loan cycle ending with nothing outstanding."""

import re

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import example_summary, run_example  # noqa: E402


@pytest.fixture(scope="module")
def runs():
    """(reference output, port output), each run once."""
    return (run_example("coscheduled.py", port=False),
            run_example("coscheduled.py", port=True))


def test_port_prints_the_reference_summary(runs):
    ref, port = runs
    assert len(example_summary(ref)) >= 10, ref
    assert example_summary(port) == example_summary(ref)


def test_coscheduled_ends_the_loan_cycle(runs):
    out = runs[1]
    assert "token-identical outputs fabric vs isolated: True" in out
    assert re.search(r"swap-slot loan A->B: granted [1-9]\d* slots, .*"
                     r"outstanding 0", out), out
    assert "A's quota 352 -> 399 pages" in out
