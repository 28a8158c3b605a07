"""``examples/torch_serve_paged.py`` on the CPU (``--device cpu``) against
``examples/serve_paged.py``, run live in the same process: the
oversubscribed trace and the ``--restart-demo`` print the reference's
summary lines. The schedule runs on the virtual clock, so every counter,
time and occupancy is equal; only the token-snippet lines differ, because
each package draws its own random weights. The counters are then checked
once more as numbers: every sequence finishes through swaps out and back
in, and the restart hits the restored trie. ``examples/torch_coscheduled.py``
is held in ``tests/test_torch_coscheduled_example.py``."""

import re

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import example_summary, run_example  # noqa: E402

ARGV = {"serve_paged": (), "restart_demo": ("--restart-demo",)}


@pytest.fixture(scope="module")
def runs():
    """{case: (reference output, port output)}, each run once."""
    return {case: (run_example("serve_paged.py", argv, port=False),
                   run_example("serve_paged.py", argv, port=True))
            for case, argv in ARGV.items()}


@pytest.mark.parametrize("case", list(ARGV))
def test_port_prints_the_reference_summary(runs, case):
    ref, port = runs[case]
    assert len(example_summary(ref)) >= 2, ref
    assert example_summary(port) == example_summary(ref)


def test_serve_paged_finishes_every_sequence_through_swaps(runs):
    out = runs["serve_paged"][1]
    m = re.search(r"finished (\d+)/(\d+) sequences in ([\d.]+) virtual s; "
                  r"swaps (\d+) out / (\d+) in", out)
    assert m, out
    done, total, secs, outs, ins = m.groups()
    assert done == total == "10" and outs == ins == "32", out
    assert secs == "1.57"
    assert "prefix hits 10 pages" in out


def test_serve_paged_restart_demo_hits_the_restored_trie(runs):
    out = runs["restart_demo"][1]
    assert "exported 1 chain(s) (12 pages)" in out
    assert "the first request matched 12 pages from the restored trie" in out
