"""``examples/torch_train_lm.py`` on the CPU (``--device cpu``) against
``examples/train_lm.py``, run live in the same process for 10 steps, each
with its own checkpoint directory: the port prints the reference's lines,
but for the loss values and times (the packages draw different initial
params; the trainer's step lines, every 20 steps, are held in
``test_torch_train.py``). A second run of the port's example resumes from
its checkpoint.

The data are uniform random tokens, so no model can beat the uniform
predictor's log(vocab) in expectation on fresh batches (Gibbs'
inequality): both final losses are held within 0.1 of log(vocab), the
level an untrained tied-embedding model starts from and a trained one
settles at (both packages end 8.33-8.36 against 8.32 at 3-40 steps).
"""

import math
import re

import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from _torch_parity import run_example  # noqa: E402

VOCAB = 4096                      # the example's tiny preset
_NUM = re.compile(r"(loss|time) [\d.]+|[\d.]+ ms")


@pytest.fixture(autouse=True)
def one_thread():
    """The port's small CPU ops run on one thread: beside the other test
    workers, torch's intra-op threads only contend."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masked(out: str) -> list[str]:
    return [_NUM.sub(r"\1 #", ln) for ln in out.splitlines()]


def _final_loss(out: str) -> float:
    m = re.search(r"final loss ([\d.]+)", out)
    assert m, out
    return float(m.group(1))


def test_port_prints_the_reference_lines(tmp_path):
    argv = ["--steps", "10"]
    ref = run_example("train_lm.py", [*argv, "--ckpt", str(tmp_path / "r")],
                      port=False)
    port = run_example("train_lm.py", [*argv, "--ckpt", str(tmp_path / "t")],
                       port=True)
    assert len(_masked(ref)) == 3, ref
    assert _masked(port) == _masked(ref)
    for out in (ref, port):
        assert abs(_final_loss(out) - math.log(VOCAB)) <= 0.1, out
    again = run_example("train_lm.py",
                        ["--steps", "11", "--ckpt", str(tmp_path / "t")],
                        port=True)
    assert "resumed from checkpoint at step 10" in again
    assert "done at step 11" in again
