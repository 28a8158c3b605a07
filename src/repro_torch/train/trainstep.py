"""Step factories (port of ``repro.train.trainstep``).

Only ``make_eval_step`` is ported: the loss of a full-sequence forward,
which on a card runs every layer's attention through the CUDA
flash-attention kernel. The optimizer (``train/optimizer.py``),
``opt_config_for``, ``make_train_step`` and gradient accumulation wait for
the training slice (ROADMAP queue 1 item 14).
"""

from __future__ import annotations


def make_eval_step(model):
    """(params, batch) -> {"ce", "aux", "loss"}: ``model.loss`` and its
    metrics, as the reference's eval step returns them."""
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return {**metrics, "loss": loss}
    return eval_step
