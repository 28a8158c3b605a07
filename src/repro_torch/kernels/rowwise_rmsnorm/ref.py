"""Plain PyTorch version of the fused residual add + row-invariant RMSNorm:
torch's ``x + y`` and the model's own ``layers.rmsnorm`` (on the CPU a
row's sum does not depend on the row count)."""

from __future__ import annotations

from repro_torch.models.layers import rmsnorm as rmsnorm_ref


def add_rmsnorm_ref(x, y, gamma, eps: float = 1e-6):
    """``(s, h)``: ``s = x + y``, ``h = layers.rmsnorm(s, gamma, eps)``."""
    s = x + y
    return s, rmsnorm_ref(s, gamma, eps)


__all__ = ["add_rmsnorm_ref", "rmsnorm_ref"]
