"""Plain PyTorch version of the row-invariant RMSNorm: the model's own
``layers.rmsnorm`` (on the CPU a row's sum does not depend on the row
count)."""

from __future__ import annotations

from repro_torch.models.layers import rmsnorm as rmsnorm_ref

__all__ = ["rmsnorm_ref"]
