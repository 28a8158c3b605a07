"""The row-invariant weight product, dispatched by device: a CUDA tensor
runs the hand-written CUDA kernel, a CPU tensor the plain PyTorch version
(the rule of ``repro_torch.kernels.use_kernel`` with ``impl=None``; the
decoder has no other choice to make, and tests and ``chip_smoke.py`` call
``kernel`` and ``ref`` directly)."""

from __future__ import annotations

from repro_torch.kernels import use_kernel
from repro_torch.kernels.rowwise_matmul import kernel
from repro_torch.kernels.rowwise_matmul.ref import rowwise_matmul_ref


def weight(w):
    """``w [K, N]`` laid out as :func:`rowwise_matmul` takes it on ``w``'s
    device: on a card the transpose of a contiguous ``[N, K]`` (one copy,
    unless it is so already, as a tied head's ``embed.T`` is), on the CPU
    as it is."""
    if use_kernel(None, w) and not w.t().is_contiguous():
        return w.t().contiguous().t()
    return w


def rowwise_matmul(a, w):
    """``a [..., K] @ w [K, N] -> [..., N]``, each row rounded as if it
    were alone. On a card ``w`` is laid out by :func:`weight`."""
    if use_kernel(None, a):
        return kernel.rowwise_matmul(a, w)
    return rowwise_matmul_ref(a, w)
