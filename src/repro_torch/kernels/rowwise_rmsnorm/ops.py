"""The fused residual add + row-invariant RMSNorm, dispatched by device as
``kernels/rowwise_matmul/ops.py``: the CUDA kernel for a CUDA tensor, the
plain version for a CPU one."""

from __future__ import annotations

from repro_torch.kernels import use_kernel
from repro_torch.kernels.rowwise_rmsnorm import kernel
from repro_torch.kernels.rowwise_rmsnorm.ref import (add_rmsnorm_ref,
                                                     rmsnorm_ref)


def add_rmsnorm(x, y, gamma, eps: float = 1e-6):
    """``(s, h)``: ``s = x + y`` in ``x``'s dtype, ``h = s * rsqrt(mean(s^2,
    -1) + eps) * (1 + gamma)`` in fp32, in ``x``'s dtype; each row summed
    in an order that does not depend on how many rows share the call. ``y``
    must match ``x`` in shape, dtype and device."""
    kernel.check_pair(x, y)
    if use_kernel(None, x):
        return kernel.add_rmsnorm(x, y, gamma, eps)
    return add_rmsnorm_ref(x, y, gamma, eps)


def rmsnorm(x, gamma, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2, -1) + eps) * (1 + gamma)`` in fp32, in
    ``x``'s dtype: ``add_rmsnorm``'s ``h`` without ``y``."""
    if use_kernel(None, x):
        return kernel.rmsnorm(x, gamma, eps)
    return rmsnorm_ref(x, gamma, eps)
