"""Wrapper of the hand-written CUDA row-invariant RMSNorm
(``repro_torch/csrc/rowwise_rmsnorm.cu``), bound with ctypes.

It replaces no Pallas kernel. On a card, PyTorch's reduction behind
``layers.rmsnorm`` sums a row in an order chosen by the row count, so a
decode step and a verify chunk normalised one position differently; this
kernel sums each row in one fixed order (a block a row). It serves
``PagedDecoder``'s norms on a card, beside ``kernels/rowwise_matmul``.

The wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on the current CUDA stream, raises if the launch reports an
error, and adds one to ``LAUNCHES["rowwise_rmsnorm"]``. There is no
fallback: a CPU tensor raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# chip_smoke.py zeroes and reads them
LAUNCHES = {"rowwise_rmsnorm": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry():
    fn = build.library("rowwise_rmsnorm").bwap_rowwise_rmsnorm
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 3 + [ci] * 2 + [ctypes.c_float, ci, ci, vp]
        fn.restype = ci
    return fn


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] (fp32 or bf16, contiguous), gamma [d] (fp32 or bf16)
    -> [..., d] in x's dtype."""
    if not x.is_cuda or gamma.device != x.device:
        raise ValueError("the CUDA row-invariant RMSNorm needs CUDA tensors "
                         f"on one device (x {x.device}, gamma "
                         f"{gamma.device})")
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES:
        raise ValueError(f"dtypes x {x.dtype}, gamma {gamma.dtype}: need "
                         f"float32 or bfloat16")
    d = x.shape[-1]
    if not x.is_contiguous() or not gamma.is_contiguous() \
            or tuple(gamma.shape) != (d,):
        raise ValueError(f"x {tuple(x.shape)} and gamma "
                         f"{tuple(gamma.shape)} must be contiguous, gamma "
                         f"[{d}]")
    out = torch.empty_like(x)
    m = x.numel() // d if d else 0
    if m == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), gamma.data_ptr(), out.data_ptr(), m, d,
                   float(eps), _DTYPES[x.dtype], _DTYPES[gamma.dtype], stream)
    if err != 0:
        raise RuntimeError(f"row-invariant RMSNorm launch failed: error "
                           f"{err} (m {m}, d {d})")
    LAUNCHES["rowwise_rmsnorm"] += 1
    return out
