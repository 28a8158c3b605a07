"""Wrapper of the hand-written CUDA row-invariant weight product
(``repro_torch/csrc/rowwise_matmul.cu``), bound with ctypes.

It replaces no Pallas kernel: the reference leaves the decoder's weight
products to XLA. It serves ``PagedDecoder._mm`` on a card, so that a row's
bits do not depend on how many rows share the launch (a decode step, a
speculative verify chunk, a ``coda`` micro-batch) and speculation stays
token-identical to greedy decode. Two instances, chosen by dtype only:
bf16 on the tensor cores (``mma.sync``, fp32 accumulators, bf16 out) and
fp32 on the CUDA cores (one ``fmaf`` a k). Both walk K in ascending order
with one block shape for every M; there is no split-K.

The weight ``w [K, N]`` is the transpose of a contiguous ``[N, K]``: a
tied head's ``embed.T`` as it is, so the vocabulary matrix is never
copied, and the decoder's projections as ``ops.weight`` stores them on a
card.

The wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on the current CUDA stream, raises if the launch reports an
error, and adds one to ``LAUNCHES["rowwise_matmul"]`` and to the entry of
the instance that ran. There is no fallback: a CPU tensor or a shape the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches, in total and per instance; chip_smoke.py zeroes and reads them
LAUNCHES = {"rowwise_matmul": 0, "rowwise_mma_bf16": 0, "rowwise_fma_f32": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def instance(dtype) -> str:
    """The ``LAUNCHES`` key of the instance that serves ``dtype``."""
    return "rowwise_mma_bf16" if dtype == torch.bfloat16 else \
        "rowwise_fma_f32"


def _entry():
    fn = build.library("rowwise_matmul").bwap_rowwise_matmul
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 3 + [ci] * 4 + [vp]
        fn.restype = ci
    return fn


def check_weight(w: torch.Tensor) -> None:
    """Raises unless ``w [K, N]`` is the transpose of a contiguous
    ``[N, K]``, the one layout the kernel reads."""
    if w.dim() != 2:
        raise ValueError(f"weight must be 2-d, got {tuple(w.shape)}")
    if not w.t().is_contiguous():
        raise ValueError(f"weight strides {w.stride()}: need the transpose "
                         f"of a contiguous [N, K] (ops.weight lays it out)")


def rowwise_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ w [K, N] -> [..., N]`` in ``a``'s dtype; ``w`` the
    transpose of a contiguous ``[N, K]``."""
    if not a.is_cuda or w.device != a.device:
        raise ValueError("the CUDA row-invariant product needs CUDA tensors "
                         f"on one device (a {a.device}, w {w.device})")
    if a.dtype not in _DTYPES or w.dtype != a.dtype:
        raise ValueError(f"dtypes a {a.dtype}, w {w.dtype}: need one of "
                         f"float32/bfloat16, alike")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    check_weight(w)
    k, n = w.shape
    if a.shape[-1] != k:
        raise ValueError(f"a {tuple(a.shape)} @ w {tuple(w.shape)}: inner "
                         f"dims differ")
    m = a.numel() // k
    if a.dtype == torch.bfloat16 and (n % 8 or k % 8):
        raise ValueError(f"bf16 product [{m}, {k}] @ [{k}, {n}]: N and K "
                         f"must be multiples of 8")
    out = torch.empty(*a.shape[:-1], n, dtype=a.dtype, device=a.device)
    if m == 0:
        return out
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _entry()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                   _DTYPES[a.dtype], stream)
    if err != 0:
        raise RuntimeError(f"row-invariant product launch failed: error "
                           f"{err} (m {m}, n {n}, k {k})")
    LAUNCHES["rowwise_matmul"] += 1
    LAUNCHES[instance(a.dtype)] += 1
    return out
