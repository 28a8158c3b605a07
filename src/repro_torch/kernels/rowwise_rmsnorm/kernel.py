"""Wrapper of the hand-written CUDA fused residual add + row-invariant
RMSNorm (``repro_torch/csrc/rowwise_rmsnorm.cu``), bound with ctypes.

It replaces no Pallas kernel: it is the port's counterpart of the add and
norm that XLA fuses in the reference decoder. On a card, PyTorch's
reduction behind ``layers.rmsnorm`` sums a row in an order chosen by the
row count, so a decode step and a verify chunk normalised one position
differently; this kernel sums each row in one order fixed by its width
and dtype (``layout``). It serves ``PagedDecoder``'s norms on a card,
beside ``kernels/rowwise_matmul``, and adds the residual that precedes
each of them in the same launch.

``add_rmsnorm(x, y, gamma)`` returns ``(x + y, norm(x + y))``;
``rmsnorm(x, gamma)`` is the launch without ``y``. The wrappers check
their inputs, allocate the outputs with ``torch.empty``, launch on the
current CUDA stream, raise if the launch reports an error, and add one to
``LAUNCHES["rowwise_rmsnorm"]`` (every launch) and, for a launch with
``y``, to ``LAUNCHES["rowwise_add_rmsnorm"]``. There is no fallback: a CPU
tensor, a ``y`` unlike ``x``, a pointer misaligned for the vector layout
or a width the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16                    # a chunk: one 16-byte load a thread
CPTS = (1, 2, 4, 8)               # chunks a thread, as the kernel is built
MAX_THREADS = 256                 # the kernel's launch bound

# chip_smoke.py zeroes and reads them
LAUNCHES = {"rowwise_rmsnorm": 0, "rowwise_add_rmsnorm": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def layout(d: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(elements a chunk, chunks a thread, threads a block) for a row of
    ``d`` elements of ``dtype``: 16-byte chunks where ``d`` splits into
    them, else chunks of one element; the fewest chunks a thread that keep
    a block within ``MAX_THREADS``, threads rounded up to whole warps. It
    fixes the order of a row's sum, so it takes no row count."""
    vec = VEC_BYTES // dtype.itemsize
    if d % vec:
        vec = 1
    nv = d // vec
    for cpt in CPTS:
        threads = -(-nv // cpt)
        if threads <= MAX_THREADS:
            return vec, cpt, -(-threads // 32) * 32
    raise ValueError(f"row-invariant RMSNorm: width {d} in {dtype} is past "
                     f"the kernel's {MAX_THREADS} threads x {CPTS[-1]} "
                     f"chunks of {vec} elements")


def _entry():
    fn = build.library("rowwise_rmsnorm").bwap_rowwise_rmsnorm
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 5 + [ci] * 2 + [ctypes.c_float] + [ci] * 5 \
            + [vp]
        fn.restype = ci
    return fn


def check_pair(x: torch.Tensor, y: torch.Tensor) -> None:
    """``y`` must be what ``x`` is: shape, dtype and device."""
    if y.shape != x.shape or y.dtype != x.dtype or y.device != x.device:
        raise ValueError(f"y {tuple(y.shape)} {y.dtype} on {y.device} must "
                         f"match x {tuple(x.shape)} {x.dtype} on {x.device}")


def _launch(x, y, gamma, eps):
    if x.dtype not in _DTYPES or gamma.dtype not in _DTYPES:
        raise ValueError(f"dtypes x {x.dtype}, gamma {gamma.dtype}: need "
                         f"float32 or bfloat16")
    if y is not None:
        check_pair(x, y)
    d = x.shape[-1]
    if not x.is_contiguous() or not gamma.is_contiguous() \
            or (y is not None and not y.is_contiguous()) \
            or tuple(gamma.shape) != (d,):
        raise ValueError(f"x {tuple(x.shape)}, y and gamma "
                         f"{tuple(gamma.shape)} must be contiguous, gamma "
                         f"[{d}]")
    vec, cpt, threads = layout(d, x.dtype)
    if vec > 1:
        # the vector layout reads 16 bytes of x and y, and gamma's part of
        # a chunk, at once; any other path would sum in another order
        need = {"x": (x, VEC_BYTES), "y": (y, VEC_BYTES),
                "gamma": (gamma, min(VEC_BYTES, vec * gamma.itemsize))}
        for name, (t, align) in need.items():
            if t is not None and t.data_ptr() % align:
                raise ValueError(
                    f"row-invariant RMSNorm: {name} at {t.data_ptr():#x} is "
                    f"not {align}-byte aligned, as the vector layout of "
                    f"width {d} needs")
    if not x.is_cuda or gamma.device != x.device:
        raise ValueError("the CUDA row-invariant RMSNorm needs CUDA tensors "
                         f"on one device (x {x.device}, gamma "
                         f"{gamma.device})")
    h = torch.empty_like(x)
    s = torch.empty_like(x) if y is not None else None
    m = x.numel() // d if d else 0
    if m == 0:                   # no rows, or rows of no elements
        return s, h
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), None if y is None else y.data_ptr(),
                   gamma.data_ptr(), None if s is None else s.data_ptr(),
                   h.data_ptr(), m, d, float(eps), _DTYPES[x.dtype],
                   _DTYPES[gamma.dtype], vec, cpt, threads, stream)
    if err != 0:
        raise RuntimeError(f"row-invariant RMSNorm launch failed: error "
                           f"{err} (m {m}, d {d}, layout {vec}, {cpt}, "
                           f"{threads})")
    LAUNCHES["rowwise_rmsnorm"] += 1
    if y is not None:
        LAUNCHES["rowwise_add_rmsnorm"] += 1
    return s, h


def add_rmsnorm(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """x, y [..., d] (one shape and dtype, fp32 or bf16, contiguous), gamma
    [d] (fp32 or bf16) -> (s, h): ``s = x + y`` rounded as torch's add
    rounds it, ``h`` the norm of ``s``, both in x's dtype."""
    return _launch(x, y, gamma, eps)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., d] (fp32 or bf16, contiguous), gamma [d] (fp32 or bf16)
    -> [..., d] in x's dtype: the launch without ``y``."""
    return _launch(x, None, gamma, eps)[1]
