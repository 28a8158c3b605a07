"""Wrapper of the hand-written CUDA flash-attention kernel
(``repro_torch/csrc/flash_attention.cu``), bound with ctypes.

Replaces the Pallas kernel ``repro.kernels.flash_attention.kernel
.flash_attention_bh``. It takes q [B,S,nq,h] and k/v [B,T,nkv,h] as they
are and passes g = nq / nkv to the kernel, which reads KV head
``head // g``: K/V are not repeated in memory (the reference's wrapper
repeats them). The block sizes and interpret flag of the TPU kernel have no
counterpart. The wrapper checks its inputs, allocates the output with
``torch.empty``, launches on the current CUDA stream, raises if the launch
reports an error, and adds one to the launch count of the instance that
ran (``instance``): ``LAUNCHES["flash_attention_wgmma"]`` for the
tensor-core instance (bf16 at a head dim in ``WGMMA_HEAD_DIMS``: wgmma,
TMA, warp specialisation), ``LAUNCHES["flash_attention"]`` for the CUDA-core
instance (fp32, and bf16 at h = 16, 32). The instance depends on the dtype
and the head dim only. There is no fallback: a CPU tensor or a shape the
kernel does not take raises ``ValueError``, and a failed launch raises
``RuntimeError``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)   # bf16 head dims of the tensor-core instance
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535             # nq and B are grid dimensions y and z

# launches per instance; chip_smoke.py zeroes and reads them
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0}
# the C entry's own error codes (else a cudaError_t)
_ERRORS = {-1: "shape or dtype not taken",
           -2: "the driver has no cuTensorMapEncodeTiled",
           -3: "the driver refused a TMA tensor map"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def instance(dtype, h: int) -> str:
    """The ``LAUNCHES`` key of the kernel instance that serves ``dtype`` at
    head dim ``h``."""
    if dtype == torch.bfloat16 and h in WGMMA_HEAD_DIMS:
        return "flash_attention_wgmma"
    return "flash_attention"


def _entry():
    fn = build.library("flash_attention").bwap_flash_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [ci] * 8 + [ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def smem_bytes(dtype, h: int) -> int:
    """Dynamic shared memory one launch of the (dtype, h) instance asks
    for (builds the library if needed)."""
    fn = build.library("flash_attention").bwap_flash_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(h, _DTYPES[dtype])


def _check(q, k, v):
    if not q.is_cuda:
        raise ValueError("the CUDA flash-attention kernel needs CUDA tensors")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B,S,nq,h] and k/v [B,T,nkv,h] alike, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, nq, h = q.shape
    bk, t, nkv, hk = k.shape
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: "
                         f"need one of float32/bfloat16")
    if bk != b or hk != h or h not in HEAD_DIMS:
        raise ValueError(f"batch {b}/{bk}, head dim {h}/{hk}: need equal "
                         f"batches and a head dim in {HEAD_DIMS}")
    if t < 1:
        raise ValueError("no keys: T must be at least 1")
    if nkv < 1 or nq % nkv:
        raise ValueError(f"nq={nq} is not a multiple of nkv={nkv}")
    if nq > _MAX_GRID_YZ or b > _MAX_GRID_YZ:
        raise ValueError(f"nq={nq}, B={b}: at most {_MAX_GRID_YZ} each")


def flash_attention(q, k, v, *, window: int = 0, causal: bool = True):
    """q [B,S,nq,h], k/v [B,T,nkv,h] -> [B,S,nq,h] (q's dtype)."""
    _check(q, k, v)
    b, s, nq, h = q.shape
    t, nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if b == 0 or s == 0:
        return out
    err = _entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, t, nq, nkv, h, int(bool(causal)), int(window),
        float(np.float32(1.0 / np.sqrt(h))), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash-attention launch failed: error {err} "
                           f"({_ERRORS.get(err, 'cudaError_t')})")
    LAUNCHES[instance(q.dtype, h)] += 1
    return out
