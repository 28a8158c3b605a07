"""Wrappers of the hand-written CUDA paged-attention kernel
(``repro_torch/csrc/paged_attention.cu``), bound with ctypes.

One kernel, the batched prefill-mode page walk, replaces both Pallas
kernels on the serving path (``repro/kernels/paged_attention/kernel.py``:
``paged_prefill_attention_batch`` and ``paged_attention``); decode is its
T = 1 instance with ``q_start = lens - 1``. Each public wrapper checks its
inputs, allocates the output with ``torch.empty``, launches on the current
CUDA stream, raises if the launch reports an error, and adds one to its own
entry of ``LAUNCHES``. There is no fallback: a CPU tensor or a shape the
kernel does not take raises. Page ids in the table are not range-checked
(that would cost a device sync per launch): callers pass ids in [0, P),
as the pool's allocator hands out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
MAX_PAGE_SIZE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# launches per public wrapper; chip_smoke.py zeroes and reads them
LAUNCHES = {"paged_attention": 0, "paged_prefill_attention_batch": 0,
            "paged_prefill_attention": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry():
    fn = build.library("paged_attention").bwap_paged_attention
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 6 + [ci] * 8 + [ctypes.c_float, ci, vp]
        fn.restype = ci
    return fn


def _check(q4, k_pool, v_pool, page_table, qstart):
    b, t, nq, h = q4.shape
    if not q4.is_cuda:
        raise ValueError("the CUDA paged-attention kernel needs CUDA tensors")
    for name, x in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("page_table", page_table), ("q_start/lens", qstart)):
        if x.device != q4.device:
            raise ValueError(f"{name} on {x.device}, q on {q4.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q4.is_contiguous():
        raise ValueError("q must be contiguous")
    if q4.dtype not in _DTYPES or k_pool.dtype != q4.dtype \
            or v_pool.dtype != q4.dtype:
        raise ValueError(f"dtypes q {q4.dtype}, k {k_pool.dtype}, "
                         f"v {v_pool.dtype}: need one of float32/bfloat16")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be [P,ps,nkv,h] alike, got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    _, ps, nkv, hk = k_pool.shape
    if hk != h or h not in HEAD_DIMS:
        raise ValueError(f"head dim {h} (pool {hk}): need one of {HEAD_DIMS}")
    if not 1 <= ps <= MAX_PAGE_SIZE:
        raise ValueError(f"page size {ps}: need 1..{MAX_PAGE_SIZE}")
    if nq % nkv:
        raise ValueError(f"nq={nq} is not a multiple of nkv={nkv}")
    if page_table.dtype != torch.int32 or page_table.dim() != 2 \
            or page_table.shape[0] != b or page_table.shape[1] < 1:
        raise ValueError(f"page_table must be int32 [B={b}, mp>=1], got "
                         f"{page_table.dtype} {tuple(page_table.shape)}")
    if qstart.dtype != torch.int32 or tuple(qstart.shape) != (b,):
        raise ValueError(f"q_start/lens must be int32 [{b}], got "
                         f"{qstart.dtype} {tuple(qstart.shape)}")


def _walk(name: str, q4, k_pool, v_pool, page_table, qstart, qoff: int):
    """Launch the page walk for q4 [B,T,nq,h]; returns [B,T,nq,h] and
    counts the launch under ``name``."""
    _check(q4, k_pool, v_pool, page_table, qstart)
    b, t, nq, h = q4.shape
    out = torch.empty_like(q4)
    if b == 0 or t == 0:
        return out
    _, ps, nkv, _ = k_pool.shape
    err = _entry()(
        q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), qstart.data_ptr(), out.data_ptr(),
        b, t, nq, nkv, h, ps, page_table.shape[1], qoff,
        float(np.float32(1.0 / np.sqrt(h))), _DTYPES[q4.dtype],
        torch.cuda.current_stream(q4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged-attention launch failed: error {err}")
    LAUNCHES[name] += 1
    return out


def paged_prefill_attention_batch(q, k_pool, v_pool, page_table, q_start):
    """q [B,T,nq,h]; pools [P,ps,nkv,h]; page_table [B,mp] int32 (pad with
    page 0); q_start [B] int32 -> [B,T,nq,h]."""
    return _walk("paged_prefill_attention_batch", q, k_pool, v_pool,
                 page_table, q_start, 0)


def paged_attention(q, k_pool, v_pool, page_table, lens):
    """q [B,nq,h]; pools [P,ps,nkv,h]; page_table [B,mp] int32; lens [B]
    int32 -> [B,nq,h]: the T = 1 walk with q_start = lens - 1."""
    return _walk("paged_attention", q[:, None], k_pool, v_pool, page_table,
                 lens, -1)[:, 0]


def paged_prefill_attention(q, k_pool, v_pool, page_table, q_start):
    """One sequence's chunk: q [T,nq,h]; page_table [mp] int32; q_start a
    scalar (int or 0-d/1-element tensor) -> [T,nq,h]. The batched walk at
    B = 1."""
    qs = torch.as_tensor(q_start, dtype=torch.int32,
                         device=q.device).reshape(1)
    return _walk("paged_prefill_attention", q[None], k_pool, v_pool,
                 page_table[None], qs, 0)[0]
