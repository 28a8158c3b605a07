"""Wrapper of the hand-written CUDA row-invariant weight product
(``repro_torch/csrc/rowwise_matmul.cu``), bound with ctypes.

It replaces no Pallas kernel: the reference leaves the decoder's weight
products to XLA. It serves ``PagedDecoder._mm`` on a card, so that a row's
bits do not depend on how many rows share the launch (a decode step, a
speculative verify chunk, a ``coda`` micro-batch) and speculation stays
token-identical to greedy decode. Two instances, chosen by dtype only:

- bf16 on the tensor cores (``rowwise_wgmma``: TMA ring, ``wgmma``
  m64nBNk16, fp32 accumulators, bf16 out), persistent blocks over tiles
  numbered with the row tile fastest, K cut into ``splits`` ranges of
  ``BK``-deep steps. ``plan(N, K, sms)`` fixes ``BN`` and ``splits`` from
  the weight's shape and the card alone, never from M, and so each
  element's order of summation; the splits' fp32 partials are folded in
  ascending split index, through a workspace by the tile's last split to
  arrive (in the same launch) or in one block's registers;
- fp32 on the CUDA cores (one ``fmaf`` a k, one block shape for every M).

The weight ``w [K, N]`` is the transpose of a contiguous ``[N, K]``: a
tied head's ``embed.T`` as it is, so the vocabulary matrix is never
copied, and the decoder's projections as ``ops.weight`` stores them on a
card.

The wrapper checks its inputs, allocates the output with ``torch.empty``,
takes the plan from a cache per (N, K, SM count) and the workspace and
tickets from a cache per device and stream (grown when a launch needs
more, never shrunk; the tickets start at 0 and every launch leaves them
0), launches on the current CUDA stream, raises if the launch reports an
error, and adds one to ``LAUNCHES["rowwise_matmul"]`` and to the entry of
the instance that ran. There is no fallback: a CPU tensor or a shape the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BK = 64                          # the bf16 instance's k a step
WIDTHS = (256, 128, 64, 32)      # its column tiles (BN), widest first

# launches, in total and per instance; chip_smoke.py zeroes and reads them
LAUNCHES = {"rowwise_matmul": 0, "rowwise_wgmma_bf16": 0,
            "rowwise_fma_f32": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def instance(dtype) -> str:
    """The ``LAUNCHES`` key of the instance that serves ``dtype``."""
    return "rowwise_wgmma_bf16" if dtype == torch.bfloat16 else \
        "rowwise_fma_f32"


def plan(n: int, k: int, sms: int) -> tuple[int, int]:
    """``(BN, splits)`` of the bf16 instance for a ``[K, N]`` weight on a
    card of ``sms`` SMs; it takes no M, so neither does any element's
    order of summation. The widest ``BN`` whose column tiles reach the SM
    count, with K whole; where none does, the narrowest, with K split so
    that column tiles x splits reach the SM count, or every ``BK``-deep
    step is a split (the narrowest tiles need the fewest splits, and the
    partials a split writes grow with M x N x splits)."""
    for bn in WIDTHS[:-1]:
        if -(-n // bn) >= sms:
            return bn, 1
    bn = WIDTHS[-1]
    return bn, min(-(-sms // -(-n // bn)), -(-k // BK))


# the built bf16 instances, (wgmma width, columns a tile, rows a tile):
# one consumer warpgroup (64 rows, launches of at most 64 rows) or two
# (128 rows; the width or 128 columns, as the kernel picks for the launch)
INSTANCES = tuple([(b, b, 64) for b in WIDTHS] + sorted(
    {(b, max(t, b), 128) for b in WIDTHS for t in (b, 128)}))


_SMS: dict[int, int] = {}
_PLANS: dict[tuple[int, int, int], tuple[int, int]] = {}
_WS: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def launch_args(m: int, n: int, k: int, sms: int) -> tuple:
    """What the bf16 instance is launched with, but pointers and stream:
    ``(m, n, k, BN, splits, sms)``, and the grid of 64-row, BN-column
    tiles a split (row tiles, column tiles x splits), which the kernel's
    persistent blocks walk row tile fastest. Only ``m`` and the grid's
    row extent follow M. (The kernel may merge those tiles into 128 rows
    and 128 columns, and fold a column tile's splits in one block, by M;
    neither changes an element's order of summation.)"""
    key = (n, k, sms)
    p = _PLANS.get(key)
    if p is None:
        p = _PLANS[key] = plan(n, k, sms)
    bn, splits = p
    return (m, n, k, bn, splits, sms), (-(-m // 64), -(-n // bn) * splits)


def _workspace(device, stream: int, nbytes: int, tickets: int):
    """The (workspace, tickets) of ``device`` (a ``torch.device`` or a CUDA
    index) and ``stream``, grown to at least ``nbytes`` and ``tickets``
    ints (tickets zeroed when made), never shrunk."""
    key = (device, stream)
    ws, tk = _WS.get(key, (None, None))
    if ws is None or ws.numel() < nbytes:
        ws = torch.empty(max(nbytes, 2 * (0 if ws is None else ws.numel()),
                             1 << 20), dtype=torch.uint8, device=device)
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(max(tickets, 2 * (0 if tk is None else tk.numel()),
                             1024), dtype=torch.int32, device=device)
    _WS[key] = ws, tk
    return ws, tk


def smem_bytes(bn: int, cols: int, rows: int) -> int:
    """Dynamic shared memory of the built bf16 instance of wgmma width
    ``bn`` with tiles of ``rows`` x ``cols`` (``INSTANCES``), -1 when none
    is built (builds the library if needed)."""
    fn = build.library("rowwise_matmul").bwap_rowwise_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(bn, int(rows == 64), cols)


def _entry():
    fn = build.library("rowwise_matmul").bwap_rowwise_matmul
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 3 + [ci] * 7 + [vp, ll, vp, ll, vp]
        fn.restype = ci
    return fn


def _raw_stream(index: int) -> int:
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is not None:
        return get(index)
    return torch.cuda.current_stream(index).cuda_stream


def check_weight(w: torch.Tensor) -> None:
    """Raises unless ``w [K, N]`` is the transpose of a contiguous
    ``[N, K]``, the one layout the kernel reads."""
    if w.dim() != 2:
        raise ValueError(f"weight must be 2-d, got {tuple(w.shape)}")
    k, n = w.shape
    s0, s1 = w.stride()
    if (s0 == 1 or k == 1) and (s1 == k or n == 1) or w.numel() == 0:
        return
    raise ValueError(f"weight strides {w.stride()}: need the transpose "
                     f"of a contiguous [N, K] (ops.weight lays it out)")


def rowwise_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ w [K, N] -> [..., N]`` in ``a``'s dtype; ``w`` the
    transpose of a contiguous ``[N, K]``."""
    dev = a.get_device()
    if not a.is_cuda or w.get_device() != dev:
        raise ValueError("the CUDA row-invariant product needs CUDA tensors "
                         f"on one device (a {a.device}, w {w.device})")
    dt = a.dtype
    if w.dtype != dt or dt not in _DTYPES:
        raise ValueError(f"dtypes a {dt}, w {w.dtype}: need one of "
                         f"float32/bfloat16, alike")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    check_weight(w)
    k, n = w.shape
    if a.shape[-1] != k:
        raise ValueError(f"a {tuple(a.shape)} @ w {tuple(w.shape)}: inner "
                         f"dims differ")
    if k == 0:
        raise ValueError(f"a {tuple(a.shape)} @ w {tuple(w.shape)}: K is 0")
    m = a.numel() // k
    bf16 = dt == torch.bfloat16
    if bf16 and (n % 8 or k % 8):
        raise ValueError(f"bf16 product [{m}, {k}] @ [{k}, {n}]: N and K "
                         f"must be multiples of 8")
    out = torch.empty(*a.shape[:-1], n, dtype=dt, device=a.device)
    if m == 0:
        return out
    stream = _raw_stream(dev)
    ws = tk = None
    n_ws = n_tk = 0
    if bf16:
        sms = _SMS.get(dev)
        if sms is None:
            sms = _SMS[dev] = \
                torch.cuda.get_device_properties(dev).multi_processor_count
        args, (slabs, cols) = launch_args(m, n, k, sms)
        bn, splits = args[3], args[4]
        if splits > 1:           # tickets: one a tile, at most a slab's
            ws, tk = _workspace(dev, stream, 4 * splits * m * n,
                                slabs * (cols // splits))
            n_ws, n_tk = ws.numel() // 4, tk.numel()
    else:
        bn = splits = sms = 0
    err = _entry()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                   _DTYPES[dt], bn, splits, sms,
                   None if ws is None else ws.data_ptr(), n_ws,
                   None if tk is None else tk.data_ptr(), n_tk, stream)
    if err != 0:
        raise RuntimeError(f"row-invariant product launch failed: error "
                           f"{err} (m {m}, n {n}, k {k})")
    LAUNCHES["rowwise_matmul"] += 1
    LAUNCHES[instance(dt)] += 1
    return out
