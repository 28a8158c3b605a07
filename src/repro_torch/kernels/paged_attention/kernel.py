"""Wrappers of the hand-written CUDA paged-attention kernel
(``repro_torch/csrc/paged_attention.cu``), bound with ctypes.

One page walk, in batched prefill mode, replaces both Pallas kernels on the
serving path (``repro/kernels/paged_attention/kernel.py``:
``paged_prefill_attention_batch`` and ``paged_attention``); decode is its
T = 1 launch with ``q_start = lens - 1``. The walk has two instances, chosen
by dtype and head dim only (``instance``): ``paged_walk_wgmma`` for bf16 at
a head dim in ``WGMMA_HEAD_DIMS`` (cp.async page gathers, wgmma on the
tensor cores), ``paged_walk`` for fp32 and for bf16 at h = 16, 32 (CUDA
cores).

The tensor-core instance walks tiles of ``TILE_KEYS[h]`` keys at absolute
positions, grouped into key chunks of ``CHUNK_TILES[h]`` tiles (chunk j
holds tiles j*CH .. j*CH + CH - 1). Each chunk's walk starts fresh, and a
row's result is the fold of its chunk partials (m, l, O) in ascending j.
The chunks and the fold are fixed by the instance, so a row's bits do not
depend on how the work is scheduled; two routes schedule it (``plan``):

- ``"split"``: a block per (sequence, KV head, row block, chunk), each
  writing its rows' partials in fp32 to a workspace; the block that draws
  the row block's last ticket folds them in chunk order. Taken when the
  launch has too few row blocks to fill half the card's SMs and its
  partials fit in ``SPLIT_BYTES`` (decode, verify, and short or
  single-sequence chunks at small head dims).
- ``"serial"``: a block per row block walks its chunks one after another
  and folds each as it ends (the second accumulator in a workspace of
  h / 2 KB a block, written and read back through the L2).

The workspace and the tickets are allocated once per device and stream and
grown when a launch needs more (``_workspace``); the tickets start at 0 and
every launch leaves them 0. Launches on one stream run in order; two
streams get two workspaces.

Each public wrapper checks its inputs, allocates the output with
``torch.empty``, launches on the current CUDA stream, raises if the launch
reports an error, and adds one to its own entry of ``LAUNCHES`` and one to
the entry of the instance that ran. There is no fallback: a CPU
tensor or a shape the kernel does not take raises. Page ids in the table
are not range-checked (that would cost a device sync per launch): callers
pass ids in [0, P), as the pool's allocator hands out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)   # bf16 head dims of the tensor-core instance
MAX_PAGE_SIZE = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core instance's layout (csrc/wgmma_attention.cuh, WgLayout<H>:
# WK keys a tile, CH tiles a key chunk) and its rows a block
TILE_KEYS = {64: 64, 128: 64, 256: 48}
CHUNK_TILES = {64: 4, 128: 8, 256: 8}
BLOCK_ROWS = 128
ROUTES = ("split", "serial")
# the split route's partials stay at most this size (L2-resident); a
# launch that would write more walks serially
SPLIT_BYTES = 4 << 20

# launches per public wrapper and per instance; chip_smoke.py zeroes and
# reads them
LAUNCHES = {"paged_attention": 0, "paged_prefill_attention_batch": 0,
            "paged_prefill_attention": 0, "paged_walk": 0,
            "paged_walk_wgmma": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def instance(dtype, h: int) -> str:
    """The ``LAUNCHES`` key of the kernel instance that serves ``dtype`` at
    head dim ``h``."""
    if dtype == torch.bfloat16 and h in WGMMA_HEAD_DIMS:
        return "paged_walk_wgmma"
    return "paged_walk"


def check_head_dim(h: int) -> None:
    """Raises ``ValueError`` for a head dim the kernel has no instance of
    (the serving engine calls it when it is built, before any step)."""
    if h not in HEAD_DIMS:
        raise ValueError(f"head dim {h}: the paged-attention kernel needs "
                         f"one of {HEAD_DIMS}")


def _entry():
    fn = build.library("paged_attention").bwap_paged_attention
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp] * 6 + [ci] * 8 + [ctypes.c_float, ci, ci, vp, ll,
                                              vp, ll, vp])
        fn.restype = ci
    return fn


def n_chunks(h: int, ps: int, mp: int) -> int:
    """Key chunks that a table of ``mp`` pages of ``ps`` keys spans at head
    dim ``h`` (tensor-core instance)."""
    tiles = -(-mp * ps // TILE_KEYS[h])
    return -(-tiles // CHUNK_TILES[h])


def plan(b: int, t: int, nq: int, nkv: int, h: int, ps: int, mp: int,
         sms: int, route: str | None = None) -> tuple[bool, int, int]:
    """How a tensor-core launch runs: (split route?, workspace bytes,
    tickets). ``route`` forces one of ``ROUTES``; by default the split
    route serves a launch whose row blocks fill at most half of the
    ``sms`` SMs and whose partials fit in ``SPLIT_BYTES``. Either route
    gives the same bits. A table of one chunk takes the serial route,
    which is then the same walk."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"route {route!r}: need one of {ROUTES}")
    rows = t * (nq // nkv)
    blocks = b * nkv * -(-rows // BLOCK_ROWS)
    chunks = n_chunks(h, ps, mp)
    split_bytes = 4 * b * nkv * chunks * rows * (h + 2)
    if route is None:
        route = ("split" if 2 * blocks <= sms and split_bytes <= SPLIT_BYTES
                 else "serial")
    if route == "split" and chunks > 1:
        return True, split_bytes, blocks
    # the serial route's second accumulator: 256 consumer threads x h / 2
    # floats a block
    return False, 4 * blocks * 256 * (h // 2), 0


_SMS: dict[int, int] = {}
_WS: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device, stream: int, nbytes: int, tickets: int):
    """The (workspace, tickets) of ``device`` and ``stream``, grown to at
    least ``nbytes`` and ``tickets`` ints (tickets zeroed when made)."""
    key = (device.index, stream)
    ws, tk = _WS.get(key, (None, None))
    if ws is None or ws.numel() < nbytes:
        ws = torch.empty(max(nbytes, 2 * (0 if ws is None else ws.numel()),
                             1 << 20), dtype=torch.uint8, device=device)
    if tk is None or tk.numel() < tickets:
        tk = torch.zeros(max(tickets, 2 * (0 if tk is None else tk.numel()),
                             1024), dtype=torch.int32, device=device)
    _WS[key] = ws, tk
    return ws, tk


def layout(h: int) -> tuple[int, int]:
    """(keys a tile, tiles a chunk) of the built tensor-core instance at
    head dim ``h`` (builds the library if needed); ``TILE_KEYS`` and
    ``CHUNK_TILES`` must agree."""
    lib = build.library("paged_attention")
    return lib.bwap_paged_tile_keys(h), lib.bwap_paged_chunk_tiles(h)


def smem_bytes(dtype, h: int, ps: int) -> int:
    """Dynamic shared memory one launch of the (dtype, h) instance asks for
    at page size ``ps`` (builds the library if needed)."""
    fn = build.library("paged_attention").bwap_paged_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(h, ps, _DTYPES[dtype])


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
    if instance(q4.dtype, h) == "paged_walk_wgmma":
        for name, x in (("q", q4), ("k_pool", k_pool), ("v_pool", v_pool)):
            if x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    if q4.dtype not in _DTYPES or k_pool.dtype != q4.dtype \
            or v_pool.dtype != q4.dtype:
        raise ValueError(f"dtypes q {q4.dtype}, k {k_pool.dtype}, "
                         f"v {v_pool.dtype}: need one of float32/bfloat16")
    if k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools must be [P,ps,nkv,h] alike, got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    _, ps, nkv, hk = k_pool.shape
    if hk != h:
        raise ValueError(f"head dim {h} (pool {hk}): q and pool differ")
    check_head_dim(h)
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


def _walk(name: str, q4, k_pool, v_pool, page_table, qstart, qoff: int,
          route: str | None = None):
    """Launch the page walk for q4 [B,T,nq,h]; returns [B,T,nq,h] and
    counts the launch under ``name``. ``route`` forces a route of the
    tensor-core instance (``plan``)."""
    _check(q4, k_pool, v_pool, page_table, qstart)
    b, t, nq, h = q4.shape
    out = torch.empty_like(q4)
    if b == 0 or t == 0:
        return out
    _, ps, nkv, _ = k_pool.shape
    mp = page_table.shape[1]
    dev = q4.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    split, ws, tk, nbytes, ntk = False, None, None, 0, 0
    if instance(q4.dtype, h) == "paged_walk_wgmma":
        sms = _SMS.get(dev.index)
        if sms is None:
            sms = _SMS[dev.index] = \
                torch.cuda.get_device_properties(dev).multi_processor_count
        split, nbytes, ntk = plan(b, t, nq, nkv, h, ps, mp, sms, route)
        if nbytes or ntk:
            ws, tk = _workspace(dev, stream, nbytes, ntk)
            nbytes, ntk = ws.numel(), tk.numel()
    err = _entry()(
        q4.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), qstart.data_ptr(), out.data_ptr(),
        b, t, nq, nkv, h, ps, mp, qoff,
        float(np.float32(1.0 / np.sqrt(h))), _DTYPES[q4.dtype], int(split),
        None if ws is None else ws.data_ptr(), nbytes,
        None if tk is None else tk.data_ptr(), ntk, stream)
    if err != 0:
        raise RuntimeError(f"paged-attention launch failed: error {err}")
    LAUNCHES[name] += 1
    LAUNCHES[instance(q4.dtype, h)] += 1
    return out


def paged_prefill_attention_batch(q, k_pool, v_pool, page_table, q_start,
                                  *, route: str | None = None):
    """q [B,T,nq,h]; pools [P,ps,nkv,h]; page_table [B,mp] int32 (pad with
    page 0); q_start [B] int32 -> [B,T,nq,h]. ``route`` forces a route of
    the tensor-core instance (tests; the same bits either way)."""
    return _walk("paged_prefill_attention_batch", q, k_pool, v_pool,
                 page_table, q_start, 0, route)


def paged_attention(q, k_pool, v_pool, page_table, lens, *,
                    route: str | None = None):
    """q [B,nq,h]; pools [P,ps,nkv,h]; page_table [B,mp] int32; lens [B]
    int32 -> [B,nq,h]: the T = 1 walk with q_start = lens - 1."""
    return _walk("paged_attention", q[:, None], k_pool, v_pool, page_table,
                 lens, -1, route)[:, 0]


def paged_prefill_attention(q, k_pool, v_pool, page_table, q_start):
    """One sequence's chunk: q [T,nq,h]; page_table [mp] int32; q_start a
    scalar (int or 0-d/1-element tensor) -> [T,nq,h]. The batched walk at
    B = 1."""
    qs = torch.as_tensor(q_start, dtype=torch.int32,
                         device=q.device).reshape(1)
    return _walk("paged_prefill_attention", q[None], k_pool, v_pool,
                 page_table[None], qs, 0)[0]
