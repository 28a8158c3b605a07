"""Fault-tolerant checkpointing: atomic, hashed, mesh-independent (port of
``repro.checkpoint.ckpt``).

Layout:  <dir>/step_00001230/
            manifest.json   — tree paths, shapes/dtypes, sha256 per file
            arr_<idx>.npy   — one file per leaf
         <dir>/LATEST       — atomic pointer file

Trees are nested dicts, lists and tuples of tensors (numpy arrays and
scalars are leaves too). They flatten as JAX flattens them — dict keys in
sorted order, sequences in order, ``None`` holds no leaf — and leaves are
named by JAX's ``keystr`` (``['blocks'][0]['wq']``), so a checkpoint of
either package restores onto the other's tree of the same structure.

The bytes are the reference's: numpy has no bfloat16, so a bfloat16 leaf is
saved as its 16-bit pattern under the descr ``'<V2'`` that ``np.save``
writes for an ``ml_dtypes`` bfloat16 array, and the manifest's dtype
(``"bfloat16"``) turns it back into a tensor on restore. Writes go to a
temp dir + atomic rename; a crashed save never corrupts LATEST. Optional
async mode runs serialization on a worker thread.

The module also holds the host-byte helpers that the persistence tier
(``placement/persist.py``) shares with it: a CPU tensor's element bytes as
numpy, the numpy dtype name of a tensor, and the inverse.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import hashlib
import io
import json
import os
import pathlib
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.placement import policy as placement_policy

# -- host bytes ---------------------------------------------------------------

# the dtypes whose numpy name and torch name differ in kind: numpy has no
# bfloat16, so its bits travel as 16-bit integers
_BITS = {torch.bfloat16: (torch.int16, np.int16)}
_STAMPS = {torch.float32: "float32", torch.bfloat16: "bfloat16",
           torch.float16: "float16"}
_DTYPES = {name: dt for dt, name in _STAMPS.items()}


def dtype_stamp(dtype: torch.dtype) -> str:
    """The numpy name of a pool dtype (``"bfloat16"``, ``"float32"``), as
    the reference stamps ``str(np.asarray(pool).dtype)``."""
    return _STAMPS[dtype]


def torch_dtype(stamp: str) -> torch.dtype:
    """Inverse of :func:`dtype_stamp`."""
    return _DTYPES[stamp]


def host_array(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's elements as a C-contiguous numpy array sharing its
    memory; bfloat16 as its 16-bit pattern (``int16``). ``.tobytes()`` is
    the reference's ``tobytes()`` of the same values."""
    t = t.detach().contiguous()
    bits = _BITS.get(t.dtype)
    if bits is not None:
        return t.view(bits[0]).numpy()
    return t.numpy()


def from_host(arr: np.ndarray, stamp: str) -> torch.Tensor:
    """A CPU tensor of dtype ``stamp`` from a numpy array of its values or,
    for bfloat16, of its bit pattern in any 16-bit dtype (``int16``,
    ``uint16``, or the ``V2`` records ``np.load`` returns)."""
    arr = np.ascontiguousarray(arr)
    dt = torch_dtype(stamp) if stamp in _DTYPES else None
    if dt in _BITS:
        return torch.from_numpy(arr.view(_BITS[dt][1])).view(dt)
    return torch.from_numpy(arr)


def _leaf_array(leaf) -> tuple[np.ndarray, str]:
    """(numpy array, the reference's dtype name) of a host leaf."""
    if isinstance(leaf, torch.Tensor):
        arr = host_array(leaf)
        if leaf.dtype in _BITS:
            return arr, _STAMPS[leaf.dtype]
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_npy(fp, leaf) -> None:
    """``np.save`` of a leaf, bytes equal to the reference's: a bfloat16
    tensor goes out as ``'<V2'`` records of its bit pattern."""
    arr, stamp = _leaf_array(leaf)
    if stamp == "bfloat16":
        arr = np.ascontiguousarray(arr)
        np.lib.format.write_array_header_1_0(fp, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        fp.write(arr.tobytes())
    else:
        np.save(fp, arr, allow_pickle=False)


# -- staging plans ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StagingTier:
    """A staging target for serialized checkpoint bytes (host DRAM, peer
    host over the network, local NVMe, ...)."""

    name: str
    bw_gbps: float           # drain bandwidth from the accelerator
    capacity_bytes: int


STAGING_PAGE_BYTES = 1 << 20  # placement granularity for staging buffers


def plan_staging(leaf_bytes: list[int], tiers: list[StagingTier],
                 policy: str = "bwap_canonical", *,
                 page_bytes: int = STAGING_PAGE_BYTES) -> dict:
    """Spread serialized checkpoint buffers over staging tiers through the
    placement policy registry (the same Eq.-1 argument as weighted ZeRO:
    draining from all tiers in parallel hides the slow tier behind the fast
    one, rather than filling the fast tier first). Returns per-tier byte
    totals and the max-parallel-transfer drain-time estimate.

    ``page_bytes`` sets the placement granularity: checkpoints stage at
    ``STAGING_PAGE_BYTES``; the persistent tier's prefix/page-range exports
    reuse the same planner at KV-page granularity (``pool.page_bytes``)."""
    pages = max(1, int(-(-sum(leaf_bytes) // page_bytes)))
    ctx = placement_policy.PlacementContext(
        bandwidths=np.asarray([t.bw_gbps for t in tiers]),
        num_pages=pages, workers=(0,),
        capacities=np.asarray([t.capacity_bytes // page_bytes
                               for t in tiers]))
    counts = placement_policy.resolve(policy).counts(ctx)
    tier_bytes = counts * page_bytes
    drain = max(float(b) / (t.bw_gbps * 1e9)
                for b, t in zip(tier_bytes, tiers))
    return {
        "policy": policy,
        "page_bytes": page_bytes,
        "tiers": {t.name: int(b) for t, b in zip(tiers, tier_bytes)},
        "drain_time_s": drain,
    }


def publish_dir(tmp: pathlib.Path, final: pathlib.Path) -> None:
    """Atomic directory publish: replace ``final`` with ``tmp`` by rename.
    A crashed writer never leaves a partially-visible directory — the same
    contract ``CheckpointManager`` gives checkpoints, reused by the
    persistent tier's prefix store."""
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)


# -- trees --------------------------------------------------------------------

def _flatten(tree, path: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _snapshot(leaf):
    """Host copy of a leaf, taken synchronously (a later write to the
    original never reaches the checkpoint)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@dataclasses.dataclass
class CheckpointManager:
    directory: str | pathlib.Path
    keep_last: int = 3
    async_save: bool = False
    staging_tiers: list[StagingTier] | None = None
    staging_policy: str = "bwap_canonical"

    def __post_init__(self):
        self.directory = pathlib.Path(self.directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=1) \
            if self.async_save else None
        self._pending: cf.Future | None = None

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, metadata: dict | None = None):
        """Snapshot (device->host copy) happens synchronously; file I/O is
        offloaded when async_save=True (training continues during write)."""
        host = [(p, _snapshot(x)) for p, x in _flatten(tree)]
        if self._pool is None:
            self._write(step, host, metadata or {})
        else:
            self.wait()
            self._pending = self._pool.submit(self._write, step, host,
                                              metadata or {})

    def wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _write(self, step: int, host: list[tuple[str, Any]],
               metadata: dict):
        name = f"step_{step:010d}"
        tmp = self.directory / f".tmp_{name}_{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {
            "step": step,
            "metadata": metadata,
            "paths": [p for p, _ in host],
            "leaves": [],
        }
        leaf_sizes = []
        for i, (_, leaf) in enumerate(host):
            buf = io.BytesIO()
            save_npy(buf, leaf)
            raw = buf.getvalue()
            fname = f"arr_{i:05d}.npy"
            (tmp / fname).write_bytes(raw)
            leaf_sizes.append(len(raw))
            arr, stamp = _leaf_array(leaf)
            manifest["leaves"].append({
                "file": fname,
                "sha256": _sha256(raw),
                "shape": list(arr.shape),
                "dtype": stamp,
            })
        if self.staging_tiers:
            # advisory metadata: an unplaceable staging demand must never
            # abort the checkpoint itself
            try:
                manifest["staging"] = plan_staging(
                    leaf_sizes, self.staging_tiers, self.staging_policy)
            except ValueError as e:
                manifest["staging"] = {"policy": self.staging_policy,
                                       "error": str(e)}
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        publish_dir(tmp, self.directory / name)
        self._point_latest(name)
        self._gc()

    def _point_latest(self, name: str):
        ptr = self.directory / "LATEST"
        tmp = self.directory / ".LATEST.tmp"
        tmp.write_text(name)
        tmp.rename(ptr)

    def _gc(self):
        steps = sorted(self.directory.glob("step_*"))
        for old in steps[:-self.keep_last]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> int | None:
        ptr = self.directory / "LATEST"
        if not ptr.exists():
            return None
        name = ptr.read_text().strip()
        if not (self.directory / name / "manifest.json").exists():
            return None
        return int(name.split("_")[1])

    def restore(self, step: int | None = None, like: Any | None = None,
                shardings: Any | None = None, strict_hash: bool = True):
        """Returns (step, tree) with CPU tensors as leaves. ``like``
        provides the structure; ``shardings`` places the leaves: one
        device for all, or a tree of devices with ``like``'s structure."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self.directory / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        leaves = []
        for entry in manifest["leaves"]:
            raw = (d / entry["file"]).read_bytes()
            if strict_hash and _sha256(raw) != entry["sha256"]:
                raise IOError(f"checksum mismatch in {d / entry['file']} — "
                              "corrupt checkpoint")
            arr = np.load(io.BytesIO(raw), allow_pickle=False)
            leaves.append(from_host(arr, entry["dtype"]))
        if like is None:
            raise ValueError("pass `like` (a tree with the same structure)")
        n = len(_flatten(like))
        if n != len(leaves):
            raise ValueError(f"`like` has {n} leaves, the checkpoint "
                             f"{len(leaves)}")
        if shardings is not None:
            if isinstance(shardings, (str, torch.device)):
                leaves = [x.to(shardings) for x in leaves]
            else:
                devs = [dev for _, dev in _flatten(shardings)]
                leaves = [x.to(dev) for x, dev in zip(leaves, devs)]
        return step, _unflatten(like, iter(leaves))
