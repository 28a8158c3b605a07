"""Persistent tier: the third placement tier below swap slots (DESIGN.md §9;
port of ``repro.placement.persist``).

"Dynamic Page Placement on Real Persistent Memory Systems" makes the case
that PMEM-class storage is best treated as one more *placement* tier with
its own bandwidth row in the cost model — not as a disk behind the runtime.
:class:`PersistentTier` is that tier for the memory fabric: the
:class:`~repro_torch.placement.fabric.MemoryFabric` owns exactly one, below
the fast domains and the reserved swap slots. Three capabilities:

- **Eq.-1 cold demotion** — parked KV pages demote out of reserved swap
  slots into the tier, freeing the slot for hotter evictions. A demoted
  page keeps its table reference and view holds under a *handle id*
  (negative, starting at ``-2`` — ``pagetable.ROOT`` is ``-1``), and
  ``swap_in`` promotes the bytes back bit-exactly. Every demote/promote
  transfer is priced by :func:`repro_torch.core.bwmodel.stall_cost` with
  the tier's bandwidth appended as one extra Eq.-1 row.
- **Restart-surviving prefix store** — pinned hot prefixes (popular system
  prompts) and refcount>1 trie chains are exported with their chain keys
  and K/V bytes, using the checkpoint subsystem's idioms: staging plans
  (:func:`repro_torch.checkpoint.ckpt.plan_staging` at KV-page
  granularity), sha256 per array, atomic directory publish, and
  never-abort advisory semantics. A freshly constructed fabric re-imports
  them so the first request after an engine restart hits the trie instead
  of re-prefilling.
- **Peer page export/import** — a fabric serializes a page range (table
  slice, physical bytes, ledger charges) and a peer fabric adopts it; the
  layout metadata is stamped from ``launch/mesh`` axes and
  ``sharding/specs``' KV-pool partition spec so an importer can check the
  bytes were produced under a compatible sharding. This is the scale-out
  primitive: prefill/decode disaggregation is "export the prefix range to
  the decode fabric".

The tier emits ``demote`` / ``promote`` / ``restore`` on the fabric event
bus; the fabric routes them into :class:`DomainTelemetry` tier counters and
refreshes the per-tier occupancy gauges.

Bytes and the reference's formats. Pages leaving the pool live on the host
as CPU tensors: each id list is one gather on the pool's device and one
copy to the host, and pages come back by one copy to the device and an
in-place scatter into the pool tensors. Every format is the reference's,
byte for byte: the geometry stamps the numpy dtype name (``"bfloat16"``,
``"float32"``); the prefix store's ``.npy`` files hold bfloat16 as
``'<V2'`` records; the wire carries ``uint8`` views; every sha256 is over
the raw element bytes; the JSON headers and manifests are equal.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import pathlib
import shutil
from typing import Sequence

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (StagingTier, dtype_stamp, from_host,
                                         host_array, plan_staging,
                                         publish_dir, save_npy, torch_dtype)
from repro_torch.core import bwmodel
from repro_torch.launch import mesh as mesh_lib
from repro_torch.sharding import specs

FIRST_HANDLE = -2          # pagetable.ROOT == -1; handles count down from -2


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _digest(t: torch.Tensor) -> str:
    """sha256 of a host tensor's raw element bytes."""
    return _sha256(host_array(t).tobytes())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather(pool_array: torch.Tensor, ids: Sequence[int]) -> torch.Tensor:
    """``pool_array[:, ids]`` on the host: one gather on the pool's device,
    one copy to the host (a CPU pool's gather is already a copy)."""
    return pool_array[:, list(ids)].cpu()


def _scatter(pool_array: torch.Tensor, ids: Sequence[int],
             host: torch.Tensor) -> None:
    """``pool_array[:, ids] = host``, in place on the pool's device."""
    pool_array[:, list(ids)] = host.to(pool_array.device)


@dataclasses.dataclass(frozen=True)
class MeshMeta:
    """Mesh geometry without device state: enough for ``dp_axes`` /
    ``mp_axis`` / spec fitting, so export metadata never needs a live
    device mesh (an exporting serve host may not even run on the
    accelerator that produced the layout)."""

    shape: dict
    axis_names: tuple


def kv_layout_metadata(cfg, page_size: int, mesh=None) -> dict:
    """Layout stamp for a page-range export: mesh axes + the KV-pool
    partition spec the bytes were produced under."""
    m = mesh if mesh is not None else MeshMeta(
        shape={"data": 4, "model": 2}, axis_names=("data", "model"))
    pspec = specs.kv_pool_spec(cfg, m, page_size)
    return {
        "mesh_axes": {a: int(m.shape[a]) for a in m.axis_names},
        "dp_axes": list(mesh_lib.dp_axes(m)),
        "mp_axis": mesh_lib.mp_axis(m),
        "kv_pool_spec": [e if e is None or isinstance(e, str) else list(e)
                         for e in pspec],
    }


@dataclasses.dataclass
class _Persisted:
    """One demoted page's bytes, held on the host outside the pool."""

    k: torch.Tensor            # [L, page_size, nkv, hd], CPU
    v: torch.Tensor
    owner: str                 # view whose ledger carries the page


class PersistentTier:
    """Third placement tier of one memory fabric.

    ``bw_gbps`` is the tier's Eq.-1 bandwidth row; ``capacity_pages`` its
    demotion capacity; ``directory`` (optional) backs the prefix store on
    disk — without it the store lives in memory, which still survives a
    fabric teardown/rebuild (the tier object outlives the fabric) and is
    what the hermetic tests use.
    """

    def __init__(self, *, bw_gbps: float = 1.0, capacity_pages: int = 1024,
                 directory: str | pathlib.Path | None = None,
                 name: str = "pmem",
                 staging_tiers: list[StagingTier] | None = None,
                 staging_policy: str = "bwap_canonical"):
        assert bw_gbps > 0 and capacity_pages >= 0
        self.name = name
        self.bw_gbps = float(bw_gbps)
        self.capacity_pages = int(capacity_pages)
        self.directory = pathlib.Path(directory) if directory else None
        self.staging_tiers = staging_tiers
        self.staging_policy = staging_policy
        self.fabric = None
        self._entries: dict[int, _Persisted] = {}
        self._next = FIRST_HANDLE
        # prefix-store pin registry:
        # (view, tokens) -> {"view","tokens","pages","stamp"}; ``stamp`` is
        # a monotonic use-clock driving LRU eviction at the store's byte cap
        self._pins: dict[tuple, dict] = {}
        self._pin_clock = 0
        self.evicted_chains = 0          # LRU evictions at the byte cap
        self.skipped_chains = 0          # unpinned chains dropped over-cap
        self._mem_store: dict | None = None      # in-memory prefix store

    def bind(self, fabric) -> None:
        """Called by ``MemoryFabric.attach_persist`` — the fabric owns the
        tier; the tier never outlives its binding silently (rebinding after
        a teardown is exactly the restart path). Pins are runtime holds on
        the *previous* fabric's pages, so a rebind drops them — the durable
        prefix store is what survives. Demoted pages must have promoted or
        died before the old fabric went away; carrying their handles across
        a rebind would strand untracked bytes."""
        if fabric is not self.fabric:
            assert not self._entries, \
                "rebinding a tier with demoted pages still outstanding"
            self._pins.clear()
        self.fabric = fabric

    # -- accounting ----------------------------------------------------------

    def persisted_ids(self):
        return set(self._entries)

    def used_pages(self) -> int:
        return len(self._entries)

    def capacity_left(self) -> int:
        return self.capacity_pages - len(self._entries)

    def per_view_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self._entries.values():
            out[e.owner] = out.get(e.owner, 0) + 1
        return out

    def stats(self) -> dict:
        return {
            "name": self.name,
            "bw_gbps": self.bw_gbps,
            "used_pages": self.used_pages(),
            "capacity_pages": self.capacity_pages,
            "pins": len(self._pins),
            "evicted_chains": self.evicted_chains,
            "skipped_chains": self.skipped_chains,
            "per_view": self.per_view_counts(),
        }

    def _geometry(self, pool) -> dict:
        cfg = pool.cfg
        g = pool.geometry
        return {
            "num_layers": int(g.num_layers),
            "page_size": int(pool.page_size),
            "num_kv_heads": int(cfg.num_kv_heads),
            "head_dim": int(cfg.head_dim_),
            "dtype": dtype_stamp(pool.k_pool.dtype),
            # geometry-polymorphic facts (DESIGN.md §12): the conversion
            # layer (cluster/convert.py) re-chunks across page_size when
            # kind and block tails agree, and refuses otherwise
            "kind": g.kind,
            "k_block": [int(x) for x in g.k_block],
            "v_block": [int(x) for x in g.v_block],
        }

    def _staging_plan(self, pool, nbytes: list[int]) -> dict:
        """Advisory staging plan at KV-page granularity — an unplaceable
        demand must never abort the export itself (ckpt semantics)."""
        tiers = self.staging_tiers or [StagingTier(
            self.name, self.bw_gbps,
            max(1, self.capacity_pages) * pool.page_bytes)]
        try:
            return plan_staging(nbytes, tiers, self.staging_policy,
                                page_bytes=pool.page_bytes)
        except ValueError as e:
            return {"policy": self.staging_policy, "error": str(e)}

    def _tier_seconds(self, view, live_pages: Sequence[int]) -> float:
        """Eq.-1 price of moving ``live_pages``'s bytes between their
        domains and this tier: the domain side and the tier row overlap,
        the stall is the slower of the two — the tier is just one more
        domain in Eq. 1."""
        pool = view.pool
        pb = pool.page_bytes
        per_domain = np.bincount([pool.domain_of(p) for p in live_pages],
                                 minlength=len(pool.domains)) * float(pb)
        return bwmodel.stall_cost(per_domain, self.fabric.bw_effective,
                                  tier_bytes=len(live_pages) * float(pb),
                                  tier_bw_gbps=self.bw_gbps)

    # -- Eq.-1 cold demotion ---------------------------------------------------

    def demote(self, view, slot_ids: Sequence[int]) -> tuple[list[int], float]:
        """Move parked pages' bytes out of reserved swap slots into the
        tier. Table references and view holds carry over onto fresh handle
        ids (``remap_physical`` + per-view ``_on_remap``, the same contract
        every other mover honors); the vacated slots are the caller's (the
        swap manager returns them to its reservation). Returns
        ``(handles, seconds)``."""
        fabric = self.fabric
        assert fabric is not None, "tier not attached to a fabric"
        slot_ids = [int(s) for s in slot_ids]
        assert len(slot_ids) <= self.capacity_left(), \
            "persistent tier capacity exhausted"
        pool = view.pool
        seconds = self._tier_seconds(view, slot_ids)
        k_host = _gather(pool.k_pool, slot_ids)
        v_host = _gather(pool.v_pool, slot_ids)
        handles = []
        for i, sid in enumerate(slot_ids):
            h = self._next
            self._next -= 1
            self._entries[h] = _Persisted(k_host[:, i].clone(),
                                          v_host[:, i].clone(), view.name)
            view.persisted += 1
            view.table.remap_physical(sid, h)
            for vv in fabric.views.values():
                vv._on_remap(sid, h)
            handles.append(h)
        fabric.emit("demote", view=view.name, pages=len(handles),
                    handles=list(handles), seconds=seconds)
        return handles, seconds

    def promote(self, view, handles: Sequence[int]) -> tuple[list[int], float]:
        """Bring demoted pages back into live fast-domain pages under the
        view's own placement cycle, bit-exactly. Mirrors
        ``FabricView.unpark_pages``: refs/holds/ownership follow the bytes.
        Returns ``(new_ids, seconds)``."""
        fabric = self.fabric
        pool = view.pool
        handles = [int(h) for h in handles]
        dst = [view._alloc_physical() for _ in handles]
        if handles:
            _scatter(pool.k_pool, dst, torch.stack(
                [self._entries[h].k for h in handles], dim=1))
            _scatter(pool.v_pool, dst, torch.stack(
                [self._entries[h].v for h in handles], dim=1))
        seconds = self._tier_seconds(view, dst)
        for h, d in zip(handles, dst):
            e = self._entries.pop(h)
            owner = fabric.views.get(e.owner)
            if owner is not None:
                owner.persisted -= 1
            view.table.remap_physical(h, d)
            fabric._own(view, d)
            for vv in fabric.views.values():
                vv._on_remap(h, d)
        fabric.emit("promote", view=view.name, pages=len(handles),
                    seconds=seconds)
        return dst, seconds

    def forget(self, handle: int) -> None:
        """Drop a demoted page whose last reference died (sequence freed
        while cold): the bytes are garbage, no transfer happens."""
        e = self._entries.pop(handle, None)
        if e is None:
            return
        owner = self.fabric.views.get(e.owner) if self.fabric else None
        if owner is not None:
            owner.persisted -= 1

    def read(self, handle: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Bytes of a demoted page (tests/oracles; no transfer priced)."""
        e = self._entries[handle]
        return e.k, e.v

    # -- restart-surviving prefix store ---------------------------------------

    def pin(self, view, tokens: Sequence[int]):
        """Pin a registered prompt prefix: the tier takes its own holds on
        the chain (via a trie probe), so the pages survive refcount churn
        with zero live requests — the arbiter pins popular system prompts
        this way. Returns the pin key, or None if nothing is registered."""
        pages: list[int] = []
        n = view.probe_prefix(list(tokens), pages, count=False)
        if not pages:
            return None
        key = (view.name, tuple(tokens[:n]))
        if key in self._pins:
            view.release(pages)            # already pinned: undo dup holds
            self.touch_pin(key)
            return key
        self._pin_clock += 1
        self._pins[key] = {"view": view.name, "tokens": list(tokens[:n]),
                           "pages": pages, "stamp": self._pin_clock}
        return key

    def touch_pin(self, key) -> None:
        """Refresh a pin's LRU stamp: the arbiter touches the pins it
        re-selects each cycle, so a preamble that stays globally hot never
        ages into an eviction candidate."""
        entry = self._pins.get(key)
        if entry is not None:
            self._pin_clock += 1
            entry["stamp"] = self._pin_clock

    def unpin(self, key) -> None:
        entry = self._pins.pop(key, None)
        if entry is None or self.fabric is None:
            return
        view = self.fabric.views.get(entry["view"])
        if view is not None:
            view.release(entry["pages"])

    def release_pins(self) -> None:
        """Drop every pin's holds (fabric teardown / test cleanup)."""
        for key in list(self._pins):
            self.unpin(key)

    def pinned_pages(self) -> set[int]:
        out: set[int] = set()
        for entry in self._pins.values():
            out.update(entry["pages"])
        return out

    def _pin_stamp(self, view, tokens: Sequence[int]) -> int | None:
        """LRU stamp of the pin covering a chain, if any: a chain is
        "pinned" when some pin's token path is a prefix of it (chains are
        maximal, so they may extend past the pinned preamble)."""
        toks = tuple(int(t) for t in tokens)
        best = None
        for (vname, ptoks), entry in self._pins.items():
            if vname == view.name and toks[:len(ptoks)] == ptoks:
                best = max(best or 0, entry["stamp"])
        return best

    def _evict_chain_pins(self, view, tokens: Sequence[int]) -> None:
        """Drop every pin whose token path prefixes the evicted chain."""
        toks = tuple(int(t) for t in tokens)
        for key in [k for k in self._pins
                    if k[0] == view.name and toks[:len(k[1])] == k[1]]:
            self.unpin(key)

    def store_budget_bytes(self, pool) -> int:
        """The prefix store's byte cap: the tier's page capacity priced in
        the pool's page bytes. Demotion slots and the store share the same
        cap — the tier is one device, not two."""
        return self.capacity_pages * pool.page_bytes

    def export_prefixes(self, view, *, min_ref: int = 2) -> dict:
        """Export hot prefix chains — every pinned chain plus every chain
        whose pages are all held by ``min_ref``+ readers — with their chain
        keys (root-anchored token paths) and K/V bytes. Returns the
        manifest; the store (disk or memory) is replaced atomically.

        The store is capped at :meth:`store_budget_bytes`. Over the cap,
        chains are kept by priority — pinned chains in LRU order (most
        recently touched first), then unpinned chains — and the losers are
        *surfaced*, not silently dropped: a rejected pinned chain is
        unpinned and emits ``evict`` (the LRU eviction policy), a rejected
        unpinned chain emits ``export_skip``; both are counted in the
        observatory metrics."""
        pool = view.pool
        table = view.table
        pinned = self.pinned_pages()
        chains = table.export_chains(
            select=lambda pid: pid in pinned
            or table.ref.get(pid, 0) >= min_ref)
        # rank: pinned chains newest-stamp-first, then unpinned in table
        # order; greedy-fit against the byte cap in that priority order
        ranked = sorted(
            range(len(chains)),
            key=lambda i: (
                (0, -(self._pin_stamp(view, chains[i]["tokens"]) or 0))
                if self._pin_stamp(view, chains[i]["tokens"]) is not None
                else (1, i)))
        budget = self.store_budget_bytes(pool)
        pb = pool.page_bytes
        spent, kept = 0, []
        for i in ranked:
            ch = chains[i]
            nbytes = len(ch["phys"]) * pb
            if spent + nbytes <= budget:
                spent += nbytes
                kept.append(i)
                continue
            stamp = self._pin_stamp(view, ch["tokens"])
            if stamp is not None:
                self._evict_chain_pins(view, ch["tokens"])
                self.evicted_chains += 1
                if self.fabric is not None:
                    self.fabric.emit("evict", view=view.name,
                                     pages=len(ch["phys"]), chains=1)
            else:
                self.skipped_chains += 1
                if self.fabric is not None:
                    self.fabric.emit("export_skip", view=view.name,
                                     pages=len(ch["phys"]), chains=1)
        chains = [chains[i] for i in sorted(kept)]
        manifest = {
            "kind": "prefix_store",
            "geometry": self._geometry(pool),
            "chains": [],
        }
        arrays: dict[str, torch.Tensor] = {}
        sizes = []
        for i, ch in enumerate(chains):
            k = _gather(pool.k_pool, ch["phys"])
            v = _gather(pool.v_pool, ch["phys"])
            fk, fv = f"chain_{i:05d}_k.npy", f"chain_{i:05d}_v.npy"
            arrays[fk], arrays[fv] = k, v
            sizes.append(_nbytes(k) + _nbytes(v))
            manifest["chains"].append({
                "tokens": [int(t) for t in ch["tokens"]],
                "pages": len(ch["phys"]),
                "k": fk, "v": fv,
                "sha256_k": _digest(k),
                "sha256_v": _digest(v),
            })
        manifest["staging"] = self._staging_plan(pool, sizes or [0])
        if self.directory is None:
            self._mem_store = {"manifest": manifest, "arrays": arrays}
        else:
            self.directory.mkdir(parents=True, exist_ok=True)
            tmp = self.directory / f".tmp_prefix_store_{os.getpid()}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for fname, arr in arrays.items():
                with open(tmp / fname, "wb") as fp:
                    save_npy(fp, arr)
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
            publish_dir(tmp, self.directory / "prefix_store")
        return manifest

    def _load_store(self):
        if self.directory is None:
            if self._mem_store is None:
                return None, None
            return self._mem_store["manifest"], self._mem_store["arrays"]
        d = self.directory / "prefix_store"
        if not (d / "manifest.json").exists():
            return None, None
        manifest = json.loads((d / "manifest.json").read_text())
        stamp = manifest["geometry"]["dtype"]
        arrays = {}
        for ch in manifest["chains"]:
            for key, sha in ((ch["k"], ch["sha256_k"]),
                             (ch["v"], ch["sha256_v"])):
                arr = np.load(d / key, allow_pickle=False)
                if _sha256(arr.tobytes()) != sha:
                    raise IOError(f"checksum mismatch in {d / key} — "
                                  "corrupt prefix store")
                arrays[key] = from_host(arr, stamp)
        return manifest, arrays

    def import_prefixes(self, view) -> tuple[int, float]:
        """Re-import the prefix store into a (typically fresh) fabric:
        allocate pages under the view's placement cycle, scatter the K/V
        bytes, re-register the chain keys, and pin the chains so they
        survive until real traffic re-shares them. Chains that no longer
        fit the view's quota are skipped (never-abort). Returns
        ``(pages_restored, seconds)``."""
        fabric = self.fabric
        manifest, arrays = self._load_store()
        if manifest is None:
            return 0, 0.0
        pool = view.pool
        if manifest["geometry"] != self._geometry(pool):
            raise ValueError(
                f"prefix store geometry {manifest['geometry']} does not "
                f"match importing pool {self._geometry(pool)}")
        ps = pool.page_size
        restored, seconds = 0, 0.0
        for ch in manifest["chains"]:
            tokens = ch["tokens"]
            pages: list[int] = []
            matched = view.probe_prefix(tokens, pages, count=False)
            fresh: list[int] = []
            try:
                for _ in range(matched // ps, len(tokens) // ps):
                    fresh.append(view.append_page(pages))
            except RuntimeError:           # quota full: keep earlier chains
                view.release(pages)
                break
            if fresh:
                idx = list(range(matched // ps, len(tokens) // ps))
                _scatter(pool.k_pool, fresh, arrays[ch["k"]][:, idx])
                _scatter(pool.v_pool, fresh, arrays[ch["v"]][:, idx])
                secs = self._tier_seconds(view, fresh)
                seconds += secs
                fabric.emit("restore", view=view.name, pages=len(fresh),
                            seconds=secs)
            view.register_prefix(tokens, pages, len(tokens))
            key = (view.name, tuple(tokens))
            if key in self._pins:
                view.release(pages)        # chain already held by a pin
                self.touch_pin(key)
            else:
                self._pin_clock += 1
                self._pins[key] = {"view": view.name, "tokens": list(tokens),
                                   "pages": pages, "stamp": self._pin_clock}
            restored += len(fresh)
        return restored, seconds

    # -- peer page export / import --------------------------------------------

    def export_range(self, view, pages: Sequence[int], mesh=None, *,
                     tokens: Sequence[int] | None = None,
                     ntokens: int | None = None) -> dict:
        """Serialize a live page range: table slice (refcounts + trie
        chains restricted to the range), physical K/V bytes (CPU tensors),
        the exporter's ledger charges, and the mesh/sharding layout stamp.
        Non-destructive: the exporter keeps its pages — the peer adopts a
        copy.

        ``tokens``/``ntokens`` annotate the range with its token path and
        valid-token count so a peer with a *different* page size can
        re-chunk the bytes (cluster/convert.py) — without them a mismatched
        import has no way to rebuild chain keys or trim write padding."""
        pool = view.pool
        pages = [int(p) for p in pages]
        assert all(p >= 0 for p in pages), \
            "export a live page range, not tier handles"
        pageset = set(pages)
        k = _gather(pool.k_pool, pages)
        v = _gather(pool.v_pool, pages)
        blob = {
            "kind": "page_range",
            "geometry": self._geometry(pool),
            "layout": kv_layout_metadata(pool.cfg, pool.page_size, mesh),
            "pages": pages,
            "tokens": None if tokens is None else [int(t) for t in tokens],
            "ntokens": int(ntokens if ntokens is not None
                           else len(pages) * pool.page_size),
            "ref": {int(p): int(view.table.ref.get(p, 0)) for p in pages},
            "chains": view.table.export_chains(
                select=lambda pid: pid in pageset),
            "ledger": {
                "view": view.name,
                "per_domain_pages": np.bincount(
                    [pool.domain_of(p) for p in pages],
                    minlength=len(pool.domains)).tolist(),
                "bytes": len(pages) * pool.page_bytes,
            },
            "staging": self._staging_plan(pool, [_nbytes(k) + _nbytes(v)]),
            "k": k, "v": v,
            "sha256": {"k": _digest(k), "v": _digest(v)},
        }
        return blob

    def import_range(self, view, blob: dict) -> tuple[list[int], float]:
        """Adopt an exported page range into this fabric: allocate under
        the importing view's placement cycle and quota ledger, scatter the
        bytes, and rebuild the range's trie chains under remapped ids.
        Returns ``(new_ids, seconds)``; both fabrics' ledgers balance (the
        exporter still charges its copy, the importer charges its own)."""
        fabric = self.fabric
        pool = view.pool
        assert blob["kind"] == "page_range"
        if blob["geometry"] != self._geometry(pool):
            raise ValueError(
                f"page-range geometry {blob['geometry']} does not match "
                f"importing pool {self._geometry(pool)}")
        if _digest(blob["k"]) != blob["sha256"]["k"] \
                or _digest(blob["v"]) != blob["sha256"]["v"]:
            raise IOError("checksum mismatch in page-range blob")
        new_ids: list[int] = []
        for _ in blob["pages"]:
            view.append_page(new_ids)
        _scatter(pool.k_pool, new_ids, blob["k"])
        _scatter(pool.v_pool, new_ids, blob["v"])
        mapping = {int(old): new for old, new in zip(blob["pages"], new_ids)}
        view.table.import_chains(
            blob["chains"], lambda ch: [mapping[int(p)] for p in ch["phys"]])
        seconds = self._tier_seconds(view, new_ids)
        fabric.emit("restore", view=view.name, pages=len(new_ids),
                    seconds=seconds)
        return new_ids, seconds


def serialize_range(blob: dict) -> bytes:
    """Wire format for a page-range export: length-prefixed JSON header
    followed by the two ``np.save`` payloads. Peers on other hosts adopt
    ranges from exactly these bytes. Payloads travel as uint8 views (the
    last dim times the element size), and the importer restores the
    geometry stamp's dtype."""
    head = {key: val for key, val in blob.items() if key not in ("k", "v")}
    raw = json.dumps(head).encode()
    buf = io.BytesIO()
    buf.write(len(raw).to_bytes(8, "little"))
    buf.write(raw)
    np.save(buf, host_array(blob["k"]).view(np.uint8), allow_pickle=False)
    np.save(buf, host_array(blob["v"]).view(np.uint8), allow_pickle=False)
    return buf.getvalue()


def deserialize_range(data: bytes) -> dict:
    buf = io.BytesIO(data)
    n = int.from_bytes(buf.read(8), "little")
    blob = json.loads(buf.read(n).decode())
    dtype = torch_dtype(blob["geometry"]["dtype"])
    blob["k"] = torch.from_numpy(np.load(buf, allow_pickle=False)).view(dtype)
    blob["v"] = torch.from_numpy(np.load(buf, allow_pickle=False)).view(dtype)
    return blob
