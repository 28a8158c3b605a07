"""Layout conversion on import (DESIGN.md §13; port of
``repro.cluster.convert``).

A page-range blob is stamped with the exporter's geometry (page size,
block shapes) and layout (mesh axes, KV-pool partition spec). A
disaggregated cluster cannot afford a mismatched import that raises — a
prefill host and a decode host legitimately run different page sizes
(prefill wants large pages for sequential writes, decode small ones for
fine-grained sharing) and different meshes. :func:`convert_range`
re-chunks/reshards the blob into the importer's geometry instead,
bit-exact per token:

- **Layout-only mismatch** (mesh axes / ``kv_pool_spec``): the wire
  carries full host-side arrays — sharding is a placement property of
  the *device* pools, not of the bytes — so conversion is a metadata
  restamp, trivially bit-exact.
- **Page-size mismatch**: the per-token trailing dims must agree (same
  ``kind``, dtype, layer count, block tails); then the k/v tensors
  re-chunk token-exactly — flatten pages to a token axis, trim the
  exporter's tail padding (``ntokens``), zero-pad to the importer's page
  boundary, re-fold. Chain keys rebuild from the blob's token path over
  *full* destination pages only (a partial tail page carries real bytes
  but no trie key; the importer's prefill recomputes past it).
- **Anything deeper** (different head counts, dtypes, cache kinds) is a
  recompute, not a re-layout: still a ``ValueError``.

The blob's k/v are host tensors (``placement/persist.py``); the re-chunk
runs where they lie.
"""

from __future__ import annotations

import hashlib

import torch

from repro_torch.checkpoint.ckpt import host_array


def _sha256(t: torch.Tensor) -> str:
    return hashlib.sha256(host_array(t).tobytes()).hexdigest()


def _require(cond: bool, what: str, a, b) -> None:
    if not cond:
        raise ValueError(
            f"cannot convert page range: {what} differs "
            f"({a!r} -> {b!r}) — that is a recompute, not a re-layout")


def convert_range(blob: dict, *, geometry: dict, layout: dict) -> dict:
    """Return a blob importable under ``geometry``/``layout``.

    Same geometry and layout passes through untouched; a layout-only
    mismatch restamps; a page-size mismatch re-chunks the k/v payloads
    token-exactly (see module docstring). Raises ``ValueError`` when the
    source and target disagree on per-token facts.
    """
    src = dict(blob["geometry"])
    dst = dict(geometry)
    if src == dst and blob.get("layout") == layout:
        return blob
    for key in ("kind", "dtype", "num_layers"):
        _require(src.get(key) == dst.get(key), key,
                 src.get(key), dst.get(key))
    for key in ("k_block", "v_block"):
        # trailing (per-token) dims must agree; the leading dim is the
        # page size, which is exactly what re-chunking changes
        _require(list(src.get(key, ()))[1:] == list(dst.get(key, ()))[1:],
                 f"{key} tail", src.get(key), dst.get(key))
    out = dict(blob)
    out["geometry"] = dst
    out["layout"] = layout
    ps_s, ps_d = int(src["page_size"]), int(dst["page_size"])
    if ps_s == ps_d:
        return out

    n_src = len(blob["pages"])
    ntokens = int(blob.get("ntokens") or n_src * ps_s)
    assert 0 < ntokens <= n_src * ps_s, (ntokens, n_src, ps_s)
    n_dst = -(-ntokens // ps_d)

    def rechunk(arr: torch.Tensor) -> torch.Tensor:
        arr = arr.contiguous()                 # [L, n_src, ps_s, *rest]
        nl = arr.shape[0]
        rest = tuple(arr.shape[3:])
        flat = arr.reshape(nl, n_src * ps_s, *rest)[:, :ntokens]
        pad = n_dst * ps_d - ntokens
        if pad:
            flat = torch.cat([flat, arr.new_zeros((nl, pad) + rest)], dim=1)
        return flat.reshape(nl, n_dst, ps_d, *rest).contiguous()

    out["k"] = rechunk(blob["k"])
    out["v"] = rechunk(blob["v"])
    out["pages"] = list(range(n_dst))
    out["ref"] = {int(p): 1 for p in out["pages"]}
    out["ntokens"] = ntokens
    out["converted"] = True
    chains = []
    tokens = blob.get("tokens")
    if tokens:
        n_full = min(len(tokens), ntokens) // ps_d
        if n_full:
            chains.append({
                "tokens": [int(t) for t in tokens[:n_full * ps_d]],
                "phys": list(range(n_full)),
            })
    out["chains"] = chains
    out["sha256"] = {"k": _sha256(out["k"]), "v": _sha256(out["v"])}
    return out
