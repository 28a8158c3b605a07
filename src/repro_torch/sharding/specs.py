"""KV-pool layout spec (port of ``repro.sharding.specs``'s ``_axis_size``,
``_fit`` and ``kv_pool_spec``).

A spec is a plain tuple with one entry per array dim — ``None``, a mesh
axis name, or a tuple of names — where the reference returns a
``PartitionSpec`` of the same entries. The persistence tier stamps it onto
page-range exports (``placement/persist.py``), so the entries, not the
type, are what must match. The parameter rules wait for training
(``ROADMAP.md`` queue 1 item 10).
"""

from __future__ import annotations

import numpy as np

Tail = tuple  # trailing-dim spec entries (None | str | tuple[str, ...])


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, str):
        return mesh.shape[entry]
    return int(np.prod([mesh.shape[a] for a in entry]))


def _fit(mesh, shape: tuple[int, ...], tail: Tail) -> tuple:
    """Pad the tail to ndim with leading Nones; drop non-dividing axes."""
    ndim = len(shape)
    tail = tuple(tail)[-ndim:] if len(tail) > ndim else tail
    full = (None,) * (ndim - len(tail)) + tuple(tail)
    out = []
    for dim, entry in zip(shape, full):
        if entry is not None and dim % _axis_size(mesh, entry) == 0:
            out.append(entry)
        else:
            out.append(None)
    return tuple(out)


def kv_pool_spec(cfg, mesh, page_size: int) -> tuple:
    """Layout spec for a paged KV pool ``[L, pages, page_size, nkv, hd]``.

    KV heads shard over 'model' when they divide; the page axis stays
    replicated — the page table, not the sharding, is the placement
    mechanism there. This is the layout metadata a fabric stamps onto peer
    page-range exports (persistence tier, DESIGN.md §9) so an importer can
    check the bytes were produced under a compatible sharding.
    """
    shape = (cfg.num_layers, 1, page_size, cfg.num_kv_heads, cfg.head_dim_)
    return _fit(mesh, shape, (None, None, None, "model", None))
