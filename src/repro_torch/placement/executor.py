"""Migration executor: page moves as batched torch gather/scatter.

Port of ``repro.placement.executor``. The reference pool is functional, so
its executor returns new arrays; here the pool tensors are written in place:
one ``index_select`` (the gather, which copies every source page first) and
one ``index_copy_`` (the scatter) per array, independent of how many pages
move. Reading all sources before writing any destination keeps a move
whose source and destination sets overlap correct.

Moves are expressed as parallel ``src_ids``/``dst_ids`` index vectors over
the page axis. The methods still return ``(arrays, MigrationResult)`` with
the same (updated) tensors, so call sites read like the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MigrationResult:
    """What a batch of moves did, for telemetry and benchmarks."""

    num_moves: int
    bytes_moved: int                      # across all arrays
    pair_pages: dict                      # (src_domain, dst_domain) -> pages

    @staticmethod
    def empty() -> "MigrationResult":
        return MigrationResult(0, 0, {})


def _page_bytes(array: torch.Tensor, page_axis: int) -> int:
    """Bytes of one page slice of ``array``."""
    per = array.element_size()
    for i, s in enumerate(array.shape):
        if i != page_axis:
            per *= int(s)
    return per


def pair_histogram(src_domains: np.ndarray,
                   dst_domains: np.ndarray) -> dict:
    """Group move counts by (src_domain, dst_domain)."""
    pairs = {}
    for s, d in zip(np.asarray(src_domains), np.asarray(dst_domains)):
        key = (int(s), int(d))
        pairs[key] = pairs.get(key, 0) + 1
    return pairs


def _index(ids: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(ids).to(like.device)


class MigrationExecutor:
    """Executes move lists against torch page pools, in place.

    Stateless aside from an optional telemetry sink.
    """

    def __init__(self, telemetry=None):
        self.telemetry = telemetry

    # -- same-pool moves -----------------------------------------------------

    def execute(self, arrays: Sequence[torch.Tensor], src_ids, dst_ids, *,
                page_axis: int = 1, src_domains=None, dst_domains=None):
        """Copy pages ``src_ids -> dst_ids`` inside each array, in place.

        One gather + one scatter per array regardless of the number of moves.
        Returns ``(arrays, MigrationResult)``.
        """
        src = np.asarray(src_ids, dtype=np.int64)
        dst = np.asarray(dst_ids, dtype=np.int64)
        assert src.shape == dst.shape
        if src.size == 0:
            return list(arrays), MigrationResult.empty()
        nbytes = 0
        for a in arrays:
            sidx, didx = _index(src, a), _index(dst, a)
            a.index_copy_(page_axis, didx, a.index_select(page_axis, sidx))
            nbytes += _page_bytes(a, page_axis) * src.size
        result = MigrationResult(
            num_moves=int(src.size), bytes_moved=int(nbytes),
            pair_pages=(pair_histogram(src_domains, dst_domains)
                        if src_domains is not None else {}))
        self._record(result)
        return list(arrays), result

    # -- cross-pool moves (pool rebalance / resize) --------------------------

    def copy(self, src_arrays: Sequence[torch.Tensor],
             dst_arrays: Sequence[torch.Tensor], src_ids, dst_ids, *,
             page_axis: int = 1):
        """Scatter pages of ``src_arrays`` into ``dst_arrays`` in place
        (which may have a different page-axis length — used when a pool is
        rebuilt on rebalance). Returns ``(dst_arrays, MigrationResult)``."""
        src = np.asarray(src_ids, dtype=np.int64)
        dst = np.asarray(dst_ids, dtype=np.int64)
        assert src.shape == dst.shape
        if src.size == 0:
            return list(dst_arrays), MigrationResult.empty()
        nbytes = 0
        for a_src, a_dst in zip(src_arrays, dst_arrays):
            a_dst.index_copy_(page_axis, _index(dst, a_dst),
                              a_src.index_select(page_axis,
                                                 _index(src, a_src)))
            nbytes += _page_bytes(a_src, page_axis) * src.size
        result = MigrationResult(int(src.size), int(nbytes), {})
        self._record(result)
        return list(dst_arrays), result

    # -- reference path ------------------------------------------------------

    def execute_looped(self, arrays: Sequence[torch.Tensor], src_ids,
                       dst_ids, *, page_axis: int = 1):
        """The per-page loop, kept as an oracle for tests: one page copy
        at a time, in move order, in place. Do not use on hot paths."""
        src = np.asarray(src_ids, dtype=np.int64)
        dst = np.asarray(dst_ids, dtype=np.int64)
        for s, d in zip(src, dst):
            for a in arrays:
                a.select(page_axis, int(d)).copy_(a.select(page_axis, int(s)))
        nbytes = sum(_page_bytes(a, page_axis) for a in arrays) * src.size
        return list(arrays), MigrationResult(int(src.size), int(nbytes), {})

    def _record(self, result: MigrationResult) -> None:
        if self.telemetry is None or result.num_moves == 0:
            return
        if result.pair_pages:
            per_page = result.bytes_moved // max(result.num_moves, 1)
            for (s, d), pages in result.pair_pages.items():
                self.telemetry.record_migration(s, d, pages,
                                                pages * per_page)
        else:
            self.telemetry.record_executed(result.num_moves)
