"""Roofline terms of a dry-run cell on the H100 (port of
``repro.roofline.analyze``).

compute    = FLOPs per device / the card's dense bf16 peak
memory     = bytes per device / the card's HBM rate
collective = per-op bytes moved on the busiest link / the link's rate,
             summed. A collective whose group spans more than one node is
             costed at the node-to-node rate, one inside a node at
             NVLink's (the reference's cross-pod / intra-pod split).

``CollectiveOp``, ``RooflineTerms`` and ``terms_from_parts`` keep the
reference's arithmetic. The reference parses its collectives out of XLA's
optimized HLO (``parse_collectives``, ``_replica_group_info``); eager
PyTorch has no such program, so ``launch/dryrun.py`` builds the same
``CollectiveOp`` list from the port's layouts, with ``group_info`` giving
each group's size and reach. The FLOPs and bytes come from
``roofline/counter.py``.

Each part combined by ``terms_from_parts`` is ``{"flops", "bytes",
"collectives", "mult"}``: the reference's trip-count correction multiplies
a scan body counted once. Eager PyTorch runs, and counts, every trip of a
loop, so the dry-run's record passes its full part alone.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np

# NVIDIA H100 SXM5 80 GB (H100 datasheet, SXM5 column)
H100_PEAK_FLOPS = 989e12     # bf16 dense tensor-core FLOP/s (1979e12 sparse)
H100_HBM_BW = 3.35e12        # HBM3, B/s
H100_NVLINK_BW = 450e9       # NVLink 4, B/s per direction per GPU (900 GB/s
                             # total) inside an 8-GPU HGX/DGX node
H100_NODE_BW = 50e9          # B/s per GPU between nodes: one InfiniBand NDR
                             # 400 Gb/s adapter per GPU (DGX H100)
GPUS_PER_NODE = 8            # an HGX/DGX H100 node


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    crosses_pod: bool        # the group spans more than one node
    count: int = 1

    def per_chip_link_bytes(self) -> float:
        """Bytes crossing the busiest link per device (ring algorithms)."""
        n = max(self.group_size, 1)
        b = self.result_bytes
        if self.kind == "all-reduce":
            # in-place: result==operand size; ring moves 2(n-1)/n x size
            return 2.0 * b * (n - 1) / n
        if self.kind == "all-gather":
            # result is the gathered size; each device receives (n-1)/n
            return b * (n - 1) / n
        if self.kind == "reduce-scatter":
            # result is the scattered shard; (n-1) shards pass per device
            return b * (n - 1)
        if self.kind == "all-to-all":
            return b * (n - 1) / n
        if self.kind == "collective-permute":
            return float(b)
        return float(b)


def group_info(mesh_sizes: tuple[int, ...], group_dims: tuple[int, ...],
               gpus_per_node: int = GPUS_PER_NODE) -> tuple[int, bool]:
    """(group size, whether a group spans more than one node) of a
    collective over the mesh dims ``group_dims``, with devices numbered in
    row-major order of ``mesh_sizes`` and ``gpus_per_node`` consecutive
    devices a node (the counterpart of the reference's
    ``_replica_group_info``)."""
    sizes = tuple(int(s) for s in mesh_sizes)
    gsize = int(np.prod([sizes[d] for d in group_dims])) if group_dims \
        else 1
    if gsize <= 1:
        return 1, False
    rest = [d for d in range(len(sizes)) if d not in group_dims]
    ids = np.arange(int(np.prod(sizes))).reshape(sizes).transpose(
        rest + list(group_dims)).reshape(-1, gsize)
    nodes = ids // gpus_per_node
    return gsize, bool((nodes != nodes[:, :1]).any())


@dataclasses.dataclass
class RooflineTerms:
    """flops / bytes are per device, so flops / peak is the whole step's
    FLOPs over (devices x peak)."""

    flops: float                # per device
    bytes_hbm: float            # per device
    coll_ici_bytes: float       # per-device busiest-link bytes, in a node
    coll_dci_bytes: float       # per-device bytes crossing nodes
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / H100_PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / H100_HBM_BW

    @property
    def t_collective(self) -> float:
        return (self.coll_ici_bytes / H100_NVLINK_BW
                + self.coll_dci_bytes / H100_NODE_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "coll_ici_bytes": self.coll_ici_bytes,
            "coll_dci_bytes": self.coll_dci_bytes, "chips": self.chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "bottleneck": self.bottleneck,
        }


def terms_from_parts(parts: Iterable[dict], chips: int) -> RooflineTerms:
    """Combine (counts, collectives, multiplier) parts.

    Each part: {"flops": F, "bytes": B, "collectives": [CollectiveOp],
    "mult": k}, flops and bytes per device."""
    flops = bytes_hbm = ici = dci = 0.0
    for p in parts:
        k = p.get("mult", 1)
        flops += k * p.get("flops", 0.0)
        bytes_hbm += k * p.get("bytes", 0.0)
        for op in p.get("collectives", []):
            moved = op.per_chip_link_bytes()
            if op.crosses_pod:
                dci += k * moved
            else:
                ici += k * moved
    return RooflineTerms(flops=flops, bytes_hbm=bytes_hbm,
                         coll_ici_bytes=ici, coll_dci_bytes=dci, chips=chips)
