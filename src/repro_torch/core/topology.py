"""Topology descriptions: NUMA machines (paper's machine A/B) and TPU systems.

The paper models a NUMA system as N nodes with an asymmetric bandwidth
function ``bw(n_src -> n_dst)``: the bandwidth a thread running on *worker*
node ``dst`` can use when reading from memory node ``src`` (paper §III-A2).

We keep exactly that abstraction, and extend it to TPU systems where the
"nodes" are *memory domains* (a chip's local HBM, pod-peer HBM at k ICI hops,
cross-pod HBM over DCI, host DRAM over PCIe) — see DESIGN.md §2.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np

GB = 1e9  # bandwidth unit: bytes/s expressed in GB/s throughout core/


@dataclasses.dataclass(frozen=True)
class Topology:
    """A set of memory nodes with an asymmetric bandwidth matrix.

    Attributes:
      name: human-readable identifier.
      bw: (N, N) array, ``bw[src, dst]`` = GB/s a thread at node ``dst``
        reads from memory at node ``src`` (nominal, uncontended).
      mc_bw: (N,) per-node memory-controller aggregate bandwidth (GB/s).
        Caps the sum of all demand served by node ``src``.
      cores_per_node: hardware threads per node (for the simulator).
      link_groups: optional mapping of (src, dst) -> link id; paths sharing a
        link id contend for that link's bandwidth (interconnect congestion,
        paper §III-A3). By default each directed pair is its own link.
    """

    name: str
    bw: np.ndarray
    mc_bw: np.ndarray
    cores_per_node: int
    link_groups: dict | None = None

    @property
    def num_nodes(self) -> int:
        return int(self.bw.shape[0])

    def nodes(self) -> range:
        return range(self.num_nodes)

    def local_bw(self, n: int) -> float:
        return float(self.bw[n, n])

    def validate(self) -> None:
        assert self.bw.ndim == 2 and self.bw.shape[0] == self.bw.shape[1]
        assert (self.bw > 0).all(), "bandwidths must be positive"
        assert self.mc_bw.shape == (self.num_nodes,)


def _hop_matrix_machine_a() -> np.ndarray:
    """Hop counts for an 8-node, 4-socket Opteron 6272 (2 dies per socket).

    Dies (2i, 2i+1) share a socket (fast internal HT link). Sockets form a
    partially-connected square — some die pairs are directly connected,
    others need 2 hops, matching the strongly asymmetric topology of the
    paper's Fig. 1a (amplitude: lowest path BW 5.8x below local).
    """
    n = 8
    hops = np.full((n, n), 2, dtype=np.int64)
    np.fill_diagonal(hops, 0)
    direct = [
        (0, 1), (2, 3), (4, 5), (6, 7),          # intra-socket
        (0, 2), (1, 3), (4, 6), (5, 7),          # intra-board neighbours
        (0, 4), (1, 5),                          # cross-board links (few)
        (2, 6),
    ]
    for a, b in direct:
        hops[a, b] = hops[b, a] = 1
    return hops


def machine_a() -> Topology:
    """The paper's machine A: 8-node AMD Opteron 6272, 8 cores/node, 64 GB.

    Reconstructed from the paper's constraints (§IV): local:nearest BW ratio
    1.7x, local:farthest 5.1x, global amplitude (max/min incl. asymmetric
    directions) 5.8x. Absolute scale ~ Opteron-era STREAM numbers.
    """
    local = 12.0  # GB/s per-node local memory bandwidth
    hops = _hop_matrix_machine_a()
    n = hops.shape[0]
    bw = np.zeros((n, n))
    for s, d in itertools.product(range(n), range(n)):
        if s == d:
            bw[s, d] = local
        elif hops[s, d] == 1:
            bw[s, d] = local / 1.7          # ~7.06
        else:
            bw[s, d] = local / 5.1          # ~2.35
    # Directional asymmetry: several HT links are narrower in one direction
    # (paper: "possibly distinct BWs for each communication direction").
    for s, d, f in [(3, 1, 0.85), (5, 4, 0.9), (7, 2, 0.88), (6, 0, 0.88),
                    (2, 7, 0.95), (1, 6, 0.92)]:
        bw[s, d] *= f
    # weakest direction hits local/5.8
    bw[7, 0] = local / 5.8
    mc = np.full(n, local * 1.6)  # controller serves local+remote readers
    return Topology(name="machineA", bw=bw, mc_bw=mc, cores_per_node=8)


def machine_b() -> Topology:
    """The paper's machine B: 2-socket Xeon E5-2660 v4, Cluster-on-Die,
    4 NUMA nodes, 7 cores/node, 32 GB. Milder asymmetry: local:nearest 1.8x,
    amplitude 2.3x.
    """
    local = 30.0
    n = 4
    bw = np.zeros((n, n))
    same_socket = {(0, 1), (1, 0), (2, 3), (3, 2)}
    for s, d in itertools.product(range(n), range(n)):
        if s == d:
            bw[s, d] = local
        elif (s, d) in same_socket:
            bw[s, d] = local / 1.8          # ~16.7
        else:
            bw[s, d] = local / 2.3          # ~13.0 (QPI cross-socket)
    mc = np.full(n, local * 1.3)
    return Topology(name="machineB", bw=bw, mc_bw=mc, cores_per_node=7)


# ---------------------------------------------------------------------------
# TPU memory-domain topologies
# ---------------------------------------------------------------------------

#: TPU v5e hardware constants (also used by roofline/).
V5E_PEAK_FLOPS = 197e12          # bf16 FLOP/s per chip
V5E_HBM_BW = 819.0               # GB/s per chip
V5E_ICI_BW = 50.0                # GB/s per ICI link per direction
V5E_DCI_BW = 12.5                # GB/s effective per-chip cross-pod (optical/DCN)
V5E_PCIE_BW = 16.0               # GB/s host<->chip


@dataclasses.dataclass(frozen=True)
class TpuDomainSpec:
    """One memory domain visible to a worker chip (DESIGN.md §2 table)."""

    name: str
    capacity_gb: float
    # bandwidth from this domain to each worker chip is derived by the
    # function below and stored in the Topology matrix.


def tpu_domains_topology(
    *,
    num_pods: int = 2,
    worker_pod: int = 0,
    ici_hops_tiers: Sequence[int] = (1, 2, 4),
    hbm_gb: float = 16.0,
) -> tuple[Topology, list[str], list[int]]:
    """Build a BWAP ``Topology`` over TPU memory domains for one worker chip
    group.

    Domains (in order):
      0: local HBM of the worker chips            bw = HBM
      1..k: pod-peer HBM reachable at h ICI hops  bw = ICI / h
      k+1..: remote-pod HBM (per extra pod)       bw = DCI
      last: host DRAM                             bw = PCIe

    Returns (topology, domain names, worker domain indices). The Topology is
    degenerate-NUMA: every worker reads through the same domain list, so the
    bw matrix has identical columns — which is exactly the single-worker
    special case of the paper (Eq. 2). Multi-partition co-scheduling builds
    one topology per partition with shifted tiers.
    """
    names = ["hbm_local"]
    bws = [V5E_HBM_BW]
    caps = [hbm_gb]
    for h in ici_hops_tiers:
        names.append(f"hbm_peer_{h}hop")
        bws.append(V5E_ICI_BW / h)
        caps.append(hbm_gb)
    for p in range(num_pods):
        if p == worker_pod:
            continue
        names.append(f"hbm_pod{p}")
        bws.append(V5E_DCI_BW)
        caps.append(hbm_gb)
    names.append("host_dram")
    bws.append(V5E_PCIE_BW)
    caps.append(512.0)

    n = len(names)
    bw = np.tile(np.asarray(bws)[:, None], (1, n))  # bw[src, dst] same per dst
    mc = np.asarray([V5E_HBM_BW] * (n - 1) + [100.0])
    topo = Topology(name=f"tpu_v5e_{num_pods}pod", bw=bw, mc_bw=mc,
                    cores_per_node=1)
    return topo, names, [0]
