"""BWAP on the TPU memory system, on the PyTorch port: the port of
``benchmarks/bwap_tpu.py`` (DESIGN.md §2). Weighted KV-page placement and
weighted optimizer-tier placement against the uniform and naive
baselines, priced with the paper's Eq.-1 max-parallel-transfer model
over the v5e bandwidths of ``repro_torch.core.topology`` (the reference's
domain table, kept as it is: an H100 table is a later feature) and
``repro_torch.sharding.zero``'s tier splits. Pure numpy: the dicts equal
the reference's to the last bit.

    PYTHONPATH=src python -m benchmarks.torch_bwap_tpu
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.core import topology
from repro_torch.sharding import zero


def kv_placement() -> dict:
    """Decode-time KV reads: weighted interleave across HBM/ICI/DCI/PCIe
    domains vs uniform-all, uniform-workers (=all-local), for a
    long-context sequence that exceeds the local HBM budget."""
    topo, names, workers = topology.tpu_domains_topology()
    bw = topo.bw[:, 0]                        # GB/s per domain
    canon = bw / bw.sum()

    # 500k-token KV cache, hymba-like: bytes per domain read per step
    kv_gb = 0.67      # 524288 x 5 kv-heads x 64 x 2 x 2B (per layer set)

    def read_time(weights):
        w = np.asarray(weights) / np.sum(weights)
        return float(np.max(w * kv_gb / bw))

    # local HBM can hold only 40% of this cache
    local_cap = 0.4
    uniform_all = np.full(len(bw), 1.0 / len(bw))
    spill_naive = np.zeros(len(bw))
    spill_naive[0] = local_cap                # fill local, spill rest to host
    spill_naive[-1] = 1.0 - local_cap
    bwap = canon.copy()
    if bwap[0] > local_cap:                   # capacity-clamped canonical
        extra = bwap[0] - local_cap
        bwap[0] = local_cap
        rest = bwap[1:] / bwap[1:].sum()
        bwap[1:] += extra * rest

    return {
        "domains": names,
        "bandwidths_gbps": bw.tolist(),
        "read_time_uniform_all_ms": read_time(uniform_all) * 1e3,
        "read_time_hbm_spill_host_ms": read_time(spill_naive) * 1e3,
        "read_time_bwap_ms": read_time(bwap) * 1e3,
        "speedup_vs_uniform": read_time(uniform_all) / read_time(bwap),
        "speedup_vs_spill": read_time(spill_naive) / read_time(bwap),
    }


def optimizer_tiers() -> dict:
    """Offloaded optimizer-state streaming: the compute chip's own HBM is
    fully budgeted, so Adam pages live in remote domains (pod-peer spare
    HBM over ICI, cross-pod spare HBM over DCI, host DRAM over PCIe). The
    single-worker Eq. 2 says stream from all of them in proportion to
    bandwidth; the naive policies are peer-first spill (the first-touch
    analogue) and uniform (the uniform-workers analogue)."""
    page_bytes = 1 << 20
    state_gb = 240.0 / 256                   # per chip after ZeRO sharding
    num_pages = int(state_gb * 2 ** 30 / page_bytes)
    tiers = [
        zero.TierSpec("peer_hbm_ici", topology.V5E_ICI_BW,
                      int(num_pages * 0.5)),
        zero.TierSpec("pod1_hbm_dci", topology.V5E_DCI_BW, num_pages),
        zero.TierSpec("host_dram", topology.V5E_PCIE_BW, num_pages),
    ]
    t_bwap = zero.stream_update_time(
        zero.tier_split(num_pages, tiers), tiers, page_bytes)
    t_uniform = zero.stream_update_time(
        zero.uniform_split(num_pages, tiers), tiers, page_bytes)
    t_peer_first = zero.stream_update_time(
        zero.hbm_first_split(num_pages, tiers), tiers, page_bytes)
    return {
        "pages": num_pages,
        "update_ms_bwap": t_bwap * 1e3,
        "update_ms_uniform": t_uniform * 1e3,
        "update_ms_peer_first_spill": t_peer_first * 1e3,
        "speedup_vs_uniform": t_uniform / t_bwap,
        "speedup_vs_peer_first": t_peer_first / t_bwap,
    }


if __name__ == "__main__":
    print(json.dumps({"kv_placement": kv_placement(),
                      "optimizer_tiers": optimizer_tiers()}, indent=1))
