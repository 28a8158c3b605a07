"""BWAP core: Eq. 1/2/5 weights, Alg.-1 weighted interleave, DWP tuner,
the canonical tuner and the paper's NUMA simulator."""

from repro_torch.core import (bwmodel, canonical, dwp, interleave, simulator,
                              topology)
from repro_torch.core.canonical import CanonicalTuner
from repro_torch.core.dwp import CoScheduledTuner, DWPConfig, DWPTuner
from repro_torch.core.interleave import (dwp_weights, plan_migration,
                                         weighted_interleave)
from repro_torch.core.simulator import PAPER_WORKLOADS, NumaSimulator
from repro_torch.core.topology import Topology, machine_a, machine_b

__all__ = [
    "bwmodel", "canonical", "dwp", "interleave", "simulator", "topology",
    "CanonicalTuner", "CoScheduledTuner", "DWPConfig", "DWPTuner",
    "dwp_weights", "plan_migration", "weighted_interleave",
    "PAPER_WORKLOADS", "NumaSimulator", "Topology", "machine_a", "machine_b",
]
