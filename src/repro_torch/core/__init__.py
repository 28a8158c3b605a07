"""BWAP core: Eq. 1/2/5 weights, Alg.-1 weighted interleave, DWP tuner."""

from repro_torch.core import bwmodel, dwp, interleave, topology
from repro_torch.core.dwp import CoScheduledTuner, DWPConfig, DWPTuner
from repro_torch.core.interleave import (dwp_weights, plan_migration,
                                         weighted_interleave)
from repro_torch.core.topology import Topology, machine_a, machine_b

__all__ = [
    "bwmodel", "dwp", "interleave", "topology",
    "CoScheduledTuner", "DWPConfig", "DWPTuner",
    "dwp_weights", "plan_migration", "weighted_interleave",
    "Topology", "machine_a", "machine_b",
]
