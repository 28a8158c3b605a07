"""Placement runtime: memory fabric, physical pool, page table, policies,
batched migration executor, per-domain telemetry."""

from repro_torch.placement import policy
from repro_torch.placement.executor import MigrationExecutor, MigrationResult
from repro_torch.placement.fabric import (FabricView, MemoryFabric, SlotLoan,
                                          as_view)
from repro_torch.placement.telemetry import DomainTelemetry, Ring

__all__ = [
    "policy",
    "MigrationExecutor",
    "MigrationResult",
    "DomainTelemetry",
    "Ring",
    "MemoryFabric",
    "FabricView",
    "SlotLoan",
    "as_view",
]
