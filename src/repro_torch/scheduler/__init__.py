"""Request scheduler subsystem: priority continuous batching, chunked
prefill, and bandwidth-aware KV swap to slow memory domains (DESIGN.md §5).

- ``scheduler``: admission queue, batch composition, preemption.
- ``swap``: swap-slot reservation + BWAP-weighted swap placement.
- ``workload``: trace-driven request generators (deterministic seeds).
- ``slo``: TTFT / TPOT / goodput accounting under per-class deadlines.
"""

from repro_torch.scheduler.scheduler import (PriorityClass, Request,  # noqa: F401
                                       RequestScheduler, State, StepPlan)
from repro_torch.scheduler.slo import SloSpec, SloTracker  # noqa: F401
from repro_torch.scheduler.swap import KVSwapManager  # noqa: F401
from repro_torch.scheduler.workload import (TraceRequest,  # noqa: F401
                                      WorkloadSpec, generate,
                                      total_kv_pages)
