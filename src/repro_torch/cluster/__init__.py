"""Disaggregated serving cluster (DESIGN.md §13; port of ``repro.cluster``).

Prefill/decode disaggregation over the fabric's page wire: the
interconnect between a prefill host and a decode host is one more
asymmetric, contended link in the paper's bandwidth model —
:mod:`interconnect` prices a KV handoff with Eq.-1 per-link rows and
stripes it Eq.-5-style across asymmetric links, :mod:`transport` carries
the persistence tier's wire format between two fabrics that share no pool,
:mod:`convert` re-chunks/reshards a mismatched peer layout on import
instead of raising, and :mod:`router` splits each prompt into a prefill
admission and a decode handoff (falling back to single-host serving when
the wire is saturated).
"""

from repro_torch.cluster.convert import convert_range
from repro_torch.cluster.interconnect import Interconnect, Link
from repro_torch.cluster.router import ClusterRouter
from repro_torch.cluster.transport import PageChannel

__all__ = ["Interconnect", "Link", "PageChannel", "convert_range",
           "ClusterRouter"]
