"""Message-passing page channel between two fabrics (DESIGN.md §13; port
of ``repro.cluster.transport``).

The persistence tier's wire format (``persist.serialize_range``:
length-prefixed JSON header + two ``np.save`` payloads) already carries
everything a peer needs to adopt a page range; this module moves those
bytes between two :class:`~repro_torch.placement.fabric.MemoryFabric`
instances that share **no pool**, over an
:class:`~repro_torch.cluster.interconnect.Interconnect`:

- sends are **chunked** onto the wire — each chunk occupies the link's
  virtual clock in turn, so a large handoff is preemptible by the
  model's accounting and its cost is visible as queueing delay to later
  sends;
- each transfer is **billed to the drift ledger** (``link_transfer``
  kind) when a probe supplies a measured time, which also
  EWMA-calibrates the wire's effective bandwidth;
- both ends **emit fabric events** (``link_send`` / ``link_recv``) that
  the observatory turns into labeled byte/chunk counters and Perfetto
  spans;
- a geometry/layout mismatch on the receiving side is **converted**
  (:func:`repro_torch.cluster.convert.convert_range`) instead of raising.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

from repro_torch.cluster.convert import convert_range
from repro_torch.placement.persist import (deserialize_range,
                                           kv_layout_metadata,
                                           serialize_range)


@dataclasses.dataclass
class Parcel:
    """One serialized page range in flight on the wire."""

    data: bytes
    sent_s: float            # sender clock when the send was issued
    arrive_s: float          # wire clock when the last chunk lands
    chunks: int


class PageChannel:
    """Ordered, chunked channel from one fabric's tier to another's."""

    def __init__(self, interconnect, *, chunk_bytes: int = 1 << 16,
                 probe=None):
        assert chunk_bytes >= 1
        self.link = interconnect
        self.chunk_bytes = int(chunk_bytes)
        # probe("link_transfer", nbytes) -> measured seconds (or None to
        # skip): wall clock on a real wire, planted truth in benchmarks
        self.probe = probe
        self._inflight: collections.deque[Parcel] = collections.deque()
        self.sent_parcels = 0
        self.recv_parcels = 0
        self.converted_imports = 0

    def pending(self) -> int:
        return len(self._inflight)

    # -- send ------------------------------------------------------------------

    def send(self, src_view, pages: Sequence[int], *, now: float,
             tokens: Sequence[int] | None = None,
             ntokens: int | None = None, mesh=None) -> Parcel:
        """Export ``pages`` from the sending fabric's tier and put the
        serialized bytes on the wire in ``chunk_bytes`` chunks. Returns
        the in-flight :class:`Parcel`; the matching :meth:`recv` adopts
        it on the other fabric. Non-destructive for the sender."""
        fabric = src_view.fabric
        tier = fabric.persist
        assert tier is not None, "sending fabric has no persistent tier"
        blob = tier.export_range(src_view, pages, mesh,
                                 tokens=tokens, ntokens=ntokens)
        data = serialize_range(blob)
        nbytes = len(data)
        chunks = -(-nbytes // self.chunk_bytes)
        start0 = max(float(now), self.link.busy_until)
        arrive, left = float(now), nbytes
        for _ in range(chunks):
            step = min(self.chunk_bytes, left)
            s, secs = self.link.send(step, now)
            arrive = s + secs
            left -= step
        seconds = arrive - start0
        obs = fabric.obs
        if obs is not None and obs.drift is not None \
                and self.probe is not None:
            measured = self.probe("link_transfer", nbytes)
            if measured is not None:
                obs.drift.observe_scalar("link_transfer", seconds,
                                         float(measured))
                self.link.calibrate(nbytes, float(measured))
        fabric.emit("link_send", view=src_view.name, bytes=nbytes,
                    chunks=chunks, seconds=seconds)
        parcel = Parcel(data=data, sent_s=float(now), arrive_s=arrive,
                        chunks=chunks)
        self._inflight.append(parcel)
        self.sent_parcels += 1
        return parcel

    # -- receive ---------------------------------------------------------------

    def recv(self, dst_view, *, mesh=None) -> tuple[list[int], Parcel,
                                                    float]:
        """Adopt the oldest in-flight parcel into the receiving fabric:
        deserialize, convert when the peer's geometry or layout differs
        from the importer's, and import under the view's own placement
        cycle and ledger. Returns ``(new_ids, parcel, import_seconds)``;
        the caller owns releasing ``new_ids`` when the adopted range is
        no longer needed."""
        assert self._inflight, "no parcel in flight"
        parcel = self._inflight.popleft()
        fabric = dst_view.fabric
        tier = fabric.persist
        assert tier is not None, "receiving fabric has no persistent tier"
        blob = deserialize_range(parcel.data)
        pool = dst_view.pool
        want_geometry = tier._geometry(pool)
        want_layout = kv_layout_metadata(pool.cfg, pool.page_size, mesh)
        if blob["geometry"] != want_geometry \
                or blob.get("layout") != want_layout:
            blob = convert_range(blob, geometry=want_geometry,
                                 layout=want_layout)
            self.converted_imports += 1
        new_ids, seconds = tier.import_range(dst_view, blob)
        fabric.emit("link_recv", view=dst_view.name, pages=len(new_ids),
                    bytes=len(parcel.data), seconds=seconds)
        self.recv_parcels += 1
        return new_ids, parcel, seconds

    def stats(self) -> dict:
        return {
            "sent_parcels": self.sent_parcels,
            "recv_parcels": self.recv_parcels,
            "pending": self.pending(),
            "converted_imports": self.converted_imports,
            "chunk_bytes": self.chunk_bytes,
            "link": self.link.stats(),
        }
