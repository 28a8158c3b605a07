"""Virtual-clock link model: the page wire as Eq.-1 rows (DESIGN.md §13;
port of ``repro.cluster.interconnect``).

BWAP's Eq. 1 prices a batch read as the max over per-domain transfer
times; a cluster interconnect is the same shape one level up — each
physical link between the prefill and decode hosts is an asymmetric,
contended row with its own bandwidth *and* a propagation latency the
intra-host domains don't have. :func:`repro_torch.core.bwmodel.stall_cost`
grew ``link_bytes``/``link_bw_gbps``/``link_latency_s`` rows for exactly
this, so a KV handoff is priced like any other domain read.

Striping follows the paper's Eq.-5 weighted interleave applied to the
wire: a transfer splits across the links proportionally to their
effective bandwidth (``optimal_weights`` over a one-worker profile), so
the slowest link stops being the bottleneck the way uniform spreading
would make it.

The wire runs on its own virtual clock: sends serialize behind
``busy_until``, queueing delay is observable (the router's saturation
fallback reads it), and measured transfers EWMA-calibrate
``bw_effective`` the same way the fabric calibrates its domain rows.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import bwmodel


@dataclasses.dataclass(frozen=True)
class Link:
    """One physical wire between the hosts."""

    name: str
    bw_gbps: float
    latency_s: float = 0.0

    def __post_init__(self):
        assert self.bw_gbps > 0 and self.latency_s >= 0.0


class Interconnect:
    """Eq.-1/Eq.-5 model of one directed host-to-host page wire."""

    def __init__(self, links: Sequence[Link], *,
                 calibration_alpha: float = 0.25):
        links = list(links)
        assert links, "an interconnect needs at least one link"
        self.links = links
        self.bw_nominal = np.asarray([l.bw_gbps for l in links],
                                     dtype=np.float64)
        self.bw_effective = self.bw_nominal.copy()
        self.latency_s = np.asarray([l.latency_s for l in links],
                                    dtype=np.float64)
        self._alpha = float(calibration_alpha)
        self.busy_until = 0.0           # wire virtual clock (seconds)
        self.sends = 0
        self.sent_bytes = 0
        self.busy_seconds = 0.0
        self.calibration_samples = 0

    # -- Eq.-5 weighted striping ----------------------------------------------

    def weights(self) -> np.ndarray:
        """Eq.-5 weights over the wire's links: proportional to effective
        bandwidth (one worker group, so minbw is the link bandwidth)."""
        return bwmodel.optimal_weights(self.bw_effective[:, None])

    def stripe(self, nbytes: int) -> np.ndarray:
        """Byte split of one transfer across the links, DWP-weighted;
        integer remainder lands on the highest-weight link."""
        w = self.weights()
        per = np.floor(w * int(nbytes)).astype(np.int64)
        per[int(np.argmax(w))] += int(nbytes) - int(per.sum())
        return per.astype(np.float64)

    # -- Eq.-1 pricing ---------------------------------------------------------

    def transfer_seconds(self, nbytes: int) -> float:
        """Eq.-1 price of one striped transfer: per-link rows (bandwidth +
        latency) appended to an empty domain vector — link transfers
        overlap, the stall is the slowest link's stripe."""
        if nbytes <= 0:
            return 0.0
        return bwmodel.stall_cost(
            np.zeros(0), np.zeros(0),
            link_bytes=self.stripe(nbytes),
            link_bw_gbps=self.bw_effective,
            link_latency_s=self.latency_s)

    # -- virtual clock ---------------------------------------------------------

    def queue_delay(self, now: float) -> float:
        """Seconds a transfer issued at ``now`` waits before starting."""
        return max(0.0, self.busy_until - float(now))

    def send(self, nbytes: int, now: float) -> tuple[float, float]:
        """Occupy the wire for one transfer: starts when the wire frees
        up, takes Eq.-1 time. Returns ``(start_s, seconds)``."""
        start = max(float(now), self.busy_until)
        seconds = self.transfer_seconds(nbytes)
        self.busy_until = start + seconds
        self.sends += 1
        self.sent_bytes += int(nbytes)
        self.busy_seconds += seconds
        return start, seconds

    def saturated(self, now: float, horizon_s: float) -> bool:
        """The router's fallback predicate: the wire is saturated when its
        backlog at ``now`` exceeds ``horizon_s`` — a handoff queued behind
        it would arrive later than serving the request locally."""
        return self.queue_delay(now) > float(horizon_s)

    # -- calibration (mirrors fabric.calibrate's EWMA) -------------------------

    def calibrate(self, nbytes: int, measured_s: float) -> None:
        """Fold one measured transfer into ``bw_effective``: every link's
        rate moves toward what the measurement implies, at the same EWMA
        step the fabric uses for its domain rows."""
        predicted = self.transfer_seconds(nbytes)
        if predicted <= 0 or measured_s <= 0:
            return
        ratio = predicted / float(measured_s)   # >1: wire faster than model
        a = self._alpha
        self.bw_effective = np.maximum(
            (1 - a) * self.bw_effective + a * self.bw_effective * ratio,
            1e-9)
        self.calibration_samples += 1

    def stats(self) -> dict:
        return {
            "links": [l.name for l in self.links],
            "bw_nominal_gbps": [float(b) for b in self.bw_nominal],
            "bw_effective_gbps": [float(b) for b in self.bw_effective],
            "weights": [float(w) for w in self.weights()],
            "sends": self.sends,
            "sent_bytes": self.sent_bytes,
            "busy_seconds": self.busy_seconds,
            "busy_until": self.busy_until,
            "calibration_samples": self.calibration_samples,
        }
