"""Eq.-1 drift ledger: predictions vs measurements, feeding calibration
(DESIGN.md §10).

Every Eq.-1 prediction the stack makes — batch KV read time, swap
transfer time, persistent-tier copy — can be paired with a measured time
(wall clock on real hardware, or a ground-truth probe in benchmarks).
The ledger:

- keeps per-kind measured/predicted *ratio* rings with p50/p95 (via
  ``Ring.quantile``) — the drift histograms;
- keeps a per-domain EWMA drift factor (ratio of measured to predicted
  per-domain transfer rate);
- stages per-domain seconds-per-page samples and periodically calls
  ``fabric.calibrate()`` with their means — closing the loop that ROADMAP
  flagged ("calibrate exists but nothing feeds it").

Measurement attribution: Eq. 1 is a max-parallel-transfer model, so a
*scalar* measurement only constrains the bottleneck domain (the argmax of
predicted per-domain time); a per-domain *vector* measurement (e.g. a
hardware counter per NUMA node, or a benchmark probe) constrains every
domain it covers.

Port of ``repro.obs.drift``, on the port's ``placement/telemetry.Ring``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.placement.telemetry import Ring

KINDS = ("batch_read", "swap_transfer", "tier_copy", "link_transfer")


class DriftLedger:
    def __init__(self, fabric, *, calibrate_every: int = 4,
                 drift_alpha: float = 0.25, ring_capacity: int = 256):
        self.fabric = fabric
        self.calibrate_every = int(calibrate_every)
        self.drift_alpha = float(drift_alpha)
        nd = len(fabric.pool.domains)
        # measured/predicted per-domain rate ratio, EWMA (1.0 = no drift)
        self.domain_drift = np.ones(nd, dtype=np.float64)
        self.domain_samples = np.zeros(nd, dtype=np.int64)
        self.ratio: dict[str, Ring] = {k: Ring(ring_capacity) for k in KINDS}
        self._staged: list[list[float]] = [[] for _ in range(nd)]
        self.observations = 0
        self.calibrations = 0

    # -- observation ----------------------------------------------------------

    def observe(self, kind: str, bytes_per_domain, predicted_s: float,
                measured) -> None:
        """Pair one Eq.-1 prediction with its measurement.

        ``measured`` is either a scalar (total seconds; attributed to the
        bottleneck domain) or a per-domain vector of seconds (every
        trafficked domain gets a calibration sample)."""
        assert kind in KINDS, kind
        bpd = np.asarray(bytes_per_domain, dtype=np.float64)
        pb = float(self.fabric.pool.page_bytes)
        m = np.asarray(measured, dtype=np.float64)
        if m.ndim == 0:                       # scalar: bottleneck domain
            per_dom_pred = bpd / (self.fabric.bw_effective * 1e9)
            d = int(np.argmax(per_dom_pred))
            doms = [d] if bpd[d] > 0 and float(m) > 0 else []
            per_dom_meas = {d: float(m)}
            measured_total = float(m)
        else:                                 # vector: all trafficked
            assert m.shape == bpd.shape, (m.shape, bpd.shape)
            doms = [d for d in range(len(bpd))
                    if bpd[d] > 0 and m[d] > 0]
            per_dom_meas = {d: float(m[d]) for d in doms}
            measured_total = float(m.max()) if len(m) else 0.0
        if predicted_s > 0 and measured_total > 0:
            self.ratio[kind].push(measured_total / predicted_s)
        for d in doms:
            # seconds per page in domain d under this measurement
            s_page = per_dom_meas[d] * pb / bpd[d]
            self._staged[d].append(s_page)
            self.domain_samples[d] += 1
            pred_d = bpd[d] / (self.fabric.bw_effective[d] * 1e9)
            if pred_d > 0:
                r = per_dom_meas[d] / pred_d
                a = self.drift_alpha
                self.domain_drift[d] = ((1 - a) * self.domain_drift[d]
                                        + a * r)
        self.observations += 1
        if self.observations % self.calibrate_every == 0:
            self.flush()

    def observe_launches(self, kind: str, launches, probe) -> int:
        """Bill a multi-launch (micro-batched) step one launch at a time.

        A compute-follows-data step issues several launches, each reading
        only its own domain-partitioned page set; attributing the *step's*
        measurement to the *global* byte vector would credit every launch's
        bottleneck time to domains it never touched, and calibration would
        drag their ``bw_effective`` toward fiction. Instead each launch is
        its own observation: ``launches`` is an iterable of
        ``(bytes_per_domain, predicted_s)`` and ``probe(kind, bpd)``
        measures that launch alone (scalar or per-domain vector; ``None``
        skips). Returns the number of observations recorded — a launch
        reading zero bytes bills nobody."""
        n = 0
        for bpd, predicted_s in launches:
            bpd = np.asarray(bpd, dtype=np.float64)
            if bpd.sum() <= 0:
                continue
            measured = probe(kind, bpd)
            if measured is None:
                continue
            self.observe(kind, bpd, predicted_s, measured)
            n += 1
        return n

    def observe_scalar(self, kind: str, predicted_s: float,
                       measured_s: float) -> None:
        """Ratio-only observation for costs outside the per-domain model
        (e.g. the persistent tier's single bandwidth row)."""
        assert kind in KINDS, kind
        if predicted_s > 0 and measured_s > 0:
            self.ratio[kind].push(measured_s / predicted_s)
        self.observations += 1

    # -- calibration ----------------------------------------------------------

    def flush(self) -> bool:
        """Fold staged per-domain samples into ``fabric.calibrate``;
        domains with no samples stay untouched. Returns True if a
        calibration happened."""
        samples = [float(np.mean(s)) if s else None for s in self._staged]
        if all(s is None for s in samples):
            return False
        self.fabric.calibrate(samples)
        self.calibrations += 1
        self._staged = [[] for _ in self._staged]
        return True

    # -- reporting ------------------------------------------------------------

    def summary(self) -> dict:
        return {
            "observations": self.observations,
            "calibrations": self.calibrations,
            "bw_effective_gbps": [float(b)
                                  for b in self.fabric.bw_effective],
            "domain_drift": [float(d) for d in self.domain_drift],
            "domain_samples": [int(n) for n in self.domain_samples],
            "kinds": {
                k: {"count": len(r), "ratio_p50": r.quantile(0.5),
                    "ratio_p95": r.quantile(0.95)}
                for k, r in self.ratio.items()
            },
        }
