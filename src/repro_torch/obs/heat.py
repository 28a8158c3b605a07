"""Per-page heat counters with per-step decay (DESIGN.md §10).

Input signal for future migration policy (ROADMAP compute-follows-data):
every decode step *touches* the pages the batch read; heat decays
geometrically per step so stale pages cool off. Decay is lazy — each page
stores ``(value, last_step)`` and resolves ``value * decay**(step -
last_step)`` on access — so a step is O(pages touched), not O(live pages).

Freed pages drop out via the fabric's ``free`` event (the Observatory
subscribes :meth:`on_free`).

Port of ``repro.obs.heat``: pure Python, the same code.
"""

from __future__ import annotations

import numpy as np


class PageHeat:
    def __init__(self, pool, *, decay: float = 0.9):
        assert 0.0 < decay <= 1.0
        self.pool = pool
        self.decay = float(decay)
        self._heat: dict[int, float] = {}
        self._stamp: dict[int, int] = {}
        self.step_count = 0
        self.touches = 0

    # -- hot path -------------------------------------------------------------

    def touch(self, pages, weight: float = 1.0, *, weights=None) -> None:
        """Record one read of ``pages``.

        ``weights`` (parallel to ``pages``) scales each page's increment by
        the fraction of the page actually read — a sequence's partial last
        page streams fewer bytes than an interior page and must not look
        equally hot to the re-homing policy. Omitted, every page counts
        ``weight`` (a full-page read).
        """
        ws = weights if weights is not None else (weight for _ in pages)
        for p, w in zip(pages, ws):
            p = int(p)
            if p < 0:                # persisted handle: not a live page
                continue
            self._heat[p] = self._resolve(p) + float(w)
            self._stamp[p] = self.step_count
            self.touches += 1

    def step(self) -> None:
        self.step_count += 1

    def _resolve(self, p: int) -> float:
        h = self._heat.get(p)
        if h is None:
            return 0.0
        age = self.step_count - self._stamp[p]
        return h * self.decay ** age if age else h

    def on_free(self, page: int = -1, **_) -> None:
        self._heat.pop(int(page), None)
        self._stamp.pop(int(page), None)

    # -- reporting ------------------------------------------------------------

    def value(self, page: int) -> float:
        return self._resolve(int(page))

    def live_pages(self) -> int:
        return len(self._heat)

    def hottest(self, n: int = 10) -> list[tuple[int, float]]:
        items = [(p, self._resolve(p)) for p in self._heat]
        items.sort(key=lambda pv: (-pv[1], pv[0]))
        return items[:n]

    def per_domain(self) -> dict[str, dict]:
        """Per-domain heat histograms: count / mean / p50 / p95 / max of
        the resolved heat of live pages resident in each domain."""
        by_dom: dict[int, list[float]] = {}
        for p in self._heat:
            by_dom.setdefault(self.pool.domain_of(p), []).append(
                self._resolve(p))
        out = {}
        for i, d in enumerate(self.pool.domains):
            vals = np.asarray(by_dom.get(i, []), dtype=np.float64)
            out[d.name] = {
                "pages": int(vals.size),
                "mean": float(vals.mean()) if vals.size else 0.0,
                "p50": float(np.quantile(vals, 0.5)) if vals.size else 0.0,
                "p95": float(np.quantile(vals, 0.95)) if vals.size else 0.0,
                "max": float(vals.max()) if vals.size else 0.0,
            }
        return out

    def snapshot(self) -> dict:
        return {"step": self.step_count, "live_pages": self.live_pages(),
                "touches": self.touches, "per_domain": self.per_domain()}
