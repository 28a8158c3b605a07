"""Canonical tuner (paper §III-A): offline, application-agnostic weights.

For each plausible worker set of a topology, profile the canonical
BW-intensive application and derive the canonical weight distribution via
Eq. 5. Results are cached ("at installation time on a given machine", §III-A3)
and symmetry-deduplicated.

Port of ``repro.core.canonical``: a numpy copy; ``install`` writes the
reference's JSON bytes.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import pathlib
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import bwmodel
from repro_torch.core.topology import Topology


@dataclasses.dataclass(frozen=True)
class CanonicalEntry:
    workers: tuple[int, ...]
    weights: np.ndarray            # (N,) sums to 1
    bw_profiled: np.ndarray        # (N, W) profiled bandwidth matrix
    minbw: np.ndarray              # (N,)

    @property
    def worker_mass(self) -> float:
        return float(self.weights[list(self.workers)].sum())


class CanonicalTuner:
    """Computes and caches canonical weight distributions per worker set."""

    def __init__(self, topo: Topology):
        self.topo = topo
        self._cache: dict[tuple[int, ...], CanonicalEntry] = {}

    def weights_for(self, workers: Sequence[int]) -> CanonicalEntry:
        key = tuple(sorted(workers))
        if key not in self._cache:
            prof = bwmodel.profile_bw(self.topo, key)
            w = bwmodel.optimal_weights(prof)
            self._cache[key] = CanonicalEntry(
                workers=key, weights=w, bw_profiled=prof,
                minbw=bwmodel.minbw(prof))
        return self._cache[key]

    # -- installation-time sweep ------------------------------------------

    def plausible_worker_sets(self, max_size: int | None = None) -> list[tuple[int, ...]]:
        """Enumerate worker sets a rational user would pick (§III-A3):
        contiguous-bandwidth clusters, deduplicated by bandwidth symmetry.

        A set is *plausible* if no excluded node has strictly higher aggregate
        bandwidth to the set than some member (i.e. the set is a top-k
        bandwidth cluster around its members).
        """
        n = self.topo.num_nodes
        max_size = max_size or n
        seen_signatures: set[tuple] = set()
        out: list[tuple[int, ...]] = []
        for size in range(1, max_size + 1):
            for combo in itertools.combinations(range(n), size):
                if not self._is_cluster(combo):
                    continue
                sig = self._signature(combo)
                if sig in seen_signatures:
                    continue
                seen_signatures.add(sig)
                out.append(combo)
        return out

    def _is_cluster(self, combo: tuple[int, ...]) -> bool:
        if len(combo) == 1:
            return True
        inside = min(self._agg_bw(a, combo) for a in combo)
        outside = [self._agg_bw(b, combo) for b in range(self.topo.num_nodes)
                   if b not in combo]
        return not outside or inside >= max(outside) - 1e-9

    def _agg_bw(self, node: int, combo: Iterable[int]) -> float:
        pairs = [c for c in combo if c != node]
        if not pairs:
            return float("inf")
        return sum(float(self.topo.bw[node, c]) + float(self.topo.bw[c, node])
                   for c in pairs) / len(pairs)

    def _signature(self, combo: tuple[int, ...]) -> tuple:
        """Bandwidth-spectrum signature; symmetric worker sets collide."""
        rows = sorted(
            tuple(sorted(np.round(self.topo.bw[:, c], 3))) for c in combo)
        cols = sorted(
            tuple(sorted(np.round(self.topo.bw[c, :], 3))) for c in combo)
        return (tuple(rows), tuple(cols))

    def install(self, path: str | pathlib.Path, max_size: int | None = None) -> int:
        """Run the installation-time sweep and persist the weight cache."""
        sets = self.plausible_worker_sets(max_size)
        blob = {}
        for ws in sets:
            e = self.weights_for(ws)
            blob[",".join(map(str, ws))] = {
                "weights": e.weights.tolist(),
                "minbw": e.minbw.tolist(),
            }
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"topology": self.topo.name, "entries": blob},
                                indent=1))
        return len(sets)

    @staticmethod
    def load(path: str | pathlib.Path) -> dict[tuple[int, ...], np.ndarray]:
        raw = json.loads(pathlib.Path(path).read_text())
        return {tuple(int(x) for x in k.split(",")): np.asarray(v["weights"])
                for k, v in raw["entries"].items()}
