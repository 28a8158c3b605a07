"""Data pipeline: deterministic sharded token streams with BWAP-weighted
shard assignment and straggler mitigation (port of
``repro.data.pipeline``; numpy, as the reference's, so its batches,
assignments and migration counts are the reference's exactly).

The paper's placement idea applied to input data: shard files are assigned
to hosts proportionally to each host's *measured ingest bandwidth* (Alg. 1
weighted interleaving over hosts instead of uniform round-robin). At run
time, per-host fetch latencies feed an EWMA; hosts that degrade (stragglers)
get their weight reduced and shards re-interleaved — the DWP-tuner pattern
(measure -> adjust placement -> migrate) on the data plane.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterator, Sequence

import numpy as np

from repro_torch.core import interleave


@dataclasses.dataclass
class HostState:
    bw_weight: float            # current assignment weight
    ewma_latency: float = 0.0   # seconds per batch fetch
    fetches: int = 0


class ShardedTokenDataset:
    """Deterministic synthetic token stream (seeded per shard) or
    memory-mapped tokenized files. Shard i yields batch b of [B_shard, S]."""

    def __init__(self, vocab_size: int, seq_len: int, num_shards: int,
                 seed: int = 0, files: Sequence[str] | None = None):
        self.vocab = vocab_size
        self.seq = seq_len
        self.num_shards = num_shards
        self.seed = seed
        self.files = list(files) if files else None
        self._mmaps = {}

    def batch(self, shard: int, step: int, batch_size: int) -> np.ndarray:
        if self.files:
            mm = self._mmaps.get(shard)
            if mm is None:
                mm = np.memmap(self.files[shard % len(self.files)],
                               dtype=np.int32, mode="r")
                self._mmaps[shard] = mm
            need = batch_size * self.seq
            off = (step * need) % max(len(mm) - need, 1)
            return np.asarray(mm[off:off + need]).reshape(batch_size,
                                                          self.seq)
        rng = np.random.default_rng(
            (self.seed, shard, step))  # deterministic & resumable
        return rng.integers(0, self.vocab, (batch_size, self.seq),
                            dtype=np.int32)


class BwapDataRouter:
    """Assigns dataset shards to hosts with weighted interleaving and
    re-balances when stragglers appear."""

    def __init__(self, num_shards: int, host_bws: Sequence[float],
                 straggler_factor: float = 2.0, ewma: float = 0.3):
        self.num_shards = num_shards
        self.hosts = [HostState(bw_weight=float(b)) for b in host_bws]
        self.straggler_factor = straggler_factor
        self.ewma = ewma
        self.assignment = interleave.weighted_interleave(
            num_shards, np.asarray([h.bw_weight for h in self.hosts]))
        self.migrations = 0

    def shards_of(self, host: int) -> np.ndarray:
        return np.nonzero(self.assignment == host)[0]

    def record_fetch(self, host: int, latency_s: float) -> bool:
        """Update EWMA; returns True if a rebalance was triggered."""
        h = self.hosts[host]
        h.fetches += 1
        h.ewma_latency = (latency_s if h.fetches == 1 else
                          (1 - self.ewma) * h.ewma_latency
                          + self.ewma * latency_s)
        return self._maybe_rebalance()

    def _maybe_rebalance(self) -> bool:
        lats = np.asarray([h.ewma_latency for h in self.hosts])
        if (lats <= 0).any() or min(h.fetches for h in self.hosts) < 2:
            return False
        median = float(np.median(lats))
        new_w = np.asarray([
            h.bw_weight * (median / h.ewma_latency
                           if h.ewma_latency > self.straggler_factor * median
                           else 1.0)
            for h in self.hosts])
        if np.allclose(new_w, [h.bw_weight for h in self.hosts]):
            return False
        for h, w in zip(self.hosts, new_w):
            h.bw_weight = float(w)
        plan = interleave.plan_migration(self.assignment, new_w)
        self.assignment = plan.new_assignment
        self.migrations += plan.num_moves
        return True


class PrefetchLoader:
    """Background-thread prefetcher over (dataset, router)."""

    def __init__(self, dataset: ShardedTokenDataset, router: BwapDataRouter,
                 host: int, batch_size: int, depth: int = 2,
                 fetch_delay: Callable[[int], float] | None = None):
        self.dataset = dataset
        self.router = router
        self.host = host
        self.batch_size = batch_size
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._fetch_delay = fetch_delay
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._step = 0
        self._thread.start()

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            t0 = time.monotonic()
            shards = self.router.shards_of(self.host)
            shard = int(shards[step % max(len(shards), 1)]) if len(shards) \
                else 0
            batch = self.dataset.batch(shard, step, self.batch_size)
            if self._fetch_delay:          # test hook: simulated slowness
                time.sleep(self._fetch_delay(step))
            self.router.record_fetch(self.host, time.monotonic() - t0)
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
