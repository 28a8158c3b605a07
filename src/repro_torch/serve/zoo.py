"""Zoo serving: per-group drivers over one byte arena (DESIGN.md §12).

The chat transformer runs the full
:class:`~repro_torch.serve.engine.ServeEngine` (continuous batching,
chunked prefill, the per-domain micro-batch decode launches of
DESIGN.md §11 all ride along unchanged — the engine only ever sees its own
group's FabricView).  The other residents of the machine are not
transformers and need no scheduler: an SSM tenant's "sequence" is one
constant-size state page mutated in place every step, an ASR tenant's
encoder K/V is written once per utterance and then only read.  Each gets
a small deterministic driver that exercises exactly the placement surface
its geometry defines — allocate, touch, fork-by-copy, attach-by-refcount,
release — and produces a content digest read back from the actual pool
arrays, so the zoo benchmark can assert data integrity ("token identity"
for groups that emit no tokens) across market-driven funding moves.

:class:`ZooServer` steps everything and runs the capacity market: after
each round it reports every engine group's unfunded demand
(``scheduler.demand_pages()`` in bytes) to the
:class:`~repro_torch.placement.zoo.PageFabricZoo` and ticks the market, so a
chat burst annexes idle ASR/SSM funding mid-run and repays it as it
drains — with ``market=False`` the same server is the static-partition
baseline.

Port of ``repro.serve.zoo``. The drivers write the pool tensors in place,
in the pool's dtype (``FabricView.k_pool`` is never rebound), and read
their digests back as the reference does: one host copy of the pool as
``float64`` numpy, summed by numpy in the reference's order, so they equal
the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.placement.zoo import PageFabricZoo


def _host64(pool: torch.Tensor) -> np.ndarray:
    """The whole pool tensor on the host as float64 (exact from bf16 and
    fp32)."""
    return pool.detach().float().cpu().numpy().astype(np.float64)


class SSMStateDriver:
    """Constant-state tenant: ``sessions`` live recurrences, one state
    page each (the geometry pins ``fixed_pages=1``).  Every step folds a
    deterministic per-session injection into the state *in place* —
    never appending — so the page list never changes while the bytes do.
    The update depends only on (session index, step count), never on
    page ids or domains: digests are invariant under placement and
    funding changes, which is exactly what the zoo benchmark asserts."""

    def __init__(self, view, sessions: int):
        self.view = view
        self.sessions: list[list[int]] = []
        self.steps = 0
        for _ in range(sessions):
            pages: list[int] = []
            for _ in range(view.geometry.fixed_pages):
                view.append_page(pages)
            self.sessions.append(pages)

    def step(self) -> None:
        """One recurrence step over every session's state page."""
        self.steps += 1
        pids = np.asarray([p[0] for p in self.sessions], dtype=np.int32)
        inject = np.asarray(
            [((i + 1) * self.steps) % 7 * 0.125
             for i in range(len(self.sessions))], dtype=np.float32)
        k = self.view.k_pool
        bshape = (1, len(pids)) + (1,) * (k.ndim - 2)
        idx = torch.from_numpy(pids).to(k.device, torch.long)
        k[:, idx] = k[:, idx] * 0.5 + torch.from_numpy(inject).reshape(
            bshape).to(k.device, k.dtype)

    def fork(self, idx: int) -> list[int]:
        """Clone one session (state copy, not CoW — geometry is
        non-shareable) and track it as a new live session."""
        clone = self.view.fork_sequence(self.sessions[idx])
        self.sessions.append(clone)
        return clone

    def digests(self) -> list[float]:
        """Per-session state checksums read back from the pool arrays."""
        k = _host64(self.view.k_pool)
        return [round(float(k[:, p[0]].sum()), 6) for p in self.sessions]

    def close(self) -> None:
        for pages in self.sessions:
            self.view.release(pages)
        self.sessions.clear()


class EncoderKVDriver:
    """Read-only encoder cross-attention K/V tier: each utterance is a
    fixed ``geometry.fixed_pages`` block written once (deterministic
    content from the utterance index), after which decode sessions
    attach by refcount (``fork_sequence`` on a shareable geometry) and
    detach by release — the shareable-tier analog of the prefix trie."""

    def __init__(self, view, utterances: int):
        self.view = view
        self.utterances: list[list[int]] = []
        self.readers: list[list[int]] = []
        for u in range(utterances):
            pages: list[int] = []
            for _ in range(view.geometry.fixed_pages):
                view.append_page(pages)
            k = self.view.k_pool
            k[:, torch.tensor(pages, dtype=torch.long, device=k.device)] = \
                (u + 1) * 0.0625
            self.utterances.append(pages)

    def attach(self, u: int) -> list[int]:
        """A decode session starts reading utterance ``u``: refcount
        attach, no copy, no new pages."""
        reader = self.view.fork_sequence(self.utterances[u])
        self.readers.append(reader)
        return reader

    def digests(self) -> list[float]:
        k = _host64(self.view.k_pool)
        return [round(float(sum(k[:, p].sum() for p in pages)), 6)
                for pages in self.utterances]

    def close(self) -> None:
        for reader in self.readers:
            self.view.release(reader)
        for pages in self.utterances:
            self.view.release(pages)
        self.readers.clear()
        self.utterances.clear()


class ZooServer:
    """Steps every group and runs the capacity market between them."""

    def __init__(self, zoo: PageFabricZoo, *, market: bool = True,
                 invariants_every: int = 8):
        self.zoo = zoo
        self.market = market
        self.engines: dict[str, object] = {}
        self.drivers: dict[str, object] = {}
        self.steps = 0
        self.invariants_every = invariants_every

    def add_engine(self, name: str, engine) -> None:
        assert name in self.zoo.groups, f"unknown zoo group {name!r}"
        self.engines[name] = engine

    def add_driver(self, name: str, driver) -> None:
        assert name in self.zoo.groups, f"unknown zoo group {name!r}"
        self.drivers[name] = driver

    def busy(self) -> bool:
        return any(eng.active or eng.waiting
                   for eng in self.engines.values())

    def demand_bytes(self, name: str) -> int:
        """An engine group's unfunded demand; driver groups (constant
        footprint, already resident) are always satisfied."""
        eng = self.engines.get(name)
        if eng is None:
            return 0
        return eng.scheduler.demand_pages() \
            * int(self.zoo.groups[name].page_bytes)

    def step(self) -> dict:
        """One zoo round: drivers tick, engines step, the market clears."""
        self.steps += 1
        for driver in self.drivers.values():
            if hasattr(driver, "step"):
                driver.step()
        for eng in self.engines.values():
            if eng.active or eng.waiting:
                eng.step()
        flows = {"granted_bytes": 0, "repaid_bytes": 0}
        if self.market:
            for name in self.zoo.groups:
                self.zoo.observe_demand(name, self.demand_bytes(name))
            flows = self.zoo.market_tick()
        if self.invariants_every \
                and self.steps % self.invariants_every == 0:
            self.zoo.check_invariants()
        return flows

    def drain(self, max_steps: int = 3000) -> int:
        """Step until every engine is idle (drivers are perpetual — they
        tick alongside but never gate completion)."""
        steps = 0
        while self.busy() and steps < max_steps:
            self.step()
            steps += 1
        if self.market:
            # burst over: let the market settle repayments
            for name in self.zoo.groups:
                self.zoo.observe_demand(name, self.demand_bytes(name))
            self.zoo.market_tick()
        self.zoo.check_invariants()
        return steps
