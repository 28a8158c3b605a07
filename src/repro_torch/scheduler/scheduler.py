"""Request scheduler: priority continuous batching with KV swap preemption.

The scheduler owns the request lifecycle the serving engine used to hand-roll:

- **Admission** — a priority-class queue (higher ``level`` preempts lower;
  FIFO within a class) with a *chunked-prefill token budget*: at most
  ``prefill_token_budget`` new prompt tokens materialize K/V per step, so a
  long prompt prefills across steps instead of stalling the decode batch.
- **Continuous batching** — finished sequences leave the batch immediately;
  waiting/swapped requests fill the slot the same step.
- **Preemption** — when fast capacity runs short or a higher class arrives,
  a victim's KV pages swap out to BWAP-weighted slow domains through the
  placement executor (``swap.KVSwapManager``) and back on resume. Victims
  maximize ``priority-factor x page-footprint x Eq.-1 stall cost``
  (DESIGN.md §5): prefer low classes, large footprints, and sequences whose
  pages already stall the batch.

State machine (per request)::

    QUEUED -> PREFILL -> RUNNING -> FINISHED
                 ^          |
                 |          v
                 +------ SWAPPED       (swap-out <-> swap-in)

Time is a virtual clock: the engine advances it by measured wall time plus
the Eq.-1 analytic components (KV read stall, swap transfers), which is what
SLO accounting (slo.py) and trace replay (workload.py) run on.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Sequence

import numpy as np

from repro_torch.placement.fabric import as_view
from repro_torch.scheduler.slo import SloSpec, SloTracker
from repro_torch.scheduler.swap import KVSwapManager


@dataclasses.dataclass(frozen=True)
class PriorityClass:
    """An admission class: scheduling level + SLO deadlines."""

    name: str
    level: int = 0                       # higher preempts lower
    slo: SloSpec = dataclasses.field(default_factory=SloSpec)


class State(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    RUNNING = "running"
    SWAPPED = "swapped"
    FINISHED = "finished"


@dataclasses.dataclass(eq=False)
class Request:
    """One sequence; the engine's ``Sequence_`` fields are preserved
    (``sid``/``tokens``/``pages``/``prompt_len``/``length``/``done``).

    ``eq=False``: requests are identities, not values. The generated
    field-wise ``__eq__`` made every ``in`` / ``list.remove`` on the hot
    decode path an O(B·tokens) deep compare of token lists (and two
    distinct requests with equal prompts compared equal); identity
    semantics make those O(B) pointer checks and restore hashability."""

    sid: int
    tokens: list
    pages: list
    prompt_len: int = 0
    length: int = 0                      # tokens with K/V in the pool
    done: bool = False
    cls: str = "default"
    max_new: int = 32
    arrival_s: float = 0.0
    state: State = State.QUEUED
    resume_after: float = 0.0            # stall-preemption cooldown gate
    probed: bool = False                 # first trie probe already counted

    @property
    def produced(self) -> int:
        return len(self.tokens) - self.prompt_len

    @property
    def prefill_target(self) -> int:
        """Prompt tokens that prefill materializes: all but the last (the
        first decode step writes that one at its true position)."""
        return self.prompt_len - 1


@dataclasses.dataclass
class StepPlan:
    """What one engine step executes, in order: prefill chunks, then decode
    over ``batch``. Swaps already happened inside ``schedule()``.

    ``launch_groups`` is the compute-follows-data assignment (DESIGN.md
    §11): when the view's policy enables micro-batching, ``batch`` is
    partitioned into ``(domain, requests)`` per-domain micro-batches —
    each decodes in its own launch, so the step's Eq.-1 stall is the max
    over per-launch bottlenecks instead of one global max. ``None`` means
    one global launch (the classic path)."""

    prefill_chunks: list                 # (Request, lo, hi) token ranges
    batch: list                          # Requests to decode this step
    swapped_in: list
    swapped_out: list
    swap_seconds: float = 0.0
    launch_groups: list | None = None    # [(domain, [Request, ...]), ...]


class RequestScheduler:
    """Priority continuous batching over one fabric view (a bare
    ``BwapPagePool`` is adopted into a single-view fabric; placement and
    page lifetime go exclusively through :class:`FabricView`).

    On a named (multi-tenant) view the scheduler registers the tenant as a
    priority class at the view's level and makes it the default class — the
    wiring ``arbiter.attach_engine`` used to reach in and do.

    ``swap=None`` disables preemption (the pre-scheduler engine behavior):
    capacity shortfalls make requests wait, and a batch that can no longer
    grow raises ``RuntimeError`` exactly like the bare allocator did.
    """

    def __init__(self, pool, *, max_batch: int = 8,
                 prefill_token_budget: int = 256,
                 classes: Sequence[PriorityClass] | None = None,
                 default_class: str = "default",
                 default_max_new: int = 32,
                 swap: KVSwapManager | None = None,
                 stall_preempt_fraction: float | None = None,
                 stall_preempt_cooldown_s: float = 0.0,
                 spec_tokens: int = 0,
                 conservative_admission: bool = False,
                 micro_batch: bool | None = None):
        assert prefill_token_budget >= 1
        self.view = as_view(pool)        # the only placement surface
        # compute-follows-data (DESIGN.md §11): partition each decode batch
        # into per-domain micro-batches. Default follows the view's
        # placement policy (the `coda` policy turns it on); an explicit
        # bool overrides.
        self.micro_batch = (bool(micro_batch) if micro_batch is not None
                            else bool(getattr(self.view.placement_policy,
                                              "micro_batch", False)))
        self.max_batch = max_batch
        self.prefill_token_budget = prefill_token_budget
        self.swap = swap
        # speculative-decode lookahead (DESIGN.md §7): every decode step
        # may write positions [length, length + spec_tokens], so growth
        # accounting reserves pages for the whole span, admission sizes
        # footprints with the margin, and the per-step token budget charges
        # each running sequence's draft+verify tokens (1 + spec_tokens)
        # before prefill chunks may claim the rest. 0 = plain decode.
        assert spec_tokens >= 0
        self.spec_tokens = spec_tokens
        # conservative (trie-aware) admission: a request joins the batch
        # only when its whole remaining *physical* footprint — worst case
        # minus pages it already shares through the prefix trie — fits
        # alongside every admitted request's remaining footprint. The
        # admitted set can then always grow to completion without swap
        # capacity, at the cost of lower oversubscription; the default
        # keeps the greedy admission that leans on preemption.
        self.conservative_admission = conservative_admission
        # stall-triggered preemption (Eq. 1): evict a sequence whose own
        # KV read time exceeds this fraction of the batch read time.
        # None disables; the cooldown stops an out/in thrash loop.
        assert stall_preempt_fraction is None \
            or 0.0 < stall_preempt_fraction < 1.0
        self.stall_preempt_fraction = stall_preempt_fraction
        self.stall_preempt_cooldown_s = stall_preempt_cooldown_s
        self.classes: dict[str, PriorityClass] = {}
        for pc in (classes or []):
            self.classes[pc.name] = pc
        if default_class not in self.classes:
            self.classes[default_class] = PriorityClass(default_class)
        self.default_class = default_class
        self.default_max_new = default_max_new
        self.slo = SloTracker(
            {n: pc.slo for n, pc in self.classes.items()},
            counters=self.view.attach_slo())
        if not self.view._adopted:
            # multi-tenant fabric: the tenant is a priority class at its
            # view's level and the default class; operator-configured SLO
            # deadlines (a pre-declared class of the same name) survive
            existing = self.classes.get(self.view.name)
            self.ensure_class(PriorityClass(
                name=self.view.name, level=self.view.level,
                slo=existing.slo if existing is not None else SloSpec()))
            self.default_class = self.view.name
        # arbiter-driven allocation-cycle moves (co-scheduled DWP): re-home
        # live sequences when the view's assignment changes under us
        self.view.on_assignment_change(self._rehome_live)
        # all-holders re-homing (DESIGN.md §11) changes physical ids under
        # live sequences; patch every request's page list with the map
        self.view.on_page_remap(self._apply_page_remap)
        self._ids = itertools.count()
        self.queued: list[Request] = []
        self.prefilling: list[Request] = []
        self.running: list[Request] = []
        self.swapped: list[Request] = []
        self.finished: list[Request] = []
        self.now = 0.0
        self._plan: StepPlan | None = None

    # -- class registry ------------------------------------------------------

    def ensure_class(self, pc: PriorityClass) -> None:
        """Register (or update) a priority class — the arbiter routes each
        tenant through this so tenant priority == scheduling priority."""
        self.classes[pc.name] = pc
        self.slo.specs[pc.name] = pc.slo

    def level(self, r: Request) -> int:
        return self.classes[r.cls].level

    # -- admission -----------------------------------------------------------

    def allocatable_pages(self) -> int:
        """Pages a single sequence could ever hold at once: the view's
        capacity minus the swap reservation (reserved slots are for
        *parked* copies)."""
        reserved = self.swap.reserved_total if self.swap is not None else 0
        return self.view.capacity() - reserved

    def submit(self, prompt: Sequence[int], *, cls: str | None = None,
               max_new: int | None = None,
               arrival_s: float | None = None) -> int:
        cls = cls if cls is not None else self.default_class
        assert cls in self.classes, f"unknown priority class {cls!r}"
        r = Request(sid=next(self._ids), tokens=list(prompt), pages=[],
                    prompt_len=len(prompt), cls=cls,
                    max_new=(max_new if max_new is not None
                             else self.default_max_new),
                    arrival_s=arrival_s if arrival_s is not None
                    else self.now)
        # reject infeasible requests here — admitting one would let it
        # accumulate pages chunk by chunk until it wedges the whole engine
        # (speculative lookahead pages count: a verify step may transiently
        # hold spec_tokens positions past the final committed one)
        ps = self.view.page_size
        footprint = self.view.geometry.pages_for_tokens(
            r.prefill_target + r.max_new + self.spec_tokens)
        if footprint > self.allocatable_pages():
            # shared trie pages cannot rescue a single request's residency
            # bound — they still occupy pages it must hold — but the
            # submit-time probe names them so the error is diagnosable
            sharable = self.view.peek_prefix(r.tokens[:r.prompt_len]) // ps
            raise ValueError(
                f"request needs {footprint} KV pages ({sharable} currently "
                f"sharable via the prefix trie) but at most "
                f"{self.allocatable_pages()} are ever allocatable "
                "(view capacity minus swap reservation)")
        self.queued.append(r)
        self.slo.on_submit(r.sid, r.cls, r.arrival_s)
        obs = self.view.fabric.obs
        if obs is not None:
            obs.on_admit(self.view, r, self.now)
        return r.sid

    @property
    def pending(self) -> list[Request]:
        """Everything submitted but not finished and not in the batch."""
        return self.queued + self.prefilling + self.swapped

    # -- the per-step decision ------------------------------------------------

    def schedule(self) -> StepPlan:
        plan = StepPlan([], [], [], [], 0.0)
        self._plan = plan
        if not (self.running or self.prefilling or self.swapped
                or self._arrived()):
            nxt = min((r.arrival_s for r in self.queued), default=None)
            if nxt is not None and nxt > self.now:
                self.now = nxt           # idle: jump to the next arrival
        self._priority_preempt()
        self._stall_preempt()
        self._swap_ins(plan)
        self._plan_prefills(plan)
        self._ensure_growth()
        plan.batch = list(self.running)
        if self.micro_batch and len(plan.batch) > 1:
            plan.launch_groups = self._launch_groups(plan.batch)
        self._plan = None
        if (not plan.batch and not plan.prefill_chunks
                and not plan.swapped_in and not plan.swapped_out
                and self.pending):
            future = [r.arrival_s for r in self.queued
                      if r.arrival_s > self.now]
            if future:
                # blocked but more requests are due: jump to them (they can
                # only be scheduled, never free capacity, so if nothing is
                # admissible once all have arrived we raise below)
                self.now = min(future)
            else:
                # no step will ever change this state — fail like the bare
                # allocator did instead of spinning
                raise RuntimeError(
                    "KV pool exhausted: pending requests but no admissible "
                    "work (pool too small or swap slots depleted)")
        return plan

    def _arrived(self) -> list[Request]:
        out = [r for r in self.queued if r.arrival_s <= self.now]
        out.sort(key=self._order)
        return out

    def _order(self, r: Request):
        return (-self.level(r), r.arrival_s, r.sid)

    def _slots_used(self) -> int:
        return len(self.running) + len(self.prefilling)

    def _growth_need(self, seqs) -> int:
        """Decode pages the next step will allocate for ``seqs``."""
        return sum(self._seq_growth(r.length, r.pages) for r in seqs)

    def _future_pages(self, r: Request) -> int:
        """Pages ``r`` will still allocate over its whole lifetime: the
        logical worst case (prompt + max_new + speculative lookahead) minus
        pages already held — shared trie pages included, which is what
        makes the bound *physical* — plus a CoW clone when the first
        decode write lands in a currently-shared page."""
        ps = self.view.page_size
        total = self.view.geometry.pages_for_tokens(
            r.prefill_target + r.max_new + self.spec_tokens)
        cow = 1 if (r.pages and r.prefill_target // ps < len(r.pages)
                    and self.view.shared(r.pages[r.prefill_target // ps])) \
            else 0
        return max(0, total + cow - len(r.pages))

    def _admitted_future(self) -> int:
        """Remaining lifetime pages of everything already in the batch."""
        return sum(self._future_pages(r)
                   for r in self.running + self.prefilling)

    def demand_pages(self) -> int:
        """Pages the current workload still wants beyond what the view
        can allocate right now — the capacity market's demand signal
        (``placement.zoo``): pending requests' lifetime footprints plus
        the running batch's next-step growth, minus free capacity.
        0 means satisfied; positive means this tenant is starved and
        values annexed funding at its Eq.-1 stall exposure."""
        need = sum(self._future_pages(r) for r in self.pending) \
            + self._growth_need(self.running)
        return max(0, need - self.view.free_count())

    def _seq_growth(self, length: int, pages) -> int:
        """Pages one sequence's next decode step may allocate: enough fresh
        pages to cover the write span ``[length, length + spec_tokens]``
        (one page per step when speculation is off), plus a CoW clone when
        the first write position falls inside a *shared* page (the
        full-prompt-match fork)."""
        ps = self.view.page_size
        need = max(0, self.view.geometry.pages_for_tokens(
            length + self.spec_tokens + 1) - len(pages))
        if length % ps and pages \
                and self.view.shared(pages[length // ps]):
            need += 1
        return need

    # -- preemption -----------------------------------------------------------

    def _exclusive(self, r: Request) -> int:
        """Pages an eviction of ``r`` actually frees: its refcount-1 pages.
        Shared (prefix) pages are pinned — other sequences read them."""
        return len(self.view.exclusive(r.pages))

    def victim_score(self, r: Request) -> float:
        """priority-factor x footprint x Eq.-1 stall cost (DESIGN.md §5):
        ``2^-level`` halves a victim's attractiveness per priority level;
        footprint is the *bytes* the eviction frees (exclusive pages only —
        shared prefix pages stay put; byte-denominated so scores compare
        across page geometries, DESIGN.md §12); the stall term prefers
        sequences whose pages already gate the batch's read time."""
        stall = self.view.stall_cost(r.pages)
        freed_bytes = self._exclusive(r) * float(self.view.page_bytes)
        return (2.0 ** -self.level(r)) * freed_bytes * (stall + 1e-12)

    def _swap_out(self, r: Request) -> None:
        pages = self._exclusive(r)
        r.pages, secs = self.swap.swap_out(r.pages)
        self.running.remove(r)
        r.state = State.SWAPPED
        self.swapped.append(r)
        self.slo.on_preempt(r.sid, pages)
        obs = self.view.fabric.obs
        if obs is not None:
            obs.on_preempt(self.view, r, self.now, secs, pages)
        if self._plan is not None:
            self._plan.swapped_out.append(r)
            self._plan.swap_seconds += secs

    def _reclaim(self, need: int, max_level: int | None = None) -> bool:
        """Swap out victims until ``need`` pages are allocatable. Never
        touches classes above ``max_level`` (capacity pressure from a low
        class must not evict a high one). Victims must free at least one
        page — evicting an all-shared sequence reclaims nothing."""
        while self.view.free_count() < need:
            if self.swap is None:
                return False
            protect = self._plan.swapped_in if self._plan is not None else []
            victims = [r for r in self.running if self._exclusive(r) > 0
                       and r not in protect   # no same-step in->out churn
                       and (max_level is None or self.level(r) <= max_level)
                       and self.swap.can_swap_out(self._exclusive(r))]
            if not victims:
                return False
            self._swap_out(max(victims, key=self.victim_score))
        return True

    def _priority_preempt(self) -> None:
        """Make a batch slot for the best waiting request by evicting a
        strictly lower class (victim choice by ``victim_score``)."""
        if self.swap is None:
            return
        cands = sorted(self._arrived() + self.swapped, key=self._order)
        if not cands or self._slots_used() < self.max_batch:
            return
        cand = cands[0]
        lower = [r for r in self.running if self.level(r) < self.level(cand)
                 and r.pages and self.swap.can_swap_out(self._exclusive(r))]
        if lower:
            self._swap_out(max(lower, key=self.victim_score))

    def _stall_preempt(self) -> None:
        """Stall-triggered preemption: when one sequence's Eq.-1 KV read
        time exceeds ``stall_preempt_fraction`` of the whole batch's read
        time, its pages are gating every token the batch produces — evict
        it (the worst offender, one per step) so the rest of the batch runs
        at the speed of its own placement. The victim sits out
        ``stall_preempt_cooldown_s`` of virtual time before resuming."""
        frac = self.stall_preempt_fraction
        if frac is None or self.swap is None or len(self.running) < 2:
            return
        batch = self.view.stall_cost(
            [p for r in self.running for p in r.pages])
        if batch <= 0.0:
            return
        offenders = [
            r for r in self.running
            if self._exclusive(r) > 0
            and self.swap.can_swap_out(self._exclusive(r))
            and self.view.stall_cost(r.pages) > frac * batch]
        if offenders:
            victim = max(offenders,
                         key=lambda r: self.view.stall_cost(r.pages))
            victim.resume_after = self.now + self.stall_preempt_cooldown_s
            self._swap_out(victim)

    # -- resume ---------------------------------------------------------------

    def _swap_ins(self, plan: StepPlan) -> None:
        for r in sorted(self.swapped, key=self._order):
            if r in plan.swapped_out:    # no same-step thrash
                continue
            if r.resume_after > self.now:   # stall-preemption cooldown
                continue
            if self._slots_used() >= self.max_batch:
                break
            # promotable footprint re-allocates: pages parked in slots AND
            # pages demoted to the persistent tier; pinned shared pages
            # never left
            need = (self.swap.promotable_count(r.pages)
                    + self._seq_growth(r.length, r.pages)
                    + self._growth_need(self.running))
            if self.conservative_admission:
                need = max(need, self.swap.promotable_count(r.pages)
                           + self._future_pages(r)
                           + self._admitted_future())
            if self.view.free_count() < need:
                continue
            r.pages, secs = self.swap.swap_in(r.pages)
            self.swapped.remove(r)
            r.state = State.RUNNING
            self.running.append(r)
            self.slo.on_resume(r.sid, len(r.pages))
            obs = self.view.fabric.obs
            if obs is not None:
                obs.on_resume(self.view, r, self.now, secs)
            plan.swapped_in.append(r)
            plan.swap_seconds += secs

    # -- chunked prefill ------------------------------------------------------

    def _plan_prefills(self, plan: StepPlan) -> None:
        ps = self.view.page_size
        budget = self.prefill_token_budget
        if self.spec_tokens:
            # draft+verify accounting: every running sequence's decode this
            # step is a (1 + spec_tokens)-token forward through the same
            # batched prefill-mode op prefill chunks use — charge it
            # against the shared per-step token budget first, so a step's
            # total forward tokens stay bounded (running sequences always
            # decode; prefill takes what is left)
            budget -= len(self.running) * (1 + self.spec_tokens)
            if budget <= 0:
                return
        in_flight = sorted(self.prefilling, key=self._order)
        fresh = self._arrived()
        for r in in_flight + fresh:
            if budget <= 0:
                break
            if r.state is State.QUEUED \
                    and self._slots_used() >= self.max_batch:
                continue                 # a lower class may still fit later
            if r.state is State.QUEUED and not r.pages and r.length == 0:
                # probe the prefix trie — matched pages join the view
                # shared (refcount bumps), their K/V already sits in the
                # pool, and prefill starts past them. A capacity-blocked
                # request re-probes next step (a donor may register late);
                # only the first probe counts in telemetry.
                matched = self.view.probe_prefix(
                    r.tokens[:r.prompt_len], r.pages, count=not r.probed)
                r.probed = True
                # a full-prompt match still leaves the last prompt token to
                # the first decode step (it CoW-forks the shared page)
                r.length = min(matched, r.prefill_target)
            target = r.prefill_target
            chunk = min(budget, target - r.length)
            hi = r.length + chunk
            new_pages = -(-hi // ps) - len(r.pages)
            # reserve the first decode step's pages too when this chunk
            # completes the prefill, so the sequence can decode (with
            # speculation the first verify step may span several pages)
            done_now = hi == target
            first_decode = 0
            if done_now:
                first_decode = max(
                    0, -(-(target + self.spec_tokens + 1) // ps)
                    - (-(-hi // ps)))
            need = new_pages + self._growth_need(self.running) + first_decode
            if self.conservative_admission and r.state is State.QUEUED:
                # admit only if the whole batch (this request included)
                # can still run to completion on free pages alone
                need = max(need, self._future_pages(r)
                           + self._admitted_future())
            if self.view.free_count() < need and \
                    not self._reclaim(need, max_level=self.level(r)):
                continue
            self.view.grow(r.pages, new_pages)
            # NB: trie registration happens in the *engine* after the final
            # chunk's K/V physically lands (registering at plan time let a
            # same-step matcher bump refcounts before the donor's write,
            # which then CoW-forked the donor onto private clones and left
            # the matcher reading never-written pages)
            if chunk > 0:
                plan.prefill_chunks.append((r, r.length, hi))
                budget -= chunk
                # advance now so growth accounting sees the post-chunk
                # length; the engine writes K/V from the plan's (lo, hi)
                r.length = hi
            if r.state is State.QUEUED:
                self.queued.remove(r)
                if done_now:
                    r.state = State.RUNNING
                    self.running.append(r)
                else:
                    r.state = State.PREFILL
                    self.prefilling.append(r)
            elif done_now:
                self.prefilling.remove(r)
                r.state = State.RUNNING
                self.running.append(r)

    def _launch_groups(self, batch) -> list | None:
        """Partition the decode batch by Eq.-1 bottleneck domain
        (DESIGN.md §11): each sequence joins the micro-batch of the domain
        that gates *its own* read, so a launch's bottleneck bytes all
        belong to its sequences and launches to different domain groups
        overlap. The step stall becomes the max over per-launch
        bottlenecks — never worse than the global max, and strictly
        better whenever no single domain carries every launch's
        bottleneck. Cross-launch traffic inside one domain is
        second-order here; the drift ledger's per-launch billing absorbs
        the residual model error into calibration. Returns ``None`` when
        every sequence lands in one group (a global launch is identical
        and skips the partition bookkeeping)."""
        bw = self.view.bw * 1e9
        fallback = int(np.argmax(bw))    # pageless sequence: fastest domain
        groups: dict[int, list] = {}
        for r in batch:
            bpd = self.view.footprint(r.pages)
            dom = int(np.argmax(bpd / bw)) if bpd.sum() > 0 else fallback
            groups.setdefault(dom, []).append(r)
        if len(groups) <= 1:
            return None
        return [(d, groups[d]) for d in sorted(groups)]

    def _apply_page_remap(self, moves: dict) -> None:
        """All-holders re-homing moved physical pages under us: swap the
        old ids for the new ones in every live request's page list (a
        queued request can hold trie-matched pages from the admission
        probe; a swapped request's list keeps its *shared* pages live).
        In place: the swap manager rewrites a swapped request's list when
        its parked pages move (``swap.KVSwapManager._rehome``)."""
        for r in (self.queued + self.prefilling + self.running
                  + self.swapped):
            if r.pages:
                r.pages[:] = [moves.get(p, p) for p in r.pages]

    def _rehome_live(self) -> None:
        """The view's allocation cycle moved under us (arbiter-driven
        co-scheduled tuning): re-home live sequences' pages per the new
        weights (one batched gather/scatter; shared pages stay pinned)."""
        for r in self.running:
            r.pages = self.view.migrate(r.pages)

    def _ensure_growth(self) -> None:
        """The decode batch must be able to allocate its next pages; evict
        (any class — an undecodable batch serves nobody) or fail loudly."""
        while self.view.free_count() < self._growth_need(self.running):
            victims = [r for r in self.running if self._exclusive(r) > 0
                       and self.swap is not None
                       and self.swap.can_swap_out(self._exclusive(r))]
            if not victims:
                raise RuntimeError("KV pool exhausted: decode batch cannot "
                                   "grow and no victim is swappable")
            self._swap_out(max(victims, key=self.victim_score))

    # -- completion + clock (driven by the engine) ----------------------------

    def advance(self, seconds: float) -> None:
        self.now += float(seconds)

    def notice_first_token(self, r: Request) -> None:
        self.slo.on_first_token(r.sid, self.now)

    def finish(self, r: Request) -> None:
        r.done = True
        r.state = State.FINISHED
        # drop this request's references; pages nobody else holds are
        # freed, pages shared with live sequences stay (and stay matchable)
        self.view.release(r.pages)
        r.pages = []
        self.running.remove(r)
        self.finished.append(r)
        self.slo.on_finish(r.sid, self.now, r.produced)
        obs = self.view.fabric.obs
        if obs is not None:
            obs.on_finish(self.view, r, self.now)

    # -- reporting ------------------------------------------------------------

    def stats(self) -> dict:
        return {
            "now_s": self.now,
            "queued": len(self.queued),
            "prefilling": len(self.prefilling),
            "running": len(self.running),
            "swapped": len(self.swapped),
            "finished": len(self.finished),
            "swap_slots_free": (self.swap.slots_free()
                                if self.swap else 0),
            "demoted_pages": (self.swap.demoted_count()
                              if self.swap else 0),
            "slo": self.slo.summary(self.now),
        }
