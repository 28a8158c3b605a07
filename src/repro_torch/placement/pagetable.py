"""Logical→physical page table: refcounts, prefix-sharing trie, CoW forks.

BWAP's unit of placement is the *physical* page; the serving stack's unit of
meaning is the *logical* page — "the b-th page-size block of this sequence's
K/V". The seed bound the two directly (``Request.pages`` was the physical
truth), so identical prompt prefixes — which heavy-tail traces produce
constantly — materialized N times, and nothing in the stack could say "these
two sequences read the same bytes". This table decouples them, the same
indirection that lets tiered-memory systems migrate pages under a live
workload (arXiv 2112.12685) and co-locate shared hot pages in fast domains
(CODA, arXiv 1710.09517):

- **Refcounts** — ``ref[pid]`` counts how many sequence views hold physical
  page ``pid``. Pages are allocated from / returned to the
  :class:`~repro.placement.pool.BwapPagePool` only through this table
  (``append_page`` / ``release``); a page is freed when its last holder
  releases it.
- **Prefix trie** — completed *prompt* pages are registered under a chain
  key ``(parent_node_id, token_block)``: a node matches only when its whole
  ancestor chain matches, so equal token blocks at different depths (or
  after different prefixes) never alias. ``match_prefix`` walks the trie
  and hands back the longest chain of already-materialized pages with
  refcount bumps — the new sequence starts life with those logical pages
  mapped to shared physical pages, shrinking its physical footprint and its
  prefill work at once.
- **Copy-on-write** — a write to a page with ``ref > 1`` must not be seen by
  the other holders. ``fork_for_write`` allocates a fresh page, copies the
  contents through the migration executor (one gather/scatter pair), moves
  one reference over, and returns the private clone. The only organic
  trigger in the serving stack is a *full-prompt* match: the first decode
  step rewrites the last prompt position, which lives in a shared page.

Placement stays downstream and untouched: the pool still decides *where*
physical pages live, migration/swap still move them — they just notify the
table (``remap_physical``) so refcounts and trie nodes follow the bytes.
Pages with ``ref > 1`` are **pinned** for movement purposes: migration and
swap skip them, because the mover only speaks for one of the holders
(``exclusive`` filters a view down to movable pages).
"""

from __future__ import annotations

import itertools
from typing import Sequence

ROOT = -1                      # parent id of depth-0 trie nodes


class _TrieNode:
    """One registered full page: chain-keyed by (parent node, token block)."""

    __slots__ = ("nid", "parent", "block", "phys", "children")

    def __init__(self, nid: int, parent: int, block: tuple, phys: int):
        self.nid = nid
        self.parent = parent               # parent node id (ROOT at depth 0)
        self.block = block                 # the page's token tuple
        self.phys = phys
        self.children: set[int] = set()    # child node ids


class PageTable:
    """Refcounted logical→physical mapping for one page pool.

    A sequence's *view* is its positional page list (``Request.pages``):
    index = logical page number, value = physical page id. The table does
    not own the lists — it owns the lifetime (refcounts), the sharing index
    (trie), and the fork semantics; callers thread their lists through.
    """

    def __init__(self, pool, prefix_reuse: bool = True):
        self.pool = pool
        self.prefix_reuse = prefix_reuse
        # the group geometry's shareability class gates the trie outright:
        # non-shareable pages (SSM state, mutated in place every step) must
        # never be matched into another sequence, whatever prefix_reuse
        # callers later toggle on this table
        self._shareable = bool(
            getattr(getattr(pool, "geometry", None), "shareable", True))
        self.ref: dict[int, int] = {}
        self._nodes: dict[int, _TrieNode] = {}
        self._index: dict[tuple[int, tuple], int] = {}   # key -> node id
        self._node_of: dict[int, int] = {}               # phys -> node id
        self._ids = itertools.count()
        # cumulative counters (surfaced via FabricView.snapshot)
        self.cow_faults = 0
        self.prefix_hit_pages = 0
        self.prefix_probes = 0
        self.prefix_misses = 0

    # -- allocation / release (the only paths to the pool's free lists) ------

    def append_page(self, view: list, alloc=None) -> int:
        """Grow a view by one fresh (exclusive) physical page. ``alloc``
        overrides the physical allocator — a fabric view passes its
        quota-ledgered, per-tenant allocation cycle; bare callers get the
        pool's own."""
        pid = (alloc or self.pool.alloc_page)()
        self.ref[pid] = 1
        view.append(pid)
        return pid

    def grow(self, view: list, n: int, alloc=None) -> None:
        for _ in range(n):
            self.append_page(view, alloc=alloc)

    def pop_page(self, view: list) -> int:
        """Undo the most recent ``append_page`` on this view (speculative
        rollback): drops the reference and returns the id so the caller can
        hand it back to the allocator (``pool.undo_alloc`` — *not*
        ``free_pages``, which would log churn and reorder the free list).
        Only valid for exclusive, trie-unregistered pages — which freshly
        appended decode pages always are."""
        pid = view.pop()
        n = self.ref.pop(pid)
        assert n == 1, "cannot pop a shared page"
        assert pid not in self._node_of, "cannot pop a registered page"
        return pid

    def release(self, view: Sequence[int]) -> list[int]:
        """Drop one reference per page; free pages nobody holds anymore.
        Returns the freed (dead) page ids so ledgered callers (fabric
        views) can settle per-tenant ownership accounting."""
        dead: list[int] = []
        for pid in view:
            n = self.ref[pid] - 1
            if n:
                self.ref[pid] = n
            else:
                del self.ref[pid]
                self._unregister(pid)
                dead.append(pid)
        if dead:
            self.pool.free_pages(dead)
        return dead

    # -- sharing ---------------------------------------------------------------

    def shared(self, pid: int) -> bool:
        return self.ref.get(pid, 1) > 1

    def exclusive(self, view: Sequence[int]) -> list[int]:
        """The view's movable pages: held by this view alone. Shared pages
        are pinned — migration/swap would yank them out from under the
        other holders."""
        return [p for p in view if self.ref.get(p, 1) == 1]

    def match_prefix(self, tokens: Sequence[int], view: list, *,
                     count: bool = True, allow=None) -> int:
        """Walk the trie over full ``page_size`` blocks of ``tokens``,
        bumping refcounts and appending matched physical pages to ``view``
        (must be empty). Returns the number of *tokens* covered.
        ``count=False`` leaves the probe/miss telemetry untouched (a
        capacity-blocked request re-probes every step hoping for a late
        registration; only its first probe should count). ``allow`` is an
        optional per-page predicate: the walk stops at the first physical
        page it rejects — fabric views use it to gate the cross-tenant
        prefix tier (a view may only match pages whose owner opted into
        sharing)."""
        assert not view, "prefix match must seed an empty view"
        if count:
            self.prefix_probes += 1
        if not (self.prefix_reuse and self._shareable):
            return 0
        ps = self.pool.page_size
        parent = ROOT
        for b in range(len(tokens) // ps):
            block = tuple(tokens[b * ps:(b + 1) * ps])
            nid = self._index.get((parent, block))
            if nid is None:
                break
            pid = self._nodes[nid].phys
            if allow is not None and not allow(pid):
                break
            self.ref[pid] += 1
            view.append(pid)
            parent = nid
        if count and not view:
            self.prefix_misses += 1
        self.prefix_hit_pages += len(view)
        return len(view) * ps

    def peek_prefix(self, tokens: Sequence[int], *, allow=None) -> int:
        """``match_prefix`` without the side effects: how many *tokens* a
        probe would cover right now, bumping no refcounts and touching no
        telemetry. Trie-aware admission calls this at submit time to size a
        request's physical (post-sharing) footprint."""
        if not (self.prefix_reuse and self._shareable):
            return 0
        ps = self.pool.page_size
        parent = ROOT
        matched = 0
        for b in range(len(tokens) // ps):
            block = tuple(tokens[b * ps:(b + 1) * ps])
            nid = self._index.get((parent, block))
            if nid is None or (allow is not None
                               and not allow(self._nodes[nid].phys)):
                break
            matched += 1
            parent = nid
        return matched * ps

    def register_prefix(self, tokens: Sequence[int], view: Sequence[int],
                        upto_tokens: int) -> int:
        """Make the view's full prompt pages discoverable: register every
        page whose ``page_size`` token block lies entirely within
        ``tokens[:upto_tokens]`` (i.e. whose K/V is final). Idempotent along
        already-registered chains; first writer wins on races (a page that
        lost the race simply stays private). Returns pages registered."""
        if not (self.prefix_reuse and self._shareable):
            return 0
        ps = self.pool.page_size
        parent = ROOT
        added = 0
        for b in range(upto_tokens // ps):
            block = tuple(tokens[b * ps:(b + 1) * ps])
            key = (parent, block)
            nid = self._index.get(key)
            if nid is None:
                pid = view[b]
                if pid in self._node_of:       # already registered elsewhere
                    break                       # (can't chain through it twice)
                nid = next(self._ids)
                node = _TrieNode(nid, parent, block, pid)
                self._nodes[nid] = node
                self._index[key] = nid
                self._node_of[pid] = nid
                if parent != ROOT and parent in self._nodes:
                    self._nodes[parent].children.add(nid)
                added += 1
            parent = nid
        return added

    # -- chain export / import (persistence tier, DESIGN.md §9) ----------------

    def export_chains(self, select=None) -> list[dict]:
        """Serialize the trie as maximal root-anchored chains.

        A chain is only meaningful with its whole ancestor line (the chain
        key is ``(parent, block)``), so the walk starts at depth-0 nodes and
        descends while every page passes ``select`` (default: all). Each
        record carries the concatenated token blocks and the physical ids in
        chain order — enough for a peer (or a restarted fabric) to rebuild
        the exact chain keys via ``register_prefix``. Branching chains emit
        one record per leaf; shared ancestor pages repeat across records and
        deduplicate on import through a prefix probe.
        """
        ok = (lambda pid: True) if select is None else select
        out: list[dict] = []
        roots = [n for n in self._nodes.values()
                 if n.parent == ROOT and ok(n.phys)]
        stack = [(n, [], []) for n in sorted(roots, key=lambda n: -n.nid)]
        while stack:
            node, toks, phys = stack.pop()
            toks = toks + list(node.block)
            phys = phys + [node.phys]
            kids = [self._nodes[c] for c in node.children
                    if c in self._nodes and ok(self._nodes[c].phys)]
            if not kids:
                out.append({"tokens": toks, "phys": phys})
                continue
            stack.extend((k, toks, phys)
                         for k in sorted(kids, key=lambda n: -n.nid))
        return out

    def import_chains(self, chains: Sequence[dict], pages_of) -> int:
        """Re-register exported chains against *this* table. ``pages_of``
        maps a chain record to its already-materialized physical pages (the
        importer allocates and fills them first). Idempotent along chains
        that already exist. Returns pages newly registered."""
        added = 0
        for ch in chains:
            added += self.register_prefix(ch["tokens"], pages_of(ch),
                                          len(ch["tokens"]))
        return added

    # -- copy-on-write ---------------------------------------------------------

    def fork_for_write(self, view: list, idx: int, alloc=None) -> int:
        """Make logical page ``idx`` privately writable. No-op for exclusive
        pages; for shared pages: allocate a clone, copy the bytes (one
        batched gather/scatter through the pool's executor), move this
        view's reference onto the clone. Returns the writable physical id.
        ``alloc`` overrides the physical allocator (fabric views charge the
        clone to their own quota)."""
        pid = view[idx]
        if self.ref.get(pid, 1) <= 1:
            return pid
        clone = (alloc or self.pool.alloc_page)()
        self.pool.executor.execute(
            (self.pool.k_pool, self.pool.v_pool), [pid], [clone],
            src_domains=[self.pool.domain_of(pid)],
            dst_domains=[self.pool.domain_of(clone)])
        self.ref[pid] -= 1
        self.ref[clone] = 1
        view[idx] = clone
        self.cow_faults += 1
        return clone

    def ensure_writable(self, view: list, lo_tok: int, hi_tok: int,
                        alloc=None) -> None:
        """CoW-fork every logical page overlapping token positions
        [lo_tok, hi_tok) ahead of a write."""
        ps = self.pool.page_size
        for idx in range(lo_tok // ps, -(-hi_tok // ps)):
            self.fork_for_write(view, idx, alloc=alloc)

    # -- movement notifications (migration / swap / rebalance) -----------------

    def remap_physical(self, old: int, new: int) -> None:
        """A mover relocated an exclusive page's bytes: carry the reference
        and any trie node over to the new id."""
        self.ref[new] = self.ref.pop(old)
        nid = self._node_of.pop(old, None)
        if nid is not None:
            self._nodes[nid].phys = new
            self._node_of[new] = nid

    def unregister(self, pid: int) -> None:
        """Drop the page (and its now-unreachable descendants) from the
        trie without touching refcounts — used when a page's bytes leave
        the live pool (swap-out parks them in a reserved slot)."""
        self._unregister(pid)

    def _unregister(self, pid: int) -> None:
        nid = self._node_of.pop(pid, None)
        if nid is None:
            return
        stack = [nid]
        while stack:
            n = self._nodes.pop(stack.pop())
            self._index.pop((n.parent, n.block), None)
            self._node_of.pop(n.phys, None)
            if n.parent in self._nodes:
                self._nodes[n.parent].children.discard(n.nid)
            stack.extend(c for c in n.children if c in self._nodes)

    def remap(self, id_map) -> None:
        """Pool was rebuilt (arbiter rebalance): rewrite every physical id."""
        self.ref = {int(id_map[p]): n for p, n in self.ref.items()}
        self._node_of = {}
        for nid, node in self._nodes.items():
            node.phys = int(id_map[node.phys])
            assert node.phys >= 0, "trie page lost in rebalance"
            self._node_of[node.phys] = nid
        assert all(p >= 0 for p in self.ref), "refcounted page lost"

    # -- reporting -------------------------------------------------------------

    def stats(self) -> dict:
        """Instantaneous sharing state + cumulative fork/probe counters."""
        phys = len(self.ref)
        logical = sum(self.ref.values())
        return {
            "physical_pages": phys,
            "logical_pages": logical,
            "shared_pages": sum(1 for n in self.ref.values() if n > 1),
            "unique_pages": sum(1 for n in self.ref.values() if n == 1),
            "saved_pages": logical - phys,
            "trie_nodes": len(self._nodes),
            "cow_faults": self.cow_faults,
            "prefix_hit_pages": self.prefix_hit_pages,
            "prefix_probes": self.prefix_probes,
            "prefix_misses": self.prefix_misses,
        }
