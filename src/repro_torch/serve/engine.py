"""Batched serving engine over the BWAP page pool (dense GQA archs), in
PyTorch (port of ``repro.serve.engine``).

Priority continuous batching through the request scheduler (admission,
chunked prefill, preemption with KV swap — ``repro_torch.scheduler``),
paged prefill + decode through ``kernels/paged_attention`` (the CUDA kernel
when the pool lives on a card, the plain PyTorch version on the CPU), BWAP
placement of fresh pages, and online DWP tuning fed by step latencies.

Differences from the reference, all on the data plane:

- the pool tensors are written in place (the reference rebinds a new array
  after every write); the verify snapshot stays a copy (advanced indexing);
- compute-dtype weights are cast once when the decoder is built, not at
  every use: the same bits, without a 1 GB bf16 cast per step at full width
  (for fp32 compute the cast is the identity and costs nothing);
- one device-to-host copy per decode launch brings the argmax tokens back
  (one a step, or one a domain micro-batch under ``coda``).

Heat-driven re-homing (``rehome=True``, the ``coda`` policy's default)
moves hot shared pages into fast domains on the pool's device, through the
executor's in-place gather/scatter (``FabricView.rehome_hot``). Finish
callbacks (``on_request_finish``) run for each finishing request before the
scheduler releases its pages: the cluster router
(``repro_torch.cluster.router``) exports the prompt range there.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import dtype_of, resolve
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, layer_params_of
from repro_torch.obs.heat import PageHeat
from repro_torch.placement.fabric import as_view
from repro_torch.scheduler.scheduler import Request, RequestScheduler


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


class PagedDecoder:
    """Per-layer forward through the page pool (dense/GQA families)."""

    def __init__(self, cfg: ModelConfig, params, pool):
        assert cfg.family in ("dense", "vlm") and cfg.mla is None
        self.cfg = cfg
        self.params = params
        self.view = as_view(pool)        # placement + data plane surface
        self.device = self.view.pool.device
        # the CUDA kernel on a card; impl="reference" forces the plain
        # version (chip_smoke.py compares the two on one pool state)
        self.impl = "cuda" if self.device.type == "cuda" else "reference"
        if self.impl == "cuda":
            paged_kernel.check_head_dim(cfg.head_dim_)
        cdt = dtype_of(cfg.compute_dtype)
        gp = params["groups"][0]
        # weights in the compute dtype, cast once (norm gains stay fp32:
        # rmsnorm reads them in fp32 either way)
        self.layers = []
        for l in range(cfg.num_layers):
            p = layer_params_of(gp, l)
            self.layers.append({"norm1": p["norm1"], "norm2": p["norm2"],
                                "attn": _cast_tree(p["attn"], cdt),
                                "mlp": _cast_tree(p["mlp"], cdt)})
        self.embed = params["embed"].to(cdt)
        self.head = (self.embed.T if cfg.tie_embeddings
                     else params["head"].to(cdt))

    def _t(self, a: np.ndarray, dtype=torch.int64) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _qkv(self, p, x, pos, b: int, t: int):
        cfg = self.cfg
        nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        h = L.apply_norm(cfg, p["norm1"], x)
        a = p["attn"]
        q = (h @ a["wq"]).reshape(b, t, nq, hd)
        k = (h @ a["wk"]).reshape(b, t, nkv, hd)
        v = (h @ a["wv"]).reshape(b, t, nkv, hd)
        if cfg.qkv_bias:
            q = q + a["bq"].reshape(nq, hd)
            k = k + a["bk"].reshape(nkv, hd)
            v = v + a["bv"].reshape(nkv, hd)
        if cfg.use_rope:
            q = L.apply_rope(q, pos, cfg.rope_theta)
            k = L.apply_rope(k, pos, cfg.rope_theta)
        return q, k, v

    def _out_mlp(self, p, x, att, b: int, t: int):
        cfg = self.cfg
        x = x + att.reshape(b, t, cfg.num_heads * cfg.head_dim_) \
            @ p["attn"]["wo"]
        h = L.apply_norm(cfg, p["norm2"], x)
        return x + L.mlp_apply(cfg, p["mlp"], h)

    def _logits(self, x):
        x = L.apply_norm(self.cfg, self.params["final_norm"], x)
        return x @ self.head

    def forward_chunks(self, chunks, *, want_logits: bool = False):
        """Fused multi-sequence chunk forward: ``chunks`` is a list of
        ``(token_ids, pages, start)`` — one sequence's token chunk at
        absolute positions ``[start, start + len(token_ids))`` over its page
        view. Per layer every chunk's K/V is scattered into its pages first
        (one op for the whole batch), then all chunks' queries run one
        batched prefill-mode paged-attention launch.

        Chunks are right-padded to the longest one; padded queries' K/V
        never lands in the pool and their outputs are discarded. With
        ``want_logits`` the padded [B,T,V] logits are returned (the
        speculative verify step reads its argmax from them)."""
        cfg = self.cfg
        b = len(chunks)
        ps = self.view.page_size
        t = max(len(toks) for toks, _, _ in chunks)
        toks_pad = np.zeros((b, t), np.int64)
        pos_pad = np.zeros((b, t), np.int64)
        starts = np.zeros(b, np.int32)
        mp = max(-(-(start + len(toks)) // ps) for toks, _, start in chunks)
        tables = np.zeros((b, mp), np.int32)
        seq_i: list[int] = []      # scatter coordinates of real positions
        tok_i: list[int] = []
        pids: list[int] = []
        slots: list[int] = []
        for i, (toks, pages, start) in enumerate(chunks):
            ti = len(toks)
            toks_pad[i, :ti] = toks
            pos_pad[i] = start + np.arange(t)
            starts[i] = start
            cover = -(-(start + ti) // ps)
            tables[i, :cover] = pages[:cover]
            seq_i.extend([i] * ti)
            tok_i.extend(range(ti))
            pids.extend(int(pages[p // ps]) for p in range(start, start + ti))
            slots.extend(p % ps for p in range(start, start + ti))
        seq_i, tok_i = self._t(np.asarray(seq_i)), self._t(np.asarray(tok_i))
        pids, slots = self._t(np.asarray(pids)), self._t(np.asarray(slots))
        tbl = self._t(tables, torch.int32)
        qs = self._t(starts, torch.int32)
        pos = self._t(pos_pad)

        x = self.embed[self._t(toks_pad)]                  # [B,T,d]
        if cfg.embed_scale:
            x = x * np.sqrt(cfg.d_model)
        kp, vp = self.view.k_pool, self.view.v_pool
        for l, p in enumerate(self.layers):
            q, k, v = self._qkv(p, x, pos, b, t)
            # real positions' K/V lands before attention: the causal mask
            # then covers prefix and intra-chunk keys uniformly (padded
            # positions never land)
            kp[l, pids, slots] = k[seq_i, tok_i]
            vp[l, pids, slots] = v[seq_i, tok_i]
            att = paged_ops.paged_prefill_attention_batch(
                q, kp[l], vp[l], tbl, qs, impl=self.impl)
            x = self._out_mlp(p, x, att, b, t)
        if not want_logits:
            return None
        return self._logits(x)                             # [B,T,V]

    def decode_step(self, tokens, tables, lens, positions):
        """tokens [B,1] int64; tables [B,MP] int32; lens [B] int32;
        positions [B] int64 — all on the decoder's device. -> [B,V]."""
        cfg = self.cfg
        b = tokens.shape[0]
        ps = self.view.page_size
        x = self.embed[tokens]                             # [B,1,d]
        if cfg.embed_scale:
            x = x * np.sqrt(cfg.d_model)
        pos_b = positions[:, None]
        # the batch's K/V lands in one scatter per layer, at the same
        # (page, slot) for every layer
        pages = torch.take_along_dim(tables, (positions // ps)[:, None],
                                     dim=1)[:, 0].long()
        slots = positions % ps
        seen = (lens + 1).to(torch.int32)
        kp, vp = self.view.k_pool, self.view.v_pool
        for l, p in enumerate(self.layers):
            q, k, v = self._qkv(p, x, pos_b, b, 1)
            self.view.write_decode_batch(l, pages, slots, k[:, 0], v[:, 0])
            att = paged_ops.paged_attention(q[:, 0], kp[l], vp[l], tables,
                                            seen, impl=self.impl)
            x = self._out_mlp(p, x, att, b, 1)
        return self._logits(x)[:, 0]                       # [B, V]


class ServeEngine:
    """Model execution over the pool; the request lifecycle — admission,
    batch composition, chunked prefill pacing, preemption — is owned by the
    :class:`RequestScheduler` (pass one in to configure priority classes and
    KV swap; the default scheduler reproduces plain continuous batching).

    ``device`` must be the pool's device (default ``"cuda"``)."""

    def __init__(self, cfg: ModelConfig, params, pool,
                 max_batch: int = 8, max_new: int = 32, seed: int = 0,
                 scheduler: RequestScheduler | None = None,
                 wall_clock: bool = True, sim_step_s: float = 0.0,
                 incremental_prefill: bool = True,
                 prefix_reuse: bool = True,
                 drafter=None,
                 rehome: bool | None = None,
                 rehome_budget_frac: float = 0.5,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve(device)
        self.view = as_view(pool)        # the only placement surface
        if self.view.pool.device != self.device:
            raise ValueError(f"pool on {self.view.pool.device}, engine "
                             f"asked for {self.device}")
        self.model = LM(cfg)
        self.decoder = PagedDecoder(cfg, params, self.view)
        self.params = params
        self.scheduler = scheduler if scheduler is not None else \
            RequestScheduler(self.view, max_batch=max_batch,
                             default_max_new=max_new)
        # wall_clock=False runs the virtual clock on the Eq.-1 analytic
        # terms only — deterministic SLO numbers and page ids for
        # benchmarks/tests; sim_step_s then stands in for compute time
        self.wall_clock = wall_clock
        self.sim_step_s = sim_step_s
        # incremental_prefill=False falls back to prefix recompute (the
        # bit-exactness oracle); prefix_reuse=False disables trie matching
        self.incremental_prefill = incremental_prefill
        self.view.table.prefix_reuse = prefix_reuse
        # speculative multi-token decode: the drafter proposes, the verify
        # step accepts only what the model's own argmax confirms; the
        # scheduler reserves page growth and token budget for the lookahead
        self.drafter = drafter
        if drafter is not None:
            self.scheduler.spec_tokens = max(self.scheduler.spec_tokens,
                                             drafter.max_tokens)
        # heat-driven re-homing: after each decode step, migrate the
        # hottest shared slow-domain pages into fast domains under an Eq.-1
        # budget of ``rehome_budget_frac`` of the step's stall. Default
        # follows the view's policy (``coda`` turns it on). Heat comes from
        # the attached observatory when it has one, else a private PageHeat
        self.rehome = (bool(rehome) if rehome is not None
                       else bool(getattr(self.view.placement_policy,
                                         "rehome", False)))
        self.rehome_budget_frac = float(rehome_budget_frac)
        self._heat = None
        self.rehomed_pages = 0
        # cluster handoff hook (DESIGN.md §13): callbacks fired for each
        # finishing request BEFORE scheduler.finish releases its pages —
        # the ClusterRouter exports the prompt range while the trie chain
        # still has a live holder
        self._finish_cbs: list = []
        self.prefill_tokens_computed = 0   # forward-pass tokens spent on
        self.prefill_chunks_run = 0        # prefill (the O(n) vs O(n²) gap)
        self.decode_steps = 0              # steps that ran a decode batch
        self.tokens_emitted = 0            # decode tokens committed
        self.latencies: list[float] = []

    # scheduler views under the pre-scheduler attribute names
    @property
    def active(self) -> list[Request]:
        return self.scheduler.running

    @property
    def waiting(self) -> list[Request]:
        return self.scheduler.pending

    @property
    def finished(self) -> list[Request]:
        return self.scheduler.finished

    def submit(self, prompt: Sequence[int], *, cls: str | None = None,
               max_new: int | None = None,
               arrival_s: float | None = None) -> int:
        return self.scheduler.submit(prompt, cls=cls, max_new=max_new,
                                     arrival_s=arrival_s)

    def on_request_finish(self, cb) -> None:
        """Register ``cb(engine, seq)`` to run when a request finishes,
        *before* the scheduler releases its pages — the only window where
        a handoff can export the sequence's range (release may drop the
        last reference and the trie chain dies with it)."""
        self._finish_cbs.append(cb)

    # -- chunked prefill ------------------------------------------------------

    def _run_prefills(self, chunks) -> None:
        """Materialize K/V for this step's prompt chunks: incremental (all
        same-step chunks fused into one batched launch per layer, reading
        prior chunks' K/V from the pool) or, with
        ``incremental_prefill=False``, prefix recompute (the exactness
        oracle). The last prompt token is never prefilled — the first decode
        step consumes it and writes its K/V at the true position."""
        chunks = [(s, lo, hi) for s, lo, hi in chunks if hi > lo]
        if not chunks:
            return
        if not self.incremental_prefill:
            for seq, lo, hi in chunks:
                self._prefill_chunk_recompute(seq, lo, hi)
            return
        fused = []
        for seq, lo, hi in chunks:
            # defensive CoW: a fork here keeps a mis-planned write from
            # corrupting another sequence's shared prefix
            self.view.ensure_writable(seq.pages, lo, hi)
            self.prefill_chunks_run += 1
            self.prefill_tokens_computed += hi - lo
            fused.append((seq.tokens[lo:hi], seq.pages, lo))
        self.decoder.forward_chunks(fused)
        for seq, lo, hi in chunks:
            seq.length = hi
            self._register_if_done(seq, hi)

    def _prefill_chunk_recompute(self, seq: Request, lo: int, hi: int):
        self.view.ensure_writable(seq.pages, lo, hi)
        self.prefill_chunks_run += 1
        self.prefill_tokens_computed += hi
        ps = self.view.page_size
        dev = self.device
        toks = torch.tensor([seq.tokens[:hi]], dtype=torch.int64, device=dev)
        x = self.model.embed(self.params, {"tokens": toks})
        pos = torch.arange(hi, device=dev)[None]
        _, _, caches = self.model.hidden(self.params, x, pos,
                                         want_cache=True)
        kv = caches[0]  # single dense group: {"k": [L,1,S,nkv,hd]} or list
        if isinstance(kv, list):
            k = torch.stack([c["k"][0] for c in kv])   # [L,S,nkv,hd]
            v = torch.stack([c["v"][0] for c in kv])
        else:
            k, v = kv["k"][:, 0], kv["v"][:, 0]
        positions = np.arange(lo, hi)
        pids = torch.tensor([seq.pages[p // ps] for p in positions],
                            dtype=torch.int64, device=dev)
        slots = torch.from_numpy(positions % ps).to(dev)
        # one scatter per pool tensor for the whole chunk
        self.view.k_pool[:, pids, slots] = k[:, lo:hi]
        self.view.v_pool[:, pids, slots] = v[:, lo:hi]
        seq.length = hi
        self._register_if_done(seq, hi)

    def _register_if_done(self, seq: Request, hi: int) -> None:
        """Final chunk just landed: only now may the prompt pages enter the
        prefix trie."""
        if hi >= seq.prefill_target:
            self.view.register_prefix(seq.tokens, seq.pages,
                                      seq.prefill_target)

    def step(self) -> dict:
        t0 = time.monotonic()
        plan = self.scheduler.schedule()
        self._run_prefills(plan.prefill_chunks)
        batch = plan.batch
        if not batch and not plan.prefill_chunks:
            self.scheduler.advance(plan.swap_seconds)
            return {"active": 0, "pending": len(self.scheduler.pending)}
        done: list[Request] = []
        produced_before = {s.sid: s.produced for s in batch}
        groups = plan.launch_groups
        if batch:
            drafts = self._draft(batch)
            if drafts is not None:
                # the verify path fuses the whole batch into one
                # prefill-mode launch; micro-batching applies to plain
                # greedy decode only
                groups = None
                self._verify_step(batch, drafts)
            else:
                self._greedy_step(batch, groups)
            self.decode_steps += 1
            for s in batch:
                if s.produced >= s.max_new:
                    done.append(s)

        wall = time.monotonic() - t0
        # latency signal = wall clock + analytic BWAP read time + swap
        # transfer time; the read set is every *physical* page the decode
        # batch gathered, billed once per launch
        read_pages = list(dict.fromkeys(
            p for s in batch for p in s.pages)) if batch else []
        launches = None
        if batch and groups is not None:
            # compute-follows-data: one Eq.-1 bill per launch — the step
            # stall is the max over per-launch bottlenecks
            launches = []
            for dom, grp in groups:
                rp = list(dict.fromkeys(p for s in grp for p in s.pages))
                launches.append(
                    (dom, rp,
                     max(self.view.expected_read_time(rp), 0.0)))
            sim = max(t for _, _, t in launches)
        elif batch:
            sim = max(self.view.expected_read_time(read_pages), 0.0)
        else:
            sim = 0.0
        dt = ((wall if self.wall_clock else 0.0) + sim + plan.swap_seconds
              + (self.sim_step_s if batch else 0.0))
        v0 = self.scheduler.now
        self.scheduler.advance(dt)
        # bytes-weighted heat: a partial tail page streams fewer bytes
        read_weights = self._page_read_weights(batch) if batch else {}
        obs = self.view.fabric.obs
        if obs is not None:
            # spans, heat touches and (with a probe) drift pairs, one per
            # launch in micro-batch mode
            obs.on_engine_step(self.view, plan, batch, read_pages,
                               sim, v0, dt, launches=launches,
                               read_weights=read_weights)
        for s in batch:
            if produced_before[s.sid] == 0 and s.produced > 0:
                self.scheduler.notice_first_token(s)
        for s in done:
            for cb in self._finish_cbs:
                cb(self, s)
            self.scheduler.finish(s)
        moved = False
        if batch:
            self.latencies.append(dt)
            # the DWP tuner judges *placement*: feed it the step latency
            # minus swap transfers
            if self.view.record_latency(dt - plan.swap_seconds):
                # the tuner moved the allocation cycle: re-home live
                # sequences (batched gather/scatter through the executor)
                for s in self.scheduler.running:
                    s.pages = self.view.migrate(s.pages)
                moved = True
        rehomed = 0
        if self.rehome and batch:
            rehomed = self._rehome_step(obs, read_pages, read_weights, sim)
        tel = self.view.snapshot()
        return {"active": len(self.scheduler.running),
                "latency": dt, "migrated": moved, "rehomed": rehomed,
                "launches": (len(groups) if groups is not None
                             else (1 if batch else 0)),
                "dwp": self.view.dwp,
                "occupancy": self.view.occupancy(),
                "swapped": len(self.scheduler.swapped),
                "swapped_out": len(plan.swapped_out),
                "swapped_in": len(plan.swapped_in),
                "pagetable": tel["pagetable"],
                "prefill_tokens_computed": self.prefill_tokens_computed,
                "decode_steps": self.decode_steps,
                "tokens_emitted": self.tokens_emitted,
                "spec": tel["spec"],
                "telemetry": tel}

    # -- decode: greedy single-token and speculative multi-token --------------

    def _draft(self, batch) -> list[list[int]] | None:
        """Each sequence's proposal, capped at the scheduler's reserved
        lookahead and the sequence's remaining allowance. None when there
        is nothing to verify — plain decode is cheaper than a 1-token
        verify launch."""
        if self.drafter is None:
            return None
        k = self.scheduler.spec_tokens
        drafts = []
        for s in batch:
            allowed = s.max_new - s.produced     # >= 1: finished seqs left
            d = self.drafter.draft(s.tokens)[:min(k, allowed - 1)] \
                if allowed > 1 else []
            drafts.append([int(t) for t in d])
        return drafts if any(drafts) else None

    def _greedy_step(self, batch, groups=None) -> None:
        ps = self.view.page_size
        # grow pages where needed over the FULL batch in global order (even
        # in micro-batch mode), so page ids match a single global launch; a
        # decode write into a shared page forks it
        if self.view.geometry.grows:
            for s in batch:
                if s.length % ps == 0:
                    self.view.append_page(s.pages)
                else:
                    self.view.fork_for_write(s.pages, s.length // ps)
        if groups is not None:
            # compute-follows-data: one launch per domain group; each row
            # reads only its own table and argmax is per row
            for _dom, grp in groups:
                self._decode_launch(grp)
        else:
            self._decode_launch(batch)
        self.tokens_emitted += len(batch)

    def _decode_launch(self, seqs) -> None:
        """One decode launch over ``seqs`` (the whole batch, or one
        per-domain micro-batch)."""
        mp = max(len(s.pages) for s in seqs)
        tables = np.zeros((len(seqs), mp), np.int32)
        for i, s in enumerate(seqs):
            tables[i, :len(s.pages)] = s.pages
        lens = np.asarray([s.length for s in seqs], np.int64)
        toks = np.asarray([[s.tokens[-1]] for s in seqs], np.int64)
        d = self.decoder
        logits = d.decode_step(d._t(toks), d._t(tables, torch.int32),
                               d._t(lens, torch.int32), d._t(lens))
        nxt = logits.argmax(dim=-1).cpu().numpy()
        for s, t in zip(seqs, nxt):
            s.tokens.append(int(t))
            s.length += 1          # the decoded token's K/V is now pooled

    # -- compute-follows-data: heat + re-homing -------------------------------

    def _page_read_weights(self, batch) -> dict[int, float]:
        """Fraction of each physical page this step's gather streamed:
        interior pages in full, a sequence's tail page up to its committed
        length. A page that is one holder's tail and another's interior
        counts as a full read."""
        ps = self.view.page_size
        out: dict[int, float] = {}
        for s in batch:
            for i, p in enumerate(s.pages):
                if p < 0:
                    continue
                frac = min(1.0, max(0.0, (s.length - i * ps) / ps))
                if frac > out.get(p, 0.0):
                    out[p] = frac
        return out

    def _own_heat(self):
        """Private heat map for re-homing when no observatory (or a
        heatless one) is attached."""
        if self._heat is None:
            heat = PageHeat(self.view.pool)
            self.view.fabric.subscribe(
                "free", lambda page=-1, **_: heat.on_free(page=page))
            self._heat = heat
        return self._heat

    def _rehome_step(self, obs, read_pages, read_weights, sim) -> int:
        """Pull the hottest shared slow-domain pages into fast domains,
        spending at most ``rehome_budget_frac`` of this step's Eq.-1 stall.
        The spent seconds advance the virtual clock."""
        if obs is not None and obs.heat is not None:
            heat = obs.heat          # the observatory already touched it
        else:
            heat = self._own_heat()
            heat.touch(read_pages,
                       weights=[read_weights.get(p, 1.0)
                                for p in read_pages])
            heat.step()
        budget = self.rehome_budget_frac * sim
        if budget <= 0.0:
            return 0
        moves, secs = self.view.rehome_hot(heat, budget_s=budget)
        if not moves:
            return 0
        v0 = self.scheduler.now
        self.scheduler.advance(secs)
        self.rehomed_pages += len(moves)
        if obs is not None:
            obs.on_rehome(self.view, v0, secs, len(moves))
        return len(moves)

    def _verify_step(self, batch, drafts) -> None:
        """Speculative multi-token decode. Per sequence the chunk
        ``[tokens[-1], draft...]`` writes K/V at positions
        ``[length, length + d]`` and runs through one batched prefill-mode
        attention launch; the longest draft prefix the model's own argmax
        confirms is accepted, plus one bonus token, so outputs are
        token-identical to greedy decoding.

        Rejected speculation rolls back exactly: snapshotted K/V bytes are
        scattered back, pages greedy would not yet hold return to the
        allocator LIFO with the allocation cycle rewound, in reverse batch
        order (the step's allocations form one stack)."""
        ps = self.view.page_size
        dev = self.device
        recs = []                       # per seq: (appended allocs, snap base)
        chunks = []
        snap_pids: list[int] = []
        snap_slots: list[int] = []
        for s, d in zip(batch, drafts):
            lo = s.length
            if lo % ps:
                self.view.fork_for_write(s.pages, lo // ps)
            appended = []               # (pid, marker_before, marker_after)
            while len(s.pages) * ps <= lo + len(d):
                m0 = self.view.alloc_marker()
                pid = self.view.append_page(s.pages)
                appended.append((pid, m0, self.view.alloc_marker()))
            base = len(snap_pids)
            for p in range(lo + 1, lo + len(d) + 1):   # speculative slots
                snap_pids.append(int(s.pages[p // ps]))
                snap_slots.append(p % ps)
            recs.append((appended, base))
            chunks.append(([s.tokens[-1]] + d, s.pages, lo))
        snap_k = snap_v = None
        if snap_pids:
            # pre-write bytes of every speculative slot, all layers at once;
            # advanced indexing copies, so the in-place writes below leave
            # the snapshot intact
            sp = torch.tensor(snap_pids, dtype=torch.int64, device=dev)
            ss = torch.tensor(snap_slots, dtype=torch.int64, device=dev)
            snap_k = self.view.k_pool[:, sp, ss]
            snap_v = self.view.v_pool[:, sp, ss]
        logits = self.decoder.forward_chunks(chunks, want_logits=True)
        nxt = logits.argmax(dim=-1).cpu().numpy()          # [B,T]
        drafted = accepted = emitted = 0
        rest_idx: list[int] = []        # snapshot rows to scatter back
        rest_pids: list[int] = []
        rest_slots: list[int] = []
        for i, (s, d) in enumerate(zip(batch, drafts)):
            lo = s.length
            allowed = s.max_new - s.produced
            a = 0
            while a < len(d) and a + 1 < allowed and int(nxt[i, a]) == d[a]:
                a += 1
            emit = a + 1                # accepted drafts + the bonus token
            s.tokens.extend(int(nxt[i, j]) for j in range(emit))
            s.length = lo + emit        # committed K/V: positions lo..lo+a
            drafted += len(d)
            accepted += a
            emitted += emit
            appended, base = recs[i]
            for j in range(emit, len(d) + 1):   # rejected: lo+emit..lo+d
                rest_idx.append(base + j - 1)
                rest_pids.append(snap_pids[base + j - 1])
                rest_slots.append(snap_slots[base + j - 1])
        # unwind rejected page allocations strictly right-to-left
        for s, (appended, _) in zip(reversed(batch), reversed(recs)):
            keep = -(-s.length // ps)   # pages greedy would hold right now
            while len(s.pages) > keep:
                pid, m0, m1 = appended.pop()
                popped = self.view.pop_page(s.pages)
                assert popped == pid, "speculative page stack out of order"
                self.view.undo_alloc(pid, m0, m1)
        if rest_idx:
            idx = torch.tensor(rest_idx, dtype=torch.int64, device=dev)
            rp = torch.tensor(rest_pids, dtype=torch.int64, device=dev)
            rs = torch.tensor(rest_slots, dtype=torch.int64, device=dev)
            self.view.k_pool[:, rp, rs] = snap_k[:, idx]
            self.view.v_pool[:, rp, rs] = snap_v[:, idx]
        self.tokens_emitted += emitted
        self.view.telemetry.record_spec(drafted, accepted, emitted)
