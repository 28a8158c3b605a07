"""``tests/test_pagetable.py``'s cases on both packages: the page table's
refcount lifecycle, trie chain keying, ``fork_for_write`` isolation, prefix
sharing and the CoW fork on a full prompt match in the engine, O(n)
incremental prefill against the recompute oracle, the prefill op against
the decode op per position, swap round trips that pin shared pages, an
oversubscribed shared prefix, and the random share/fork/swap property.

Each case runs the reference's assertions on each package and returns a
record (tokens, page ids, refcounts, trie nodes ``(parent, block, phys)``,
free lists, the allocation cycle, pool bits where the test wrote them)
that must be equal on both (``_torch_parity.both``). Where the model wrote
the K/V, the two packages' fp32 arithmetic rounds differently, so those
bytes are held within 2e-5 (``both_close``) and everything else exactly.
The engines run the one-layer fp32 smoke qwen2 on both sides
(``_torch_parity.smoke_pair``).

``test_prefill_kernel_matches_ref_interpret`` (the Pallas kernel in
interpret mode against its jnp oracle) is not ported: its port
counterpart is ``test_torch_paged_pallas.py::
test_prefill_single_plain_matches_pallas``. The property runs
derandomized, with no example database, at the reference's
``max_examples``."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax", reason="parity with the reference needs jax")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from _torch_parity import (both, both_close, smoke_pair,  # noqa: E402
                          table_state)
from repro.configs import registry  # noqa: E402
from repro.kernels.paged_attention import ref as r_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ref as t_ref  # noqa: E402

CFG = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                          num_layers=1, compute_dtype="float32")


@pytest.fixture(scope="module")
def smoke():
    return smoke_pair()


def _pool(pkg, fast=32, peer=16, host=16, page_size=4):
    return pkg.pool(CFG, (("hbm_local", fast, 819.0, True),
                          ("hbm_peer", peer, 0.05, False),
                          ("host", host, 0.016, False)),
                    page_size=page_size)


def _table_state(pool) -> dict:
    return table_state(pool) | {"stats": pool.table.stats()}


def _drain(eng, max_steps=500):
    steps = 0
    while (eng.active or eng.waiting) and steps < max_steps:
        eng.step()
        steps += 1
    return steps


# ---------------------------------------------------------------------------
# refcounts + trie
# ---------------------------------------------------------------------------

def test_refcount_lifecycle():
    def case(pkg):
        pool = _pool(pkg)
        t, ps, trail = pool.table, pool.page_size, []
        tokens = list(range(1, 1 + 3 * ps))
        donor: list = []
        t.grow(donor, 3)
        assert all(t.ref[p] == 1 for p in donor)
        t.register_prefix(tokens, donor, len(tokens))
        assert t.stats()["trie_nodes"] == 3
        trail.append(_table_state(pool))
        view: list = []
        assert t.match_prefix(tokens, view) == 3 * ps
        assert view == donor
        assert all(t.ref[p] == 2 for p in donor)
        assert t.exclusive(view) == []
        assert t.stats()["shared_pages"] == 3
        assert t.stats()["saved_pages"] == 3
        trail.append(_table_state(pool))
        free0 = pool.free_count()
        t.release(view)
        assert pool.free_count() == free0
        assert all(t.ref[p] == 1 for p in donor)
        t.release(donor)
        assert pool.free_count() == free0 + 3
        assert t.stats()["trie_nodes"] == 0
        assert t.ref == {}
        trail.append(_table_state(pool))
        return donor, trail
    both(case)


def test_trie_chain_keying_blocks_position_aliasing():
    def case(pkg):
        pool = _pool(pkg)
        t, ps = pool.table, pool.page_size
        blk_a, blk_b = list(range(10, 10 + ps)), list(range(50, 50 + ps))
        donor: list = []
        t.grow(donor, 2)
        t.register_prefix(blk_a + blk_b, donor, 2 * ps)
        hit: list = []
        got = [t.match_prefix(blk_a + blk_b, hit)]
        assert got[-1] == 2 * ps
        t.release(hit)
        partial: list = []
        got.append(t.match_prefix(blk_a + list(range(90, 90 + ps)),
                                  partial))
        assert got[-1] == ps
        t.release(partial)
        aliased: list = []
        got.append(t.match_prefix(blk_b + blk_a, aliased))
        assert got[-1] == 0
        assert t.stats()["prefix_misses"] >= 1
        state = _table_state(pool)
        t.release(donor)
        return got, hit, partial, aliased, state, _table_state(pool)
    both(case)


def test_fork_for_write_isolates_holders():
    def case(pkg):
        pool = _pool(pkg)
        t = pool.table
        a: list = []
        t.grow(a, 1)
        pkg.put(pool, [a[0]], 7.0)
        pkg.put(pool, [a[0]], -7.0, "v")
        tokens = list(range(1, 1 + pool.page_size))
        t.register_prefix(tokens, a, pool.page_size)
        b: list = []
        t.match_prefix(tokens, b)
        assert b == a
        pid = t.fork_for_write(b, 0)
        assert pid != a[0] and b[0] == pid
        assert t.ref[a[0]] == 1 and t.ref[pid] == 1
        assert t.cow_faults == 1
        k, v = pkg.kv(pool, [a[0], pid])
        assert (k == 7.0).all() and (v == -7.0).all()
        pkg.put(pool, [pid], 9.0)
        assert (pkg.host(pool.k_pool)[:, a[0]] == 7.0).all()
        assert t.fork_for_write(b, 0) == pid and t.cow_faults == 1
        state = _table_state(pool)
        t.release(a)
        t.release(b)
        assert pool.free_count() == pool.total_pages
        return a, b, pid, state, pkg.kv(pool, range(pool.total_pages))
    both(case)


# ---------------------------------------------------------------------------
# engine integration: sharing is invisible in tokens, visible in footprint
# ---------------------------------------------------------------------------

def _shared_prompts(vocab, ps, prefix_blocks=2, n=3, seed=0):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, prefix_blocks * ps).tolist()
    return [prefix + rng.integers(1, vocab, 3 + i).tolist()
            for i in range(n)]


def _run_engine(pkg, smoke, prompts, *, reuse, incremental=True,
                max_new=5, budget=64, arrivals=None):
    cfg, params = smoke[pkg.port]
    pool = _pool(pkg, fast=64, peer=16, host=16)
    sched = pkg.sched.RequestScheduler(pool, max_batch=8,
                                       prefill_token_budget=budget,
                                       default_max_new=max_new)
    eng = pkg.engine(cfg, params, pool, scheduler=sched, wall_clock=False,
                     sim_step_s=0.01, prefix_reuse=reuse,
                     incremental_prefill=incremental)
    for i, p in enumerate(prompts):
        eng.submit(list(p), arrival_s=arrivals[i] if arrivals else None)
    _drain(eng)
    assert len(eng.finished) == len(prompts)
    eng.view.fabric.check_invariants()
    return eng, pool


def _engine_record(pkg, eng, pool):
    """(exact record, K/V arrays) of a drained engine."""
    return ({"tokens": {s.sid: list(s.tokens) for s in eng.finished},
             "prefill": (eng.prefill_tokens_computed,
                         eng.prefill_chunks_run),
             "decode_steps": eng.decode_steps, "clock": eng.scheduler.now,
             "table": _table_state(pool)},
            [pkg.host(pool.k_pool), pkg.host(pool.v_pool)])


def test_prefix_sharing_saves_pages_tokens_identical(smoke):
    def case(pkg):
        prompts = _shared_prompts(CFG.vocab_size, ps=4)
        arrivals = [0.0, 0.02, 0.04]
        on, pool_on = _run_engine(pkg, smoke, prompts, reuse=True,
                                  arrivals=arrivals)
        off, pool_off = _run_engine(pkg, smoke, prompts, reuse=False,
                                    arrivals=arrivals)
        tok_on = {s.sid: s.tokens for s in on.finished}
        assert tok_on == {s.sid: s.tokens for s in off.finished}
        st_ = pool_on.table.stats()
        assert st_["prefix_hit_pages"] >= 2 * 2
        assert on.prefill_tokens_computed < off.prefill_tokens_computed
        assert pool_on.free_count() == pool_on.total_pages
        rec_on, kv_on = _engine_record(pkg, on, pool_on)
        rec_off, kv_off = _engine_record(pkg, off, pool_off)
        return (rec_on, rec_off), kv_on + kv_off
    both_close(case)


def test_cow_fork_on_full_prompt_match_is_exact(smoke):
    def case(pkg):
        ps, vocab = 4, CFG.vocab_size
        rng = np.random.default_rng(3)
        prefix = rng.integers(1, vocab, 3 * ps).tolist()
        donor = prefix + rng.integers(1, vocab, 5).tolist()
        matcher = list(prefix)
        base, base_pool = _run_engine(pkg, smoke, [matcher], reuse=False)
        eng, pool = _run_engine(pkg, smoke, [donor, matcher], reuse=True,
                                arrivals=[0.0, 0.015])
        assert pool.table.cow_faults >= 1
        got = next(s for s in eng.finished if s.prompt_len == len(matcher))
        want = base.finished[0]
        assert got.tokens[got.prompt_len:] == want.tokens[want.prompt_len:]
        assert pool.free_count() == pool.total_pages
        rec, kv = _engine_record(pkg, eng, pool)
        rec_b, kv_b = _engine_record(pkg, base, base_pool)
        return (rec, rec_b, pool.table.cow_faults), kv + kv_b
    both_close(case)


# ---------------------------------------------------------------------------
# incremental chunked prefill: O(n) compute, token-exact vs recompute
# ---------------------------------------------------------------------------

def test_incremental_prefill_is_o_n_and_token_exact(smoke):
    def case(pkg):
        rng = np.random.default_rng(1)
        prompts = [rng.integers(1, CFG.vocab_size, n).tolist()
                   for n in (23, 17, 9)]
        targets = sum(len(p) - 1 for p in prompts)
        inc, pool_i = _run_engine(pkg, smoke, prompts, reuse=False,
                                  incremental=True, budget=6)
        rec, pool_r = _run_engine(pkg, smoke, prompts, reuse=False,
                                  incremental=False, budget=6)
        assert {s.sid: s.tokens for s in inc.finished} \
            == {s.sid: s.tokens for s in rec.finished}
        assert inc.prefill_tokens_computed == targets
        assert rec.prefill_tokens_computed > targets
        assert inc.prefill_chunks_run > len(prompts)
        r_i, kv_i = _engine_record(pkg, inc, pool_i)
        r_r, kv_r = _engine_record(pkg, rec, pool_r)
        return (r_i, r_r), kv_i + kv_r
    both_close(case)


# ---------------------------------------------------------------------------
# prefill-mode paged attention op
# ---------------------------------------------------------------------------

def test_prefill_op_matches_decode_op_per_position():
    """The prefill-mode op at chunk [lo, hi) agrees with the decode op
    queried position by position (lens = pos + 1) over the same pool, on
    each package, and the packages agree."""
    ps, pages, nkv, g, h, t, lo = 4, 8, 2, 2, 16, 5, 6
    rng = np.random.default_rng(0)
    kp = rng.standard_normal((pages, ps, nkv, h)).astype(np.float32)
    vp = rng.standard_normal((pages, ps, nkv, h)).astype(np.float32)
    q = rng.standard_normal((t, nkv * g, h)).astype(np.float32)
    tbl = np.asarray([3, 1, 4], np.int32)
    lens = (lo + 1 + np.arange(t)).astype(np.int32)

    def case(pkg):
        if pkg.port:
            m, arr = t_ref, torch.from_numpy
        else:
            m, arr = r_ref, jnp.asarray
        out = pkg.host(m.paged_prefill_attention_ref(
            arr(q), arr(kp), arr(vp), arr(tbl), lo))
        per_pos = pkg.host(m.paged_attention_ref(
            arr(q), arr(kp), arr(vp), arr(np.broadcast_to(tbl, (t, 3)).copy()),
            arr(lens)))
        np.testing.assert_allclose(out, per_pos, rtol=1e-6, atol=1e-6)
        return (), [out, per_pos]
    both_close(case, atol=1e-6)


# ---------------------------------------------------------------------------
# swap x sharing: shared pages pin, exclusive pages park
# ---------------------------------------------------------------------------

def test_swap_roundtrip_pins_shared_pages():
    def case(pkg):
        pool = _pool(pkg, fast=8, peer=12, host=12)
        t, ps = pool.table, pool.page_size
        swap = pkg.KVSwapManager(pool, reserve_fraction=0.8)
        tokens = list(range(1, 1 + 2 * ps))
        donor: list = []
        t.grow(donor, 2)
        for i, p in enumerate(donor):
            pkg.put(pool, [p], float(i + 1))
        t.register_prefix(tokens, donor, 2 * ps)
        victim: list = []
        t.match_prefix(tokens, victim)
        t.grow(victim, 2)
        for i in (2, 3):
            pkg.put(pool, [victim[i]], float(10 + i))
        shared_before = victim[:2]
        out_pages, secs_out = swap.swap_out(list(victim), table=t)
        assert out_pages[:2] == shared_before
        assert out_pages[2] != victim[2] and out_pages[3] != victim[3]
        assert swap.parked_count(out_pages) == 2
        for i, p in enumerate(out_pages):
            assert t.ref[p] == (2 if i < 2 else 1)
        k = pkg.host(pool.k_pool)
        assert (k[:, out_pages[2]] == 12.0).all()
        parked = _table_state(pool)
        back, secs_in = swap.swap_in(out_pages, table=t)
        assert back[:2] == shared_before
        assert swap.parked_count(back) == 0
        assert swap.slots_free() == swap.reserved_total
        k = pkg.host(pool.k_pool)
        assert (k[:, back[2]] == 12.0).all()
        assert (k[:, back[3]] == 13.0).all()
        assert (k[:, back[0]] == 1.0).all()
        t.release(back)
        t.release(donor)
        assert pool.free_count() + swap.reserved_total == pool.total_pages
        return (victim, out_pages, back, secs_out, secs_in, parked,
                _table_state(pool), pkg.kv(pool, range(pool.total_pages)))
    both(case)


def test_oversubscribed_shared_prefix_completes(smoke):
    def case(pkg):
        cfg, params = smoke[pkg.port]
        ps = 4
        rng = np.random.default_rng(5)
        prefix = rng.integers(1, CFG.vocab_size, 3 * ps).tolist()
        prompts = [prefix + rng.integers(1, CFG.vocab_size, 2 + i).tolist()
                   for i in range(5)]
        arrivals = [0.0] + [0.05 + 0.01 * i for i in range(4)]

        def run(fast, peer, host, swap_on):
            pool = _pool(pkg, fast=fast, peer=peer, host=host)
            swap = pkg.KVSwapManager(pool, reserve_fraction=0.9) \
                if swap_on else None
            sched = pkg.sched.RequestScheduler(
                pool, max_batch=4, prefill_token_budget=24,
                default_max_new=12, swap=swap)
            eng = pkg.engine(cfg, params, pool, scheduler=sched,
                             wall_clock=False, sim_step_s=0.01)
            for p, a in zip(prompts, arrivals):
                eng.submit(list(p), arrival_s=a)
            _drain(eng)
            assert len(eng.finished) == len(prompts)
            eng.view.fabric.check_invariants()
            rec, kv = _engine_record(pkg, eng, pool)
            return ({s.sid: s.tokens for s in eng.finished},
                    pool.telemetry.swap_outs, pool.table.prefix_hit_pages,
                    rec, kv)

        ref = run(64, 16, 16, swap_on=False)
        got = run(8, 10, 22, swap_on=True)
        assert got[1] > 0 and got[2] > 0
        assert got[0] == ref[0]
        return (ref[:4], got[:4]), ref[4] + got[4]
    both_close(case)


# ---------------------------------------------------------------------------
# property test: random share/fork/swap/free interleavings
# ---------------------------------------------------------------------------

def _share_fork_swap(pkg, ops, seed):
    """The reference property's body on one package; returns the page
    lists and contents after every op and the final table state."""
    pool = _pool(pkg, fast=10, peer=12, host=14)
    t, ps = pool.table, pool.page_size
    swap = pkg.KVSwapManager(pool, reserve_fraction=0.7)
    rng = np.random.default_rng(seed)
    streams = [[int(x) for x in rng.integers(1, 10 ** 6, 2 * ps)]
               for _ in range(3)]
    views: list[dict] = []
    next_fill = [1.0]
    trail = []

    def k_at(pid):
        return float(pkg.host(pool.k_pool[0, pid, 0, 0, 0]))

    def new_view():
        n = int(rng.integers(1, 3))
        tokens = streams[int(rng.integers(len(streams)))][:n * ps]
        pages: list = []
        matched = t.match_prefix(tokens, pages) // ps
        content = [None] * n
        for b in range(matched, n):
            t.append_page(pages)
            v = next_fill[0]
            next_fill[0] += 1.0
            pkg.put(pool, [pages[b]], v)
            content[b] = v
        for b in range(matched):
            content[b] = k_at(pages[b])
        t.register_prefix(tokens, pages, n * ps)
        views.append({"pages": pages, "content": content, "parked": False})

    for op, which in ops:
        if op == 0 or not views:
            if pool.free_count() >= 3:
                new_view()
            trail.append([(list(s["pages"]), s["parked"]) for s in views])
            continue
        s = views[which % len(views)]
        if op == 1 and not s["parked"]:
            idx = int(rng.integers(len(s["pages"])))
            if pool.free_count() < 1:
                continue
            t.fork_for_write(s["pages"], idx)
            v = next_fill[0]
            next_fill[0] += 1.0
            pkg.put(pool, [s["pages"][idx]], v)
            s["content"][idx] = v
        elif op == 2:
            if s["parked"]:
                if pool.free_count() >= swap.parked_count(s["pages"]):
                    s["pages"], _ = swap.swap_in(s["pages"], table=t)
                    s["parked"] = False
            else:
                excl = len(t.exclusive(s["pages"]))
                if swap.can_swap_out(excl):
                    s["pages"], _ = swap.swap_out(s["pages"], table=t)
                    s["parked"] = True
        elif op == 3 and not s["parked"]:
            t.release(s["pages"])
            views.remove(s)
        trail.append([(list(s["pages"]), s["parked"]) for s in views])

    holder_counts: dict[int, int] = {}
    for s in views:
        for pid, val in zip(s["pages"], s["content"]):
            holder_counts[pid] = holder_counts.get(pid, 0) + 1
            assert k_at(pid) == val, f"page {pid}: {k_at(pid)} != {val}"
    for pid, n in holder_counts.items():
        assert t.ref[pid] == n
    assert sum(t.ref.values()) == sum(len(s["pages"]) for s in views)
    parked = sum(swap.parked_count(s["pages"]) for s in views)
    assert pool.free_count() + swap.reserved_total + len(t.ref) - parked \
        == pool.total_pages
    return trail, [s["content"] for s in views], _table_state(pool)


@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 5)),
                min_size=1, max_size=24),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
@settings(max_examples=15, deadline=None, derandomize=True, database=None)
def test_random_share_fork_swap_interleavings(ops, seed):
    both(_share_fork_swap, ops, seed)
