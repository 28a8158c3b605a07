"""``tests/test_spec_decode.py``'s cases on both packages: the prompt-lookup
drafter, token identity of speculative and greedy decoding (one sequence,
a batch, ``max_new``), exact rollback of rejected speculation (the pool's
bytes, free lists, refcounts, trie and allocation cycle left where greedy
leaves them; every draft rejected across two sequences), the Eq.-1 read
set (finishing sequences billed, shared pages once), request identity, the
scheduler's speculative accounting, and fused prefill against the
recompute oracle.

Each case runs the reference's assertions on each package. Within a
package they compare greedy and speculative runs bit for bit, as the
reference does (``_state``). Between the packages the records (tokens,
page ids, free lists, refcounts, trie nodes, the cycle, counters) must be
equal, and the K/V bytes within 2e-5 (``both_close``: the two packages'
fp32 arithmetic rounds differently). Engines run the one-layer fp32 smoke
qwen2. The rollback property keeps the reference's ``max_examples`` and
runs derandomized, with no example database; each package's greedy oracle
is run once and reused, as every example draws the same one."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from _torch_parity import (BOTH, both, both_close, smoke_pair,  # noqa: E402
                          table_state)
from repro.configs import registry  # noqa: E402

CFG = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                          num_layers=1, compute_dtype="float32")
LOOP_PROMPT = [5, 9, 3, 5, 9, 3, 5, 9, 3, 7]
_SMOKE: dict = {}


@pytest.fixture(scope="module")
def smoke():
    if not _SMOKE:
        _SMOKE.update(smoke_pair())
    return _SMOKE


def _pool(pkg, fast=32, peer=16, host=16, page_size=4, cfg=CFG):
    return pkg.pool(cfg, (("hbm_local", fast, 819.0, True),
                          ("hbm_peer", peer, 50.0, False),
                          ("host", host, 16.0, False)),
                    page_size=page_size)


def _drain(eng, cap=500):
    steps = 0
    while (eng.active or eng.waiting) and steps < cap:
        eng.step()
        steps += 1
    assert not eng.active and not eng.waiting, "engine did not drain"


def _state(pkg, pool):
    """Everything speculative rollback must leave bit-identical to greedy
    (``test_spec_decode.py``'s ``_state``): K/V bits, free lists,
    refcounts, trie nodes, the allocation cycle."""
    k, v = pkg.kv(pool, range(pool.total_pages))
    t = table_state(pool)
    return k, v, t["free"], t["ref"], t["trie"], t["cycle"]


def _assert_states_equal(a, b):
    ak, av, afree, aref, atrie, acyc = a
    bk, bv, bfree, bref, btrie, bcyc = b
    assert np.array_equal(ak, bk), "k_pool bytes differ from greedy"
    assert np.array_equal(av, bv), "v_pool bytes differ from greedy"
    assert afree == bfree, "free lists differ from greedy"
    assert aref == bref, "refcounts differ from greedy"
    assert atrie == btrie, "trie nodes differ from greedy"
    assert acyc == bcyc, "allocation cycle position differs from greedy"


def _split(state):
    """(exact part, K/V arrays) of a ``_state``."""
    return state[2:], [np.asarray(state[0], np.float32),
                       np.asarray(state[1], np.float32)]


def _run_engine(pkg, smoke, drafter, prompts, max_new=12, max_batch=4):
    cfg, params = smoke[pkg.port]
    pool = _pool(pkg)
    eng = pkg.engine(cfg, params, pool, max_batch=max_batch,
                     max_new=max_new, wall_clock=False, sim_step_s=0.001,
                     drafter=drafter)
    for p in prompts:
        eng.submit(list(p))
    _drain(eng)
    eng.view.fabric.check_invariants()
    return eng, pool


def _tokens(eng) -> dict:
    return {s.sid: list(s.tokens) for s in eng.finished}


_GREEDY: dict = {}


def _greedy(pkg, smoke, prompts, max_new):
    """The greedy run of ``prompts`` on one package, made once:
    ``(tokens, decode steps, _state)``."""
    key = (pkg.port, tuple(map(tuple, prompts)), max_new)
    if key not in _GREEDY:
        eng, pool = _run_engine(pkg, smoke, None, prompts, max_new=max_new)
        _GREEDY[key] = (_tokens(eng), eng.decode_steps, _state(pkg, pool))
    return _GREEDY[key]


# ---------------------------------------------------------------------------
# drafter
# ---------------------------------------------------------------------------

def test_drafter_unrolls_runs_and_cycles():
    def case(pkg):
        d = pkg.spec.PromptLookupDrafter(max_tokens=4, max_ngram=3)
        out = [d.draft([7, 7, 7]), d.draft([1, 2, 3, 1, 2, 3]),
               d.draft([1, 2, 3, 4, 5]), d.draft([9])]
        assert out == [[7, 7, 7, 7], [1, 2, 3, 1], [], []]
        toks = [4, 1, 4, 1, 4]
        assert d.draft(toks) == d.draft(list(toks))
        return out, d.draft(toks)
    both(case)


def test_drafter_prefers_longest_ngram():
    def case(pkg):
        d = pkg.spec.PromptLookupDrafter(max_tokens=2, max_ngram=2)
        assert d.draft([1, 2, 5, 9, 1, 2]) == [5, 9]
        return d.draft([1, 2, 5, 9, 1, 2])
    both(case)


# ---------------------------------------------------------------------------
# token identity + exact rollback vs greedy
# ---------------------------------------------------------------------------

def test_spec_token_identical_and_fewer_steps(smoke):
    def case(pkg):
        g_tok, g_steps, _ = _greedy(pkg, smoke, [LOOP_PROMPT], 16)
        s_eng, s_pool = _run_engine(pkg, smoke,
                                    pkg.spec.PromptLookupDrafter(
                                        max_tokens=4),
                                    [LOOP_PROMPT], max_new=16)
        assert g_tok == _tokens(s_eng)
        assert s_eng.decode_steps < g_steps
        sp = s_pool.telemetry.snapshot()["spec"]
        assert sp["accepted"] > 0
        assert s_eng.tokens_emitted == 16
        assert sp["emitted"] == sp["accepted"] + sp["steps"]
        assert sp["emitted"] <= s_eng.tokens_emitted
        exact, kv = _split(_state(pkg, s_pool))
        return (g_tok, g_steps, s_eng.decode_steps, sp, exact), kv
    both_close(case)


def test_spec_batch_token_identical(smoke):
    def case(pkg):
        prompts = [LOOP_PROMPT, [2, 11, 2, 11, 2, 11, 4],
                   [17, 23, 31, 40, 8]]
        g_tok, g_steps, g_state = _greedy(pkg, smoke, prompts, 10)
        s_eng, s_pool = _run_engine(pkg, smoke,
                                    pkg.spec.PromptLookupDrafter(
                                        max_tokens=3),
                                    prompts, max_new=10)
        assert g_tok == _tokens(s_eng)
        exact, kv = _split(_state(pkg, s_pool))
        return (g_tok, g_steps, s_eng.decode_steps, exact), kv
    both_close(case)


def test_spec_rollback_bit_identical_to_greedy(smoke):
    def case(pkg):
        _, _, g_state = _greedy(pkg, smoke, [LOOP_PROMPT], 16)
        _, s_pool = _run_engine(pkg, smoke,
                                pkg.spec.PromptLookupDrafter(max_tokens=4),
                                [LOOP_PROMPT], max_new=16)
        s_state = _state(pkg, s_pool)
        _assert_states_equal(s_state, g_state)
        return _split(s_state)
    both_close(case)


class ScriptedDrafter:
    """Proposes ``good`` greedy-consistent tokens then ``bad`` wrong ones,
    per call, from a fixed plan (``test_spec_decode.py``'s)."""

    def __init__(self, oracle, vocab, plan, max_tokens=6):
        self.oracle = list(oracle)
        self.vocab = vocab
        self.plan = list(plan)
        self.calls = 0
        self.max_tokens = max_tokens

    def draft(self, tokens):
        good, bad = self.plan[self.calls % len(self.plan)]
        self.calls += 1
        pos = len(tokens)
        assert self.oracle[:pos] == list(tokens), \
            "speculative run diverged from the greedy oracle"
        out = self.oracle[pos:pos + good]
        good = len(out)
        for i in range(bad):
            true = self.oracle[pos + good + i] \
                if pos + good + i < len(self.oracle) else 0
            out.append((true + 7) % self.vocab or 1)
        return out[:self.max_tokens]


def _rollback(pkg, plan):
    g_tok, _, g_state = _greedy(pkg, _SMOKE, [LOOP_PROMPT], 12)
    oracle = g_tok[0]
    drafter = ScriptedDrafter(oracle, CFG.vocab_size, plan)
    s_eng, s_pool = _run_engine(pkg, _SMOKE, drafter, [LOOP_PROMPT],
                                max_new=12)
    assert s_eng.finished[0].tokens == oracle
    s_state = _state(pkg, s_pool)
    _assert_states_equal(s_state, g_state)
    exact, kv = _split(s_state)
    return (exact, drafter.calls,
            s_pool.telemetry.snapshot()["spec"]), kv


@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 2)),
                min_size=1, max_size=8))
@settings(max_examples=10, deadline=None, derandomize=True, database=None)
def test_spec_rollback_property(plan):
    if not _SMOKE:
        _SMOKE.update(smoke_pair())
    both_close(_rollback, plan)


class AlwaysWrongDrafter:
    """Proposes tokens that never match the model's argmax: every draft
    rejects, so every lookahead allocation must roll back."""

    max_tokens = 6

    def __init__(self, vocab):
        self.vocab = vocab

    def draft(self, tokens):
        return [self.vocab - 1] * self.max_tokens \
            if tokens[-1] != self.vocab - 1 else [1] * self.max_tokens


def test_spec_multiseq_all_rejected_restores_allocator(smoke):
    def case(pkg):
        cfg, params = smoke[pkg.port]
        prompts = [[5, 9, 3, 5, 9, 3, 7], [2, 11, 2, 11, 2, 11]]

        def mk(drafter):
            pool = _pool(pkg)
            eng = pkg.engine(cfg, params, pool, max_batch=4, max_new=8,
                             wall_clock=False, sim_step_s=0.001,
                             drafter=drafter)
            for p in prompts:
                eng.submit(list(p))
            while len(eng.scheduler.running) < 2:
                eng.step()
            return eng, pool

        g_eng, g_pool = mk(None)
        s_eng, s_pool = mk(AlwaysWrongDrafter(CFG.vocab_size))
        _assert_states_equal(_state(pkg, s_pool), _state(pkg, g_pool))
        trail, kvs = [], []
        for _ in range(2):
            g_eng.step()
            s_eng.step()
            assert [s.tokens for s in g_eng.scheduler.running] == \
                [s.tokens for s in s_eng.scheduler.running]
            s_state = _state(pkg, s_pool)
            _assert_states_equal(s_state, _state(pkg, g_pool))
            exact, kv = _split(s_state)
            trail.append(([list(s.tokens) for s in s_eng.scheduler.running],
                          [list(s.pages) for s in s_eng.scheduler.running],
                          exact))
            kvs += kv
        sp = s_pool.telemetry.snapshot()["spec"]
        assert sp["drafted"] > 0 and sp["accepted"] == 0
        return (trail, sp), kvs
    both_close(case)


def test_spec_multiseq_token_identical_and_leak_free(smoke):
    def case(pkg):
        prompts = [LOOP_PROMPT, [2, 11, 2, 11, 2, 11, 4], [8, 8, 8, 8, 8]]
        g_tok, _, _ = _greedy(pkg, smoke, prompts, 10)
        s_eng, s_pool = _run_engine(pkg, smoke,
                                    pkg.spec.PromptLookupDrafter(
                                        max_tokens=4),
                                    prompts, max_new=10)
        assert g_tok == _tokens(s_eng)
        sp = s_pool.telemetry.snapshot()["spec"]
        assert sp["accepted"] > 0
        assert sum(len(f) for f in s_pool.free) == s_pool.total_pages
        assert not s_pool.table.ref
        exact, kv = _split(_state(pkg, s_pool))
        return (g_tok, sp, exact), kv
    both_close(case)


def test_spec_respects_max_new(smoke):
    def case(pkg):
        g_tok, _, _ = _greedy(pkg, smoke, [LOOP_PROMPT], 3)
        s_eng, _ = _run_engine(pkg, smoke,
                               pkg.spec.PromptLookupDrafter(max_tokens=6),
                               [LOOP_PROMPT], max_new=3)
        assert s_eng.finished[0].produced == 3
        assert g_tok == _tokens(s_eng)
        return g_tok
    both(case)


# ---------------------------------------------------------------------------
# Eq.-1 latency-signal regression tests
# ---------------------------------------------------------------------------

def _billing_engine(pkg, smoke, **kw):
    cfg, params = smoke[pkg.port]
    pool = _pool(pkg)
    eng = pkg.engine(cfg, params, pool, wall_clock=False, sim_step_s=0.001,
                     **kw)
    seen = []
    orig = eng.view.expected_read_time
    eng.view.expected_read_time = lambda pages: (seen.append(list(pages)),
                                                 orig(pages))[1]
    return eng, pool, seen


def test_eq1_read_set_includes_finishing_sequences(smoke):
    def case(pkg):
        eng, _, seen = _billing_engine(pkg, smoke, max_batch=1, max_new=1)
        eng.submit([3, 17, 29, 5, 8])
        _drain(eng)
        assert len(eng.finished) == 1
        decode_reads = [p for p in seen if p]
        assert decode_reads, "finishing step billed no pages"
        assert len(decode_reads[-1]) == 2
        return seen, eng.scheduler.now, _tokens(eng)
    both(case)


def test_eq1_read_set_dedups_shared_pages(smoke):
    def case(pkg):
        eng, pool, seen = _billing_engine(pkg, smoke, max_batch=2,
                                          max_new=4)
        prompt = [3, 17, 29, 5, 8, 2, 40, 11, 9]
        eng.submit(list(prompt))
        eng.step()
        eng.submit(list(prompt))
        shared_seen = False
        for _ in range(30):
            if not (eng.active or eng.waiting):
                break
            pair = len(eng.scheduler.running) == 2
            eng.step()
            if pair and seen and seen[-1]:
                reads = seen[-1]
                assert len(reads) == len(set(reads)), \
                    "shared trie pages double-billed in bytes_per_domain"
                shared_seen = True
        assert shared_seen
        assert pool.table.prefix_hit_pages >= 2
        return seen, pool.table.prefix_hit_pages, eng.scheduler.now, \
            _tokens(eng)
    both(case)


def test_request_equality_is_identity():
    def case(pkg):
        Request = pkg.sched.Request
        a = Request(sid=0, tokens=[1, 2], pages=[])
        b = Request(sid=0, tokens=[1, 2], pages=[])
        assert a != b and a == a
        assert a in [a] and a not in [b]
        assert len({a, b}) == 2
        return a == b, len({a, b})
    both(case)


# ---------------------------------------------------------------------------
# scheduler speculative accounting
# ---------------------------------------------------------------------------

def test_scheduler_spec_growth_need():
    def case(pkg):
        pool = _pool(pkg)
        sched = pkg.sched.RequestScheduler(pool, spec_tokens=4)
        sched0 = pkg.sched.RequestScheduler(pool)
        got = [sched._seq_growth(8, [0, 1]), sched._seq_growth(6, [0, 1]),
               sched0._seq_growth(8, [0, 1]), sched0._seq_growth(6, [0, 1])]
        assert got == [2, 1, 1, 0]
        return got
    both(case)


def test_scheduler_spec_budget_charges_verify_tokens():
    def case(pkg):
        def first_chunk(spec_tokens):
            pool = pkg.pool(CFG, (("hbm_local", 64, 819.0, True),
                                  ("host", 32, 16.0, False)), page_size=4)
            sched = pkg.sched.RequestScheduler(
                pool, max_batch=4, prefill_token_budget=16,
                default_max_new=4, spec_tokens=spec_tokens)
            sched.submit(list(range(1, 6)))
            plan = sched.schedule()
            for r, lo, hi in plan.prefill_chunks:
                r.length = hi
            assert len(sched.running) == 1
            sched.submit(list(range(1, 40)))
            plan = sched.schedule()
            return sum(hi - lo for _, lo, hi in plan.prefill_chunks)

        got = first_chunk(0), first_chunk(4)
        assert got == (16, 16 - 5)
        return got
    both(case)


def test_scheduler_spec_footprint_margin():
    def case(pkg):
        pool = _pool(pkg, fast=2, peer=2, host=2)
        sched = pkg.sched.RequestScheduler(pool, spec_tokens=0,
                                           default_max_new=4)
        sid = sched.submit(list(range(1, 22)))
        spec = pkg.sched.RequestScheduler(pool, spec_tokens=4,
                                          default_max_new=4)
        with pytest.raises(ValueError) as e:
            spec.submit(list(range(1, 22)))
        return sid, str(e.value)
    both(case)


# ---------------------------------------------------------------------------
# fused (batched) incremental prefill
# ---------------------------------------------------------------------------

def test_fused_prefill_matches_recompute_oracle(smoke):
    def case(pkg):
        cfg, params = smoke[pkg.port]
        rng = np.random.default_rng(3)
        prompts = [rng.integers(1, CFG.vocab_size, n).tolist()
                   for n in (19, 11, 7)]

        def run(incremental):
            pool = _pool(pkg, fast=64, peer=32, host=32)
            eng = pkg.engine(cfg, params, pool, max_batch=3, max_new=4,
                             wall_clock=False, sim_step_s=0.001,
                             incremental_prefill=incremental)
            eng.scheduler.prefill_token_budget = 8
            for p in prompts:
                eng.submit(list(p))
            _drain(eng)
            assert eng.prefill_chunks_run > len(prompts)
            return (_tokens(eng), eng.prefill_chunks_run,
                    eng.prefill_tokens_computed), \
                [pkg.host(pool.k_pool), pkg.host(pool.v_pool)]

        (fused, kv_f), (rec, kv_r) = run(True), run(False)
        assert fused[0] == rec[0]
        return (fused, rec), kv_f + kv_r
    both_close(case)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_chunk_writes_decode_bits(dtype):
    """The port's decoder on the plain path, two layers: one verify chunk
    of T tokens writes the K/V bits, and gives the logits, that T decode
    steps give at the same positions (``PagedDecoder._mm``: every weight
    product row by row). A plain ``@`` there rounds by row count and broke
    ``test_spec_rollback_bit_identical_to_greedy`` on the port."""
    import torch

    from repro_torch.models.lm import LM
    from repro_torch.serve.engine import PagedDecoder

    port = BOTH[1]
    ref_cfg = dataclasses.replace(CFG, num_layers=2, compute_dtype=dtype)
    cfg = port.cfg(ref_cfg)
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(1, CFG.vocab_size, 11).tolist()
    lo, ps = 6, 4
    runs = []
    for verify in (True, False):
        pool = _pool(port, cfg=ref_cfg)
        dec = PagedDecoder(cfg, params, pool)
        pages = list(range(3))
        dec.forward_chunks([(toks[:lo], pages, 0)])
        if verify:
            logits = dec.forward_chunks([(toks[lo:], pages, lo)],
                                        want_logits=True)[0]
        else:
            tbl = torch.tensor([pages], dtype=torch.int32)
            logits = torch.cat([dec.decode_step(
                torch.tensor([[toks[p]]]), tbl,
                torch.tensor([p], dtype=torch.int32), torch.tensor([p]))
                for p in range(lo, len(toks))])
        runs.append((port.kv(pool, pages), logits))
    (kv_a, log_a), (kv_b, log_b) = runs
    assert np.array_equal(kv_a[0], kv_b[0]) and np.array_equal(kv_a[1],
                                                                kv_b[1])
    assert torch.equal(log_a, log_b)
