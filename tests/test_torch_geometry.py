"""``tests/test_geometry.py``'s cases on both packages: the page-geometry
protocol (paged K/V, the MLA latent, the one-page SSM state, the read-only
encoder K/V), the pool and page table it induces, and the ``PageFabricZoo``
byte ledger and capacity market (``repro_torch.placement.zoo`` against
``repro.placement.zoo``). Each case runs on the reference and on the port
(``_torch_parity.both``) and returns a record that must be equal: page
ids, quotas, funded and free bytes, lease books, pool bits. The two shim
cases are not ported (``serve/kvcache.py`` and ``serve/pagetable.py`` are
deprecation re-exports the port does not carry). The hypothesis property
runs derandomized, with no example database."""

import dataclasses
import math

import numpy as np
import pytest

pytest.importorskip("jax", reason="parity with the reference needs jax")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from _torch_parity import both, bits  # noqa: E402
from repro.configs import registry  # noqa: E402


def _cfg(name, **over):
    cfg = registry.get_smoke_config(name)
    return dataclasses.replace(cfg, **over) if over else cfg


CHAT = _cfg("qwen2-0.5b", num_layers=1, compute_dtype="float32")
MLA = _cfg("deepseek-v3-671b")
SSM = _cfg("xlstm-125m")
ASR = _cfg("whisper-tiny")
DOMAINS = (("hbm_local", 32, 819.0, True), ("host", 24, 16.0, False))
ARENA = (("hbm_local", 64 * 1024, 819.0, True), ("host", 128 * 1024, 8.0))


def _itemsize(cfg) -> int:
    return {"float32": 4, "bfloat16": 2}[cfg.compute_dtype]


def _geom_record(g) -> dict:
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)} | {
        "page_bytes": g.page_bytes, "shareable": g.shareable,
        "grows": g.grows, "array_shapes": [tuple(map(int, s)) for s in
                                           g.array_shapes(10)]}


def _set_k(pkg, view, pages, value) -> None:
    """Write ``value`` into every K element of ``pages``."""
    if pkg.port:
        view.k_pool[:, list(pages)] = value
    else:
        view.k_pool = view.k_pool.at[:, list(pages)].set(value)


def _zoo(pkg):
    zoo = pkg.zoo(ARENA)
    zoo.register("chat", pkg.cfg(CHAT), share=0.25, page_size=4)
    zoo.register("mla", pkg.cfg(MLA), share=0.25, page_size=4)
    zoo.register("ssm", pkg.cfg(SSM), share=0.3)
    return zoo


def _zoo_record(zoo) -> dict:
    st_ = zoo.stats()
    return {"stats": st_,
            "quota": {n: g.view.quota.tolist()
                      for n, g in zoo.groups.items()},
            "leases": [(ln.lender, ln.borrower, ln.lender_pages.tolist(),
                        ln.borrower_pages.tolist(), ln.escrow_bytes.tolist())
                       for ln in zoo.leases]}


# ---------------------------------------------------------------------------
# the geometry protocol
# ---------------------------------------------------------------------------

def test_paged_geometry_matches_historical_layout():
    def case(pkg):
        ps = 4
        g = pkg.geometry.geometry_for(pkg.cfg(CHAT), ps)
        assert g.kind == "paged_kv" and g.shareable and g.grows
        old = 2 * ps * CHAT.num_kv_heads * CHAT.head_dim_ \
            * _itemsize(CHAT) * CHAT.num_layers
        assert g.page_bytes == old
        k, v = g.array_shapes(10)
        assert k == v == (CHAT.num_layers, 10, ps, CHAT.num_kv_heads,
                          CHAT.head_dim_)
        assert [g.pages_for_tokens(t) for t in (0, 1, 9)] == [0, 1, 3]
        return _geom_record(g)
    both(case)


def test_mla_geometry_is_asymmetric_and_compressed():
    def case(pkg):
        g = pkg.geometry.geometry_for(pkg.cfg(MLA), 4)
        assert g.kind == "mla_latent" and g.shareable and g.grows
        assert g.k_block == (4, 1, MLA.mla.qk_rope_head_dim)
        assert g.v_block == (4, 1, MLA.mla.kv_lora_rank)
        assert g.k_block != g.v_block, "latent cache must be asymmetric"
        dense = pkg.geometry.paged_kv_geometry(pkg.cfg(MLA), 4)
        assert g.page_bytes < dense.page_bytes
        assert g.page_bytes == (4 * (MLA.mla.qk_rope_head_dim
                                     + MLA.mla.kv_lora_rank)
                                * _itemsize(MLA) * MLA.num_layers)
        return _geom_record(g), dense.page_bytes
    both(case)


def test_ssm_geometry_is_one_fixed_nonshareable_page():
    def case(pkg):
        g = pkg.geometry.geometry_for(pkg.cfg(SSM), 4)
        assert g.kind == "ssm_state"
        assert g.page_size == 1 and g.fixed_pages == 1 and not g.grows
        assert not g.shareable, "in-place-mutated state must not CoW-alias"
        assert [g.pages_for_tokens(t) for t in (0, 1, 7, 10 ** 6)] \
            == [1, 1, 1, 1]
        assert math.prod(g.k_block) != math.prod(g.v_block)
        return _geom_record(g)
    both(case)


def test_encoder_geometry_is_fixed_and_shareable():
    def case(pkg):
        cfg = pkg.cfg(ASR)
        g = pkg.geometry.encoder_kv_geometry(cfg, 4)
        assert g.kind == "encoder_kv" and g.shareable and not g.grows
        assert g.fixed_pages == -(-ASR.enc_frames // 4)
        assert g.num_layers == ASR.enc_layers
        default = pkg.geometry.geometry_for(cfg, 4)
        assert default.kind == "paged_kv"
        return _geom_record(g), _geom_record(default)
    both(case)


# ---------------------------------------------------------------------------
# pool + pagetable under a geometry
# ---------------------------------------------------------------------------

def test_pool_defaults_are_bit_identical():
    def case(pkg):
        pool = pkg.pool(CHAT, DOMAINS, page_size=4)
        g = pool.geometry
        assert g.kind == "paged_kv"
        assert pool.page_bytes == g.page_bytes
        assert tuple(pool.k_pool.shape) == tuple(pool.v_pool.shape) \
            == g.array_shapes(pool.total_pages)[0]
        pid = pool.alloc_page()
        assert pool.bytes_per_domain([pid])[0] == g.page_bytes
        return pid, pool.page_bytes, tuple(pool.k_pool.shape), \
            pool.bytes_per_domain([pid]).tolist()
    both(case)


def test_pool_materializes_asymmetric_mla_arrays():
    def case(pkg):
        pool = pkg.pool(MLA, DOMAINS, page_size=4)
        assert pool.geometry.kind == "mla_latent"
        assert pool.k_pool.shape != pool.v_pool.shape
        assert pool.k_pool.shape[-1] == MLA.mla.qk_rope_head_dim
        assert pool.v_pool.shape[-1] == MLA.mla.kv_lora_rank
        assert pool.page_bytes == pool.geometry.page_bytes
        return tuple(pool.k_pool.shape), tuple(pool.v_pool.shape), \
            pool.page_bytes, str(bits(pool.k_pool).dtype)
    both(case)


def test_ssm_pool_follows_geometry_page_size():
    def case(pkg):
        pool = pkg.pool(SSM, DOMAINS, page_size=4)
        assert pool.geometry.kind == "ssm_state"
        assert pool.page_size == 1, "pool token granularity follows geometry"
        return pool.page_size, tuple(pool.k_pool.shape), \
            tuple(pool.v_pool.shape), pool.total_pages
    both(case)


def test_prefix_trie_gated_off_for_nonshareable_geometry():
    def case(pkg):
        fab = pkg.fabric(SSM, DOMAINS, page_size=1, seed=0)
        view = fab.view("s", quota=(8, 6), home=(0,))
        pages = []
        view.append_page(pages)
        view.register_prefix([1], pages, 1)     # must be a silent no-op
        probe = []
        assert view.probe_prefix([1], probe) == 0 and probe == []
        view.release(pages)
        fab.check_invariants()
        return pages, view.free_count(), view.used.tolist()
    both(case)


def test_fork_semantics_copy_vs_refcount():
    def case(pkg):
        # SSM: fork copies state into fresh pages
        fab = pkg.fabric(SSM, DOMAINS, page_size=1, seed=0)
        v = fab.view("s", quota=(8, 6), home=(0,))
        pages = []
        v.append_page(pages)
        _set_k(pkg, v, pages[:1], 3.0)
        clone = v.fork_sequence(pages)
        assert clone and set(clone).isdisjoint(pages), "SSM fork must copy"
        np.testing.assert_array_equal(bits(v.k_pool[:, clone[0]]),
                                      bits(v.k_pool[:, pages[0]]))
        assert all(fab.table.ref[p] == 1 for p in pages + clone)
        # shareable: fork bumps refcounts, no new pages
        fab2 = pkg.fabric(CHAT, DOMAINS, page_size=4, seed=0)
        v2 = fab2.view("c", quota=(8, 6), home=(0,))
        pages2 = []
        v2.grow(pages2, 2)
        free_before = v2.free_count()
        clone2 = v2.fork_sequence(pages2)
        assert clone2 == pages2 and v2.free_count() == free_before
        assert all(fab2.table.ref[p] == 2 for p in pages2)
        rec = (pages, clone, pages2, clone2,
               bits(v.k_pool[:, clone[0]]), bits(v.v_pool[:, clone[0]]))
        v2.release(clone2)
        v2.release(pages2)
        for f in (fab, fab2):
            f.check_invariants()
        return rec
    both(case)


# ---------------------------------------------------------------------------
# the zoo: byte arena + capacity market
# ---------------------------------------------------------------------------

def test_zoo_three_geometries_one_arena():
    def case(pkg):
        zoo = _zoo(pkg)
        kinds = {g.geometry.kind for g in zoo.groups.values()}
        assert kinds == {"paged_kv", "mla_latent", "ssm_state"}
        for g in zoo.groups.values():
            assert (g.funded_bytes()
                    <= np.asarray([0.31 * d.capacity_bytes
                                   for d in zoo.domains])).all()
        zoo.check_invariants()
        return _zoo_record(zoo)
    both(case)


def test_zoo_market_annex_and_repay():
    def case(pkg):
        zoo = _zoo(pkg)
        chat = zoo.groups["chat"]
        start = {n: g.view.quota.copy() for n, g in zoo.groups.items()}
        zoo.observe_demand("chat", 80 * chat.page_bytes)
        assert zoo.page_value("chat") > zoo.page_value("ssm") == 0.0
        value = zoo.page_value("chat")
        flows = zoo.market_tick()
        assert flows["granted_bytes"] > 0
        assert {ln.lender for ln in zoo.leases if ln.granted_bytes} \
            <= {"mla", "ssm"}
        assert (chat.view.quota > start["chat"]).any()
        zoo.check_invariants()
        mid = _zoo_record(zoo)
        zoo.observe_demand("chat", 0)
        flows2 = zoo.market_tick()
        assert zoo.outstanding_bytes() == 0
        for n, q in start.items():
            np.testing.assert_array_equal(zoo.groups[n].view.quota, q)
        zoo.check_invariants()
        return value, flows, mid, flows2, _zoo_record(zoo)
    both(case)


def test_zoo_escrow_balances_mismatched_page_sizes():
    def case(pkg):
        zoo = _zoo(pkg)
        chat = zoo.groups["chat"]
        zoo.observe_demand("chat", 10 ** 9)
        zoo.market_tick()
        zoo.check_invariants()
        ssm_leases = [ln for ln in zoo.leases
                      if ln.lender == "ssm" and ln.granted_bytes]
        assert ssm_leases, "ssm funding never traded"
        ln = ssm_leases[0]
        lent = int(ln.lender_pages.sum()) * zoo.groups["ssm"].page_bytes
        funded = int(ln.borrower_pages.sum()) * chat.page_bytes
        assert lent == funded + int(ln.escrow_bytes.sum())
        return lent, funded, _zoo_record(zoo)
    both(case)


def test_zoo_unregister_is_leak_free():
    def case(pkg):
        zoo = _zoo(pkg)
        cap = zoo.capacity_bytes.copy()
        freed = [zoo.unregister(n).tolist() for n in list(zoo.groups)]
        np.testing.assert_array_equal(zoo.free_bytes(), cap)
        return freed, zoo.free_bytes().tolist()
    both(case)


def test_zoo_rejects_oversubscription():
    def case(pkg):
        zoo = pkg.zoo(ARENA)
        zoo.register("a", pkg.cfg(CHAT), share=0.7, page_size=4)
        with pytest.raises(AssertionError, match="oversubscribe"):
            zoo.register("b", pkg.cfg(CHAT), share=0.5, page_size=4)
        return _zoo_record(zoo)["quota"]
    both(case)


# ---------------------------------------------------------------------------
# property test: the trio under random interleavings
# ---------------------------------------------------------------------------

def _interleave(pkg, ops, seed) -> list:
    """``test_geometry.py``'s interleaving on one package; returns what
    each operation left behind (page lists, quotas, the lease book)."""
    zoo = _zoo(pkg)
    names = list(zoo.groups)
    rng = np.random.default_rng(seed)
    seqs = {n: [] for n in names}
    trail = []
    for op, gi, arg in ops:
        name = names[gi]
        g = zoo.groups[name]
        v, mine = g.view, seqs[name]
        if op == 0:                        # alloc
            n = 1 if not g.geometry.grows else int(rng.integers(1, 4))
            if v.free_count() < n:
                continue
            pages = []
            if g.geometry.grows:
                v.grow(pages, n)
            else:
                for _ in range(g.geometry.fixed_pages):
                    v.append_page(pages)
            mine.append(pages)
        elif op == 1 and mine:             # fork: copy or refcount
            pages = mine[arg % len(mine)]
            if not g.geometry.shareable \
                    and v.free_count() < len(pages):
                continue
            mine.append(v.fork_sequence(pages))
        elif op == 2 and mine:             # migrate live pages
            i = arg % len(mine)
            mine[i] = v.migrate(mine[i])
        elif op == 3 and mine:             # release
            v.release(mine.pop(arg % len(mine)))
        elif op == 4:                      # market tick under this demand
            for other in names:
                zoo.observe_demand(other, 0)
            zoo.observe_demand(name, arg * g.page_bytes)
            zoo.market_tick()
        zoo.check_invariants()
        trail.append(({n: [list(p) for p in s] for n, s in seqs.items()},
                      _zoo_record(zoo)))
    cap = zoo.capacity_bytes.copy()
    for name in names:
        for pages in seqs[name]:
            zoo.groups[name].view.release(pages)
        zoo.observe_demand(name, 0)
    zoo.market_tick()
    assert zoo.outstanding_bytes() == 0, "idle leases must fully repay"
    zoo.check_invariants()
    for name in names:
        zoo.unregister(name)
    np.testing.assert_array_equal(zoo.free_bytes(), cap)
    return trail


@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 2),
                          st.integers(0, 10 ** 6)),
                min_size=1, max_size=40),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
@settings(max_examples=20, deadline=None, derandomize=True, database=None)
def test_zoo_invariants_under_random_interleavings(ops, seed):
    """Random interleavings of alloc / fork / migrate / release / market
    ticks across the transformer + MLA + SSM trio hold the zoo byte ledger
    and every member fabric's invariants after every operation on both
    packages, leave the same page lists and ledgers on both, and a full
    drain + unregister leaks nothing."""
    both(_interleave, ops, seed)
