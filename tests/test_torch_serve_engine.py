"""``tests/test_serve_engine.py``'s five cases on both packages: the BWAP
page pool and the serving engine on the 2-layer fp32 qwen2 smoke config.

Each case runs on the reference and on the port through
``_torch_parity.both`` and returns a record (page domains, tokens, the
tuner's state) that must be equal; each also keeps the reference test's
own assertions on either package. Both engines get the reference's params
(``PRNGKey(0)``, crossing through numpy). The dense-decode case also holds
the port engine's first decode logits against the port's
``LM.decode_step`` over the same prompt, in fp32 (atol 2e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from _torch_parity import both, port_config  # noqa: E402


@pytest.fixture(scope="module")
def small_lm():
    """{port?: (cfg, params)} for the reference test's model."""
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=2, compute_dtype="float32")
    params = LM(cfg).init(jax.random.PRNGKey(0))
    return {False: (cfg, params),
            True: (port_config(cfg), params_from_reference(
                jax.tree.map(np.asarray, params), device="cpu"))}


def _mods(pkg):
    if pkg.port:
        from repro_torch.core.dwp import DWPConfig
        from repro_torch.models.lm import LM as M
        from repro_torch.placement import pool
        from repro_torch.serve.engine import ServeEngine
    else:
        from repro.core.dwp import DWPConfig
        from repro.models.lm import LM as M
        from repro.placement import pool
        from repro.serve.engine import ServeEngine
    return DWPConfig, M, pool, ServeEngine


def _pool(pkg, cfg, pages=64, page_size=8):
    DWPConfig, _, m, _ = _mods(pkg)
    domains = [
        m.MemoryDomain("hbm_local", pages // 2, 819.0, True),
        m.MemoryDomain("hbm_peer", pages // 4, 50.0, False),
        m.MemoryDomain("host", pages - pages // 2 - pages // 4, 16.0, False),
    ]
    kw = {"device": "cpu"} if pkg.port else {}
    return m.BwapPagePool(cfg, domains, page_size=page_size,
                          dwp_config=DWPConfig(n=4, c=1), **kw)


def _engine(pkg, cfg, params, pool, **kw):
    ServeEngine = _mods(pkg)[3]
    if pkg.port:
        kw["device"] = "cpu"
    return ServeEngine(cfg, params, pool, **kw)


def test_pool_placement_follows_weights(small_lm):
    def case(pkg):
        cfg, _ = small_lm[pkg.port]
        pool = _pool(pkg, cfg, pages=64)
        ids = [pool.alloc_page() for _ in range(32)]
        domains = np.asarray([pool.domain_of(i) for i in ids])
        # canonical weights put most pages on the fast domain
        assert (domains == 0).mean() > 0.7
        # but slower domains are used too (Observation 1)
        assert (domains != 0).any()
        return ids, domains.tolist(), np.asarray(pool.weights).tolist()
    both(case)


def test_pool_alloc_free_roundtrip(small_lm):
    def case(pkg):
        cfg, _ = small_lm[pkg.port]
        pool = _pool(pkg, cfg, pages=16, page_size=4)
        ids = [pool.alloc_page() for _ in range(16)]
        assert len(set(ids)) == 16
        with pytest.raises(RuntimeError):
            pool.alloc_page()
        pool.free_pages(ids)
        assert sum(len(f) for f in pool.free) == 16
        return ids, [sorted(f) for f in pool.free]
    both(case)


def test_engine_generates_and_respects_pages(small_lm):
    def case(pkg):
        cfg, params = small_lm[pkg.port]
        pool = _pool(pkg, cfg, pages=128, page_size=4)
        eng = _engine(pkg, cfg, params, pool, max_batch=3, max_new=6)
        rng = np.random.default_rng(0)
        for _ in range(3):
            eng.submit(rng.integers(1, cfg.vocab_size, 5).tolist())
        pages = []
        for _ in range(30):
            eng.step()
            pages.append([list(s.pages) for s in eng.active])
            if not eng.active and not eng.waiting:
                break
        assert len(eng.finished) == 3
        for s in eng.finished:
            assert s.produced == 6
            assert all(np.isfinite(t) for t in s.tokens)
        # pool fully reclaimed
        assert sum(len(f) for f in pool.free) == pool.total_pages
        return {s.sid: list(s.tokens) for s in eng.finished}, pages
    both(case)


def test_engine_decode_matches_dense_decode(small_lm):
    """Paged decode must produce the same token as the dense path (the
    reference's check: argmax of the full forward's last position). On the
    port the engine's first decode logits also equal ``LM.decode_step``'s
    over the same prompt."""
    prompt = [3, 17, 29, 5]

    def case(pkg):
        cfg, params = small_lm[pkg.port]
        _, M, _, _ = _mods(pkg)
        pool = _pool(pkg, cfg, pages=64, page_size=4)
        eng = _engine(pkg, cfg, params, pool, max_batch=1, max_new=1)
        seen = []
        if pkg.port:
            run = eng.decoder.decode_step

            def record(*a):
                seen.append(run(*a))
                return seen[-1]
            eng.decoder.decode_step = record
        eng.submit(list(prompt))
        eng.step()  # prefill + 1 decode
        paged_next = eng.finished[0].tokens[len(prompt)] if eng.finished \
            else eng.active[0].tokens[len(prompt)]
        model = M(cfg)
        if pkg.port:
            toks = torch.tensor([prompt])
            logits = model.prefill(params, {"tokens": toks})
            cache = model.init_cache(1, len(prompt), device="cpu")
            for t in range(len(prompt)):
                dense, cache = model.decode_step(params, cache,
                                                 toks[:, t:t + 1], t)
            assert len(seen) == 1
            np.testing.assert_allclose(seen[0].numpy(), dense[:, 0].numpy(),
                                       rtol=0, atol=2e-5)
            dense_next = int(logits[0, -1].argmax())
        else:
            toks = jnp.asarray([prompt], jnp.int32)
            logits = model.prefill(params, {"tokens": toks})
            dense_next = int(jnp.argmax(logits[0, -1]))
        assert paged_next == dense_next
        return paged_next
    both(case)


def test_dwp_migration_changes_allocation(small_lm):
    def case(pkg):
        cfg, _ = small_lm[pkg.port]
        pool = _pool(pkg, cfg, pages=64, page_size=4)
        w0 = pool.weights.copy()
        # feed decreasing latencies -> tuner raises DWP -> more
        # worker-local mass
        lat, fed = 1.0, 0
        while not pool.tuner.done and lat > 0.2:
            pool.record_latency(lat)
            lat -= 0.02
            fed += 1
        assert pool.tuner.dwp > 0
        assert pool.weights[0] > w0[0]
        return fed, pool.tuner.dwp, np.asarray(pool.weights).tolist()
    both(case)


def test_prefill_chunk_writes_the_reference_pages(small_lm):
    """``PagedDecoder.prefill_chunk``, the one-chunk call of
    ``forward_chunks``: the 4-token prompt of the dense-decode case (the
    same B = 1, T = 4 chunk that engine runs, so the reference compiles
    no new shape) writes K/V pages equal to the reference's, within fp32
    rounding (2e-5); on the port, the same prompt as two chunks writes the
    same pages."""
    prompt = [3, 17, 29, 5]
    pages_of = {}

    def case(pkg):
        cfg, params = small_lm[pkg.port]
        pool = _pool(pkg, cfg, pages=64, page_size=4)
        eng = _engine(pkg, cfg, params, pool, max_batch=1, max_new=1)
        pages = [pool.alloc_page()]
        eng.decoder.prefill_chunk(prompt, pages, 0, len(prompt))
        view = eng.decoder.view
        kv = [np.asarray(p[:, pages]) for p in (view.k_pool, view.v_pool)]
        assert np.abs(kv[0]).max() > 0
        if pkg.port:
            split = _engine(pkg, cfg, params,
                            _pool(pkg, cfg, pages=64, page_size=4),
                            max_batch=1, max_new=1)
            spages = [split.decoder.view.pool.alloc_page()]
            split.decoder.prefill_chunk(prompt, spages, 0, 2)
            split.decoder.prefill_chunk(prompt, spages, 2, len(prompt))
            sv = split.decoder.view
            for got, want in zip((sv.k_pool, sv.v_pool), kv):
                np.testing.assert_allclose(np.asarray(got[:, spages]),
                                           want, rtol=0, atol=2e-5)
        pages_of[pkg.port] = kv
        return pages
    both(case)
    for got, want in zip(pages_of[True], pages_of[False]):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
