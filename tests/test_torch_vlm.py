"""repro_torch's VLM family (qwen2-vl: M-RoPE and the vision stub's patch
embeddings) against the reference: ``layers.apply_mrope``, ``LM.prefill``
and ``LM.loss`` with patch embeddings and the batch's own ``[3, B, S]``
positions, the M-RoPE ``decode_step`` after every step, the serving engine
on the qwen2-vl smoke config, and the flash branch's refusal of
caller-given M-RoPE positions.

Both packages get the same params (drawn by the reference, crossing
through numpy) and the same seeded inputs, in fp32. Tolerance 2e-5: both
sides compute in fp32 but sum in different orders (XLA:CPU vs ATen). The
reference's model functions run under ``jax.jit``; its engine runs eagerly,
as in its own tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import both, port_config  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def vlm():
    """(cfg, reference LM, its params, port LM, port params) on the
    qwen2-vl smoke config in fp32."""
    cfg = dataclasses.replace(r_registry.get_smoke_config("qwen2-vl-7b"),
                              compute_dtype="float32")
    rm = LM(cfg)
    params = jax.tree.map(np.asarray, jax.jit(rm.init)(jax.random.PRNGKey(0)))
    return (cfg, rm, params, TLM(port_config(cfg)),
            params_from_reference(params, device="cpu"))


def _mrope_batch(cfg, b: int, n_text: int, seed: int) -> dict:
    """A 2 x 4 grid of stub patches (temporal stream 0, height and width
    streams the patch's row and column), then ``n_text`` tokens whose three
    streams all continue from the grid's largest position plus one."""
    rng = np.random.default_rng(seed)
    rows, cols = 2, cfg.vision_patches // 2
    grid = np.stack([np.zeros(rows * cols), np.repeat(np.arange(rows), cols),
                     np.tile(np.arange(cols), rows)])              # [3, P]
    text = np.arange(n_text) + grid.max() + 1
    pos = np.concatenate([grid, np.broadcast_to(text, (3, n_text))], axis=1)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (b, n_text)),
        "patch_embeds": (rng.standard_normal(
            (b, cfg.vision_patches, cfg.d_model)) * 0.02).astype(np.float32),
        "positions": np.broadcast_to(pos[:, None], (3, b, pos.shape[1]))
        .astype(np.int32).copy(),
    }


def test_apply_mrope_three_streams():
    """Three distinct position streams at qwen2-vl's published sections
    (16, 24, 24) and the smoke config's (2, 3, 3); one stream broadcast to
    all three equals the 1-D rotary embedding."""
    rng = np.random.default_rng(0)
    for sections in ((16, 24, 24), (2, 3, 3)):
        d = 2 * sum(sections)
        x = rng.standard_normal((2, 7, 4, d)).astype(np.float32)
        pos = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)
        assert len({tuple(p.ravel()) for p in pos}) == 3
        want = jax.jit(r_layers.apply_mrope, static_argnums=(2, 3))(
            jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
        got = t_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                                   1e6, sections)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        one = torch.from_numpy(pos[1])
        np.testing.assert_array_equal(
            t_layers.apply_mrope(torch.from_numpy(x), one.expand(3, 2, 7),
                                 1e6, sections).numpy(),
            t_layers.apply_rope(torch.from_numpy(x), one, 1e6).numpy())


@pytest.mark.parametrize("attn_impl", [None, "reference"])
def test_prefill_and_loss_with_patches_and_positions(vlm, attn_impl):
    """Patch embeddings before the tokens and the batch's own M-RoPE
    positions: last-token logits, loss and its parts equal the
    reference's (the loss skips the patch region)."""
    cfg, rm, params, tm, tparams = vlm
    tm.attn_impl = attn_impl
    batch = _mrope_batch(cfg, 2, 11, 1)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert tm.embed(tparams, tb).shape == (2, cfg.vision_patches + 11,
                                           cfg.d_model)
    want = jax.jit(rm.prefill)(params, rb)
    got = tm.prefill(tparams, tb)
    assert got.shape == want.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    (want, wm), (got, gm) = jax.jit(rm.loss)(params, rb), \
        tm.loss(tparams, tb)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert set(gm) == set(wm) == {"ce", "aux"}
    np.testing.assert_allclose(gm["ce"].item(), float(wm["ce"]), **TOL)
    # the batch's positions matter: the default ones give other logits
    plain = tm.prefill(tparams, {k: v for k, v in tb.items()
                                 if k != "positions"})
    assert float((plain - got).abs().max()) > 1e-4


@pytest.mark.parametrize("attn_impl", [None, "flash"])
def test_prefill_with_patches_default_positions(vlm, attn_impl):
    """Patch embeddings with the default positions (``arange`` in every
    stream): the flash branch (its plain version on the CPU) and the
    chunked branch give the reference's logits and loss."""
    cfg, rm, params, tm, tparams = vlm
    tm.attn_impl = attn_impl
    batch = _mrope_batch(cfg, 2, 9, 2)
    del batch["positions"]
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(tm.prefill(tparams, tb).numpy(),
                               np.asarray(jax.jit(rm.prefill)(params, rb)),
                               **TOL)
    np.testing.assert_allclose(tm.loss(tparams, tb)[0].item(),
                               float(jax.jit(rm.loss)(params, rb)[0]), **TOL)


def test_flash_refuses_caller_positions(vlm):
    """The flash branch masks by sequence index: with the batch's own
    M-RoPE positions it raises, naming ``attn_impl='reference'``, instead
    of attending at positions it cannot honour."""
    cfg, _, _, tm, tparams = vlm
    tm.attn_impl = "flash"
    tb = {k: torch.from_numpy(v)
          for k, v in _mrope_batch(cfg, 1, 5, 3).items()}
    for fn in (tm.prefill, tm.loss):
        with pytest.raises(NotImplementedError,
                           match="attn_impl='reference'"):
            fn(tparams, tb)
    tm.attn_impl = None


def test_mrope_decode_matches_reference_every_step(vlm):
    """Token-by-token decode (the position broadcast to the three streams)
    from an empty cache: the port's logits, cache positions and K/V equal
    the reference's after every step, and its decode logits equal its full
    forward's at every position."""
    cfg, rm, params, tm, tparams = vlm
    tm.attn_impl = None
    b, s = 2, 9
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (b, s))
    rc, tc = rm.init_cache(b, s), tm.init_cache(b, s, device="cpu")
    step = jax.jit(rm.decode_step)
    dec = []
    for t in range(s):
        tok = tokens[:, t:t + 1]
        want, rc = step(params, rc, jnp.asarray(tok, jnp.int32), jnp.int32(t))
        got, tc2 = tm.decode_step(tparams, tc, torch.from_numpy(tok),
                                  torch.tensor(t))
        assert tc2 is tc
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(tc[0]["pos"].numpy(),
                                      np.asarray(rc[0]["pos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[0][name].numpy(),
                                       np.asarray(rc[0][name]), **TOL)
        dec.append(got[:, 0])
    x = tm.embed(tparams, {"tokens": torch.from_numpy(tokens)})
    h, _, _ = tm.hidden(tparams, x, torch.arange(s).expand(3, b, s))
    np.testing.assert_allclose(tm.logits(tparams, h).numpy(),
                               torch.stack(dec, 1).numpy(), rtol=1e-4,
                               atol=1e-4)


def _serve(pkg, vlm):
    """The qwen2-vl smoke config served on a pool of 64 pages of 4 tokens:
    4 prompts of 5-12 tokens, 5 new tokens each, batch 3. Returns the
    tokens, the page ids of every running sequence after every step, and
    the first decode step's logits."""
    cfg, _, params, tm, tparams = vlm
    if pkg.port:
        from repro_torch.core.dwp import DWPConfig
        from repro_torch.placement import pool as m
        from repro_torch.serve.engine import ServeEngine
        cfg, params, kw = tm.cfg, tparams, {"device": "cpu"}
    else:
        from repro.core.dwp import DWPConfig
        from repro.placement import pool as m
        from repro.serve.engine import ServeEngine
        kw = {}
    pool = m.BwapPagePool(cfg, [
        m.MemoryDomain("hbm_local", 32, 819.0, True),
        m.MemoryDomain("hbm_peer", 16, 50.0, False),
        m.MemoryDomain("host", 16, 16.0, False)], page_size=4,
        dwp_config=DWPConfig(n=4, c=1), **kw)
    eng = ServeEngine(cfg, params, pool, max_batch=3, max_new=5,
                      wall_clock=False, **kw)
    seen = []
    run = eng.decoder.decode_step

    def record(*a):
        seen.append(np.asarray(run(*a)))
        return seen[-1] if not pkg.port else torch.from_numpy(seen[-1])
    eng.decoder.decode_step = record
    rng = np.random.default_rng(0)
    for n in rng.integers(5, 13, 4):
        eng.submit(rng.integers(1, cfg.vocab_size, n).tolist())
    pages = []
    for _ in range(60):
        eng.step()
        pages.append([list(map(int, s.pages)) for s in eng.active])
        if not eng.active and not eng.waiting:
            break
    assert len(eng.finished) == 4 and all(s.produced == 5
                                          for s in eng.finished)
    assert sum(len(f) for f in pool.free) == pool.total_pages
    return ({s.sid: list(map(int, s.tokens)) for s in eng.finished}, pages,
            seen[0])


def test_engine_serves_qwen2_vl_as_reference(vlm):
    """The port's engine serves the qwen2-vl smoke config with the
    reference engine's tokens and page ids at every step (the engine's
    1-D rotary embedding is M-RoPE on text tokens), and its first decode
    step's logits within 2e-5 of the reference's."""
    logits = {}

    def case(pkg):
        toks, pages, first = _serve(pkg, vlm)
        logits[pkg.port] = first
        return toks, pages
    both(case)
    np.testing.assert_allclose(logits[True], logits[False], rtol=0,
                               atol=2e-5)


def test_launch_serve_qwen2_vl_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --arch qwen2-vl-7b --device
    cpu`` builds the smoke config's model and serves every request."""
    from repro_torch.launch import serve
    eng = serve.main(["--arch", "qwen2-vl-7b", "--device", "cpu",
                      "--requests", "2", "--new", "4"])
    assert eng.cfg.family == "vlm" and len(eng.finished) == 2
    assert "served 2 sequences" in capsys.readouterr().out
