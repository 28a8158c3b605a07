"""repro_torch's MLA (DeepSeek-V3's compressed-latent attention) against
the reference's: ``attn_params``' MLA tree, ``mla_attention`` (per-head
K/V materialised from the latent), the latent cache (``init_cache`` and
``LM.init_cache`` on the deepseek smoke config), the absorbed
``mla_decode_attention`` step by step, and
``test_models_smoke.py::test_decode_matches_prefill_mla`` on both packages.

Both packages get the same params (drawn by the reference, crossing
through numpy) and the same seeded inputs, in fp32. Tolerances: 2e-5 for
the attention functions (both sides compute in fp32 but sum in different
orders, XLA:CPU vs ATen), 1e-4 between decode and the full forward (the
reference test's own). The reference runs under ``jax.jit``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro_torch.convert import (cache_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import port_config  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _cfg(**moe):
    cfg = dataclasses.replace(r_registry.get_smoke_config("deepseek-v3-671b"),
                              compute_dtype="float32")
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _shapes(tree):
    return jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.fixture(scope="module")
def attn():
    """(cfg, port cfg, reference MLA params, the port's copy)."""
    cfg = _cfg()
    p = jax.tree.map(np.asarray, jax.jit(
        lambda key: r_attn.attn_params(key, cfg))(jax.random.PRNGKey(2)))
    return cfg, port_config(cfg), p, params_from_reference(p, device="cpu")


def test_mla_params_and_cache_layout(attn):
    """The port's own MLA params have the reference's tree; its latent
    cache is ``{"ckv", "kpe", "pos"}`` at the reference's shapes and
    dtypes (one layer, and with a leading layer axis), and
    ``LM.init_cache`` groups it as the model's layers: the deepseek smoke
    config's one ``moe_dense`` layer as a list, its four ``moe`` layers
    stacked."""
    cfg, tcfg, p, _ = attn
    own = t_attn.attn_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert _shapes(p) == _shapes(own)
    m = cfg.mla
    for axes in ((), (3,)):
        want = r_attn.init_cache(cfg, 2, 10, layer_axes=axes)
        got = t_attn.init_cache(tcfg, 2, 10, axes, device="cpu")
        assert set(got) == {"ckv", "kpe", "pos"}
        assert _shapes(want) == _shapes(got)
        assert tuple(got["ckv"].shape) == axes + (2, 10, m.kv_lora_rank)
        assert tuple(got["kpe"].shape) == axes + (2, 10, m.qk_rope_head_dim)
        assert bool((got["pos"] == -1).all())
    tm = TLM(tcfg)
    assert [(g.kind, len(g.indices), g.scanned) for g in tm.groups] == [
        ("moe_dense", 1, False), ("moe", 4, True)]
    want = jax.eval_shape(lambda: LM(cfg).init_cache(2, 12))
    got = tm.init_cache(2, 12, device="cpu")
    assert jax.tree.structure(_shapes(want)) == \
        jax.tree.structure(_shapes(got))
    assert jax.tree.leaves(_shapes(want)) == jax.tree.leaves(_shapes(got))


@pytest.mark.parametrize("s,window", [(9, 0), (13, 4)])
def test_mla_attention_matches_reference(attn, s, window):
    """Output and the latent K/V it primes a cache with, causal, with and
    without a window."""
    cfg, tcfg, p, tp = attn
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    want, (wc, wk) = jax.jit(
        lambda p, x, pos: r_attn.mla_attention(cfg, p, x, pos, window))(
        p, jnp.asarray(x), jnp.asarray(pos))
    got, (gc, gk) = t_attn.mla_attention(tcfg, tp, torch.from_numpy(x),
                                         torch.from_numpy(pos), window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)


@pytest.mark.parametrize("cap", [12, 4], ids=["linear", "ring"])
def test_mla_decode_attention_matches_reference(attn, cap):
    """The absorbed decode, 10 steps from an empty cache (a ring buffer of
    4 slots with a window of 4 wraps): the port writes its cache in place,
    and its output and cache equal the reference's after every step; then
    a step from the reference's cache crossed mid-sequence."""
    cfg, tcfg, p, tp = attn
    window = 0 if cap == 12 else 4
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((11, 2, 1, cfg.d_model)).astype(np.float32)
    step = jax.jit(lambda p, x, c, t: r_attn.mla_decode_attention(
        cfg, p, x, c, t, window))
    rc = r_attn.init_cache(cfg, 2, cap)
    tc = t_attn.init_cache(tcfg, 2, cap, device="cpu")
    for t in range(10):
        want, rc = step(p, jnp.asarray(xs[t]), rc, jnp.int32(t))
        got, tc2 = t_attn.mla_decode_attention(
            tcfg, tp, torch.from_numpy(xs[t]), tc,
            t if t % 2 else torch.tensor(t), window)
        assert tc2 is tc
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(rc["pos"]))
        for name in ("ckv", "kpe"):
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(rc[name]), **TOL)
    assert tc["pos"][0].tolist() == (list(range(10)) + [-1, -1] if cap == 12
                                     else [8, 9, 6, 7])
    tc = cache_from_reference(jax.tree.map(np.asarray, rc), device="cpu")
    want, _ = step(p, jnp.asarray(xs[10]), rc, jnp.int32(10))
    got, _ = t_attn.mla_decode_attention(tcfg, tp, torch.from_numpy(xs[10]),
                                         tc, 10, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_prefill_mla():
    """``test_models_smoke.py::test_decode_matches_prefill_mla`` on both
    packages: with a capacity factor of 8 (no copy dropped), each
    package's absorbed decode logits match its materialised forward's at
    every position (1e-4, the reference test's bound), and the port's
    decode and forward logits equal the reference's."""
    cfg = _cfg(capacity_factor=8.0)
    rm, tm = LM(cfg), TLM(port_config(cfg))
    params = jax.tree.map(np.asarray,
                          jax.jit(rm.init)(jax.random.PRNGKey(5)))
    tparams = params_from_reference(params, device="cpu")
    b, s = 2, 8
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    rfull = jax.jit(lambda p, t, pos: rm.logits(p, rm.hidden(
        p, rm.embed(p, {"tokens": t}), pos)[0]))(
        params, jnp.asarray(tokens, jnp.int32), jnp.asarray(pos))
    th, _, _ = tm.hidden(tparams, tm.embed(tparams, {
        "tokens": torch.from_numpy(tokens)}), torch.from_numpy(pos))
    tfull = tm.logits(tparams, th)
    rc, tc = rm.init_cache(b, s), tm.init_cache(b, s, device="cpu")
    rstep = jax.jit(rm.decode_step)
    rdec, tdec = [], []
    for t in range(s):
        lg, rc = rstep(params, rc, jnp.asarray(tokens[:, t:t + 1], jnp.int32),
                       jnp.int32(t))
        rdec.append(np.asarray(lg[:, 0]))
        lg, tc = tm.decode_step(tparams, tc,
                                torch.from_numpy(tokens[:, t:t + 1]), t)
        tdec.append(lg[:, 0].numpy())
    rdec, tdec = np.stack(rdec, 1), np.stack(tdec, 1)
    for full, dec in ((np.asarray(rfull), rdec), (tfull.numpy(), tdec)):
        np.testing.assert_allclose(full, dec, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tdec, rdec, **TOL)
    np.testing.assert_allclose(tfull.numpy(), np.asarray(rfull), **TOL)
