"""repro_torch.models.whisper (``EncDecLM``) and ``full_attention``'s
cross-attention against the reference's.

Both packages get the same params (drawn by the reference, crossing
through numpy) and the same seeded frames and tokens, on the whisper smoke
config in fp32. Tolerance 2e-5 (both sides compute in fp32 but sum in
different orders, XLA:CPU vs ATen); 1e-4 where a token-by-token decode is
held against a full forward. The reference runs under ``jax.jit``.

``init_cache`` leaves the cross K/V (``ck``, ``cv``) at zero in both
packages and nothing in either writes them, so a decode that should match
``prefill`` needs its caller to write them: here both packages project the
encoder's output through each layer's ``cross`` weights in the same way.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models.whisper import EncDecLM  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.models.whisper import EncDecLM as TEncDecLM  # noqa: E402
from _torch_parity import port_config  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 12


@pytest.fixture(autouse=True)
def one_thread():
    """Step-by-step runs of many small CPU ops run on one thread: beside
    the other test workers, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference model, its params, port model, port
    params, frames, tokens) on the whisper smoke config in fp32."""
    cfg = dataclasses.replace(r_registry.get_smoke_config("whisper-tiny"),
                              compute_dtype="float32")
    rm = EncDecLM(cfg)
    params = jax.tree.map(np.asarray, jax.jit(rm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    return (cfg, rm, params, TEncDecLM(port_config(cfg)),
            params_from_reference(params, device="cpu"), frames, toks)


def _batches(frames, toks):
    return ({"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
            {"frames": torch.from_numpy(frames),
             "tokens": torch.from_numpy(toks)})


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-0.5b"])
def test_cross_attention_matches_reference(arch):
    """``full_attention`` with ``xkv``/``kv_positions``: K/V from another
    sequence of another length, no rotary embedding (qwen2's rope is
    skipped too), not causal; and causal self-attention over ``xkv is
    None`` still rotates."""
    cfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                              compute_dtype="float32")
    tcfg = port_config(cfg)
    p = jax.tree.map(np.asarray, jax.jit(
        lambda k: r_attn.attn_params(k, cfg))(jax.random.PRNGKey(2)))
    tp = params_from_reference(p, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    xkv = rng.standard_normal((B, 11, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (B, 7)).copy()
    kpos = np.broadcast_to(np.arange(11, dtype=np.int32), (B, 11)).copy()
    want, (wk, wv) = jax.jit(lambda p, x, xkv, pos, kpos: r_attn.full_attention(
        cfg, p, x, pos, 0, causal=False, xkv=xkv, kv_positions=kpos))(
        p, jnp.asarray(x), jnp.asarray(xkv), jnp.asarray(pos),
        jnp.asarray(kpos))
    t = torch.from_numpy
    got, (gk, gv) = t_attn.full_attention(tcfg, tp, t(x), t(pos), 0,
                                          causal=False, xkv=t(xkv),
                                          kv_positions=t(kpos))
    assert gk.shape == (B, 11, cfg.num_kv_heads, cfg.head_dim_)
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL)
    want, _ = jax.jit(lambda p, x, pos: r_attn.full_attention(
        cfg, p, x, pos, 0))(p, jnp.asarray(x), jnp.asarray(pos))
    got, _ = t_attn.full_attention(tcfg, tp, t(x), t(pos), 0)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


def test_init_tree_mirrors_reference(pair):
    """The port's own init draws the reference's tree: keys, nesting and
    shapes."""
    _, _, params, tm, _, _, _ = pair
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert jax.tree.structure(shapes(params)) == \
        jax.tree.structure(shapes(own))
    assert shapes(params) == shapes(own)
    assert set(own) == {"embed", "pos_dec", "enc", "dec", "enc_norm",
                        "final_norm"}


def test_encode_loss_prefill_match_reference(pair):
    cfg, rm, params, tm, tparams, frames, toks = pair
    rb, tb = _batches(frames, toks)
    np.testing.assert_allclose(
        _f32(tm.encode(tparams, tb["frames"])),
        _f32(jax.jit(rm.encode)(params, rb["frames"])), **TOL)
    (want, wm), (got, gm) = jax.jit(rm.loss)(params, rb), \
        tm.loss(tparams, tb)
    assert set(gm) == set(wm) == {"ce"}
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    want, got = jax.jit(rm.prefill)(params, rb), tm.prefill(tparams, tb)
    assert got.shape == want.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL)


def _assert_same_cache(tc, rc):
    assert len(tc) == len(rc)
    for t, r in zip(tc, rc):
        assert set(t) == set(r) == {"k", "v", "pos", "ck", "cv"}
        for key in r:
            assert tuple(t[key].shape) == r[key].shape
            if key == "pos":
                np.testing.assert_array_equal(t[key].numpy(), np.asarray(r[key]))
            else:
                np.testing.assert_allclose(_f32(t[key]), _f32(r[key]), **TOL)


def test_decode_from_zero_cross_cache_matches_reference(pair):
    """Two steps from ``init_cache``'s zero cross K/V, as the reference's
    ``decode_step`` runs unless its caller writes them: logits and caches
    equal after each step; the self-attention cache is written in place."""
    cfg, rm, params, tm, tparams, _, toks = pair
    rc = rm.init_cache(None, B, 16, cfg.enc_frames)
    tc = tm.init_cache(None, B, 16, cfg.enc_frames, device="cpu")
    _assert_same_cache(tc, rc)
    step = jax.jit(rm.decode_step)
    for t in range(2):
        want, rc = step(params, rc, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                        jnp.int32(t))
        got, tc2 = tm.decode_step(tparams, tc,
                                  torch.from_numpy(toks[:, t:t + 1]),
                                  torch.tensor(t))
        assert tc2 is tc
        assert got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
        _assert_same_cache(tc, rc)
    assert tc[0]["pos"][0].tolist()[:3] == [0, 1, -1]


def test_decode_with_encoder_cross_cache_matches_prefill(pair):
    """Each package writes ``ck``/``cv`` from its own ``encode`` through
    each layer's ``cross`` weights, then decodes the tokens one by one: the
    port's last-step logits equal the reference's ``prefill`` of the same
    tokens (1e-4), and so do the reference's own."""
    cfg, rm, params, tm, tparams, frames, toks = pair
    rb, tb = _batches(frames, toks)
    nkv, hd, f = cfg.num_kv_heads, cfg.head_dim_, cfg.enc_frames
    enc = jax.jit(rm.encode)(params, rb["frames"])
    tenc = tm.encode(tparams, tb["frames"])
    rc = rm.init_cache(None, B, S, f)
    tc = tm.init_cache(None, B, S, f, device="cpu")
    for l in range(cfg.num_layers):
        pc, tpc = params["dec"][l]["cross"], tparams["dec"][l]["cross"]
        rc[l]["ck"] = (enc @ pc["wk"]).reshape(B, f, nkv, hd)
        rc[l]["cv"] = (enc @ pc["wv"]).reshape(B, f, nkv, hd)
        tc[l]["ck"].copy_((tenc @ tpc["wk"]).reshape(B, f, nkv, hd))
        tc[l]["cv"].copy_((tenc @ tpc["wv"]).reshape(B, f, nkv, hd))
    step = jax.jit(rm.decode_step)
    for t in range(S):
        tok = toks[:, t:t + 1]
        want, rc = step(params, rc, jnp.asarray(tok, jnp.int32), jnp.int32(t))
        got, tc = tm.decode_step(tparams, tc, torch.from_numpy(tok), t)
    full = _f32(jax.jit(rm.prefill)(params, rb))
    np.testing.assert_allclose(_f32(want), full, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_f32(got), full, rtol=1e-4, atol=1e-4)


def test_registry_builds_encdec_and_lm_refuses(pair):
    """``registry.make_model`` gives ``EncDecLM`` for whisper, as the
    reference's; ``LM`` refuses the config and names ``EncDecLM``; the
    registry's train, prefill and decode steps equal the reference's."""
    cfg, rm, params, tm, tparams, frames, toks = pair
    tcfg = tm.cfg
    assert isinstance(t_registry.make_model(tcfg), TEncDecLM)
    assert isinstance(r_registry.make_model(cfg), EncDecLM)
    with pytest.raises(ValueError, match="EncDecLM"):
        TLM(t_registry.get_config("whisper-tiny"))
    rb, tb = _batches(frames, toks)
    shapes = t_registry.SHAPES
    for name in ("train_4k", "prefill_32k"):
        got = t_registry.step_fn(tcfg, shapes[name], tm)(tparams, tb)
        want = jax.jit(r_registry.step_fn(cfg, r_registry.SHAPES[name],
                                          rm))(params, rb)
        got, want = (got[0], want[0]) if name == "train_4k" else (got, want)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
    toks1 = toks[:, :1]
    for name in ("decode_32k", "long_500k"):
        assert t_registry.cell_supported(tcfg, shapes[name]) == \
            r_registry.cell_supported(cfg, r_registry.SHAPES[name])
        want, _ = jax.jit(r_registry.step_fn(cfg, r_registry.SHAPES[name],
                                             rm))(
            params, {"cache": rm.init_cache(None, B, 8, cfg.enc_frames),
                     "tokens": jnp.asarray(toks1, jnp.int32),
                     "position": jnp.int32(0)})
        got, _ = t_registry.step_fn(tcfg, shapes[name], tm)(
            tparams, {"cache": tm.init_cache(None, B, 8, cfg.enc_frames,
                                             device="cpu"),
                      "tokens": torch.from_numpy(toks1), "position": 0})
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL)
