"""repro_torch.models against repro.models under the same (converted)
params: layers, dense GQA attention, and ``LM.hidden``/``logits``, in fp32.

Tolerance: 1e-5 relative / 1e-5 absolute for single layers and 5e-5 for the
whole LM — both sides compute in fp32 but sum in different orders (XLA:CPU
vs ATen). Params cross through numpy; bf16 crosses bit-exactly. The
reference functions run under ``jax.jit``: one XLA compile per function
instead of one per eager op keeps this file short.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import port_config  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(num_layers: int, dtype: str = "float32"):
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=num_layers, compute_dtype=dtype)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def test_registry_mirrors_reference():
    """All ten configs and smoke configs equal the reference's (sub-configs
    included); ``LM`` builds the MoE, VLM, hybrid and SSM families with the
    reference's layer groups, and refuses the encoder-decoder config,
    naming ``EncDecLM``."""
    assert t_registry.ARCH_IDS == registry.ARCH_IDS
    for arch in registry.ARCH_IDS:
        assert t_registry.get_config(arch) == port_config(
            registry.get_config(arch))
        assert t_registry.get_smoke_config(arch) == port_config(
            registry.get_smoke_config(arch))
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-vl-7b",
                 "hymba-1.5b", "xlstm-125m"):
        assert [(g.kind, g.indices, g.scanned) for g in
                TLM(t_registry.get_config(arch)).groups] == \
            [(g.kind, g.indices, g.scanned) for g in
             LM(registry.get_config(arch)).groups]
    with pytest.raises(ValueError, match="EncDecLM"):
        TLM(t_registry.get_config("whisper-tiny"))


def test_bf16_params_cross_bit_exactly():
    x = jax.random.normal(jax.random.PRNGKey(1), (7, 5)).astype(jnp.bfloat16)
    tree = {"a": [x, x[0]], "b": {"c": jnp.arange(4, dtype=jnp.float32)}}
    out = params_from_reference(_np(tree), device="cpu")
    assert out["a"][0].dtype == torch.bfloat16
    bits = np.asarray(x).view(np.uint16).astype(np.int32)
    got = out["a"][0].view(torch.int16).numpy().astype(np.int32) & 0xFFFF
    np.testing.assert_array_equal(got, bits)
    assert out["b"]["c"].dtype == torch.float32
    assert out["a"][1].shape == (5,)


def test_norm_rope_mlp_match():
    cfg, tcfg = _cfgs(1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    gamma = rng.standard_normal(64).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        t_layers.rmsnorm(_t(x), _t(gamma), 1e-6).numpy(),
        np.asarray(jax.jit(r_layers.rmsnorm)(jnp.asarray(x),
                                             jnp.asarray(gamma))),
        **TOL)
    q = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        t_layers.apply_rope(_t(q), _t(pos), 1e6).numpy(),
        np.asarray(jax.jit(r_layers.apply_rope, static_argnums=2)(
            jnp.asarray(q), jnp.asarray(pos), 1e6)), rtol=1e-4, atol=1e-4)
    mlp = _np(jax.jit(lambda key: r_layers.mlp_params(key, cfg, 64, 128))(
        jax.random.PRNGKey(2)))
    tm = params_from_reference(mlp, device="cpu")
    np.testing.assert_allclose(
        t_layers.mlp_apply(tcfg, tm, _t(x)).numpy(),
        np.asarray(jax.jit(lambda m, x: r_layers.mlp_apply(cfg, m, x))(
            mlp, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("s,chunk", [(9, 512), (11, 4)])
def test_dense_attention_matches(s, chunk):
    cfg, tcfg = _cfgs(1)
    rng = np.random.default_rng(s)
    b, nq, nkv, h = 2, 4, 2, 16
    q = rng.standard_normal((b, s, nq, h)).astype(np.float32)
    k = rng.standard_normal((b, s, nkv, h)).astype(np.float32)
    v = rng.standard_normal((b, s, nkv, h)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    bias = np.asarray(jax.jit(lambda p: r_attn._window_bias(p, p, 0, True))(
        jnp.asarray(pos)))
    want = jax.jit(r_attn.gqa_attention, static_argnums=4)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias),
        jnp.float32)
    got = t_attn.gqa_attention(_t(q), _t(k), _t(v), _t(bias), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kf, vf = np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2)
    want = jax.jit(lambda *a: r_attn.chunked_mha(
        *a, 0, True, jnp.float32, chunk=chunk))(
        jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf), jnp.asarray(pos),
        jnp.asarray(pos))
    got = t_attn.chunked_mha(_t(q), _t(kf), _t(vf), _t(pos), _t(pos), 0,
                             True, torch.float32, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    p = _np(jax.jit(lambda key: r_attn.attn_params(key, cfg))(
        jax.random.PRNGKey(3)))
    x = rng.standard_normal((b, s, 64)).astype(np.float32)
    (want, (wk, wv)) = jax.jit(
        lambda p, x, pos: r_attn.full_attention(cfg, p, x, pos, 0))(
        p, jnp.asarray(x), jnp.asarray(pos))
    got, (gk, gv) = t_attn.full_attention(
        tcfg, params_from_reference(p, device="cpu"), _t(x), _t(pos), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)


@pytest.mark.parametrize("num_layers", [2, 4], ids=["list", "stacked"])
def test_lm_hidden_and_logits_match(num_layers):
    cfg, tcfg = _cfgs(num_layers)
    params = _np(jax.jit(LM(cfg).init)(jax.random.PRNGKey(0)))
    tparams = params_from_reference(params, device="cpu")
    # the port's own init draws the same tree (keys, nesting, shapes)
    own = TLM(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.structure(jax.tree.map(lambda a: a.shape, params)) == \
        jax.tree.structure(jax.tree.map(lambda a: tuple(a.shape), own))
    assert jax.tree.map(lambda a: a.shape, params) == \
        jax.tree.map(lambda a: tuple(a.shape), own)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13))
    pos = np.broadcast_to(np.arange(13, dtype=np.int32), (2, 13)).copy()
    rm, tm = LM(cfg), TLM(tcfg)
    rx = jax.jit(rm.embed)(params, {"tokens": jnp.asarray(toks)})
    tx = tm.embed(tparams, {"tokens": _t(toks)})
    rh, _, rc = jax.jit(lambda p, x, pos: rm.hidden(p, x, pos,
                                                     want_cache=True))(
        params, rx, jnp.asarray(pos))
    th, _, tc = tm.hidden(tparams, tx, _t(pos), want_cache=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(rh),
                               rtol=5e-5, atol=5e-5)
    if num_layers >= 4:
        np.testing.assert_allclose(tc[0]["k"].numpy(),
                                   np.asarray(rc[0]["k"]),
                                   rtol=5e-5, atol=5e-5)
    else:
        assert isinstance(tc[0], list) and len(tc[0]) == num_layers
        np.testing.assert_allclose(tc[0][1]["v"].numpy(),
                                   np.asarray(rc[0][1]["v"]),
                                   rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(tm.logits(tparams, th).numpy(),
                               np.asarray(jax.jit(rm.logits)(params, rh)),
                               rtol=5e-5, atol=5e-5)


def test_bf16_compute_lm_close():
    """bf16 compute, fp32 params (qwen2-0.5b's types) at smoke width: the
    two frameworks round bf16 at different places, so this holds the
    hidden state to bf16 resolution only."""
    cfg, tcfg = _cfgs(2, "bfloat16")
    params = _np(jax.jit(LM(cfg).init)(jax.random.PRNGKey(0)))
    tparams = params_from_reference(params, device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 9))
    pos = np.arange(9, dtype=np.int32)[None]
    rm, tm = LM(cfg), TLM(tcfg)
    rh, _, _ = jax.jit(lambda p, t, pos: rm.hidden(
        p, rm.embed(p, {"tokens": t}), pos))(params, jnp.asarray(toks),
                                             jnp.asarray(pos))
    th, _, _ = tm.hidden(tparams, tm.embed(tparams, {"tokens": _t(toks)}),
                         _t(pos))
    assert th.dtype == torch.bfloat16
    np.testing.assert_allclose(th.float().numpy(),
                               np.asarray(rh, np.float32),
                               rtol=5e-2, atol=5e-2)


# ``tests/test_models_smoke.py::test_param_counts_match_assignment``'s
# ranges for the headline sizes (the roofline's MODEL_FLOPS read them)
PARAM_RANGES = {
    "deepseek-v3-671b": (600e9, 760e9),
    "gemma3-27b": (23e9, 31e9),
    "internlm2-20b": (17e9, 23e9),
    "qwen2-0.5b": (0.4e9, 0.65e9),
    "gemma-2b": (2.0e9, 3.2e9),
    "qwen2-vl-7b": (6.5e9, 8.5e9),
    "hymba-1.5b": (1.1e9, 2.0e9),
    "xlstm-125m": (0.10e9, 0.20e9),
    "granite-moe-3b-a800m": (2.5e9, 3.9e9),
    "whisper-tiny": (0.025e9, 0.06e9),
}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_counts_match_assignment(arch):
    """``ModelConfig.param_counts()`` equals the reference's, every field,
    and its total lies in the reference case's range."""
    assert set(PARAM_RANGES) == set(registry.ARCH_IDS)
    ref = registry.get_config(arch).param_counts()
    port = t_registry.get_config(arch).param_counts()
    assert port == ref
    lo, hi = PARAM_RANGES[arch]
    assert lo <= port["total"] <= hi, (arch, port["total"])
