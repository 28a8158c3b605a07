"""repro_torch's dense decode (``attention.init_cache``/``decode_attention``,
``blocks.layer_decode``, ``LM.cache_capacity``/``init_cache``/
``decode_step``, ``registry.step_fn``'s decode branch) against the
reference's.

Both packages get the same params (drawn by the reference, crossing
through numpy) and the same seeded tokens. The reference's ``decode_step``
is jitted once per model, so each position runs the same compiled step
(the position is traced). Tolerances: fp32 1e-5 (both sides compute in
fp32 but sum in different orders, XLA:CPU vs ATen), bf16 0.05, the
reference's own for its bf16 decode test. Cache positions are held
exactly. The port writes its cache in place; the reference returns a new
one, so the two trees are compared after every step.
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
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import (cache_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import bits, port_config  # noqa: E402

DENSE = ["qwen2-0.5b", "gemma-2b", "internlm2-20b", "gemma3-27b"]
# the MoE (MLA and MTP included) and VLM families
FAMILIES = ["granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-vl-7b"]


def _tol(cfg) -> dict:
    t = 1e-5 if cfg.compute_dtype == "float32" else 0.05
    return dict(rtol=t, atol=t)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


class Pair:
    """One config on both packages: the reference's LM with its jitted
    decode step and params, the port's LM with the same params."""

    def __init__(self, cfg, seed: int):
        self.cfg = cfg
        self.rm = LM(cfg)
        self.params = jax.tree.map(
            np.asarray, jax.jit(self.rm.init)(jax.random.PRNGKey(seed)))
        self.step = jax.jit(self.rm.decode_step)
        self.tm = TLM(port_config(cfg))
        self.tparams = params_from_reference(self.params, device="cpu")

    def caches(self, b: int, cap: int):
        return (self.rm.init_cache(b, cap),
                self.tm.init_cache(b, cap, device="cpu"))

    def decode(self, tokens: np.ndarray, cap: int):
        """Decode ``tokens`` [B,S] position by position on both packages
        from empty caches of ``cap`` slots; the port's logits, cache
        positions and K/V must equal the reference's after every step.
        Returns (port logits [B,S,V], reference logits, port cache)."""
        b, s = tokens.shape
        rc, tc = self.caches(b, cap)
        assert_same_tree(tc, rc, self.cfg)
        got, want = [], []
        for t in range(s):
            tok = tokens[:, t:t + 1]
            rl, rc = self.step(self.params, rc, jnp.asarray(tok, jnp.int32),
                               jnp.int32(t))
            tl, tc2 = self.tm.decode_step(self.tparams, tc,
                                          torch.from_numpy(tok), t)
            assert tc2 is tc                       # written in place
            np.testing.assert_allclose(_f32(tl), _f32(rl), **_tol(self.cfg))
            assert_same_tree(tc, rc, self.cfg)
            got.append(_f32(tl)[:, 0])
            want.append(_f32(rl)[:, 0])
        return np.stack(got, 1), np.stack(want, 1), tc

    def full_logits(self, tokens: np.ndarray) -> np.ndarray:
        """The port's full-sequence logits (``LM.hidden`` + ``logits``)."""
        b, s = tokens.shape
        toks = torch.from_numpy(tokens)
        x = self.tm.embed(self.tparams, {"tokens": toks})
        pos = torch.arange(s, dtype=torch.int32).expand(b, s)
        h, _, _ = self.tm.hidden(self.tparams, x, pos)
        return _f32(self.tm.logits(self.tparams, h))


def assert_same_tree(tc, rc, cfg) -> None:
    """The port's cache has the reference's grouping (stacked dict or list
    of per-layer dicts), shapes and dtypes; ``pos`` equal, K/V within the
    tolerance."""
    shape = lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
    assert jax.tree.structure(jax.tree.map(shape, rc)) == \
        jax.tree.structure(jax.tree.map(shape, tc))
    assert jax.tree.leaves(jax.tree.map(shape, rc)) == \
        jax.tree.leaves(jax.tree.map(shape, tc))
    for path, r in jax.tree_util.tree_leaves_with_path(rc):
        t = tc
        for key in path:
            t = t[key.key if hasattr(key, "key") else key.idx]
        if path[-1].key == "pos":
            np.testing.assert_array_equal(t.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(_f32(t), _f32(r), **_tol(cfg))


_PAIRS: dict = {}


def pair(cfg, seed: int) -> Pair:
    """One ``Pair`` per (config, seed) in this process: the reference's
    init and decode compile once."""
    key = (cfg, seed)
    if key not in _PAIRS:
        _PAIRS[key] = Pair(cfg, seed)
    return _PAIRS[key]


def _smoke(arch: str, **kw):
    return dataclasses.replace(r_registry.get_smoke_config(arch), **kw)


@pytest.mark.parametrize("arch", DENSE + FAMILIES)
def test_smoke_decode_step(arch):
    """``test_models_smoke.py::test_smoke_decode_step``'s rows of the
    families the port builds on both packages: two steps of ones at
    positions 0 and 1 from an empty cache of 32 slots; shapes, finite
    logits, a cache that evolves, and the port's logits and caches equal to
    the reference's after each step (MLA's latent cache included)."""
    cfg = r_registry.get_smoke_config(arch)
    pr = pair(cfg, 2)
    b, cap = 2, 32
    got, want, tc = pr.decode(np.ones((b, 2), np.int64), cap)
    assert got.shape == (b, 2, cfg.vocab_size)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    fresh = pr.tm.init_cache(b, cap, device="cpu")
    assert not all(torch.equal(x, y) for x, y in
                   zip(jax.tree.leaves(tc), jax.tree.leaves(fresh)))
    # a group of >= 4 layers is stacked, a shorter one a list: the dense
    # and VLM smoke configs are one stacked group; deepseek's leading dense
    # layer is a list of one before its stacked MoE layers
    assert len(tc) == len(pr.tm.groups)
    for g, c in zip(pr.tm.groups, tc):
        if g.scanned:
            assert isinstance(c, dict) and c["pos"].shape[0] == len(g.indices)
        else:
            assert isinstance(c, list) and len(c) == len(g.indices)
    if arch in DENSE:
        assert isinstance(tc[0], dict) and \
            tc[0]["pos"].shape[0] == cfg.num_layers


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_matches_prefill_qwen2(dtype):
    """``test_models_smoke.py::test_decode_matches_prefill_qwen2`` on both
    packages: token-by-token decode logits match the full forward's at
    every position (0.05, the reference's own bound), and the port's decode
    logits equal the reference's at every position."""
    cfg = _smoke("qwen2-0.5b", compute_dtype=dtype)
    pr = pair(cfg, 4)
    b, s = 2, 8
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, s))
    got, want, _ = pr.decode(tokens, s)
    rx = pr.rm.embed(pr.params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    rpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    rh, _, _ = jax.jit(pr.rm.hidden)(pr.params, rx, rpos)
    full_ref = _f32(pr.rm.logits(pr.params, rh))
    full = pr.full_logits(tokens)
    for dec, ful in ((want, full_ref), (got, full)):
        np.testing.assert_allclose(ful, dec, rtol=0.05, atol=0.05)
    np.testing.assert_allclose(full, full_ref, **_tol(cfg))


def test_sliding_window_mask_effective():
    """``test_models_smoke.py::test_sliding_window_mask_effective`` on both
    packages: in a 1-layer all-windowed gemma3 variant (window 4) a token
    outside the window does not move the last logits, through the full
    forward and through decode; the decode runs past the window, so its
    ring buffer of 4 slots wraps, and its logits and caches equal the
    reference's at every step."""
    cfg = _smoke("gemma3-27b", global_every=0, sliding_window=4,
                 num_layers=1, compute_dtype="float32")
    pr = pair(cfg, 6)
    assert pr.tm.cache_capacity(0, 12) == 4
    rng = np.random.default_rng(2)
    t1 = rng.integers(1, cfg.vocab_size, (1, 12))
    t2 = t1.copy()
    t2[0, 0] = (t2[0, 0] + 7) % cfg.vocab_size     # a far-past token
    full1, full2 = pr.full_logits(t1), pr.full_logits(t2)
    np.testing.assert_allclose(full1[:, -1], full2[:, -1], rtol=1e-4,
                               atol=1e-4)
    assert np.abs(full1[:, 0] - full2[:, 0]).max() > 1e-3
    dec1, _, tc = pr.decode(t1, 12)
    dec2, _, _ = pr.decode(t2, 12)
    assert tc[0][0]["k"].shape[1] == 4            # a list group, 4 slots
    np.testing.assert_array_equal(tc[0][0]["pos"].numpy(), [[8, 9, 10, 11]])
    np.testing.assert_allclose(dec1[:, -1], dec2[:, -1], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(dec1, full1, rtol=1e-4, atol=1e-4)


# (layers, global_every, window): all-windowed groups are ring buffers of
# ``window`` slots; a group that mixes windowed and global layers holds
# ``max_len`` slots and applies the window through the mask
WINDOWED = {
    "ring-list": (2, 0, 4),
    "ring-stacked": (4, 0, 4),
    "mixed-list": (2, 2, 4),
    "mixed-stacked": (6, 3, 4),
}


@pytest.mark.parametrize("variant", list(WINDOWED))
def test_windowed_decode_matches_reference(variant):
    """Windowed gemma3 variants in both layouts (a list group of 2 layers,
    a stacked group of >= 4), decoding 12 tokens past a window of 4: the
    port's logits and caches equal the reference's after every step, and
    its decode logits equal its full forward's at every position."""
    layers, every, window = WINDOWED[variant]
    cfg = _smoke("gemma3-27b", num_layers=layers, global_every=every,
                 sliding_window=window, compute_dtype="float32")
    pr = pair(cfg, 7)
    s = 12
    ring = variant.startswith("ring")
    assert max(pr.tm.cache_capacity(i, s) for i in range(layers)) == \
        (window if ring else s)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, s))
    got, _, tc = pr.decode(tokens, s)
    stacked = layers >= 4
    assert isinstance(tc[0], dict) == stacked
    pos = tc[0]["pos"][0] if stacked else tc[0][0]["pos"]
    assert pos.shape[-1] == (window if ring else s)
    np.testing.assert_allclose(got, pr.full_logits(tokens), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [16, 4], ids=["linear", "ring"])
def test_decode_attention_from_reference_cache(cap, dtype):
    """``decode_attention`` fed the reference's cache mid-sequence (crossed
    through ``cache_from_reference``, bit for bit) gives the reference's
    output and next cache, at a position past the ring's capacity."""
    cfg = _smoke("gemma3-27b", compute_dtype=dtype)
    tcfg = port_config(cfg)
    p = jax.tree.map(np.asarray, jax.jit(
        lambda key: r_attn.attn_params(key, cfg))(jax.random.PRNGKey(8)))
    tp = params_from_reference(p, device="cpu")
    rng = np.random.default_rng(9)
    xs = rng.standard_normal((10, 2, 1, cfg.d_model)).astype(np.float32)
    step = jax.jit(lambda p, x, c, t: r_attn.decode_attention(
        cfg, p, x, c, t, 4))
    rc = r_attn.init_cache(cfg, 2, cap)
    for t in range(9):
        _, rc = step(p, jnp.asarray(xs[t]), rc, jnp.int32(t))
    tc = cache_from_reference(jax.tree.map(np.asarray, rc), device="cpu")
    for name in ("k", "v", "pos"):
        assert np.array_equal(bits(tc[name]), bits(rc[name]))
    want, rc = step(p, jnp.asarray(xs[9]), rc, jnp.int32(9))
    got, tc2 = t_attn.decode_attention(
        tcfg, tp, torch.from_numpy(xs[9]), tc, torch.tensor(9), 4)
    assert tc2 is tc
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(cfg))
    assert_same_tree(tc, rc, cfg)
    assert tc["pos"][0].tolist() == (list(range(10)) + [-1] * 6 if cap == 16
                                     else [8, 9, 6, 7])


def test_step_fn_decode_runs():
    """``registry.step_fn(cfg, SHAPES["decode_32k"])`` decodes one token on
    a smoke config (a small cache stands in for 32k slots): the logits and
    cache equal the reference's decode step's."""
    cfg = r_registry.get_smoke_config("qwen2-0.5b")
    pr = pair(cfg, 2)
    tcfg = pr.tm.cfg
    for name in ("decode_32k", "long_500k"):
        assert t_registry.SHAPES[name].kind == "decode"
        dec = t_registry.step_fn(tcfg, t_registry.SHAPES[name], pr.tm)
        rdec = jax.jit(r_registry.step_fn(cfg, r_registry.SHAPES[name],
                                          pr.rm))
        rc, tc = pr.caches(2, 16)
        toks = np.full((2, 1), 5)
        want, rc = rdec(pr.params, {"cache": rc,
                                    "tokens": jnp.asarray(toks, jnp.int32),
                                    "position": jnp.int32(3)})
        got, tc = dec(pr.tparams, {"cache": tc,
                                   "tokens": torch.from_numpy(toks),
                                   "position": torch.tensor(3)})
        assert got.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(cfg))
        assert_same_tree(tc, rc, cfg)


def test_init_cache_mirrors_reference():
    """Capacity per group is the reference's rule on the full-size configs
    too: gemma3-27b's one group of 62 layers (global every 6th) holds
    ``max_len`` slots, and ``init_cache`` refuses no dense config."""
    for arch in DENSE:
        cfg = r_registry.get_config(arch)
        rm, tm = LM(cfg), TLM(port_config(cfg))
        for i in range(cfg.num_layers):
            for n in (8, 1024, 2048):
                assert tm.cache_capacity(i, n) == rm.cache_capacity(i, n)
    g3 = TLM(t_registry.get_config("gemma3-27b"))
    assert [g.scanned for g in g3.groups] == [True]
    assert max(g3.cache_capacity(i, 2048) for i in range(62)) == 2048
    small = _smoke("gemma3-27b", num_layers=2, compute_dtype="float32")
    want = jax.eval_shape(lambda: LM(small).init_cache(3, 40))
    got = TLM(port_config(small)).init_cache(3, 40, device="cpu")
    assert [[{k: (tuple(v.shape), str(v.dtype)) for k, v in c.items()}
             for c in g] for g in want] == \
        [[{k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in c.items()} for c in g] for g in got]
    assert all(bool((c["pos"] == -1).all()) for c in got[0])
