"""Transformer blocks: per-layer params, the full-sequence forward body and
the one-token decode body (port of ``repro.models.blocks``) for every kind:
``dense``, ``moe`` and ``moe_dense`` (MLA included), ``hybrid`` (hymba:
attention and a Mamba head in parallel), ``mlstm`` and ``slstm`` (xLSTM),
and whisper's ``enc`` and ``dec`` (``dec_layer_fwd``,
``dec_layer_decode``).

On DTensors every body runs as its modules lay it out (``models/
attention.py``, ``models/ssm.py``, ``layers.mlp_apply``): each
row-parallel output (attention's ``wo``, Mamba's ``out_proj``, the
mixers' ``down``, the MLP's ``w_down``) comes back with its partial sums
reduced into the stream's layout, so a hybrid layer norms its two heads'
outputs whole before it mixes them."""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params

KINDS = ("dense", "moe", "moe_dense", "hybrid", "mlstm", "slstm", "enc",
         "dec")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; known: {KINDS}")


def layer_params(gen: torch.Generator, cfg: ModelConfig, kind: str,
                 device) -> Params:
    """The reference's tree: norm1, then attn and norm2 (every kind but
    the xLSTM ones), then mlp (``dense``, ``hybrid``, ``enc``, ``dec``;
    the leading dense layers of an MoE model, ``moe_dense``, at
    ``moe.d_ff_dense``) or moe (``moe``); ``hybrid`` adds mamba, norm_a and
    norm_s, ``dec`` cross and norm3, ``mlstm``/``slstm`` a mixer."""
    _check_kind(kind)
    d = cfg.d_model
    p = {"norm1": layers.norm_params(cfg, d, device)}
    if kind in ("mlstm", "slstm"):
        mixer = ssm.mlstm_params if kind == "mlstm" else ssm.slstm_params
        p["mixer"] = mixer(gen, cfg, device)
        return p
    p["attn"] = attention.attn_params(gen, cfg, device)
    p["norm2"] = layers.norm_params(cfg, d, device)
    if kind == "moe":
        p["moe"] = moe.moe_params(gen, cfg, device)
        return p
    ff = cfg.moe.d_ff_dense if kind == "moe_dense" else cfg.d_ff
    p["mlp"] = layers.mlp_params(gen, cfg, d, ff, device)
    if kind == "hybrid":
        p["mamba"] = ssm.mamba_params(gen, cfg, device)
        p["norm_a"] = layers.norm_params(cfg, d, device)
        p["norm_s"] = layers.norm_params(cfg, d, device)
    elif kind == "dec":
        p["cross"] = attention.attn_params(gen, cfg, device)
        p["norm3"] = layers.norm_params(cfg, d, device)
    return p


def _self_attn(cfg: ModelConfig, p: Params, x, positions, window: int,
               want_cache: bool, attn_impl: str | None):
    h = layers.apply_norm(cfg, p["norm1"], x)
    if cfg.mla:
        out, kv = attention.mla_attention(cfg, p["attn"], h, positions,
                                          window)
        cache = {"ckv": kv[0], "kpe": kv[1]} if want_cache else None
    else:
        out, kv = attention.full_attention(cfg, p["attn"], h, positions,
                                           window, impl=attn_impl)
        cache = {"k": kv[0], "v": kv[1]} if want_cache else None
    return out, cache


def _hybrid_mix(cfg: ModelConfig, p: Params, x, a, s):
    """hymba's block after its two heads: the mean of the normed attention
    and SSM outputs added to the stream, then the MLP."""
    mixed = 0.5 * (layers.apply_norm(cfg, p["norm_a"], a)
                   + layers.apply_norm(cfg, p["norm_s"], s))
    x = x + mixed
    h = layers.apply_norm(cfg, p["norm2"], x)
    return x + layers.mlp_apply(cfg, p["mlp"], h)


def layer_fwd(cfg: ModelConfig, kind: str, p: Params, x, positions,
              window: int, want_cache: bool = False,
              attn_impl: str | None = None):
    """Returns (x_out, aux_loss, cache_entry_or_None). ``attn_impl`` is
    ``full_attention``'s ``impl`` for causal self-attention (MLA has no
    flash branch; the encoder's attention is not causal)."""
    _check_kind(kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    if kind in ("dense", "moe", "moe_dense"):
        a, cache = _self_attn(cfg, p, x, positions, window, want_cache,
                              attn_impl)
        x = x + a
        h = layers.apply_norm(cfg, p["norm2"], x)
        if kind == "moe":
            m, aux = moe.moe_apply(cfg, p["moe"], h)
        else:
            m = layers.mlp_apply(cfg, p["mlp"], h)
        return x + m, aux, cache
    h = layers.apply_norm(cfg, p["norm1"], x)
    if kind == "hybrid":
        a, kv = attention.full_attention(cfg, p["attn"], h, positions,
                                         window, impl=attn_impl)
        s = ssm.mamba_apply(cfg, p["mamba"], h)
        x = _hybrid_mix(cfg, p, x, a, s)
        if want_cache:
            cache = {"k": kv[0], "v": kv[1]}
    elif kind == "mlstm":
        x = x + ssm.mlstm_apply(cfg, p["mixer"], h)
    elif kind == "slstm":
        x = x + ssm.slstm_apply(cfg, p["mixer"], h)
    elif kind == "enc":
        a, _ = attention.full_attention(cfg, p["attn"], h, positions, 0,
                                        causal=False)
        x = x + a
        h = layers.apply_norm(cfg, p["norm2"], x)
        x = x + layers.mlp_apply(cfg, p["mlp"], h)
    else:
        raise ValueError(f"{kind!r} layers run through dec_layer_fwd")
    return x, aux, cache


def dec_layer_fwd(cfg: ModelConfig, p: Params, x, positions, enc_out,
                  enc_positions, want_cache: bool = False,
                  attn_impl: str | None = None):
    """Whisper's decoder layer: causal self-attention (``attn_impl`` as in
    ``layer_fwd``: the flash kernel on a card), cross-attention over
    ``enc_out`` at ``enc_positions``, then the MLP. Returns (x_out,
    {"k", "v", "ck", "cv"} or None)."""
    h = layers.apply_norm(cfg, p["norm1"], x)
    a, kv = attention.full_attention(cfg, p["attn"], h, positions, 0,
                                     impl=attn_impl)
    x = x + a
    h = layers.apply_norm(cfg, p["norm3"], x)
    c, ckv = attention.full_attention(cfg, p["cross"], h, positions, 0,
                                      causal=False, xkv=enc_out,
                                      kv_positions=enc_positions)
    x = x + c
    h = layers.apply_norm(cfg, p["norm2"], x)
    x = x + layers.mlp_apply(cfg, p["mlp"], h)
    cache = None
    if want_cache:
        cache = {"k": kv[0], "v": kv[1], "ck": ckv[0], "cv": ckv[1]}
    return x, cache


def layer_decode(cfg: ModelConfig, kind: str, p: Params, x, cache, position,
                 window: int):
    """One-token decode of a layer: x [B,1,d] and the layer's cache,
    written in place: ``attention.init_cache``'s (dense and MoE kinds),
    ``{"attn", "ssm"}`` (hybrid) or the mixer's state (mLSTM, sLSTM).
    Returns (x_out, cache)."""
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
    if kind in ("mlstm", "slstm"):
        step = (ssm.mlstm_decode_step if kind == "mlstm"
                else ssm.slstm_decode_step)
        o, _ = step(cfg, p["mixer"], h, cache)
        return x + o, cache
    if kind == "hybrid":
        a, _ = attention.decode_attention(cfg, p["attn"], h, cache["attn"],
                                          position, window)
        s, _ = ssm.mamba_decode_step(cfg, p["mamba"], h, cache["ssm"])
        return _hybrid_mix(cfg, p, x, a, s), cache
    if kind not in ("dense", "moe", "moe_dense"):
        raise ValueError(f"{kind!r} layers have no layer_decode (whisper's "
                         "decoder steps through dec_layer_decode)")
    if cfg.mla:
        a, cache = attention.mla_decode_attention(cfg, p["attn"], h, cache,
                                                  position, window)
    else:
        a, cache = attention.decode_attention(cfg, p["attn"], h, cache,
                                              position, window)
    x = x + a
    h = layers.apply_norm(cfg, p["norm2"], x)
    if kind == "moe":
        m, _ = moe.moe_apply(cfg, p["moe"], h)
    else:
        m = layers.mlp_apply(cfg, p["mlp"], h)
    return x + m, cache


def dec_layer_decode(cfg: ModelConfig, p: Params, x, cache, position):
    """Whisper's decoder step: the self-attention cache written in place,
    then cross-attention over the cached encoder K/V (``ck``, ``cv``; not
    written; ``attention.cross_decode_attention``). Returns (x_out,
    cache)."""
    h = layers.apply_norm(cfg, p["norm1"], x)
    a, _ = attention.decode_attention(cfg, p["attn"], h, cache, position, 0)
    x = x + a
    h = layers.apply_norm(cfg, p["norm3"], x)
    x = x + attention.cross_decode_attention(cfg, p["cross"], h, cache["ck"],
                                             cache["cv"])
    h = layers.apply_norm(cfg, p["norm2"], x)
    return x + layers.mlp_apply(cfg, p["mlp"], h), cache
