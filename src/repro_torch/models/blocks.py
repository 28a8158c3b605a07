"""Transformer blocks: per-layer params, the full-sequence forward body and
the one-token decode body (port of ``repro.models.blocks`` for the kinds
``dense``, ``moe`` and ``moe_dense``, MLA included). The hybrid, xLSTM and
encoder-decoder kinds are not ported yet (ROADMAP queue 1 item 9c)."""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers, moe
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params

KINDS = ("dense", "moe", "moe_dense")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP queue 1 item "
            "9c)")


def layer_params(gen: torch.Generator, cfg: ModelConfig, kind: str,
                 device) -> Params:
    """The reference's tree: norm1, attn, norm2, then mlp (``dense``; the
    leading dense layers of an MoE model, ``moe_dense``, at
    ``moe.d_ff_dense``) or moe (``moe``)."""
    _check_kind(kind)
    d = cfg.d_model
    p = {"norm1": layers.norm_params(cfg, d, device),
         "attn": attention.attn_params(gen, cfg, device),
         "norm2": layers.norm_params(cfg, d, device)}
    if kind == "dense":
        p["mlp"] = layers.mlp_params(gen, cfg, d, cfg.d_ff, device)
    elif kind == "moe":
        p["moe"] = moe.moe_params(gen, cfg, device)
    else:
        p["mlp"] = layers.mlp_params(gen, cfg, d, cfg.moe.d_ff_dense, device)
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


def layer_fwd(cfg: ModelConfig, kind: str, p: Params, x, positions,
              window: int, want_cache: bool = False,
              attn_impl: str | None = None):
    """Returns (x_out, aux_loss, cache_entry_or_None). ``attn_impl`` is
    ``full_attention``'s ``impl`` (MLA has no flash branch)."""
    _check_kind(kind)
    a, cache = _self_attn(cfg, p, x, positions, window, want_cache,
                          attn_impl)
    x = x + a
    h = layers.apply_norm(cfg, p["norm2"], x)
    if kind == "moe":
        m, aux = moe.moe_apply(cfg, p["moe"], h)
    else:
        m = layers.mlp_apply(cfg, p["mlp"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + m, aux, cache


def layer_decode(cfg: ModelConfig, kind: str, p: Params, x, cache, position,
                 window: int):
    """One-token decode of a layer: x [B,1,d] and the layer's cache
    (``attention.init_cache``), written in place. Returns (x_out, cache)."""
    _check_kind(kind)
    h = layers.apply_norm(cfg, p["norm1"], x)
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
