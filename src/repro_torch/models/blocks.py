"""Transformer blocks: per-layer params and the full-sequence forward body
(port of the dense part of ``repro.models.blocks``)."""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params


def layer_params(gen: torch.Generator, cfg: ModelConfig, kind: str,
                 device) -> Params:
    """Dense layer params: norm1, attn, norm2, mlp (the reference's tree)."""
    if kind != "dense":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP queue 1)")
    d = cfg.d_model
    return {"norm1": layers.norm_params(cfg, d, device),
            "attn": attention.attn_params(gen, cfg, device),
            "norm2": layers.norm_params(cfg, d, device),
            "mlp": layers.mlp_params(gen, cfg, d, cfg.d_ff, device)}


def layer_fwd(cfg: ModelConfig, kind: str, p: Params, x, positions,
              window: int, want_cache: bool = False,
              attn_impl: str | None = None):
    """Returns (x_out, aux_loss, cache_entry_or_None). ``attn_impl`` is
    ``full_attention``'s ``impl``."""
    if kind != "dense":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet (ROADMAP queue 1)")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(cfg, p["norm1"], x)
    a, kv = attention.full_attention(cfg, p["attn"], h, positions, window,
                                     impl=attn_impl)
    cache = {"k": kv[0], "v": kv[1]} if want_cache else None
    x = x + a
    h = layers.apply_norm(cfg, p["norm2"], x)
    x = x + layers.mlp_apply(cfg, p["mlp"], h)
    return x, aux, cache
