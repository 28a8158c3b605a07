"""Dense GQA attention (port of the dense part of ``repro.models.attention``).

The full-sequence reference path (``chunked_mha``) and the grouped decode
einsum (``gqa_attention``) on plain tensors. MLA and the Pallas flash
route (``impl="flash"``) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import dtype_of
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense_init

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def attn_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    assert cfg.mla is None, "MLA attention is not ported yet"
    dt = dtype_of(cfg.param_dtype)
    d, hd = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": dense_init(gen, d, nq * hd, dt, device),
        "wk": dense_init(gen, d, nkv * hd, dt, device),
        "wv": dense_init(gen, d, nkv * hd, dt, device),
        "wo": dense_init(gen, nq * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dt, device=device)
    return p


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------

def _window_bias(q_pos, k_pos, window: int, causal: bool):
    """[..., S_q, S_k] additive fp32 bias from absolute positions; window 0
    means full attention."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = dk >= 0
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dq - dk < window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)


# ---------------------------------------------------------------------------
# Core GQA attention (reference)
# ---------------------------------------------------------------------------

def gqa_attention(q, k, v, bias, compute_dtype):
    """q [B,Sq,nq,h], k/v [B,Sk,nkv,h], bias [B,Sq,Sk] -> [B,Sq,nq,h].

    KV heads are not repeated per query head: the einsum groups query heads
    over their shared KV head."""
    b, sq, nq, h = q.shape
    nkv = k.shape[2]
    g = nq // nkv
    q = q.reshape(b, sq, nkv, g, h)
    scores = torch.einsum("bsngh,btnh->bngst", q.float(), k.float())
    scores = scores / np.sqrt(h) + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    out = torch.einsum("bngst,btnh->bsngh", probs, v.to(compute_dtype))
    return out.reshape(b, sq, nq, h)


def attn_q_chunks(seq: int, chunk: int = 512) -> int:
    """Number of query chunks the full-sequence reference path uses."""
    if seq <= chunk:
        return 1
    return -(-seq // chunk)


def chunked_mha(q, k, v, qpos, kpos, window: int, causal: bool,
                compute_dtype, chunk: int = 512,
                scores_dtype=torch.float32):
    """Full-sequence attention, chunked over queries: the live score buffer
    is [B, nq, chunk, S_kv] instead of [B, nq, S, S]. q/k/v are head-aligned
    ([B,S,n,h] with identical head counts)."""
    s = q.shape[1]
    nc = attn_q_chunks(s, chunk)
    outs = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        bias = _window_bias(qpos[:, sl], kpos, window, causal)
        outs.append(_mha_one_chunk(q[:, sl], k, v, bias, compute_dtype,
                                   scores_dtype))
    return outs[0] if nc == 1 else torch.cat(outs, dim=1)


def _mha_one_chunk(q, k, v, bias, compute_dtype,
                   scores_dtype=torch.float32):
    """q [B,c,n,h], k/v [B,T,n,h], bias [B,c,T] -> [B,c,n,h]; scores are
    accumulated in fp32."""
    h = q.shape[-1]
    scores = torch.einsum("bsnh,btnh->bnst", q.float(), k.float())
    scores = (scores / np.sqrt(h)).to(scores_dtype)
    scores = scores + bias[:, None, :, :].to(scores_dtype)
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    return torch.einsum("bnst,btnh->bsnh", probs, v)


def full_attention(cfg: ModelConfig, p: Params, x, positions, window: int,
                   impl: str = "reference", causal: bool = True):
    """Full-sequence self-attention (train / prefill), reference branch.

    Returns (out [B,S,d], (k, v)) with k/v [B,S,nkv,hd] for cache priming.
    """
    if impl != "reference":
        raise NotImplementedError(
            "full_attention(impl='flash') waits for the flash-attention "
            "kernel port (ROADMAP queue 2)")
    assert not cfg.mrope, "M-RoPE is not ported yet"
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    x = x.to(cdt)
    q = x @ p["wq"].to(cdt)
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    # repeat KV to full query heads, as the reference does
    g = nq // nkv
    kf = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
    vf = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
    out = chunked_mha(q, kf, vf, positions, positions, int(window), causal,
                      cdt, scores_dtype=dtype_of(cfg.attn_scores_dtype))
    out = out.reshape(b, s, nq * hd) @ p["wo"].to(cdt)
    return out, (k, v)
