"""Attention: GQA/MQA, sliding windows, M-RoPE, MLA (DeepSeek) and the KV
caches (port of ``repro.models.attention``).

The full-sequence reference path (``chunked_mha``), the grouped decode
einsum (``gqa_attention``), ``full_attention``, whose causal attention
goes through the flash-attention op (on a card the hand-written CUDA
kernel, ``kernels/flash_attention``, the counterpart of the reference's
Pallas route ``impl="flash"``), and the dense KV cache with one-token
decode (``init_cache``, ``decode_attention``), in plain torch as the
reference's is plain jnp. Under M-RoPE (qwen2-vl) q and k rotate with
``layers.apply_mrope`` over ``[3, B, S]`` positions and the mask reads
stream 1, as the reference's.

MLA keeps a latent cache (``{"ckv", "kpe", "pos"}``): ``mla_attention``
materialises per-head K/V and runs ``chunked_mha``, and
``mla_decode_attention`` attends in the latent space with the K and V
up-projections absorbed. Both are plain torch, as the reference's are plain
jnp outside any Pallas kernel; MLA's q/k head dim (192) differs from its v
head dim (128), which the flash kernel does not take.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import dtype_of, resolve
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense_init

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def attn_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = dtype_of(cfg.param_dtype)
    d, hd = cfg.d_model, cfg.head_dim_
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    if cfg.mla:
        m = cfg.mla
        return {
            "wq_a": dense_init(gen, d, m.q_lora_rank, dt, device),
            "q_norm": torch.zeros((m.q_lora_rank,), dtype=dt, device=device),
            "wq_b": dense_init(gen, m.q_lora_rank,
                               nq * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                               dt, device),
            "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                                dt, device),
            "kv_norm": torch.zeros((m.kv_lora_rank,), dtype=dt,
                                   device=device),
            "wkv_b": dense_init(gen, m.kv_lora_rank,
                                nq * (m.qk_nope_head_dim + m.v_head_dim), dt,
                                device),
            "wo": dense_init(gen, nq * m.v_head_dim, d, dt, device),
        }
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


def init_cache(cfg: ModelConfig, batch: int, capacity: int, layer_axes=(),
               *, device="cuda") -> Params:
    """KV cache on ``device``: ``k`` and ``v`` [*layer_axes, B, cap, nkv,
    hd] in the compute dtype, ``pos`` [*layer_axes, B, cap] int32; under
    MLA the latent ``ckv`` [..., cap, kv_lora_rank] and the rotated key
    part ``kpe`` [..., cap, qk_rope_head_dim] instead of ``k`` and ``v``.

    ``pos`` records the absolute position held by each slot (-1 = empty),
    so a linear cache and a ring buffer (capacity = window) share one
    path."""
    dev = resolve(device)
    cdt = dtype_of(cfg.compute_dtype)
    shape = tuple(layer_axes) + (batch, capacity)
    if cfg.mla:
        m = cfg.mla
        return {"ckv": torch.zeros(shape + (m.kv_lora_rank,), dtype=cdt,
                                   device=dev),
                "kpe": torch.zeros(shape + (m.qk_rope_head_dim,), dtype=cdt,
                                   device=dev),
                "pos": torch.full(shape, -1, dtype=torch.int32, device=dev)}
    kv = shape + (cfg.num_kv_heads, cfg.head_dim_)
    return {"k": torch.zeros(kv, dtype=cdt, device=dev),
            "v": torch.zeros(kv, dtype=cdt, device=dev),
            "pos": torch.full(shape, -1, dtype=torch.int32, device=dev)}


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


def takes_flash(impl: str | None, x, causal: bool = True) -> bool:
    """Whether ``full_attention`` runs causal attention on ``x`` through the
    flash branch under ``impl``."""
    if impl not in (None, "flash", "reference"):
        raise ValueError(f"unknown impl {impl!r}: None, 'flash' or "
                         "'reference'")
    return causal and (impl == "flash" or (impl is None and x.is_cuda))


def full_attention(cfg: ModelConfig, p: Params, x, positions, window: int,
                   impl: str | None = None, causal: bool = True):
    """Full-sequence self-attention (train / prefill).

    ``impl`` picks the branch of causal attention: ``None`` takes the flash
    branch on a CUDA tensor (the CUDA kernel) and the chunked reference
    branch on the CPU; ``"flash"`` takes the flash branch on any device (on
    the CPU that is the kernel's plain version); ``"reference"`` takes the
    chunked branch. The CUDA kernel has no backward: a backward through it
    raises, so training on a card passes ``"reference"``, the reference's
    own default. Non-causal attention always takes the chunked branch, as
    in the reference. The flash branch masks by sequence index: it assumes
    ``positions`` is ``arange(S)`` per row (under M-RoPE, in every
    stream), as the reference's does; ``LM`` refuses caller-given M-RoPE
    positions on that branch.

    ``positions`` is [B,S], or [3,B,S] under M-RoPE (the mask reads stream
    1, the temporal one, as the reference's). Returns (out [B,S,d],
    (k, v)) with k/v [B,S,nkv,hd] for cache priming.
    """
    flash = takes_flash(impl, x, causal)
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
    if cfg.use_rope and cfg.mrope:
        q = layers.apply_mrope(q, positions, cfg.rope_theta,
                               cfg.mrope_sections)
        k = layers.apply_mrope(k, positions, cfg.rope_theta,
                               cfg.mrope_sections)
    elif cfg.use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    pos1 = positions[1] if cfg.mrope else positions   # temporal stream masks
    if flash:
        out = flash_ops.flash_attention(q, k, v, window=int(window))
    else:
        # repeat KV to full query heads, as the reference does
        g = nq // nkv
        kf = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
        vf = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
        out = chunked_mha(q, kf, vf, pos1, pos1, int(window), causal, cdt,
                          scores_dtype=dtype_of(cfg.attn_scores_dtype))
    out = out.reshape(b, s, nq * hd) @ p["wo"].to(cdt)
    return out, (k, v)


def decode_attention(cfg: ModelConfig, p: Params, x, cache, position,
                     window: int):
    """One-token decode with cache append. x [B,1,d]; ``position`` a Python
    int or a 0-d integer tensor on the cache's device (nothing here reads
    it back to the host).

    The new K/V and its position are written in place at slot ``position
    % capacity`` (``index_copy_``), and ``cache`` itself is returned. The
    mask comes from the per-slot absolute positions only, so a linear
    cache and a ring buffer share one path. Under M-RoPE the position is
    broadcast to all three streams, as the reference's. Returns (out
    [B,1,d], cache).
    """
    cdt = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    cpos = cache["pos"]
    position = torch.as_tensor(position, dtype=torch.int32,
                               device=cpos.device)
    slot = (position % cpos.shape[-1]).reshape(1).long()
    pos_b = position.reshape(1, 1).expand(b, 1)

    x = x.to(cdt)
    q = x @ p["wq"].to(cdt)
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(b, 1, nq, hd)
    k = k.reshape(b, 1, nkv, hd)
    v = v.reshape(b, 1, nkv, hd)
    if cfg.mrope:
        p3 = pos_b[None].expand(3, b, 1)
        q = layers.apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k = layers.apply_mrope(k, p3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.use_rope:
        q = layers.apply_rope(q, pos_b, cfg.rope_theta)
        k = layers.apply_rope(k, pos_b, cfg.rope_theta)

    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    cpos.index_copy_(1, slot, pos_b)
    bias = _window_bias(pos_b, cpos, int(window), causal=True)
    out = gqa_attention(q, cache["k"], cache["v"], bias, cdt)
    out = out.reshape(b, 1, nq * hd) @ p["wo"].to(cdt)
    return out, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): compressed-latent attention
# ---------------------------------------------------------------------------

def _mla_qkv(cfg: ModelConfig, p: Params, x, positions):
    """(q_nope, q_pe [B,S,nq,*], ckv [B,S,r], k_pe [B,S,rope]): q and the
    latent K/V from x [B,S,d], the rope parts rotated at ``positions``."""
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nq = cfg.num_heads
    x = x.to(cdt)
    cq = layers.rmsnorm(x @ p["wq_a"].to(cdt), p["q_norm"], cfg.rms_eps)
    q = (cq @ p["wq_b"].to(cdt)).reshape(
        b, s, nq, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = layers.apply_rope(q_pe, positions, cfg.rope_theta)

    kv = x @ p["wkv_a"].to(cdt)
    ckv, k_pe = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    ckv = layers.rmsnorm(ckv, p["kv_norm"], cfg.rms_eps)
    k_pe = layers.apply_rope(k_pe[:, :, None, :], positions,
                             cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_pe, ckv, k_pe


def mla_attention(cfg: ModelConfig, p: Params, x, positions, window: int):
    """Training / prefill MLA: per-head K/V materialised from the latent,
    then the q-chunked reference path (its scale is the concatenated
    [nope ; rope] head dim's). Returns (out [B,S,d], (ckv, k_pe)) for cache
    priming."""
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nq = cfg.num_heads
    q_nope, q_pe, ckv, k_pe = _mla_qkv(cfg, p, x, positions)
    kvb = (ckv @ p["wkv_b"].to(cdt)).reshape(
        b, s, nq, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kvb[..., :m.qk_nope_head_dim], kvb[..., m.qk_nope_head_dim:]
    q_full = torch.cat([q_nope, q_pe], dim=-1)
    k_full = torch.cat(
        [k_nope, k_pe[:, :, None, :].expand(b, s, nq, m.qk_rope_head_dim)],
        dim=-1)
    out = chunked_mha(q_full, k_full, v, positions, positions, int(window),
                      True, cdt, scores_dtype=dtype_of(cfg.attn_scores_dtype))
    out = out.reshape(b, s, nq * m.v_head_dim) @ p["wo"].to(cdt)
    return out, (ckv, k_pe)


def mla_decode_attention(cfg: ModelConfig, p: Params, x, cache, position,
                         window: int):
    """Absorbed-matrix MLA decode: attention runs in the latent space, so a
    step costs O(S * kv_lora_rank) and the cache holds only the latent
    (arXiv:2412.19437 §2.1). x [B,1,d]; ``position`` as in
    ``decode_attention``; the new latent, rope key and position are written
    in place at slot ``position % capacity``. Returns (out [B,1,d],
    cache)."""
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    nq = cfg.num_heads
    cpos = cache["pos"]
    position = torch.as_tensor(position, dtype=torch.int32,
                               device=cpos.device)
    slot = (position % cpos.shape[-1]).reshape(1).long()
    pos_b = position.reshape(1, 1).expand(b, 1)

    q_nope, q_pe, ckv_new, kpe_new = _mla_qkv(cfg, p, x, pos_b)
    cache["ckv"].index_copy_(1, slot, ckv_new)
    cache["kpe"].index_copy_(1, slot, kpe_new)
    cpos.index_copy_(1, slot, pos_b)
    ckv, kpe = cache["ckv"], cache["kpe"]

    wkv_b = p["wkv_b"].to(cdt).reshape(
        m.kv_lora_rank, nq, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wkv_b[:, :, :m.qk_nope_head_dim]          # [r, n, hk]
    w_uv = wkv_b[:, :, m.qk_nope_head_dim:]          # [r, n, hv]
    # the K up-projection absorbed into the query
    q_lat = torch.einsum("bsnh,rnh->bsnr", q_nope, w_uk)       # [b,1,n,r]
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = (torch.einsum("bsnr,btr->bnst", q_lat.float(), ckv.float())
              + torch.einsum("bsnh,bth->bnst", q_pe.float(),
                             kpe.float())) * scale
    bias = _window_bias(pos_b, cpos, int(window), causal=True)
    probs = torch.softmax(scores + bias[:, None], dim=-1).to(cdt)
    out_lat = torch.einsum("bnst,btr->bsnr", probs, ckv)       # [b,1,n,r]
    out = torch.einsum("bsnr,rnh->bsnh", out_lat, w_uv)
    out = out.reshape(b, 1, nq * m.v_head_dim) @ p["wo"].to(cdt)
    return out, cache
