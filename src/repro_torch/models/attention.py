"""Attention: GQA/MQA, sliding windows, M-RoPE, MLA (DeepSeek) and the KV
caches (port of ``repro.models.attention``).

The full-sequence reference path (``chunked_mha``), the grouped decode
einsum (``gqa_attention``), ``full_attention``, whose causal attention
goes through the flash-attention op (on a card the hand-written CUDA
kernel, ``kernels/flash_attention``, the counterpart of the reference's
Pallas route ``impl="flash"``) and whose non-causal attention (whisper's
encoder, and its cross-attention over ``xkv``) takes the chunked path, as
the reference's, and the dense KV cache with one-token
decode (``init_cache``, ``decode_attention``), in plain torch as the
reference's is plain jnp. Under M-RoPE (qwen2-vl) q and k rotate with
``layers.apply_mrope`` over ``[3, B, S]`` positions and the mask reads
stream 1, as the reference's.

On DTensor params and activations (``sharding/dtensor.py``) attention is
tensor parallel over the model axis where the reference's rules shard the
heads (``sharding/specs.py``: ``heads_ok``, ``kv_ok``): q/k/v come out of
column-parallel products with each rank's heads, the attention itself
(the chunked path, or the flash kernel on a card) runs on each rank's own
heads and batch rows (``dtensor.on_shards``), and ``wo``'s partial sums are
reduced into the input's layout. Where the heads do not divide the model
axis the weights are replicated and attention is parallel over the batch
only, as in the reference. MLA's prefill runs so on each rank's heads.

Decode on DTensors keeps each cache leaf in the reference's
``cache_leaf_spec`` layout: K/V split over the batch and the KV heads, or
over the capacity where the heads do not divide; MLA's latent split over
the batch and the capacity. The new slot is written on the ranks that own
it (``dtensor.write_slot``); each rank attends over its own slots, in its
leaf's layout (the queries and the int32 ``pos`` leaf move to it, never K,
V or the latent), and where the capacity is split the softmax is merged
across those ranks (``dtensor.split_softmax``). A ring buffer (capacity =
window) wraps on a split capacity as on one device.

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
from repro_torch.sharding import dtensor as dtn

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

def _window_ok(q_pos, k_pos, window: int, causal: bool):
    """[..., S_q, S_k] bool: which keys each query sees, from absolute
    positions (a key at a negative position is an empty slot); window 0
    means full attention."""
    dq = q_pos[..., :, None]
    dk = k_pos[..., None, :]
    ok = dk >= 0
    if causal:
        ok = ok & (dk <= dq)
    if window > 0:
        ok = ok & (dq - dk < window)
    return ok


def _window_bias(q_pos, k_pos, window: int, causal: bool):
    """[..., S_q, S_k] additive fp32 bias of ``_window_ok``."""
    ok = _window_ok(q_pos, k_pos, window, causal)
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


#: the reference unrolls up to this many query chunks and runs a
#: ``lax.scan`` beyond, to bound the compiled program's size; eager torch
#: has no compile step and loops over every chunk either way
CHUNK_SCAN_THRESHOLD = 4


def chunked_mha(q, k, v, qpos, kpos, window: int, causal: bool,
                compute_dtype, chunk: int = 512,
                scores_dtype=torch.float32):
    """Full-sequence attention, chunked over queries: the live score buffer
    is [B, nq, chunk, S_kv] instead of [B, nq, S, S]. q/k/v are head-aligned
    ([B,S,n,h] with identical head counts). Past one chunk, each chunk is
    rematerialised while autograd records, as the reference's
    ``jax.checkpoint``: the backward recomputes its [c, S] score tile
    instead of keeping every chunk's scores live."""
    s = q.shape[1]
    nc = attn_q_chunks(s, chunk)
    if nc == 1:
        return _chunk_with_bias(q, qpos, k, v, kpos, window, causal,
                                compute_dtype, scores_dtype)
    outs = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        outs.append(layers.checkpointed(
            _chunk_with_bias, q[:, sl], qpos[:, sl], k, v, kpos, window,
            causal, compute_dtype, scores_dtype))
    return torch.cat(outs, dim=1)


def _chunk_with_bias(q, qpos, k, v, kpos, window, causal, compute_dtype,
                     scores_dtype=torch.float32):
    bias = _window_bias(qpos, kpos, window, causal)
    return _mha_one_chunk(q, k, v, bias, compute_dtype, scores_dtype)


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
                   impl: str | None = None, causal: bool = True,
                   kv_positions=None, xkv=None):
    """Full-sequence attention (train / prefill / encoder / cross).

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
    1, the temporal one, as the reference's). ``xkv`` [B,T,d] is the source
    of K and V (cross-attention; default ``x``) at ``kv_positions``
    (default ``positions``); rotary embeddings apply to self-attention
    only (causal, or ``xkv`` is ``x``), as the reference's. Returns (out
    [B,S,d], (k, v)) with k/v [B,T,nkv,hd] for cache priming.
    """
    flash = takes_flash(impl, x, causal)
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    self_attn = xkv is None or xkv is x
    xkv = x if xkv is None else xkv
    kv_positions = positions if kv_positions is None else kv_positions
    x_in = x
    x = dtn.whole_on(x.to(cdt))           # column-parallel inputs
    xkv = x if self_attn else dtn.whole_on(xkv.to(cdt))
    with layers.checkpoint_name("qkv"):
        q = x @ p["wq"].to(cdt)
        k = xkv @ p["wk"].to(cdt)
        v = xkv @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    t = xkv.shape[1]
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, t, nkv, hd)
    v = v.reshape(b, t, nkv, hd)
    if cfg.use_rope and (causal or self_attn):
        if cfg.mrope:
            q = layers.apply_mrope(q, positions, cfg.rope_theta,
                                   cfg.mrope_sections)
            k = layers.apply_mrope(k, kv_positions, cfg.rope_theta,
                                   cfg.mrope_sections)
        else:
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, kv_positions, cfg.rope_theta)
    pos1 = positions[1] if cfg.mrope else positions   # temporal stream masks
    kpos1 = kv_positions[1] if cfg.mrope else kv_positions
    scores_dtype = dtype_of(cfg.attn_scores_dtype)

    def attend(q, k, v, pos1, kpos1):
        """Attention over the heads of ``q`` (all of them, or this rank's
        block of ``nq // n`` heads: K/V then hold the block's KV heads or
        all of them)."""
        g = nq // nkv
        if k.shape[2] * g != q.shape[2]:      # whole K/V, a block of q
            h0 = dtn.local_rank(x.device_mesh, "model") * q.shape[2]
            k = torch.repeat_interleave(k, g, dim=2)[:, :, h0:h0 + q.shape[2]]
            v = torch.repeat_interleave(v, g, dim=2)[:, :, h0:h0 + q.shape[2]]
            g = 1
        if flash:
            return flash_ops.flash_attention(q, k, v, window=int(window))
        # repeat KV to full query heads, as the reference does
        kf = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
        vf = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
        return chunked_mha(q, kf, vf, pos1, kpos1, int(window), causal, cdt,
                           scores_dtype=scores_dtype)
    if dtn.is_dt(q):
        out = dtn.on_shards(attend, q.placements, q, k, v, pos1, kpos1)
    else:
        out = attend(q, k, v, pos1, kpos1)
    out = layers.row_parallel(out.reshape(b, s, nq * hd), p["wo"].to(cdt))
    return layers.tp_out(out, x_in).to(cdt), (k, v)


def as_position(position, like):
    """``position`` as a 0-d int32 tensor on ``like``'s device: a Python
    int, a 0-d tensor, or a replicated 0-d DTensor (its local tensor);
    nothing is read back to the host."""
    if dtn.is_dt(position):
        position = position.to_local()
    if dtn.is_dt(like):
        like = like.to_local()
    return torch.as_tensor(position, dtype=torch.int32, device=like.device)


def _attend_layout(leaf) -> list:
    """The layout that queries take to attend over the cache leaf ``leaf``
    ([B, C, ...], a DTensor) on each rank's own slots: on a mesh dim that
    splits the batch (dim 0) or the KV heads (dim 2) the queries are split
    alike; on one that splits the capacity (dim 1), or leaves the leaf
    whole, each rank takes every query head of its rows."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(p.dim) if p.is_shard() and p.dim in (0, 2) else Replicate()
            for p in leaf.placements]


def _pos_layout(leaf) -> list:
    """The layout of a ``pos`` leaf [B, C] in the cache leaf ``leaf``'s
    layout (its batch and capacity splits; whole elsewhere)."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(p.dim) if p.is_shard() and p.dim in (0, 1) else Replicate()
            for p in leaf.placements]


def _local_view(cache, q, leaf_name):
    """(mesh, the layout ``q`` attends in, its local tensor, the local
    ``pos`` in ``cache[leaf_name]``'s layout, the mesh dims that split the
    capacity) for attention on each rank's shards. ``pos`` keeps its own
    layout in the cache; reading it in the leaf's is a redistribute of the
    int32 [B, C] leaf."""
    leaf = cache[leaf_name]
    tgt = _attend_layout(leaf)
    ql = dtn.settle(q, tgt).to_local()
    pos = dtn.regroup(cache["pos"], _pos_layout(leaf)).to_local()
    return leaf.device_mesh, tgt, ql, pos, dtn.split_dims(leaf, 1)


def _gqa_split(q, k, v, q_pos, k_pos, window: int, compute_dtype, mesh,
               dims):
    """``gqa_attention`` with the keys split over the mesh dims ``dims``
    (each rank holds its own cache slots), merged by
    ``dtensor.split_softmax``: q [b,1,nq,h], k/v [b,t,nkv,h], q_pos [b,1],
    k_pos [b,t] -> [b,1,nq,h] on every rank."""
    b, sq, nq, h = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, sq, nkv, nq // nkv, h)
    scores = torch.einsum("bsngh,btnh->bngst", qg.float(),
                          k.float()) / np.sqrt(h)
    ok = _window_ok(q_pos, k_pos, window, causal=True)[:, None, None]
    o, l = dtn.split_softmax(
        scores, ok, lambda p: torch.einsum("bngst,btnh->bsngh", p,
                                           v.float()), mesh, dims)
    out = o / l.permute(0, 3, 1, 2)[..., None]
    return out.to(compute_dtype).reshape(b, sq, nq, h)


def decode_attention(cfg: ModelConfig, p: Params, x, cache, position,
                     window: int):
    """One-token decode with cache append. x [B,1,d]; ``position`` a Python
    int, a 0-d integer tensor on the cache's device or a replicated 0-d
    DTensor (nothing here reads it back to the host).

    The new K/V and its position are written in place at slot ``position
    % capacity`` (``index_copy_``), and ``cache`` itself is returned. The
    mask comes from the per-slot absolute positions only, so a linear
    cache and a ring buffer share one path. Under M-RoPE the position is
    broadcast to all three streams, as the reference's. Returns (out
    [B,1,d], cache).

    On DTensors the cache leaves keep the layouts of
    ``sharding/specs.cache_leaf_spec``: each rank writes the slot into its
    own shard where it owns it (``dtensor.write_slot``) and attends over
    its own slots; where the capacity is split the softmax is merged
    across those ranks (``dtensor.split_softmax``). Only queries, the
    ``pos`` leaf and the merge's statistics move, never K or V.
    """
    cdt = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    cpos = cache["pos"]
    position = as_position(position, cpos)
    slot = (position % cpos.shape[-1]).reshape(1).long()
    pos_b = position.reshape(1, 1).expand(b, 1)

    x_in = x
    x = dtn.whole_on(x.to(cdt))           # column-parallel inputs
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
        rows = dtn.rows_like(pos_b, q)
        p3 = (dtn.on_shards(lambda r: r[None].expand(3, *r.shape),
                            dtn.remap(rows.placements, {0: 1}), rows)
              if dtn.is_dt(rows) else rows[None].expand(3, b, 1))
        q = layers.apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k = layers.apply_mrope(k, p3, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.use_rope:
        rows = dtn.rows_like(pos_b, q)
        q = layers.apply_rope(q, rows, cfg.rope_theta)
        k = layers.apply_rope(k, rows, cfg.rope_theta)

    dtn.write_slot(cache["k"], slot, k)
    dtn.write_slot(cache["v"], slot, v)
    dtn.write_slot(cpos, slot, position.reshape(1, 1))
    if dtn.is_dt(cache["k"]):
        mesh, tgt, ql, pos, dims = _local_view(cache, q, "k")
        kl, vl = cache["k"].to_local(), cache["v"].to_local()
        q_pos = position.reshape(1, 1).expand(ql.shape[0], 1)
        if dims:
            out = _gqa_split(ql, kl, vl, q_pos, pos, int(window), cdt, mesh,
                             dims)
        else:
            out = gqa_attention(ql, kl, vl, _window_bias(
                q_pos, pos, int(window), causal=True), cdt)
        out = dtn.settle(dtn.from_local(out, mesh, tgt), q.placements)
    else:
        bias = _window_bias(pos_b, cpos, int(window), causal=True)
        out = gqa_attention(q, cache["k"], cache["v"], bias, cdt)
    out = layers.row_parallel(out.reshape(b, 1, nq * hd), p["wo"].to(cdt))
    return layers.tp_out(out, x_in).to(cdt), cache


def cross_decode_attention(cfg: ModelConfig, p: Params, x, ck, cv):
    """One token's cross-attention over the cached encoder K/V (read, not
    written): x [B,1,d], ``ck``/``cv`` [B,F,nkv,hd]; no mask, no rotary
    embedding (whisper's decoder). On DTensors ``ck``/``cv`` keep their
    ``cache_leaf_spec`` layout (batch over the data axes, KV heads over
    model where they divide): the queries move to it and each rank
    attends over its own shard; ``wo``'s partial sums are reduced into
    ``x``'s layout. Returns out [B,1,d]."""
    cdt = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    nq, hd = cfg.num_heads, cfg.head_dim_
    x_in = x
    x = dtn.whole_on(x.to(cdt))
    q = (x @ p["wq"].to(cdt)).reshape(b, 1, nq, hd)
    if dtn.is_dt(ck):
        tgt = _attend_layout(ck)
        ql, kl = dtn.settle(q, tgt).to_local(), ck.to_local()
        bias = torch.zeros((ql.shape[0], 1, kl.shape[1]),
                           dtype=torch.float32, device=kl.device)
        out = gqa_attention(ql, kl, cv.to_local(), bias, cdt)
        out = dtn.settle(dtn.from_local(out, ck.device_mesh, tgt),
                         q.placements)
    else:
        bias = torch.zeros((b, 1, ck.shape[1]), dtype=torch.float32,
                           device=ck.device)
        out = gqa_attention(q, ck, cv, bias, cdt)
    out = layers.row_parallel(out.reshape(b, 1, nq * hd), p["wo"].to(cdt))
    return layers.tp_out(out, x_in)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): compressed-latent attention
# ---------------------------------------------------------------------------

def _mla_qkv(cfg: ModelConfig, p: Params, x, positions):
    """(q_nope, q_pe [B,S,nq,*], ckv [B,S,r], k_pe [B,S,rope]): q and the
    latent K/V from x [B,S,d], the rope parts rotated at ``positions``. On
    DTensors x is whole on the model axis first (the column-parallel
    input); q comes out with each rank's heads."""
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nq = cfg.num_heads
    x = dtn.whole_on(x.to(cdt))
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
    [nope ; rope] head dim's). On DTensors the per-head part runs on each
    rank's heads and rows (``dtensor.on_shards``) and ``wo``'s partial
    sums are reduced into the input's layout, as ``full_attention``'s.
    Returns (out [B,S,d], (ckv, k_pe)) for cache priming."""
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nq = cfg.num_heads
    q_nope, q_pe, ckv, k_pe = _mla_qkv(cfg, p, x, positions)
    scores_dtype = dtype_of(cfg.attn_scores_dtype)

    def attend(q_nope, q_pe, ckv, k_pe, wkv_b, positions):
        """Attention over the heads of ``q_nope`` (all, or this rank's
        block, with ``wkv_b``'s columns of the same heads)."""
        bl, n = q_nope.shape[0], q_nope.shape[2]
        kvb = (ckv @ wkv_b).reshape(bl, s, n,
                                    m.qk_nope_head_dim + m.v_head_dim)
        k_nope = kvb[..., :m.qk_nope_head_dim]
        v = kvb[..., m.qk_nope_head_dim:]
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        k_full = torch.cat(
            [k_nope, k_pe[:, :, None, :].expand(bl, s, n,
                                                m.qk_rope_head_dim)],
            dim=-1)
        return chunked_mha(q_full, k_full, v, positions, positions,
                           int(window), True, cdt, scores_dtype=scores_dtype)
    args = (q_nope, q_pe, ckv, k_pe, p["wkv_b"].to(cdt), positions)
    if dtn.is_dt(q_nope):
        out = dtn.on_shards(attend, q_nope.placements, *args)
    else:
        out = attend(*args)
    out = layers.row_parallel(out.reshape(b, s, nq * m.v_head_dim),
                              p["wo"].to(cdt))
    return layers.tp_out(out, x).to(cdt), (ckv, k_pe)


def _mla_latent(q_lat, q_pe, ckv, kpe, q_pos, k_pos, window: int, scale,
                compute_dtype, mesh=None, dims=()):
    """MLA decode's attention in the latent space: q_lat [b,1,n,r], q_pe
    [b,1,n,rope] over ckv [b,t,r], kpe [b,t,rope] at k_pos [b,t] ->
    out_lat [b,1,n,r]. With ``dims`` the slots are split over those mesh
    dims and the softmax is merged (``dtensor.split_softmax``)."""
    scores = (torch.einsum("bsnr,btr->bnst", q_lat.float(), ckv.float())
              + torch.einsum("bsnh,bth->bnst", q_pe.float(),
                             kpe.float())) * scale
    if not dims:
        bias = _window_bias(q_pos, k_pos, window, causal=True)
        probs = torch.softmax(scores + bias[:, None], dim=-1).to(
            compute_dtype)
        return torch.einsum("bnst,btr->bsnr", probs, ckv)
    ok = _window_ok(q_pos, k_pos, window, causal=True)[:, None]
    o, l = dtn.split_softmax(
        scores, ok, lambda p: torch.einsum("bnst,btr->bsnr", p, ckv.float()),
        mesh, dims)
    return (o / l.permute(0, 2, 1)[..., None]).to(compute_dtype)


def mla_decode_attention(cfg: ModelConfig, p: Params, x, cache, position,
                         window: int):
    """Absorbed-matrix MLA decode: attention runs in the latent space, so a
    step costs O(S * kv_lora_rank) and the cache holds only the latent
    (arXiv:2412.19437 §2.1). x [B,1,d]; ``position`` as in
    ``decode_attention``; the new latent, rope key and position are written
    in place at slot ``position % capacity``. Returns (out [B,1,d],
    cache).

    On DTensors the latent leaves keep ``cache_leaf_spec``'s layout (batch
    over the data axes, capacity over model): each rank writes the slot
    where it owns it and attends over its own slots. The absorbed queries
    (``q_lat``, ``q_pe``: one token, every head) move to the cache's
    layout, the softmax is merged across the ranks that split the
    capacity, and ``out_lat`` returns to the rank's heads; ``ckv`` and
    ``kpe`` never move."""
    m = cfg.mla
    cdt = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    nq = cfg.num_heads
    hk, hv, r = m.qk_nope_head_dim, m.v_head_dim, m.kv_lora_rank
    cpos = cache["pos"]
    position = as_position(position, cpos)
    slot = (position % cpos.shape[-1]).reshape(1).long()
    pos_b = position.reshape(1, 1).expand(b, 1)

    rows = dtn.rows_of(pos_b, x) if dtn.is_dt(x) else pos_b
    q_nope, q_pe, ckv_new, kpe_new = _mla_qkv(cfg, p, x, rows)
    dtn.write_slot(cache["ckv"], slot, ckv_new)
    dtn.write_slot(cache["kpe"], slot, kpe_new)
    dtn.write_slot(cpos, slot, position.reshape(1, 1))
    scale = 1.0 / np.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    wkv_b = p["wkv_b"].to(cdt)

    if dtn.is_dt(q_nope):
        mesh = q_nope.device_mesh
        qn = q_nope.to_local()
        w = wkv_b.to_local().reshape(r, qn.shape[2], hk + hv)
        # the K up-projection absorbed into the rank's heads of the query
        q_lat = dtn.from_local(torch.einsum("bsnh,rnh->bsnr", qn,
                                            w[:, :, :hk]),
                               mesh, q_nope.placements)
        _, tgt, q_lat, pos, dims = _local_view(cache, q_lat, "ckv")
        q_pe = dtn.settle(q_pe, tgt).to_local()
        q_pos = position.reshape(1, 1).expand(q_lat.shape[0], 1)
        out_lat = _mla_latent(q_lat, q_pe, cache["ckv"].to_local(),
                              cache["kpe"].to_local(), q_pos, pos,
                              int(window), scale, cdt, mesh, dims)
        out_lat = dtn.settle(dtn.from_local(out_lat, mesh, tgt),
                             q_nope.placements).to_local()
        out = torch.einsum("bsnr,rnh->bsnh", out_lat, w[:, :, hk:])
        out = dtn.from_local(out.reshape(out.shape[0], 1, -1), mesh,
                             q_nope.placements)
    else:
        w = wkv_b.reshape(r, nq, hk + hv)
        q_lat = torch.einsum("bsnh,rnh->bsnr", q_nope, w[:, :, :hk])
        out_lat = _mla_latent(q_lat, q_pe, cache["ckv"], cache["kpe"],
                              pos_b, cpos, int(window), scale, cdt)
        out = torch.einsum("bsnr,rnh->bsnh", out_lat,
                           w[:, :, hk:]).reshape(b, 1, nq * hv)
    out = layers.row_parallel(out, p["wo"].to(cdt))
    return layers.tp_out(out, x).to(cdt), cache
