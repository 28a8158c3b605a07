"""Plain PyTorch versions of paged attention over a BWAP-placed page pool
(port of ``repro.kernels.paged_attention.ref``).

The CPU path of the port's engine runs these, and the tests and
``chip_smoke.py`` hold the CUDA kernel against them. Like the reference
oracles they walk the page table in order with an online-softmax update per
page, with one finite ``NEG_INF`` for both the running-max init and the
mask, so a fully masked trailing page updates (m, l, acc) by exactly
nothing: the output is bit-invariant to trailing table padding.

Dot products are written as an elementwise product summed over the last
axis (not a batched matmul), so the arithmetic of one query row does not
depend on how many rows share the call: decode equals the first row of a
verify chunk bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -2.0e38


def _page_walk(qf, k_pool, v_pool, page_table, mask_fn):
    """Online-softmax accumulation over one batched page table.

    qf [B, R, h] float32 query rows; page_table [B, mp]; ``mask_fn(pos)``
    maps per-page key positions [1, ps] to a validity mask [B, R, ps].
    Returns [B, R, h] float32.
    """
    b, r, h = qf.shape
    ps, nkv = k_pool.shape[1], k_pool.shape[2]
    mp = page_table.shape[1]
    g = r // nkv                      # query rows per KV head
    dev = qf.device
    q5 = qf.reshape(b, nkv, g, 1, h)
    scale = 1.0 / np.sqrt(h)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    m = torch.full((b, nkv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, nkv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, nkv, g, h), dtype=torch.float32, device=dev)
    table = page_table.long()
    slots = torch.arange(ps, device=dev)[None, :]
    for pi in range(mp):
        ids = table[:, pi]
        k = k_pool[ids].float().permute(0, 2, 1, 3)        # [B,nkv,ps,h]
        v = v_pool[ids].float().permute(0, 2, 1, 3)
        s = (q5 * k[:, :, None]).sum(-1) * scale           # [B,nkv,g,ps]
        ok = mask_fn(pi * ps + slots).reshape(b, nkv, g, ps)
        s = torch.where(ok, s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + (p[..., None] * v[:, :, None]).sum(-2)
        m = m_new
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.reshape(b, r, h)


def paged_attention_ref(q, k_pool, v_pool, page_table, lens):
    """q [B,nq,h]; pools [P,ps,nkv,h]; page_table [B,mp]; lens [B] ->
    [B,nq,h]. Query b sees pool positions < lens[b] through its row."""
    b, nq, h = q.shape

    def mask(pos):                                   # pos [1,ps]
        ok = pos < lens.long()[:, None]              # [B,ps]
        return ok[:, None, :].expand(b, nq, pos.shape[1])

    out = _page_walk(q.float(), k_pool, v_pool, page_table, mask)
    return out.to(q.dtype)


def paged_prefill_attention_batch_ref(q, k_pool, v_pool, page_table,
                                      q_start):
    """q [B,T,nq,h]; pools [P,ps,nkv,h]; page_table [B,mp]; q_start [B] ->
    [B,T,nq,h]. Query (b, t) sits at position ``q_start[b] + t`` and sees
    pool positions <= its own through row b's table."""
    b, t, nq, h = q.shape
    nkv = k_pool.shape[2]
    g = nq // nkv
    dev = q.device
    # rows grouped by KV head, then query position, then group: [nkv, T*g]
    qf = q.reshape(b, t, nkv, g, h).permute(0, 2, 1, 3, 4) \
        .reshape(b, nkv * t * g, h)
    qpos = (q_start.long()[:, None]
            + torch.arange(t, device=dev).repeat_interleave(g)[None, :])

    def mask(pos):                                   # pos [1,ps]
        ok = pos[:, None, :] <= qpos[:, :, None]     # [B,T*g,ps]
        return ok[:, None].expand(b, nkv, t * g, pos.shape[1]) \
            .reshape(b, nkv * t * g, pos.shape[1])

    out = _page_walk(qf.float(), k_pool, v_pool, page_table, mask)
    out = out.reshape(b, nkv, t, g, h).permute(0, 2, 1, 3, 4)
    return out.reshape(b, t, nq, h).to(q.dtype)


def paged_prefill_attention_ref(q, k_pool, v_pool, page_table, q_start):
    """One sequence's chunk: q [T,nq,h]; page_table [mp]; scalar q_start ->
    [T,nq,h]. The B=1 case of the batched version."""
    qs = torch.as_tensor(q_start, dtype=torch.int32, device=q.device) \
        .reshape(1)
    return paged_prefill_attention_batch_ref(
        q[None], k_pool, v_pool, page_table[None], qs)[0]
