"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``): GQA, causal, sliding window.

fp32 scores and softmax; the query heads of one KV head are grouped by a
reshape, never repeated. Masking is top-left aligned (query s at position
s, key t at position t), also when S != T, as in the reference. A row that
sees no key gets the softmax of all-masked scores (the mean of V), as the
reference oracle does; the kernel gives 0 there (``kernel``).
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, window: int = 0, causal: bool = True):
    """q [B,S,nq,h], k/v [B,T,nkv,h] -> [B,S,nq,h] in q's dtype."""
    b, s, nq, h = q.shape
    t, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    q5 = q.reshape(b, s, nkv, g, h)
    scores = torch.einsum("bsngh,btnh->bngst", q5.float(),
                          k.float()) / np.sqrt(h)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    scores = torch.where(ok, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bngst,btnh->bsngh", probs, v.float())
    return out.reshape(b, s, nq, h).to(q.dtype)
