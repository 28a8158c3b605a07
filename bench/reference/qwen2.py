"""Plain PyTorch reference of the Qwen2 decoder and of Qwen2-VL's text path,
in float32 with TF32 off.

Written from the published description (arXiv:2407.10671, arXiv:2409.12191)
and the configuration file's sizes under their Hugging Face names; it
imports nothing of the program. Pre-norm blocks: RMSNorm with the gain
applied as ``1 + gamma`` (the weights' convention), q/k/v projections with
bias, rotary embeddings on the two halves of each head (M-RoPE for Qwen2-VL:
the half dims split into t/h/w sections, each rotated by its own position
stream; a text token has t = h = w = its position), causal grouped-query
attention, a SiLU-gated MLP, the final norm and the head (the embedding's
transpose when tied).

It runs one sequence at a time, a layer at a time, each layer's weights
cast to float32 when it is reached, and attention in blocks of query rows,
so that it fits beside the weights. ``quant="fp8"`` is the control: every
product's weight (per output column) and input (per row), and the cached
K and V (per token and head), rounded through float8 e4m3.
"""

from __future__ import annotations

import math

import torch

ROWS = 512                       # query rows an attention block


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with one scale per slice along
    ``dim``'s complement (absmax mapped to 448)."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(a, w, quant):
    if quant == "fp8":
        return _fp8(a, -1) @ _fp8(w, 0)
    return a @ w


def _norm(x, gamma, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + gamma.float())


def _rope(x, pos, theta: float, sections):
    """x [S, H, hd] at positions ``pos`` [S]."""
    hd = x.shape[-1]
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    if sections:
        # t, h, w streams; a text token's three positions are equal
        streams = torch.stack([pos, pos, pos]).double()         # [3, S]
        sec = torch.repeat_interleave(
            torch.arange(len(sections), device=x.device),
            torch.tensor(sections, device=x.device))             # [half]
        ang = streams[sec].T * inv                               # [S, half]
    else:
        ang = pos.double()[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v):
    """Causal grouped-query attention: q [S, nq, hd], k/v [S, nkv, hd]."""
    s, nq, hd = q.shape
    nkv = k.shape[1]
    g = nq // nkv
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    for a in range(0, s, ROWS):
        b = min(s, a + ROWS)
        qb = q[a:b].reshape(b - a, nkv, g, hd)
        sc = torch.einsum("tkgh,skh->kgts", qb, k[:b]) * scale
        mask = torch.arange(b, device=q.device)[None, :] \
            > torch.arange(a, b, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf")).softmax(-1)
        out[a:b] = torch.einsum("kgts,skh->tkgh", sc, v[:b]).reshape(
            b - a, nq, hd)
    return out


def logits(m: dict, params: dict, tokens, rows, quant: str | None = None):
    """Float32 logits [len(rows), V] at positions ``rows`` of the sequence
    ``tokens``, from ``params`` (the tree ``bench.weights.make`` gives, any
    dtype, on the device the reference runs on)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(m, params, tokens, rows, quant)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _logits(m, params, tokens, rows, quant):
    d = m["hidden_size"]
    nq, nkv = m["num_attention_heads"], m["num_key_value_heads"]
    hd = d // nq
    eps, theta = m["rms_norm_eps"], m["rope_theta"]
    sections = m.get("mrope_section")
    emb = params["embed"]
    dev = emb.device
    toks = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
    pos = torch.arange(len(toks), device=dev)
    x = emb[toks].float()
    g = params["groups"][0]
    for l in range(m["num_hidden_layers"]):
        a, p = g["attn"], g["mlp"]
        h = _norm(x, g["norm1"]["gamma"][l], eps)
        q = _mm(h, a["wq"][l].float(), quant)
        k = _mm(h, a["wk"][l].float(), quant)
        v = _mm(h, a["wv"][l].float(), quant)
        if m.get("qkv_bias", False):
            q, k, v = (q + a["bq"][l].float(), k + a["bk"][l].float(),
                       v + a["bv"][l].float())
        q = _rope(q.reshape(-1, nq, hd), pos, theta, sections)
        k = _rope(k.reshape(-1, nkv, hd), pos, theta, sections)
        v = v.reshape(-1, nkv, hd)
        if quant == "fp8":
            k, v = _fp8(k, -1), _fp8(v, -1)
        o = _attention(q, k, v).reshape(-1, nq * hd)
        x = x + _mm(o, a["wo"][l].float(), quant)
        h = _norm(x, g["norm2"]["gamma"][l], eps)
        up = _mm(h, p["w_up"][l].float(), quant)
        gate = _mm(h, p["w_gate"][l].float(), quant)
        x = x + _mm(torch.nn.functional.silu(gate) * up,
                    p["w_down"][l].float(), quant)
    idx = torch.as_tensor(list(rows), dtype=torch.long, device=dev)
    h = _norm(x[idx], params["final_norm"]["gamma"], eps)
    head = emb.T if m["tie_word_embeddings"] else params["head"]
    return _mm(h, head.float(), quant)
