"""Shared layer primitives on plain tensors (port of ``repro.models.layers``:
norms, the gated MLP, rotary embeddings (1-D and Qwen2-VL's M-RoPE), the
initialisers and the cross-entropy losses).

Params are the reference's nested dicts of tensors. Initialisers draw from
an explicit ``torch.Generator``; they cannot reproduce ``jax.random``, so
parity tests hand reference params over through ``repro_torch.convert``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import dtype_of

Params = dict  # nested dict of tensors


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(device)


# -- initializers -------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    s = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return (_randn(gen, (d_in, d_out), device) * s).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return (_randn(gen, (vocab, d), device) * 0.02).to(dtype)


# -- norms ---------------------------------------------------------------------

def rmsnorm(x, gamma, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + gamma.float())
    return out.to(dt)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(dt)


def norm_params(cfg, d: int, device) -> Params:
    dt = dtype_of(cfg.param_dtype)
    if cfg.norm == "rmsnorm":
        return {"gamma": torch.zeros((d,), dtype=dt, device=device)}
    return {"gamma": torch.ones((d,), dtype=dt, device=device),
            "beta": torch.zeros((d,), dtype=dt, device=device)}


def apply_norm(cfg, p: Params, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["gamma"], cfg.rms_eps)
    return layernorm(x, p["gamma"], p["beta"], cfg.rms_eps)


# -- activations ---------------------------------------------------------------

def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name in ("gelu", "geglu"):
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


# -- gated MLP -------------------------------------------------------------------

def mlp_params(gen: torch.Generator, cfg, d: int, ff: int, device) -> Params:
    dt = dtype_of(cfg.param_dtype)
    p = {"w_up": dense_init(gen, d, ff, dt, device),
         "w_down": dense_init(gen, ff, d, dt, device)}
    if cfg.act in ("silu", "geglu"):
        p["w_gate"] = dense_init(gen, d, ff, dt, device)
    return p


def mlp_apply(cfg, p: Params, x):
    """Gated MLP; weights are cast to the compute dtype at use (a no-op
    when the caller already holds compute-dtype weights)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = x.to(cdt)
    up = x @ p["w_up"].to(cdt)
    if "w_gate" in p:
        gate = x @ p["w_gate"].to(cdt)
        up = act_fn(cfg.act)(gate) * up
    else:
        up = act_fn(cfg.act)(up)
    return up @ p["w_down"].to(cdt)


# -- rotary embeddings ------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. The head dim
    splits into halves (x1, x2), rotated by the same angles."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)
    ang = positions[..., :, None, None].float() * freqs   # [...,S,1,D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections: tuple[int, ...]):
    """Qwen2-VL M-RoPE: x [B, S, H, D], positions3 [3, B, S] (t, h, w). The
    head dim's half is split into ``sections`` (summing to D/2); each
    frequency index takes its angle from its section's position stream
    (arXiv:2409.12191). In fp32, as ``apply_rope``."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, half)
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)                      # [D/2]
    # the position stream of each frequency index
    sec_id = torch.as_tensor(np.repeat(np.arange(len(sections)), sections),
                             device=positions3.device)
    pos = positions3[sec_id].float()                              # [D/2,B,S]
    ang = torch.einsum("dbs,d->bsd", pos, freqs)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- losses -----------------------------------------------------------------------

def softmax_xent(logits, labels, mask=None):
    """Mean next-token cross-entropy; logits [..., V] in fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None].long(),
                                dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def softmax_xent_fused(h, w_head, labels, chunk: int = 0):
    """CE from hidden states h [B,S,d] (aligned with labels [B,S]) without
    [B,S,V] logits: the head matmul and logsumexp run per sequence chunk.
    The chunk rule is the reference's (fp32 logits of 2**28 bytes per
    device under 16-way batch and vocab sharding), so both chunk alike.
    Returns the mean NLL."""
    b, s, _ = h.shape
    v = w_head.shape[-1]
    if chunk <= 0:
        budget = 2 ** 28
        b_local = max(b // 16, 1)
        v_local = v // 16 if v % 16 == 0 else v
        chunk = max(8, min(s, budget // max(b_local * v_local * 4, 1)))
    w = w_head.to(h.dtype)
    nll_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    n = 0
    for i in range(0, s, chunk):
        hc = h[:, i:i + chunk]
        lc = labels[:, i:i + chunk]
        logits = (hc @ w).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, lc[..., None].long(),
                                    dim=-1)[..., 0]
        nll_sum = nll_sum + (logz - gold).sum()
        n += hc.shape[1] * b
    return nll_sum / n
