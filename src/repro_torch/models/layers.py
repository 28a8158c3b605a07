"""Shared layer primitives on plain tensors (port of ``repro.models.layers``:
norms, the gated MLP, rotary embeddings and the initialisers).

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
