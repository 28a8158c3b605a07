"""State-space and recurrent sequence mixers: Mamba (hymba's parallel head),
mLSTM and sLSTM (xLSTM) (port of ``repro.models.ssm``).

Plain torch, as the reference's are plain jnp outside any Pallas kernel.
The chunked forms keep the reference's formulation: the selective scan
runs in fp32 over ``SSM_CHUNK``-token chunks (zero padding to whole
chunks), each chunk's first-order recurrence a log-depth scan (the
reference's ``associative_scan``) with the carried state entering as
``cumprod(abar) * h0``; the mLSTM runs its stabilised chunkwise-parallel
form over ``MLSTM_CHUNK``-token chunks; the sLSTM is a loop over the
sequence (the reference's ``lax.scan``). The chunk loops are Python loops
(the reference's ``lax.scan``); past one chunk, each Mamba and mLSTM chunk
body is rematerialised while autograd records, as the reference's
``jax.checkpoint`` around it (``layers.checkpointed``).

Decode state is written in place (``copy_``) and returned, as the dense
decode cache is; the reference returns a new tree.

Two places hold the reference's invariant, not its code (ROADMAP §3): the
reference's ``mlstm_decode_step`` leaves out the output gate ``out *
silu(res @ wv)`` that its ``mlstm_apply`` applies, and its
``mlstm_chunk_body`` contracts the query with the value index of the
carried memory ``C`` (``q_d C[d, e]``) where the recurrence reads ``C[d,
e] q_e``, so its chunked form leaves the recurrence after the first chunk.
Here the decode step applies the gate and the chunk body reads ``C`` as the
recurrence does: ``mlstm_apply`` equals the reference's on one chunk, and
the decode step's outputs equal ``mlstm_apply``'s at any length.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import dtype_of
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, _randn, dense_init

# ---------------------------------------------------------------------------
# Selective SSM (Mamba-style): hymba's parallel head
# ---------------------------------------------------------------------------


def mamba_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    s = cfg.ssm
    dt = dtype_of(cfg.param_dtype)
    d = cfg.d_model
    inner = s.expand * d
    a = torch.arange(1, s.state_dim + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, 2 * inner, dt, device),
        "conv_w": (_randn(gen, (s.conv_dim, inner), device) * 0.2).to(dt),
        "w_dt": dense_init(gen, d, inner, dt, device),
        "b_dt": torch.full((inner,), -4.6, dtype=dt,     # softplus^-1(0.01)
                           device=device),
        "w_bc": dense_init(gen, d, 2 * s.state_dim, dt, device),
        "a_log": torch.log(a.repeat(inner, 1)).to(dt),
        "d_skip": torch.ones((inner,), dtype=dt, device=device),
        "out_proj": dense_init(gen, inner, d, dt, device),
    }


def _causal_conv(x, w):
    """Depthwise causal conv over seq: x [B,S,C], w [K,C]."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(k))


def _ssm_scan(a, bx):
    """First-order linear recurrence h_t = a_t * h_{t-1} + bx_t along axis
    1 from h = 0: a log-depth inclusive scan of the reference's combine
    ``(al * ar, bl * ar + br)``."""
    n, d = a.shape[1], 1
    while d < n:
        bx = torch.cat([bx[:, :d], bx[:, :-d] * a[:, d:] + bx[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return bx


SSM_CHUNK = 256  # sequence chunk of the selective scan


def mamba_chunk_body(p, h0, dt_c, xin_c, b_c, c_c):
    """One chunk of the selective scan: carry h0 [B,inner,state]; chunk
    inputs [B,c,inner] / [B,c,state]. The [B,c,inner,state] discretised
    tensors live only inside this body. Returns (h at the chunk's end,
    y [B,c,inner] fp32)."""
    f32 = torch.float32
    a = -torch.exp(p["a_log"].to(f32))                        # [inner,state]
    abar = torch.exp(dt_c[..., None].to(f32) * a)             # [B,c,in,st]
    bx = (dt_c * xin_c)[..., None].to(f32) * b_c[:, :, None, :].to(f32)
    h_in = _ssm_scan(abar, bx)
    a_cum = torch.cumprod(abar, dim=1)
    h = h_in + a_cum * h0[:, None]
    y = torch.einsum("bsit,bst->bsi", h, c_c.to(f32))
    return h[:, -1], y


def mamba_apply(cfg: ModelConfig, p: Params, x):
    """x [B,S,d] -> [B,S,d]: the chunked selective SSM (a carry passed over
    ``SSM_CHUNK``-sized pieces keeps the discretised state tensor
    bounded)."""
    s = cfg.ssm
    cdt = dtype_of(cfg.compute_dtype)
    b, seq, _ = x.shape
    x = x.to(cdt)
    xin, res = (x @ p["in_proj"].to(cdt)).chunk(2, dim=-1)    # [B,S,inner]
    xin = F.silu(_causal_conv(xin, p["conv_w"].to(cdt)))
    dt_ = F.softplus(x @ p["w_dt"].to(cdt) + p["b_dt"].to(cdt))
    bmat, cmat = (x @ p["w_bc"].to(cdt)).chunk(2, dim=-1)     # [B,S,state]

    inner = xin.shape[-1]
    chunk = min(SSM_CHUNK, seq)
    nc = -(-seq // chunk)
    pad = nc * chunk - seq
    ins = [F.pad(t, (0, 0, 0, pad)) for t in (dt_, xin, bmat, cmat)]
    h = torch.zeros((b, inner, s.state_dim), dtype=torch.float32,
                    device=x.device)
    # past one chunk each chunk body is rematerialised under autograd (the
    # reference's jax.checkpoint): only the chunk's inputs are kept, not
    # its [B,c,inner,state] discretised state
    body = mamba_chunk_body if nc == 1 else functools.partial(
        layers.checkpointed, mamba_chunk_body)
    ys = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        h, y = body(p, h, *(t[:, sl] for t in ins))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :seq]
    y = (y.to(cdt) + xin * p["d_skip"].to(cdt)) * F.silu(res)
    return y @ p["out_proj"].to(cdt)


def mamba_init_state(cfg: ModelConfig, batch: int, layer_axes=(), *,
                     device) -> Params:
    """``conv`` [*layer_axes, B, conv_dim - 1, inner] in the compute dtype
    (the last inputs of the causal conv) and ``h`` [..., B, inner, state]
    fp32, all zero."""
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    lead = tuple(layer_axes) + (batch,)
    return {
        "conv": torch.zeros(lead + (s.conv_dim - 1, inner),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
        "h": torch.zeros(lead + (inner, s.state_dim), dtype=torch.float32,
                         device=device),
    }


def mamba_decode_step(cfg: ModelConfig, p: Params, x, state):
    """x [B,1,d]: the O(1) recurrent update; ``state`` is written in place.
    Returns (out [B,1,d], state)."""
    cdt = dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    x = x.to(cdt)
    xin, res = (x @ p["in_proj"].to(cdt)).chunk(2, dim=-1)    # [B,1,inner]
    conv_buf = torch.cat([state["conv"], xin], dim=1)         # [B,K,inner]
    # the forward's conv at its last position (the reference sums with an
    # einsum): the same products in the same order, so in bf16 decode and
    # forward round alike
    xin = F.silu(_causal_conv(conv_buf, p["conv_w"].to(cdt))[:, -1:])
    dt_ = F.softplus(x @ p["w_dt"].to(cdt) + p["b_dt"].to(cdt))
    bmat, cmat = (x @ p["w_bc"].to(cdt)).chunk(2, dim=-1)
    a = -torch.exp(p["a_log"].to(f32))
    abar = torch.exp(dt_[..., None].to(f32) * a)[:, 0]        # [B,in,st]
    bx = (dt_ * xin)[..., None].to(f32) * bmat[:, :, None, :].to(f32)
    h = state["h"] * abar + bx[:, 0]                          # [B,in,st]
    y = torch.einsum("bit,bt->bi", h, cmat[:, 0].to(f32))
    y = (y[:, None, :].to(cdt) + xin * p["d_skip"].to(cdt)) * F.silu(res)
    state["conv"].copy_(conv_buf[:, 1:])
    state["h"].copy_(h)
    return y @ p["out_proj"].to(cdt), state


# ---------------------------------------------------------------------------
# mLSTM (xLSTM): matrix-memory LSTM, chunkwise-parallel form
# ---------------------------------------------------------------------------

def mlstm_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = dtype_of(cfg.param_dtype)
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim_
    inner = int(cfg.xlstm.mlstm_proj_factor * d)
    return {
        "up": dense_init(gen, d, 2 * inner, dt, device),
        "conv_w": (_randn(gen, (cfg.xlstm.conv_dim, inner), device)
                   * 0.2).to(dt),
        "wq": dense_init(gen, inner, h * hd, dt, device),
        "wk": dense_init(gen, inner, h * hd, dt, device),
        "wv": dense_init(gen, inner, h * hd, dt, device),
        "w_if": dense_init(gen, inner, 2 * h, dt, device),
        "b_if": torch.cat([torch.zeros((h,), device=device),
                           torch.full((h,), 3.0, device=device)]).to(dt),
        "gn": torch.ones((h * hd,), dtype=dt, device=device),
        "down": dense_init(gen, h * hd, d, dt, device),
        "skip": dense_init(gen, inner, h * hd, dt, device),
    }


def _mlstm_gates(p, xin, cdt):
    """(i_raw, log f) [B,S,H] fp32 from xin [B,S,inner]."""
    gif = xin @ p["w_if"].to(cdt) + p["b_if"].to(cdt)
    i_raw, f_raw = gif.to(torch.float32).chunk(2, dim=-1)
    return i_raw, F.logsigmoid(f_raw)


def _headwise_norm(h, gain, eps: float = 1e-6):
    """Group norm per head of h [..., H, hd], flattened to [..., H*hd]
    and scaled by ``gain``."""
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + eps)
    return out.reshape(*h.shape[:-2], -1) * gain


MLSTM_CHUNK = 256


def mlstm_chunk_body(carry, q, k, v, i_raw, logf):
    """The stabilised chunkwise-parallel mLSTM: intra-chunk quadratic form
    plus the carried state, all fp32. carry: (C [B,H,hd_v,hd_k], n
    [B,H,hd], m [B,H]); q/k/v [B,c,H,hd]; i_raw/logf [B,c,H]. Returns
    (new carry, h [B,c,H,hd]). The carried term reads ``C`` as the
    recurrence does (``C[d, e] q_e``; the reference's transposes it)."""
    c_prev, n_prev, m_prev = carry
    c = q.shape[1]
    f32 = torch.float32
    q, k, v = (t.to(f32) for t in (q, k, v))
    i_raw, logf = i_raw.to(f32), logf.to(f32)

    fcum = torch.cumsum(logf, dim=1)                     # [B,c,H] inclusive
    ftot = fcum[:, -1]                                   # [B,H]
    # intra-chunk log-decay D[j,s] = F_j - F_s + i_s (valid for s <= j)
    dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + i_raw[:, None, :, :]
    causal = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    dmat = torch.where(causal[None, :, :, None], dmat,
                       torch.tensor(-torch.inf, device=q.device))
    m_intra = dmat.amax(dim=2)                           # [B,c,H]
    m_inter = fcum + m_prev[:, None, :]                  # [B,c,H]
    m_j = torch.maximum(torch.maximum(m_intra, m_inter),
                        torch.full_like(m_inter, -1e30))  # empty past

    w_intra = torch.exp(dmat - m_j[:, :, None, :])       # [B,c,c,H]
    scores = torch.einsum("bjhd,bshd->bjsh", q, k) * w_intra
    num = torch.einsum("bjsh,bshd->bjhd", scores, v)
    den = scores.sum(dim=2)                              # [B,c,H]

    w_inter = torch.exp(m_inter - m_j)                   # [B,c,H]
    num = num + w_inter[..., None] * torch.einsum("bjhe,bhde->bjhd", q,
                                                  c_prev)
    den = den + w_inter * torch.einsum("bjhd,bhd->bjh", q, n_prev)
    h = num / torch.maximum(den.abs(), torch.exp(-m_j))[..., None]

    # the state at the chunk's end
    m_new = torch.maximum(m_prev + ftot,
                          (i_raw + ftot[:, None, :] - fcum).amax(dim=1))
    w_c = torch.exp(m_prev + ftot - m_new)               # [B,H]
    w_s = torch.exp(i_raw + ftot[:, None, :] - fcum
                    - m_new[:, None, :])                 # [B,c,H]
    c_new = w_c[..., None, None] * c_prev \
        + torch.einsum("bsh,bshd,bshe->bhde", w_s, v, k)
    n_new = w_c[..., None] * n_prev + torch.einsum("bsh,bshd->bhd", w_s, k)
    return (c_new, n_new, m_new), h


def mlstm_apply(cfg: ModelConfig, p: Params, x):
    """x [B,S,d] -> [B,S,d]: the chunkwise mLSTM, the decode step's
    recurrence (``tests/test_torch_ssm.py`` holds the two together)."""
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim_
    x = x.to(cdt)
    up, res = (x @ p["up"].to(cdt)).chunk(2, dim=-1)
    xin = F.silu(_causal_conv(up, p["conv_w"].to(cdt)))

    q = (xin @ p["wq"].to(cdt)).reshape(b, s, nh, hd)
    k = (xin @ p["wk"].to(cdt)).reshape(b, s, nh, hd) / np.sqrt(hd)
    v = (up @ p["wv"].to(cdt)).reshape(b, s, nh, hd)
    i_raw, logf = _mlstm_gates(p, xin, cdt)                   # [B,S,H]

    chunk = min(MLSTM_CHUNK, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e30)
    logf = F.pad(logf, (0, 0, 0, pad))
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = (torch.zeros((b, nh, hd, hd), **f32),
             torch.zeros((b, nh, hd), **f32),
             torch.full((b, nh), -1e30, **f32))
    body = mlstm_chunk_body if nc == 1 else functools.partial(
        layers.checkpointed, mlstm_chunk_body)     # as Mamba's chunks
    hs = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        carry, h = body(carry, q[:, sl], k[:, sl], v[:, sl], i_raw[:, sl],
                        logf[:, sl])
        hs.append(h)
    h = torch.cat(hs, dim=1)[:, :s]
    out = _headwise_norm(h.to(cdt), p["gn"].to(cdt))
    out = out + F.silu(xin @ p["skip"].to(cdt))
    out = out * F.silu(res @ p["wv"].to(cdt))      # output gate from res
    return out @ p["down"].to(cdt)


def mlstm_init_state(cfg: ModelConfig, batch: int, layer_axes=(), *,
                     device) -> Params:
    """``conv`` [*layer_axes, B, conv_dim - 1, inner] in the compute dtype,
    ``c`` [..., B, H, hd, hd], ``n`` [..., B, H, hd] zero and ``m`` [...,
    B, H] at -inf, fp32."""
    nh, hd = cfg.num_heads, cfg.head_dim_
    inner = int(cfg.xlstm.mlstm_proj_factor * cfg.d_model)
    lead = tuple(layer_axes) + (batch,)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv": torch.zeros(lead + (cfg.xlstm.conv_dim - 1, inner),
                            dtype=dtype_of(cfg.compute_dtype), device=device),
        "c": torch.zeros(lead + (nh, hd, hd), **f32),
        "n": torch.zeros(lead + (nh, hd), **f32),
        "m": torch.full(lead + (nh,), -torch.inf, **f32),
    }


def mlstm_decode_step(cfg: ModelConfig, p: Params, x, state):
    """x [B,1,d]: one step of the mLSTM recurrence with the output gate
    that ``mlstm_apply`` applies (the reference's decode step leaves it
    out, ROADMAP §3); ``state`` is written in place. Returns (out [B,1,d],
    state)."""
    cdt = dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    b = x.shape[0]
    nh, hd = cfg.num_heads, cfg.head_dim_
    x = x.to(cdt)
    up, res = (x @ p["up"].to(cdt)).chunk(2, dim=-1)          # [B,1,inner]
    conv_buf = torch.cat([state["conv"], up], dim=1)
    # the forward's conv at its last position, as mamba_decode_step's
    xin = F.silu(_causal_conv(conv_buf, p["conv_w"].to(cdt))[:, -1:])

    q = (xin @ p["wq"].to(cdt)).reshape(b, nh, hd).to(f32)
    k = ((xin @ p["wk"].to(cdt)).reshape(b, nh, hd) / np.sqrt(hd)).to(f32)
    v = (up @ p["wv"].to(cdt)).reshape(b, nh, hd).to(f32)
    i_raw, logf = _mlstm_gates(p, xin, cdt)
    i_raw, logf = i_raw[:, 0], logf[:, 0]                     # [B,H]

    m_new = torch.maximum(logf + state["m"], i_raw)
    fprime = torch.exp(logf + state["m"] - m_new)[..., None]
    iprime = torch.exp(i_raw - m_new)[..., None]
    c = state["c"] * fprime[..., None] \
        + iprime[..., None] * torch.einsum("bhd,bhe->bhde", v, k)
    n = state["n"] * fprime + iprime * k
    num = torch.einsum("bhde,bhe->bhd", c, q)
    den = torch.maximum(torch.einsum("bhe,bhe->bh", n, q).abs(),
                        torch.exp(-m_new))[..., None]
    h = (num / den)[:, None]                                  # [B,1,H,hd]
    out = _headwise_norm(h.to(cdt), p["gn"].to(cdt))
    out = out + F.silu(xin @ p["skip"].to(cdt))
    out = out * F.silu(res @ p["wv"].to(cdt))      # output gate from res
    state["conv"].copy_(conv_buf[:, 1:])
    state["c"].copy_(c)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    return out @ p["down"].to(cdt), state


# ---------------------------------------------------------------------------
# sLSTM (xLSTM): scalar LSTM with exponential gating and recurrent mixing
# ---------------------------------------------------------------------------

def slstm_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    dt = dtype_of(cfg.param_dtype)
    d, nh, hd = cfg.d_model, cfg.num_heads, cfg.head_dim_
    ff = int(cfg.xlstm.slstm_proj_factor * d)
    return {
        "wx": dense_init(gen, d, 4 * nh * hd, dt, device),  # z, i, f, o
        "r": (_randn(gen, (4, nh, hd, hd), device) / np.sqrt(hd)).to(dt),
        "b": torch.zeros((4, nh, hd), dtype=dt, device=device),
        "gn": torch.ones((nh * hd,), dtype=dt, device=device),
        "up": dense_init(gen, nh * hd, 2 * ff, dt, device),
        "down": dense_init(gen, ff, d, dt, device),
    }


def slstm_cell(p, carry, xg):
    """One sLSTM step. carry: (h, c, n, m), each [B,H,hd] fp32; xg: the
    precomputed W x_t [B,4,H,hd]."""
    h, c, n, m = carry
    f32 = torch.float32
    rec = torch.einsum("bhd,ghde->bghe", h, p["r"].to(f32))   # [B,4,H,hd]
    g = xg.to(f32) + rec + p["b"].to(f32)
    z = torch.tanh(g[:, 0])
    o = torch.sigmoid(g[:, 3])
    logi = g[:, 1]
    logf = F.logsigmoid(g[:, 2])
    m_new = torch.maximum(logf + m, logi)
    i_ = torch.exp(logi - m_new)
    f_ = torch.exp(logf + m - m_new)
    c_new = f_ * c + i_ * z
    n_new = f_ * n + i_
    # torch.maximum, not clamp: at a tie (n = 1 exactly after the first
    # step) it splits the gradient, as the reference's jnp.maximum
    h_new = o * c_new / torch.maximum(n_new.abs(), torch.ones_like(n_new))
    return (h_new, c_new, n_new, m_new)


def _slstm_out(cfg: ModelConfig, p: Params, hs, cdt):
    """Head-wise norm of hs [B,S,H,hd], then the gated up/down projection."""
    out = _headwise_norm(hs.to(cdt), p["gn"].to(cdt))
    u, g = (out @ p["up"].to(cdt)).chunk(2, dim=-1)
    return (u * F.gelu(g, approximate="tanh")) @ p["down"].to(cdt)


def slstm_apply(cfg: ModelConfig, p: Params, x):
    """x [B,S,d] -> [B,S,d]: a sequential loop over S (recurrent memory
    mixing is the point of the sLSTM)."""
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim_
    xg = (x.to(cdt) @ p["wx"].to(cdt)).reshape(b, s, 4, nh, hd)
    f32 = dict(dtype=torch.float32, device=x.device)
    carry = tuple(torch.zeros((b, nh, hd), **f32) for _ in range(3)) \
        + (torch.full((b, nh, hd), -1e30, **f32),)
    hs = []
    for t in range(s):
        carry = slstm_cell(p, carry, xg[:, t])
        hs.append(carry[0])
    return _slstm_out(cfg, p, torch.stack(hs, dim=1), cdt)


def slstm_init_state(cfg: ModelConfig, batch: int, layer_axes=(), *,
                     device) -> Params:
    """``h``, ``c``, ``n`` [*layer_axes, B, H, hd] zero and ``m`` at
    -1e30, fp32."""
    shape = tuple(layer_axes) + (batch, cfg.num_heads, cfg.head_dim_)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
            "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, -1e30, **f32)}


def slstm_decode_step(cfg: ModelConfig, p: Params, x, state):
    """x [B,1,d]: one sLSTM step; ``state`` is written in place. Returns
    (out [B,1,d], state)."""
    cdt = dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    nh, hd = cfg.num_heads, cfg.head_dim_
    xg = (x.to(cdt) @ p["wx"].to(cdt)).reshape(b, 4, nh, hd)
    new = slstm_cell(p, tuple(state[k] for k in ("h", "c", "n", "m")), xg)
    for key, val in zip(("h", "c", "n", "m"), new):
        state[key].copy_(val)
    return _slstm_out(cfg, p, new[0][:, None], cdt), state
