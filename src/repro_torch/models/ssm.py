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

On DTensor params and activations (``sharding/dtensor.py``) each mixer is
tensor parallel over the model axis in the reference's layouts
(``sharding/specs.py``): its input is whole on the model axis, its
column-parallel products split over their output columns, its
row-parallel output (``out_proj``, ``down``) reduced into the input's
layout. Mamba's ``in_proj`` product is cut into its halves by one
all-to-all (``dtensor.split_cols``), so each rank holds both halves of its
own channels, and the conv and the scan run on those channels with no
collective (B and C are gathered: every channel reads them). The mLSTM's
products after ``up`` contract over its channels, so ``up``'s product is
gathered whole; its recurrence runs on each rank's heads. The sLSTM's
four gates are cut by one all-to-all to each rank's heads, where the
recurrence runs with those heads of ``r`` and ``b``. Where the heads do
not divide the model axis the recurrences run on every head, on every
rank. Decode states keep ``cache_leaf_spec``'s layouts: the step's
inputs move to them, never a state leaf.

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
from repro_torch.sharding import dtensor as dtn

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
    bounded). On DTensors the products are column parallel over
    ``inner``, ``in_proj``'s halves are cut by ``dtensor.split_cols`` (one
    all-to-all, no gather of the product), B and C are gathered (every
    channel reads them), the conv and the scan run on each rank's own
    channels, and ``out_proj``'s partial sums are reduced into ``x``'s
    layout."""
    cdt = dtype_of(cfg.compute_dtype)
    x_in = x
    x = dtn.whole_on(x.to(cdt))                               # column-parallel
    xin, res = dtn.split_cols(x @ p["in_proj"].to(cdt), 2)    # [B,S,inner]
    dt_ = F.softplus(x @ p["w_dt"].to(cdt) + p["b_dt"].to(cdt))
    bmat, cmat = dtn.whole_on(x @ p["w_bc"].to(cdt)).chunk(2, dim=-1)
    args = (xin, res, dt_, bmat, cmat, p["conv_w"].to(cdt), p["a_log"],
            p["d_skip"].to(cdt))
    if dtn.is_dt(xin):
        pl = xin.placements
        rows = dtn.remap(pl, {0: 0})
        args = (xin, dtn.settle(res, pl), dtn.settle(dt_, pl),
                dtn.settle(bmat, rows), dtn.settle(cmat, rows)) + args[5:]
        y = dtn.on_shards(_mamba_mix, pl, *args)
    else:
        y = _mamba_mix(*args)
    return layers.tp_out(layers.row_parallel(y, p["out_proj"].to(cdt)),
                         x_in)


def _mamba_mix(xin, res, dt_, bmat, cmat, conv_w, a_log, d_skip):
    """The conv, the chunked scan and the gate over xin/res/dt [B,S,c]
    (every channel, or this rank's), bmat/cmat [B,S,state]: y [B,S,c]."""
    cdt = xin.dtype
    b, seq, inner = xin.shape
    xin = F.silu(_causal_conv(xin, conv_w))
    chunk = min(SSM_CHUNK, seq)
    nc = -(-seq // chunk)
    pad = nc * chunk - seq
    ins = [F.pad(t, (0, 0, 0, pad)) for t in (dt_, xin, bmat, cmat)]
    h = torch.zeros((b, inner, bmat.shape[-1]), dtype=torch.float32,
                    device=xin.device)
    # past one chunk each chunk body is rematerialised under autograd (the
    # reference's jax.checkpoint): only the chunk's inputs are kept, not
    # its [B,c,inner,state] discretised state
    body = mamba_chunk_body if nc == 1 else functools.partial(
        layers.checkpointed, mamba_chunk_body)
    p = {"a_log": a_log}
    ys = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        h, y = body(p, h, *(t[:, sl] for t in ins))
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :seq]
    return (y.to(cdt) + xin * d_skip) * F.silu(res)


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
    Returns (out [B,1,d], state). On DTensors the state keeps its
    ``cache_leaf_spec`` layout (``conv`` and ``h`` over the batch and
    ``inner``): the step's inputs move to it, as in ``mamba_apply``, and
    each rank updates its own channels; no state leaf moves."""
    cdt = dtype_of(cfg.compute_dtype)
    x_in = x
    x = dtn.whole_on(x.to(cdt))
    xin, res = dtn.split_cols(x @ p["in_proj"].to(cdt), 2)    # [B,1,inner]
    dt_ = F.softplus(x @ p["w_dt"].to(cdt) + p["b_dt"].to(cdt))
    bmat, cmat = dtn.whole_on(x @ p["w_bc"].to(cdt)).chunk(2, dim=-1)
    args = [state["conv"], state["h"], xin, res, dt_, bmat, cmat,
            p["conv_w"].to(cdt), p["a_log"], p["d_skip"].to(cdt)]
    if dtn.is_dt(xin):
        pl = state["conv"].placements     # [B, K-1, inner]: as [B, 1, inner]
        rows = dtn.remap(pl, {0: 0})
        args[2:7] = [dtn.settle(t, pl) for t in (xin, res, dt_)] + [
            dtn.settle(t, rows) for t in (bmat, cmat)]
        y = dtn.on_shards(_mamba_step, pl, *args)
    else:
        y = _mamba_step(*args)
    return layers.tp_out(layers.row_parallel(y, p["out_proj"].to(cdt)),
                         x_in), state


def _mamba_step(conv, h, xin, res, dt_, bmat, cmat, conv_w, a_log, d_skip):
    """One recurrent step over xin/res/dt [B,1,c] (every channel, or this
    rank's) from the state ``conv`` [B,K-1,c], ``h`` [B,c,state], both
    written in place: y [B,1,c]."""
    cdt = xin.dtype
    f32 = torch.float32
    conv_buf = torch.cat([conv, xin], dim=1)                  # [B,K,c]
    # the forward's conv at its last position (the reference sums with an
    # einsum): the same products in the same order, so in bf16 decode and
    # forward round alike
    xin = F.silu(_causal_conv(conv_buf, conv_w)[:, -1:])
    a = -torch.exp(a_log.to(f32))
    abar = torch.exp(dt_[..., None].to(f32) * a)[:, 0]        # [B,c,st]
    bx = (dt_ * xin)[..., None].to(f32) * bmat[:, :, None, :].to(f32)
    h_new = h * abar + bx[:, 0]                               # [B,c,st]
    y = torch.einsum("bit,bt->bi", h_new, cmat[:, 0].to(f32))
    y = (y[:, None, :].to(cdt) + xin * d_skip) * F.silu(res)
    conv.copy_(conv_buf[:, 1:])
    h.copy_(h_new)
    return y


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
    """(i_raw, log f) [B,S,H] fp32 from xin [B,S,inner] (whole on the
    model axis on DTensors: ``w_if`` is replicated, ``b_if`` gathered)."""
    gif = xin @ p["w_if"].to(cdt) + dtn.whole_on(p["b_if"].to(cdt))
    i_raw, f_raw = gif.to(torch.float32).chunk(2, dim=-1)
    if dtn.is_dt(f_raw):     # DTensor has no rule for its backward
        return i_raw, dtn.on_shards(F.logsigmoid, f_raw.placements, f_raw)
    return i_raw, F.logsigmoid(f_raw)


def _headwise_norm(h, gain, eps: float = 1e-6):
    """Group norm per head of h [..., H, hd], flattened to [..., H*hd]
    and scaled by ``gain``. On DTensors it runs on each rank's heads, with
    ``gain`` split as the heads are (gathered where they are whole), so the
    flattened dim is split only at head boundaries, in the backward too."""
    if dtn.is_dt(h):
        from torch.distributed.tensor import Replicate, Shard
        heads = h.ndim - 2
        gain = dtn.settle(gain, [Shard(0) if p.is_shard(heads)
                                 else Replicate() for p in h.placements])
        return dtn.on_shards(lambda hl, gl: _headwise_norm(hl, gl, eps),
                             h.placements, h, gain)
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    out = (h - mu) * torch.rsqrt(var + eps)
    return out.reshape(*h.shape[:-2], -1) * gain


MLSTM_CHUNK = 256

#: the stabiliser state ``m``'s start in a fresh decode state, by kind
M_START = {"mlstm": -float("inf"), "slstm": -1e30}


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
    recurrence (``tests/test_torch_ssm.py`` holds the two together). On
    DTensors every product after ``up`` contracts over ``inner``, so
    ``up``'s product is gathered whole before its split (and the conv runs
    on it whole); the q/k/v, skip and output-gate products are column
    parallel over the heads, the chunked recurrence runs on each rank's
    heads (all of them where the heads do not divide the model axis), and
    ``down``'s partial sums are reduced into ``x``'s layout."""
    cdt = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim_
    x_in = x
    x = dtn.whole_on(x.to(cdt))
    up, res = dtn.whole_on(x @ p["up"].to(cdt)).chunk(2, dim=-1)
    conv_w = dtn.whole_on(p["conv_w"].to(cdt))
    xin = F.silu(dtn.on_shards(_causal_conv, up.placements, up, conv_w)
                 if dtn.is_dt(up) else _causal_conv(up, conv_w))

    q = (xin @ p["wq"].to(cdt)).reshape(b, s, nh, hd)
    k = (xin @ p["wk"].to(cdt)).reshape(b, s, nh, hd) / np.sqrt(hd)
    v = (up @ p["wv"].to(cdt)).reshape(b, s, nh, hd)
    i_raw, logf = _mlstm_gates(p, xin, cdt)                   # [B,S,H]
    if dtn.is_dt(q):
        pl = q.placements           # [B,S,H,hd]: as [B,S,H] on dims 0, 2
        args = [q] + [dtn.settle(t, pl) for t in (k, v, i_raw, logf)]
        h = dtn.on_shards(_mlstm_scan, pl, *args)
    else:
        h = _mlstm_scan(q, k, v, i_raw, logf)
    out = _headwise_norm(h.to(cdt), p["gn"].to(cdt))
    out = out + F.silu(xin @ p["skip"].to(cdt))
    out = out * F.silu(res @ p["wv"].to(cdt))      # output gate from res
    return layers.tp_out(layers.row_parallel(out, p["down"].to(cdt)), x_in)


def _mlstm_scan(q, k, v, i_raw, logf):
    """The chunked recurrence from a zero state over q/k/v [B,S,H,hd]
    and the gates [B,S,H] (every head, or this rank's): h [B,S,H,hd]
    fp32."""
    b, s, nh, hd = q.shape
    chunk = min(MLSTM_CHUNK, s)
    nc = -(-s // chunk)
    pad = nc * chunk - s
    q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    i_raw = F.pad(i_raw, (0, 0, 0, pad), value=-1e30)
    logf = F.pad(logf, (0, 0, 0, pad))
    f32 = dict(dtype=torch.float32, device=q.device)
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
    return torch.cat(hs, dim=1)[:, :s]


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
        "m": torch.full(lead + (nh,), M_START["mlstm"], **f32),
    }


def mlstm_decode_step(cfg: ModelConfig, p: Params, x, state):
    """x [B,1,d]: one step of the mLSTM recurrence with the output gate
    that ``mlstm_apply`` applies (the reference's decode step leaves it
    out, ROADMAP §3); ``state`` is written in place. Returns (out [B,1,d],
    state). On DTensors the state keeps its ``cache_leaf_spec`` layout:
    the conv runs on each rank's channels of ``conv`` (its output is then
    gathered, one token's), the recurrence on each rank's heads of ``c``,
    ``n`` and ``m``; no state leaf moves."""
    cdt = dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    b = x.shape[0]
    nh, hd = cfg.num_heads, cfg.head_dim_
    x_in = x
    x = dtn.whole_on(x.to(cdt))
    up, res = dtn.whole_on(x @ p["up"].to(cdt)).chunk(2, dim=-1)  # [B,1,in]
    conv_w = p["conv_w"].to(cdt)
    if dtn.is_dt(up):
        pl = state["conv"].placements       # [B, K-1, inner]
        xin = dtn.whole_on(dtn.on_shards(
            _conv_step, pl, state["conv"], dtn.settle(up, pl), conv_w))
    else:
        xin = _conv_step(state["conv"], up, conv_w)

    q = (xin @ p["wq"].to(cdt)).reshape(b, nh, hd).to(f32)
    k = ((xin @ p["wk"].to(cdt)).reshape(b, nh, hd) / np.sqrt(hd)).to(f32)
    v = (up @ p["wv"].to(cdt)).reshape(b, nh, hd).to(f32)
    i_raw, logf = _mlstm_gates(p, xin, cdt)
    i_raw, logf = i_raw[:, 0], logf[:, 0]                     # [B,H]
    args = [state["c"], state["n"], state["m"], q, k, v, i_raw, logf]
    if dtn.is_dt(q):
        pl = state["c"].placements         # [B, H, ...] on dims 0 and 1
        args[3:] = [dtn.settle(t, pl) for t in args[3:]]
        h = dtn.on_shards(_mlstm_step, pl, *args)
    else:
        h = _mlstm_step(*args)
    out = _headwise_norm(h[:, None].to(cdt), p["gn"].to(cdt))
    out = out + F.silu(xin @ p["skip"].to(cdt))
    out = out * F.silu(res @ p["wv"].to(cdt))      # output gate from res
    return layers.tp_out(layers.row_parallel(out, p["down"].to(cdt)),
                         x_in), state


def _conv_step(conv, u, w):
    """The causal conv's output at a new input u [B,1,c] after the state
    ``conv`` [B,K-1,c] (written in place): silu of the forward's conv at
    its last position, as ``mamba_decode_step``'s."""
    buf = torch.cat([conv, u], dim=1)
    out = F.silu(_causal_conv(buf, w)[:, -1:])
    conv.copy_(buf[:, 1:])
    return out


def _mlstm_step(c, n, m, q, k, v, i_raw, logf):
    """One recurrence step over q/k/v [B,H,hd] and the gates [B,H] (every
    head, or this rank's) from the state ``c``, ``n``, ``m``, written in
    place: h [B,H,hd] fp32."""
    m_new = torch.maximum(logf + m, i_raw)
    fprime = torch.exp(logf + m - m_new)[..., None]
    iprime = torch.exp(i_raw - m_new)[..., None]
    c_new = c * fprime[..., None] \
        + iprime[..., None] * torch.einsum("bhd,bhe->bhde", v, k)
    n_new = n * fprime + iprime * k
    num = torch.einsum("bhde,bhe->bhd", c_new, q)
    den = torch.maximum(torch.einsum("bhe,bhe->bh", n_new, q).abs(),
                        torch.exp(-m_new))[..., None]
    c.copy_(c_new)
    n.copy_(n_new)
    m.copy_(m_new)
    return num / den


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


def _slstm_x(cfg: ModelConfig, p: Params, x, cdt):
    """The precomputed W x [B,S,4,H,hd] from x [B,S,d]. On DTensors x is
    whole on the model axis and ``wx`` column parallel, so the product is
    split over its gate dim; where the heads divide the model axis its
    four gates are cut by ``dtensor.split_cols`` (each rank's heads of
    every gate, one all-to-all), else it is gathered whole."""
    b, s = x.shape[:2]
    nh, hd = cfg.num_heads, cfg.head_dim_
    y = dtn.whole_on(x.to(cdt)) @ p["wx"].to(cdt)
    if not dtn.is_dt(y):
        return y.reshape(b, s, 4, nh, hd)
    md = dtn.mesh_dim(y.device_mesh, "model")
    if md is not None and nh % y.device_mesh.size(md) == 0:
        parts = dtn.split_cols(y, 4)
    else:
        parts = dtn.split_cols(dtn.whole_on(y), 4)
    return dtn.on_shards(
        lambda *ts: torch.stack([t.unflatten(-1, (-1, hd)) for t in ts],
                                dim=2),
        dtn.remap(parts[0].placements, {0: 0, 2: 3}), *parts)


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


def _slstm_out(cfg: ModelConfig, p: Params, hs, cdt, like):
    """Head-wise norm of hs [B,S,H,hd], then the gated up/down projection;
    on DTensors the normed heads are gathered (``up`` contracts over
    them), ``up``'s halves cut by ``dtensor.split_cols``, and ``down``'s
    partial sums reduced into ``like``'s layout."""
    out = _headwise_norm(hs.to(cdt), p["gn"].to(cdt))
    u, g = dtn.split_cols(dtn.whole_on(out) @ p["up"].to(cdt), 2)
    return layers.tp_out(layers.row_parallel(
        u * F.gelu(g, approximate="tanh"), p["down"].to(cdt)), like)


def slstm_apply(cfg: ModelConfig, p: Params, x):
    """x [B,S,d] -> [B,S,d]: a sequential loop over S (recurrent memory
    mixing is the point of the sLSTM). On DTensors the loop runs on each
    rank's heads (all of them where the heads do not divide the model
    axis), with its heads of ``r`` and ``b``."""
    cdt = dtype_of(cfg.compute_dtype)
    xg = _slstm_x(cfg, p, x, cdt)                             # [B,S,4,H,hd]
    if dtn.is_dt(xg):
        heads = dtn.remap(xg.placements, {3: 1})              # [4,H,...]
        hs = dtn.on_shards(_slstm_scan, dtn.remap(xg.placements,
                                                  {0: 0, 3: 2}),
                           xg, dtn.settle(p["r"], heads),
                           dtn.settle(p["b"], heads))
    else:
        hs = _slstm_scan(xg, p["r"], p["b"])
    return _slstm_out(cfg, p, hs, cdt, x)


def _slstm_scan(xg, r, b):
    """The recurrence from a zero state over xg [B,S,4,H,hd] (every head,
    or this rank's, with their ``r`` and ``b``): hs [B,S,H,hd] fp32."""
    bsz, s, _, nh, hd = xg.shape
    f32 = dict(dtype=torch.float32, device=xg.device)
    carry = tuple(torch.zeros((bsz, nh, hd), **f32) for _ in range(3)) \
        + (torch.full((bsz, nh, hd), -1e30, **f32),)
    p = {"r": r, "b": b}
    hs = []
    for t in range(s):
        carry = slstm_cell(p, carry, xg[:, t])
        hs.append(carry[0])
    return torch.stack(hs, dim=1)


def slstm_init_state(cfg: ModelConfig, batch: int, layer_axes=(), *,
                     device) -> Params:
    """``h``, ``c``, ``n`` [*layer_axes, B, H, hd] zero and ``m`` at
    -1e30, fp32."""
    shape = tuple(layer_axes) + (batch, cfg.num_heads, cfg.head_dim_)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
            "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, M_START["slstm"], **f32)}


_SLSTM_STATE = ("h", "c", "n", "m")


def slstm_decode_step(cfg: ModelConfig, p: Params, x, state):
    """x [B,1,d]: one sLSTM step; ``state`` is written in place. Returns
    (out [B,1,d], state). On DTensors the state keeps its
    ``cache_leaf_spec`` layout: the step's gates move to it and each rank
    updates its own heads."""
    cdt = dtype_of(cfg.compute_dtype)
    xg = _slstm_x(cfg, p, x, cdt)[:, 0]                       # [B,4,H,hd]
    args = [state[k] for k in _SLSTM_STATE] + [xg, p["r"], p["b"]]
    if dtn.is_dt(xg):
        pl = state["h"].placements                            # [B,H,hd]
        heads = dtn.remap(pl, {1: 1})
        args[4:] = [dtn.settle(xg, dtn.remap(pl, {0: 0, 1: 2})),
                    dtn.settle(p["r"], heads), dtn.settle(p["b"], heads)]
        h = dtn.on_shards(_slstm_step, pl, *args)
    else:
        h = _slstm_step(*args)
    return _slstm_out(cfg, p, h[:, None], cdt, x), state


def _slstm_step(h, c, n, m, xg, r, b):
    """One cell step from the state (written in place) over xg [B,4,H,hd]:
    the new h [B,H,hd]."""
    new = slstm_cell({"r": r, "b": b}, (h, c, n, m), xg)
    for leaf, val in zip((h, c, n, m), new):
        leaf.copy_(val)
    return new[0]
