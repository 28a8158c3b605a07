"""Shared layer primitives on plain tensors (port of ``repro.models.layers``:
norms, the gated MLP, rotary embeddings (1-D and Qwen2-VL's M-RoPE), the
initialisers and the cross-entropy losses), and ``checkpoint_name``, the
reference's ``jax.ad_checkpoint.checkpoint_name`` tags on the q/k/v
projections and the MLP's pre-activations, which ``remat="names"`` saves.

On DTensor params and activations (``sharding/dtensor.py``) the MLP is
tensor parallel (its input replicated on the model axis, the partial sums
of the row-parallel product reduced into the input's layout), RoPE and
M-RoPE run on each rank's shards (at decode, on the positions of each
rank's own rows: ``dtensor.rows_of``), the embedding lookup and the fused
cross-entropy are vocab parallel; on plain tensors every function is the
one-device arithmetic.

Params are the reference's nested dicts of tensors. Initialisers draw from
an explicit ``torch.Generator``; they cannot reproduce ``jax.random``, so
parity tests hand reference params over through ``repro_torch.convert``.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.device import dtype_of
from repro_torch.sharding import dtensor as dtn

Params = dict  # nested dict of tensors

# the name of the products being computed (``checkpoint_name``), read by
# ``models/lm.py``'s selective-checkpoint policy under ``remat="names"``
_CHECKPOINT_NAME: contextvars.ContextVar[str | None] = \
    contextvars.ContextVar("checkpoint_name", default=None)


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Tag the matmuls run inside the block with ``name``, as the
    reference's ``checkpoint_name`` tags their outputs."""
    token = _CHECKPOINT_NAME.set(name)
    try:
        yield
    finally:
        _CHECKPOINT_NAME.reset(token)


def current_checkpoint_name() -> str | None:
    return _CHECKPOINT_NAME.get()


def records_grad(*trees) -> bool:
    """Whether autograd records a call on these args: grad mode is on and
    some tensor among them (dict values included) requires grad."""
    def needs(t):
        if isinstance(t, dict):
            return any(needs(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return any(needs(v) for v in t)
        return isinstance(t, torch.Tensor) and t.requires_grad
    return torch.is_grad_enabled() and needs(trees)


def checkpointed(fn, *args):
    """``fn(*args)``, rematerialised in the backward while autograd records
    it (the reference's ``jax.checkpoint`` around a chunk body: only the
    chunk's inputs are kept); a plain call otherwise."""
    if not records_grad(args):
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    if torch.device(device).type == "meta":    # shapes only: nothing drawn
        return torch.empty(shape, device="meta")
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
    xin = dtn.whole_on(x)                 # column-parallel input
    with checkpoint_name("mlp_pre_up"):
        up = xin @ p["w_up"].to(cdt)
    if "w_gate" in p:
        with checkpoint_name("mlp_pre_gate"):
            gate = xin @ p["w_gate"].to(cdt)
        up = act_fn(cfg.act)(gate) * up
    else:
        up = act_fn(cfg.act)(up)
    return tp_out(row_parallel(up, p["w_down"].to(cdt)), x).to(cdt)


def row_parallel(a, w):
    """``a @ w``. Where the contraction dim is split over the model axis
    of more than one rank (a row-parallel product on DTensors) and the
    operands are 16-bit, each rank's partial sum is kept in fp32 (its own
    product accumulates in fp32), so the reduced sum rounds once, as one
    device's product does; else the plain product (partial sums in
    ``a``'s dtype; on one rank, one device's product)."""
    if not dtn.is_dt(a) or a.dtype not in (torch.bfloat16, torch.float16):
        return a @ w
    from torch.distributed.tensor import Partial, Shard
    md = dtn.mesh_dim(a.device_mesh, "model")
    if md is None or a.device_mesh.size(md) == 1 \
            or a.placements[md] != Shard(a.ndim - 1) \
            or w.placements[md] != Shard(0):
        return a @ w
    return dtn.on_shards(lambda x, y: x.float() @ y.float(),
                         dtn.with_dim(a.placements, md, Partial()), a, w)


def tp_out(y, like):
    """A row-parallel product's result in the layout of the block's input
    ``like``: its partial sums over the model axis all-reduced, or
    reduce-scattered into a sequence-sharded stream (plain tensors pass
    through)."""
    return dtn.settle(y, like.placements) if dtn.is_dt(y) else y


# -- rotary embeddings ------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: broadcastable to [..., S]. The head dim
    splits into halves (x1, x2), rotated by the same angles. On DTensors it
    runs on each rank's shards (heads and batch rows stay whole or split
    alike; positions are those rows')."""
    if dtn.is_dt(x):
        return dtn.on_shards(lambda xl, pl: apply_rope(xl, pl, theta),
                             x.placements, x, positions)
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
    (arXiv:2409.12191). In fp32, as ``apply_rope``; on DTensors on each
    rank's shards, as ``apply_rope`` (positions3 split over the batch on
    dim 1 as x's rows on dim 0)."""
    if dtn.is_dt(x):
        return dtn.on_shards(
            lambda xl, pl: apply_mrope(xl, pl, theta, sections),
            x.placements, x, positions3)
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


# -- embedding lookup -------------------------------------------------------------

def embed_lookup(table, tokens):
    """``table[tokens]``. On a vocab-sharded DTensor table each rank looks
    up the tokens in its own rows (the others give zero rows), so the
    result holds partial sums over the model axis, which the caller's
    layout constraint reduces; no rank gathers the table."""
    if not dtn.is_dt(table):
        return table[tokens]
    from torch.distributed.tensor import Partial
    mesh = table.device_mesh
    md = dtn.mesh_dim(mesh, "model")
    if md is None or not table.placements[md].is_shard():
        return dtn.on_shards(lambda t, i: t[i], tokens.placements, table,
                             tokens)
    if table.placements[md].dim != 0 or any(
            p.is_shard() for i, p in enumerate(table.placements) if i != md):
        raise NotImplementedError(
            f"an embedding table placed {table.placements}: the lookup "
            "takes rows over the model axis, replicated elsewhere")
    rows = table.shape[0] // mesh.size(md)
    v0 = dtn.local_rank(mesh, "model") * rows

    def lookup(t, i):
        j = i.long() - v0
        ok = (j >= 0) & (j < rows)
        out = t[torch.where(ok, j, 0)]
        return torch.where(ok[..., None], out, torch.zeros((), dtype=t.dtype,
                                                           device=t.device))
    out_pl = dtn.with_dim(tokens.placements, md, Partial())
    return dtn.on_shards(lookup, out_pl, table, tokens)


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
    if dtn.is_dt(h):
        return _xent_sharded(h, w_head, labels, chunk)
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


def _xent_sharded(h, w_head, labels, chunk: int):
    """``softmax_xent_fused`` on DTensors: h [B,S,d] batch-sharded over the
    data axes and whole on model, labels alike, ``w_head`` [d,V] with its
    vocab over model or replicated. Per chunk each rank computes its
    logits for its own vocab slice; the max (no gradient), and the sum of
    exponentials with the gold logit (masked to the rank's vocab range, one
    stacked tensor) are each all-reduced over model. The NLL sum is then a
    partial sum over the data axes; the mean is a DTensor with that
    pending sum (the caller's layout reduces it)."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = h.device_mesh
    md = dtn.mesh_dim(mesh, "model")
    h = dtn.whole_on(h)
    labels = dtn.whole_on(labels)
    w = w_head.to(h.dtype)
    sharded = md is not None and w.placements[md].is_shard()
    if sharded and w.placements[md].dim != 1:
        raise NotImplementedError(f"a head placed {w.placements}")
    b, s = labels.shape[0], labels.shape[1]
    v_loc = w.shape[-1] // (mesh.size(md) if sharded else 1)
    v0 = dtn.local_rank(mesh, "model") * v_loc if sharded else 0
    row_pl = h.placements                  # [b, c] tensors: h's batch dims
    red_pl = dtn.with_dim(row_pl, md, Partial()) if sharded else row_pl
    max_pl = dtn.with_dim(row_pl, md, Partial("max")) if sharded else row_pl
    rows_whole = dtn.with_dim(row_pl, md, Replicate()) if sharded else row_pl

    def allreduce(t, pl):
        if not sharded:
            return t
        return dtn.from_local(t, mesh, pl).redistribute(
            mesh, rows_whole).to_local()

    nll_sum = None
    for i in range(0, s, chunk):
        hc = h[:, i:i + chunk]
        # each rank's products are partial sums of h's gradient over the
        # vocab (model) and of w's over the rows (data)
        hl, wl = dtn.local(hc, (w,)), dtn.local(w, (hc,))
        ll = labels[:, i:i + chunk].to_local()
        logits = (hl @ wl).float()                     # [b_l, c, v_loc]
        mx = allreduce(logits.detach().amax(dim=-1), max_pl)
        sumexp = torch.exp(logits - mx[..., None]).sum(dim=-1)
        j = ll.long() - v0
        ok = (j >= 0) & (j < v_loc)
        gold = torch.take_along_dim(logits, torch.where(ok, j, 0)[..., None],
                                    dim=-1)[..., 0]
        gold = torch.where(ok, gold, torch.zeros((), device=gold.device))
        both = allreduce(torch.stack([sumexp, gold], dim=-1), red_pl)
        nll = torch.log(both[..., 0]) + mx - both[..., 1]
        part = dtn.from_local(nll.sum(), mesh, [
            Partial() if p.is_shard() else Replicate() for p in row_pl])
        nll_sum = part if nll_sum is None else nll_sum + part
    return nll_sum / (b * s)
