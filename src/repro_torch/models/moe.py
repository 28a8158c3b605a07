"""Mixture-of-Experts: top-k router and capacity-grouped sorted dispatch
(port of ``repro.models.moe``).

Dispatch is row-local, as the reference's: routing, the stable sort by
expert and the capacity cut run per batch row. The router stays at the
true expert count; the expert tensors are padded (``padded_experts``:
granite's 40 to 48) and the padded experts are never routed to. A copy
past its expert's capacity goes to one drop slot, whose row is thrown
away. The aux loss is Switch-style. The expert products are plain einsums
(batched matmuls), as the reference's are plain jnp outside any Pallas
kernel.

The reference's ``set_buf_spec`` and ``_constrain_*`` are GSPMD sharding
hints on the dispatch buffers for expert parallelism; they have no
counterpart until the port shards a model (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import torch

from repro_torch.device import dtype_of
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense_init


def capacity(tokens_per_row: int, cfg: ModelConfig) -> int:
    """Slots per expert for a row of ``tokens_per_row`` tokens: the
    capacity factor's share, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(tokens_per_row * m.top_k / m.num_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def padded_experts(cfg: ModelConfig, align: int = 16) -> int:
    """Expert tensors are padded to a multiple of ``align`` (the model
    axis's size in the reference's sharding) when there are at least
    ``align`` experts: granite's 40 -> 48."""
    e = cfg.moe.num_experts
    if e % align == 0 or e < align:
        return e
    return -(-e // align) * align


def _experts_init(gen: torch.Generator, e: int, d_in: int, d_out: int,
                  dtype, device) -> torch.Tensor:
    """[e, d_in, d_out] normal / sqrt(d_in), drawn one expert at a time so
    that the fp32 draw of a full-width expert stack (15 GB for deepseek's
    256) never lives at once."""
    out = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
    if out.is_meta:                  # shapes only: nothing to draw
        return out
    for i in range(e):
        out[i] = dense_init(gen, d_in, d_out, dtype, device)
    return out


def moe_params(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    m = cfg.moe
    dt = dtype_of(cfg.param_dtype)
    d, f, e = cfg.d_model, m.d_expert, padded_experts(cfg)
    p = {
        # the router stays at the true expert count (padded experts are
        # unreachable)
        "router": dense_init(gen, d, m.num_experts, torch.float32, device),
        "w_gate": _experts_init(gen, e, d, f, dt, device),
        "w_up": _experts_init(gen, e, d, f, dt, device),
        "w_down": _experts_init(gen, e, f, d, dt, device),
    }
    if m.num_shared_experts:
        p["shared"] = layers.mlp_params(gen, cfg, d, f * m.num_shared_experts,
                                        device)
    return p


def _route_one_row(xf, router, cfg: ModelConfig, cap: int):
    """Routing of one row: xf [S, d] -> (dest [S*K], weights [S*K],
    counts [E], probs [S, E]). Copy ``t*K + j`` is token t's j-th choice;
    ``dest == E*cap`` means dropped. Within an expert, copies keep token
    order (a stable sort), so the first ``cap`` tokens are kept."""
    m = cfg.moe
    k, e = m.top_k, m.num_experts
    s = xf.shape[0]
    logits = xf.float() @ router                                 # [S, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)                  # [S, K]
    if m.router_scale:
        top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat_e = top_i.reshape(s * k)
    sorted_e, order = torch.sort(flat_e, stable=True)
    # the reference's bincount(length=E), without torch.bincount's read of
    # the largest index back to the host
    counts = torch.zeros(e, dtype=flat_e.dtype, device=xf.device)
    counts = counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(s * k, device=xf.device) - offsets[sorted_e]
    keep = rank < cap
    dest_sorted = torch.where(keep, sorted_e * cap + rank,
                              torch.full_like(rank, e * cap))
    # un-sort, so dest lines up with the copy index
    dest = torch.empty_like(dest_sorted).scatter_(0, order, dest_sorted)
    return dest, top_p.reshape(s * k), counts, probs


def moe_apply(cfg: ModelConfig, p: Params, x):
    """x [B, S, d] -> (out [B, S, d], aux loss, a scalar)."""
    m = cfg.moe
    cdt = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    k, e = m.top_k, m.num_experts
    cap = capacity(s, cfg)
    e_pad = padded_experts(cfg)
    xf = x.to(cdt)                                               # [B, S, d]
    routed = [_route_one_row(row, p["router"], cfg, cap) for row in xf]
    dest, weights, counts, probs = (torch.stack(t) for t in zip(*routed))
    # dest [B, S*K]; weights [B, S*K]; counts [B, E]; probs [B, S, E]

    copies = xf.repeat_interleave(k, dim=1)                      # [B,S*K,d]
    # the drop slot is the buffer's last row; every kept destination is
    # unique, so only that row takes duplicate writes
    dest = torch.where(dest >= e * cap, torch.full_like(dest, e_pad * cap),
                       dest)
    rows = torch.arange(b, device=x.device)[:, None].expand_as(dest)
    buf = torch.zeros((b, e_pad * cap + 1, d), dtype=cdt, device=x.device)
    buf = buf.index_put((rows, dest), copies)
    buf = buf[:, :-1].reshape(b, e_pad, cap, d)

    act = layers.act_fn(cfg.act)
    h = act(torch.einsum("becd,edf->becf", buf, p["w_gate"].to(cdt))) \
        * torch.einsum("becd,edf->becf", buf, p["w_up"].to(cdt))
    y = torch.einsum("becf,efd->becd", h, p["w_down"].to(cdt))

    y_flat = torch.cat([y.reshape(b, e_pad * cap, d),
                        torch.zeros((b, 1, d), dtype=cdt, device=x.device)],
                       dim=1)
    out_copies = y_flat[rows, dest]                              # [B,S*K,d]
    out = (out_copies.reshape(b, s, k, d)
           * weights.reshape(b, s, k)[..., None].to(cdt)).sum(dim=2)

    if m.num_shared_experts:
        out = out + layers.mlp_apply(cfg, p["shared"], xf)

    # load-balance aux loss (Switch-style), averaged over rows
    frac_tokens = counts.float() / max(s * k, 1)
    mean_prob = probs.mean(dim=1)                                # [B, E]
    aux = e * (frac_tokens * mean_prob).sum(dim=-1).mean() \
        * m.aux_loss_weight
    return out.reshape(b, s, d), aux
