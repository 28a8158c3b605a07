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

On DTensors (``sharding/dtensor.py``) routing is row-local, so it runs on
each rank's batch rows (``dtensor.on_shards``), and so do the scatter into
the batch-major buffer ``[B, slots, d]`` and the gather back. The
reference's ``set_buf_spec`` hints are layouts here: ``_constrain_b``
redistributes a buffer to the batch-major spec, ``_constrain_e`` to the
expert-major spec ``[B, E, C, d]`` (experts over (data, model)), and the
redistribute between the two is the expert all-to-all. The expert products
then run on each rank's experts. The launcher sets the specs under the
reference's condition (``num_experts % (data * model) == 0``); without
them the buffers keep the batch layout and DTensor partitions the expert
products by the weights' layout.
"""

from __future__ import annotations

import torch

from repro_torch.device import dtype_of
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, dense_init
from repro_torch.sharding import dtensor as dtn

#: layout specs of the dispatch buffers (spec tuples, as ``sharding/
#: specs.py`` gives them), set by the launcher when the experts divide over
#: (data, model): the expert products run expert-major, the scatter and
#: gather batch-major, and the two constraints around the reshape are the
#: token all-to-all of production expert parallelism
_BUF_SPEC_E = None     # [B, E, C, d] expert-major
_BUF_SPEC_B = None     # [B, slots, d] batch-major


def set_buf_spec(spec_e, spec_b=None):
    global _BUF_SPEC_E, _BUF_SPEC_B
    _BUF_SPEC_E = spec_e
    _BUF_SPEC_B = spec_b


def _constrain(x, spec):
    """``x`` in ``spec``'s layout. A mesh dim whose shard moves between
    the batch dim and the expert (slot) dim is an all-to-all over that
    dim (``dtensor.swap``); the others are gathered before it and split after
    it, so the experts' shard order is the weights' (data-major)."""
    if spec is None or not dtn.is_dt(x):
        return x
    from torch.distributed.tensor import Replicate
    from repro_torch.sharding.specs import placements
    target = placements(x.device_mesh, spec)
    pl = tuple(x.placements)
    swaps = [d for d, (a, b) in enumerate(zip(pl, target))
             if a.is_shard() and b.is_shard() and a.dim != b.dim]
    before = []
    for d, (a, b) in enumerate(zip(pl, target)):
        if d in swaps or a == b:
            before.append(a)
        elif b.is_shard():                  # split after the swaps
            before.append(a if a.is_replicate() else Replicate())
        else:                               # gathered or reduced before
            before.append(b)
    x = dtn.settle(x, before)
    for d in swaps:
        x = dtn.swap(x, d, target[d].dim)
    return dtn.settle(x, target)


def _constrain_e(x):
    return _constrain(x, _BUF_SPEC_E)


def _constrain_b(x):
    return _constrain(x, _BUF_SPEC_B)


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
    x_in = x
    xf = dtn.whole_on(x.to(cdt))                                 # [B, S, d]

    def route(xf, router):
        """Each row's routing, the batch-major buffer [b, E*C, d] and the
        rows' aux-loss share; ``dest`` points at the drop slot, the
        buffer's last row (every kept destination is unique, so only that
        row takes duplicate writes)."""
        bl = xf.shape[0]
        routed = [_route_one_row(row, router, cfg, cap) for row in xf]
        dest, weights, counts, probs = (torch.stack(t) for t in zip(*routed))
        # dest [b, S*K]; weights [b, S*K]; counts [b, E]; probs [b, S, E]
        copies = xf.repeat_interleave(k, dim=1)                  # [b,S*K,d]
        dest = torch.where(dest >= e * cap,
                           torch.full_like(dest, e_pad * cap), dest)
        rows = torch.arange(bl, device=xf.device)[:, None].expand_as(dest)
        buf = torch.zeros((bl, e_pad * cap + 1, d), dtype=cdt,
                          device=xf.device)
        buf = buf.index_put((rows, dest), copies)
        # each row's term of the load-balance aux loss (Switch-style)
        frac_tokens = counts.float() / max(s * k, 1)
        mean_prob = probs.mean(dim=1)                            # [b, E]
        return buf[:, :-1], dest, weights, \
            (frac_tokens * mean_prob).sum(dim=-1)

    def combine(y_flat, dest, weights):
        bl = y_flat.shape[0]
        y_flat = torch.cat([y_flat, torch.zeros((bl, 1, d), dtype=cdt,
                                                device=y_flat.device)], 1)
        rows = torch.arange(bl, device=y_flat.device)[:, None].expand_as(
            dest)
        out_copies = y_flat[rows, dest]                          # [b,S*K,d]
        return (out_copies.reshape(bl, s, k, d)
                * weights.reshape(bl, s, k)[..., None].to(cdt)).sum(dim=2)

    if dtn.is_dt(xf):
        rows_pl = xf.placements
        buf, dest, weights, terms = dtn.on_shards(
            route, (rows_pl,) * 4, xf, p["router"])
        aux = terms.sum() / b          # the mean over rows, a pending sum
    else:
        buf, dest, weights, terms = route(xf, p["router"])
        aux = terms.mean()
    aux = e * aux * m.aux_loss_weight
    buf = _constrain_b(buf)
    buf = _constrain_e(buf.reshape(b, e_pad, cap, d))

    act = layers.act_fn(cfg.act)
    h = act(_expert_product("becd,edf->becf", buf, p["w_gate"].to(cdt))) \
        * _expert_product("becd,edf->becf", buf, p["w_up"].to(cdt))
    y = _constrain_e(_expert_product("becf,efd->becd", h,
                                     p["w_down"].to(cdt)))

    y_flat = _constrain_b(y.reshape(b, e_pad * cap, d))
    if dtn.is_dt(y_flat):
        y_flat = dtn.settle(y_flat, dest.placements)
        out = dtn.on_shards(combine, dest.placements, y_flat, dest, weights)
    else:
        out = combine(y_flat, dest, weights)

    if m.num_shared_experts:
        out = out + layers.mlp_apply(cfg, p["shared"], xf)
    return layers.tp_out(out.reshape(b, s, d), x_in), aux


def _expert_product(eq: str, buf, w):
    """An expert einsum: on each rank's own experts where the buffer's
    expert dim (1) and the weights' (0) are split alike and nothing else
    is (the expert-major layout), else as DTensor partitions it (or a
    plain einsum)."""
    if dtn.is_dt(buf) and all(
            (a.is_replicate() and b.is_replicate())
            or (a.is_shard() and a.dim == 1 and b.is_shard() and b.dim == 0)
            for a, b in zip(buf.placements, w.placements)):
        return dtn.on_shards(lambda a, c: torch.einsum(eq, a, c),
                             buf.placements, buf, w)
    return torch.einsum(eq, buf, w)
