"""train_step / eval_step factories with the full optimizer update (port of
``repro.train.trainstep``).

The gradients come from ``torch.autograd`` over ``model.loss``. A train
step runs the loss on the branch the reference trains with: a model whose
``attn_impl`` is ``None`` (the CUDA flash kernel on a card, which has no
backward) runs the step with ``attn_impl = "reference"``, the chunked path
(``models/attention.py``), and gets its ``None`` back afterwards; an
explicit ``"flash"`` is kept, and its backward raises as the kernel's
does. The eval step runs ``model.loss`` as the model is set: on a card,
every layer's attention through the flash kernel.

On DTensor params and batches the step is sharded (``sharding/
dtensor.py``). ``grad_specs`` and ``mb_specs`` are the reference's layout
constraints, as trees of ``(DeviceMesh, placements)`` pairs
(``sharding/specs.py``'s ``grad_shardings`` and ``mb_shardings``):
``mb_specs`` re-pins each microbatch's batch layout after the ``[accum,
B/accum, ...]`` reshape, and ``grad_specs`` keeps the accumulator in the
ZeRO layout, so each microbatch's gradients are reduce-scattered into it
instead of summed into a replicated one.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import dtensor as dtn
from repro_torch.sharding import specs as sh
from repro_torch.train import optimizer as opt


def opt_config_for(cfg: ModelConfig, **overrides) -> opt.OptConfig:
    """Per-arch optimizer layout: 671B-scale bf16 models get int8 moments and
    no fp32 master (the only layout that fits a single v5e pod)."""
    kw: dict[str, Any] = {}
    if cfg.param_counts()["total"] > 1e11:
        kw.update(quantized_moments=True, master_fp32=False)
    kw.update(overrides)
    return opt.OptConfig(**kw)


@contextlib.contextmanager
def training_branch(model):
    """``model.attn_impl`` as the reference trains while the block runs:
    ``"reference"`` where it is ``None``; any other value is kept."""
    saved = getattr(model, "attn_impl", "reference")
    if saved is None:
        model.attn_impl = "reference"
    try:
        yield
    finally:
        if saved is None:
            model.attn_impl = None


def _grad_fn(model, params, mb):
    """(grads in the params' dtypes, metrics with ``loss``) of
    ``model.loss`` at ``params`` on the microbatch ``mb``. The grads are
    taken w.r.t. fresh leaves over the params' storage, so the params
    themselves never require grad."""
    tree = opt.tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = opt.tree_leaves(tree)
    loss, metrics = model.loss(tree, mb)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(t): (torch.zeros_like(t) if g is None else g)
             for t, g in zip(flat, grads)}
    grads = opt.tree_map(lambda t: by_id[id(t)], tree)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return grads, {**metrics, "loss": loss.detach()}


def accumulated_grads(model, params, batch, accum_steps: int = 1,
                      grad_specs=None, mb_specs=None):
    """(grads, metrics) of ``model.loss`` over ``batch`` on the branch the
    reference trains with (``training_branch``). accum_steps > 1 splits the
    batch into microbatches ``[accum, B/accum, ...]`` run one after the
    other, so the per-layer activation stash is sized by the microbatch:
    their grads are summed in the params' dtypes and divided by
    ``accum_steps``, and the metrics are the last microbatch's. This is
    the gradient half of ``make_train_step``'s step. On DTensors,
    ``mb_specs`` re-pins each microbatch's layout and ``grad_specs`` is
    the accumulator's (both only with accumulation, as the reference's);
    the grads come back in the layout their products left them in
    (pending sums over the data axes), which the update settles."""
    with training_branch(model):
        if accum_steps == 1:
            return _grad_fn(model, params, batch)
        mbs = opt.tree_map(lambda x: _microbatches(x, accum_steps), batch)
        if mb_specs is not None:
            # the reshape loses the batch dim's layout; re-pin it or every
            # microbatch is replicated
            mbs = sh.map_pairs(lambda x, mesh, pl: dtn.settle(x, pl), mbs,
                               mb_specs)
        if grad_specs is not None:
            grads = sh.make_leaves(params, grad_specs, _zeros)
            pin = functools.partial(sh.map_pairs,
                                    lambda g, mesh, pl: dtn.settle(g, pl))
        else:
            grads = opt.tree_map(torch.zeros_like, params)
            pin = None
        for i in range(accum_steps):
            g, metrics = _grad_fn(model, params,
                                  opt.tree_map(lambda x: x[i], mbs))
            if pin is not None:
                # each microbatch's grads reduce-scattered into the ZeRO
                # layout
                g = pin(g, grad_specs)
                grads = opt.tree_map(lambda a, b: a + b, grads, g)
            else:
                opt.tree_map(lambda a, b: a.add_(b), grads, g)
            del g
        return opt.tree_map(lambda g: g / accum_steps, grads), metrics


def _microbatches(x, accum_steps: int):
    """``x`` [B, ...] as ``[accum, B/accum, ...]`` (microbatch i holds rows
    i*B/accum onwards). A batch-sharded DTensor is gathered first (the
    batch's leaves are token ids: a small all-gather), since DTensor cannot
    split a sharded dim that way."""
    if dtn.is_dt(x):
        from torch.distributed.tensor import Replicate
        x = dtn.settle(x, [Replicate()] * len(x.placements))
    return x.reshape((accum_steps, x.shape[0] // accum_steps)
                     + tuple(x.shape[1:]))


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def make_train_step(model, opt_cfg: opt.OptConfig, accum_steps: int = 1,
                    grad_specs=None, mb_specs=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``accumulated_grads`` (gradient accumulation when accum_steps > 1),
    then ``adamw_update``; the metrics are the last microbatch's plus the
    update's ``grad_norm`` and ``lr``. The params and state passed in are
    not written.
    """
    def train_step(params, opt_state, batch):
        grads, metrics = accumulated_grads(model, params, batch, accum_steps,
                                           grad_specs, mb_specs)
        params, opt_state, om = opt.adamw_update(opt_cfg, params, grads,
                                                 opt_state)
        return params, opt_state, {**metrics, **om}

    return train_step


#: per-device activation-stash budget for choosing accumulation steps
STASH_BUDGET_BYTES = 3.0 * 2**30
STASH_F32_HOIST_FACTOR = 3.0   # observed: XLA hoists an f32 copy of the stash


def accum_steps_for(cfg: ModelConfig, global_batch: int, seq: int,
                    dp_size: int, mp_size: int = 16) -> int:
    """Smallest power-of-two microbatch count keeping the per-layer scan
    stash under budget (the reference's rule, constants included)."""
    if cfg.train_accum_override:
        return cfg.train_accum_override
    b_local = max(global_batch // dp_size, 1)
    per_seq = cfg.num_layers * seq * cfg.d_model * 2 * STASH_F32_HOIST_FACTOR
    if cfg.seq_shard_activations and seq % mp_size == 0:
        per_seq /= mp_size
    n = 1
    while n < b_local and b_local / n * per_seq > STASH_BUDGET_BYTES:
        n *= 2
    return n


def make_eval_step(model):
    """(params, batch) -> {"ce", "aux", "loss"}: ``model.loss`` and its
    metrics, as the reference's eval step returns them (on a card, with
    ``attn_impl`` None, through the flash kernel)."""
    def eval_step(params, batch):
        loss, metrics = model.loss(params, batch)
        return {**metrics, "loss": loss}
    return eval_step
