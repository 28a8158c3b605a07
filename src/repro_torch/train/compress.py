"""Gradient compression: int8 error-feedback all-reduce (port of
``repro.train.compress``).

Distributed-optimization trick for slow (cross-pod) gradient reduction:
quantize per-block to int8 before the data-parallel sum, keep the
quantization residual locally and add it back next step (error feedback —
Karimireddy et al. 2019 — preserves convergence).

What moves: ``torch.distributed.all_reduce`` (SUM) of the dequantized
fp32 values over ``group``, the same arithmetic as the reference's
``shard_map`` + ``psum`` of ``sent``. Like the reference's, this
collective moves fp32, not int8: the reference's docstring says the psum
"really moves int8 (4x less DCI traffic)", but its psum sums the
dequantized fp32 ``sent`` (ROADMAP §3). What int8 buys here is the
rounding the receiver sees, and the residual that feeds it back.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.train.optimizer import tree_map


def _blockwise_q8(x, block: int = 256):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def _deq(q, scale, shape):
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compressed_psum_grads(grads, residuals, group=None, block: int = 256):
    """All-reduce ``grads`` over ``group`` (default: the default process
    group) in int8 blocks with error feedback.

    grads/residuals: matching trees (residuals carry the quantization
    error of the previous step, fp32). Returns (reduced_grads,
    new_residuals), both fp32: each rank sends ``sent``, the dequantized
    blocks of ``grad + residual``, keeps ``grad + residual - sent``, and
    receives the sum of every rank's ``sent``."""
    def one(g, r):
        val = g.to(torch.float32) + r
        q, scale = _blockwise_q8(val, block)
        sent = _deq(q, scale, tuple(g.shape))      # what the rank sends
        new_r = val - sent
        red = sent.clone()
        dist.all_reduce(red, op=dist.ReduceOp.SUM, group=group)
        return red, new_r

    out = tree_map(one, grads, residuals)
    red = tree_map(lambda g, o: o[0], grads, out)
    res = tree_map(lambda g, o: o[1], grads, out)
    return red, res


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
