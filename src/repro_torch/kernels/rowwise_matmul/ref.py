"""Plain PyTorch version of the row-invariant weight product: each row of
``a`` is its own product against ``w`` (a ``bmm`` of [N,1,K] rows), so a
row's rounding does not depend on how many rows share the call. A plain
``a @ w`` folds the rows into one GEMM whose blocking, and so rounding,
follows the row count."""

from __future__ import annotations

import torch


def rowwise_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [..., K] @ w [K, N] -> [..., N]``, row by row."""
    rows = a.reshape(-1, 1, a.shape[-1])
    out = torch.bmm(rows, w.expand(rows.shape[0], *w.shape))
    return out.reshape(*a.shape[:-1], w.shape[-1])
