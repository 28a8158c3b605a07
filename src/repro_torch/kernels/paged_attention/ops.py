"""Public paged-attention ops with the reference's names and an ``impl``
argument (port of ``repro.kernels.paged_attention.ops``).

``impl=None`` picks by device: a CUDA tensor runs the hand-written CUDA
kernel, a CPU tensor runs the plain PyTorch version. ``impl="reference"``
runs the plain version on any device; it is taken only when a caller asks
for it (tests, ``chip_smoke.py``). ``impl="cuda"`` on a CPU tensor raises.
"""

from __future__ import annotations

from repro_torch.kernels.paged_attention import kernel
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_prefill_attention_batch_ref,
    paged_prefill_attention_ref)


def _use_kernel(impl: str | None, q) -> bool:
    if impl is None:
        return q.is_cuda
    if impl == "reference":
        return False
    if impl == "cuda":
        if not q.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors")
        return True
    raise ValueError(f"unknown impl {impl!r}: None, 'cuda' or 'reference'")


def paged_attention(q, k_pool, v_pool, page_table, lens, *,
                    impl: str | None = None):
    """Decode attention over a paged KV pool: q [B,nq,h]; pools
    [P,ps,nkv,h]; page_table [B,mp]; lens [B] -> [B,nq,h]."""
    if _use_kernel(impl, q):
        return kernel.paged_attention(q, k_pool, v_pool, page_table, lens)
    return paged_attention_ref(q, k_pool, v_pool, page_table, lens)


def paged_prefill_attention(q, k_pool, v_pool, page_table, q_start, *,
                            impl: str | None = None):
    """Prefill-mode attention: one sequence's query chunk [T,nq,h] over its
    page table [mp], causal at absolute positions ``q_start + t``. The
    chunk's own K/V must be scattered into its pages before the call."""
    if _use_kernel(impl, q):
        return kernel.paged_prefill_attention(q, k_pool, v_pool, page_table,
                                              q_start)
    return paged_prefill_attention_ref(q, k_pool, v_pool, page_table,
                                       q_start)


def paged_prefill_attention_batch(q, k_pool, v_pool, page_table, q_start, *,
                                  impl: str | None = None):
    """Batched prefill-mode attention: B sequences' chunks [B,T,nq,h]
    (padded to a common T) over per-sequence page tables [B,mp], causal at
    absolute positions ``q_start[b] + t``. Serves fused same-step prefill
    chunks and the speculative verify step."""
    if _use_kernel(impl, q):
        return kernel.paged_prefill_attention_batch(q, k_pool, v_pool,
                                                    page_table, q_start)
    return paged_prefill_attention_batch_ref(q, k_pool, v_pool, page_table,
                                             q_start)
