"""repro_torch's plain paged-attention versions against the reference's
Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs
them: its shapes plus the qwen2-0.5b head shape (nq 14, nkv 2, h 64) at the
serving page size 16, and its property over random page tables. Tolerances are test_kernels.py's: 2e-5 in fp32, 3e-2
in bf16. Inputs are seeded numpy fp32, rounded to bf16 to nearest even on
both sides.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

jax = pytest.importorskip("jax", reason="the Pallas comparisons need jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import ops as jops  # noqa: E402
from repro_torch.kernels.paged_attention import ops, ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _ints(a):
    return jnp.asarray(a), torch.from_numpy(a)


def _close(out, want, dtype):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nq,nkv,h,ps,pages_per_seq,pool", [
    (2, 4, 2, 64, 16, 4, 16),
    (1, 8, 8, 32, 8, 8, 64),
    (3, 6, 2, 64, 32, 2, 8),
    (2, 14, 2, 64, 16, 3, 12),        # qwen2-0.5b heads
])
def test_decode_plain_matches_pallas(b, nq, nkv, h, ps, pages_per_seq, pool,
                                     dtype):
    rng = np.random.default_rng(b * 7 + nq)
    qj, qt = _pair(rng, (b, nq, h), dtype)
    kj, kt = _pair(rng, (pool, ps, nkv, h), dtype)
    vj, vt = _pair(rng, (pool, ps, nkv, h), dtype)
    table = np.stack([rng.choice(pool, pages_per_seq, replace=False)
                      for _ in range(b)]).astype(np.int32)
    lens = rng.integers(1, ps * pages_per_seq + 1, b).astype(np.int32)
    (tj, tt), (lj, lt) = _ints(table), _ints(lens)
    want = jops.paged_attention(qj, kj, vj, tj, lj, interpret=True)
    _close(ref.paged_attention_ref(qt, kt, vt, tt, lt), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,nq,nkv,h,ps,mp,pool", [
    (1, 4, 4, 2, 64, 8, 3, 16),
    (3, 5, 4, 2, 32, 4, 6, 24),
    (2, 1, 8, 8, 32, 8, 4, 16),
    (2, 5, 14, 2, 64, 16, 3, 12),     # qwen2-0.5b heads
])
def test_prefill_batch_plain_matches_pallas(b, t, nq, nkv, h, ps, mp, pool,
                                            dtype):
    rng = np.random.default_rng(b * 11 + t)
    qj, qt = _pair(rng, (b, t, nq, h), dtype)
    kj, kt = _pair(rng, (pool, ps, nkv, h), dtype)
    vj, vt = _pair(rng, (pool, ps, nkv, h), dtype)
    table = np.stack([rng.choice(pool, mp, replace=False)
                      for _ in range(b)]).astype(np.int32)
    q_start = rng.integers(0, mp * ps - t + 1, b).astype(np.int32)
    (tj, tt), (sj, st) = _ints(table), _ints(q_start)
    want = jops.paged_prefill_attention_batch(qj, kj, vj, tj, sj,
                                              interpret=True)
    _close(ref.paged_prefill_attention_batch_ref(qt, kt, vt, tt, st), want,
           dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_single_plain_matches_pallas(dtype):
    rng = np.random.default_rng(5)
    qj, qt = _pair(rng, (6, 14, 64), dtype)
    kj, kt = _pair(rng, (12, 16, 2, 64), dtype)
    vj, vt = _pair(rng, (12, 16, 2, 64), dtype)
    tj, tt = _ints(np.asarray([3, 7, 0], np.int32))
    want = jops.paged_prefill_attention(qj, kj, vj, tj, 29, interpret=True)
    _close(ref.paged_prefill_attention_ref(qt, kt, vt, tt, 29), want, dtype)


@given(st.integers(min_value=1, max_value=4),     # batch
       st.integers(min_value=1, max_value=6),     # pages per seq
       st.integers(min_value=0, max_value=10_000))
@settings(max_examples=12, deadline=None, derandomize=True, database=None)
def test_paged_property_random_tables(b, mp, seed):
    """``tests/test_kernels.py::test_paged_property_random_tables``: the
    decode op equals the Pallas kernel (interpret mode) for any table,
    pages repeating within and across sequences, and lengths that fall on
    page edges often; fp32, 3e-5. On CPU tensors the op runs the plain
    version."""
    nq, nkv, h, ps, pool = 4, 2, 32, 8, 12
    rng = np.random.default_rng(seed)
    qj, qt = _pair(rng, (b, nq, h), "float32")
    kj, kt = _pair(rng, (pool, ps, nkv, h), "float32")
    vj, vt = _pair(rng, (pool, ps, nkv, h), "float32")
    table = rng.integers(0, pool, (b, mp)).astype(np.int32)
    lens = np.minimum(rng.integers(1, mp * ps + 1, b)
                      // ps * ps + rng.integers(0, 2, b) * rng.integers(
                          1, ps + 1, b), mp * ps)
    lens = np.maximum(lens, 1).astype(np.int32)
    (tj, tt), (lj, lt) = _ints(table), _ints(lens)
    want = jops.paged_attention(qj, kj, vj, tj, lj, interpret=True)
    out = ops.paged_attention(qt, kt, vt, tt, lt)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               rtol=3e-5, atol=3e-5)
