"""repro_torch paged attention: the plain PyTorch versions against the JAX
oracles (``repro.kernels.paged_attention.ref``), their bitwise properties,
the dispatch rules, and — on a machine with a card — the CUDA kernel
against the plain version.

The JAX comparisons import JAX lazily (fixture ``jref``), so this file also
runs where JAX is absent: there they skip and the CUDA cases run. Where JAX
has a GPU backend, run with ``JAX_PLATFORMS=cpu`` (as the tier-1 command
does): the reference's fp32 oracles would otherwise run at the GPU's
reduced matmul precision. The Pallas interpret-mode comparisons live in
``test_torch_paged_pallas.py``.

Tolerances are the reference's (``tests/test_kernels.py``): 2e-5 in fp32,
3e-2 in bf16. The CUDA kernel and the plain version both accumulate in fp32
and round to bf16 once, so in bf16 they are also held within two bf16 ulps
of the plain value (``BF16_ULPS``). Inputs come from seeded numpy and are handed to both sides;
bf16 inputs are rounded from the same fp32 data to nearest even on both
sides, so both see the same bits.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# kernel vs plain version in bf16: |err| <= 2^-6 |want| + 1e-4 (two bf16
# ulps of the plain value; 1e-4 covers fp32 reordering next to zero)
BF16_ULPS = (2.0 ** -6, 1e-4)

# (b, nq, nkv, h, ps, pages_per_seq, pool): tests/test_kernels.py's decode
# shapes, then the qwen2-0.5b head shape at its serving page size
DECODE_SHAPES = [
    (2, 4, 2, 64, 16, 4, 16),
    (1, 8, 8, 32, 8, 8, 64),
    (3, 6, 2, 64, 32, 2, 8),
    (4, 14, 2, 64, 16, 5, 40),
]
# (b, t, nq, nkv, h, ps, mp, pool): test_kernels.py's prefill shapes + qwen
PREFILL_SHAPES = [
    (1, 4, 4, 2, 64, 8, 3, 16),
    (3, 5, 4, 2, 32, 4, 6, 24),
    (2, 1, 8, 8, 32, 8, 4, 16),
    (3, 6, 14, 2, 64, 16, 3, 24),
]


@pytest.fixture(scope="module")
def jref():
    """The JAX side: jax.numpy and the reference's paged-attention ops
    (``impl="reference"`` runs its jnp oracles under jit)."""
    pytest.importorskip("jax", reason="JAX comparisons need jax")
    import jax.numpy as jnp

    from repro.kernels.paged_attention import ops as jops
    return jnp, jops


@pytest.fixture
def cuda():
    """Skips unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Arr(np.ndarray):
    """fp32 numpy data tagged with the dtype both sides should see."""

    def __array_finalize__(self, obj):
        self.dtype_name = getattr(obj, "dtype_name", None)


def _arr(rng, shape, dtype: str) -> np.ndarray:
    a = rng.standard_normal(shape).astype(np.float32).view(_Arr)
    a.dtype_name = dtype
    return a


def _torch(a: np.ndarray, device="cpu") -> torch.Tensor:
    """Integer arrays as they are; data rounded to its tagged dtype (fp32 ->
    bf16 rounds to nearest even, as jnp's astype does)."""
    t = torch.from_numpy(np.array(a, copy=True)).to(device)
    name = getattr(a, "dtype_name", None)
    return t.to(getattr(torch, name)) if name else t


def _jax(jnp, a: np.ndarray):
    x = jnp.asarray(np.asarray(a))
    name = getattr(a, "dtype_name", None)
    return x.astype(getattr(jnp, name)) if name else x


def _decode_inputs(shape, dtype, seed):
    b, nq, nkv, h, ps, pps, pool = shape
    rng = np.random.default_rng(seed)
    q = _arr(rng, (b, nq, h), dtype)
    kp = _arr(rng, (pool, ps, nkv, h), dtype)
    vp = _arr(rng, (pool, ps, nkv, h), dtype)
    table = np.stack([rng.choice(pool, pps, replace=False)
                      for _ in range(b)]).astype(np.int32)
    lens = rng.integers(1, ps * pps + 1, b).astype(np.int32)
    return q, kp, vp, table, lens


def _prefill_inputs(shape, dtype, seed):
    b, t, nq, nkv, h, ps, mp, pool = shape
    rng = np.random.default_rng(seed)
    q = _arr(rng, (b, t, nq, h), dtype)
    kp = _arr(rng, (pool, ps, nkv, h), dtype)
    vp = _arr(rng, (pool, ps, nkv, h), dtype)
    table = np.stack([rng.choice(pool, mp, replace=False)
                      for _ in range(b)]).astype(np.int32)
    q_start = rng.integers(0, mp * ps - t + 1, b).astype(np.int32)
    return q, kp, vp, table, q_start


def _close(out, want, dtype):
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def _close_kernel(out, want, dtype):
    """The CUDA kernel against the plain version, both in torch."""
    _close(out, want, dtype)
    if dtype == "bfloat16":
        got, want = out.float().cpu().numpy(), np.asarray(want, np.float32)
        rel, ab = BF16_ULPS
        assert (np.abs(got - want) <= ab + rel * np.abs(want)).all(), \
            float(np.abs(got - want).max())


# -- plain versions vs the JAX oracles ---------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_plain_matches_jax_oracle(jref, shape, dtype):
    jnp, jops = jref
    q, kp, vp, table, lens = _decode_inputs(shape, dtype, 1)
    want = jops.paged_attention(_jax(jnp, q), _jax(jnp, kp), _jax(jnp, vp),
                                _jax(jnp, table), _jax(jnp, lens),
                                impl="reference")
    out = ref.paged_attention_ref(*map(_torch, (q, kp, vp, table, lens)))
    assert out.dtype == _torch(q).dtype and out.shape == q.shape
    _close(out, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", PREFILL_SHAPES)
def test_prefill_batch_plain_matches_jax_oracle(jref, shape, dtype):
    jnp, jops = jref
    q, kp, vp, table, qs = _prefill_inputs(shape, dtype, 2)
    want = jops.paged_prefill_attention_batch(
        _jax(jnp, q), _jax(jnp, kp), _jax(jnp, vp),
        _jax(jnp, table), _jax(jnp, qs), impl="reference")
    out = ref.paged_prefill_attention_batch_ref(
        *map(_torch, (q, kp, vp, table, qs)))
    assert out.shape == q.shape
    _close(out, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_single_plain_matches_jax_oracle(jref, dtype):
    jnp, jops = jref
    q, kp, vp, table, qs = _prefill_inputs((1, 6, 14, 2, 64, 16, 3, 12),
                                           dtype, 3)
    want = jops.paged_prefill_attention(
        _jax(jnp, q[0]), _jax(jnp, kp), _jax(jnp, vp),
        _jax(jnp, table[0]), int(qs[0]), impl="reference")
    out = ops.paged_prefill_attention(
        _torch(q[0]), _torch(kp), _torch(vp), _torch(table[0]), int(qs[0]))
    _close(out, want, dtype)


def test_ops_default_route_matches_jax_ops(jref):
    """The port's ops with no ``impl`` on CPU tensors agree with the
    reference's ops, at the smoke engine's decode call shape."""
    jnp, jops = jref
    q, kp, vp, table, lens = _decode_inputs((3, 4, 2, 16, 4, 3, 12),
                                            "float32", 4)
    want = jops.paged_attention(_jax(jnp, q), _jax(jnp, kp),
                                _jax(jnp, vp), _jax(jnp, table),
                                _jax(jnp, lens), impl="reference")
    out = ops.paged_attention(*map(_torch, (q, kp, vp, table, lens)))
    _close(out, want, "float32")


# -- bitwise properties of the plain version ----------------------------------

def _properties(fn_batch, fn_decode, dtype, device, seed):
    """Trailing fully-masked pages change nothing; decode equals verify row
    0; real rows do not change when the batch is padded with extra rows."""
    nq, nkv, h, ps, pool = 14, 2, 64, 16, 24
    rng = np.random.default_rng(seed)
    conv = lambda a: _torch(a, device)
    q = conv(_arr(rng, (2, 5, nq, h), dtype))
    kp = conv(_arr(rng, (pool, ps, nkv, h), dtype))
    vp = conv(_arr(rng, (pool, ps, nkv, h), dtype))
    qs = conv(np.asarray([37, 16], np.int32))           # 37: mid-page
    tbl = conv(np.asarray([[5, 9, 2], [7, 1, 0]], np.int32))
    ext = conv(np.asarray([[5, 9, 2, 7, 11], [7, 1, 0, 3, 3]], np.int32))
    base = fn_batch(q, kp, vp, tbl, qs)
    wide = fn_batch(q, kp, vp, ext, qs)
    assert torch.equal(base, wide)
    dec = fn_decode(q[:, 0].contiguous(), kp, vp, tbl, qs + 1)
    assert torch.equal(dec, base[:, 0])
    pad_q = torch.cat([q, conv(_arr(rng, (2, 5, nq, h), dtype))])
    pad_tbl = torch.cat([tbl, conv(np.asarray([[4, 6, 8], [0, 0, 0]],
                                              np.int32))])
    pad_qs = torch.cat([qs, conv(np.asarray([40, 0], np.int32))])
    padded = fn_batch(pad_q, kp, vp, pad_tbl, pad_qs)
    assert torch.equal(padded[:2], base)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_bitwise_properties(dtype, seed):
    _properties(ref.paged_prefill_attention_batch_ref,
                ref.paged_attention_ref, dtype, "cpu", seed)


def test_plain_trailing_page_invariance_reference_case(jref):
    """test_kernels.py's own trailing-page case, on the plain version."""
    jnp, jops = jref
    rng = np.random.default_rng(15)
    q = _torch(_arr(rng, (1, 3, 4, 32), "float32"))
    kp = _torch(_arr(rng, (16, 4, 2, 32), "float32"))
    vp = _torch(_arr(rng, (16, 4, 2, 32), "float32"))
    tbl = _torch(np.asarray([[5, 9, 2]], np.int32))
    ext = _torch(np.asarray([[5, 9, 2, 7, 11]], np.int32))
    qs = _torch(np.asarray([9], np.int32))
    base = ref.paged_prefill_attention_batch_ref(q, kp, vp, tbl, qs)
    assert torch.equal(base, ref.paged_prefill_attention_batch_ref(
        q, kp, vp, ext, qs))
    dec = ref.paged_attention_ref(q[:, 0], kp, vp, tbl,
                                  _torch(np.asarray([10], np.int32)))
    assert torch.equal(dec[0], base[0, 0])
    want = jops.paged_prefill_attention_batch(
        *(jnp.asarray(t.numpy()) for t in (q, kp, vp, tbl, qs)),
        impl="reference")
    _close(base, want, "float32")


# -- dispatch rules ------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    q, kp, vp, table, lens = map(_torch, _decode_inputs(
        (2, 4, 2, 16, 4, 2, 8), "float32", 5))
    before = dict(kernel.LAUNCHES)
    out = ops.paged_attention(q, kp, vp, table, lens)
    assert torch.equal(out, ref.paged_attention_ref(q, kp, vp, table, lens))
    assert kernel.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_attention(q, kp, vp, table, lens, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.paged_prefill_attention_batch(q[:, None], kp, vp, table, lens)
    with pytest.raises(ValueError, match="impl"):
        ops.paged_attention(q, kp, vp, table, lens, impl="pallas")
    assert kernel.LAUNCHES == before


# -- the CUDA kernel against the plain version (card only) --------------------

CUDA_CASES = [  # (b, t, nq, nkv, h, ps, mp, pool, dtype)
    (8, 1, 14, 2, 64, 16, 50, 512, "bfloat16"),
    (8, 7, 14, 2, 64, 16, 50, 512, "bfloat16"),
    (8, 7, 14, 2, 64, 16, 50, 512, "float32"),
    (3, 37, 4, 2, 16, 4, 12, 64, "float32"),
    (2, 5, 8, 8, 32, 8, 6, 32, "float32"),
    (2, 9, 4, 1, 128, 64, 3, 12, "bfloat16"),
    (1, 3, 6, 2, 128, 33, 4, 10, "float32"),
    (4, 2, 4, 4, 32, 1, 20, 40, "float32"),
]


@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, case):
    b, t, nq, nkv, h, ps, mp, pool, dtype = case
    rng = np.random.default_rng(b * 100 + t)
    conv = lambda a: _torch(a, cuda)
    q = conv(_arr(rng, (b, t, nq, h), dtype))
    kp = conv(_arr(rng, (pool, ps, nkv, h), dtype))
    vp = conv(_arr(rng, (pool, ps, nkv, h), dtype))
    # repeated pages and padding with page 0 included
    table = conv(rng.integers(0, pool, (b, mp)).astype(np.int32))
    qs = conv(rng.integers(0, mp * ps - t + 1, b).astype(np.int32))
    n0 = kernel.LAUNCHES["paged_prefill_attention_batch"]
    out = ops.paged_prefill_attention_batch(q, kp, vp, table, qs)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["paged_prefill_attention_batch"] == n0 + 1
    want = ops.paged_prefill_attention_batch(q, kp, vp, table, qs,
                                             impl="reference")
    _close_kernel(out, want.float().cpu().numpy(), dtype)
    lens = qs + 1
    dec = ops.paged_attention(q[:, 0].contiguous(), kp, vp, table, lens)
    _close_kernel(dec, ref.paged_attention_ref(q[:, 0], kp, vp, table, lens)
           .float().cpu().numpy(), dtype)
    assert torch.equal(dec, out[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_bitwise_properties(cuda, dtype):
    _properties(ops.paged_prefill_attention_batch, ops.paged_attention,
                dtype, cuda, 3)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 1, 4, 48), device=cuda)
    kp = torch.zeros((4, 16, 2, 48), device=cuda)
    tbl = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    qs = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        kernel.paged_prefill_attention_batch(q, kp, kp, tbl, qs)
    q = torch.zeros((1, 1, 4, 64), device=cuda)
    kp = torch.zeros((4, 65, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="page size"):
        kernel.paged_prefill_attention_batch(q, kp, kp, tbl, qs)
