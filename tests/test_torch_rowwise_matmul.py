"""repro_torch's row-invariant weight product and RMSNorm
(``kernels/rowwise_matmul``, ``kernels/rowwise_rmsnorm``): the plain
versions' row invariance, their dispatch rules, the decoder's use of them,
the reference's ``x @ w`` and ``layers.rmsnorm`` against them, and — on a
machine with a card — the CUDA kernels against the plain versions.

A row's bits must not depend on how many rows share the call: decode runs
one row a sequence, a speculative verify chunk T, a ``coda`` micro-batch a
share of the batch, and speculation is token-identical to greedy decode
only if each position's K/V and logits come out the same either way. The
plain versions are held to it bit for bit at M = 1, 40 and 200 rows; the
kernels (on the card) at every M the engine serves.

Tolerances against the reference: 2e-5 relative in fp32 (a sum of K fp32
products in another order); in bf16 the port rounds once from fp32, as
XLA's dot does, so results are held within two bf16 ulps of the
reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.rowwise_matmul import kernel, ops, ref
from repro_torch.kernels.rowwise_rmsnorm import kernel as nkernel
from repro_torch.kernels.rowwise_rmsnorm import ops as nops
from repro_torch.models import layers as L

DTYPES = (torch.float32, torch.bfloat16)
ROWS = (1, 40, 200)
K, N = 96, 80                     # narrow stand-ins for d and a projection


@pytest.fixture
def cuda():
    """Skips unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(seed, shape, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dtype)


def _weights(dtype):
    """A [K, N] weight as the model holds it and a tied head: the
    transpose of a [N, K] table (the kernel's layout, ``ops.weight``)."""
    return {"kn": _data(1, (K, N), dtype, K ** -0.5),
            "tied": _data(2, (N, K), dtype, 0.02).T}


# -- the plain versions -------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["kn", "tied"])
def test_plain_product_rows_do_not_depend_on_the_row_count(dtype, layout):
    w = _weights(dtype)[layout]
    a = _data(3, (max(ROWS), K), dtype)
    whole = ref.rowwise_matmul_ref(a, w)
    for m in ROWS:
        for lo in (0, max(ROWS) - m):
            part = ref.rowwise_matmul_ref(a[lo:lo + m].contiguous(), w)
            assert torch.equal(part, whole[lo:lo + m]), (m, lo)
    # the same rows as a [B, T, K] verify chunk
    chunk = ref.rowwise_matmul_ref(a.reshape(8, 25, K), w)
    assert torch.equal(chunk.reshape(200, N), whole)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_plain_rmsnorm_rows_do_not_depend_on_the_row_count(dtype):
    x = _data(4, (max(ROWS), K), dtype, 3.0)
    g = _data(5, (K,), torch.float32, 0.1)
    whole = nops.rmsnorm(x, g, 1e-6)
    assert torch.equal(whole, L.rmsnorm(x, g, 1e-6))
    for m in ROWS:
        assert torch.equal(nops.rmsnorm(x[:m].contiguous(), g, 1e-6),
                           whole[:m])


def test_cpu_dispatch_takes_the_plain_versions_and_the_kernels_refuse():
    w = _weights(torch.float32)["kn"]
    a = _data(6, (5, K), torch.float32)
    assert torch.equal(ops.rowwise_matmul(a, w), ref.rowwise_matmul_ref(a, w))
    g = torch.zeros(K)
    assert torch.equal(nops.rmsnorm(a, g), L.rmsnorm(a, g))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.rowwise_matmul(a, w)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        nkernel.rmsnorm(a, g)


def test_weight_layouts():
    """The kernel reads one layout, the transpose of a contiguous [N, K]:
    a tied head as it is; ``ops.weight`` keeps a CPU weight as it is (the
    plain version's bits) and lays a card's out so."""
    w = _weights(torch.float32)
    kernel.check_weight(w["tied"])
    assert ops.weight(w["tied"]) is w["tied"]
    assert ops.weight(w["kn"]) is w["kn"]
    with pytest.raises(ValueError, match="strides"):
        kernel.check_weight(w["kn"])
    with pytest.raises(ValueError, match="strides"):
        kernel.check_weight(w["tied"][:, ::2])
    with pytest.raises(ValueError, match="2-d"):
        kernel.check_weight(w["kn"][None])
    assert kernel.instance(torch.bfloat16) == "rowwise_mma_bf16"
    assert kernel.instance(torch.float32) == "rowwise_fma_f32"


def test_decoder_runs_its_products_and_norms_through_the_ops():
    """``PagedDecoder._mm`` and ``_norm`` on the CPU are the plain
    versions, bit for bit (the F6 repair moved into ``ref.py``), and a
    tied head is the embedding's transpose, not a copy."""
    from repro_torch.models.lm import LM
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain
    from repro_torch.serve.engine import PagedDecoder
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    pool = BwapPagePool(cfg, [MemoryDomain("hbm", 8, 819.0, True)],
                        page_size=4, device="cpu")
    dec = PagedDecoder(cfg, params, pool)
    assert dec.head.data_ptr() == dec.embed.data_ptr() \
        or not cfg.tie_embeddings
    x = _data(7, (3, 5, cfg.d_model), torch.float32)
    for w in (dec.layers[0]["attn"]["wq"], dec.head):
        assert torch.equal(dec._mm(x, w), ref.rowwise_matmul_ref(x, w))
    p = dec.layers[0]["norm1"]
    assert torch.equal(dec._norm(p, x), L.apply_norm(cfg, p, x))


# -- against the reference ----------------------------------------------------

@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax", reason="JAX comparisons need jax")
    import jax.numpy as jnp

    from repro.models import layers as rl
    return jnp, rl


def _np32(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["kn", "tied"])
def test_product_matches_the_reference_matmul(jref, dtype, layout):
    """The reference decoder's ``x @ w`` (XLA's dot, fp32 accumulation)."""
    jnp, _ = jref
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    w = _weights(dtype)[layout]
    a = _data(8, (40, K), dtype)
    want = np.asarray(jnp.asarray(_np32(a), jdt) @ jnp.asarray(_np32(w), jdt),
                      np.float32)
    got = _np32(ops.rowwise_matmul(a, w))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    else:
        np.testing.assert_array_less(np.abs(got - want),
                                     2.0 ** -7 * np.abs(want) + 1e-3)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_rmsnorm_matches_the_reference(jref, dtype):
    jnp, rl = jref
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = _data(9, (40, K), dtype, 3.0)
    g = _data(10, (K,), torch.float32, 0.1)
    want = np.asarray(rl.rmsnorm(jnp.asarray(_np32(x), jdt),
                                 jnp.asarray(_np32(g)), 1e-6), np.float32)
    got = _np32(nops.rmsnorm(x, g, 1e-6))
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    else:
        np.testing.assert_array_less(np.abs(got - want),
                                     2.0 ** -7 * np.abs(want) + 1e-6)


# -- on the card --------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["kn", "tied"])
def test_kernel_rows_are_bit_equal_across_row_counts(cuda, dtype, layout):
    w = ops.weight(_weights(dtype)[layout].to(cuda))
    kernel.check_weight(w)
    a = _data(11, (256, K), dtype).to(cuda)
    whole = kernel.rowwise_matmul(a, w)
    for m in (1, 8, 40, 200):
        for lo in (0, 256 - m, 7):
            if lo + m > 256:
                continue
            part = kernel.rowwise_matmul(a[lo:lo + m].contiguous(), w)
            assert torch.equal(part, whole[lo:lo + m]), (m, lo)
    plain = ref.rowwise_matmul_ref(a.float(), w.float())
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(whole.float(), plain, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_rmsnorm_kernel_rows_are_bit_equal_across_row_counts(cuda, dtype):
    x = _data(12, (200, 896), dtype, 3.0).to(cuda)
    g = _data(13, (896,), torch.float32, 0.1).to(cuda)
    whole = nkernel.rmsnorm(x, g, 1e-6)
    for m in (1, 8, 40):
        assert torch.equal(nkernel.rmsnorm(x[:m].contiguous(), g, 1e-6),
                           whole[:m])
    want = L.rmsnorm(x, g, 1e-6).float()
    np.testing.assert_array_less(
        (whole.float() - want).abs().cpu().numpy(),
        (2.0 ** -6 * want.abs() + 1e-5).cpu().numpy())
