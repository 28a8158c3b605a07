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
    assert kernel.instance(torch.bfloat16) == "rowwise_wgmma_bf16"
    assert kernel.instance(torch.float32) == "rowwise_fma_f32"


# -- the bf16 instance's plan and launch ------------------------------------

SMS = 132                         # the H100's SM count
ARCHS = ("qwen2-0.5b", "gemma-2b", "qwen2-vl-7b")


def _served_shapes():
    """(K, N) of every weight product of the three served decoders."""
    out = set()
    for arch in ARCHS:
        cfg = registry.get_config(arch)
        d, ff = cfg.d_model, cfg.d_ff
        q = cfg.num_heads * cfg.head_dim_
        kv = cfg.num_kv_heads * cfg.head_dim_
        out |= {(d, q), (d, kv), (q, d), (d, ff), (ff, d),
                (d, cfg.vocab_size)}
    return sorted(out)


def test_plan_takes_no_m_and_fills_the_card():
    """``plan(N, K, sms)`` has no argument for M, and at every served
    shape it gives at least the SM count of blocks a row tile, or splits K
    at every step; a width of the built instances, splits within the
    steps."""
    import inspect
    assert list(inspect.signature(kernel.plan).parameters) == \
        ["n", "k", "sms"]
    for k, n in _served_shapes():
        bn, splits = kernel.plan(n, k, SMS)
        steps = -(-k // kernel.BK)
        assert bn in kernel.WIDTHS and 1 <= splits <= steps, (k, n)
        blocks = -(-n // bn) * splits
        assert blocks >= SMS or splits == steps, (k, n, bn, splits)


@pytest.mark.parametrize("k,n", _served_shapes())
def test_launch_args_differ_only_in_m(k, n):
    """The bf16 launch of any row count is the same launch but for M and
    the grid's row extent: what fixes an element's order of summation
    (the width, the split of K) never follows M."""
    runs = {m: kernel.launch_args(m, n, k, SMS) for m in (1, 8, 40, 256, 300)}
    args0, grid0 = runs[1]
    for m, (args, grid) in runs.items():
        assert args[0] == m and args[1:] == args0[1:], (m, args, args0)
        assert grid[1] == grid0[1], (m, grid, grid0)
        assert grid[0] == -(-m // 64), (m, grid)


def test_workspace_is_grown_never_shrunk(monkeypatch):
    """The split workspace and tickets are cached per device and stream,
    grown when a launch needs more and never shrunk; tickets start at 0."""
    monkeypatch.setattr(kernel, "_WS", {})
    dev = torch.device("cpu")
    ws, tk = kernel._workspace(dev, 7, 100, 10)
    assert ws.numel() >= 100 and tk.numel() >= 10
    assert not tk.any()
    ws2, tk2 = kernel._workspace(dev, 7, 50, 5)
    assert ws2 is ws and tk2 is tk
    big = ws.numel() + 1
    ws3, tk3 = kernel._workspace(dev, 7, big, tk.numel() + 1)
    assert ws3.numel() >= big and tk3.numel() > tk.numel()
    ws4, tk4 = kernel._workspace(dev, 7, 1, 1)
    assert ws4 is ws3 and tk4 is tk3
    other, _ = kernel._workspace(dev, 8, 1, 1)    # another stream
    assert other is not ws3


def test_decoder_runs_its_products_and_norms_through_the_ops():
    """``PagedDecoder._mm`` and ``_add_norm`` on the CPU are the plain
    versions, bit for bit (the F6 repair moved into ``ref.py``): the norm
    alone without a delta, torch's add then the norm with one; and a tied
    head is the embedding's transpose, not a copy."""
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
    s, h = dec._add_norm(p, x, None)
    assert s is x and torch.equal(h, L.apply_norm(cfg, p, x))
    y = _data(8, (3, 5, cfg.d_model), torch.float32)
    s, h = dec._add_norm(p, x, y)
    assert torch.equal(s, x + y)
    assert torch.equal(h, L.apply_norm(cfg, p, x + y))


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
    """Rows of launches of 1 to 300 rows, at offsets 0, 7 and the end,
    equal the same rows of the 300-row launch, at the narrow stand-in and
    at qwen2-0.5b's K/V projection (896 x 128, K split in 14 on an H100)."""
    deep = _data(14, (128, 896), dtype, 896 ** -0.5).T
    for w in (_weights(dtype)[layout], deep):
        w = ops.weight(w.to(cuda))
        kernel.check_weight(w)
        k = w.shape[0]
        a = _data(11, (300, k), dtype).to(cuda)
        whole = kernel.rowwise_matmul(a, w)
        for m in (1, 8, 40, 200, 256):
            for lo in (0, 300 - m, 7):
                if lo + m > 300:
                    continue
                part = kernel.rowwise_matmul(a[lo:lo + m].contiguous(), w)
                assert torch.equal(part, whole[lo:lo + m]), (k, m, lo)
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
