"""repro_torch's fused residual add + row-invariant RMSNorm
(``kernels/rowwise_rmsnorm``): the plain version against torch's add and
``layers.rmsnorm`` and against the reference's ``rmsnorm(x + y)``, the
dispatch and the wrapper's refusals, the layout rule, the decoder that
threads each residual into the next norm, and — on a machine with a card —
the CUDA kernel against the plain version.

``add_rmsnorm(x, y, gamma)`` returns ``s = x + y`` (rounded as torch's
add rounds it) and ``h = rmsnorm(s)``. ``PagedDecoder`` hands each
layer's MLP output on unsummed to the next norm, so a logits forward runs
2L + 1 norms of which 2L add, and a prefill forward 2L of which 2L - 1 add
(its last layer's add is read by nothing). On the CPU the decoder's logits
and K/V equal the unfused composition (add in the layer, then norm) bit
for bit.

Tolerances against the reference: those of
``test_torch_rowwise_matmul.py::test_rmsnorm_matches_the_reference`` (2e-6
relative in fp32; two bf16 ulps in bf16). On the card the kernel's ``s``
equals torch's add bit for bit, its rows are bit-equal across row counts,
and ``h`` is within two bf16 ulps of the plain version (fp32: 1e-6
relative, another order of an fp32 sum).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.kernels.rowwise_rmsnorm import kernel, ops, ref
from repro_torch.models import layers as L

DTYPES = (torch.float32, torch.bfloat16)
ROWS = (1, 40, 200)
D = 96                             # a narrow stand-in for d_model
WIDTHS = (896, 2048, 3584)         # qwen2-0.5b, gemma-2b, qwen2-vl-7b
CARD_ROWS = (1, 8, 40, 256)        # a row, decode, a verify step, a chunk


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


def _np32(t):
    return t.float().numpy()


# -- the plain version --------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_plain_version_is_torchs_add_then_the_norm(dtype):
    x = _data(1, (max(ROWS), D), dtype, 3.0)
    y = _data(2, (max(ROWS), D), dtype, 1.0)
    g = _data(3, (D,), torch.float32, 0.1)
    s, h = ref.add_rmsnorm_ref(x, y, g, 1e-6)
    assert s.dtype == h.dtype == dtype
    assert torch.equal(s, x + y)
    assert torch.equal(h, L.rmsnorm(x + y, g, 1e-6))
    for m in ROWS:
        sm, hm = ref.add_rmsnorm_ref(x[:m].contiguous(), y[:m].contiguous(),
                                     g, 1e-6)
        assert torch.equal(sm, s[:m]) and torch.equal(hm, h[:m]), m
    # the same rows as a [B, T, d] verify chunk
    sc, hc = ref.add_rmsnorm_ref(x.reshape(8, 25, D), y.reshape(8, 25, D),
                                 g, 1e-6)
    assert torch.equal(sc.reshape(200, D), s)
    assert torch.equal(hc.reshape(200, D), h)


@pytest.mark.parametrize("gdtype", DTYPES, ids=["gamma_fp32", "gamma_bf16"])
def test_cpu_dispatch_takes_the_plain_version(gdtype):
    x = _data(4, (3, 5, D), torch.bfloat16, 3.0)
    y = _data(5, (3, 5, D), torch.bfloat16)
    g = _data(6, (D,), gdtype, 0.1)
    s, h = ops.add_rmsnorm(x, y, g, 1e-6)
    want = ref.add_rmsnorm_ref(x, y, g, 1e-6)
    assert torch.equal(s, want[0]) and torch.equal(h, want[1])
    assert torch.equal(ops.rmsnorm(x, g, 1e-6), L.rmsnorm(x, g, 1e-6))


# -- the wrapper's refusals and the layout ------------------------------------

def test_kernel_refuses_cpu_tensors_a_mismatched_y_and_misalignment():
    x = _data(7, (4, D), torch.bfloat16)
    g = torch.zeros(D)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.add_rmsnorm(x, x.clone(), g)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        kernel.rmsnorm(x, g)
    for y in (x[:3].clone(), x.float(), x.reshape(2, 2, D).clone()):
        with pytest.raises(ValueError, match="must match x"):
            kernel.add_rmsnorm(x, y, g)
        with pytest.raises(ValueError, match="must match x"):
            ops.add_rmsnorm(x, y, g)
    # a view 2 bytes into its storage: the vector layout's 16-byte loads
    # cannot take it, and no other path may run
    odd = torch.zeros(4 * D + 1, dtype=torch.bfloat16)[1:].view(4, D)
    assert kernel.layout(D, torch.bfloat16)[0] == 8
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        kernel.rmsnorm(odd, g)
    with pytest.raises(ValueError, match="y at .* not 16-byte aligned"):
        kernel.add_rmsnorm(x, odd, g)
    godd = torch.zeros(D + 1)[1:]
    with pytest.raises(ValueError, match="gamma at .* not 16-byte aligned"):
        kernel.rmsnorm(x, godd)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.rmsnorm(x.T.contiguous().T, g)
    with pytest.raises(ValueError, match="width 40000"):
        kernel.layout(40000, torch.float32)


def test_layout_takes_no_row_count_and_covers_the_row():
    """``layout(d, dtype)`` has no argument for M; its threads are whole
    warps within the launch bound, cover the row's chunks with the fewest
    chunks a thread, and a width that does not split into 16-byte chunks
    takes chunks of one element."""
    import inspect
    assert list(inspect.signature(kernel.layout).parameters) == \
        ["d", "dtype"]
    for d in (*WIDTHS, 64, 96, 1600, 5376, 7168, 1100, 2047, 2044):
        for dtype in DTYPES:
            vec, cpt, threads = kernel.layout(d, dtype)
            assert d % vec == 0 and vec in (1, 16 // dtype.itemsize)
            assert vec > 1 or d % (16 // dtype.itemsize), (d, dtype)
            nv = d // vec
            assert threads % 32 == 0 and threads <= kernel.MAX_THREADS
            assert threads * cpt >= nv > (threads - 32) * cpt
            assert cpt == 1 or -(-nv // (cpt // 2)) > kernel.MAX_THREADS
    assert kernel.layout(896, torch.bfloat16) == (8, 1, 128)
    assert kernel.layout(3584, torch.bfloat16) == (8, 2, 224)
    assert kernel.layout(3584, torch.float32) == (4, 4, 224)


# -- against the reference ----------------------------------------------------

@pytest.fixture(scope="module")
def jref():
    pytest.importorskip("jax", reason="JAX comparisons need jax")
    import jax.numpy as jnp

    from repro.models import layers as rl
    return jnp, rl


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_add_rmsnorm_matches_the_reference(jref, dtype):
    """The reference decoder's ``x + ...`` then ``rmsnorm`` (XLA fuses
    them) against the op, on the same seeded inputs."""
    jnp, rl = jref
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x = _data(9, (40, D), dtype, 3.0)
    y = _data(10, (40, D), dtype)
    g = _data(11, (D,), torch.float32, 0.1)
    js = jnp.asarray(_np32(x), jdt) + jnp.asarray(_np32(y), jdt)
    want_s = np.asarray(js, np.float32)
    want = np.asarray(rl.rmsnorm(js, jnp.asarray(_np32(g)), 1e-6),
                      np.float32)
    s, h = ops.add_rmsnorm(x, y, g, 1e-6)
    np.testing.assert_array_equal(_np32(s), want_s)
    got = _np32(h)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)
    else:
        np.testing.assert_array_less(np.abs(got - want),
                                     2.0 ** -7 * np.abs(want) + 1e-6)


# -- the decoder --------------------------------------------------------------

LAYERS = 2


def _decoders(dtype):
    """A fused decoder and the unfused composition (each layer adds its own
    residuals, then the next norm reads the sum), on two pools with the
    same random K/V, from the same params (random norm gains)."""
    from repro_torch.models.lm import LM
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain
    from repro_torch.serve.engine import PagedDecoder

    class Unfused(PagedDecoder):
        def _qkv(self, p, x, delta, pos, b, t):
            assert delta is None
            return super()._qkv(p, x, None, pos, b, t)

        def _out_mlp(self, p, x, att, b, t):
            cfg = self.cfg
            x = x + self._mm(att.reshape(b, t, cfg.num_heads
                                         * cfg.head_dim_), p["attn"]["wo"])
            h = L.apply_norm(cfg, p["norm2"], x)
            return x + self._mlp(p["mlp"], h), None

        def _logits(self, x, delta):
            assert delta is None
            h = L.apply_norm(self.cfg, self.params["final_norm"], x)
            return self._mm(h, self.head)

    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=LAYERS, compute_dtype=dtype)
    params = LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(12)
    gp = params["groups"][0]          # a list of layers at this depth
    for tree in (*(gp[l][k] for l in range(LAYERS) for k in ("norm1",
                                                              "norm2")),
                 params["final_norm"]):
        g = tree["gamma"]
        tree["gamma"] = torch.from_numpy(
            (rng.standard_normal(g.shape) * 0.3).astype(np.float32))
    out = []
    for cls in (PagedDecoder, Unfused):
        pool = BwapPagePool(cfg, [MemoryDomain("hbm", 32, 819.0, True)],
                            page_size=4, device="cpu")
        for t in (pool.k_pool, pool.v_pool):
            t.copy_(_data(13, tuple(t.shape), t.dtype))
        out.append(cls(cfg, params, pool))
    return out


def _decode_args(dec):
    lens = np.asarray([5, 9, 2], np.int64)
    tables = np.arange(3 * 4, dtype=np.int32).reshape(3, 4)
    toks = np.asarray([[7], [100], [3]], np.int64)
    return (dec._t(toks), dec._t(tables, torch.int32),
            dec._t(lens, torch.int32), dec._t(lens))


CHUNKS = [([5, 6, 7, 8, 9], [12, 13], 2), ([40, 41, 42], [14, 15, 16], 7)]


def _same_pools(a, b):
    return torch.equal(a.view.k_pool, b.view.k_pool) \
        and torch.equal(a.view.v_pool, b.view.v_pool)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decoder_equals_the_unfused_composition(dtype):
    fused, plain = _decoders(dtype)
    got, want = (d.decode_step(*_decode_args(d)) for d in (fused, plain))
    assert got.shape == (3, fused.cfg.vocab_size)
    assert torch.equal(got, want) and _same_pools(fused, plain)
    for want_logits in (True, False):
        got, want = (d.forward_chunks(CHUNKS, want_logits=want_logits)
                     for d in (fused, plain))
        if want_logits:
            assert got.shape == (2, 5, fused.cfg.vocab_size)
            assert torch.equal(got, want)
        else:
            assert got is None and want is None
        assert _same_pools(fused, plain)


def test_decoder_norm_counts_and_no_residual_add(monkeypatch):
    """A logits forward (a decode launch, a verify step) runs 2L + 1 norms,
    2L of them with the residual; a prefill step 2L, 2L - 1 with it. No
    add of two residual-shaped tensors runs outside the norm op (on a card
    the kernel adds them)."""
    from torch.overrides import TorchFunctionMode

    from repro_torch.serve import engine
    fused, _ = _decoders("bfloat16")
    d = fused.cfg.d_model
    calls = {"rmsnorm": 0, "add_rmsnorm": 0, "residual_adds": 0}
    inside = []

    def counting(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            inside.append(1)
            try:
                return fn(*a, **kw)
            finally:
                inside.pop()
        return run

    class Adds(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if not inside and func in (torch.add, torch.Tensor.add,
                                       torch.Tensor.__add__) \
                    and all(isinstance(a, torch.Tensor) and a.dim() == 3
                            and a.shape[-1] == d for a in args[:2]):
                calls["residual_adds"] += 1
            return func(*args, **(kwargs or {}))

    monkeypatch.setattr(engine.norm_ops, "rmsnorm",
                        counting("rmsnorm", ops.rmsnorm))
    monkeypatch.setattr(engine.norm_ops, "add_rmsnorm",
                        counting("add_rmsnorm", ops.add_rmsnorm))
    for run, total, fused_n in (
            (lambda: fused.decode_step(*_decode_args(fused)),
             2 * LAYERS + 1, 2 * LAYERS),
            (lambda: fused.forward_chunks(CHUNKS, want_logits=True),
             2 * LAYERS + 1, 2 * LAYERS),
            (lambda: fused.forward_chunks(CHUNKS), 2 * LAYERS,
             2 * LAYERS - 1)):
        for k in calls:
            calls[k] = 0
        with Adds():
            run()
        assert calls == {"rmsnorm": total - fused_n, "add_rmsnorm": fused_n,
                         "residual_adds": 0}, calls


# -- on the card --------------------------------------------------------------

def _ulps2(want):
    return 2.0 ** -6 * want.abs() + 1e-4


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_cuda_kernel_against_the_plain_version(cuda, dtype, d):
    """s equals torch's x + y; rows of s and h bit-equal across M 1 / 8 /
    40 / 256 (offsets 0 and the end); h within two bf16 ulps of the plain
    version (fp32: 1e-6 relative); the launch without y alike."""
    big = max(CARD_ROWS)
    x = _data(14, (big, d), dtype, 3.0).to(cuda)
    y = _data(15, (big, d), dtype).to(cuda)
    g = _data(16, (d,), torch.float32, 0.1).to(cuda)
    s, h = kernel.add_rmsnorm(x, y, g, 1e-6)
    alone = kernel.rmsnorm(x, g, 1e-6)
    assert torch.equal(s, x + y)
    for m in CARD_ROWS[:-1]:
        for lo in (0, big - m):
            sm, hm = kernel.add_rmsnorm(x[lo:lo + m], y[lo:lo + m], g, 1e-6)
            assert torch.equal(sm, s[lo:lo + m]), (m, lo)
            assert torch.equal(hm, h[lo:lo + m]), (m, lo)
            assert torch.equal(kernel.rmsnorm(x[lo:lo + m], g, 1e-6),
                               alone[lo:lo + m]), (m, lo)
    for got, want in ((h, ref.add_rmsnorm_ref(x, y, g, 1e-6)[1]),
                      (alone, ref.rmsnorm_ref(x, g, 1e-6))):
        got, want = got.float(), want.float()
        bound = _ulps2(want) if dtype == torch.bfloat16 \
            else 1e-6 * want.abs() + 1e-7
        assert bool(((got - want).abs() <= bound).all()), \
            float((got - want).abs().max())


def test_cuda_kernel_counts_and_refusals(cuda):
    x = _data(17, (8, 896), torch.bfloat16).to(cuda)
    g = torch.zeros(896, device=cuda)
    kernel.reset_launch_counts()
    kernel.add_rmsnorm(x, x, g)
    kernel.rmsnorm(x, g)
    assert kernel.LAUNCHES == {"rowwise_rmsnorm": 2,
                               "rowwise_add_rmsnorm": 1}
    odd = torch.zeros(8 * 896 + 1, dtype=torch.bfloat16,
                      device=cuda)[1:].view(8, 896)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        kernel.rmsnorm(odd, g)
    with pytest.raises(ValueError, match="must match x"):
        kernel.add_rmsnorm(x, x.float(), g)
    assert kernel.LAUNCHES["rowwise_rmsnorm"] == 2
