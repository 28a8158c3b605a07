"""repro_torch flash attention: the plain PyTorch version and the op on CPU
tensors against the reference (its jnp oracle ``flash_attention_ref`` and
its Pallas kernel in interpret mode), ``full_attention``'s flash branch
against the reference's, the dispatch rules, a torch emulation of the
tensor-core instance's rounding of P (the hi/lo bf16 pair) against both
bf16 gates, and — on a machine with a card — both CUDA instances against
the plain version, with their bitwise suffix and batch invariance.

Shapes are ``tests/test_kernels.py``'s flash sweep (MHA, GQA 4:1, MQA with
S not a multiple of the tile, small S, windows 1/7/64/200, non-causal),
plus qwen2-0.5b's heads (14/2/64) and causal cases with S != T (masking is
top-left aligned, as in the reference). Tolerances are the reference's:
2e-5 in fp32, 3e-2 in bf16. The CUDA kernel and the plain version both
accumulate in fp32 and round once, so in bf16 they are also held within two
bf16 ulps of the plain value (``BF16_ULPS``). Inputs are seeded numpy, fp32,
rounded to bf16 to nearest even on both sides.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

import repro.kernels.flash_attention.ops as r_flash_ops  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro.models import attention as r_attn  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels.flash_attention import kernel, ops, ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_ULPS = (2.0 ** -6, 1e-4)

# (b, s, t, nq, nkv, h): test_kernels.py's sweep, qwen2 heads, S != T
SHAPES = [
    (1, 128, 128, 4, 4, 64),     # MHA
    (2, 256, 256, 8, 2, 64),     # GQA 4:1
    (1, 192, 192, 4, 1, 32),     # MQA, S not a multiple of the tile
    (1, 64, 64, 2, 2, 128),      # small S
    (1, 80, 80, 14, 2, 64),      # qwen2-0.5b heads
    (1, 70, 150, 4, 2, 32),      # S < T, causal
    (2, 150, 70, 4, 1, 16),      # S > T, causal
]
WINDOWS = [1, 7, 64, 200]
# the reference oracle under jit: one XLA compile per shape, not per op
r_flash_ref = jax.jit(flash_attention_ref, static_argnames=("window",
                                                            "causal"))


@pytest.fixture
def cuda():
    """Skips unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(b, s, t, nq, nkv, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, nq, h)).astype(np.float32),
            rng.standard_normal((b, t, nkv, h)).astype(np.float32),
            rng.standard_normal((b, t, nkv, h)).astype(np.float32))


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a).astype(getattr(jnp, dtype))


def _close(out, want, dtype):
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


# -- the plain version and the op on CPU vs the reference ---------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_oracle(shape, dtype):
    q, k, v = _inputs(*shape, seed=sum(shape))
    want = r_flash_ref(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype))
    out = ref.flash_attention_ref(*(_torch(x, dtype) for x in (q, k, v)))
    assert out.dtype == getattr(torch, dtype) and out.shape == q.shape
    _close(out, want, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
def test_plain_window_matches_reference_oracle(window, causal):
    q, k, v = _inputs(1, 200, 200, 4, 2, 32, seed=window)
    want = r_flash_ref(*map(jnp.asarray, (q, k, v)), window=window,
                       causal=causal)
    out = ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  window=window, causal=causal)
    _close(out, want, "float32")


@pytest.mark.parametrize("case", [
    dict(shape=(1, 128, 128, 4, 4, 64), dtype="float32"),
    dict(shape=(2, 256, 256, 8, 2, 64), dtype="bfloat16"),
    dict(shape=(1, 192, 192, 4, 1, 32), dtype="float32"),
    dict(shape=(1, 70, 150, 4, 2, 32), dtype="float32"),
    dict(shape=(1, 200, 200, 4, 2, 32), dtype="float32", window=1),
    dict(shape=(1, 200, 200, 4, 2, 32), dtype="float32", window=7),
    dict(shape=(2, 128, 128, 4, 4, 64), dtype="float32", causal=False),
], ids=["mha", "gqa-bf16", "mqa-ragged", "s<t", "window1", "window7",
        "noncausal"])
def test_op_on_cpu_matches_pallas_interpret(case):
    """The port's op on CPU tensors (the plain version) against the
    reference's Pallas kernel in interpret mode with 64-row tiles, where a
    row's first tile can be fully masked (windows 1 and 7)."""
    dtype = case["dtype"]
    kw = dict(window=case.get("window", 0), causal=case.get("causal", True))
    q, k, v = _inputs(*case["shape"], seed=3)
    want = r_flash_ops.flash_attention(
        *(_jax(x, dtype) for x in (q, k, v)), block_q=64, block_kv=64,
        interpret=True, **kw)
    out = ops.flash_attention(*(_torch(x, dtype) for x in (q, k, v)), **kw)
    _close(out, want, dtype)


def _smoke_cfgs(arch):
    cfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                              compute_dtype="float32")
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "gemma-2b"])
def test_full_attention_flash_matches_reference(monkeypatch, arch, window):
    """``full_attention(impl="flash")`` of both packages on the same
    params and input; the reference's Pallas kernel runs in interpret mode
    (patched in this test process only)."""
    orig = r_flash_ops.flash_attention
    monkeypatch.setattr(r_flash_ops, "flash_attention",
                        lambda *a, **kw: orig(*a, interpret=True, **kw))
    cfg, tcfg = _smoke_cfgs(arch)
    p = jax.tree.map(np.asarray, r_attn.attn_params(jax.random.PRNGKey(4),
                                                    cfg))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19)).copy()
    want, (wk, _) = jax.jit(lambda p, x, pos: r_attn.full_attention(
        cfg, p, x, pos, window, impl="flash"))(p, jnp.asarray(x),
                                               jnp.asarray(pos))
    got, (gk, _) = t_attn.full_attention(
        tcfg, params_from_reference(p, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(pos), window, impl="flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk),
                               rtol=1e-5, atol=1e-5)


# -- dispatch rules -------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 9, 9, 4, 2, 16, 6))
    before = dict(kernel.LAUNCHES)
    out = ops.flash_attention(q, k, v, window=3)
    assert torch.equal(out, ref.flash_attention_ref(q, k, v, window=3))
    assert torch.equal(ops.flash_attention(q, k, v, impl="reference"),
                       ref.flash_attention_ref(q, k, v))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, v, impl="pallas")
    assert kernel.LAUNCHES == before


def test_full_attention_branches_on_cpu(monkeypatch):
    """On the CPU ``impl=None`` takes the chunked branch and ``"flash"``
    the plain flash version; non-causal attention never takes flash."""
    _, tcfg = _smoke_cfgs("qwen2-0.5b")
    from repro_torch.models.lm import LM
    p = LM(tcfg).init(torch.Generator().manual_seed(1), device="cpu")
    layer = {k: v[0] for k, v in p["groups"][0]["attn"].items()}
    x = torch.randn((1, 11, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    pos = torch.arange(11)[None]
    calls = []
    orig = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or orig(*a, **kw))
    t_attn.full_attention(tcfg, layer, x, pos, 0)
    t_attn.full_attention(tcfg, layer, x, pos, 0, impl="reference")
    t_attn.full_attention(tcfg, layer, x, pos, 0, impl="flash", causal=False)
    assert calls == []
    t_attn.full_attention(tcfg, layer, x, pos, 5, impl="flash")
    assert calls == [{"window": 5}]
    with pytest.raises(ValueError, match="impl"):
        t_attn.full_attention(tcfg, layer, x, pos, 0, impl="cuda")


# -- the tensor-core instance's rounding of P, emulated on the CPU --------------

LOG2E = np.float32(1.4426950408889634)


# keys per tile of the tensor-core instance, by head dim (WgLayout<H>::WK in
# csrc/wgmma_attention.cuh)
WGMMA_TILE = {64: 64, 128: 64, 256: 48}


def _emulate_wgmma_instance(q, k, v, *, split, window=0, causal=True):
    """The bf16 tensor-core instance's tiling and rounding in torch fp32:
    tiles of the instance's width (``WGMMA_TILE``) at absolute positions,
    masked keys at -inf (p = 0), online (m, l) in fp32 in log2 units with l
    summing the fp32 p, and P rounded to bf16 before P V: as the pair
    hi = bf16(p), lo = bf16(p - hi) (``split``), or as hi alone. The
    exponent arithmetic may differ from the kernel's in the last fp32 bits;
    what is emulated is where bf16 rounding enters. q [B,S,nq,h], k/v [B,T,nkv,h] bf16 -> bf16; 0
    where a row sees no key."""
    b, s, nq, h = q.shape
    t, nkv = k.shape[1], k.shape[2]
    tile = WGMMA_TILE[h]
    c2 = float(np.float32(np.float32(1.0 / np.sqrt(h)) * LOG2E))
    q5 = q.float().reshape(b, s, nkv, nq // nkv, h)
    scores = torch.einsum("bsngh,btnh->bngst", q5, k.float())
    qpos = torch.arange(s)[:, None]
    m = torch.full((*scores.shape[:-1], 1), -2.0e38)
    l = torch.zeros_like(m)
    acc = torch.zeros((*scores.shape[:-1], h))
    for k0 in range(0, t, tile):
        kpos = torch.arange(k0, min(k0 + tile, t))[None, :]
        ok = torch.ones((s, kpos.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= qpos - kpos < window
        x = torch.where(ok, scores[..., k0:k0 + tile] * c2, -torch.inf)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        vt = v[:, k0:k0 + tile].float().permute(0, 2, 1, 3)[:, :, None]
        hi = p.bfloat16().float()
        acc = acc * alpha + hi @ vt
        if split:
            acc = acc + (p - hi).bfloat16().float() @ vt
    out = torch.where(l == 0, 0.0, acc / torch.where(l == 0, 1.0, l))
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, nq, h).bfloat16()


def _bf16_gate_violations(out, want):
    """(elements beyond the 3e-2 gate, elements beyond two bf16 ulps)."""
    out, want = out.float(), want.float()
    diff = (out - want).abs()
    rel, ab = BF16_ULPS
    tol = TOL["bfloat16"]
    return (int((diff > tol + tol * want.abs()).sum()),
            int((diff > ab + rel * want.abs()).sum()))


# (b, s, t, nq, nkv, h, window): qwen2 and gemma head dims, GQA and MQA
P_SPLIT_SHAPES = [(1, 256, 256, 4, 2, 64, 0), (1, 192, 200, 2, 1, 256, 7)]


@pytest.mark.parametrize("shape", P_SPLIT_SHAPES)
def test_hi_lo_p_keeps_both_bf16_gates(shape):
    """P as a hi/lo bf16 pair stays within 3e-2 and within two bf16 ulps
    of the plain version everywhere."""
    *dims, window = shape
    q, k, v = (_torch(x, "bfloat16") for x in _inputs(*dims, seed=11))
    want = ref.flash_attention_ref(q, k, v, window=window)
    out = _emulate_wgmma_instance(q, k, v, split=True, window=window)
    assert _bf16_gate_violations(out, want) == (0, 0)


@pytest.mark.parametrize("shape", P_SPLIT_SHAPES)
def test_single_bf16_p_breaks_the_two_ulp_gate(shape):
    """P rounded once to bf16 (FlashAttention-2/3's choice) passes 3e-2
    but breaks the two-ulp gate: why the kernel takes the hi/lo pair."""
    *dims, window = shape
    q, k, v = (_torch(x, "bfloat16") for x in _inputs(*dims, seed=11))
    want = ref.flash_attention_ref(q, k, v, window=window)
    out = _emulate_wgmma_instance(q, k, v, split=False, window=window)
    loose, ulps = _bf16_gate_violations(out, want)
    assert loose == 0 and ulps > 100, (loose, ulps)


# -- the CUDA kernel against the plain version (card only) ----------------------

def _kernel_vs_plain(q, k, v, dtype, **kw):
    """One launch of the instance that serves this dtype and head dim,
    against the plain version at the reference's tolerance and, in bf16,
    within two bf16 ulps of the plain value."""
    name = kernel.instance(q.dtype, q.shape[-1])
    before = dict(kernel.LAUNCHES)
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == {**before, name: before[name] + 1}
    want = ops.flash_attention(q, k, v, impl="reference", **kw)
    _close(out, want.float().cpu().numpy(), dtype)
    if dtype == "bfloat16":
        diff = (out.float() - want.float()).abs()
        rel, ab = BF16_ULPS
        assert bool((diff <= ab + rel * want.float().abs()).all()), \
            float(diff.max())


CUDA_CASES = [dict(shape=s, dtype=d) for s in SHAPES
              for d in ("float32", "bfloat16")] + [
    dict(shape=(1, 200, 200, 4, 2, 32), dtype="float32", window=w)
    for w in WINDOWS] + [
    dict(shape=(1, 200, 200, 4, 2, 32), dtype="float32", window=7,
         causal=False),
    dict(shape=(2, 128, 128, 4, 4, 64), dtype="float32", causal=False),
    dict(shape=(1, 300, 300, 8, 1, 256), dtype="bfloat16"),
    dict(shape=(1, 130, 130, 8, 1, 256), dtype="float32", window=64),
    dict(shape=(2, 97, 97, 6, 3, 128), dtype="bfloat16", window=33),
]


@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda, case):
    dtype = case["dtype"]
    kw = dict(window=case.get("window", 0), causal=case.get("causal", True))
    q, k, v = (_torch(x, dtype, cuda)
               for x in _inputs(*case["shape"], seed=7))
    _kernel_vs_plain(q, k, v, dtype, **kw)


# bf16 at every head dim (h >= 64: the tensor-core instance), T not a
# multiple of the 64-key tile, S < T and S > T, windows 1/7/33/200,
# non-causal, B > 1
WGMMA_CASES = [dict(shape=(2, 131, 131, 4, 2, h)) for h in (16, 32, 64, 128,
                                                         256)] + [
    dict(shape=(1, 100, 250, 6, 2, 64)),
    dict(shape=(1, 250, 100, 4, 1, 128)),
    dict(shape=(3, 190, 190, 8, 1, 256), causal=False),
    dict(shape=(2, 129, 257, 4, 4, 128), causal=False),
] + [dict(shape=(2, 300, 300, 4, 2, h), window=w)
     for h, w in ((64, 1), (128, 7), (256, 33), (64, 200), (256, 200))] + [
    dict(shape=(1, 260, 260, 4, 2, 128), window=33, causal=False),
]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_cuda_bf16_instances_match_plain(cuda, case):
    kw = dict(window=case.get("window", 0), causal=case.get("causal", True))
    q, k, v = (_torch(x, "bfloat16", cuda)
               for x in _inputs(*case["shape"], seed=9))
    _kernel_vs_plain(q, k, v, "bfloat16", **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,nq,nkv,window", [(64, 14, 2, 0), (256, 8, 1, 0),
                                             (32, 4, 2, 7), (128, 6, 3, 33)])
def test_cuda_kernel_suffix_and_batch_invariance(cuda, dtype, h, nq, nkv,
                                                 window):
    """Bit for bit: the first S' rows of a run at S equal a run at S' < S
    (S = T both times), and row b of a B = 4 run equals that row alone.
    S' crosses the 64-row tile of the CUDA-core instance and the 128-row
    tile of the tensor-core instance; every launch is the instance's."""
    name = kernel.instance(getattr(torch, dtype), h)
    n0 = kernel.LAUNCHES[name]
    q, k, v = (_torch(x, dtype, cuda)
               for x in _inputs(4, 300, 300, nq, nkv, h, seed=8))
    full = ops.flash_attention(q, k, v, window=window)
    cuts = (1, 63, 64, 65, 127, 128, 129, 200)
    for s2 in cuts:
        part = ops.flash_attention(q[:, :s2].contiguous(),
                                   k[:, :s2].contiguous(),
                                   v[:, :s2].contiguous(), window=window)
        assert torch.equal(part, full[:, :s2]), s2
    for b in range(4):
        one = ops.flash_attention(q[b:b + 1].contiguous(),
                                  k[b:b + 1].contiguous(),
                                  v[b:b + 1].contiguous(), window=window)
        assert torch.equal(one, full[b:b + 1]), b
    assert kernel.LAUNCHES[name] == n0 + 1 + len(cuts) + 4


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_attention(z(1, 4, 2, 48), z(1, 4, 2, 48),
                               z(1, 4, 2, 48))
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_attention(z(1, 2, 4, 64).transpose(1, 2),
                               z(1, 4, 2, 64), z(1, 4, 2, 64))
    with pytest.raises(ValueError, match="dtypes"):
        kernel.flash_attention(z(1, 4, 2, 64), z(1, 4, 2, 64,
                                                 dt=torch.bfloat16),
                               z(1, 4, 2, 64))
    with pytest.raises(ValueError, match="multiple"):
        kernel.flash_attention(z(1, 4, 3, 64), z(1, 4, 2, 64),
                               z(1, 4, 2, 64))


def test_cuda_full_attention_goes_through_the_kernel(cuda):
    _, tcfg = _smoke_cfgs("gemma-2b")
    from repro_torch.models.lm import LM
    lm = LM(tcfg)
    p = lm.init(torch.Generator(device=cuda).manual_seed(0), device=cuda)
    toks = torch.randint(0, tcfg.vocab_size, (2, 70), device=cuda)
    kernel.reset_launch_counts()
    fast = lm.prefill(p, {"tokens": toks})
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["flash_attention"] == tcfg.num_layers
    lm.attn_impl = "reference"
    plain = lm.prefill(p, {"tokens": toks})
    assert kernel.LAUNCHES["flash_attention"] == tcfg.num_layers
    torch.testing.assert_close(fast, plain, rtol=1e-4, atol=1e-4)
