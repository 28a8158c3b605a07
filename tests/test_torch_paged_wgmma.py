"""repro_torch paged attention, the tensor-core instance: a torch emulation
of its tiling and of its rounding of P (the hi/lo bf16 pair) against the
plain version and the reference's jnp oracle, its bitwise properties under
that emulation, the instance rule and launch counters, and — on a machine
with a card — every instance of the CUDA kernel against the plain version.

The emulation follows ``csrc/paged_attention.cu``'s ``paged_wgmma_kernel``:
blocks of 128 rows of one KV head laid out ``[nkv, T*g]``, tiles of the
instance's width (``WK``: 64 keys at h = 64, 128 and 48 at h = 256, as
``WgLayout<H>::WK`` in ``csrc/wgmma_attention.cuh``) at absolute key
positions gathered through the page table (zeros past the table), each
block walking tiles up to the one that holds its last row's position,
masked keys at -inf (p = 0), the online softmax in fp32 in log2 units, and
P rounded to bf16 before P V as the pair hi = bf16(p), lo = bf16(p - hi). Its exponent arithmetic may differ from the kernel's in
the last fp32 bits; what it shows is where bf16 rounding enters and that the
tiling keeps the walk's bitwise properties. Dot products are elementwise
products summed over one axis, as in the plain version, so a row's bits do
not depend on the rows beside it.

Tolerances are the reference's (``tests/test_kernels.py``): 3e-2 in bf16,
2e-5 in fp32, and in bf16 also two bf16 ulps of the plain value
(``BF16_ULPS``). Inputs are seeded numpy, fp32, rounded to bf16 to nearest
even on both sides.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel, ops, ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
BF16_ULPS = (2.0 ** -6, 1e-4)
WQ = 128                           # rows per block
WK = {64: 64, 128: 64, 256: 48}    # keys per tile, by head dim
LOG2E = np.float32(1.4426950408889634)
NEG_INF = -2.0e38

# (b, t, nq, nkv, h, ps, mp, pool): qwen2-0.5b heads at the serving page
# size (T*g = 259 rows: three row blocks, the last ragged), h = 128 with
# ragged T over two row blocks, a page size that does not divide a tile, and
# gemma-2b heads (8/1/256: T*g = 168 rows over two row blocks, 48-key tiles,
# pages of 20)
SHAPES = [
    (3, 37, 14, 2, 64, 16, 24, 96),
    (2, 45, 8, 2, 128, 16, 12, 40),
    (2, 19, 4, 1, 128, 24, 8, 30),
    (2, 21, 8, 1, 256, 20, 12, 40),
]


@pytest.fixture
def cuda():
    """Skips unless a CUDA card is present (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(shape, seed, dtype="bfloat16", device="cpu"):
    """q [B,T,nq,h], pools, a table of distinct pages per row, and starts
    that keep each chunk inside its table."""
    b, t, nq, nkv, h, ps, mp, pool = shape
    rng = np.random.default_rng(seed)
    conv = lambda a: torch.from_numpy(a).to(device).to(getattr(torch, dtype))
    q = conv(rng.standard_normal((b, t, nq, h)).astype(np.float32))
    kp = conv(rng.standard_normal((pool, ps, nkv, h)).astype(np.float32))
    vp = conv(rng.standard_normal((pool, ps, nkv, h)).astype(np.float32))
    table = np.stack([rng.choice(pool, mp, replace=False)
                      for _ in range(b)]).astype(np.int32)
    q_start = rng.integers(0, mp * ps - t + 1, b).astype(np.int32)
    return (q, kp, vp, torch.from_numpy(table).to(device),
            torch.from_numpy(q_start).to(device))


def _emulate(q, k_pool, v_pool, table, q_start, *, qoff=0, split=True):
    """The tensor-core instance's page walk in torch fp32 (module
    docstring): q [B,T,nq,h] bf16; query (b, t) at q_start[b] + qoff + t.
    ``split`` rounds P as the hi/lo pair, else as hi alone. -> bf16."""
    b, t, nq, h = q.shape
    ps, nkv = k_pool.shape[1], k_pool.shape[2]
    g, mp, wk = nq // nkv, table.shape[1], WK[h]
    k_end, n_rows = mp * ps, t * g
    c2 = float(np.float32(np.float32(1.0 / np.sqrt(h)) * LOG2E))
    out = torch.zeros((b, nkv, n_rows, h))
    for bi in range(b):
        qpos_all = int(q_start[bi]) + qoff + torch.arange(n_rows) // g
        for kvh in range(nkv):
            # row r = t*g + j is query t of head kvh*g + j
            rows = q[bi, :, kvh * g:(kvh + 1) * g].float().reshape(n_rows, h)
            for r0 in range(0, n_rows, WQ):
                qr, qpos = rows[r0:r0 + WQ], qpos_all[r0:r0 + WQ]
                q_last = int(qpos[-1])
                n_tiles = (0 if q_last < 0
                           else min(q_last // wk + 1, -(-k_end // wk)))
                m = torch.full((len(qr), 1), NEG_INF)
                l = torch.zeros((len(qr), 1))
                acc = torch.zeros((len(qr), h))
                for i in range(n_tiles):
                    kpos = torch.arange(i * wk, (i + 1) * wk)
                    inside = kpos < k_end
                    page = table[bi, (kpos // ps).clamp(max=mp - 1)].long()
                    zero = torch.zeros(())
                    k = torch.where(inside[:, None],
                                    k_pool[page, kpos % ps, kvh].float(), zero)
                    v = torch.where(inside[:, None],
                                    v_pool[page, kpos % ps, kvh].float(), zero)
                    s = (qr[:, None, :] * k[None]).sum(-1)        # [R, wk]
                    ok = (kpos[None] <= qpos[:, None]) & inside[None]
                    x = torch.where(ok, s * c2, -torch.inf)
                    m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    hi = p.bfloat16().float()
                    pv = (hi[..., None] * v[None]).sum(-2)
                    if split:
                        lo = (p - hi).bfloat16().float()
                        pv = pv + (lo[..., None] * v[None]).sum(-2)
                    acc = acc * alpha + pv
                    m = m_new
                out[bi, kvh, r0:r0 + WQ] = torch.where(
                    l == 0, 0.0, acc / torch.where(l == 0, 1.0, l))
    out = out.reshape(b, nkv, t, g, h).permute(0, 2, 1, 3, 4)
    return out.reshape(b, t, nq, h).bfloat16()


def _violations(out, want):
    """(elements beyond the 3e-2 gate, elements beyond two bf16 ulps)."""
    out, want = out.float(), want.float()
    diff = (out - want).abs()
    rel, ab = BF16_ULPS
    tol = TOL["bfloat16"]
    return (int((diff > tol + tol * want.abs()).sum()),
            int((diff > ab + rel * want.abs()).sum()))


# -- the emulation against the plain version and the reference -----------------

@pytest.mark.parametrize("shape", SHAPES)
def test_hi_lo_p_keeps_both_bf16_gates(shape):
    """P as a hi/lo bf16 pair stays within 3e-2 and within two bf16 ulps
    of the plain version everywhere, decode (T = 1) included."""
    q, kp, vp, tbl, qs = _inputs(shape, seed=sum(shape))
    want = ref.paged_prefill_attention_batch_ref(q, kp, vp, tbl, qs)
    assert _violations(_emulate(q, kp, vp, tbl, qs), want) == (0, 0)
    q1, lens = q[:, 0].contiguous(), qs + 1
    dec = _emulate(q1[:, None], kp, vp, tbl, lens, qoff=-1)[:, 0]
    assert _violations(dec, ref.paged_attention_ref(q1, kp, vp, tbl,
                                                    lens)) == (0, 0)


@pytest.mark.parametrize("shape", SHAPES)
def test_single_bf16_p_breaks_the_two_ulp_gate(shape):
    """P rounded once to bf16 passes 3e-2 but not two ulps of the plain
    version: why the instance takes the hi/lo pair."""
    q, kp, vp, tbl, qs = _inputs(shape, seed=sum(shape))
    want = ref.paged_prefill_attention_batch_ref(q, kp, vp, tbl, qs)
    loose, ulps = _violations(_emulate(q, kp, vp, tbl, qs, split=False),
                              want)
    assert loose == 0 and ulps > 0, (loose, ulps)


def test_emulation_matches_reference_oracle():
    """The emulation against the reference's jnp oracle on the same
    bits, at qwen2-0.5b heads (3e-2, the reference's bf16 tolerance)."""
    pytest.importorskip("jax", reason="the reference oracle needs jax")
    import jax.numpy as jnp

    from repro.kernels.paged_attention import ops as jops
    q, kp, vp, tbl, qs = _inputs(SHAPES[0], seed=7)
    jx = lambda x: (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                    if x.is_floating_point() else jnp.asarray(x.numpy()))
    want = jops.paged_prefill_attention_batch(*map(jx, (q, kp, vp, tbl, qs)),
                                              impl="reference")
    np.testing.assert_allclose(_emulate(q, kp, vp, tbl, qs).float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


# -- bitwise properties of the tiling, under the emulation -----------------------

@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[3:])
def test_emulated_decode_equals_verify_row_0(shape):
    """Decode is the T = 1 launch at q_start = lens - 1: its rows sit where
    verify row 0's do, and the tiles verify walks past them are no-ops."""
    q, kp, vp, tbl, qs = _inputs(shape, seed=3)
    verify = _emulate(q, kp, vp, tbl, qs)
    dec = _emulate(q[:, :1], kp, vp, tbl, qs + 1, qoff=-1)
    assert torch.equal(dec[:, 0], verify[:, 0])


@pytest.mark.parametrize("shape", SHAPES)
def test_emulated_trailing_pages_and_batch_padding_change_nothing(shape):
    """A table cut to the pages the rows cover, then widened with random
    pages, and a batch padded with other rows, give the same bits."""
    b, t, nq, nkv, h, ps, mp, pool = shape
    q, kp, vp, tbl, qs = _inputs(shape, seed=5)
    need = int(((qs + t + ps - 1) // ps).max())
    base = _emulate(q, kp, vp, tbl[:, :need].contiguous(), qs)
    rng = np.random.default_rng(6)
    extra = torch.from_numpy(rng.integers(0, pool, (b, 3)).astype(np.int32))
    wide = _emulate(q, kp, vp, torch.cat([tbl[:, :need], extra], 1), qs)
    assert torch.equal(base, wide)
    q2, _, _, tbl2, qs2 = _inputs(shape, seed=8)
    padded = _emulate(torch.cat([q, q2]), kp, vp,
                      torch.cat([tbl[:, :need], tbl2[:, :need]]),
                      torch.cat([qs, qs2.clamp(max=need * ps - t)]))
    assert torch.equal(padded[:b], base)


# -- the instance rule and the counters -----------------------------------------

def test_instance_is_chosen_by_dtype_and_head_dim():
    for h in kernel.HEAD_DIMS:
        want = ("paged_walk_wgmma" if h in kernel.WGMMA_HEAD_DIMS
                else "paged_walk")
        assert kernel.instance(torch.bfloat16, h) == want
        assert kernel.instance(torch.float32, h) == "paged_walk"
    assert kernel.WGMMA_HEAD_DIMS == (64, 128, 256)
    assert set(kernel.WGMMA_HEAD_DIMS) < set(kernel.HEAD_DIMS)


def test_launch_counters_have_an_entry_per_wrapper_and_instance():
    assert set(kernel.LAUNCHES) == {
        "paged_attention", "paged_prefill_attention_batch",
        "paged_prefill_attention", "paged_walk", "paged_walk_wgmma"}
    saved = dict(kernel.LAUNCHES)
    try:
        kernel.LAUNCHES["paged_walk_wgmma"] = 3
        kernel.reset_launch_counts()
        assert all(v == 0 for v in kernel.LAUNCHES.values())
    finally:
        kernel.LAUNCHES.update(saved)


# -- every instance of the CUDA kernel against the plain version (card only) -----

CUDA_CASES = [  # (b, t, nq, nkv, h, ps, mp, pool, dtype)
    (8, 1, 14, 2, 64, 16, 50, 512, "bfloat16"),
    (8, 37, 14, 2, 64, 16, 50, 512, "bfloat16"),
    (3, 45, 8, 2, 128, 16, 12, 40, "bfloat16"),
    (2, 19, 4, 1, 128, 24, 8, 30, "bfloat16"),
    (3, 7, 8, 1, 256, 16, 20, 80, "bfloat16"),
    (3, 7, 8, 1, 256, 16, 20, 80, "float32"),
    (3, 7, 4, 2, 32, 16, 20, 80, "bfloat16"),
    (8, 1, 8, 1, 256, 16, 50, 512, "bfloat16"),   # gemma-2b decode
    (8, 5, 8, 1, 256, 16, 50, 512, "bfloat16"),   # gemma-2b verify
]


@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_instance_matches_plain(cuda, case):
    *shape, dtype = case
    q, kp, vp, tbl, qs = _inputs(tuple(shape), seed=sum(shape), dtype=dtype,
                                 device=cuda)
    name = kernel.instance(q.dtype, q.shape[-1])
    n0 = kernel.LAUNCHES[name]
    out = ops.paged_prefill_attention_batch(q, kp, vp, tbl, qs)
    dec = ops.paged_attention(q[:, 0].contiguous(), kp, vp, tbl, qs + 1)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES[name] == n0 + 2
    want = ref.paged_prefill_attention_batch_ref(q, kp, vp, tbl, qs)
    diff = (out.float() - want.float()).abs()
    tol = TOL[dtype]
    assert bool((diff <= tol + tol * want.float().abs()).all())
    if dtype == "bfloat16":
        assert _violations(out.cpu(), want.cpu()) == (0, 0)
    assert torch.equal(dec, out[:, 0])
