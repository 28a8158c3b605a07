"""repro_torch paged attention, the tensor-core instance: a torch emulation
of its tiling, its key chunks and their fold, and of its rounding of P (the
hi/lo bf16 pair) against the plain version and the reference's jnp oracle,
its bitwise properties under that emulation, the instance and route rules
and launch counters, and — on a machine with a card — every instance of the
CUDA kernel against the plain version and both of its routes against each
other.

The emulation follows ``csrc/paged_attention.cu``'s ``paged_wgmma_kernel``:
blocks of 128 rows of one KV head laid out ``[nkv, T*g]``, tiles of the
instance's width (``kernel.TILE_KEYS``: 64 keys at h = 64, 128 and 48 at
h = 256, as ``WgLayout<H>::WK`` in ``csrc/wgmma_attention.cuh``) at absolute
key positions gathered through the page table (zeros past the table), each
block walking tiles up to the one that holds its last row's position,
masked keys at -inf (p = 0), the online softmax in fp32 in log2 units, and
P rounded to bf16 before P V as the pair hi = bf16(p), lo = bf16(p - hi).
Tiles form key chunks of ``kernel.CHUNK_TILES`` tiles at absolute
positions; each chunk's walk starts at m = -2e38, l = 0, O = 0, and a row's
result is the fold of its chunk partials in ascending order (M' = max(M,
m), a = 2^(M - M'), b = 2^(m - M'), L' = fma(L, a, l b), Acc' = fma(Acc, a,
O b)), then Acc / L. Two routes, as the kernel's: ``"serial"`` walks a
block's chunks in one pass and folds each as it ends; ``"split"`` walks
each chunk on its own and folds the partials afterwards. ``route=None`` is
the walk before chunks (one pass, no fold). Its exponent arithmetic may
differ from the kernel's in the last fp32 bits; what it shows is where bf16
rounding enters and that the tiling and the chunks keep the walk's bitwise
properties. Dot products are elementwise products summed over one axis, as
in the plain version, so a row's bits do not depend on the rows beside it.

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
WQ = kernel.BLOCK_ROWS             # rows per block
WK = kernel.TILE_KEYS              # keys per tile, by head dim
CH = kernel.CHUNK_TILES            # tiles per key chunk, by head dim
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
# contexts of at least 5 key chunks (2688 keys at h = 64: 42 tiles, 11
# chunks; 2688 at h = 128, pages of 24: 42 tiles, 6 chunks; 2048 at
# h = 256: 43 tiles, 6 chunks), qwen2-0.5b, gemma3-27b-like and gemma-2b
# heads
LONG = [
    (2, 3, 14, 2, 64, 16, 168, 180),
    (2, 4, 4, 2, 128, 24, 112, 120),
    (2, 3, 8, 1, 256, 16, 128, 136),
]


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation's many small CPU ops run on one thread: beside the
    other test workers, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _fma(x, y, z):
    """x * y + z rounded once to fp32 (via fp64, where x * y is exact)."""
    return (x.double() * y.double() + z.double()).float()


def _fold(state, part):
    """Folds a chunk partial (m, l, O) into the running (M, L, Acc)."""
    (mm, ll, acc), (m, l, o) = state, part
    mn = torch.maximum(mm, m)
    a, b = torch.exp2(mm - mn), torch.exp2(m - mn)
    return mn, _fma(ll, a, l * b), _fma(acc, a, o * b)


def _emulate(q, k_pool, v_pool, table, q_start, *, qoff=0, split=True,
             route="serial"):
    """The tensor-core instance's page walk in torch fp32 (module
    docstring): q [B,T,nq,h] bf16; query (b, t) at q_start[b] + qoff + t.
    ``split`` rounds P as the hi/lo pair, else as hi alone; ``route`` is
    ``"serial"``, ``"split"`` or None (no chunks). -> bf16."""
    b, t, nq, h = q.shape
    ps, nkv = k_pool.shape[1], k_pool.shape[2]
    g, mp, wk, ch = nq // nkv, table.shape[1], WK[h], CH[h]
    k_end, n_rows = mp * ps, t * g
    c2 = float(np.float32(np.float32(1.0 / np.sqrt(h)) * LOG2E))
    out = torch.zeros((b, nkv, n_rows, h))
    for bi in range(b):
        qpos_all = int(q_start[bi]) + qoff + torch.arange(n_rows) // g
        for kvh in range(nkv):
            # row r = t*g + j is query t of head kvh*g + j
            rows = q[bi, :, kvh * g:(kvh + 1) * g].float().reshape(n_rows, h)

            def tile(i, qr, qpos, state):
                """One tile of the online softmax: (m, l, acc) -> new."""
                m, l, acc = state
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
                return m_new, l, acc * alpha + pv

            for r0 in range(0, n_rows, WQ):
                qr, qpos = rows[r0:r0 + WQ], qpos_all[r0:r0 + WQ]
                q_last = int(qpos[-1])
                n_tiles = (0 if q_last < 0
                           else min(q_last // wk + 1, -(-k_end // wk)))
                fresh = lambda: (torch.full((len(qr), 1), NEG_INF),
                                 torch.zeros((len(qr), 1)),
                                 torch.zeros((len(qr), h)))
                folded = fresh()
                if route is None:
                    for i in range(n_tiles):
                        folded = tile(i, qr, qpos, folded)
                elif route == "serial":
                    # one pass; a chunk's last tile folds it, the next tile
                    # starts afresh
                    walk = fresh()
                    for i in range(n_tiles):
                        walk = tile(i, qr, qpos, walk)
                        if (i + 1) % ch == 0 or i == n_tiles - 1:
                            folded = _fold(folded, walk)
                            walk = fresh()
                else:
                    # each chunk on its own, then the partials in order
                    parts = []
                    for c0 in range(0, n_tiles, ch):
                        walk = fresh()
                        for i in range(c0, min(c0 + ch, n_tiles)):
                            walk = tile(i, qr, qpos, walk)
                        parts.append(walk)
                    for part in parts:
                        folded = _fold(folded, part)
                _, l, acc = folded
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


# -- the key chunks, their fold and the two routes, under the emulation ----------

def _chunks(shape):
    b, t, nq, nkv, h, ps, mp, pool = shape
    return -(-(-(-mp * ps // WK[h])) // CH[h])


@pytest.mark.parametrize("shape", LONG + SHAPES[:1] + SHAPES[3:])
def test_emulated_routes_give_equal_bits(shape):
    """One chunk a block then the ordered merge, and one pass that folds
    each chunk as it ends, give the same bits, in decode and in verify."""
    q, kp, vp, tbl, qs = _inputs(shape, seed=11)
    assert torch.equal(_emulate(q, kp, vp, tbl, qs, route="split"),
                       _emulate(q, kp, vp, tbl, qs, route="serial"))
    lens = qs + 1
    assert torch.equal(
        _emulate(q[:, :1], kp, vp, tbl, lens, qoff=-1, route="split"),
        _emulate(q[:, :1], kp, vp, tbl, lens, qoff=-1, route="serial"))


@pytest.mark.parametrize("shape", LONG)
def test_emulated_long_decode_equals_verify_row_0(shape):
    """At >= 5 chunks, decode on the split route equals verify row 0 on the
    serial route (and on the split route) bit for bit."""
    assert _chunks(shape) >= 5
    q, kp, vp, tbl, qs = _inputs(shape, seed=12)
    dec = _emulate(q[:, :1], kp, vp, tbl, qs + 1, qoff=-1, route="split")
    for route in ("serial", "split"):
        verify = _emulate(q, kp, vp, tbl, qs, route=route)
        assert torch.equal(dec[:, 0], verify[:, 0])


@pytest.mark.parametrize("shape", LONG)
def test_emulated_long_trailing_pages_and_batch_padding_change_nothing(shape):
    """At >= 5 chunks, a table cut to the pages the rows cover then widened
    (whole chunks of random pages past the last row), and a batch padded
    with other rows, give the same bits on both routes."""
    b, t, nq, nkv, h, ps, mp, pool = shape
    q, kp, vp, tbl, qs = _inputs(shape, seed=13)
    need = int(((qs + t + ps - 1) // ps).max())
    extra = torch.from_numpy(np.random.default_rng(14).integers(
        0, pool, (b, 2 * CH[h] * WK[h] // ps + 1)).astype(np.int32))
    q2, _, _, tbl2, qs2 = _inputs(shape, seed=15)
    for route in ("serial", "split"):
        base = _emulate(q, kp, vp, tbl[:, :need].contiguous(), qs,
                        route=route)
        wide = _emulate(q, kp, vp, torch.cat([tbl[:, :need], extra], 1), qs,
                        route=route)
        assert torch.equal(base, wide)
        padded = _emulate(torch.cat([q, q2]), kp, vp,
                          torch.cat([tbl[:, :need], tbl2[:, :need]]),
                          torch.cat([qs, qs2.clamp(max=need * ps - t)]),
                          route=route)
        assert torch.equal(padded[:b], base)


@pytest.mark.parametrize("h", [64, 256])
def test_emulated_rows_inside_chunk_0_equal_the_unchunked_walk(h):
    """A row whose keys all lie in chunk 0 gets the bits of the walk before
    chunks: folding chunk 0 into the start state gives chunk 0, and later
    chunks are no-ops for it. The block holds rows on both sides of the
    chunk edge; rows past it are not compared."""
    c = CH[h] * WK[h]                      # keys a chunk
    shape = (1, c + 40, 4, 2, h, 16, (c + 40) // 16 + 4, 64)
    q, kp, vp, tbl, _ = _inputs(shape, seed=16)
    qs = torch.zeros(1, dtype=torch.int32)
    old = _emulate(q, kp, vp, tbl, qs, route=None)
    for route in ("serial", "split"):
        new = _emulate(q, kp, vp, tbl, qs, route=route)
        assert torch.equal(new[:, :c], old[:, :c])
        assert not torch.equal(new[:, c:], old[:, c:])   # a real fold ran
    dec = _emulate(q[:, c - 1:c], kp, vp, tbl,
                   torch.tensor([c], dtype=torch.int32), qoff=-1,
                   route="split")
    assert torch.equal(dec[:, 0], old[:, c - 1])


@pytest.mark.parametrize("shape", LONG)
def test_long_context_hi_lo_keeps_both_bf16_gates(shape):
    """At >= 5 chunks the chunked walk and its fold stay within 3e-2 and two
    bf16 ulps of the plain version, decode included."""
    q, kp, vp, tbl, qs = _inputs(shape, seed=17)
    want = ref.paged_prefill_attention_batch_ref(q, kp, vp, tbl, qs)
    assert _violations(_emulate(q, kp, vp, tbl, qs), want) == (0, 0)
    q1, lens = q[:, 0].contiguous(), qs + 1
    dec = _emulate(q1[:, None], kp, vp, tbl, lens, qoff=-1, route="split")
    assert _violations(dec[:, 0], ref.paged_attention_ref(
        q1, kp, vp, tbl, lens)) == (0, 0)


def test_fold_of_an_unreached_chunk_is_an_exact_no_op():
    """(M, L, Acc) folded with (-2e38, 0, 0) stays as it was, bit for bit;
    folded into the start state, a chunk gives itself."""
    rng = np.random.default_rng(18)
    m = torch.from_numpy(rng.standard_normal((5, 1)).astype(np.float32))
    l = torch.from_numpy(rng.random((5, 1)).astype(np.float32)) + 1
    o = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    start = (torch.full((5, 1), NEG_INF), torch.zeros((5, 1)),
             torch.zeros((5, 8)))
    first = _fold(start, (m, l, o))
    assert all(torch.equal(x, y) for x, y in zip(first, (m, l, o)))
    again = _fold(first, start)
    assert all(torch.equal(x, y) for x, y in zip(again, first))


# -- the route rule -----------------------------------------------------------------

def test_route_rule_and_workspace():
    """Decode at batch 8 (8 or 16 row blocks) splits, and so does a
    single sequence's chunk of T = 256 at qwen2-0.5b heads (3.8 MB of
    partials) but not at gemma-2b heads (6.3 MB, over ``SPLIT_BYTES``);
    batched prefill at T = 256 (128 or 224 row blocks) walks serially; a
    table of one chunk never splits; the workspace holds every chunk's
    (m, l, O) of every row on the split route, and the serial route's
    second accumulator (h / 2 floats a consumer thread) on the other."""
    sms = 132
    for nq, nkv, h in ((14, 2, 64), (8, 1, 256)):
        chunks = kernel.n_chunks(h, 16, 50)
        assert chunks == -(-(-(-800 // WK[h])) // CH[h])
        split, nbytes, tickets = kernel.plan(8, 1, nq, nkv, h, 16, 50, sms)
        g = nq // nkv
        assert split and tickets == 8 * nkv
        assert nbytes == 4 * 8 * nkv * chunks * g * (h + 2)
        # a single sequence's chunk splits while its partials stay small
        assert kernel.plan(1, 256, nq, nkv, h, 16, 50, sms)[0] == (h == 64)
        split, nbytes, tickets = kernel.plan(8, 256, nq, nkv, h, 16, 50, sms)
        blocks = 8 * nkv * -(-256 * g // WQ)
        assert not split and tickets == 0
        assert nbytes == 4 * blocks * 256 * h // 2
        # forced routes; one chunk takes the serial walk
        assert not kernel.plan(8, 1, nq, nkv, h, 16, 50, sms, "serial")[0]
        assert kernel.plan(8, 256, nq, nkv, h, 16, 50, sms, "split")[0]
        one = CH[h] * WK[h] // 16
        assert not kernel.plan(8, 1, nq, nkv, h, 16, one, sms, "split")[0]
    assert kernel.CHUNK_TILES.keys() == kernel.TILE_KEYS.keys() \
        == set(kernel.WGMMA_HEAD_DIMS)
    with pytest.raises(ValueError, match="route"):
        kernel.plan(8, 1, 14, 2, 64, 16, 50, sms, "both")


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


# long contexts (>= 5 chunks at every head dim, up to 4096 keys), pools of
# 2560 pages, decode (T = 1) and verify (T = 5: one walking consumer
# warpgroup), and chunks of T = 40 (280 and 320 rows: both warpgroups)
CUDA_LONG = [  # (b, t, nq, nkv, h, ps, mp, pool)
    (8, 5, 14, 2, 64, 16, 256, 2560),
    (4, 5, 32, 16, 128, 16, 192, 1024),
    (8, 5, 8, 1, 256, 16, 256, 2560),
    (2, 40, 14, 2, 64, 16, 256, 600),
    (2, 40, 8, 1, 256, 16, 256, 600),
]


def test_cuda_layout_matches_the_mirror(cuda):
    """The built instance's tile and chunk widths are the ones the wrapper
    (which sizes the workspace from them) and the emulation use."""
    for h in kernel.WGMMA_HEAD_DIMS:
        assert kernel.layout(h) == (WK[h], CH[h])


@pytest.mark.parametrize("case", CUDA_LONG)
def test_cuda_routes_give_equal_bits(cuda, case):
    """On the card, at long contexts: the split and the serial route give
    the same bits in decode and in verify, decode equals verify row 0 on
    each route, and both hold the plain version under both bf16 gates."""
    q, kp, vp, tbl, qs = _inputs(case, seed=sum(case), device=cuda)
    lens = qs + 1
    q1 = q[:, 0].contiguous()
    dec = {r: kernel.paged_attention(q1, kp, vp, tbl, lens, route=r)
           for r in kernel.ROUTES}
    ver = {r: kernel.paged_prefill_attention_batch(q, kp, vp, tbl, qs,
                                                   route=r)
           for r in kernel.ROUTES}
    torch.cuda.synchronize()
    assert torch.equal(dec["split"], dec["serial"])
    assert torch.equal(ver["split"], ver["serial"])
    assert torch.equal(dec["split"], ver["serial"][:, 0])
    want = ref.paged_prefill_attention_batch_ref(q, kp, vp, tbl, qs)
    assert _violations(ver["split"].cpu(), want.cpu()) == (0, 0)
    assert _violations(dec["serial"].cpu(), ref.paged_attention_ref(
        q1, kp, vp, tbl, lens).cpu()) == (0, 0)


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
