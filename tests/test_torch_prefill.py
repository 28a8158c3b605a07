"""repro_torch's full-sequence forward against the reference: ``LM.prefill``,
``LM.loss``, ``make_eval_step``, the cross-entropy losses, the registry's
shapes and step functions, and the gemma-2b config.

Both packages get the same params (drawn by the reference, crossing through
numpy) and the same seeded tokens, on the dense smoke configs (qwen2, gemma,
gemma3, internlm2) and those of the MoE, VLM, hybrid and SSM families
(granite-moe, deepseek-v3 with MLA and its MTP head, qwen2-vl, hymba,
xlstm) in fp32. Tolerance 5e-5, as ``test_torch_models.py``: both sides compute in
fp32 but sum in different orders (XLA:CPU vs ATen). The port's forward runs
with ``attn_impl=None`` (the chunked branch on the CPU) and ``"flash"``
(the flash kernel's plain version); the reference's LM takes its chunked
branch. The reference runs under ``jax.jit``. On a card, the serving engine
must refuse a head dim its paged kernel lacks when it is built; on any
device it refuses a config with sliding windows, which the reference's
engine serves as full attention.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.models import layers as r_layers  # noqa: E402
from repro.models.lm import LM  # noqa: E402
from repro.train.trainstep import make_eval_step as r_eval_step  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.train.trainstep import make_eval_step  # noqa: E402
from _torch_parity import port_config  # noqa: E402

TOL = dict(rtol=5e-5, atol=5e-5)
ARCHS = ["qwen2-0.5b", "gemma-2b", "gemma3-27b", "internlm2-20b",
         "granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-vl-7b",
         "hymba-1.5b", "xlstm-125m"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference cfg, reference LM, its params, port LM, port params,
    tokens) for one smoke config in fp32."""
    cfg = dataclasses.replace(r_registry.get_smoke_config(request.param),
                              compute_dtype="float32")
    rm = LM(cfg)
    params = jax.tree.map(np.asarray, jax.jit(rm.init)(jax.random.PRNGKey(0)))
    tm = TLM(port_config(cfg))     # sub-configs as the port's dataclasses
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 21))
    return (cfg, rm, params, tm, params_from_reference(params, device="cpu"),
            toks)


@pytest.mark.parametrize("attn_impl", [None, "flash"])
def test_prefill_and_loss_match_reference(model, attn_impl):
    _, rm, params, tm, tparams, toks = model
    tm.attn_impl = attn_impl
    batch = {"tokens": torch.from_numpy(toks)}
    rbatch = {"tokens": jnp.asarray(toks)}
    want = jax.jit(rm.prefill)(params, rbatch)
    got = tm.prefill(tparams, batch)
    assert got.shape == want.shape == (2, 1, rm.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    (want, wm), (got, gm) = jax.jit(rm.loss)(params, rbatch), \
        tm.loss(tparams, batch)
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    assert set(gm) == set(wm)
    for k in wm:                  # ce, aux, and deepseek's mtp_ce
        np.testing.assert_allclose(gm[k].item(), float(wm[k]), **TOL)
    # the dense and VLM families have no aux loss; MoE's router has one
    assert (gm["aux"].item() == float(wm["aux"]) == 0.0) == \
        (rm.cfg.moe is None)


def test_eval_step_matches_reference(model):
    _, rm, params, tm, tparams, toks = model
    want = jax.jit(r_eval_step(rm))(params, {"tokens": jnp.asarray(toks)})
    got = make_eval_step(tm)(tparams, {"tokens": torch.from_numpy(toks)})
    assert set(got) == set(want) == {"ce", "aux", "loss"} | (
        {"mtp_ce"} if rm.cfg.mtp_depth else set())
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), **TOL)


@pytest.mark.parametrize("chunk", [0, 3, 8])
def test_softmax_xent_matches_reference(chunk):
    """Both losses, with and without a mask; the fused loss at its default
    chunk rule (``chunk=0``) and at ragged chunks."""
    rng = np.random.default_rng(chunk)
    b, s, d, v = 2, 10, 16, 48
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, (b, s))
    mask = (rng.random((b, s)) < 0.7).astype(np.float32)
    logits = h @ w
    t = torch.from_numpy
    xent = jax.jit(r_layers.softmax_xent)
    np.testing.assert_allclose(
        t_layers.softmax_xent(t(logits), t(labels)).item(),
        float(xent(logits, labels)), **TOL)
    np.testing.assert_allclose(
        t_layers.softmax_xent(t(logits), t(labels), t(mask)).item(),
        float(xent(logits, labels, mask)), **TOL)
    np.testing.assert_allclose(
        t_layers.softmax_xent_fused(t(h), t(w), t(labels), chunk).item(),
        float(jax.jit(r_layers.softmax_xent_fused, static_argnums=3)(
            h, w, labels, chunk)), **TOL)


def test_registry_shapes_and_steps_mirror_reference(model):
    cfg, rm, params, tm, tparams, toks = model
    tcfg = tm.cfg
    assert list(t_registry.SHAPES) == list(r_registry.SHAPES)
    for name, shape in r_registry.SHAPES.items():
        tshape = t_registry.SHAPES[name]
        assert dataclasses.asdict(tshape) == dataclasses.asdict(shape)
        assert t_registry.cell_supported(tcfg, tshape) == \
            r_registry.cell_supported(cfg, shape)
    assert isinstance(t_registry.make_model(tcfg), TLM)
    batch = {"tokens": torch.from_numpy(toks)}
    rbatch = {"tokens": jnp.asarray(toks)}
    train = t_registry.step_fn(tcfg, t_registry.SHAPES["train_4k"], tm)
    want = jax.jit(r_registry.step_fn(cfg, r_registry.SHAPES["train_4k"],
                                      rm))(params, rbatch)
    np.testing.assert_allclose(train(tparams, batch)[0].item(),
                               float(want[0]), **TOL)
    prefill = t_registry.step_fn(tcfg, t_registry.SHAPES["prefill_32k"], tm)
    want = jax.jit(r_registry.step_fn(cfg, r_registry.SHAPES["prefill_32k"],
                                      rm))(params, rbatch)
    np.testing.assert_allclose(prefill(tparams, batch).numpy(),
                               np.asarray(want), **TOL)
    # the decode shapes' step: one token against a small cache (a stand-in
    # for the shapes' 32k and 500k slots); xlstm's against the reference's
    # prefill of that token, since its decode leaves out the mLSTM's output
    # gate (ROADMAP §3)
    toks1 = toks[:, :1]
    for name in ("decode_32k", "long_500k"):
        decode = t_registry.step_fn(tcfg, t_registry.SHAPES[name], tm)
        if cfg.xlstm is not None:
            want = jax.jit(rm.prefill)(params, {"tokens": jnp.asarray(toks1)})
        else:
            want, _ = jax.jit(r_registry.step_fn(
                cfg, r_registry.SHAPES[name], rm))(
                params, {"cache": rm.init_cache(2, 8),
                         "tokens": jnp.asarray(toks1, jnp.int32),
                         "position": jnp.int32(0)})
        got, _ = decode(tparams, {"cache": tm.init_cache(2, 8, device="cpu"),
                                  "tokens": torch.from_numpy(toks1),
                                  "position": 0})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gemma_config_mirrors_reference():
    """Every config and smoke config equals the reference's; the dense
    ones (gemma3-27b's sliding windows included), the MoE ones, the VLM,
    the hybrid and the SSM build an ``LM`` with the reference's layer
    groups, and ``LM`` refuses the encoder-decoder config, naming
    ``EncDecLM``, which ``registry.make_model`` builds."""
    for arch in r_registry.ARCH_IDS:
        assert t_registry.get_config(arch) == port_config(
            r_registry.get_config(arch))
        assert t_registry.get_smoke_config(arch) == port_config(
            r_registry.get_smoke_config(arch))
    full = t_registry.get_config("gemma-2b")
    assert (full.num_layers, full.head_dim_, full.num_kv_heads) == (18, 256, 1)
    g3 = t_registry.get_config("gemma3-27b")
    assert (g3.family, g3.sliding_window, g3.global_every) == ("dense", 1024,
                                                               6)
    assert TLM(g3).windows.tolist() == [
        0 if i % 6 == 5 else 1024 for i in range(62)]
    for arch in ("granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-vl-7b"):
        assert TLM(t_registry.get_config(arch)).groups
    for arch in ("xlstm-125m", "hymba-1.5b"):
        assert [(g.kind, g.indices, g.scanned) for g in
                TLM(t_registry.get_config(arch)).groups] == \
            [(g.kind, g.indices, g.scanned) for g in
             LM(r_registry.get_config(arch)).groups]
    with pytest.raises(ValueError, match="EncDecLM"):
        TLM(t_registry.get_config("whisper-tiny"))
    assert type(t_registry.make_model(
        t_registry.get_config("whisper-tiny"))).__name__ == "EncDecLM"



def test_windowed_serving_is_refused_and_reference_serving_is_window_blind():
    """The reference's paged serving ignores sliding windows: its
    ``PagedDecoder`` prefill logits of a windowed config equal the LM's
    with the windows taken away, and differ from the windowed LM's
    (ROADMAP §3). The port's engine refuses a windowed config instead of
    serving it the same way."""
    from repro.placement.pool import BwapPagePool, MemoryDomain
    from repro.serve.engine import PagedDecoder
    from repro_torch.placement import pool as t_pool
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(r_registry.get_smoke_config("gemma3-27b"),
                              num_layers=2, sliding_window=4, global_every=2,
                              compute_dtype="float32")
    assert LM(cfg).windows.tolist() == [4, 0]
    params = jax.jit(LM(cfg).init)(jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, 12)
    pool = BwapPagePool(cfg, [MemoryDomain("hbm_local", 8, 819.0, True)],
                        page_size=4)
    pages = [pool.alloc_page() for _ in range(3)]
    served = np.asarray(PagedDecoder(cfg, params, pool).forward_chunks(
        [(toks.tolist(), pages, 0)], want_logits=True))[0, -1]
    batch = {"tokens": jnp.asarray(toks[None])}
    windowed = np.asarray(LM(cfg).prefill(params, batch))[0, -1]
    full = np.asarray(LM(dataclasses.replace(cfg, sliding_window=0))
                      .prefill(params, batch))[0, -1]
    np.testing.assert_allclose(served, full, **TOL)
    assert np.abs(served - windowed).max() > 1e-3
    tcfg = port_config(cfg)
    tpool = t_pool.BwapPagePool(
        tcfg, [t_pool.MemoryDomain("hbm_local", 8, 819.0, True)],
        page_size=4, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        ServeEngine(tcfg, params_from_reference(
            jax.tree.map(np.asarray, params), device="cpu"), tpool,
            device="cpu")

def test_paged_kernel_head_dim_check():
    """gemma-2b's head dim 256 has a paged-kernel instance (the tensor-core
    walk), so the check the engine runs when it is built on a card passes;
    a head dim with no instance raises."""
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    gemma_h = t_registry.get_config("gemma-2b").head_dim_
    assert gemma_h == 256 and gemma_h in paged_kernel.HEAD_DIMS
    for h in paged_kernel.HEAD_DIMS:
        paged_kernel.check_head_dim(h)
    for h in (48, 512):
        with pytest.raises(ValueError, match=f"head dim {h}"):
            paged_kernel.check_head_dim(h)


def test_cuda_engine_builds_at_head_dim_256():
    """On a card the engine builds at head dim 256 and serves through the
    paged kernel's tensor-core instance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(t_registry.get_smoke_config("gemma-2b"),
                              head_dim=256)
    params = TLM(cfg).init(torch.Generator().manual_seed(0), device="cuda")
    pool = BwapPagePool(cfg, [MemoryDomain("hbm_local", 64, 819.0, True)],
                        page_size=16, device="cuda")
    eng = ServeEngine(cfg, params, pool, max_batch=2, max_new=4,
                      wall_clock=False, device="cuda")
    for n in (5, 21):
        eng.submit(list(range(1, n + 1)))
    before = paged_kernel.LAUNCHES[paged_kernel.instance(
        getattr(torch, cfg.compute_dtype), 256)]
    while eng.active or eng.waiting:
        eng.step()
    assert len(eng.finished) == 2
    assert all(s.produced == 4 for s in eng.finished)
    assert paged_kernel.LAUNCHES[paged_kernel.instance(
        getattr(torch, cfg.compute_dtype), 256)] > before
