"""Gradients of repro_torch's ``LM.loss`` against ``jax.grad`` of the
reference's, and the flash kernel's refusal to be differentiated.

On the CPU the port's ``torch.autograd`` grads equal the reference's on
the four dense smoke configs and those of the MoE, VLM, hybrid, SSM and
encoder-decoder families (granite-moe, deepseek-v3 with MLA and its MTP
head, qwen2-vl, hymba, xlstm, whisper) in fp32 (rtol 1e-4, atol 1e-5)
for every param leaf (xlstm's embedding table with rtol taken of each
row's largest |grad|, ``ROW_SCALED``): attention's projections included,
which a forward through the flash kernel would cut off, the router
(through the aux loss and the gate weights), the experts, the MTP head,
the Mamba, mLSTM and sLSTM mixers, and whisper's encoder (through the
cross-attention). Both get the same params (drawn by
the reference, crossing through numpy) and the same seeded tokens; the
reference's grad runs under ``jax.jit``. On a card, ``attn_impl=None``
and ``"flash"`` launch the kernel, and a backward through it raises;
``"reference"`` trains through the chunked branch.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import port_config  # noqa: E402

ARCHS = ["qwen2-0.5b", "gemma-2b", "internlm2-20b", "gemma3-27b",
         "granite-moe-3b-a800m", "deepseek-v3-671b", "qwen2-vl-7b",
         "hymba-1.5b", "xlstm-125m", "whisper-tiny"]

# The one leaf held at the file's rtol of its row's largest |grad| rather
# than of each element: xlstm-125m's embedding table. Its rows are drawn at
# rms 0.0199, so the first RMSNorm scales their gradient ~50x, and its
# backward, (g * gamma - xhat * mean(g * gamma * xhat)) / rms, rounds
# relative to the row: 6 of its 16384 elements miss the elementwise bound,
# by up to 4.886e-5 at |grad| 0.2036 in a row whose largest |grad| is
# 3.26 (worst |diff| 0.146 of the row bound).
ROW_SCALED = {("xlstm-125m", "['embed']")}


def _grads(tm, tparams, toks, frames=None):
    leaves = jax.tree.leaves(tparams)
    for x in leaves:
        x.requires_grad_(True)
    batch = {"tokens": toks}
    if frames is not None:
        batch["frames"] = frames
    loss, _ = tm.loss(tparams, batch)
    loss.backward()
    return loss, [x.grad for x in leaves]


def _qkv_owners(tm) -> int:
    """How many q/k/v projection triples the param tree holds: one per
    stacked group or per layer of a list group (attention, or an mLSTM's
    mixer; an sLSTM has none), one in the MTP layer; whisper's encoder
    layers one each, its decoder layers two (self and cross)."""
    cfg = tm.cfg
    if cfg.enc_dec:
        return cfg.enc_layers + 2 * cfg.num_layers
    return sum(1 if g.scanned else len(g.indices) for g in tm.groups
               if g.kind != "slstm") + (1 if cfg.mtp_depth else 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_reference(arch):
    cfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                              compute_dtype="float32")
    rm = r_registry.make_model(cfg)
    params = jax.tree.map(np.asarray, jax.jit(rm.init)(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 16))
    batch = {"tokens": jnp.asarray(toks)}
    frames = None
    if cfg.enc_dec:                 # whisper's stub frame embeddings
        frames = rng.standard_normal((2, cfg.enc_frames, cfg.d_model)
                                     ).astype(np.float32)
        batch["frames"] = jnp.asarray(frames)
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: rm.loss(p, b)[0]))(params, batch)
    tm = t_registry.make_model(port_config(cfg))
    tparams = params_from_reference(params, device="cpu")
    loss, got = _grads(tm, tparams, torch.from_numpy(toks),
                       None if frames is None else torch.from_numpy(frames))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(want)]
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        assert g is not None, path
        g, w = g.numpy(), np.asarray(w)
        if (arch, path) in ROW_SCALED:
            bound = 1e-5 + 1e-4 * np.abs(w).max(-1, keepdims=True)
            assert (np.abs(g - w) <= bound).all(), \
                (path, float((np.abs(g - w) / bound).max()))
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5,
                                       err_msg=path)
    # attention's projections are reached, and not by zeros: one leaf per
    # stacked group, one per layer of a list group, one in the MTP layer
    # (``_qkv_owners``)
    names = (("wq_a", "wq_b", "wkv_a", "wkv_b") if cfg.mla
             else ("wq", "wk", "wv"))
    attn = [g for path, g in zip(paths, got)
            if any(f"'{n}'" in path for n in names)]
    assert len(attn) == len(names) * _qkv_owners(tm)
    assert all(float(g.abs().max()) > 0 for g in attn)
    if cfg.moe is not None:
        moe = [g for path, g in zip(paths, got)
               if any(f"'{n}'" in path for n in ("router", "w_gate"))
               and "'moe'" in path]
        assert moe and all(float(g.abs().max()) > 0 for g in moe)


def test_cuda_flash_refuses_backward_and_reference_trains():
    """On a card, ``attn_impl=None`` and ``"flash"`` launch the kernel in
    the forward, and a backward through it raises, naming
    ``attn_impl='reference'``; ``"reference"`` launches no kernel and its
    grads reach wq, wk and wv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import kernel as fkernel
    cfg = port_config(dataclasses.replace(
        r_registry.get_smoke_config("qwen2-0.5b"), head_dim=64,
        compute_dtype="bfloat16"))
    tm = TLM(cfg)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 64))).cuda()
    for impl in (None, "flash"):
        tm.attn_impl = impl
        params = tm.init(torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
        fkernel.reset_launch_counts()
        leaves = jax.tree.leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = tm.loss(params, {"tokens": toks})
        # the forward's launches: under remat (a stacked group) the
        # backward recomputes a layer, launching once more, then raises
        assert fkernel.LAUNCHES["flash_attention_wgmma"] == cfg.num_layers
        with pytest.raises(NotImplementedError,
                           match="no backward kernel.*attn_impl='reference'"):
            loss.backward()
    tm.attn_impl = "reference"
    params = tm.init(torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    fkernel.reset_launch_counts()
    loss, got = _grads(tm, params, toks)
    assert sum(fkernel.LAUNCHES.values()) == 0
    assert bool(torch.isfinite(loss))
    qkv = [params["groups"][0]["attn"][k] for k in ("wq", "wk", "wv")]
    for w in qkv:
        assert w.grad is not None and bool(torch.isfinite(w.grad).all())
        assert float(w.grad.abs().max()) > 0
