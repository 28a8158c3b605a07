"""Gradients of repro_torch's ``LM.loss`` against ``jax.grad`` of the
reference's, and the flash kernel's refusal to be differentiated.

On the CPU the port's ``torch.autograd`` grads equal the reference's on
the four dense smoke configs in fp32 (rtol 1e-4, atol 1e-5) for every param
leaf: attention's ``wq``, ``wk`` and ``wv`` included, which a forward
through the flash kernel would cut off. Both get the same params (drawn by
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
from repro.models.lm import LM  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from _torch_parity import port_config  # noqa: E402

ARCHS = ["qwen2-0.5b", "gemma-2b", "internlm2-20b", "gemma3-27b"]


def _grads(tm, tparams, toks):
    leaves = jax.tree.leaves(tparams)
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = tm.loss(tparams, {"tokens": toks})
    loss.backward()
    return loss, [x.grad for x in leaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_grads_match_reference(arch):
    cfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                              compute_dtype="float32")
    rm = LM(cfg)
    params = jax.tree.map(np.asarray, jax.jit(rm.init)(jax.random.PRNGKey(1)))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p, b: rm.loss(p, b)[0]))(params, {"tokens": jnp.asarray(toks)})
    tm = TLM(port_config(cfg))
    tparams = params_from_reference(params, device="cpu")
    loss, got = _grads(tm, tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(want)]
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for path, g, w in zip(paths, got, want):
        assert g is not None, path
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=path)
    # attention's projections are reached, and not by zeros
    attn = [g for path, g in zip(paths, got)
            if any(f"'{n}'" in path for n in ("wq", "wk", "wv"))]
    assert len(attn) == 3 * (1 if cfg.num_layers >= 4 else cfg.num_layers)
    assert all(float(g.abs().max()) > 0 for g in attn)


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
        with pytest.raises(NotImplementedError,
                           match="no backward kernel.*attn_impl='reference'"):
            _grads(tm, params, toks)
        assert fkernel.LAUNCHES["flash_attention_wgmma"] == cfg.num_layers
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
