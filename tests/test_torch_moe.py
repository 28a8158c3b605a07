"""repro_torch.models.moe against repro.models.moe: ``capacity``,
``padded_experts``, the params' tree, the routing of one row and
``moe_apply`` (output and aux loss) on the granite and deepseek smoke
configs in fp32.

Both packages get the same params (drawn by the reference, crossing
through numpy) and the same seeded inputs. ``moe_apply`` runs at the
config's capacity factor, on inputs skewed towards a few experts so that
copies are dropped (the test checks that they are), and at a capacity with
no drops. Tolerance 1e-5: both sides compute in fp32 but sum in different
orders (XLA:CPU vs ATen). The reference runs under ``jax.jit``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as r_registry  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from _torch_parity import port_config  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["granite-moe-3b-a800m", "deepseek-v3-671b"]


def _cfg(arch: str, capacity_factor: float | None = None):
    cfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                              compute_dtype="float32")
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


_PARAMS: dict = {}


def _params(arch: str):
    """The reference's MoE params of ``arch``'s smoke config (drawn once in
    this process) and the port's copy."""
    if arch not in _PARAMS:
        cfg = _cfg(arch)
        p = jax.tree.map(np.asarray, jax.jit(
            lambda key: r_moe.moe_params(key, cfg))(jax.random.PRNGKey(3)))
        _PARAMS[arch] = (p, params_from_reference(p, device="cpu"))
    return _PARAMS[arch]


def _inputs(cfg, b: int, s: int, seed: int) -> np.ndarray:
    """[b, s, d] inputs sharing one direction, so that the router sends
    most tokens to the same few experts."""
    rng = np.random.default_rng(seed)
    common = rng.standard_normal(cfg.d_model)
    x = 2.0 * common + 0.5 * rng.standard_normal((b, s, cfg.d_model))
    return x.astype(np.float32)


def test_capacity_and_padding_on_full_configs():
    """The published configs: granite's 40 experts pad to 48, deepseek's
    256 stay; capacities at the train and decode lengths equal the
    reference's."""
    for arch in ARCHS:
        cfg = r_registry.get_config(arch)
        tcfg = t_registry.get_config(arch)
        assert t_moe.padded_experts(tcfg) == r_moe.padded_experts(cfg)
        for n in (1, 7, 64, 512, 4096, 32768):
            assert t_moe.capacity(n, tcfg) == r_moe.capacity(n, cfg)
    granite = t_registry.get_config("granite-moe-3b-a800m")
    assert (granite.moe.num_experts, t_moe.padded_experts(granite)) == (40,
                                                                       48)
    assert t_moe.padded_experts(t_registry.get_config(
        "deepseek-v3-671b")) == 256
    assert t_moe.capacity(4096, granite) == 1024
    assert t_moe.capacity(1, granite) == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_params_tree_mirrors_reference(arch):
    """The port's own init draws the reference's tree: the router at the
    true expert count in fp32, the expert stacks at the padded count."""
    cfg = _cfg(arch)
    want = jax.eval_shape(lambda: r_moe.moe_params(jax.random.PRNGKey(0),
                                                   cfg))
    got = t_moe.moe_params(torch.Generator().manual_seed(0),
                           port_config(cfg), "cpu")
    shape = lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
    assert jax.tree.map(shape, want) == jax.tree.map(shape, got)
    assert got["router"].shape[1] == cfg.moe.num_experts


@pytest.mark.parametrize("arch", ARCHS)
def test_route_one_row_matches_reference(arch):
    """Destinations (drops included), weights, counts and probabilities of
    one row equal the reference's."""
    cfg = _cfg(arch)
    p, tp = _params(arch)
    x = _inputs(cfg, 1, 48, 5)[0]
    cap = r_moe.capacity(48, cfg)
    want = jax.jit(lambda xf, r: r_moe._route_one_row(xf, r, cfg, cap))(
        jnp.asarray(x), p["router"])
    got = t_moe._route_one_row(torch.from_numpy(x), tp["router"],
                               port_config(cfg), cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), **TOL)
    assert int((got[0] == cfg.moe.num_experts * cap).sum()) > 0  # drops


@pytest.mark.parametrize("drops", [True, False], ids=["drops", "no-drops"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, drops):
    """``moe_apply``'s output and aux loss equal the reference's at the
    config's capacity factor (copies dropped) and at a factor with room
    for every copy (``num_experts / top_k``: each expert's capacity is the
    row's length)."""
    base = _cfg(arch)
    m = base.moe
    cfg = base if drops else _cfg(arch, m.num_experts / m.top_k)
    p, tp = _params(arch)
    tcfg = port_config(cfg)
    b, s = 2, 40
    x = _inputs(cfg, b, s, 7)
    want, want_aux = jax.jit(lambda p, x: r_moe.moe_apply(cfg, p, x))(
        p, jnp.asarray(x))
    got, got_aux = t_moe.moe_apply(tcfg, tp, torch.from_numpy(x))
    assert got.shape == (b, s, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), **TOL)
    cap = t_moe.capacity(s, tcfg)
    counts = torch.stack([t_moe._route_one_row(r, tp["router"], tcfg,
                                               cap)[2]
                          for r in torch.from_numpy(x)])
    assert bool((counts > cap).any()) == drops
