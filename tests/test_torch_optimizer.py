"""repro_torch's optimizer (``train/optimizer.py``) and the train step's
layout rules (``train/trainstep.py``) against the reference's.

Block quantization is held equal element for element in both layouts (the
last-dim aligned one and the flat blocks): the same fp32 division and
round-half-to-even. The schedule is held over every step of both
schedules (1e-6 relative: the cosine rounds differently in XLA and ATen),
and ``adamw_update`` over 3 steps from the same params, grads
and state (fp32 params; bf16 params with an fp32 master; int8 moments;
clipping on and off) within 1e-6 relative for fp32 values (1e-5 where the
grads are bf16: the reference's fp32 norm of bf16 grads is 2.1e-6 off the
float64 norm, the port's 7e-8, and each is held against that norm); bf16
params and int8 moments within one step where an fp32 rounding moved a
half-way quotient, counted; a param element whose ``m`` or ``v`` entry so
moved within the update difference the two packages' states imply for
that step (``_moment_slack``, summed over the steps), counted too. ``opt_config_for`` and ``accum_steps_for`` are held
for every config and every ``SHAPES`` row, exactly. The reference's
``test_quantized_adam_moments_roundtrip`` runs on the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import bits, port_config  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train import trainstep as r_ts  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainstep as t_ts  # noqa: E402

REL = 1e-6                      # fp32 values, relative to the tree's scale


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops run on one thread: beside the other test workers,
    torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return params_from_reference(np.asarray(a), device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- quantization ---------------------------------------------------------------

SHAPES_Q = [(1000,), (3, 512), (2, 4, 256), (7, 300), (), (5, 0, 256)]


@pytest.mark.parametrize("shape", SHAPES_Q, ids=str)
def test_quantize_q8_equals_the_reference(shape):
    x = (np.random.default_rng(3).standard_normal(shape) * 1e-3
         ).astype(np.float32)
    if x.size:
        x.reshape(-1)[:7] = 0.0                 # a zero run: scale 1.0
    r = r_opt.quantize_q8(jnp.asarray(x), 256)
    t = t_opt.quantize_q8(_t(x), 256)
    assert set(t) == {"q", "scale"}
    assert t["q"].dtype == torch.int8 and t["scale"].dtype == torch.float32
    np.testing.assert_array_equal(bits(t["q"]), np.asarray(r["q"]))
    np.testing.assert_array_equal(bits(t["scale"]), np.asarray(r["scale"]))
    back = t_opt.dequantize_q8(t, shape)
    np.testing.assert_array_equal(
        bits(back), np.asarray(r_opt.dequantize_q8(r, shape)))
    assert tuple(back.shape) == shape


def test_quantized_adam_moments_roundtrip():
    """The reference's case (tests/test_fault_tolerance.py), on the port."""
    x = _t(np.random.default_rng(1).normal(size=(1000,)).astype(np.float32))
    q = t_opt.quantize_q8(x, 256)
    back = t_opt.dequantize_q8(q, x.shape)
    err = (back - x).abs()
    # blockwise absmax: error bounded by scale/2 per block
    assert float(err.max()) < float(x.abs().max()) / 127.0


# -- schedule -------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "constant"])
def test_lr_schedule_equals_the_reference(schedule):
    cfg = dict(lr=3e-3, warmup_steps=7, total_steps=40, schedule=schedule)
    rc, tc = r_opt.OptConfig(**cfg), t_opt.OptConfig(**cfg)
    for step in range(0, 46):
        want = float(r_opt._lr_at(rc, jnp.int32(step)))
        got = t_opt._lr_at(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        # cos rounds differently in XLA and ATen: 2 fp32 ulps seen
        assert abs(float(got) - want) <= REL * abs(want), (step, want)


# -- state and update -----------------------------------------------------------

def _params(dtype):
    rng = np.random.default_rng(0)
    tree = {"embed": rng.normal(size=(64, 256)) * 0.02,
            "groups": [{"w": rng.normal(size=(4, 256, 512)) * 0.05,
                        "b": np.zeros((7,))},
                       [{"norm": rng.normal(size=(300,))}]],
            "final_norm": np.ones((256,))}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), tree)


def _grads(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32) * scale, p.dtype)),
        params)


# (param dtype, config overrides, fp32 tolerance). With bf16 grads the
# reference's fp32 norm (XLA's reduction of the converted squares) lands
# 2.1e-6 from the float64 norm, the port's 7e-8: the clip scale then moves
# m and v by up to 5e-6 relative, so those cases hold fp32 values at 1e-5
# and each package's norm against the float64 one
CASES = {
    "fp32": (jnp.float32, {}, REL),
    "fp32_noclip": (jnp.float32, dict(grad_clip=0.0), REL),
    "bf16_master": (jnp.bfloat16, {}, 1e-5),
    "fp32_q8": (jnp.float32, dict(quantized_moments=True), REL),
    "bf16_q8_nomaster": (jnp.bfloat16, dict(quantized_moments=True,
                                            master_fp32=False,
                                            grad_clip=0.0), 1e-5),
}


def _close(got, want, what, rel=REL, slack=None):
    """fp32: |got - want| <= rel * (the leaf's largest |want|). bf16: the
    same bound plus one bf16 step of the value (the fp32 master rounds to
    bf16 either side of a tie); ints: equal but for one step. ``slack``
    (float64, the leaf's shape) widens the bound of each element by the
    update difference its moved int8 moments imply (``_moment_slack``).
    Returns the count of bf16 and int elements that differ, and of
    elements held with slack."""
    want = np.asarray(want)
    got = bits(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    extra = 0.0 if slack is None else slack
    loose = 0 if slack is None else int((slack > 0).sum())
    if want.dtype.name == "bfloat16":
        got = torch.from_numpy(got).view(torch.bfloat16).float().numpy()
        want = np.asarray(want, np.float32)
        s = max(np.abs(want).max(initial=0), 1e-30)
        np.testing.assert_array_less(
            np.abs(got - want),
            rel * s + 2.0 ** -7 * np.abs(want) + 1e-30 + extra,
            err_msg=what)
        return int((got != want).sum()) + loose
    if want.dtype == np.float32:
        s = max(np.abs(want).max(initial=0), 1e-30)
        if slack is None or not loose:
            np.testing.assert_allclose(got, want, rtol=0, atol=rel * s,
                                       err_msg=what)
        else:
            over = np.abs(got.astype(np.float64) - want) > rel * s + slack
            assert not over.any(), (what, np.argwhere(over)[:5].tolist())
        return loose
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max(initial=0) <= 1, what
    return int((diff > 0).sum())


def _moment_slack(cfg, params, grads, ref_state, state, lr, clip):
    """For each param leaf (JAX's order), float64: where an int8 entry of
    ``m`` or ``v`` differs between the reference's state and the port's
    as this step starts, the |difference| of this step's update that the
    two states imply with the same gradient (``adamw_update``'s
    arithmetic in float64); 0 wherever both moments agree. XLA contracts
    and rounds the moment arithmetic differently on different CPUs, so a
    quotient on a rounding edge may quantize one step apart; the param
    that step feeds moves by this much and no more."""
    ref = opt_state_from_reference(_np(ref_state), device="cpu")
    step = float(int(state["step"]) + 1)
    b1c, b2c = 1.0 - cfg.b1 ** step, 1.0 - cfg.b2 ** step

    def one(p, g, mr, vr, mt, vt):
        shape = tuple(p.shape)

        def deq(qs):
            return t_opt.dequantize_q8(qs, shape).double()

        def moved(a, b):
            flag = {"q": (a["q"] != b["q"]).to(torch.int8),
                    "scale": torch.ones_like(a["scale"])}
            return t_opt.dequantize_q8(flag, shape) != 0

        gs = g.double() * clip

        def update(m, v):
            m = cfg.b1 * deq(m) + (1 - cfg.b1) * gs
            v = cfg.b2 * deq(v) + (1 - cfg.b2) * gs ** 2
            return (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        gap = lr * (update(mr, vr) - update(mt, vt)).abs()
        return torch.where(moved(mr, mt) | moved(vr, vt), gap, 0.0)
    return [x.numpy() for x in t_opt.tree_leaves(t_opt.tree_map(
        one, params, grads, ref["m"], ref["v"], state["m"], state["v"]))]


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_three_steps_equal_the_reference(case):
    dtype, over, rel = CASES[case]
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, **over)
    rc, tc = r_opt.OptConfig(**cfg), t_opt.OptConfig(**cfg)
    rp = _params(dtype)
    tp = params_from_reference(rp, device="cpu")
    rs = r_opt.init_opt_state(rc, jax.tree.map(jnp.asarray, rp))
    ts = t_opt.init_opt_state(tc, tp)
    rp = jax.tree.map(jnp.asarray, rp)
    moved = 0
    slack = None                # per param leaf, summed over the steps
    for step in range(3):
        # step 1 clips (norm >> 1), the others do not
        g = _grads(rp, 10 + step, 5.0 if step == 1 else 1e-3)
        rs_in, ts_in = rs, ts
        rp, rs, rm = r_opt.adamw_update(rc, rp, jax.tree.map(jnp.asarray, g),
                                        rs)
        tg = params_from_reference(g, device="cpu")
        tp, ts, tm = t_opt.adamw_update(tc, tp, tg, ts_in)
        exact = np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                            for x in jax.tree.leaves(g)))
        assert abs(float(tm["grad_norm"]) / exact - 1) <= REL, case
        assert abs(float(rm["grad_norm"]) / exact - 1) <= rel, case
        _close(tm["lr"], rm["lr"], "lr")
        if tc.quantized_moments:
            clip = min(1.0, tc.grad_clip / (exact + 1e-9)) \
                if tc.grad_clip > 0 else 1.0
            gap = _moment_slack(tc, tp, tg, rs_in, ts_in, float(rm["lr"]),
                                clip)
            slack = gap if slack is None else [
                a + b for a, b in zip(slack, gap)]
        for i, ((path, want), got) in enumerate(zip(
                jax.tree_util.tree_flatten_with_path(_np(rp))[0],
                t_opt.tree_leaves(tp))):
            moved += _close(got, want, f"{case} step {step} params{path}",
                            rel, None if slack is None else slack[i])
        flat_r = jax.tree_util.tree_flatten_with_path(_np(rs))[0]
        flat_t = t_opt.tree_leaves(ts)
        assert len(flat_r) == len(flat_t)
        for (path, want), got in zip(flat_r, flat_t):
            assert tuple(got.shape) == want.shape, path
            moved += _close(got, want, f"{case} step {step} state{path}",
                            rel)
    # fp32 rounding differs from XLA's (fused multiply-adds, reduction
    # order), so a quantized moment or a bf16 param on a rounding edge may
    # land one step over, and a param that such a moment feeds moves by
    # what the step implies; never more, and rarely
    n = sum(np.asarray(x).size for x in jax.tree.leaves(_np(rs)))
    assert moved <= 1e-3 * n, (case, moved, n)


def test_init_opt_state_tree():
    for case, (dtype, over, _) in CASES.items():
        rc = r_opt.OptConfig(**over)
        tc = t_opt.OptConfig(**over)
        rp = _params(dtype)
        rs = _np(r_opt.init_opt_state(rc, jax.tree.map(jnp.asarray, rp)))
        ts = t_opt.init_opt_state(tc, params_from_reference(rp,
                                                            device="cpu"))
        assert set(ts) == set(rs), case
        assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
        assert jax.tree.structure(rs) == jax.tree.structure(
            jax.tree.map(lambda t: 0, ts)), case
        for want, got in zip(jax.tree.leaves(rs), t_opt.tree_leaves(ts)):
            np.testing.assert_array_equal(bits(got), np.asarray(want))
            assert str(got.dtype).split(".")[-1] == want.dtype.name, case
        # the meta-device specs: the same shapes and dtypes, no storage
        specs = t_opt.opt_state_specs(tc, params_from_reference(
            rp, device="cpu"))
        for got, want in zip(t_opt.tree_leaves(specs),
                             t_opt.tree_leaves(ts)):
            assert got.is_meta and got.shape == want.shape \
                and got.dtype == want.dtype


def test_reference_state_crosses_to_the_port():
    rc = r_opt.OptConfig(quantized_moments=True, master_fp32=True)
    rp = jax.tree.map(jnp.asarray, _params(jnp.bfloat16))
    rs = r_opt.init_opt_state(rc, rp)
    rp, rs, _ = r_opt.adamw_update(
        rc, rp, jax.tree.map(jnp.asarray, _grads(rp, 1, 1e-2)), rs)
    ts = opt_state_from_reference(_np(rs), device="cpu")
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    assert int(ts["step"]) == 1
    for want, got in zip(jax.tree.leaves(_np(rs)), t_opt.tree_leaves(ts)):
        np.testing.assert_array_equal(bits(got), np.asarray(want))
    with pytest.raises(ValueError):
        opt_state_from_reference({"m": {}, "v": {}}, device="cpu")


# -- layout rules ---------------------------------------------------------------

@pytest.mark.parametrize("arch", r_registry.ARCH_IDS)
def test_opt_config_and_accum_steps_equal_the_reference(arch):
    rcfg = r_registry.get_config(arch)
    tcfg = port_config(rcfg)
    kw = dict(lr=1e-3, total_steps=7)
    assert dataclasses.asdict(t_ts.opt_config_for(tcfg, **kw)) == \
        dataclasses.asdict(r_ts.opt_config_for(rcfg, **kw))
    for shape in r_registry.SHAPES.values():
        for dp in (1, 16, 32):
            for mp in (1, 16):
                args = (shape.global_batch, shape.seq_len, dp, mp)
                assert t_ts.accum_steps_for(tcfg, *args) == \
                    r_ts.accum_steps_for(rcfg, *args), (shape.name, dp, mp)
    over = dataclasses.replace(tcfg, train_accum_override=3)
    assert t_ts.accum_steps_for(over, 256, 4096, 1) == 3


def test_grad_and_microbatch_specs_raise():
    """``make_train_step`` takes ``grad_specs`` and ``mb_specs`` (they used
    to raise): on a (2, 2) mesh of a fake process group, the accumulated
    gradients of a fake sharded step carry ``grad_specs``' placements,
    the ZeRO layout. (The name is the case's from before.)"""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry as t_registry
    from repro_torch.models.lm import LM as TLM
    from repro_torch.roofline import counter
    from repro_torch.sharding import dtensor, specs
    cfg = dataclasses.replace(t_registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=2, d_ff=64)
    lm = TLM(cfg)
    lm.attn_impl = "reference"
    step = t_ts.make_train_step(lm, t_opt.OptConfig(), 2, grad_specs={},
                                mb_specs={})
    assert callable(step)
    dtensor.init_fake_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        pspecs = lm.param_specs()
        batch = {"tokens": torch.empty((4, 8), dtype=torch.int32,
                                       device="meta")}
        gsh = specs.grad_shardings(cfg, mesh, pspecs)
        bsh = specs.batch_shardings(cfg, mesh, batch)
        got = counter.trace_sharded(
            lambda p, b: t_ts.accumulated_grads(
                lm, p, b, 2, gsh, specs.mb_shardings(bsh))[0],
            (pspecs, batch), (specs.param_shardings(cfg, mesh, pspecs), bsh))
        placed = []
        specs.map_pairs(lambda g, m, pl: placed.append(
            (tuple(g.placements), tuple(pl))), got.out, gsh)
        assert placed and all(a == b for a, b in placed), placed
        assert any(any(p.is_shard() for p in b) for _, b in placed)
    finally:
        dist.destroy_process_group()
