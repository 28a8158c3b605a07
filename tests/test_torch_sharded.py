"""repro_torch's sharded compute against the reference's GSPMD step and
against its own one-device step (``models/*`` and ``train/*`` on DTensors,
``sharding/specs.py``'s layouts, ``launch/dryrun.py``'s traced cells).

The port runs as gloo ranks on the CPU (``tests/_torch_dist.py``): one
spawn of 8 ranks and one of 4, shared by the cases. The reference runs in
one subprocess under ``--xla_force_host_platform_device_count=8``, as
``tests/test_zero_and_sharding.py`` runs its multi-device cases: it jits
``make_train_step(model, ocfg, accum, grad_specs, mb_specs)`` with
``in_shardings``/``out_shardings`` as its dry-run does, on
``make_debug_mesh(8, model)``, with the launcher's ``act_spec`` and MoE
buffer specs, and writes numpy arrays. Both start from the reference's
params (``convert``).

Configs are fp32-compute smoke variants: qwen2 at 2 layers (heads divide
the model axis, 2), internlm2 with ``seq_shard_activations`` (``act_spec``
live, 4 stacked layers under remat), granite-moe at 2 layers (8 experts
over (4, 2): ``set_buf_spec`` live, the expert all-to-all), deepseek-v3
(MLA on each rank's heads, its MoE layers' all-to-all, the MTP head), and
qwen2 with 6 heads on a (2, 4) mesh, where the heads do not divide the
model axis and attention is replicated. On each:

1. two steps at accumulation 2 with ``grad_specs`` and ``mb_specs``: each
   step's gradients (as the moments imply them) and every moment within
   ``FP32_TOL`` of the reference's GSPMD step, loss and ``grad_norm``
   within it relative, every param within it plus the update difference
   the two packages' moments imply (``_update_slack``: Adam's direction
   amplifies a near-zero gradient's rounding);
2. the same steps within ``FP32_TOL`` of the port's one-device step;
3. (qwen2) int8 moments on shards against the one-device step, ``q``
   within one step, a param element fed by a moved int8 entry within the
   update difference the two states imply (``test_torch_optimizer.py``'s
   F5 rule), under the same budget; a layout that splits a quantization
   block updates as one device does (the blocks are gathered whole);
4. the collectives of one step, counted by ``CommDebugMode`` on the ranks,
   equal by kind to the dry-run's fake-group trace of the same cell; a
   layer body issues only model-axis collectives (an MoE layer: and its
   all-to-all pair over data, forward and backward, in every MoE layer,
   and in a stacked group's recompute under remat), and no forward or
   backward all-gathers a tensor-parallel weight;
5. the dry-run's traced rank FLOPs equal ``RankFlops`` over that real
   step on rank 0, exactly;
6. the port's ``Trainer``: two steps on a (2, 2) mesh with a checkpoint,
   a restore onto (4, 1) and two more steps, within ``FP32_TOL`` of the
   one-device trainer's four.
"""

import dataclasses
import itertools
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")

import _torch_dist  # noqa: E402
from _torch_parity import port_config  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.train import loop as t_loop  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainstep as t_ts  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP32_TOL = 5e-5                  # test_torch_train.py: what fp32 holds
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=12)
WORLD, ACCUM, STEPS, B, S = 8, 2, 2, 8, 16
# name: (arch, overrides of its smoke config, model axis of the 8 ranks)
CASES = {
    "qwen2": ("qwen2-0.5b", dict(num_layers=2, d_ff=64), 2),
    "internlm2": ("internlm2-20b", dict(seq_shard_activations=True), 2),
    "granite": ("granite-moe-3b-a800m", dict(num_layers=2), 2),
    "deepseek": ("deepseek-v3-671b", {}, 2),
    "replicated": ("qwen2-0.5b", dict(num_layers=2, d_ff=64, num_heads=6,
                                      num_kv_heads=2, head_dim=16), 4),
}
Q8 = "qwen2"                     # the int8-moment case

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import registry
    from repro.launch.mesh import dp_axes, make_debug_mesh
    from repro.models import moe
    from repro.models.lm import LM
    from repro.sharding import specs as sh
    from repro.train import optimizer as opt
    from repro.train import trainstep as ts

    job = json.loads(sys.argv[1])
    for name, (arch, over, model_size) in job["cases"].items():
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  compute_dtype="float32", **over)
        mesh = make_debug_mesh(8, model_size)
        model = LM(cfg)
        with open(os.path.join(job["dir"], name + ".pkl"), "rb") as f:
            params = pickle.load(f)
        pspecs = model.param_specs()
        bspecs = {"tokens": jax.ShapeDtypeStruct(tuple(job["bs"]),
                                                 jnp.int32)}
        with mesh:
            if cfg.seq_shard_activations:
                model.act_spec = P(dp_axes(mesh), "model", None)
            if cfg.moe and cfg.moe.num_experts % (
                    mesh.shape["data"] * mesh.shape["model"]) == 0:
                moe.set_buf_spec(P(None, ("data", "model"), None, None),
                                 P(dp_axes(mesh), None, None))
            else:
                moe.set_buf_spec(None)
            pshard = sh.param_shardings(cfg, mesh, pspecs)
            bshard = sh.batch_shardings(cfg, mesh, bspecs)
            ocfg = opt.OptConfig(**job["opt"])
            oshard = sh.opt_shardings(cfg, mesh,
                                      opt.opt_state_specs(ocfg, pspecs))
            mb = jax.tree.map(
                lambda ns: NamedSharding(mesh, P(None, *ns.spec)), bshard)
            step = ts.make_train_step(model, ocfg, job["accum"],
                                      sh.grad_shardings(cfg, mesh, pspecs),
                                      mb)
            jfn = jax.jit(step, in_shardings=(pshard, oshard, bshard),
                          out_shardings=(pshard, oshard, None))
            p = jax.device_put(jax.tree.map(jnp.asarray, params), pshard)
            s = jax.device_put(opt.init_opt_state(ocfg, p), oshard)
            out = {}
            for i, toks in enumerate(job["tokens"]):
                p, s, m = jfn(p, s, {"tokens": jnp.asarray(toks, jnp.int32)})
                out[f"loss{i}"] = np.asarray(m["loss"])
                out[f"grad_norm{i}"] = np.asarray(m["grad_norm"])
                for key in ("m", "v"):
                    for k, leaf in enumerate(jax.tree.leaves(s[key])):
                        out[f"{key}{k}_{i}"] = np.asarray(leaf)
            moe.set_buf_spec(None)
        for k, leaf in enumerate(jax.tree.leaves(p)):
            out[f"p{k}"] = np.asarray(leaf)
        for key in ("m", "v"):
            for k, leaf in enumerate(jax.tree.leaves(s[key])):
                out[f"{key}{k}"] = np.asarray(leaf)
        np.savez(os.path.join(job["dir"], name + "_ref.npz"), **out)
    print("REFERENCE_OK")
""")


def _cfg(name):
    arch, over, _ = CASES[name]
    return dataclasses.replace(r_registry.get_smoke_config(arch),
                               compute_dtype="float32", **over)


def _tokens(step):
    rng = np.random.default_rng(step)
    return rng.integers(0, 256, (B, S)).astype(np.int32)


def _one_device(name, params, q8=False):
    """The port's one-device steps (``STEPS``, accumulation ``ACCUM``) from
    ``params``: per step its params, state and metrics, and the params,
    state and gradients it started from."""
    lm = TLM(port_config(_cfg(name)))
    lm.attn_impl = "reference"
    ocfg = t_opt.OptConfig(**OPT, quantized_moments=q8)
    state = t_opt.init_opt_state(ocfg, params)
    out = []
    for i in range(STEPS):
        batch = {"tokens": torch.from_numpy(_tokens(i))}
        grads, m = t_ts.accumulated_grads(lm, params, batch, ACCUM)
        params_in, state_in = params, state
        params, state, om = t_opt.adamw_update(ocfg, params, grads, state)
        out.append(dict(params=params, state=state, metrics={**m, **om},
                        grads=grads, params_in=params_in, state_in=state_in))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the cases compare, made once: the reference's params of
    each case; the reference's GSPMD steps (a subprocess, run while the
    gloo ranks run); the port's sharded steps, int8 steps and counted
    steps on 8 ranks, its trainer on 4; the dry-run's traces; and the
    port's one-device runs."""
    d = tmp_path_factory.mktemp("sharded")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    params = {}
    for name in CASES:
        p = jax.tree.map(np.asarray,
                         jax.jit(RLM(_cfg(name)).init)(jax.random.PRNGKey(0)))
        params[name] = p
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(p, f)
    job = dict(dir=str(d), cases=CASES, opt=OPT, accum=ACCUM, bs=[B, S],
               tokens=[_tokens(i).tolist() for i in range(STEPS)])
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env={**os.environ, "PYTHONPATH": "src"})
    try:
        toks = [_tokens(i) for i in range(STEPS)]
        tasks = []
        for name, (_, _, model) in CASES.items():
            kw = port_config(_cfg(name))
            tasks.append(("sharded_train", (str(d / f"{name}.pkl"), kw, model,
                                            OPT, ACCUM, toks), name))
            tasks.append(("sharded_counts", (kw, model, _tokens(7)),
                          f"counts {name}"))
        q8 = dict(OPT, quantized_moments=True)
        tasks.append(("sharded_update", (
            str(d / f"{Q8}.pkl"), port_config(_cfg(Q8)),
            CASES[Q8][2], q8, ACCUM, toks), "q8"))
        tasks.append(("split_block_update", ()))
        eight = _torch_dist.run(WORLD, tasks, timeout=240)[0]
        tiny = port_config(_cfg("qwen2"))
        four = _torch_dist.run(4, [("sharded_trainer", (
            str(d / "ckpt"), tiny, OPT, ACCUM, 2))], timeout=240)[0]
        out = {"sharded": {n: eight[n] for n in CASES},
               "counts": {n: eight[f"counts {n}"] for n in CASES},
               "sharded_q8": eight["q8"],
               "split_block": eight["split_block_update"],
               "trainer": four["sharded_trainer"], "dry": {}, "one": {}}
        for name, (arch, _, model) in CASES.items():
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(t_registry, "get_config",
                           lambda a, _c=port_config(_cfg(name)): _c)
                out["dry"][name] = dryrun.run_cell(
                    arch, "train_4k", verbose=False, batch=B, seq=S,
                    mesh=dryrun.StandInMesh(("data", "model"),
                                            (WORLD // model, model)))
            out["one"][name] = _one_device(
                name, params_from_reference(params[name], device="cpu"))
        out["one_q8"] = _one_device(
            Q8, params_from_reference(params[Q8], device="cpu"), q8=True)
        lm = TLM(port_config(_cfg("qwen2")))
        lm.attn_impl = "reference"
        trainer = t_loop.Trainer(
            lm, t_opt.OptConfig(**OPT),
            t_loop.LoopConfig(total_steps=4, ckpt_every=4, log_every=10 ** 6),
            str(d / "one"), _torch_dist.trainer_batch, accum=ACCUM,
            device="cpu")
        out["one_trainer"] = trainer.run()[1]
        stdout, stderr = ref.communicate(timeout=240)
    finally:
        torch.set_num_threads(n)
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK" in stdout, stderr[-3000:]
    out["ref"] = {name: dict(np.load(d / f"{name}_ref.npz"))
                  for name in CASES}
    return out


def _leaves(tree):
    return [t.detach().numpy() for t in t_opt.tree_leaves(tree)]


def _fill(like, leaves):
    """``like``'s structure with ``leaves`` (numpy, in ``tree_leaves``'
    order) as tensors."""
    if isinstance(like, dict):
        return {k: _fill(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, leaves) for v in like)
    return torch.from_numpy(next(leaves))


# -- 1. against the reference's GSPMD step ----------------------------------------

def _update_slack(ref, got):
    """Per param leaf (float64, ``tree_leaves``' order): the |difference|
    of the updates that the reference's and the port's moments imply at
    each step (``adamw_update``'s direction ``m_hat / (sqrt(v_hat) +
    eps)`` in float64, times that step's lr), summed over the steps. Where
    a gradient is near zero (|g| ~ 1e-9, below ``eps``), Adam's direction
    turns a gradient difference far inside ``FP32_TOL`` into an update
    difference of up to a full lr step; weight decay only shrinks a param
    difference, so the params differ by at most this sum plus fp32
    rounding."""
    ocfg = t_opt.OptConfig(**OPT)
    slack = None
    for i, rec in enumerate(got):
        b1c, b2c = 1.0 - ocfg.b1 ** (i + 1), 1.0 - ocfg.b2 ** (i + 1)

        def direction(m, v):
            m, v = np.float64(m), np.float64(v)
            return (m / b1c) / (np.sqrt(v / b2c) + ocfg.eps)
        gaps = [rec["metrics"]["lr"] * np.abs(
            direction(ref[f"m{k}_{i}"], ref[f"v{k}_{i}"])
            - direction(m, v))
            for k, (m, v) in enumerate(zip(rec["state"]["m"],
                                           rec["state"]["v"]))]
        slack = gaps if slack is None else [a + b for a, b in
                                            zip(slack, gaps)]
    return slack


def _implied_grads(m, prev, b1):
    """The clipped gradient of a step that its first moments imply,
    ``(m - b1 prev) / (1 - b1)``, float64, per leaf."""
    return [(np.float64(a) - b1 * np.float64(p)) / (1 - b1)
            for a, p in zip(m, prev)]


def _rms_grads(v, b2c):
    """Adam's denominator before ``eps``, ``sqrt(v / (1 - b2^t))``: the
    root mean square of each element's clipped gradients so far, float64,
    per leaf. It sits at the gradients' own scale, where ``v`` itself sits
    at their square's (1e-8 for a gradient of 1e-4)."""
    return [np.sqrt(np.float64(a) / b2c) for a in v]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_the_reference_gspmd_step(runs, name):
    """Each step's clipped gradients (as the first moments imply them) and
    their root mean square (as the second moments imply it,
    ``_rms_grads``), the final moments, the loss and ``grad_norm`` within
    ``FP32_TOL`` of the reference's; each final param within ``FP32_TOL``
    plus the update difference the two packages' moments imply
    (``_update_slack``): where a gradient is near zero Adam turns a
    difference far inside the tolerance into one near a full lr step
    (internlm2's ``param 11``: a gradient of 1e-9 against 2.6e-9 at step 0
    moved one element 6.0e-5). The slack is built from moments held at the
    gradients' scale at every step: a root mean square moves by no more
    than the largest gradient difference it averages, so gradients within
    ``FP32_TOL`` give ``_rms_grads`` within it, and a wrong second-moment
    update on shards fails there (``v`` itself, ~1e-8, is no check at
    that tolerance)."""
    ref, got = runs["ref"][name], runs["sharded"][name]
    ocfg = t_opt.OptConfig(**OPT)
    b1 = ocfg.b1
    nleaf = len(got[-1]["params"])
    ref_m = [[ref[f"m{k}_{i}"] for k in range(nleaf)] for i in range(len(got))]
    got_m = [rec["state"]["m"] for rec in got]
    zero = [0.0] * nleaf
    for i in range(len(got)):
        want = _implied_grads(ref_m[i], ref_m[i - 1] if i else zero, b1)
        have = _implied_grads(got_m[i], got_m[i - 1] if i else zero, b1)
        for k, (a, b) in enumerate(zip(have, want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=FP32_TOL,
                                       err_msg=f"{name} step {i} grad {k}")
        b2c = 1.0 - ocfg.b2 ** (i + 1)
        want = _rms_grads([ref[f"v{k}_{i}"] for k in range(nleaf)], b2c)
        have = _rms_grads(got[i]["state"]["v"], b2c)
        for k, (a, b) in enumerate(zip(have, want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=FP32_TOL,
                                       err_msg=f"{name} step {i} rms {k}")
    slack = _update_slack(ref, got)
    for k, leaf in enumerate(got[-1]["params"]):
        over = (np.abs(np.float64(leaf) - ref[f"p{k}"])
                > FP32_TOL + slack[k])
        assert not over.any(), (f"{name} param {k}",
                                np.argwhere(over)[:5].tolist())
    for key in ("m", "v"):
        for k, leaf in enumerate(got[-1]["state"][key]):
            np.testing.assert_allclose(leaf, ref[f"{key}{k}"], rtol=0,
                                       atol=FP32_TOL,
                                       err_msg=f"{name} {key} {k}")
    for i, rec in enumerate(got):
        for what in ("loss", "grad_norm"):
            want = float(ref[f"{what}{i}"])
            assert abs(rec["metrics"][what] / want - 1) <= FP32_TOL, \
                (name, i, what, rec["metrics"][what], want)


# -- 2. against the port's one-device step ----------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_equals_the_one_device_step(runs, name):
    for i, (got, one) in enumerate(zip(runs["sharded"][name],
                                       runs["one"][name])):
        for k, (a, b) in enumerate(zip(got["params"],
                                       _leaves(one["params"]))):
            np.testing.assert_allclose(a, b, rtol=0, atol=FP32_TOL,
                                       err_msg=f"{name} step {i} param {k}")
        for key in ("m", "v"):
            for a, b in zip(got["state"][key], _leaves(one["state"][key])):
                np.testing.assert_allclose(a, b, rtol=0, atol=FP32_TOL)
        for what in ("loss", "grad_norm", "lr"):
            want = float(one["metrics"][what])
            assert abs(got["metrics"][what] / want - 1) <= FP32_TOL, \
                (name, i, what)


# -- 3. int8 moments on shards ---------------------------------------------------

def _moved_slack(ocfg, params, grads, st_a, st_b, lr, clip):
    """Per param leaf (float64, ``tree_leaves``' order): where an int8
    entry of ``m`` or ``v`` differs between the states ``st_a`` and
    ``st_b`` as a step starts, the |difference| of that step's update the
    two imply with the same gradient (``adamw_update``'s arithmetic in
    float64); 0 where both agree. ``test_torch_optimizer.py``'s
    ``_moment_slack`` with two port states."""
    step = float(int(st_a["step"]) + 1)
    b1c, b2c = 1.0 - ocfg.b1 ** step, 1.0 - ocfg.b2 ** step

    def one(p, g, ma, va, mb, vb):
        shape = tuple(p.shape)

        def deq(qs):
            return t_opt.dequantize_q8(qs, shape).double()

        def moved(a, b):
            flag = {"q": (a["q"] != b["q"]).to(torch.int8),
                    "scale": torch.ones_like(a["scale"])}
            return t_opt.dequantize_q8(flag, shape) != 0

        gs = g.double() * clip

        def update(m, v):
            m = ocfg.b1 * deq(m) + (1 - ocfg.b1) * gs
            v = ocfg.b2 * deq(v) + (1 - ocfg.b2) * gs ** 2
            return (m / b1c) / (torch.sqrt(v / b2c) + ocfg.eps)
        gap = lr * (update(ma, va) - update(mb, vb)).abs()
        return torch.where(moved(ma, mb) | moved(va, vb), gap, 0.0)
    return [x.numpy() for x in t_opt.tree_leaves(t_opt.tree_map(
        one, params, grads, st_a["m"], st_a["v"], st_b["m"], st_b["v"]))]


def test_int8_moments_on_shards_hold_the_one_device_step(runs):
    """The update on shards with int8 moments, fed the one-device step's
    gradients (as ``test_torch_optimizer.py`` feeds both packages the same
    ones: with int8 moments an element whose ``v`` rounds to 0 moves by
    ``m / eps``, so a gradient that differs in its last bits would move it
    by anything): ``q`` within one step and ``scale`` within ``FP32_TOL``
    relative of the one-device state; a param element within ``FP32_TOL``
    unless an int8 entry that feeds it moved, then within the update
    difference the two states imply (summed over the steps); moved entries
    under 1e-3 of the state, the budget of ``test_torch_optimizer.py``."""
    ocfg = t_opt.OptConfig(**OPT, quantized_moments=True)
    got, one = runs["sharded_q8"], runs["one_q8"]
    slack, moved, n = None, 0, 0
    state_in = one[0]["state_in"]                 # both start from zeros
    for i, (g, o) in enumerate(zip(got, one)):
        gn = float(o["metrics"]["grad_norm"])
        clip = min(1.0, ocfg.grad_clip / (gn + 1e-9))
        gap = _moved_slack(ocfg, o["params_in"], o["grads"], o["state_in"],
                           state_in, float(o["metrics"]["lr"]), clip)
        slack = gap if slack is None else [a + b for a, b in zip(slack, gap)]
        state_in = {"step": o["state"]["step"],
                    **{k: _fill(o["state"][k], iter(g["state"][k]))
                       for k in ("m", "v")}}
        for k, (a, b, sl) in enumerate(zip(g["params"],
                                           _leaves(o["params"]), slack)):
            over = np.abs(a.astype(np.float64) - b) > FP32_TOL + sl
            assert not over.any(), (i, k, np.argwhere(over)[:5].tolist())
            moved += int((sl > 0).sum())
        for key in ("m", "v"):
            for a, b in zip(g["state"][key], _leaves(o["state"][key])):
                if a.dtype == np.int8:
                    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
                    assert diff.max(initial=0) <= 1, (i, key)
                    moved += int((diff > 0).sum())
                    n += a.size
                else:
                    np.testing.assert_allclose(a, b, rtol=FP32_TOL)
    assert moved <= 1e-3 * n, (moved, n)


def test_an_int8_layout_that_splits_a_block_raises(runs):
    """An int8 moment whose quantization blocks (``q``'s last dim) are
    split across ranks (ZeRO's data axis lands there in some of
    deepseek-v3's leaves) no longer raises: ``adamw_update`` gathers the
    blocks whole first (``optimizer.whole_blocks``), so each block is
    quantized with its own absmax over the whole block. On 8 gloo ranks,
    ``q`` [8, 2, 256] split over data on its block dim: the new params,
    ``q`` and ``scale`` equal the one-device update's, and the moments
    keep their layouts."""
    got = runs["split_block"]
    p, grads, state = _torch_dist.split_block_inputs()
    new_p, new_s, _ = t_opt.adamw_update(
        t_opt.OptConfig(quantized_moments=True), p, grads, state)
    np.testing.assert_allclose(got["w"], new_p["w"].numpy(), rtol=0,
                               atol=1e-7)
    for k in ("m", "v"):
        np.testing.assert_array_equal(got[f"{k}.q"],
                                      new_s[k]["w"]["q"].numpy())
        np.testing.assert_allclose(got[f"{k}.scale"],
                                   new_s[k]["w"]["scale"].numpy(),
                                   rtol=1e-7, atol=0)
        assert got[f"{k}.q.placements"] == \
            "(Shard(dim=2), Replicate())", got[f"{k}.q.placements"]
        assert got[f"{k}.scale.placements"] == \
            "(Replicate(), Replicate())", got[f"{k}.scale.placements"]


# -- 4 and 5. the dry-run's traced cells against the ranks -------------------------

def _tp_weight_gathers(name) -> set[tuple]:
    """(bytes, trailing dims) of each tensor-parallel weight (a layer's
    slice of a stacked leaf) whole on the model axis, as a gather of its
    shard over the model axis would give them: the collective gathers
    along its input's first dim, so its result ends in the shard's other
    dims (in any order of the shard's dims)."""
    from repro_torch.sharding import specs
    cfg = port_config(_cfg(name))
    lm = TLM(cfg)
    mesh = dryrun.StandInMesh(("data", "model"),
                              (WORLD // CASES[name][2], CASES[name][2]))
    sizes = dict(zip(mesh.axis_names, mesh.sizes))
    out = set()

    def f(path, leaf):
        shape = tuple(leaf.shape)
        spec = specs.param_spec_for(cfg, mesh, path, shape)
        if any(e == "model" or (isinstance(e, tuple) and "model" in e)
               for e in spec):
            stacked = path[0] == "groups" and lm.groups[path[1]].scanned
            if stacked:
                shape, spec = shape[1:], spec[1:]
            n = int(np.prod(shape)) * leaf.element_size()
            # the shard whole on model, split as its spec says elsewhere
            shard = [d // (sizes["data"] if e == "data" or (
                isinstance(e, tuple) and "data" in e) else 1)
                for d, e in zip(shape, spec)]
            model = [i for i, e in enumerate(spec) if e == "model" or (
                isinstance(e, tuple) and "model" in e)][0]
            shard[model] //= sizes["model"]
            k = sizes["data"] if any(e == "data" or (
                isinstance(e, tuple) and "data" in e) for e in spec) else 1
            # any order of its dims (a transposed use, as the tied head)
            for perm in itertools.permutations(shard):
                out.add((n // k, perm[1:]))
    specs.map_with_path(f, lm.param_specs())
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_as_issued_equal_the_dry_run(runs, name):
    accum, counts, _, layer_ops, loss_ops = runs["counts"][name]
    rec = runs["dry"][name]
    full = rec["full"]
    assert rec["status"] == "OK" and full["partition"] == "traced"
    assert rec["accum_steps"] == accum
    by_kind: dict[str, int] = {}
    for c in full["collectives"]:
        by_kind[c["kind"]] = by_kind.get(c["kind"], 0) + c["count"]
        assert c["mesh_dims"] in (["data"], ["model"]), c
    assert by_kind == counts, (by_kind, counts)
    # a layer body's collectives are the model axis's; an MoE layer's
    # expert all-to-all pair (and its backward pair) is over data
    groups = TLM(port_config(_cfg(name))).groups
    moe = groups[0].kind == "moe"            # layer 0's kind
    for kind, dim, _, _ in layer_ops:
        assert dim == "model" or (moe and kind == "all-to-all"
                                  and dim == "data"), (kind, dim)
    n_a2a = sum(kind == "all-to-all" for kind, _, _, _ in layer_ops)
    assert n_a2a == (4 if moe else 0), n_a2a
    # the pair, in every MoE layer (deepseek's MTP layer is dense), and
    # once more in the backward's recompute of a stacked group under remat
    remat = _cfg(name).remat != "none"
    want = sum(g.size * (6 if g.scanned and remat else 4) for g in groups
               if g.kind == "moe")
    assert sum(kind == "all-to-all" for kind, _, _, _ in loss_ops) == want
    # no forward or backward gathers a tensor-parallel weight: no model-axis
    # all-gather has a weight's whole-on-model bytes and its shard's dims
    weights = _tp_weight_gathers(name)
    gathered = {(n, tuple(shape[1:])) for kind, dim, n, shape in loss_ops
                if kind == "all-gather" and dim == "model"}
    assert not gathered & weights, sorted(gathered & weights)


@pytest.mark.parametrize("name", list(CASES))
def test_dry_run_rank_flops_equal_the_real_rank_step(runs, name):
    _, _, flops, _, _ = runs["counts"][name]
    assert flops > 0 and runs["dry"][name]["full"]["flops"] == flops


# -- 6. the trainer on a mesh ------------------------------------------------------

def test_trainer_on_a_mesh_restores_elastically(runs):
    step, leaves = runs["trainer"]
    assert step == 4
    want = _leaves(runs["one_trainer"])
    assert len(leaves) == len(want)
    for k, (a, b) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(a, b, rtol=0, atol=FP32_TOL,
                                   err_msg=f"param {k}")
