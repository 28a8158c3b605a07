"""repro_torch's train step, rematerialisation, trainer and optimizer-state
checkpoints (``train/trainstep.py``, ``models/lm.py``'s remat,
``train/loop.py``, ``convert.opt_state_from_reference``) against the
reference's.

The model is the reference's crash-restart config
(``tests/test_fault_tolerance.py``: the qwen2 smoke config cut to 2
layers, d_ff 64) with the reference's params on both sides. In fp32
compute, 3 train steps at accumulation 1 and 2 hold the reference's loss,
``grad_norm``, ``lr`` and params within 5e-5 (the reference's crash-restart
bound is 2e-4; the largest gap seen is 1.8e-5, on elements whose gradient
is within Adam's eps of zero). In the config's bf16 compute the two
packages round their products apart: loss and norm stay within 2e-3 and
1 %, and after the first step a param element is more than 2e-4 away
only where the two packages' gradients have opposite signs or one of them
lies within 100 x Adam's eps of zero, where the first step g / (|g| +
eps) stops being +-lr (the check names each such element; 247 of 66112
at accumulation 1, 2 of them the near-zero kind, 283 at 2); over 3 steps
under 1 % of the elements.

Remat ``"full"``, ``"dots"`` and ``"names"`` give grads equal bit for bit
to ``"none"``'s, and within the grads file's bound of ``jax.grad``'s, on a
4-layer stacked group (qwen2 at S = 520: two attention query chunks;
hymba at S = 300: two Mamba chunks). The reference's crash-restart case runs on the port's
``Trainer``; a reference run checkpointed at step 4 is continued to step 8
by the port's trainer, through the checkpoint and through
``opt_state_from_reference``, within 2e-4 of the reference's own 8-step
run (fp32 compute); an int8 optimizer state crosses the packages'
checkpoints bit for bit both ways.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import bits, port_config  # noqa: E402
from repro.checkpoint import ckpt as r_ckpt  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro.models.lm import LM as RLM  # noqa: E402
from repro.train import loop as r_loop  # noqa: E402
from repro.train import optimizer as r_opt  # noqa: E402
from repro.train import trainstep as r_ts  # noqa: E402
from repro_torch.checkpoint import ckpt as t_ckpt  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models.lm import LM as TLM  # noqa: E402
from repro_torch.train import loop as t_loop  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainstep as t_ts  # noqa: E402

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=12)
CRASH_TOL = 2e-4                 # tests/test_fault_tolerance.py:90-92
FP32_TOL = 5e-5                  # what holds in fp32 compute (1.8e-5 seen)


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU ops run on one thread: beside the other test workers,
    torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(compute_dtype="bfloat16"):
    cfg = r_registry.get_smoke_config("qwen2-0.5b")
    return dataclasses.replace(cfg, num_layers=2, d_ff=64,
                               compute_dtype=compute_dtype)


def _tokens(cfg, step, bs=4, s=16):
    rng = np.random.default_rng(step)
    return rng.integers(0, cfg.vocab_size, (bs, s)).astype(np.int32)


def _to_port(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree),
                                 device="cpu")


def _diffs(ref_tree, port_tree) -> list[np.ndarray]:
    """|reference - port| per param leaf, in fp32, in the trees' order."""
    return [np.abs(np.asarray(a, np.float32)
                   - np.asarray(bits(b), np.float32))
            for a, b in zip(jax.tree.leaves(ref_tree),
                            t_opt.tree_leaves(port_tree))]


def _steps(cfg, accum, n=3):
    """n train steps of each package from the reference's params; yields
    (reference params, metrics, port params, metrics) after each."""
    model = RLM(cfg)
    rp = jax.jit(model.init)(jax.random.PRNGKey(0))
    tp = _to_port(rp)
    rcfg, tcfg = r_opt.OptConfig(**OPT), t_opt.OptConfig(**OPT)
    rstep = jax.jit(r_ts.make_train_step(model, rcfg, accum_steps=accum))
    tstep = t_ts.make_train_step(TLM(port_config(cfg)), tcfg,
                                 accum_steps=accum)
    rs, ts = r_opt.init_opt_state(rcfg, rp), t_opt.init_opt_state(tcfg, tp)
    for step in range(n):
        toks = _tokens(cfg, step)
        rp, rs, rm = rstep(rp, rs, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        yield rp, rm, tp, tm


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_fp32_equals_the_reference(accum):
    for rp, rm, tp, tm in _steps(_tiny("float32"), accum):
        for k in ("loss", "ce", "grad_norm", "lr"):
            want = float(rm[k])
            assert abs(float(tm[k]) - want) <= 1e-5 * max(abs(want), 1), k
        assert max(d.max() for d in _diffs(rp, tp)) <= FP32_TOL


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_bf16_moves_only_near_zero_gradients(accum):
    cfg = _tiny()
    # the first step's gradients of both packages, at the same params
    model = RLM(cfg)
    rp0 = jax.jit(model.init)(jax.random.PRNGKey(0))
    mbs = _tokens(cfg, 0).reshape(accum, -1, 16)
    tm_ = TLM(port_config(cfg))
    rg = tg = None
    grad = jax.jit(jax.grad(lambda p, t: model.loss(p, {"tokens": t})[0]))
    for mb in mbs:
        g = grad(rp0, jnp.asarray(mb))
        g_t, _ = t_ts.accumulated_grads(tm_, _to_port(rp0),
                                        {"tokens": torch.from_numpy(mb)})
        rg = g if rg is None else jax.tree.map(jnp.add, rg, g)
        tg = g_t if tg is None else t_opt.tree_map(torch.add, tg, g_t)
    # opposite signs, or one side within 100 eps of zero, where Adam's
    # first step g / (|g| + eps) stops being +-lr
    eps = 100 * r_opt.OptConfig().eps
    flipped = []
    for a, b in zip(jax.tree.leaves(rg), t_opt.tree_leaves(tg)):
        a, b = np.asarray(a, np.float32), bits(b).astype(np.float32)
        flipped.append((np.sign(a) != np.sign(b))
                       | (np.minimum(np.abs(a), np.abs(b)) < eps))
    n = sum(f.size for f in flipped)
    for step, (rp, rm, tp, tm) in enumerate(_steps(cfg, accum)):
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= 2e-3
        assert abs(float(tm["grad_norm"]) / float(rm["grad_norm"]) - 1) \
            <= 1e-2
        assert abs(float(tm["lr"]) - float(rm["lr"])) <= 1e-6 * float(
            rm["lr"])
        far = [d > CRASH_TOL for d in _diffs(rp, tp)]
        moved = sum(int(f.sum()) for f in far)
        if step == 0:
            # every element beyond the bound had a near-zero gradient
            for f, s in zip(far, flipped):
                assert not (f & ~s).any()
            assert 0 < moved <= sum(int(s.sum()) for s in flipped)
        assert moved <= 0.01 * n, (step, moved, n)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b"])
def test_remat_keeps_grads_bit_for_bit(arch, monkeypatch):
    cfg = dataclasses.replace(r_registry.get_smoke_config(arch),
                              num_layers=4, compute_dtype="float32")
    model = RLM(cfg)
    rp = jax.jit(model.init)(jax.random.PRNGKey(1))
    # two query chunks of qwen2's attention, two Mamba chunks of hymba's
    seq = 520 if arch == "qwen2-0.5b" else 300
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, seq)).astype(np.int32)
    want = jax.tree.leaves(jax.jit(jax.grad(
        lambda p: model.loss(p, {"tokens": jnp.asarray(toks)})[0]))(rp))
    grads = {}
    calls = []
    layer_fwd = blocks.layer_fwd
    monkeypatch.setattr(blocks, "layer_fwd",
                        lambda *a: calls.append(1) or layer_fwd(*a))
    for remat in ("none", "full", "dots", "names"):
        tm = TLM(port_config(dataclasses.replace(cfg, remat=remat)))
        tm.attn_impl = "reference"
        assert tm.groups[0].scanned
        calls.clear()
        g, _ = t_ts.accumulated_grads(tm, _to_port(rp),
                                      {"tokens": torch.from_numpy(toks)})
        grads[remat] = t_opt.tree_leaves(g)
        # the backward recomputes each layer's forward, but for "none"
        assert len(calls) == (4 if remat == "none" else 8), remat
    for remat, g in grads.items():
        assert all(torch.equal(a, b) for a, b in zip(g, grads["none"])), \
            remat
    for a, b in zip(want, grads["full"]):
        np.testing.assert_allclose(bits(b), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


def _batch_fn(cfg, bs=4, s=16):
    def f(step):
        return {"tokens": _tokens(cfg, step, bs, s)}
    return f


def test_crash_restart_resumes_identically(tmp_path):
    """The reference's case (tests/test_fault_tolerance.py) on the port's
    trainer: a crash mid-run restarts from the checkpoint and converges to
    the same state as an uninterrupted run."""
    cfg = port_config(_tiny())
    model = TLM(cfg)
    ocfg = t_opt.OptConfig(**OPT)

    def trainer(d, fail=-1):
        return t_loop.Trainer(
            model, ocfg, t_loop.LoopConfig(total_steps=12, ckpt_every=4,
                                           log_every=100, fail_at_step=fail),
            str(d), _batch_fn(cfg), device="cpu")

    _, p_ref, _, _ = trainer(tmp_path / "a").run()
    with pytest.raises(t_loop.SimulatedFailure):
        trainer(tmp_path / "b", fail=6).run()
    assert t_ckpt.CheckpointManager(tmp_path / "b").latest_step() == 4
    step, p_res, _, _ = trainer(tmp_path / "b").run()
    assert step == 12
    for a, b in zip(t_opt.tree_leaves(p_ref), t_opt.tree_leaves(p_res)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=CRASH_TOL, atol=CRASH_TOL)


def test_port_trainer_continues_a_reference_run(tmp_path, capsys):
    """A reference run checkpointed at step 4, continued to step 8 by the
    port's trainer, lands within the crash-restart bound of the
    reference's own 8-step run: through the checkpoint directory, and
    through ``opt_state_from_reference`` on the in-memory state."""
    cfg = _tiny("float32")
    model = RLM(cfg)
    ocfg = r_opt.OptConfig(**OPT)

    def ref_trainer(d, total):
        return r_loop.Trainer(model, ocfg, r_loop.LoopConfig(
            total_steps=total, ckpt_every=4, log_every=4), str(d),
            lambda s: {"tokens": jnp.asarray(_tokens(cfg, s))})

    _, p8, _, m8 = ref_trainer(tmp_path / "ref", 8).run()
    _, p4, s4, _ = ref_trainer(tmp_path / "cont", 4).run()
    port = TLM(port_config(cfg))
    tcfg = t_opt.OptConfig(**OPT)

    def port_trainer(d):
        return t_loop.Trainer(port, tcfg, t_loop.LoopConfig(
            total_steps=8, ckpt_every=4, log_every=4), str(d),
            _batch_fn(cfg), device="cpu")

    runs = {"checkpoint": port_trainer(tmp_path / "cont").run(),
            "convert": port_trainer(tmp_path / "mem").run(
                start=(4, _to_port(p4),
                       opt_state_from_reference(jax.tree.map(np.asarray,
                                                             s4),
                                                device="cpu")))}
    for how, (step, tp, ts, tm) in runs.items():
        assert step == 8 and int(ts["step"]) == 8, how
        assert max(d.max() for d in _diffs(p8, tp)) <= CRASH_TOL, how
        assert abs(float(tm["loss"]) - float(m8["loss"])) <= 1e-5, how
    # the log line is the reference's, step for step
    out = capsys.readouterr().out.splitlines()
    steps = [ln.split()[:2] for ln in out if ln.startswith("step")]
    assert steps == [["step", "4"], ["step", "8"], ["step", "4"],
                     ["step", "8"], ["step", "8"]], out


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_int8_opt_state_crosses_checkpoints(tmp_path, direction):
    cfg = _tiny()
    rp = jax.jit(RLM(cfg).init)(jax.random.PRNGKey(3))
    ocfg = dict(quantized_moments=True, master_fp32=False, **OPT)
    rcfg = r_opt.OptConfig(**ocfg)
    rs = r_opt.init_opt_state(rcfg, rp)
    rp, rs, _ = jax.jit(r_opt.adamw_update, static_argnums=0)(
        rcfg, rp, jax.tree.map(lambda p: jnp.full(p.shape, 1e-3, p.dtype),
                               rp), rs)
    ref = {"params": rp, "opt": rs}
    port = {"params": _to_port(rp),
            "opt": opt_state_from_reference(jax.tree.map(np.asarray, rs),
                                            device="cpu")}
    assert port["opt"]["m"]["embed"]["q"].dtype == torch.int8
    src, dst = (r_ckpt, t_ckpt) if direction == "reference_to_port" \
        else (t_ckpt, r_ckpt)
    src.CheckpointManager(tmp_path).save(
        1, ref if src is r_ckpt else port)
    like = port if dst is t_ckpt else ref
    step, out = dst.CheckpointManager(tmp_path).restore(like=like)
    assert step == 1
    got = t_opt.tree_leaves(out) if dst is t_ckpt else jax.tree.leaves(out)
    assert len(got) == len(jax.tree.leaves(ref))
    for a, b in zip(jax.tree.leaves(ref), got):
        np.testing.assert_array_equal(bits(b), bits(a))
        assert bits(b).dtype == bits(a).dtype
        assert bits(b).shape == bits(a).shape      # the 0-d step too


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-tiny",
                                  "qwen2-vl-7b"])
def test_launcher_trains_each_batch_kind(tmp_path, arch, capsys):
    """``python -m repro_torch.launch.train --smoke`` on the CPU: the
    token, encoder-decoder (frames) and vision-stub (patch embeddings)
    batch functions of the reference's launcher."""
    from repro_torch.launch import train
    step, metrics = train.main(["--arch", arch, "--smoke", "--steps", "2",
                                "--batch", "2", "--seq", "16", "--ckpt",
                                str(tmp_path), "--device", "cpu"])
    assert step == 2 and np.isfinite(float(metrics["loss"]))
    assert "finished at step 2: loss=" in capsys.readouterr().out


def test_what_the_port_cannot_honour_raises(tmp_path, capsys, monkeypatch):
    from repro_torch.configs import registry as t_registry
    from repro_torch.launch import train
    # --dry-run traces the production cell on fake tensors (no card) and
    # prints its record: status, memory, the roofline on the H100 table;
    # traced here at the smoke width (tests/test_torch_dryrun.py holds
    # the dry-run itself)
    monkeypatch.setattr(t_registry, "get_config",
                        t_registry.get_smoke_config)
    rec = train.main(["--arch", "qwen2-0.5b", "--dry-run"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[qwen2-0.5b x train_4k x single] trace ")
    assert out[1].startswith("OK {'argument_size_in_bytes': ")
    assert out[2].startswith("roofline: {'flops': ")
    assert rec["status"] == "OK" and rec["shape"] == "train_4k" \
        and rec["mesh"] == "single" and rec["chips"] == 256
    rl = rec["roofline"]
    assert rl["t_compute"] == rl["flops"] / 989e12 > 0
    assert rl["t_memory"] == rl["bytes_hbm"] / 3.35e12 > 0
    model = TLM(port_config(_tiny()))
    ocfg, loop = t_opt.OptConfig(), t_loop.LoopConfig()

    # a (2, 1) mesh and a shardings triple are accepted (they used to
    # raise): the trainer runs sharded on the mesh, here one of a fake
    # process group of 2 ranks
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import dtensor, specs
    dtensor.init_fake_group(2)
    try:
        mesh = init_device_mesh("cpu", (2, 1),
                                mesh_dim_names=("data", "model"))
        t = t_loop.Trainer(model, ocfg, loop, str(tmp_path), None, mesh=mesh)
        assert t.mesh is mesh and t.device.type == "cpu"
        pspecs = model.param_specs()
        triple = (specs.param_shardings(model.cfg, mesh, pspecs),
                  specs.opt_shardings(model.cfg, mesh,
                                      t_opt.opt_state_specs(ocfg, pspecs)),
                  {"tokens": (mesh, specs.placements(mesh, ("data", None)))})
        t = t_loop.Trainer(model, ocfg, loop, str(tmp_path), None,
                           shardings=triple)
        assert t.mesh is mesh and t.shardings is triple
    finally:
        dist.destroy_process_group()

    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}       # a one-device stand-in

    t_loop.Trainer(model, ocfg, loop, str(tmp_path), None, mesh=Mesh(),
                   device="cpu")
    if not torch.cuda.is_available():
        # the entry points default to the card
        with pytest.raises(RuntimeError, match="cuda"):
            t_loop.Trainer(model, ocfg, loop, str(tmp_path), None)
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(["--arch", "qwen2-0.5b", "--smoke", "--ckpt",
                        str(tmp_path)])
