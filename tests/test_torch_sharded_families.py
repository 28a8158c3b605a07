"""repro_torch's VLM, hybrid, SSM and encoder-decoder families on shards
(the train step, ``prefill`` and ``decode_step`` on DTensor params,
batches and caches) against the reference's GSPMD cells and against the
port's one-device path.

The port runs as gloo ranks on the CPU (``tests/_torch_dist.py``): one
spawn of 8 ranks, a (4, 2) (data, model) mesh, and one of 4, a (1, 4)
mesh, shared by the cases. The reference runs in one subprocess under
``--xla_force_host_platform_device_count=8``: it jits
``make_train_step`` with ``in_shardings``/``out_shardings`` (and
``grad_specs``/``mb_specs`` under accumulation), ``registry.step_fn`` for
prefill with ``in_shardings`` and for decode with ``out_shardings`` and
``donate_argnums``, as its dry-run does, with the launcher's ``act_spec``
(train and prefill, under ``seq_shard_activations``, never for an
encoder-decoder), and writes numpy arrays. Both start from the
reference's params (``convert``).

Configs are fp32-compute smoke variants, at B 8 and S 16:

- ``hymba``: the hybrid smoke with ``sliding_window=8`` and no global
  layer, on (4, 2): Mamba's ``in_proj`` halves cut by one all-to-all,
  ``h``/``conv`` over model, a ring of 8 slots that wraps at position 8;
- ``hymba_replicated``: 6 heads / 2 KV heads of 16 on (1, 4), window 8
  with global layers 0 and 3: attention replicated (K/V capacity over
  model, the window applied by the mask) while Mamba's ``inner`` is
  split;
- ``qwen2vl``: the VLM smoke with ``seq_shard_activations``, 8 patch
  embeddings and caller-given M-RoPE positions, on (4, 2): ``act_spec``
  after the patch concatenation, M-RoPE on sharded positions;
- ``xlstm``: the SSM smoke on (4, 2): the mLSTM's and sLSTM's states over
  the heads, ``up``'s split, the sLSTM's gates cut by one all-to-all;
- ``whisper``: the encoder-decoder smoke on (4, 2): the encoder on shards,
  ``ck``/``cv`` in their layouts, the tied vocab-parallel head.

For each:

1. one train step (accumulation 2, the configs' ``train_accum_override``,
   so the counted step is the dry-run's cell; ``qwen2vl`` at 1): loss and
   ``grad_norm`` within ``FP32_TOL`` relative, every param within it, of
   the reference's GSPMD step and of the port's one-device step;
2. the prefill's last-token logits within ``FP32_TOL`` of the
   reference's and of the one-device prefill, and a prefill with the
   Mamba and mLSTM chunks cut to 4 tokens (a multi-chunk forward) within
   it of the one-device prefill at the same chunks;
3. 12 decode steps from an empty cache: every step's logits and every
   cache leaf after the last within ``FP32_TOL`` of the reference's
   donated-cache decode and of the one-device decode; each cache leaf in
   the reference's ``cache_leaf_sharding`` layout;
4. the collectives of one train, one prefill and one decode step, counted
   by ``CommDebugMode`` on the ranks, equal by kind the dry-run's
   fake-group trace of the same cell;
5. the dry-run's traced rank FLOPs of the three cells equal ``RankFlops``
   over the real rank-0 steps, exactly;
6. no decode step gathers a ``k``, ``v``, ``h``, ``conv``, ``c``, ``n``,
   ``m``, ``ck`` or ``cv`` leaf: no collective takes one of their shards
   as its input.

Where the reference is known wrong (ROADMAP §3) the port is held against
its own one-device path only:

- the mLSTM decode: the reference's drops the output gate, so ``xlstm``'s
  decode logits and cache values are held against the one-device decode
  only; its cache layouts against the reference's;
- the mLSTM's chunked forward: the reference reads the carried memory
  transposed past one chunk, so ``xlstm``'s train step and prefill are
  compared with the reference at S 16, within one chunk, and the
  multi-chunk prefill with the one-device one only;
- whisper's cross K/V: the reference never writes ``ck``/``cv``; both
  sides write them from the encoder's output of the batch's frames before
  decoding;
- the VLM's microbatches: the reference splits a batch's ``positions``
  [3, B, S] on its stream dim under accumulation, so ``qwen2vl`` trains at
  accumulation 1, as the reference can.
"""

import concurrent.futures
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax", reason="parity with the reference needs jax")

import _torch_dist  # noqa: E402
from _torch_parity import port_config  # noqa: E402
from repro.configs import registry as r_registry  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.sharding import specs as t_specs  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import trainstep as t_ts  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP32_TOL = 5e-5                  # test_torch_train.py: what fp32 holds
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=12)
B, S, STEPS, CHUNK = 8, 16, 12, 4
# name: (arch, overrides of its smoke config, ranks, model axis); the train
# step's accumulation is the config's train_accum_override (the dry-run's)
CASES = {
    "hymba": ("hymba-1.5b", dict(sliding_window=8, global_layers=(),
                                 train_accum_override=2), 8, 2),
    "hymba_replicated": ("hymba-1.5b", dict(
        num_heads=6, num_kv_heads=2, head_dim=16, sliding_window=8,
        train_accum_override=2), 4, 4),
    "qwen2vl": ("qwen2-vl-7b", dict(seq_shard_activations=True), 8, 2),
    "xlstm": ("xlstm-125m", dict(train_accum_override=2), 8, 2),
    "whisper": ("whisper-tiny", dict(train_accum_override=2), 8, 2),
}
# held against the one-device decode only (the reference's drops the
# mLSTM's output gate)
ONE_DEVICE_DECODE = ("xlstm",)

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import registry
    from repro.launch.mesh import dp_axes
    from repro.sharding import specs as sh
    from repro.train import optimizer as opt
    from repro.train import trainstep as ts

    job = json.loads(sys.argv[1])
    steps = np.asarray(job["steps"], np.int32)
    for name, (arch, over, world, model_size) in job["cases"].items():
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  compute_dtype="float32", **over)
        accum = cfg.train_accum_override or 1
        mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(
            world // model_size, model_size), ("data", "model"))
        model = registry.make_model(cfg)
        d = job["dir"]
        with open(os.path.join(d, name + ".pkl"), "rb") as f:
            params = pickle.load(f)
        batch = dict(np.load(os.path.join(d, name + "_batch.npz")))
        bspecs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                  for k, v in batch.items()}
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        pspecs = model.param_specs()
        out = {}
        with mesh:
            if cfg.seq_shard_activations and not cfg.enc_dec:
                model.act_spec = P(dp_axes(mesh), "model", None)
            pshard = sh.param_shardings(cfg, mesh, pspecs)
            p0 = jax.device_put(jax.tree.map(jnp.asarray, params), pshard)
            bshard = sh.batch_shardings(cfg, mesh, bspecs)
            ocfg = opt.OptConfig(**job["opt"])
            oshard = sh.opt_shardings(cfg, mesh,
                                      opt.opt_state_specs(ocfg, pspecs))
            mb = jax.tree.map(
                lambda ns: NamedSharding(mesh, P(None, *ns.spec)), bshard)
            step = ts.make_train_step(
                model, ocfg, accum,
                sh.grad_shardings(cfg, mesh, pspecs) if accum > 1 else None,
                mb if accum > 1 else None)
            jfn = jax.jit(step, in_shardings=(pshard, oshard, bshard),
                          out_shardings=(pshard, oshard, None))
            s0 = jax.device_put(opt.init_opt_state(ocfg, p0), oshard)
            p, st, m = jfn(p0, s0, batch)
            out["loss"] = np.asarray(m["loss"])
            out["grad_norm"] = np.asarray(m["grad_norm"])
            for k, leaf in enumerate(jax.tree.leaves(p)):
                out[f"p{k}"] = np.asarray(leaf)
            for key in ("m", "v"):
                for k, leaf in enumerate(jax.tree.leaves(st[key])):
                    out[f"{key}{k}"] = np.asarray(leaf)
            shape = registry.SHAPES["prefill_32k"]
            jfn = jax.jit(registry.step_fn(cfg, shape, model),
                          in_shardings=(pshard, bshard))
            out["prefill"] = np.asarray(jfn(p0, batch))
            model.act_spec = None
            shape = registry.SHAPES["decode_32k"]
            b, s = job["bs"]
            dshard = sh.batch_shardings(
                cfg, mesh, registry.input_specs(cfg, shape, batch=b, seq=s))
            for k, ns in enumerate(jax.tree.leaves(dshard["cache"])):
                out[f"spec{k}"] = np.asarray(json.dumps(list(ns.spec)))
            if name not in job["one_device_decode"]:
                if cfg.enc_dec:
                    cache = model.init_cache(p0, b, s, cfg.enc_frames)
                    enc = model.encode(p0, batch["frames"])
                    f = enc.shape[1]
                    for c, p_l in zip(cache, p0["dec"]):
                        for leaf, w in (("ck", "wk"), ("cv", "wv")):
                            c[leaf] = (enc @ p_l["cross"][w]).reshape(
                                b, f, cfg.num_kv_heads, cfg.head_dim_)
                else:
                    cache = model.init_cache(b, s)
                jfn = jax.jit(registry.step_fn(cfg, shape, model),
                              in_shardings=(pshard, dshard),
                              out_shardings=(None, dshard["cache"]),
                              donate_argnums=(1,))
                cache = jax.device_put(cache, dshard["cache"])
                for t, toks in enumerate(steps):
                    logits, cache = jfn(p0, {"cache": cache,
                                             "tokens": jnp.asarray(toks),
                                             "position": jnp.int32(t)})
                    out[f"decode{t}"] = np.asarray(logits)
                for k, leaf in enumerate(jax.tree.leaves(cache)):
                    out[f"cache{k}"] = np.asarray(leaf)
        np.savez(os.path.join(d, name + "_ref.npz"), **out)
    print("REFERENCE_OK")
""")


def _cfg(name):
    arch, over = CASES[name][:2]
    return dataclasses.replace(r_registry.get_smoke_config(arch),
                               compute_dtype="float32", **over)


def _batch(name):
    """The case's batch (numpy), in ``registry.input_specs``' shapes at B
    x S: tokens, and frames or 8 patch embeddings with caller-given M-RoPE
    positions."""
    cfg = _cfg(name)
    rng = np.random.default_rng(0)
    out = {}
    if cfg.enc_dec:
        out["frames"] = rng.normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        p = min(cfg.vision_patches, S // 2)
        out["patch_embeds"] = rng.normal(
            size=(B, p, cfg.d_model)).astype(np.float32)
        out["positions"] = np.stack([np.broadcast_to(
            np.arange(S) // (i + 1), (B, S)) for i in range(3)]).astype(
                np.int32)
        out["tokens"] = rng.integers(0, 256, (B, S - p)).astype(np.int32)
    else:
        out["tokens"] = rng.integers(0, 256, (B, S)).astype(np.int32)
    return out


def _steps():
    return np.random.default_rng(1).integers(
        0, 256, (STEPS, B, 1)).astype(np.int32)


def _one_device(name, params):
    """The port's one-device train step, prefill (and at ``CHUNK``-token
    chunks), decode logits at every step and cache leaves after the last
    (for ``ONE_DEVICE_DECODE`` also in float64)."""
    cfg = port_config(_cfg(name))
    lm = t_registry.make_model(cfg)
    lm.attn_impl = "reference"
    batch = {k: torch.from_numpy(v) for k, v in _batch(name).items()}
    ocfg = t_opt.OptConfig(**OPT)
    new, st, m = t_ts.make_train_step(lm, ocfg,
                                      cfg.train_accum_override or 1)(
        params, t_opt.init_opt_state(ocfg, params), batch)
    out = {"train": {"params": [t.numpy() for t in tree_leaves(new)],
                     "state": {k: [t.numpy() for t in tree_leaves(st[k])]
                               for k in ("m", "v")},
                     "metrics": {k: float(m[k])
                                 for k in ("loss", "grad_norm", "lr")}}}
    with torch.no_grad():
        out["prefill"] = lm.prefill(params, batch).numpy()
        restore = _torch_dist._set_chunks(CHUNK)
        try:
            out["prefill_chunked"] = lm.prefill(params, batch).numpy()
        finally:
            restore()
        out["decode"], out["cache"] = _one_decode(lm, params, batch)
        if name in ONE_DEVICE_DECODE:
            lm64 = t_registry.make_model(dataclasses.replace(
                cfg, compute_dtype="float64", param_dtype="float64"))
            lm64.attn_impl = "reference"
            out["decode64"], out["cache64"] = _one_decode(
                lm64, t_opt.tree_map(lambda t: t.double(), params),
                {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()})
    return out


def _one_decode(lm, params, batch):
    """Each step's logits and the cache leaves after the last of
    ``STEPS`` one-device decode steps from an empty cache."""
    cfg = lm.cfg
    s = _torch_dist._seq_of(batch)
    if cfg.enc_dec:
        cache = lm.init_cache(None, B, s, cfg.enc_frames, device="cpu")
        lm.write_cross(params, cache, batch["frames"])
    else:
        cache = lm.init_cache(B, s, device="cpu")
    logits = []
    for t, toks in enumerate(_steps()):
        lg, cache = lm.decode_step(params, cache, torch.from_numpy(toks), t)
        logits.append(lg.numpy())
    return logits, [c.numpy() for c in tree_leaves(cache)]


def _dry(name, shape):
    """The dry-run's record of ``shape``'s cell of the case's config on its
    mesh, at B x S (a decode cell's cache of capacity S)."""
    arch, _, world, model = CASES[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_registry, "get_config",
                   lambda a, _c=port_config(_cfg(name)): _c)
        return dryrun.run_cell(
            arch, shape, verbose=False, batch=B, seq=S,
            mesh=dryrun.StandInMesh(("data", "model"),
                                    (world // model, model)))


KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the cases compare, made once: the reference's params and
    batch of each case; the reference's GSPMD cells (a subprocess), the
    port's sharded runs on 8 and on 4 ranks (two spawns), the dry-run's
    traces and the port's one-device runs, all at once."""
    d = tmp_path_factory.mktemp("sharded_families")
    t0 = time.perf_counter()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    params = {}
    for name in CASES:
        cfg = _cfg(name)
        p = jax.tree.map(np.asarray, jax.jit(
            r_registry.make_model(cfg).init)(jax.random.PRNGKey(0)))
        params[name] = p
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(p, f)
        np.savez(d / f"{name}_batch.npz", **_batch(name))
    job = dict(dir=str(d), cases=CASES, opt=OPT, bs=[B, S],
               steps=_steps().tolist(), one_device_decode=ONE_DEVICE_DECODE)
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env={**os.environ, "PYTHONPATH": "src"})
    try:
        out = {"sharded": {}, "dry": {}, "one": {}}
        # both spawns run while this process traces the dry-run's cells and
        # runs the one-device path
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            spawns = [pool.submit(_torch_dist.run, world, [(
                "sharded_family", (
                    str(d / f"{name}.pkl"), port_config(_cfg(name)), model,
                    OPT, _batch(name), _steps(), CHUNK,
                    name in ONE_DEVICE_DECODE), name)
                for name, (_, _, w, model) in CASES.items()
                if w == world], timeout=300) for world in (8, 4)]
            for name in CASES:
                out["dry"][name] = {kind: _dry(name, shape)
                                    for kind, shape in KINDS.items()}
                out["one"][name] = _one_device(
                    name, params_from_reference(params[name], device="cpu"))
            for spawn in spawns:
                out["sharded"].update(spawn.result()[0])
        stdout, stderr = ref.communicate(timeout=300)
    finally:
        torch.set_num_threads(n)
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK" in stdout, stderr[-3000:]
    out["ref"] = {name: dict(np.load(d / f"{name}_ref.npz"))
                  for name in CASES}
    print(f"sharded family runs: {time.perf_counter() - t0:.1f} s")
    return out


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=0,
                               atol=FP32_TOL, err_msg=what)


# -- 1. the train step -------------------------------------------------------

def _direction(m, v):
    """The first AdamW step's direction from a zero state, in float64:
    (m / (1 - b1)) / (sqrt(v / (1 - b2)) + eps)."""
    c = t_opt.OptConfig(**OPT)
    m, v = np.asarray(m, np.float64), np.asarray(v, np.float64)
    return (m / (1 - c.b1)) / (np.sqrt(v / (1 - c.b2)) + c.eps)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_equals_the_reference_and_one_device(runs, name):
    """Loss and grad norm within ``FP32_TOL`` relative; the moments within
    ``FP32_TOL``; every param within ``FP32_TOL`` plus the update
    difference the two steps' moments imply (``lr`` times the gap of
    their directions), which is 0 but where a clipped gradient is at the
    scale of Adam's eps: there the update's slope ``lr eps / (|g| +
    eps)^2`` turns an fp32 rounding of the gradient into a param
    difference past ``FP32_TOL`` (xlstm's grad norm of ~128 scales its
    smallest gradients to ~2e-8; its one-device step and the reference's
    differ by 8.6e-5 at one element of 16384, with no sharding
    involved), as ``test_torch_sharded.py``'s int8 rule allows an
    element the moved moments feed."""
    got, ref = runs["sharded"][name]["train"], runs["ref"][name]
    one = runs["one"][name]["train"]
    for what in ("loss", "grad_norm"):
        for want, who in ((float(ref[what]), "reference"),
                          (one["metrics"][what], "one device")):
            assert abs(got["metrics"][what] / want - 1) <= FP32_TOL, \
                (name, what, who, got["metrics"][what], want)
    lr = one["metrics"]["lr"]
    n = len(got["params"])
    assert n == len(one["params"]) == sum(
        k[0] == "p" and k[1:].isdigit() for k in ref)
    for who, params, state in (
            ("reference", [ref[f"p{k}"] for k in range(n)],
             {key: [ref[f"{key}{k}"] for k in range(n)]
              for key in ("m", "v")}),
            ("one device", one["params"], one["state"])):
        for k in range(n):
            for key in ("m", "v"):
                _close(got["state"][key][k], state[key][k],
                       f"{name} {key} {k}: {who}")
            slack = lr * np.abs(
                _direction(got["state"]["m"][k], got["state"]["v"][k])
                - _direction(state["m"][k], state["v"][k]))
            over = np.abs(got["params"][k].astype(np.float64)
                          - params[k]) > FP32_TOL + slack
            assert not over.any(), (name, who, k,
                                    np.argwhere(over)[:5].tolist())


# -- 2. prefill ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_equals_the_reference_and_one_device(runs, name):
    got, one = runs["sharded"][name], runs["one"][name]
    assert got["prefill"].shape == (B, 1, _cfg(name).vocab_size)
    _close(got["prefill"], runs["ref"][name]["prefill"],
           f"{name}: reference")
    _close(got["prefill"], one["prefill"], f"{name}: one device")
    _close(got["prefill_chunked"], one["prefill_chunked"],
           f"{name}: {CHUNK}-token chunks, one device")


# -- 3. decode -----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_equals_the_reference_and_one_device(runs, name):
    """Every step's logits and every cache leaf after the last, and the
    leaves' layouts. ``xlstm``'s decode is held against the one-device
    decode only (the reference's drops the output gate), and in float64:
    in fp32 this decode sits at its conditioning floor (its one-device
    fp32 decode is ~6e-5 from the float64 one at step 1, and splitting
    the batch over ranks alone, which changes the products' rounding,
    moves it by as much), so its fp32 decode is held to be no farther
    from the float64 decode than the one-device fp32 decode is."""
    got, ref, one = (runs["sharded"][name], runs["ref"][name],
                     runs["one"][name])
    assert len(got["decode"]) == STEPS
    held = name not in ONE_DEVICE_DECODE
    suffix = "" if held else "64"
    for t, lg in enumerate(got["decode" + suffix]):
        _close(lg, one["decode" + suffix][t],
               f"{name} step {t}: one device")
        if held:
            _close(lg, ref[f"decode{t}"], f"{name} step {t}: reference")
    if not held:
        gap = [np.abs(a.astype(np.float64) - b).max()
               for pair in (got["decode"], one["decode"])
               for a, b in [(np.stack(pair), np.stack(one["decode64"]))]]
        print(f"{name}: fp32 decode to float64: sharded {gap[0]:.3g}, "
              f"one device {gap[1]:.3g}")
        assert gap[0] <= gap[1], gap
    specs = [json.loads(str(ref[f"spec{k}"])) for k in range(sum(
        k.startswith("spec") for k in ref))]
    assert len(got["cache"]) == len(one["cache"]) == len(specs)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    for k, leaf in enumerate(got["cache" + suffix]):
        _close(leaf, one["cache" + suffix][k],
               f"{name} cache leaf {k}: one device")
        if held:
            _close(leaf, ref[f"cache{k}"], f"{name} cache leaf {k}: ref")
        spec = tuple(tuple(e) if isinstance(e, list) else e
                     for e in specs[k])
        want = tuple(str(p) for p in t_specs.placements(mesh, spec))
        assert got["cache_placements"][k] == want, (name, k, spec)


def test_the_hymba_ring_wraps(runs):
    """hymba's all-windowed group is a ring of 8 slots: after 12 steps its
    ``pos`` leaf holds positions 8-11 in slots 0-3 and 4-7 in slots 4-7,
    on every layer and row."""
    pos = [leaf for leaf in runs["sharded"]["hymba"]["cache"]
           if leaf.dtype == np.int32]
    assert len(pos) == 1 and pos[0].shape[-1] == 8
    assert (pos[0] == np.array([8, 9, 10, 11, 4, 5, 6, 7])).all()


# -- 4 and 5. the dry-run's traced cells against the ranks ----------------------

@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(CASES))
def test_collectives_as_issued_equal_the_dry_run(runs, name, kind):
    counts = runs["sharded"][name][f"{kind}_counted"][0]
    rec = runs["dry"][name][kind]
    assert rec["status"] == "OK" and rec["full"]["partition"] == "traced"
    by_kind: dict[str, int] = {}
    for c in rec["full"]["collectives"]:
        by_kind[c["kind"]] = by_kind.get(c["kind"], 0) + c["count"]
    assert by_kind == counts and counts, (by_kind, counts)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", list(CASES))
def test_dry_run_rank_flops_equal_the_real_rank_step(runs, name, kind):
    flops = runs["sharded"][name][f"{kind}_counted"][1]
    assert flops > 0 and runs["dry"][name][kind]["full"]["flops"] == flops


# -- 6. no gather of a decode state leaf ---------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_no_decode_step_gathers_a_state_leaf(runs, name):
    """No collective of a decode step takes a shard of a K/V, Mamba,
    mLSTM, sLSTM or cross K/V leaf as its input."""
    counts, _, _, hits = runs["sharded"][name]["decode_counted"]
    assert counts and not hits, (name, hits)
