"""repro_torch's sharded prefill and decode (``LM.prefill`` and
``LM.decode_step`` on DTensor params, batches and caches) against the
reference's GSPMD cells and against the port's one-device path.

The port runs as gloo ranks on the CPU (``tests/_torch_dist.py``): one
spawn of 8 ranks, a (4, 2) (data, model) mesh, and one of 4, a (1, 4)
mesh, shared by the cases. The reference runs in one subprocess under
``--xla_force_host_platform_device_count=8``: it jits
``registry.step_fn`` for prefill with ``in_shardings=(pshard, bshard)``
and for decode with ``out_shardings=(None, bshard["cache"])`` and
``donate_argnums=(1,)``, as its dry-run does, with the launcher's
``act_spec`` (prefill, under ``seq_shard_activations``) and MoE buffer
specs, and writes numpy arrays. Both start from the reference's params
(``convert``).

Configs are fp32-compute smoke variants:

- ``qwen2`` at 2 layers on (4, 2): K/V heads over model, capacity whole;
- ``internlm2`` with ``seq_shard_activations``: ``act_spec`` on prefill;
- ``granite`` (MoE) at 2 layers: ``set_buf_spec`` and the expert
  all-to-all at decode;
- ``deepseek`` (MLA, MoE): the latent ``ckv``/``kpe`` with capacity over
  model;
- ``replicated``: qwen2 with 6 heads on (1, 4), where attention is
  replicated and K/V capacity is split over model;
- ``ring``: gemma3 at 2 windowed layers (window 8) on (1, 4): a ring
  buffer of 8 slots split over 4 ranks, which wraps at position 8.

For each, at B 8, a prompt of S 16 and a cache of capacity 16 (the ring's
8):

1. the prefill's last-token logits within ``FP32_TOL`` of the reference's
   GSPMD prefill and of the port's one-device prefill;
2. 12 decode steps from an empty cache at positions 0-11: every step's
   logits, and every cache leaf after the last, within ``FP32_TOL`` of
   the reference's donated-cache decode and of the port's one-device
   decode;
3. no decode step gathers a ``k``, ``v``, ``ckv`` or ``kpe`` leaf: no
   collective takes one of their shards as its input, and none of that
   leaf's dtype and last dim reaches one rank's share of one layer of it
   times the smallest split of it; the ``pos`` reads' bytes are printed
   and equal the dry-run record's ``pos_read_bytes``;
4. the collectives of one prefill and one decode step, counted by
   ``CommDebugMode`` on the ranks, equal by kind the dry-run's fake-group
   trace of the same cell at the same mesh, batch and sequence;
5. the dry-run's traced rank FLOPs of both cells equal ``RankFlops`` over
   the real rank-0 step, exactly.
"""

import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import time

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
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FP32_TOL = 5e-5                  # test_torch_train.py: what fp32 holds
B, S, STEPS = 8, 16, 12
# name: (arch, overrides of its smoke config, ranks, model axis)
CASES = {
    "qwen2": ("qwen2-0.5b", dict(num_layers=2, d_ff=64), 8, 2),
    "internlm2": ("internlm2-20b", dict(seq_shard_activations=True), 8, 2),
    "granite": ("granite-moe-3b-a800m", dict(num_layers=2), 8, 2),
    "deepseek": ("deepseek-v3-671b", {}, 8, 2),
    "replicated": ("qwen2-0.5b", dict(num_layers=2, d_ff=64, num_heads=6,
                                      num_kv_heads=2, head_dim=16), 4, 4),
    "ring": ("gemma3-27b", dict(num_layers=2, sliding_window=8), 4, 4),
}

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import registry
    from repro.launch.mesh import dp_axes
    from repro.models import moe
    from repro.models.lm import LM
    from repro.sharding import specs as sh

    job = json.loads(sys.argv[1])
    tokens = np.asarray(job["tokens"], np.int32)
    steps = np.asarray(job["steps"], np.int32)
    b, s = tokens.shape
    for name, (arch, over, world, model_size) in job["cases"].items():
        cfg = dataclasses.replace(registry.get_smoke_config(arch),
                                  compute_dtype="float32", **over)
        mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(
            world // model_size, model_size), ("data", "model"))
        model = LM(cfg)
        with open(os.path.join(job["dir"], name + ".pkl"), "rb") as f:
            params = pickle.load(f)
        pspecs = model.param_specs()
        out = {}
        with mesh:
            if cfg.moe and cfg.moe.num_experts % (
                    mesh.shape["data"] * mesh.shape["model"]) == 0:
                moe.set_buf_spec(P(None, ("data", "model"), None, None),
                                 P(dp_axes(mesh), None, None))
            else:
                moe.set_buf_spec(None)
            pshard = sh.param_shardings(cfg, mesh, pspecs)
            p = jax.device_put(jax.tree.map(jnp.asarray, params), pshard)
            shape = registry.SHAPES["prefill_32k"]
            if cfg.seq_shard_activations:
                model.act_spec = P(dp_axes(mesh), "model", None)
            bshard = sh.batch_shardings(
                cfg, mesh, registry.input_specs(cfg, shape, batch=b, seq=s))
            jfn = jax.jit(registry.step_fn(cfg, shape, model),
                          in_shardings=(pshard, bshard))
            out["prefill"] = np.asarray(jfn(p, {"tokens":
                                                jnp.asarray(tokens)}))
            model.act_spec = None
            shape = registry.SHAPES["decode_32k"]
            bshard = sh.batch_shardings(
                cfg, mesh, registry.input_specs(cfg, shape, batch=b, seq=s))
            jfn = jax.jit(registry.step_fn(cfg, shape, model),
                          in_shardings=(pshard, bshard),
                          out_shardings=(None, bshard["cache"]),
                          donate_argnums=(1,))
            cache = jax.device_put(model.init_cache(b, s), bshard["cache"])
            for t, toks in enumerate(steps):
                logits, cache = jfn(p, {"cache": cache,
                                        "tokens": jnp.asarray(toks),
                                        "position": jnp.int32(t)})
                out[f"decode{t}"] = np.asarray(logits)
            for k, leaf in enumerate(jax.tree.leaves(cache)):
                out[f"cache{k}"] = np.asarray(leaf)
            moe.set_buf_spec(None)
        np.savez(os.path.join(job["dir"], name + "_ref.npz"), **out)
    print("REFERENCE_OK")
""")


def _cfg(name):
    arch, over, _, _ = CASES[name]
    return dataclasses.replace(r_registry.get_smoke_config(arch),
                               compute_dtype="float32", **over)


def _tokens():
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


def _steps():
    return np.random.default_rng(1).integers(
        0, 256, (STEPS, B, 1)).astype(np.int32)


def _one_device(name, params):
    """The port's one-device prefill logits, decode logits at every step
    and cache leaves after the last."""
    lm = TLM(port_config(_cfg(name)))
    lm.attn_impl = "reference"
    with torch.no_grad():
        prefill = lm.prefill(params, {"tokens": torch.from_numpy(_tokens())})
        cache = lm.init_cache(B, S, device="cpu")
        logits = []
        for t, toks in enumerate(_steps()):
            lg, cache = lm.decode_step(params, cache, torch.from_numpy(toks),
                                       t)
            logits.append(lg.numpy())
    return {"prefill": prefill.numpy(), "decode": logits,
            "cache": [c.numpy() for c in tree_leaves(cache)]}


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the cases compare, made once: the reference's params of
    each case; the reference's GSPMD prefill and decode (a subprocess, run
    while the gloo ranks run); the port's sharded runs on 8 and on 4
    ranks; the dry-run's traces; and the port's one-device runs."""
    d = tmp_path_factory.mktemp("sharded_decode")
    t0 = time.perf_counter()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    params = {}
    for name in CASES:
        p = jax.tree.map(np.asarray,
                         jax.jit(RLM(_cfg(name)).init)(jax.random.PRNGKey(0)))
        params[name] = p
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(p, f)
    job = dict(dir=str(d), cases=CASES, tokens=_tokens().tolist(),
               steps=_steps().tolist())
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT), env={**os.environ, "PYTHONPATH": "src"})
    try:
        out = {"sharded": {}, "dry": {}, "one": {}}
        for world in (8, 4):
            tasks = [("sharded_infer", (str(d / f"{name}.pkl"),
                                        port_config(_cfg(name)), model,
                                        _tokens(), _steps()), name)
                     for name, (_, _, w, model) in CASES.items()
                     if w == world]
            if world == 8:
                tasks.append(("regroup_cases", ()))
            ranks = _torch_dist.run(world, tasks, timeout=240)
            out["sharded"].update(ranks[0])
            if world == 8:
                out["regroup"] = [r["regroup_cases"] for r in ranks]
        for name in CASES:
            out["dry"][name] = {kind: _dry(name, shape) for kind, shape in
                                (("prefill", "prefill_32k"),
                                 ("decode", "decode_32k"))}
            out["one"][name] = _one_device(
                name, params_from_reference(params[name], device="cpu"))
        stdout, stderr = ref.communicate(timeout=240)
    finally:
        torch.set_num_threads(n)
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert "REFERENCE_OK" in stdout, stderr[-3000:]
    out["ref"] = {name: dict(np.load(d / f"{name}_ref.npz"))
                  for name in CASES}
    print(f"sharded prefill and decode runs: "
          f"{time.perf_counter() - t0:.1f} s")
    return out


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64), b, rtol=0,
                               atol=FP32_TOL, err_msg=what)


# -- 1 and 2. against the reference's GSPMD cells and the one-device path --------

@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_equals_the_reference_and_one_device(runs, name):
    got = runs["sharded"][name]["prefill"]
    assert got.shape == (B, 1, _cfg(name).vocab_size)
    _close(got, runs["ref"][name]["prefill"], f"{name}: reference")
    _close(got, runs["one"][name]["prefill"], f"{name}: one device")


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_decode_equals_the_reference_and_one_device(runs, name):
    got, ref, one = (runs["sharded"][name], runs["ref"][name],
                     runs["one"][name])
    assert len(got["decode"]) == STEPS
    for t, lg in enumerate(got["decode"]):
        _close(lg, ref[f"decode{t}"], f"{name} step {t}: reference")
        _close(lg, one["decode"][t], f"{name} step {t}: one device")
    assert len(got["cache"]) == len(one["cache"]) == sum(
        k.startswith("cache") for k in ref)
    for k, leaf in enumerate(got["cache"]):
        _close(leaf, ref[f"cache{k}"], f"{name} cache leaf {k}: reference")
        _close(leaf, one["cache"][k], f"{name} cache leaf {k}: one device")


def test_the_ring_wraps_on_split_capacity(runs):
    """The ring's 8 slots hold positions 8-11 in slots 0-3 and 4-7 in slots
    4-7 after 12 steps, on every row and layer."""
    pos = [leaf for leaf in runs["sharded"]["ring"]["cache"]
           if leaf.dtype == np.int32]
    assert len(pos) == 2
    want = np.array([8, 9, 10, 11, 4, 5, 6, 7], np.int32)
    for leaf in pos:
        assert leaf.shape == (B, 8) and (leaf == want).all()


def test_regroup_moves_shards_as_distribute_tensor_places_them(runs):
    """``dtensor.regroup`` (the ``pos`` leaf read in K's layout: slots to
    rows over one or two mesh dims, the others gathered first or kept) on
    a (2, 2, 2) mesh of 8 gloo ranks: every rank's shard and placements
    equal ``distribute_tensor``'s of the target layout."""
    assert len(runs["regroup"]) == 8
    for rank, oks in enumerate(runs["regroup"]):
        assert all(oks), (rank, oks)


# -- 3. no gather of a cache leaf -------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_no_decode_step_gathers_a_cache_leaf(runs, name):
    """No collective of a decode step takes a K/V or latent shard as its
    input, and none has such a leaf's dtype and last dim with a result of
    one rank's share of one layer of it times its smallest split (a gather
    of it over one mesh dim). The MoE's expert buffers end in d_model, so
    they are not taken for a leaf."""
    _, _, ops, hits = runs["sharded"][name]["decode_counted"]
    shares = runs["sharded"][name]["shares"]
    assert shares and not hits, (name, hits)
    pos_bytes = sum(n for _, _, n, dt, _ in ops if dt == "torch.int32")
    print(f"{name}: pos read in the K/V layout moves {pos_bytes} bytes a "
          f"step ({runs['dry'][name]['decode']['full']['pos_read_bytes']} "
          f"in the dry-run's record)")
    assert pos_bytes == \
        runs["dry"][name]["decode"]["full"]["pos_read_bytes"]
    for leaf, share, splits, dtype, last in shares:
        assert splits, (name, leaf)
        limit = share * min(splits)
        big = [op for op in ops if op[3] == dtype and op[4][-1] == last
               and op[2] >= limit]
        assert not big, (name, leaf, limit, big)


# -- 4 and 5. the dry-run's traced cells against the ranks -------------------------

@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", list(CASES))
def test_collectives_as_issued_equal_the_dry_run(runs, name, kind):
    counts = runs["sharded"][name][f"{kind}_counted"][0]
    full = runs["dry"][name][kind]["full"]
    assert runs["dry"][name][kind]["status"] == "OK"
    assert full["partition"] == "traced"
    by_kind: dict[str, int] = {}
    for c in full["collectives"]:
        by_kind[c["kind"]] = by_kind.get(c["kind"], 0) + c["count"]
    assert by_kind == counts and counts, (by_kind, counts)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", list(CASES))
def test_dry_run_rank_flops_equal_the_real_rank_step(runs, name, kind):
    flops = runs["sharded"][name][f"{kind}_counted"][1]
    assert flops > 0 and runs["dry"][name][kind]["full"]["flops"] == flops
