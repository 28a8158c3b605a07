"""Multi-process cases of the port's collectives, run as gloo ranks on the
CPU: ``run(world, tasks)`` spawns ``world`` processes (the ``spawn``
start method), each joining one process group over a TCP store on
localhost, runs the named tasks of this module in every rank and returns
each rank's results. The module imports only torch and the port, so a
rank starts without JAX. Every wait has a timeout: a hung collective fails
the test instead of stalling the suite."""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, tasks, out):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=world)
        try:
            res = {}
            for task in tasks:          # (name, args[, key])
                name, args = task[0], task[1]
                res[task[2] if len(task) > 2 else name] = \
                    globals()[name](rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, res, None))
    except Exception:                       # reported to the parent
        out.put((rank, None, traceback.format_exc()))


def run(world: int, tasks: list[tuple], timeout: float = 120):
    """[rank -> {key: result}] of ``tasks`` [(function name, args[, key])]
    run in order in each of ``world`` gloo ranks; a task's key is its
    function name unless it gives one."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, tasks, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):              # drain before joining
            rank, res, err = out.get(timeout=timeout)
            if err:
                errors.append(f"rank {rank}:\n{err}")
            results[rank] = res
    except queue.Empty:
        errors.append(f"timed out after {timeout} s with "
                      f"{sorted(results)} of {world} ranks done")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        raise AssertionError("\n".join(errors))
    return [results[r] for r in range(world)]


# -- tasks (each called as task(rank, world, *args) in every rank) -----------

def allgather(rank, world, weights):
    """sharding.zero.weighted_allgather: each rank holds only its own
    pages of a 32 x 16 table."""
    from repro_torch.sharding import zero
    pages, width = 32, 16
    owner = zero.weighted_page_partition(pages, np.asarray(weights))
    full = torch.arange(pages * width, dtype=torch.float32).reshape(pages,
                                                                    width)
    mine = torch.from_numpy(owner == rank)[:, None]
    out = zero.weighted_allgather(torch.where(mine, full, 0.0), owner)
    return owner, out.numpy()


def compress(rank, world):
    """train.compress.compressed_psum_grads over the world: each rank's
    own seeded grads, zero residuals."""
    from repro_torch.train import compress as c
    rng = np.random.default_rng(100 + rank)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)),
         "b": [torch.from_numpy(rng.normal(size=(300,)).astype(np.float32))]}
    red, res = c.compressed_psum_grads(g, c.init_residuals(g))
    tree = {"g": g, "red": red, "res": res}
    return {k: {"w": v["w"].numpy(), "b": v["b"][0].numpy()}
            for k, v in tree.items()}


def elastic(rank, world, ckpt_dir, cfg_kw, tokens):
    """A checkpoint restored onto a (world/2, 2) (data, model) mesh by
    ``sharding.specs.param_shardings`` (DTensor placements): each leaf's
    full tensor and the loss computed on the restored DTensor params, the
    tokens placed by ``batch_shardings`` (the reference computes it under
    ``with mesh``)."""
    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.lm import LM
    from repro_torch.sharding import specs
    from repro_torch.train.optimizer import tree_leaves, tree_map
    cfg = ModelConfig(**cfg_kw)
    lm = LM(cfg)
    like = lm.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = make_debug_mesh(world, 2, device_type="cpu")
    shards = specs.param_shardings(cfg, mesh, like)
    step, restored = CheckpointManager(ckpt_dir).restore(like=like,
                                                         shardings=shards)
    sharded = sum(any(p.is_shard() for p in t.placements)
                  for t in tree_leaves(restored))
    local = [tuple(t.to_local().shape) for t in tree_leaves(restored)]
    full = tree_map(lambda t: t.full_tensor(), restored)
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        loss, _ = lm.loss(restored, specs.place(
            batch, specs.batch_shardings(cfg, mesh, batch)))
    loss = loss.full_tensor()
    leaves = [t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
              else t.numpy() for t in tree_leaves(full)]
    return step, sharded, local, leaves, float(loss)


# -- sharded compute (tests/test_torch_sharded.py) ----------------------------

def _sharded_model(cfg, model_size, world):
    """(``cfg``, an LM on the chunked path, the (world/model, model)
    DeviceMesh, a function that clears the launcher's constraints) on the
    CPU."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.lm import LM
    lm = LM(cfg)
    lm.attn_impl = "reference"
    mesh = make_debug_mesh(world, model_size, device_type="cpu")
    return cfg, lm, mesh, dryrun.launcher_constraints(lm, cfg, mesh,
                                                      "train")


def _full(tree):
    from repro_torch.train.optimizer import tree_leaves
    return [t.full_tensor().numpy() for t in tree_leaves(tree)]


def sharded_train(rank, world, params_path, cfg, model_size, opt_kw,
                  accum, token_batches):
    """``make_train_step`` with ``grad_specs`` and ``mb_specs`` on the
    (world/model, model) mesh from the params pickled at ``params_path``
    (the reference's, numpy): after each step, rank 0 returns the full
    params and optimizer state and the metrics."""
    import pickle

    from repro_torch.convert import params_from_reference
    from repro_torch.sharding import specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    cfg, lm, mesh, clear = _sharded_model(cfg, model_size, world)
    with open(params_path, "rb") as f:
        params = params_from_reference(pickle.load(f), device="cpu")
    ocfg = opt.OptConfig(**opt_kw)
    pspecs = lm.param_specs()
    params = specs.place(params, specs.param_shardings(cfg, mesh, pspecs))
    state = opt.init_opt_state(ocfg, params, specs.opt_shardings(
        cfg, mesh, opt.opt_state_specs(ocfg, pspecs)))
    batch0 = {"tokens": torch.from_numpy(token_batches[0])}
    bsh = specs.batch_shardings(cfg, mesh, batch0)
    step = ts.make_train_step(lm, ocfg, accum,
                              specs.grad_shardings(cfg, mesh, pspecs),
                              specs.mb_shardings(bsh))
    out = []
    try:
        for toks in token_batches:
            batch = specs.place({"tokens": torch.from_numpy(toks)}, bsh)
            params, state, m = step(params, state, batch)
            rec = {"params": _full(params),
                   "state": {k: _full(state[k]) for k in ("m", "v")},
                   "metrics": {k: float(getattr(v, "full_tensor",
                                                 lambda: v)())
                               for k, v in m.items()}}
            out.append(rec if rank == 0 else None)
    finally:
        clear()
    return out


def sharded_update(rank, world, params_path, cfg, model_size, opt_kw,
                   accum, token_batches):
    """``adamw_update`` on shards fed the one-device step's gradients:
    each rank runs the one-device steps from the params pickled at
    ``params_path`` and, beside them, the update of the params and state
    placed on the (world/model, model) mesh with the same gradients. After
    each step rank 0 returns the full sharded params and state."""
    import pickle

    from repro_torch.convert import params_from_reference
    from repro_torch.sharding import specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    cfg, lm, mesh, clear = _sharded_model(cfg, model_size, world)
    clear()
    with open(params_path, "rb") as f:
        params = params_from_reference(pickle.load(f), device="cpu")
    ocfg = opt.OptConfig(**opt_kw)
    pspecs = lm.param_specs()
    psh = specs.param_shardings(cfg, mesh, pspecs)
    state = opt.init_opt_state(ocfg, params)
    sparams = specs.place(params, psh)
    sstate = opt.init_opt_state(ocfg, sparams, specs.opt_shardings(
        cfg, mesh, opt.opt_state_specs(ocfg, pspecs)))
    out = []
    for toks in token_batches:
        grads = ts.accumulated_grads(
            lm, params, {"tokens": torch.from_numpy(toks)}, accum)[0]
        params, state, _ = opt.adamw_update(ocfg, params, grads, state)
        sparams, sstate, _ = opt.adamw_update(
            ocfg, sparams, specs.place(grads, psh), sstate)
        rec = {"params": _full(sparams),
               "state": {k: _full(sstate[k]) for k in ("m", "v")}}
        out.append(rec if rank == 0 else None)
    return out


def sharded_counts(rank, world, cfg, model_size, tokens):
    """One ``make_train_step`` step at ``accum_steps_for``'s accumulation
    (the dry-run's), the params drawn from a seeded generator: the
    collectives ``CommDebugMode`` counts by kind and ``RankFlops``' FLOPs;
    and, under ``CollectiveLog``, the forward and backward of layer 0's
    body and of the whole loss (kind, mesh dim, result bytes and result
    shape each)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models.lm import layer_params_of
    from repro_torch.roofline import counter
    from repro_torch.sharding import specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    from repro_torch.launch.dryrun import group_dims
    cfg, lm, mesh, clear = _sharded_model(cfg, model_size, world)
    dim_of = group_dims(mesh)
    pspecs = lm.param_specs()
    params = specs.place(lm.init(torch.Generator().manual_seed(1),
                                 device="cpu"),
                         specs.param_shardings(cfg, mesh, pspecs))
    ocfg = ts.opt_config_for(cfg)
    state = opt.init_opt_state(ocfg, params, specs.opt_shardings(
        cfg, mesh, opt.opt_state_specs(ocfg, pspecs)))
    b, s = tokens.shape
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    accum = ts.accum_steps_for(cfg, b, s, sizes["data"], sizes["model"])
    batch = {"tokens": torch.from_numpy(tokens)}
    bsh = specs.batch_shardings(cfg, mesh, batch)
    batch = specs.place(batch, bsh)
    step = ts.make_train_step(
        lm, ocfg, accum,
        specs.grad_shardings(cfg, mesh, pspecs) if accum > 1 else None,
        specs.mb_shardings(bsh) if accum > 1 else None)

    def logged(fn):
        with counter.CollectiveLog() as log:
            fn()
        return [(k, mesh.mesh_dim_names[dim_of(g)], nbytes, shape)
                for k, nbytes, g, shape, _ in log.ops]
    try:
        with CommDebugMode() as comm, counter.RankFlops() as flops:
            step(params, state, batch)
        counts = {counter.KINDS[str(op).split(".")[-1]]: n
                  for op, n in comm.get_comm_counts().items()}
        g = lm.groups[0]
        p0 = opt.tree_map(lambda t: t.detach().requires_grad_(),
                          layer_params_of(params["groups"][0], 0))
        x = lm._constrain(lm.embed(params, batch))
        pos = lm._positions(batch, s, b)

        def layer():
            y, aux, _ = lm._layer(g.kind, p0, x.detach().requires_grad_(),
                                  pos, 0)
            torch.autograd.grad(y.sum() + aux, opt.tree_leaves(p0))

        def loss():
            ts.accumulated_grads(lm, params, batch)
        out = (accum, counts, flops.flops, logged(layer), logged(loss))
    finally:
        clear()
    return out if rank == 0 else None


def sharded_trainer(rank, world, ckpt_dir, cfg, opt_kw, accum, steps):
    """The reference's elastic story on the port's ``Trainer``: ``steps``
    steps on a (2, 2) mesh with a checkpoint at the last, then a restore
    onto (4, 1) and ``steps`` more. Rank 0 returns the full params."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.lm import LM
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt
    lm = LM(cfg)
    lm.attn_impl = "reference"
    out = None
    for model_size, total in ((2, steps), (1, 2 * steps)):
        mesh = make_debug_mesh(world, model_size, device_type="cpu")
        trainer = loop.Trainer(
            lm, opt.OptConfig(**opt_kw),
            loop.LoopConfig(total_steps=total, ckpt_every=steps,
                            log_every=10 ** 6),
            ckpt_dir, trainer_batch, mesh=mesh, accum=accum)
        step, params, _, _ = trainer.run()
        out = (step, _full(params))
    return out if rank == 0 else None


def trainer_batch(step):
    """The trainer tests' batches: 8 rows of 16 tokens from a seeded
    generator (the smoke configs' 256-token vocabulary)."""
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, 256, (8, 16)).astype(np.int32)}


# -- sharded prefill and decode (tests/test_torch_sharded_decode.py) ---------

class _InputsOf(TorchDispatchMode):
    """A dispatch mode that records each collective (a functional
    collective on a rank's local tensors) whose input shares a storage
    with one of ``watched``'s local tensors (DTensors)."""

    def __init__(self, watched):
        super().__init__()
        self.keys = {t.to_local().untyped_storage().data_ptr()
                     for t in watched}
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from repro_torch.sharding import dtensor
        if any(issubclass(t, dtensor._dtensor()) for t in types):
            return NotImplemented
        if func.namespace == "_c10d_functional" and any(
                _storage_ptr(a) in self.keys for a in args):
            self.hits.append(func._opname)
        return func(*args, **(kwargs or {}))


def _storage_ptr(a):
    """The data pointer of a tensor's storage (None for anything else, or
    a tensor whose storage Python cannot reach, as a collective's
    in-flight output: not a cache leaf's)."""
    if not isinstance(a, torch.Tensor):
        return None
    try:
        return a.untyped_storage().data_ptr()
    except RuntimeError:
        return None


def _counted(fn, mesh, watched=()):
    """(``CommDebugMode``'s counts by kind, ``RankFlops``' FLOPs,
    ``CollectiveLog``'s records as (kind, mesh dim, result bytes, dtype,
    result shape), and the collectives whose input is one of
    ``watched``'s shards) of one call of ``fn``."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.launch.dryrun import group_dims
    from repro_torch.roofline import counter
    dim_of = group_dims(mesh)
    inputs = _InputsOf(watched)
    with CommDebugMode() as comm, counter.RankFlops() as flops, \
            counter.CollectiveLog() as log, inputs:
        fn()
    counts = {counter.KINDS[str(op).split(".")[-1]]: n
              for op, n in comm.get_comm_counts().items()}
    ops = [(k, mesh.mesh_dim_names[dim_of(g)], nbytes, str(dt), shape)
           for k, nbytes, g, shape, dt in log.ops]
    return counts, flops.flops, ops, inputs.hits


def _cache_shares(cache, lm):
    """Per K/V or latent leaf (``k``, ``v``, ``ckv``, ``kpe``): its name,
    one layer's share on this rank in bytes, the sizes of the mesh dims
    that split it (of more than one rank), its dtype and its last dim."""
    from repro_torch.sharding import specs
    out = []

    def f(path, leaf):
        name = specs._leaf_name(path)
        if name not in ("k", "v", "ckv", "kpe"):
            return
        local = leaf.to_local()
        if lm.groups[path[0]].scanned:       # one layer of a stacked leaf
            local = local[0]
        mesh = leaf.device_mesh
        out.append((name, local.numel() * local.element_size(),
                    [mesh.size(d) for d, p in enumerate(leaf.placements)
                     if p.is_shard() and mesh.size(d) > 1],
                    str(leaf.dtype), local.shape[-1]))
    specs.map_with_path(f, cache)
    return out


def _kv_leaves(cache):
    """The ``k``, ``v``, ``ckv`` and ``kpe`` leaves of a cache."""
    from repro_torch.sharding import specs
    out = []
    specs.map_with_path(
        lambda path, leaf: out.append(leaf) if specs._leaf_name(path) in (
            "k", "v", "ckv", "kpe") else None, cache)
    return out


def sharded_infer(rank, world, params_path, cfg, model_size, tokens,
                  steps):
    """The prefill and decode cells as the reference jits them, on the
    (world/model, model) mesh from the params pickled at ``params_path``:
    the prefill's last-token logits under the launcher's prefill
    constraints; then a cache made shard by shard in
    ``cache_leaf_spec``'s layouts and ``len(steps)`` decode steps at
    positions 0, 1, ... (each step's logits, and every cache leaf after
    the last); and one more prefill and one more decode step
    (``registry.step_fn``, the dry-run's function) counted by
    ``_counted``, with the cache's shares. Rank 0 returns it all."""
    import pickle

    from repro_torch.configs import registry
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import dryrun
    from repro_torch.sharding import specs
    from repro_torch.train.optimizer import tree_leaves
    cfg, lm, mesh, clear = _sharded_model(cfg, model_size, world)
    clear()
    with open(params_path, "rb") as f:
        params = params_from_reference(pickle.load(f), device="cpu")
    params = specs.place(params, specs.param_shardings(cfg, mesh,
                                                       lm.param_specs()))
    b, s = tokens.shape
    out = {}
    with torch.no_grad():
        shape = registry.SHAPES["prefill_32k"]
        clear = dryrun.launcher_constraints(lm, cfg, mesh, shape.kind)
        try:
            batch = {"tokens": torch.from_numpy(tokens)}
            batch = specs.place(batch, specs.batch_shardings(cfg, mesh,
                                                             batch))
            out["prefill"] = lm.prefill(params, batch).full_tensor().numpy()
            fn = registry.step_fn(cfg, shape, lm)
            out["prefill_counted"] = _counted(lambda: fn(params, batch),
                                              mesh)
        finally:
            clear()
        shape = registry.SHAPES["decode_32k"]
        bsh = specs.batch_shardings(cfg, mesh, registry.input_specs(
            cfg, shape, batch=b, seq=s))
        clear = dryrun.launcher_constraints(lm, cfg, mesh, shape.kind)
        try:
            cache = lm.init_cache(b, s, shardings=bsh["cache"])
            logits = []
            for t, toks in enumerate(steps):
                tk = specs.place(torch.from_numpy(toks), bsh["tokens"])
                lg, cache = lm.decode_step(params, cache, tk, t)
                logits.append(lg.full_tensor().numpy())
            out["decode"] = logits
            out["cache"] = [c.full_tensor().numpy()
                            for c in tree_leaves(cache)]
            fn = registry.step_fn(cfg, shape, lm)
            batch = {"cache": cache,
                     "tokens": specs.place(torch.from_numpy(steps[0]),
                                           bsh["tokens"]),
                     "position": specs.place(
                         torch.tensor(len(steps), dtype=torch.int32),
                         bsh["position"])}
            out["decode_counted"] = _counted(lambda: fn(params, batch),
                                             mesh, _kv_leaves(cache))
            out["shares"] = _cache_shares(cache, lm)
        finally:
            clear()
    return out if rank == 0 else None


def regroup_cases(rank, world):
    """``sharding.dtensor.regroup`` of a [16, 32] int32 tensor on a (2, 2,
    2) (pod, data, model) mesh, for the layouts a ``pos`` leaf takes (its
    capacity over some mesh dims, read with the batch over the data-
    parallel ones): whether this rank's shard and placements equal
    ``distribute_tensor``'s of the target layout, a case each."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.sharding import dtensor
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    full = torch.arange(16 * 32, dtype=torch.int32).reshape(16, 32)
    s0, s1, r = Shard(0), Shard(1), Replicate()
    cases = [((s1, s1, s1), (s0, s0, s1)), ((s1, s1, s1), (s0, s0, r)),
             ((r, s1, s1), (r, s0, s1)), ((s1, s1, r), (s0, s0, r)),
             ((s1, r, s1), (s0, r, r)), ((s1, s1, s1), (s1, s1, s1))]
    out = []
    for src, tgt in cases:
        x = distribute_tensor(full, mesh, list(src), src_data_rank=None)
        y = dtensor.regroup(x, tgt)
        want = distribute_tensor(full, mesh, list(tgt), src_data_rank=None)
        out.append(tuple(y.placements) == tgt
                   and torch.equal(y.to_local(), want.to_local()))
    return out


def split_block_inputs():
    """Params, grads and an int8 optimizer state (block 256, step 3, nonzero
    moments) from a seeded generator: the ``split_block_update`` case."""
    from repro_torch.train import optimizer as opt
    g = torch.Generator().manual_seed(3)
    p = {"w": torch.randn(8, 512, generator=g)}
    grads = {"w": torch.randn(8, 512, generator=g)}
    m = opt.quantize_q8(torch.randn(8, 512, generator=g) * 0.1, 256)
    v = opt.quantize_q8(torch.rand(8, 512, generator=g) * 0.01, 256)
    state = {"step": torch.tensor(3, dtype=torch.int32), "m": {"w": m},
             "v": {"w": v}}
    return p, grads, state


def split_block_update(rank, world):
    """``adamw_update`` with int8 moments whose quantization blocks are
    split over the data axis of a (world/2, 2) mesh (``q`` [8, 2, 256]
    placed ``Shard(2)`` on data, the params and grads whole): rank 0
    returns the full new params, ``q`` and ``scale``, and the moments'
    placements after the step."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding import dtensor
    from repro_torch.train import optimizer as opt
    mesh = make_debug_mesh(world, 2, device_type="cpu")
    p, grads, state = split_block_inputs()
    whole = [Replicate(), Replicate()]
    split = [Shard(2), Replicate()]

    def place(t, pl):
        return dtensor.from_local(t, mesh, whole).redistribute(mesh, pl)
    moment = {k: {"w": {"q": place(state[k]["w"]["q"], split),
                        "scale": place(state[k]["w"]["scale"], whole)}}
              for k in ("m", "v")}
    sstate = {"step": state["step"], **moment}
    new_p, new_s, _ = opt.adamw_update(
        opt.OptConfig(quantized_moments=True),
        {"w": place(p["w"], whole)}, {"w": place(grads["w"], whole)},
        sstate)
    out = {"w": new_p["w"].full_tensor().numpy()}
    for k in ("m", "v"):
        for part in ("q", "scale"):
            leaf = new_s[k]["w"][part]
            out[f"{k}.{part}"] = leaf.full_tensor().numpy()
            out[f"{k}.{part}.placements"] = str(tuple(leaf.placements))
    return out if rank == 0 else None


# -- the VLM, hybrid, SSM and encoder-decoder families on shards
#    (tests/test_torch_sharded_families.py) ---------------------------------

#: the decode-state leaves no decode step may gather
STATE_LEAVES = ("k", "v", "h", "conv", "c", "n", "m", "ck", "cv")


def _state_leaves(cache):
    from repro_torch.sharding import specs
    out = []
    specs.map_with_path(
        lambda path, leaf: out.append(leaf)
        if specs._leaf_name(path) in STATE_LEAVES else None, cache)
    return out


def _set_chunks(chunk):
    """The Mamba and mLSTM chunk lengths (``None``: as they are); returns
    a function that restores them."""
    from repro_torch.models import ssm
    saved = ssm.SSM_CHUNK, ssm.MLSTM_CHUNK
    if chunk:
        ssm.SSM_CHUNK = ssm.MLSTM_CHUNK = chunk

    def restore():
        ssm.SSM_CHUNK, ssm.MLSTM_CHUNK = saved
    return restore


_MESHES: dict = {}


def _mesh_of(world, model_size):
    """One (world/model, model) DeviceMesh a process: DTensor's sharding
    cache can hand an op on one mesh the output spec of an equal mesh made
    earlier, whose process groups the other ranks need not pick alike, and
    two ranks then wait in collectives over different groups."""
    from repro_torch.launch.mesh import make_debug_mesh
    if (world, model_size) not in _MESHES:
        _MESHES[world, model_size] = make_debug_mesh(world, model_size,
                                                     device_type="cpu")
    return _MESHES[world, model_size]


def sharded_family(rank, world, params_path, cfg, model_size, opt_kw,
                   batch, steps, chunk, f64=False):
    """A family's cells as the reference jits them, on the (world/model,
    model) mesh from the params pickled at ``params_path`` (the
    reference's, numpy), ``batch`` (numpy arrays: tokens, and frames or
    patch embeddings and positions) placed by ``batch_shardings``:

    - one ``make_train_step`` step at the dry-run's accumulation
      (``accum_steps_for``: the config's ``train_accum_override``), with
      ``grad_specs`` and ``mb_specs`` under accumulation: the full new
      params and moments, loss and grad norm;
    - the prefill's last-token logits (``registry.step_fn``, the dry-run's
      function), and again with the Mamba and mLSTM chunks cut to
      ``chunk`` tokens (a multi-chunk forward);
    - a cache made shard by shard in ``cache_leaf_spec``'s layouts (an
      encoder-decoder's cross K/V written from its frames) and
      ``len(steps)`` decode steps at positions 0, 1, ...: each step's
      logits, every cache leaf after the last and its placements; with
      ``f64`` the same decode again in float64 params and compute;
    - ``_counted`` of that train step and that prefill, and of one more
      decode step (``registry.step_fn``) with the state leaves watched.

    Rank 0 returns it all."""
    import dataclasses
    import pickle

    from repro_torch.configs import registry
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import dryrun
    from repro_torch.sharding import specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    lm = registry.make_model(cfg)
    lm.attn_impl = "reference"
    mesh = _mesh_of(world, model_size)
    with open(params_path, "rb") as f:
        whole = params_from_reference(pickle.load(f), device="cpu")
    pspecs = lm.param_specs()
    params = specs.place(whole, specs.param_shardings(cfg, mesh, pspecs))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    bsh = specs.batch_shardings(cfg, mesh, batch)
    batch = specs.place(batch, bsh)
    b, s = batch["tokens"].shape[0], _seq_of(batch)
    out = {}

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    accum = ts.accum_steps_for(cfg, b, s, sizes["data"], sizes["model"])
    ocfg = opt.OptConfig(**opt_kw)
    state = opt.init_opt_state(ocfg, params, specs.opt_shardings(
        cfg, mesh, opt.opt_state_specs(ocfg, pspecs)))
    step = ts.make_train_step(
        lm, ocfg, accum,
        specs.grad_shardings(cfg, mesh, pspecs) if accum > 1 else None,
        specs.mb_shardings(bsh) if accum > 1 else None)
    res = {}
    clear = dryrun.launcher_constraints(lm, cfg, mesh, "train")
    try:
        out["train_counted"] = _counted(
            lambda: res.update(train=step(params, state, batch)), mesh)
    finally:
        clear()
    new, st, m = res["train"]
    out["train"] = {"params": _full(new),
                    "state": {k: _full(st[k]) for k in ("m", "v")},
                    "metrics": {k: float(m[k].full_tensor())
                                for k in ("loss", "grad_norm")}}
    with torch.no_grad():
        shape = registry.SHAPES["prefill_32k"]
        clear = dryrun.launcher_constraints(lm, cfg, mesh, shape.kind)
        try:
            fn = registry.step_fn(cfg, shape, lm)
            out["prefill_counted"] = _counted(
                lambda: res.update(prefill=fn(params, batch)), mesh)
            out["prefill"] = res["prefill"].full_tensor().numpy()
            restore = _set_chunks(chunk)
            try:
                out["prefill_chunked"] = lm.prefill(
                    params, batch).full_tensor().numpy()
            finally:
                restore()
        finally:
            clear()
        logits, cache, dsh = _decode_run(lm, params, batch, steps, mesh)
        out["decode"], out["cache"] = logits, _full(cache)
        out["cache_placements"] = [tuple(str(p) for p in leaf.placements)
                                   for leaf in _leaves(cache)]
        shape = registry.SHAPES["decode_32k"]
        clear = dryrun.launcher_constraints(lm, cfg, mesh, shape.kind)
        try:
            fn = registry.step_fn(cfg, shape, lm)
            dbatch = {"cache": cache,
                      "tokens": specs.place(torch.from_numpy(steps[0]),
                                            dsh["tokens"]),
                      "position": specs.place(
                          torch.tensor(len(steps), dtype=torch.int32),
                          dsh["position"])}
            out["decode_counted"] = _counted(lambda: fn(params, dbatch),
                                             mesh, _state_leaves(cache))
        finally:
            clear()
        if f64:
            cfg64 = dataclasses.replace(cfg, compute_dtype="float64",
                                        param_dtype="float64")
            lm64 = registry.make_model(cfg64)
            lm64.attn_impl = "reference"
            p64 = specs.place(
                opt.tree_map(lambda t: t.double(), whole),
                specs.param_shardings(cfg64, mesh, lm64.param_specs()))
            b64 = {k: v.double() if v.is_floating_point() else v
                   for k, v in batch.items()}
            logits, cache, _ = _decode_run(lm64, p64, b64, steps, mesh)
            out["decode64"], out["cache64"] = logits, _full(cache)
    return out if rank == 0 else None


def _decode_run(lm, params, batch, steps, mesh):
    """(each step's full logits, the cache, the decode cell's shardings)
    of ``len(steps)`` decode steps at positions 0, 1, ... from a cache
    made shard by shard at the batch's size (an encoder-decoder's cross
    K/V written from the batch's frames)."""
    from repro_torch.configs import registry
    from repro_torch.sharding import specs
    cfg = lm.cfg
    b, s = batch["tokens"].shape[0], _seq_of(batch)
    dsh = specs.batch_shardings(cfg, mesh, registry.input_specs(
        cfg, registry.SHAPES["decode_32k"], batch=b, seq=s))
    if cfg.enc_dec:
        cache = lm.init_cache(None, b, s, cfg.enc_frames,
                              shardings=dsh["cache"])
        lm.write_cross(params, cache, batch["frames"])
    else:
        cache = lm.init_cache(b, s, shardings=dsh["cache"])
    logits = []
    for t, toks in enumerate(steps):
        tk = specs.place(torch.from_numpy(toks), dsh["tokens"])
        lg, cache = lm.decode_step(params, cache, tk, t)
        logits.append(lg.full_tensor().numpy())
    return logits, cache, dsh


def _seq_of(batch):
    """A batch's sequence: its tokens', and a VLM's patches before them."""
    s = batch["tokens"].shape[1]
    if "patch_embeds" in batch:
        s += batch["patch_embeds"].shape[1]
    return s


def _leaves(tree):
    from repro_torch.train.optimizer import tree_leaves
    return tree_leaves(tree)
