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
    body and of the whole loss (kind, mesh dim, result shape each)."""
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
        return [(k, mesh.mesh_dim_names[dim_of(g)], nbytes)
                for k, nbytes, g, _ in log.ops]
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
