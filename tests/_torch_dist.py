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
            res = {name: globals()[name](rank, world, *args)
                   for name, args in tasks}
        finally:
            dist.destroy_process_group()
        out.put((rank, res, None))
    except Exception:                       # reported to the parent
        out.put((rank, None, traceback.format_exc()))


def run(world: int, tasks: list[tuple[str, tuple]], timeout: float = 120):
    """[rank -> {task: result}] of ``tasks`` [(function name, args)] run in
    order in each of ``world`` gloo ranks."""
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
    full tensor and, reassembled, the params' loss."""
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
    with torch.no_grad():
        loss, _ = lm.loss(full, {"tokens": torch.from_numpy(tokens)})
    leaves = [t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
              else t.numpy() for t in tree_leaves(full)]
    return step, sharded, local, leaves, float(loss)
