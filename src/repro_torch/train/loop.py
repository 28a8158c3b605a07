"""Training loop with the large-scale runnability substrate (port of
``repro.train.loop``):

- checkpoint/restart (atomic, hashed — checkpoint/ckpt.py), resume from
  LATEST after any crash; the checkpoints are the reference's, so either
  package's trainer resumes the other's run (through ``convert`` for the
  optimizer state's arrays);
- straggler mitigation and BWAP-weighted data routing live in the batch
  function's data pipeline (data/pipeline.py ``BwapDataRouter``);
- optional int8 error-feedback gradient compression (train/compress.py);
- failure injection hooks for tests (fail_at_step).

The reference jit-compiles the step and donates its buffers; here the step
runs eagerly on ``device`` (the card unless the caller passes another) and
the caller's trees are not written. The reference's
``jax.block_until_ready`` on the loss is one synchronisation a step here:
the device's stream after the update, so ``step_times`` hold whole steps.

On a ``DeviceMesh`` (``mesh``; the caller has made the process group)
the trainer runs the sharded step: params, optimizer state and each batch
are DTensors placed by ``shardings`` (the reference's ``(params, opt_state,
batch)`` triple of ``sharding.specs`` trees; by default the specs' layouts
on the mesh), and with accumulation the step takes the ZeRO ``grad_specs``
and the microbatch specs. A checkpoint holds global arrays, so
``restore_or_init`` restores onto whatever mesh the trainer has: the
re-shard at load that makes elastic restart the reference's story.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.device import resolve
from repro_torch.launch.mesh import axis_sizes
from repro_torch.sharding import specs
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.trainstep import make_train_step


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    keep_last: int = 3
    log_every: int = 10
    straggler_ewma: float = 0.3
    straggler_factor: float = 2.0
    fail_at_step: int = -1          # test hook: raise at this step


class SimulatedFailure(RuntimeError):
    pass


def _mesh_of(mesh, shardings):
    """The ``DeviceMesh`` the trainer runs on (None: one device): ``mesh``,
    or the mesh of ``shardings``' pairs; a stand-in mesh (axis names and
    sizes) of one device is one device."""
    if mesh is None and shardings is not None:
        mesh = next(iter(_pairs(shardings[0])))[0]
    if mesh is None or hasattr(mesh, "mesh_dim_names"):
        return mesh
    if math.prod(axis_sizes(mesh).values()) == 1:
        return None
    raise TypeError(f"a {axis_sizes(mesh)} mesh: pass a torch.distributed "
                    "DeviceMesh (launch/mesh.py) to run sharded on it")


def _pairs(tree):
    if isinstance(tree, tuple) and len(tree) == 2 \
            and hasattr(tree[0], "mesh_dim_names"):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _pairs(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _pairs(v)


def _scalar(x) -> float:
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


class Trainer:
    def __init__(self, model, opt_cfg: opt_mod.OptConfig, loop: LoopConfig,
                 ckpt_dir: str, batch_fn: Callable[[int], dict],
                 mesh=None, shardings=None, accum: int = 1, *,
                 device="cuda"):
        """batch_fn(step) -> batch dict (the data pipeline boundary; numpy
        arrays or tensors, the whole global batch on every rank). Without
        a mesh the step runs on ``device``; on a ``DeviceMesh`` it runs
        sharded, on the mesh's device type, with ``shardings`` the
        ``(params, opt_state, batch)`` layouts (None: the specs' rules;
        the batch's from its first batch)."""
        self.mesh = _mesh_of(mesh, shardings)
        self.device = resolve(self.mesh.device_type if self.mesh is not None
                              else device)
        self.model = model
        self.opt_cfg = opt_cfg
        self.loop = loop
        self.ckpt = CheckpointManager(ckpt_dir, keep_last=loop.keep_last)
        self.batch_fn = batch_fn
        self.accum = accum
        self.shardings = shardings
        if self.mesh is not None and shardings is None:
            cfg = model.cfg
            pspecs = model.param_specs()
            self.shardings = (
                specs.param_shardings(cfg, self.mesh, pspecs),
                specs.opt_shardings(cfg, self.mesh, opt_mod.opt_state_specs(
                    opt_cfg, pspecs)), None)
        self.jstep = None if self.mesh is not None else make_train_step(
            model, opt_cfg, accum_steps=accum)
        self.step_times: list[float] = []

    # -- state --------------------------------------------------------------

    def init_state(self, seed: int = 0):
        """(0, params, opt_state): ``model.init`` from a ``torch.Generator``
        seeded with ``seed`` on the trainer's device; on a mesh every rank
        draws the same params and keeps its own shards of them, and the
        optimizer state is made shard by shard."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen, device=self.device)
        if self.mesh is None:
            return 0, params, opt_mod.init_opt_state(self.opt_cfg, params)
        params = specs.place(params, self.shardings[0])
        return 0, params, opt_mod.init_opt_state(self.opt_cfg, params,
                                                 self.shardings[1])

    def restore_or_init(self, seed: int = 0):
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state(seed)
        pspecs = self.model.param_specs()
        like = {"params": pspecs,
                "opt": opt_mod.opt_state_specs(self.opt_cfg, pspecs)}
        where = self.device if self.mesh is None else {
            "params": self.shardings[0], "opt": self.shardings[1]}
        step, tree = self.ckpt.restore(latest, like=like, shardings=where)
        return step, tree["params"], tree["opt"]

    def _batch(self, step: int) -> dict:
        batch = opt_mod.tree_map(lambda x: torch.as_tensor(x).to(self.device),
                                 self.batch_fn(step))
        if self.mesh is None:
            return batch
        if self.shardings[2] is None:
            self.shardings = self.shardings[:2] + (specs.batch_shardings(
                self.model.cfg, self.mesh, batch),)
        return specs.place(batch, self.shardings[2])

    def _step(self, params, opt_state, batch):
        if self.jstep is None:             # sharded: specs of the batch's
            cfg, mesh = self.model.cfg, self.mesh
            grads = mb = None
            if self.accum > 1:
                grads = specs.grad_shardings(cfg, mesh,
                                             self.model.param_specs())
                mb = specs.mb_shardings(self.shardings[2])
            self.jstep = make_train_step(self.model, self.opt_cfg,
                                         self.accum, grads, mb)
        return self.jstep(params, opt_state, batch)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- loop ---------------------------------------------------------------

    def run(self, start=None):
        step, params, opt_state = start or self.restore_or_init()
        metrics = {}
        while step < self.loop.total_steps:
            if step == self.loop.fail_at_step:
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.monotonic()
            batch = self._batch(step)
            params, opt_state, metrics = self._step(params, opt_state,
                                                    batch)
            self._sync()
            dt = time.monotonic() - t0
            self.step_times.append(dt)
            step += 1
            if step % self.loop.ckpt_every == 0 \
                    or step == self.loop.total_steps:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               metadata={"loss": _scalar(metrics["loss"])})
            if step % self.loop.log_every == 0:
                print(f"step {step:5d} loss {_scalar(metrics['loss']):.4f} "
                      f"lr {_scalar(metrics['lr']):.2e} "
                      f"{dt * 1e3:.0f} ms/step")
        return step, params, opt_state, metrics
