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

Elastic restart (restore onto a different mesh) is ``CheckpointManager.
restore(shardings=...)`` with ``sharding.specs``' DTensor placements; the
trainer itself runs on one device. A ``mesh`` or ``shardings`` that
describes more than one device raises ``NotImplementedError`` (sharded
compute is ROADMAP queue 1 item 10).
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


def _one_device(mesh, shardings) -> torch.device | None:
    """The single device that ``mesh`` / ``shardings`` describe (None when
    both are None); raises if they describe more than one."""
    if mesh is not None:
        sizes = axis_sizes(mesh)
        if math.prod(sizes.values()) != 1:
            raise NotImplementedError(
                f"a {sizes} mesh: the port's trainer runs on one device "
                "(sharded compute is ROADMAP queue 1 item 10)")
    if shardings is None:
        return None
    if isinstance(shardings, (str, torch.device)):
        return torch.device(shardings)
    raise NotImplementedError(
        "shardings other than one device: the port's trainer runs on one "
        "device (sharded compute is ROADMAP queue 1 item 10); restore onto "
        "a mesh with CheckpointManager.restore(shardings=...)")


class Trainer:
    def __init__(self, model, opt_cfg: opt_mod.OptConfig, loop: LoopConfig,
                 ckpt_dir: str, batch_fn: Callable[[int], dict],
                 mesh=None, shardings=None, accum: int = 1, *,
                 device="cuda"):
        """batch_fn(step) -> batch dict (the data pipeline boundary; numpy
        arrays or tensors, moved to the trainer's device). ``mesh`` /
        ``shardings`` may only describe one device (a one-device mesh; a
        device, which then is the trainer's)."""
        one = _one_device(mesh, shardings)
        self.device = resolve(one if one is not None else device)
        self.model = model
        self.opt_cfg = opt_cfg
        self.loop = loop
        self.ckpt = CheckpointManager(ckpt_dir, keep_last=loop.keep_last)
        self.batch_fn = batch_fn
        self.mesh = mesh
        self.shardings = shardings
        self.jstep = make_train_step(model, opt_cfg, accum_steps=accum)
        self.step_times: list[float] = []

    # -- state --------------------------------------------------------------

    def init_state(self, seed: int = 0):
        """(0, params, opt_state): ``model.init`` from a ``torch.Generator``
        seeded with ``seed`` on the trainer's device."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = self.model.init(gen, device=self.device)
        opt_state = opt_mod.init_opt_state(self.opt_cfg, params)
        return 0, params, opt_state

    def restore_or_init(self, seed: int = 0):
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state(seed)
        _, params, opt_state = self.init_state(seed)
        step, tree = self.ckpt.restore(
            latest, like={"params": params, "opt": opt_state},
            shardings=self.device)
        return step, tree["params"], tree["opt"]

    def _batch(self, step: int) -> dict:
        return opt_mod.tree_map(lambda x: torch.as_tensor(x).to(self.device),
                                self.batch_fn(step))

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
            params, opt_state, metrics = self.jstep(params, opt_state,
                                                    batch)
            self._sync()
            dt = time.monotonic() - t0
            self.step_times.append(dt)
            step += 1
            if step % self.loop.ckpt_every == 0 \
                    or step == self.loop.total_steps:
                self.ckpt.save(step, {"params": params, "opt": opt_state},
                               metadata={"loss": float(metrics["loss"])})
            if step % self.loop.log_every == 0:
                print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"{dt * 1e3:.0f} ms/step")
        return step, params, opt_state, metrics
