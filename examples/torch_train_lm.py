"""End-to-end training run of the PyTorch port: reduced LM, synthetic
pipeline, checkpoint/restart, straggler-aware data routing; on the card
unless ``--device cpu`` is given. The port of ``examples/train_lm.py``
(params drawn by ``torch.Generator`` from seed 0).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --steps 200   # resumes!

Scale knobs: --d-model/--layers grow toward the ~100M-param configuration
(--preset 100m). The checkpoints go to ``--ckpt``, by default
``bwap_torch_train_ckpt`` in the temporary directory: not the reference
example's directory, so neither package resumes the other's run.
"""

import argparse
import dataclasses
import os
import tempfile

import numpy as np

from repro_torch.configs import registry
from repro_torch.data.pipeline import BwapDataRouter, ShardedTokenDataset
from repro_torch.device import resolve
from repro_torch.models.lm import LM
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optimizer import OptConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--preset", choices=["tiny", "100m"], default="tiny")
    ap.add_argument("--ckpt", default=os.path.join(
        tempfile.gettempdir(), "bwap_torch_train_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    base = registry.get_smoke_config("qwen2-0.5b")
    if args.preset == "100m":
        cfg = dataclasses.replace(base, num_layers=12, d_model=768,
                                  num_heads=12, num_kv_heads=4, d_ff=2048,
                                  vocab_size=32000)
    else:
        cfg = dataclasses.replace(base, num_layers=args.layers,
                                  d_model=args.d_model,
                                  num_heads=4, num_kv_heads=2,
                                  d_ff=4 * args.d_model, vocab_size=4096)
    model = LM(cfg)
    n = cfg.param_counts()["total"]
    print(f"model: {cfg.num_layers}L d={cfg.d_model} "
          f"({n / 1e6:.1f}M params)")

    # BWAP-weighted data routing over 4 simulated hosts
    ds = ShardedTokenDataset(cfg.vocab_size, args.seq, num_shards=16, seed=0)
    router = BwapDataRouter(16, host_bws=[1.0, 1.0, 0.8, 0.6])

    def batch_fn(step):
        shards = router.shards_of(step % 4)
        shard = int(shards[step % max(len(shards), 1)]) if len(shards) else 0
        return {"tokens": ds.batch(shard, step, args.batch)}

    trainer = Trainer(model, OptConfig(lr=3e-3, warmup_steps=20,
                                       total_steps=args.steps),
                      LoopConfig(total_steps=args.steps, ckpt_every=50,
                                 log_every=20),
                      args.ckpt, batch_fn, device=dev)
    step0, *_ = start = trainer.restore_or_init()
    if step0:
        print(f"resumed from checkpoint at step {step0}")
    step, params, opt_state, metrics = trainer.run(start)
    print(f"done at step {step}; final loss {float(metrics['loss']):.4f} "
          f"(uniform-random baseline would be "
          f"{np.log(cfg.vocab_size):.2f})")
    print(f"mean step time {np.mean(trainer.step_times) * 1e3:.1f} ms")
    return step, metrics


if __name__ == "__main__":
    main()
