"""Training launcher (port of ``repro.launch.train``), on the card unless
``--device`` says otherwise.

A reduced config end to end with checkpointing (``--smoke``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --smoke --steps 50 [--device cpu]

Without ``--smoke`` the same entry point trains the full config on one
device. ``--dry-run`` runs the production cell (``train_4k`` on the
single-pod mesh) through ``launch/dryrun.py`` on fake tensors, on the CPU,
and prints its status, memory and roofline terms (the H100 table).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def make_batch_fn(cfg, seq: int, batch: int, device):
    """step -> batch, the reference launcher's: synthetic tokens from shard
    0 of a seeded ``ShardedTokenDataset``; whisper's batches add seeded
    ``frames``, the vision stub's seeded ``patch_embeds`` (the text cut to
    leave them room)."""
    from repro_torch.data.pipeline import ShardedTokenDataset
    from repro_torch.device import dtype_of
    ds = ShardedTokenDataset(cfg.vocab_size, seq, num_shards=8)
    cdt = dtype_of(cfg.compute_dtype)

    def tensor(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    def batch_fn(step):
        if cfg.enc_dec:
            rng = np.random.default_rng(step)
            return {
                "frames": tensor(rng.normal(size=(
                    batch, cfg.enc_frames, cfg.d_model)), cdt),
                "tokens": tensor(ds.batch(0, step, batch)),
            }
        if cfg.frontend == "vision_stub":
            rng = np.random.default_rng(step)
            p = min(cfg.vision_patches, seq // 2)
            return {
                "patch_embeds": tensor(
                    rng.normal(size=(batch, p, cfg.d_model)) * 0.02, cdt),
                "tokens": tensor(ds.batch(0, step, batch)[:, :seq - p]),
            }
        return {"tokens": tensor(ds.batch(0, step, batch))}
    return batch_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the production cell on fake tensors "
                         "instead of executing (see repro_torch.launch."
                         "dryrun for the full sweep)")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell(args.arch, "train_4k", multi_pod=False)
        rec["roofline"] = dryrun.roofline_record(rec)
        print(rec.get("status"), rec.get("memory"))
        print("roofline:", rec["roofline"])
        return rec

    from repro_torch.configs import registry
    from repro_torch.device import resolve
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.trainstep import opt_config_for

    dev = resolve(args.device)
    cfg = registry.get_smoke_config(args.arch) if args.smoke \
        else registry.get_config(args.arch)
    model = registry.make_model(cfg)
    trainer = Trainer(model, opt_config_for(cfg, lr=1e-3,
                                            total_steps=args.steps),
                      LoopConfig(total_steps=args.steps, ckpt_every=25,
                                 log_every=10),
                      args.ckpt,
                      make_batch_fn(cfg, args.seq, args.batch, dev),
                      device=dev)
    step, _, _, metrics = trainer.run()
    print(f"finished at step {step}: loss={float(metrics['loss']):.4f}")
    return step, metrics


if __name__ == "__main__":
    main()
