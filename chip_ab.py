#!/usr/bin/env python3
"""Compare the port's attention kernels between checkouts on one card.

    python3 chip_ab.py OTHER_ROOT [THIS_ROOT ...]   # THIS_ROOT defaults to .
    python3 chip_ab.py --kernels OTHER_ROOT [...]   # no serving runs

Each tree's CUDA sources are built by that tree's own
``repro_torch.kernels.build`` (into its own ``build/kernels``), and each
tree is timed in a fresh process, in turns A, B, B, A (A = OTHER_ROOT;
with more trees A, B, C, C, B, A), so that a drift of the card's clock or
of its neighbours shows as a spread rather than as a difference. Every turn
times, through the public ops with the same seeded inputs:

- the paged kernel at qwen2-0.5b heads (14/2/64) and at gemma-2b heads
  (8/1/256), bf16, page 16, pool 1280 pages, batch 8, context <= 800:
  decode, batched prefill at T = 256, and the single-sequence entry point
  at T = 256; then decode at context 4096 (lengths 4033..4096, pool 2560
  pages);
- the flash kernel (bf16, causal, B = 1): qwen2-0.5b heads at S = 4096 and
  S = 32768, gemma-2b heads at S = 4096;

with ``chip_smoke.py``'s timing (``_timed``: CUDA events, the L2 flushed
before every call, the host's enqueue hidden behind a device spin, the
mean of the calls); then the p50 engine step of ``chip_smoke.py`` phases 4
and 9 (full-width qwen2-0.5b and gemma-2b greedy serving, their trace and
seeds, through ``chip_smoke.serve``), unless ``--kernels``. It prints one
line per turn and, last, the card's name and power limit. Nothing here
imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import chip_smoke

PS, POOL, B, T = 16, 1280, 8, 256
LONG_CTX, LONG_POOL = 4096, 2560
QWEN = (14, 2, 64)
GEMMA = (8, 1, 256)


def run(root: Path, serving: bool = True) -> dict[str, float]:
    """Times of the tree at ``root`` (this process imports its package)."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    chip_smoke.torch = torch
    timed = chip_smoke._timed

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.paged_attention import ops
    build.build_all()
    rng = np.random.default_rng(0)
    data = lambda shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).cuda().bfloat16()
    ints = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
        .cuda()

    def tables(need):
        t = np.zeros((B, 50), np.int32)
        for i, n in enumerate(need):
            t[i, :n] = rng.choice(POOL, n, replace=False)
        return t

    out = {}
    for nq, nkv, h in (QWEN, GEMMA):
        kp, vp = data((POOL, PS, nkv, h)), data((POOL, PS, nkv, h))
        lens = rng.integers(128, 801, B)
        q, tb, ln = data((B, nq, h)), ints(tables(-(-lens // PS))), \
            ints(lens)
        out[f"paged decode h{h} B8"] = timed(
            lambda: ops.paged_attention(q, kp, vp, tb, ln), 30)
        qs = rng.integers(0, 800 - T + 1, B)
        q4, tb, qst = data((B, T, nq, h)), \
            ints(tables(-(-(qs + T) // PS))), ints(qs)
        out[f"paged prefill h{h} B8 T256"] = timed(
            lambda: ops.paged_prefill_attention_batch(q4, kp, vp, tb, qst),
            30)
        q1, tb1, qs1 = q4[0].contiguous(), tb[0].contiguous(), qst[:1]
        out[f"paged prefill h{h} B1 T256"] = timed(
            lambda: ops.paged_prefill_attention(q1, kp, vp, tb1, qs1), 30)
        del kp, vp
        kp, vp = data((LONG_POOL, PS, nkv, h)), data((LONG_POOL, PS, nkv, h))
        lens = rng.integers(LONG_CTX - 63, LONG_CTX + 1, B)
        t4 = np.zeros((B, LONG_CTX // PS), np.int32)
        for i, n in enumerate(-(-lens // PS)):
            t4[i, :n] = rng.choice(LONG_POOL, n, replace=False)
        q, tb, ln = data((B, nq, h)), ints(t4), ints(lens)
        out[f"paged decode h{h} B8 ctx4096"] = timed(
            lambda: ops.paged_attention(q, kp, vp, tb, ln), 30)
    for (nq, nkv, h), s, iters in ((QWEN, 4096, 30), (QWEN, 32768, 7),
                                   (GEMMA, 4096, 30)):
        fq, fk, fv = (data((1, s, n, h)) for n in (nq, nkv, nkv))
        out[f"flash h{h} S{s}"] = timed(
            lambda: fops.flash_attention(fq, fk, fv), iters)
    del kp, vp, fq, fk, fv
    if not serving:
        return out
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.models.lm import LM
    chip_smoke.kernel, chip_smoke.fkernel = kernel, fkernel
    for arch in ("qwen2-0.5b", "gemma-2b"):
        cfg = registry.get_config(arch)
        params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                              device="cuda")
        prng = np.random.default_rng(0)
        prompts = [prng.integers(1, cfg.vocab_size, n).tolist()
                   for n in prng.integers(128, 769, 8)]
        r = chip_smoke.serve(cfg, params, torch.device("cuda"), prompts)
        out[f"{arch} serving p50 step"] = float(np.median(r["step_s"])) * 1e3
        del params
    return out


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--run":
        print(json.dumps(run(Path(argv[1]).resolve(), "--kernels" not in
                             argv)), flush=True)
        return 0
    import torch
    flags = [a for a in argv if a == "--kernels"]
    roots = [Path(a).resolve() for a in argv if a != "--kernels"]
    if not torch.cuda.is_available() or not roots:
        print("chip_ab: needs a CUDA card and OTHER_ROOT [THIS_ROOT ...]")
        return 2
    if len(roots) == 1:
        roots.append(Path(".").resolve())
    for root in roots + roots[::-1]:
        r = subprocess.run([sys.executable, __file__, "--run", str(root),
                            *flags], capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            print(r.stdout[-2000:], r.stderr[-4000:])
            return 1
        times = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"{root}: " + ", ".join(f"{k} {v:.5f} ms"
                                      for k, v in times.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
