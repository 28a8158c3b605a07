#!/usr/bin/env python3
"""Compare the port's kernels between checkouts on one card.

    python3 chip_ab.py OTHER_ROOT [THIS_ROOT ...]   # THIS_ROOT defaults to .
    python3 chip_ab.py --kernels OTHER_ROOT [...]   # no serving runs
    python3 chip_ab.py --plans       # this tree's weight product by plan

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
- the row-invariant weight product (bf16) at ``chip_smoke.py`` phase
  25's 15 shapes (qwen2-0.5b, gemma-2b, qwen2-vl-7b) at M 8, 40 and 256,
  each beside ``torch.matmul`` on the same inputs, and the wrapper's host
  microseconds a call;
- the residual add and the norm that reads it (bf16, fp32 gamma) at the
  three models' widths (896, 2048, 3584) and M 8, 40 and 256: the tree's
  fused ``add_rmsnorm`` where it has one, else torch's ``x + y`` then its
  ``rmsnorm`` (``add+norm``), and in every tree torch's add then the
  launch without ``y`` (``x + y, norm``); beside them, the floor these
  timings cannot go below: torch's add alone (``torch add``) and a launch
  that does no work (``empty launch``, ``torch.cuda._sleep(0)``);

with ``chip_smoke.py``'s timing (``_timed``: CUDA events, the L2 flushed
before every call, the host's enqueue hidden behind a device spin, the
mean of the calls); then the p50 engine step, the p50 of the steps that
ran a decode and of those that ran a prefill chunk, of ``chip_smoke.py``
phases 4 and 9 (full-width qwen2-0.5b and gemma-2b greedy serving, their
trace and seeds, through ``chip_smoke.serve``), unless ``--kernels``:
each model serves ``SERVE_RUNS`` times and the p50s are over the steps of
all runs but the first (the first run of a process pays its one-time
costs); then the device kernels a decode step, from ``chip_smoke.py``
phase 6's profile of each model. A tree from before the row-invariant
kernels (``kernels/rowwise_matmul``, ``kernels/rowwise_rmsnorm``) times
no product and no norm, serves with its own decoder and counts none of
their launches.
It prints one line per turn and, last, the card's name and power limit.
Nothing here imports JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import chip_smoke

PS, POOL, B, T = 16, 1280, 8, 256
LONG_CTX, LONG_POOL = 4096, 2560
QWEN = (14, 2, 64)
GEMMA = (8, 1, 256)
SERVE_RUNS = 3
KERNELS_A_STEP = "device kernels a decode step"     # phase 6's count


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
    out.update(products(torch, timed))
    out.update(norms(torch, timed))
    if not serving:
        return out
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.paged_attention import kernel
    from repro_torch.models.lm import LM
    chip_smoke.kernel, chip_smoke.fkernel = kernel, fkernel
    try:
        from repro_torch.kernels.rowwise_matmul import kernel as rkernel
        from repro_torch.kernels.rowwise_rmsnorm import kernel as nkernel
    except ImportError:          # a tree from before them
        rkernel = nkernel = types.SimpleNamespace(
            LAUNCHES={}, reset_launch_counts=lambda: None)
    chip_smoke.rkernel, chip_smoke.nkernel = rkernel, nkernel
    for arch in ("qwen2-0.5b", "gemma-2b"):
        cfg = registry.get_config(arch)
        params = LM(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                              device="cuda")
        prng = np.random.default_rng(0)
        prompts = [prng.integers(1, cfg.vocab_size, n).tolist()
                   for n in prng.integers(128, 769, 8)]
        runs = [chip_smoke.serve(cfg, params, torch.device("cuda"), prompts)
                for _ in range(SERVE_RUNS)][1:]
        for what, key in (("step", "step_s"), ("decode step", "decode_s"),
                          ("prefill step", "prefill_s")):
            out[f"{arch} serving p50 {what}"] = \
                float(np.median([t for r in runs for t in r[key]])) * 1e3
        out[f"{arch} {KERNELS_A_STEP}"] = chip_smoke.phase_profile(
            torch.device("cuda"), cfg, params)
        del params
    return out


def norms(torch, timed) -> dict[str, float]:
    """The residual add and the norm that reads it (bf16 x and y, fp32
    gamma) at the three served widths and M 8, 40, 256: the tree's fused
    launch where it has one, else torch's add then its norm; and torch's
    add then the launch without ``y`` in every tree; torch's add alone
    and an empty launch, the floor of the timing."""
    try:
        from repro_torch.kernels.rowwise_rmsnorm import kernel as nkernel
    except ImportError:          # a tree from before it
        return {}
    fused = getattr(nkernel, "add_rmsnorm", None)
    if fused is None:            # a tree from before the fused launch
        fused = lambda x, y, g, eps: (None, nkernel.rmsnorm(x + y, g, eps))
    gen = torch.Generator(device="cuda").manual_seed(33)
    out = {"empty launch": timed(lambda: torch.cuda._sleep(0))}
    for d in (896, 2048, 3584):
        x, y = (torch.randn(256, d, generator=gen, device="cuda").bfloat16()
                for _ in range(2))
        g = torch.randn(d, generator=gen, device="cuda") * 0.1
        for m in (8, 40, 256):
            xm, ym = x[:m], y[:m]
            out[f"add+norm d{d} M{m}"] = timed(
                lambda: fused(xm, ym, g, 1e-6))
            out[f"x + y, norm d{d} M{m}"] = timed(
                lambda: nkernel.rmsnorm(xm + ym, g, 1e-6))
            out[f"torch add d{d} M{m}"] = timed(lambda: xm + ym)
    return out


def products(torch, timed) -> dict[str, float]:
    """The row-invariant weight product (bf16) at ``chip_smoke.py`` phase
    25's shapes and timed row counts, beside ``torch.matmul`` on the same
    inputs, and the wrapper's host microseconds a call (M 8, the K/V
    projection of qwen2-0.5b, ``chip_smoke._host_us``)."""
    try:
        from repro_torch.kernels.rowwise_matmul import kernel as rkernel
    except ImportError:          # a tree from before it
        return {}
    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {}
    for (k, n, tied), _ in chip_smoke._row_products().items():
        a = torch.randn(max(chip_smoke.ROW_TIMED), k, generator=gen,
                        device="cuda").bfloat16()
        scale = 0.02 if tied else k ** -0.5
        w = (torch.randn(n, k, generator=gen, device="cuda") * scale) \
            .bfloat16().T
        for m in chip_smoke.ROW_TIMED:
            out[f"rowwise {k}x{n} M{m}"] = timed(
                lambda: rkernel.rowwise_matmul(a[:m], w))
            out[f"torch.matmul {k}x{n} M{m}"] = timed(
                lambda: torch.matmul(a[:m], w))
        if (k, n) == (896, 128):
            out["rowwise host us a call"] = chip_smoke._host_us(
                lambda: rkernel.rowwise_matmul(a[:8], w))
        del a, w
    return out


def plans() -> int:
    """``--plans``: this tree's bf16 product at phase 25's shapes under
    other plans than ``plan(N, K)``'s (each width, unsplit and split to
    reach the SM count), at M 8, 40 and 256, each row's time beside the
    chosen plan's; at M 256 the chosen plan under each tile a launch of
    more than 64 rows can take, beside the one the kernel picks; then the
    wrapper's host microseconds a call, whole and without its launch."""
    import torch
    chip_smoke.torch = torch
    sys.path.insert(0, str(Path(".").resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.rowwise_matmul import kernel as rkernel
    build.build_all()
    force = build.library("rowwise_matmul").bwap_rowwise_force_shape
    force.argtypes = [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(25)
    chosen = rkernel.plan
    for (k, n, tied), users in chip_smoke._row_products().items():
        a = torch.randn(256, k, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(n, k, generator=gen, device="cuda")
             * (0.02 if tied else k ** -0.5)).bfloat16().T
        want = torch.matmul(a.float(), w.float())
        steps = -(-k // rkernel.BK)
        cands = {chosen(n, k, sms)}
        for bn in rkernel.WIDTHS:
            cands |= {(bn, 1), (bn, min(-(-sms // -(-n // bn)), steps))}
        for bn, splits in sorted(cands):
            rkernel.plan = lambda n_, k_, s_, p=(bn, splits): p
            rkernel._PLANS.clear()
            got = rkernel.rowwise_matmul(a, w).float()
            err = float((got - want).abs().max())
            times = [chip_smoke._timed(
                lambda: rkernel.rowwise_matmul(a[:m], w))
                for m in chip_smoke.ROW_TIMED]
            mark = " (plan)" if (bn, splits) == chosen(n, k, sms) else ""
            print(f"plans {k}x{n} BN {bn} splits {splits}{mark}: " + ", ".join(
                f"M{m} {t:.5f}" for m, t in zip(chip_smoke.ROW_TIMED, times))
                + f" ms; max |err| vs fp32 {err:.4g}", flush=True)
        rkernel.plan = chosen
        rkernel._PLANS.clear()
        bn, splits = chosen(n, k, sms)
        shapes = []
        for rows, t in sorted({(64, bn), (128, bn), (128, max(bn, 128))}):
            for dist in (0, 1):
                if (dist and splits == 1) or \
                        (not dist and splits > 1 and t > 64):
                    continue
                force(rows, t, dist)
                ms = chip_smoke._timed(lambda: rkernel.rowwise_matmul(a, w))
                shapes.append(f"{rows}x{t}{' dist' if dist else ''} "
                              f"{ms:.5f}")
        force(0, 0, 0)
        picked = chip_smoke._timed(lambda: rkernel.rowwise_matmul(a, w))
        print(f"plans {k}x{n} M256 by tile: " + ", ".join(shapes)
              + f" ms; picked {picked:.5f}", flush=True)
        if (k, n) == (896, 128):
            whole = chip_smoke._host_us(
                lambda: rkernel.rowwise_matmul(a[:8], w))
            entry = rkernel._entry
            rkernel._entry = lambda: (lambda *args: 0)
            py = chip_smoke._host_us(lambda: rkernel.rowwise_matmul(a[:8], w))
            rkernel._entry = entry
            print(f"plans host us a call (M 8, {k}x{n}): wrapper {whole:.2f}"
                  f", without the C call {py:.2f}", flush=True)
        del a, w, want
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


def _shown(key: str, value: float) -> str:
    """A result with its unit: a count, microseconds or milliseconds."""
    if key.endswith(KERNELS_A_STEP):
        return f"{key} {value:g}"
    return f"{key} {value:.5f}" + ("" if key.endswith(" us a call")
                                   else " ms")


def main(argv: list[str]) -> int:
    if argv == ["--plans"]:
        return plans()
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
        print(f"{root}: " + ", ".join(_shown(k, v) for k, v in times.items()),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
