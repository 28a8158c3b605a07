#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on a GPU.

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases (each failed check raises; the script then exits non-zero):

1. environment and build: torch/CUDA versions, the card's name and power
   limit, the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together); ptxas registers,
   spills and dynamic shared memory per kernel instance, and ptxas's
   performance warnings (serialised wgmma in a tensor-core instance fails
   the phase); the bf16 flash instances and the bf16 paged instances at
   h = 64, 128, 256 (four a head dim: the split and the serial route, each
   with two walking consumer warpgroups or one) must hold HGMMA
   (tensor-core) instructions in their SASS;
2. every kernel against its plain PyTorch version on the card: the paged
   kernel per instance at the serving shapes (qwen2-0.5b heads, h = 128 and
   gemma-2b heads in bf16 on the tensor-core instance, at contexts up to
   800 and, on a pool of 2560 pages, up to 4096, where decode splits into
   up to 22 key chunks; qwen2-0.5b heads and the smoke shapes in fp32 on
   the CUDA-core instance), each with three bitwise properties (at both
   lengths on the tensor-core instance, where the split and the serial
   route must also give the same bits, and a T = 1 launch must equal row 0
   of a T > 1 launch on either route), and qwen2-0.5b heads in bf16 at
   page size 4 (phase 10's pool: 16 pages a 64-key tile); the flash kernel
   over the
   reference test's sweep (MHA, GQA, MQA, small S, windows, non-causal),
   its bf16 instances at every head dim (ragged T, S < T, S > T, windows,
   non-causal, B > 1) and the prefill shapes (qwen2-0.5b and gemma-2b
   heads, bf16, S = T = 4096, and S != T), each case on the instance its
   dtype and head dim select, plus bitwise suffix and batch invariance;
3. timing with CUDA events (L2 flushed before every launch, the host's
   enqueue hidden behind a device spin) of kernel, plain version and a
   ``scaled_dot_product_attention`` yardstick, beside the least time the
   card could take (bytes at the HBM rate, or flops at the card's dense
   peak for the input type, whichever is larger); the paged rows at
   qwen2-0.5b, gemma-2b and qwen2-vl-7b heads, and decode at context 4096
   at each; flash at S = T = 4096 at qwen2-0.5b, gemma-2b, qwen2-vl-7b
   and granite-moe-3b-a800m heads (the last two held against the plain
   version on the timed inputs, as the qwen2-vl-7b paged rows);
4. full-width qwen2-0.5b serving (24 layers, seeded random weights) through
   ``ServeEngine`` on the BWAP pool: 8 requests x 32 new tokens, launch
   counters zeroed just before and read just after, every paged launch on
   the instance its dtype and head dim select; one decode step is also
   run through the plain version and the logits compared (within 0.1, and
   on every row a token that is an argmax of both versions: bf16 logits
   can tie exactly in either, and a tie passes either token; the gate of
   phases 4, 7 and 9-12);
5. speculative decode at full width on a repetition-friendly trace, counters
   zeroed again, verify steps through the prefill kernel;
6. a ``torch.profiler`` window over 3 full-width decode steps: the device's
   busy share and the kernels that fill it (informational);
7. full-width prefill: ``LM.prefill`` and ``make_eval_step`` of qwen2-0.5b
   (B = 4) and gemma-2b (B = 1) at S = 4096, every layer's attention
   through the flash kernel's tensor-core instance (counters zeroed before
   each forward, exactly ``num_layers`` launches), then the same forwards
   through the plain chunked path: last-token logits and loss compared; a
   profiler window over the kernel forward (informational); then
   qwen2-0.5b's loss under autograd (B = 1, S = 512): with
   ``attn_impl=None`` and ``"flash"`` the forward launches the kernel and
   the backward raises (the kernel has no backward), and with
   ``"reference"`` no kernel launches and the grads reach wq, wk, wv;
8. recompute-prefill serving: phase 4's trace with
   ``incremental_prefill=False``, every recompute chunk a 24-layer forward
   through the flash kernel;
9. full-width gemma-2b serving (18 layers, head dim 256): phase 4 on
   gemma-2b, every paged launch on the tensor-core instance (48-key tiles
   at h = 256), then phase 6's profile on gemma-2b;
10. ``coda`` serving at full width: qwen2-0.5b (phase 4's weights) on
   ``benchmarks/torch_scheduler_bench.coda_compare``'s trace and pool
   (page 4; Eq.-1 bandwidths x 48, the full-width page's bytes over the
   smoke page's, so the schedule is the smoke run's), once under ``coda``
   with an observatory (tracer, heat) and once under ``bwap_dwp``, counts
   zeroed before each: every request finishes and every page comes back;
   ``coda`` re-homes pages and splits decode steps, ``bwap_dwp`` neither;
   every paged decode launch is one micro-batch of one layer; each
   re-homed page's K/V equal its source's bit for bit; on the first
   multi-launch step and the first after a re-homing, each micro-batch's
   logits hold the plain version's (phase 4's gate) and its attention
   rows equal one full-batch launch's bit for bit; the tracer holds each
   request's spans and one ``rehome`` span a re-homing step. Printed: the
   counters beside ``BENCH_coda.json``'s, token agreement of the two
   policies, p50 step times and launches a step, and the observatory's
   host cost (5 interleaved pairs with and without it: best of each,
   median paired difference, and the spread of the runs without it);
11. the persistence tier at full width: qwen2-0.5b (phase 4's weights)
   through ``benchmarks/torch_scheduler_bench.persist_run`` (page 4;
   domain and tier bandwidths x 48, as phase 10): an engine serves the
   warmup, pins and exports the two preamble chains to a prefix store in a
   temporary directory and serves the trace on; a restarted engine imports
   the store (warm), another starts empty (cold). Gates: chains, restored
   pages, first-step prefix hits and steps equal ``BENCH_persist.json``'s;
   the warm restart's tokens equal the uninterrupted engine's; the warm
   engine's first decode step over restored pages holds the plain
   version's logits (phase 4's gate). Then, on pages of that prefill:
   demote 2 of 4 parked pages and promote them back, bit-equal; a 12-page
   range through ``export_range``, the wire and ``import_range`` into a
   second pool on the card, bit-equal, its sha256 the host copy's.
   Printed: the cold restart's token agreement, the TTFT ratio beside
   ``BENCH_persist.json``'s, synchronised wall ms of each step;
12. prefill/decode disaggregation at full width: ``disagg_run`` (a prefill
   host at page 4 hands each prompt's range over the Eq.-5-striped wire to
   a decode host at page 8; every Eq.-1 bandwidth x 48, the wire's links
   too, and the wire's chunk size, so a handoff takes the smoke run's
   chunks). Gates: 10 handoffs, 10 converted imports, 0 fallbacks, both
   fabrics' invariants; the first handoff's re-chunked K/V equal the
   prefill host's token for token; the decode host's first decode step
   over imported pages holds the plain logits. Printed: token agreement
   with the single host, wire bytes beside ``BENCH_disagg.json``'s, and
   the wall ms a handoff spends in export, serialize, deserialize,
   convert and import;
13. the page-geometry zoo at full width: ``zoo_run`` (``zoo_compare``'s
   setup) with qwen2-0.5b (phase 4's weights, page 4, 49152 B a page) as
   the chat tenant, the arena's capacities and bandwidths x 48, under the
   capacity market and under static partitions, counts zeroed before
   each; the SSM and ASR tenants keep the smoke configs' geometries (the
   published ones do not fit the x 48 arena) and run no model. Gates: 12
   finished and 0 failed in each mode, at least one idle lender, granted
   equal to repaid with nothing outstanding, funding restored, no grant
   under static partitions, the zoo's invariants after every step, SSM
   and ASR digests equal across the modes and to the CPU smoke run's,
   the first decode step's logits against the plain version (phase 4's
   gate), every paged launch on the tensor-core instance. Printed: steps,
   goodput ratio and granted bytes beside ``BENCH_zoo.json``'s, token
   agreement of the two modes, p50 zoo step;
14. the placement executor on the card: ``torch_placement_bench.suite``
   at ``benchmarks/run.py``'s size (batched moves equal looped ones bit
   for bit, >= 5x faster), then 1024 moves at qwen2-0.5b's full-width
   pool geometry in bf16 (equal bit for bit; times and GB/s beside the
   bound of the bytes read and written at the HBM rate); allocation
   pages/s;
15. dense decode (``LM.init_cache``/``decode_step``) at full width: for
   qwen2-0.5b (phase 4's weights) and gemma-2b (phase 9's), an engine
   serves 8 prompts until each has prefilled, each sequence's K/V is
   copied from its pool pages into a dense cache, and one decode step runs
   through ``PagedDecoder.decode_step`` (the paged kernel) and through
   ``LM.decode_step`` on the same K/V, one sequence at a time (B = 1; the
   rows' positions differ and ``decode_step`` takes one), logits held by
   phase 4's gate; then, for qwen2-0.5b, 16 more tokens through both
   (equal tokens printed, not gated). gemma3-27b at full width with depth
   cut to 6 layers (5 windowed at 1024, 1 global; bf16 params) decodes an
   1100-token prompt token by token, and its logits at positions
   1022-1026 and 1095-1099 are held against ``LM.hidden`` over the whole
   prompt (the flash kernel with ``window=1024``) by the same gate, each
   logit's bound the larger of 0.1 and one bf16 ulp of the logit (each
   token's own logit reaches ~74, where an ulp is 0.5); the same forward
   blind to the window must miss that gate at 1095-1099. Printed: the
   gaps, ties, equal tokens, ms a ``decode_step``, the window-blind
   gaps;
16. the MoE, MLA and VLM families at full width, each model freed before
   the next is built: qwen2-vl-7b (28 layers, d 3584, 28/4 heads of 128;
   bf16 params, the config's default being fp32) served as phase 4
   (every paged launch on the h = 128 tensor-core instance, launches
   printed per entry point, one decode step against the plain version),
   then ``LM.prefill`` at B = 1 over the published 1024 stub patches
   (random, seed 3) and 1024 tokens: exactly 28 flash launches, logits
   against the chunked path's; granite-moe-3b-a800m (32 layers, 40
   experts top-8 padded to 48, fp32 params): prefill and loss at B = 1,
   S = 4096, exactly 32 flash launches a forward, logits (0.1) and loss
   (1e-2) against the chunked path's with the kernel path's expert
   choices replayed (``_Routing``: bf16 routing flips on near-tied
   router probabilities otherwise separate two correct paths; the gaps
   with each path's own routing are printed, the loss gated on both),
   then ``decode_step`` over 64 tokens at a capacity factor with no
   drops (``num_experts / top_k``), the forward's routing replayed,
   against the kernel forward at positions 59-63; deepseek-v3-671b cut
   to 4 of 61 layers (3 dense, 1 MoE of 256 experts; MLA; the MTP head;
   bf16 params, the config's): the loss with MTP at S = 512 finite,
   then MLA's absorbed ``decode_step`` over 64 tokens against the
   materialised forward the same way. Printed: each part's wall time,
   ms a forward and a ``decode_step``.

The second-to-last lines are the kernels' JSON record (a row per entry
point at qwen2-0.5b, gemma-2b and qwen2-vl-7b heads and flash at
granite-moe-3b-a800m heads, each naming its instance and context, and
the context-4096 decode rows; the rows at qwen2-vl-7b and granite heads
carry the error of their phase-3 inputs against the plain version, and
their launches from phase 16; the qwen2-0.5b
paged rows also carry phases 10-13's ``coda_launches``,
``persist_launches``, ``disagg_launches`` and ``zoo_launches``, the last
summed over the zoo's two modes) and the card's
``nvidia-smi`` name and power limit; the last
line is the result JSON. Nothing here imports JAX: the machine with the
card has none.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense, 700 W)
HBM_BYTES_PER_S = 3.35e12        # device memory
PEAK_FLOPS = {"bfloat16": 989e12,   # tensor cores
              "float32": 67e12}     # CUDA cores
CUDA_CORE_FLOPS = 67e12          # fp32 FMA on CUDA cores: what this kernel uses
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # tests/test_kernels.py: ceiling
# kernel vs plain version in bf16: both accumulate in fp32 and round to bf16
# once, so also |err| <= 2^-6 |want| + 1e-4 (two bf16 ulps of the plain
# value; 1e-4 covers fp32 reordering next to zero)
BF16_ULPS = (2.0 ** -6, 1e-4)
LOGIT_TOL = 0.1                  # |kernel - plain| on full-width bf16 logits
LOSS_TOL = 1e-2                  # |kernel - plain| on the full-width loss
PS = 16                          # serving page size
MAIN = dict(nq=14, nkv=2, h=64)  # qwen2-0.5b attention heads
SMOKE = dict(nq=4, nkv=2, h=16)  # qwen2 smoke config heads
GEMMA = dict(nq=8, nkv=1, h=256)  # gemma-2b attention heads
GEMMA3 = dict(nq=32, nkv=16, h=128)  # gemma3-27b attention heads
QWEN_VL = dict(nq=28, nkv=4, h=128)  # qwen2-vl-7b attention heads
GRANITE = dict(nq=24, nkv=8, h=64)   # granite-moe-3b-a800m attention heads
# phase 2's paged sweep: each instance at serving shapes (tensor cores:
# bf16 at h 64, 128, 256; CUDA cores: fp32)
PAGED_SWEEP = ((MAIN, "bfloat16"), (GEMMA3, "bfloat16"), (GEMMA, "bfloat16"),
               (MAIN, "float32"), (SMOKE, "float32"))
LONG_CTX, LONG_POOL = 4096, 2560  # the long-context paged cases and rows
PREFILL_S = 4096                 # train_4k's sequence length
LONG_S = 32768                   # prefill_32k's sequence length
FLUSH_BYTES = 64 << 20           # > the H100's 50 MB L2
SPIN_CYCLES = 1_000_000          # ~0.5 ms at the H100's clock

torch = None
kernel = ops = None              # paged attention
fkernel = fops = None            # flash attention


class SmokeFailure(RuntimeError):
    """A check of this script failed."""


def check(ok, msg) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# -- phase 1 -----------------------------------------------------------------

def phase_build() -> None:
    from repro_torch.kernels import build
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    log(f"card: {smi_line()}  ({torch.cuda.device_count()} visible)")
    secs = build.build_all()
    log(f"build: {secs:.1f} s (nvcc, sm_90a) of "
        f"{sorted(p.name for p in build.CSRC.glob('*.cu'))}")
    if not build.LOGS:
        log("  built before this run: no ptxas report (a fresh checkout "
            "builds and reports)")
    for name, out in build.LOGS.items():
        for fn, regs, spill in _ptxas_report(build, out):
            smem = ""
            m = re.match(r"(flash|paged)_(?:walk_|wgmma_)?kernel<"
                         r"(?:(float|__nv_bfloat16), )?(\d+)(?:, \w+)*>", fn)
            if m:
                dtype = torch.float32 if m.group(2) == "float" else \
                    torch.bfloat16
                h = int(m.group(3))
                smem = (f"; {fkernel.smem_bytes(dtype, h)} bytes dynamic "
                        f"shared memory" if m.group(1) == "flash" else
                        f"; {kernel.smem_bytes(dtype, h, PS)} bytes dynamic "
                        f"shared memory at page {PS}")
            log(f"  ptxas[{name}] {fn}: {regs}; {spill}{smem}")
        # ptxas's performance warnings; serialised wgmma (C7510-C7520)
        # in a tensor-core instance fails the phase
        for line in out.splitlines():
            if "(C75" in line:
                log(f"  ptxas[{name}] {line.split('info', 1)[-1].strip()}")
                check("serialized" not in line or "wgmma_kernel" not in line,
                      f"ptxas serialised a tensor-core instance's wgmma: "
                      f"{line.strip()}")
    _check_tensor_cores(build, "flash_attention", "flash_wgmma_kernel",
                        len(fkernel.WGMMA_HEAD_DIMS))
    # a paged instance per head dim, route, and block shape (two consumer
    # warpgroups, or one for launches of at most 64 rows)
    _check_tensor_cores(build, "paged_attention", "paged_wgmma_kernel",
                        len(kernel.WGMMA_HEAD_DIMS) * len(kernel.ROUTES) * 2)
    for h in kernel.WGMMA_HEAD_DIMS:
        check(kernel.layout(h) == (kernel.TILE_KEYS[h], kernel.CHUNK_TILES[h]),
              f"paged h={h}: built layout {kernel.layout(h)} != the "
              f"wrapper's (keys a tile, tiles a chunk)")
    log("paged tensor-core layout (keys a tile, tiles a key chunk): "
        + ", ".join(f"h {h}: {kernel.TILE_KEYS[h]}, {kernel.CHUNK_TILES[h]}"
                    for h in kernel.WGMMA_HEAD_DIMS))


def _ptxas_report(build, out) -> list[tuple[str, str, str]]:
    """(kernel, registers, spills) for each entry function in nvcc's
    ``-Xptxas -v`` output, kernel names demangled where ``cu++filt`` is
    found."""
    rows, fn, spill = [], None, ""
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn is not None:
            rows.append((fn, line.split(":", 1)[-1].strip(), spill))
            fn = None
    names = _short_names(build, [r[0] for r in rows])
    return [(n, regs, spill) for n, (_, regs, spill) in zip(names, rows)]


def _short_names(build, mangled: list[str]) -> list[str]:
    """Kernel names as ``name<template args>``, demangled with ``cu++filt``
    where it is found (else as they came)."""
    try:
        names = subprocess.run(
            [build.cuda_tool("cu++filt")], input="\n".join(mangled),
            capture_output=True, text=True, check=True, timeout=60
        ).stdout.splitlines()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        names = mangled
    if len(names) != len(mangled):
        names = mangled
    short = []
    for n in names:
        # name<args>( ... ): template arguments may print as "(int)256"
        m = re.search(r"(\w+)<(.*?)>\(", n)
        args = re.sub(r"[(][\w ]+[)]", "", m.group(2)) if m else ""
        short.append(f"{m.group(1)}<{args}>" if m else n)
    return short


def _check_tensor_cores(build, lib, tc_kernel, n_tc) -> None:
    """The ``n_tc`` tensor-core instances of library ``lib`` (the kernels
    named ``tc_kernel``) have HGMMA instructions in their SASS
    (``cuobjdump -sass``)."""
    so = build.library_path(lib)
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    wgmma = {k: v for k, v in counts.items() if tc_kernel in k}
    names = _short_names(build, list(counts))
    log(f"SASS of {so.name}: HGMMA instructions per kernel "
        + ", ".join(f"{n} {v}" for n, v in zip(names, counts.values())))
    check(len(wgmma) == n_tc and all(v > 0 for v in wgmma.values()),
          f"the tensor-core instances of {lib} lack HGMMA: {wgmma}")


# -- inputs --------------------------------------------------------------------

def _data(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to("cuda").to(getattr(torch, dtype))


def _ints(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to("cuda")


def _pools(rng, pool, nkv, h, dtype, ps=PS):
    return (_data(rng, (pool, ps, nkv, h), dtype),
            _data(rng, (pool, ps, nkv, h), dtype))


def _tables(rng, need, mp, pool, repeat=True):
    """Each row covers ``need[b]`` pages (random, repeats allowed when
    ``repeat``), padded with page 0 to width ``mp``."""
    t = np.zeros((len(need), mp), np.int32)
    for b, n in enumerate(need):
        t[b, :n] = (rng.integers(0, pool, n) if repeat
                    else rng.choice(pool, n, replace=False))
    return t


# -- phase 2 -----------------------------------------------------------------

def _max_err(out, want, dtype) -> float:
    """max |out - want|, after checking |out - want| <= tol + tol * |want|
    elementwise (test_kernels.py's rtol = atol) and, in bf16, within two
    bf16 ulps of ``want`` (``BF16_ULPS``)."""
    out, want = out.float(), want.float()
    diff = (out - want).abs()
    tol = TOL[dtype]
    check(out.shape == want.shape
          and bool((diff <= tol + tol * want.abs()).all()),
          f"kernel vs plain: max |err| {float(diff.max())} ({dtype})")
    if dtype == "bfloat16":
        rel, ab = BF16_ULPS
        check(bool((diff <= ab + rel * want.abs()).all()),
              f"kernel vs plain: bf16 error beyond two ulps, max |err| "
              f"{float(diff.max())}")
    return float(diff.max())


def _vs_plain(errs, name, dtype, h, call) -> None:
    """``call(None)`` launches the paged entry point ``name`` once, on the
    instance its dtype and head dim select; ``call("reference")`` runs the
    plain version. The error is kept per entry point, per instance, and per
    (entry point, dtype, head dim)."""
    inst = kernel.instance(getattr(torch, dtype), h)
    n0 = kernel.LAUNCHES[inst]
    out = call(None)
    check(kernel.LAUNCHES[inst] == n0 + 1,
          f"{name} ({dtype}, h={h}) did not launch the {inst} instance")
    err = _max_err(out, call("reference"), dtype)
    for key in (name, inst, (name, dtype, h)):
        errs[key] = max(errs.get(key, 0.0), err)


def phase_correctness() -> dict:
    """The paged sweep; returns max |err| by entry point, by instance, and
    by (entry point, dtype, head dim)."""
    rng = np.random.default_rng(1)
    errs = dict.fromkeys(kernel.LAUNCHES, 0.0)
    for heads, dtype in PAGED_SWEEP:
        nq, nkv, h = heads["nq"], heads["nkv"], heads["h"]
        b = 8
        # contexts up to 800, and up to 4096 on the tensor-core instance
        # (up to 22 key chunks: decode splits, T = 256 walks serially)
        ctxs = (800, LONG_CTX) if kernel.instance(
            getattr(torch, dtype), h) == "paged_walk_wgmma" else (800,)
        for ctx in ctxs:
            pool = 1280 if ctx == 800 else LONG_POOL
            mp = ctx // PS + 10
            kp, vp = _pools(rng, pool, nkv, h, dtype)
            # decode: lengths on and next to page edges, up to ctx tokens
            lens = np.asarray([1, 15, 16, 17, 256, 257, ctx - 1, ctx],
                              np.int32)
            if ctx > 800:
                lens[4:6] = (1217, 2931)
            tbl = _ints(_tables(rng, -(-lens // PS), mp, pool))
            q = _data(rng, (b, nq, h), dtype)
            _vs_plain(errs, "paged_attention", dtype, h,
                      lambda impl: ops.paged_attention(q, kp, vp, tbl,
                                                       _ints(lens),
                                                       impl=impl))
            # prefill / verify chunks at ragged starts, context up to ctx
            for t in (256, 7, 1):
                qs = np.asarray([0, 15, 16, 17, 240, 287, 500, 800 - t],
                                np.int32)
                if ctx > 800:
                    qs[5:] = (1500, 3000, ctx - t)
                tb = _ints(_tables(rng, -(-(qs + t) // PS), mp, pool))
                q = _data(rng, (b, t, nq, h), dtype)
                _vs_plain(errs, "paged_prefill_attention_batch", dtype, h,
                          lambda impl: ops.paged_prefill_attention_batch(
                              q, kp, vp, tb, _ints(qs), impl=impl))
            if ctx == 800:
                q = _data(rng, (37, nq, h), dtype)
                tb1 = _ints(_tables(rng, [5], 5, pool)[0])
                _vs_plain(errs, "paged_prefill_attention", dtype, h,
                          lambda impl: ops.paged_prefill_attention(
                              q, kp, vp, tb1, 40, impl=impl))
            _bitwise(rng, kp, vp, pool, heads, dtype, ctx)
            del kp, vp
    _page4_cases(rng, errs)
    torch.cuda.synchronize()
    log("kernel vs plain version: max |err| " + ", ".join(
        f"{k} {errs[k]:.3g}" for k in kernel.LAUNCHES)
        + f" (tolerance {TOL['float32']} fp32 / {TOL['bfloat16']} bf16, "
        f"and bf16 within {BF16_ULPS[0]} |want| + {BF16_ULPS[1]})")
    return errs


def _page4_cases(rng, errs) -> None:
    """qwen2-0.5b heads in bf16 at page size 4 (phase 10's pool): 16 pages
    in each 64-key tile of the tensor-core gather. Decode, prefill and
    verify chunks at lengths on and next to page edges, up to 800 keys,
    against the plain version; then the bitwise properties."""
    ps, pool, ctx = 4, 1024, 800
    nq, nkv, h = MAIN["nq"], MAIN["nkv"], MAIN["h"]
    kp, vp = _pools(rng, pool, nkv, h, "bfloat16", ps)
    mp = ctx // ps + 10
    lens = np.asarray([1, 3, 4, 5, 47, 48, 81, ctx], np.int32)
    tbl = _ints(_tables(rng, -(-lens // ps), mp, pool))
    q = _data(rng, (8, nq, h), "bfloat16")
    _vs_plain(errs, "paged_attention", "bfloat16", h,
              lambda impl: ops.paged_attention(q, kp, vp, tbl, _ints(lens),
                                               impl=impl))
    for t in (32, 5, 1):
        qs = np.asarray([0, 3, 4, 5, 44, 47, 100, ctx - t], np.int32)
        tb = _ints(_tables(rng, -(-(qs + t) // ps), mp, pool))
        q = _data(rng, (8, t, nq, h), "bfloat16")
        _vs_plain(errs, "paged_prefill_attention_batch", "bfloat16", h,
                  lambda impl: ops.paged_prefill_attention_batch(
                      q, kp, vp, tb, _ints(qs), impl=impl))
    _bitwise(rng, kp, vp, pool, MAIN, "bfloat16", ctx, ps=ps)


def _bitwise(rng, kp, vp, pool, heads, dtype, ctx=800, ps=PS) -> None:
    """On the kernel, with rows up to position ``ctx``: a fully masked
    trailing page (and, at ``ctx`` > 800, a whole trailing key chunk)
    changes nothing; decode equals verify row 0; real rows do not change
    when the batch is padded with extra rows. On the tensor-core instance
    the split and the serial route give the same bits, and decode (a T = 1
    launch) equals row 0 of the T = 5 launch on each route."""
    nq, h = heads["nq"], heads["h"]
    b, t = 4, 5
    qs = np.asarray([37, 16, ctx - 10, 0 if ctx == 800 else ctx // 2],
                    np.int32)
    need = -(-(qs + t) // ps)
    wgmma = kernel.instance(getattr(torch, dtype), h) == "paged_walk_wgmma"
    extra = 3 if ctx == 800 or not wgmma else \
        kernel.CHUNK_TILES[h] * kernel.TILE_KEYS[h] // ps + 3
    base_t = _tables(rng, need, need.max(), pool, repeat=False)
    ext_t = np.concatenate([base_t, rng.integers(0, pool, (b, extra))
                            .astype(np.int32)], axis=1)
    q = _data(rng, (b, t, nq, h), dtype)
    base = ops.paged_prefill_attention_batch(q, kp, vp, _ints(base_t),
                                             _ints(qs))
    wide = ops.paged_prefill_attention_batch(q, kp, vp, _ints(ext_t),
                                             _ints(qs))
    check(torch.equal(base, wide), "trailing masked page changed bits")
    dec = ops.paged_attention(q[:, 0].contiguous(), kp, vp, _ints(base_t),
                              _ints(qs + 1))
    check(torch.equal(dec, base[:, 0]), "decode != verify row 0")
    if wgmma:
        for route in kernel.ROUTES:
            ver = kernel.paged_prefill_attention_batch(
                q, kp, vp, _ints(base_t), _ints(qs), route=route)
            one = kernel.paged_attention(q[:, 0].contiguous(), kp, vp,
                                         _ints(base_t), _ints(qs + 1),
                                         route=route)
            check(torch.equal(ver, base),
                  f"the {route} route changed bits (T = {t}, ctx {ctx})")
            check(torch.equal(one, ver[:, 0]),
                  f"T = 1 on the {route} route != row 0 of T = {t}")
        # a chunk of more than 64 rows: both consumer warpgroups walk
        q40 = _data(rng, (2, 40, nq, h), dtype)
        qs40 = _ints(np.minimum(qs[:2], need.max() * ps - 40))
        both = [kernel.paged_prefill_attention_batch(
            q40, kp, vp, _ints(base_t[:2]), qs40, route=route)
            for route in kernel.ROUTES]
        check(torch.equal(*both), f"the routes differ at T = 40, ctx {ctx}")
    pad_q = torch.cat([q, _data(rng, (3, t, nq, h), dtype)])
    pad_t = np.concatenate([base_t, _tables(rng, [1, 2, 3], base_t.shape[1],
                                            pool)])
    pad_qs = np.concatenate([qs, np.asarray([3, 20, 40], np.int32)])
    padded = ops.paged_prefill_attention_batch(pad_q, kp, vp, _ints(pad_t),
                                               _ints(pad_qs))
    check(torch.equal(padded[:b], base), "batch padding changed bits")
    log(f"bitwise properties hold on the kernel ({dtype}, nq {nq}, h {h}, "
        f"page {ps}, rows up to {ctx}, "
        f"{kernel.instance(getattr(torch, dtype), h)}"
        + (", both routes equal" if wgmma else "") + ")")


def _flash_inputs(rng, b, s, t, heads, dtype):
    nq, nkv, h = heads["nq"], heads["nkv"], heads["h"]
    return (_data(rng, (b, s, nq, h), dtype),
            _data(rng, (b, t, nkv, h), dtype),
            _data(rng, (b, t, nkv, h), dtype))


def phase_flash_correctness() -> dict:
    """The flash kernel against its plain version: tests/test_kernels.py's
    sweep (:28-70) in fp32 and bf16, windows 1/7/64/200 (1 and 7 leave a
    row's first 64-key tile fully masked), non-causal, then the bf16
    instances at every head dim (h >= 64: the tensor-core instance) with T
    not a multiple of the 64-key tile, S < T, S > T, windows 1/7/33/200,
    non-causal and B > 1, then the prefill shapes in bf16 (qwen2-0.5b and
    gemma-2b heads at S = T = 4096, and S = 1000 < T = 4096), then bitwise
    suffix and batch invariance. Each case must launch the instance that
    its dtype and head dim select. Returns max |err| by instance and by
    (dtype, head dim)."""
    rng = np.random.default_rng(4)
    mha, gqa = dict(nq=4, nkv=4, h=64), dict(nq=8, nkv=2, h=64)
    mqa, small = dict(nq=4, nkv=1, h=32), dict(nq=2, nkv=2, h=128)
    win = dict(nq=4, nkv=2, h=32)
    cases = [(b, s, s, heads, dtype, 0, True)
             for dtype in ("float32", "bfloat16")
             for b, s, heads in ((1, 128, mha), (2, 256, gqa), (1, 192, mqa),
                                 (1, 64, small))]
    cases += [(1, 200, 200, win, "float32", w, True) for w in (1, 7, 64, 200)]
    cases += [(2, 128, 128, mha, "float32", 0, False)]
    cases += [(2, 131, 131, dict(nq=4, nkv=2, h=h), "bfloat16", 0, True)
              for h in fkernel.HEAD_DIMS]
    cases += [(1, 100, 250, dict(nq=6, nkv=2, h=64), "bfloat16", 0, True),
              (1, 250, 100, dict(nq=4, nkv=1, h=128), "bfloat16", 0, True),
              (3, 190, 190, dict(nq=8, nkv=1, h=256), "bfloat16", 0, False)]
    cases += [(2, 300, 300, dict(nq=4, nkv=2, h=h), "bfloat16", w, True)
              for h, w in ((64, 1), (128, 7), (256, 33), (64, 200))]
    cases += [(1, PREFILL_S, PREFILL_S, MAIN, "bfloat16", 0, True),
              (1, PREFILL_S, PREFILL_S, GEMMA, "bfloat16", 0, True),
              (1, 1000, PREFILL_S, MAIN, "bfloat16", 0, True)]
    errs = dict.fromkeys(fkernel.LAUNCHES, 0.0)
    for b, s, t, heads, dtype, window, causal in cases:
        q, k, v = _flash_inputs(rng, b, s, t, heads, dtype)
        kw = dict(window=window, causal=causal)
        name = fkernel.instance(q.dtype, heads["h"])
        n0 = fkernel.LAUNCHES[name]
        out = fops.flash_attention(q, k, v, **kw)
        check(fkernel.LAUNCHES[name] == n0 + 1,
              f"{dtype} h={heads['h']} did not launch the {name} instance")
        want = fops.flash_attention(q, k, v, impl="reference", **kw)
        err = _max_err(out, want, dtype)
        for key in (name, (dtype, heads["h"])):
            errs[key] = max(errs.get(key, 0.0), err)
    torch.cuda.synchronize()
    log(f"flash kernel vs plain version over {len(cases)} cases: max |err| "
        + ", ".join(f"{k} {errs[k]:.3g}" for k in fkernel.LAUNCHES)
        + f" (tolerance {TOL['float32']} fp32 / {TOL['bfloat16']} "
        f"bf16, and bf16 within {BF16_ULPS[0]} |want| + {BF16_ULPS[1]})")
    for heads in (MAIN, GEMMA):
        _flash_bitwise(rng, heads)
    return errs


def _flash_bitwise(rng, heads) -> None:
    """On the kernel, bit for bit: the first S' rows of a run at S = T =
    1024 equal a run at S' = T' < 1024 (S' on both sides of the 64- and
    128-row tiles); row b of a B = 4 run equals that row alone."""
    q, k, v = _flash_inputs(rng, 4, 1024, 1024, heads, "bfloat16")
    full = fops.flash_attention(q, k, v)
    for s2 in (1, 64, 65, 127, 128, 129, 700):
        part = fops.flash_attention(*(x[:, :s2].contiguous()
                                      for x in (q, k, v)))
        check(torch.equal(part, full[:, :s2]),
              f"flash suffix invariance broke at S' = {s2}")
    for b in range(4):
        one = fops.flash_attention(*(x[b:b + 1].contiguous()
                                     for x in (q, k, v)))
        check(torch.equal(one, full[b:b + 1]),
              f"flash batch invariance broke at row {b}")
    log(f"flash bitwise suffix and batch invariance hold on the kernel "
        f"(bf16, nq {heads['nq']}, nkv {heads['nkv']}, h {heads['h']})")


# -- phase 3 -----------------------------------------------------------------

def _timed(fn, iters: int = 20, warmup: int = 3, hide: bool = True) -> float:
    """Mean ms per call; the L2 is flushed (not timed) before each call.
    With ``hide`` a device spin of ~0.5 ms runs before the start event, so
    that the host has enqueued the call before the card reaches it: the
    time is the device's, not the host's enqueue (a launch from Python
    takes tens of microseconds, longer than a fast kernel runs)."""
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        scratch.zero_()
        if hide:
            torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def _bound(q_start, t, tables, heads, dtype) -> tuple[float, str, float]:
    """Least time for the page walk on these inputs: each needed input byte
    read once (unique pages the rows cover, K and V), each output written
    once, at the HBM rate; flops of QK^T and PV over the keys each row sees,
    at the card's dense peak for ``dtype``. Returns (ms, what binds, ms of
    those flops on fp32 CUDA cores)."""
    nq, nkv, h = heads["nq"], heads["nkv"], heads["h"]
    itemsize = torch.finfo(getattr(torch, dtype)).bits // 8
    b = len(q_start)
    pages = set()
    for i, s in enumerate(q_start):
        pages.update(tables[i, :-(-(int(s) + t) // PS)].tolist())
    nbytes = (len(pages) * 2 * PS * nkv * h * itemsize      # K and V pages
              + 2 * b * t * nq * h * itemsize                # q in, out
              + tables.size * 4 + b * 4)                     # table, starts
    keys = sum((int(s) + j + 1) for s in q_start for j in range(t))
    flops = 4.0 * keys * nq * h
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_mem, t_ops),
            "bytes" if t_mem >= t_ops else "operations",
            1e3 * flops / CUDA_CORE_FLOPS)


def _sdpa_inputs(q4, kp, vp, tables, q_start, t):
    """Dense K/V gathered beforehand per row, and the causal mask at each
    row's absolute positions, for the library yardstick."""
    b, _, nq, h = q4.shape
    dev = q4.device
    ctx = int(max(q_start)) + t
    mp = -(-ctx // PS)
    idx = torch.as_tensor(tables[:, :mp], device=dev).long()
    k = kp[idx].reshape(b, mp * PS, -1, h)[:, :ctx].transpose(1, 2)
    v = vp[idx].reshape(b, mp * PS, -1, h)[:, :ctx].transpose(1, 2)
    qpos = torch.as_tensor(q_start, device=dev)[:, None] + \
        torch.arange(t, device=dev)
    mask = torch.arange(ctx, device=dev)[None, None] <= qpos[:, :, None]
    return (q4.transpose(1, 2).contiguous(), k.contiguous(), v.contiguous(),
            mask[:, None])


def _paged_row(name, tag, run, plain, q4, kp, vp, tables, q_start, t,
               dtype, ctx="<=800", gate=False) -> dict:
    """Time one paged entry point (q4 [B,T,nq,h] is its query) beside its
    bound and the SDPA yardstick over K/V gathered beforehand. With
    ``gate`` the kernel is first held against its plain version on these
    inputs (``_max_err``), and the row carries that error."""
    import torch.nn.functional as F
    b, _, nq, h = q4.shape
    heads = dict(nq=nq, nkv=kp.shape[2], h=h)
    sq, sk, sv, mask = _sdpa_inputs(q4, kp, vp, tables, q_start, t)
    lib = lambda: F.scaled_dot_product_attention(
        sq, sk, sv, attn_mask=mask, enable_gqa=True)
    got = run().float().reshape(b, t, nq, h)
    lib_err = float((got - lib().transpose(1, 2).float()).abs().max())
    ms, plain_ms, lib_ms = _timed(run), _timed(plain, 5), _timed(lib)
    ms_host, lib_host = _timed(run, hide=False), _timed(lib, hide=False)
    bound_ms, bound_by, core_ms = _bound(q_start, t, tables, heads, dtype)
    inst = kernel.instance(q4.dtype, h)
    log(f"time {name} (B={b}, T={t}, ctx {ctx}, {dtype}, {tag} heads "
        f"{nq}/{heads['nkv']}/{h}, {inst}): kernel {ms:.5f} ms, plain "
        f"{plain_ms:.4f} ms, library yardstick (SDPA over pre-gathered K/V, "
        f"never called by the port) {lib_ms:.5f} ms [|kernel-SDPA| "
        f"{lib_err:.3g}]; with the host's enqueue not hidden kernel "
        f"{ms_host:.5f} ms, SDPA {lib_host:.5f} ms; bound {bound_ms:.5f} ms "
        f"({bound_by}; {dtype} peak {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, "
        f"HBM {HBM_BYTES_PER_S / 1e12} TB/s), kernel/bound "
        f"{ms / bound_ms:.1f}x, kernel/SDPA {ms / lib_ms:.2f}x -- "
        f"{smi_line()}")
    if inst == "paged_walk":
        log(f"  {name}: the same flops on fp32 CUDA cores (what this "
            f"instance uses, {CUDA_CORE_FLOPS / 1e12:.0f} TFLOP/s) take "
            f"{core_ms:.5f} ms; not the bound")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by, context=ctx)
    if gate:
        row["max_abs_err"] = _max_err(run(), plain(), dtype)
    return row


def _flash_bound(b, s, t, heads, dtype, window=0,
                 causal=True) -> tuple[float, str]:
    """Least time for full-sequence attention on these shapes: flops
    4·h·nq·B per unmasked (query, key) pair at the dense peak for
    ``dtype``, or q, out and the un-repeated K and V once each at the HBM
    rate, whichever is larger."""
    nq, nkv, h = heads["nq"], heads["nkv"], heads["h"]
    itemsize = torch.finfo(getattr(torch, dtype)).bits // 8
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(i, t - 1) if causal else np.full(s, t - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(s)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    flops = 4.0 * h * nq * b * pairs
    nbytes = itemsize * (2 * b * s * nq * h + 2 * b * t * nkv * h)
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_mem, t_ops),
            "bytes" if t_mem >= t_ops else "operations")


def _flash_row(rng, heads, s, tag, gate=False) -> dict:
    """Time the flash kernel, its plain version (S <= 4096: it holds
    [B,nkv,g,S,T] fp32 scores) and SDPA (causal, GQA) at B = 1, S = T,
    bf16, causal. With ``gate`` (S <= 4096) the kernel is first held
    against its plain version on these inputs, and the row carries that
    error."""
    import torch.nn.functional as F
    dtype = "bfloat16"
    q, k, v = _flash_inputs(rng, 1, s, s, heads, dtype)
    run = lambda: fops.flash_attention(q, k, v)
    plain = lambda: fops.flash_attention(q, k, v, impl="reference")
    sq, sk, sv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(sq, sk, sv, is_causal=True,
                                                 enable_gqa=True)
    lib_err = float((run().float() - lib().transpose(1, 2).float())
                    .abs().max())
    long = s > PREFILL_S         # the plain version would need > 8 GB
    iters, warm = (3, 1) if long else (20, 3)
    ms = _timed(run, iters, warm)
    lib_ms = _timed(lib, iters, warm)
    plain_ms = None if long else _timed(plain, 3, 1)
    bound_ms, bound_by = _flash_bound(1, s, s, heads, dtype)
    plain_txt = "not run (S > 4096)" if long else f"{plain_ms:.4f} ms"
    log(f"time flash_attention ({tag} heads nq {heads['nq']}/nkv "
        f"{heads['nkv']}/h {heads['h']}, B=1, S=T={s}, bf16, causal): "
        f"kernel {ms:.4f} ms, plain {plain_txt}, library yardstick (SDPA, "
        f"is_causal, enable_gqa; never called by the port) {lib_ms:.4f} ms "
        f"[|kernel-SDPA| {lib_err:.3g}], bound {bound_ms:.5f} ms "
        f"({bound_by}; bf16 peak {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, "
        f"HBM {HBM_BYTES_PER_S / 1e12} TB/s), kernel/bound "
        f"{ms / bound_ms:.1f}x, kernel/SDPA {ms / lib_ms:.2f}x -- "
        f"{smi_line()}")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if gate:
        row["max_abs_err"] = _max_err(run(), plain(), dtype)
    return row


def _paged_rows(rng, heads, tag, gate=False) -> dict[str, dict]:
    """Time the three paged entry points at serving shapes (bf16, page 16,
    pool 1280, batch 8, context <= 800): decode, batched prefill at
    T = 256, and the single-sequence entry point at the same shape; then
    decode at context 4096 (lengths 4033..4096, pool 2560). ``gate`` as
    ``_paged_row``'s."""
    dtype, pool, b = "bfloat16", 1280, 8
    nq, nkv, h = heads["nq"], heads["nkv"], heads["h"]
    kp, vp = _pools(rng, pool, nkv, h, dtype)
    rows = {}
    lens = rng.integers(128, 801, b).astype(np.int32)
    tables = _tables(rng, -(-lens // PS), 50, pool, repeat=False)
    q, tb, ln = _data(rng, (b, nq, h), dtype), _ints(tables), _ints(lens)
    rows["paged_attention"] = _paged_row(
        "paged_attention", tag,
        lambda: ops.paged_attention(q, kp, vp, tb, ln),
        lambda: ops.paged_attention(q, kp, vp, tb, ln, impl="reference"),
        q[:, None], kp, vp, tables, lens - 1, 1, dtype, gate=gate)
    t = 256
    q_start = rng.integers(0, 800 - t + 1, b).astype(np.int32)
    tables = _tables(rng, -(-(q_start + t) // PS), 50, pool, repeat=False)
    q4, tb, qs = _data(rng, (b, t, nq, h), dtype), _ints(tables), \
        _ints(q_start)
    rows["paged_prefill_attention_batch"] = _paged_row(
        "paged_prefill_attention_batch", tag,
        lambda: ops.paged_prefill_attention_batch(q4, kp, vp, tb, qs),
        lambda: ops.paged_prefill_attention_batch(q4, kp, vp, tb, qs,
                                                  impl="reference"),
        q4, kp, vp, tables, q_start, t, dtype, gate=gate)
    # q_start as a device tensor: from a Python int the entry point would
    # copy it to the card on every call, a wait on the host
    q1, tb1, qs1 = q4[0].contiguous(), _ints(tables[0]), _ints(q_start[:1])
    rows["paged_prefill_attention"] = _paged_row(
        "paged_prefill_attention", tag,
        lambda: ops.paged_prefill_attention(q1, kp, vp, tb1, qs1),
        lambda: ops.paged_prefill_attention(q1, kp, vp, tb1, qs1,
                                            impl="reference"),
        q1[None], kp, vp, tables[:1], q_start[:1], t, dtype,
        gate=gate)
    del kp, vp
    kp, vp = _pools(rng, LONG_POOL, nkv, h, dtype)
    lens = rng.integers(LONG_CTX - 63, LONG_CTX + 1, b).astype(np.int32)
    tables = _tables(rng, -(-lens // PS), LONG_CTX // PS, LONG_POOL,
                     repeat=False)
    q, tb, ln = _data(rng, (b, nq, h), dtype), _ints(tables), _ints(lens)
    rows["paged_attention", LONG_CTX] = _paged_row(
        "paged_attention", tag,
        lambda: ops.paged_attention(q, kp, vp, tb, ln),
        lambda: ops.paged_attention(q, kp, vp, tb, ln, impl="reference"),
        q[:, None], kp, vp, tables, lens - 1, 1, dtype, LONG_CTX,
        gate=gate)
    return rows


def phase_timing() -> dict[tuple[str, str], dict]:
    """The paged rows at qwen2-0.5b, gemma-2b and qwen2-vl-7b heads, then
    the flash rows (and flash at granite-moe-3b-a800m heads); keyed (entry
    point, heads) for the JSON record. The rows at the heads of phase 16's
    models also hold the kernel against its plain version on their
    inputs."""
    rng = np.random.default_rng(2)
    rows = {}
    for tag, heads in (("qwen2-0.5b", MAIN), ("gemma-2b", GEMMA),
                       ("qwen2-vl-7b", QWEN_VL)):
        gate = tag == "qwen2-vl-7b"
        for name, row in _paged_rows(rng, heads, tag, gate).items():
            rows[name, tag] = row   # name: entry point, or (it, context)
    frng = np.random.default_rng(6)
    rows["flash_attention_bh", "qwen2-0.5b"] = _flash_row(
        frng, MAIN, PREFILL_S, "qwen2-0.5b")
    _flash_row(frng, MAIN, LONG_S, "qwen2-0.5b, prefill_32k length")
    rows["flash_attention_bh", "gemma-2b"] = _flash_row(
        frng, GEMMA, PREFILL_S, "gemma-2b")
    for tag, heads in (("qwen2-vl-7b", QWEN_VL),
                       ("granite-moe-3b-a800m", GRANITE)):
        rows["flash_attention_bh", tag] = _flash_row(frng, heads, PREFILL_S,
                                                     tag, gate=True)
    for key in ("qwen2-0.5b", "gemma-2b", "qwen2-vl-7b",
                "granite-moe-3b-a800m"):
        rows["flash_attention_bh", key]["context"] = PREFILL_S
    return rows


# -- phases 4 and 5 ------------------------------------------------------------

def _domains():
    from repro_torch.placement.pool import MemoryDomain
    # launch/serve.py's modelled domain bandwidths (Eq.-1 inputs kept for
    # parity with the reference), not rates of this card
    return [MemoryDomain("hbm_local", 512, 819.0, True),
            MemoryDomain("hbm_peer", 256, 50.0, False),
            MemoryDomain("host", 512, 16.0, False)]


def serve(cfg, params, device, prompts, *, max_new=32, drafter=None,
          check_decode=False, incremental_prefill=True) -> dict:
    """Drive ServeEngine over ``prompts`` (all submitted at once) on a fresh
    pool; launch counts zeroed just before the first step, read after the
    last. Returns tokens, counters, step times."""
    from repro_torch.placement.pool import BwapPagePool
    from repro_torch.serve.engine import ServeEngine
    pool = BwapPagePool(cfg, _domains(), page_size=PS, device=device)
    eng = ServeEngine(cfg, params, pool, max_batch=8, max_new=max_new,
                      wall_clock=False, drafter=drafter, device=device,
                      incremental_prefill=incremental_prefill)
    for prompt in prompts:
        eng.submit(prompt)
    logit_err = None
    step_s, decode_s, prefill_steps = [], [], 0
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    fkernel.reset_launch_counts()
    while eng.active or eng.waiting:
        if check_decode and logit_err is None:
            logit_err = _decode_plain_check(eng)
        c0, d0 = eng.prefill_chunks_run, eng.decode_steps
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - s0
        step_s.append(dt)
        prefill_steps += eng.prefill_chunks_run > c0
        if eng.decode_steps > d0:
            decode_s.append(dt)
        check(len(step_s) < 10_000, "serving did not finish")
    launches = {**kernel.LAUNCHES, **fkernel.LAUNCHES}
    eng.view.fabric.check_invariants()
    reclaimed = (pool.free_count() + int(pool.reserved.sum())
                 == pool.total_pages and not pool.table.ref)
    spec = pool.telemetry.snapshot()["spec"]
    return dict(tokens={s.sid: list(s.tokens) for s in eng.finished},
                produced=[s.produced for s in eng.finished],
                finished=len(eng.finished), steps=len(step_s),
                decode_steps=eng.decode_steps, prefill_steps=prefill_steps,
                prefill_chunks=eng.prefill_chunks_run,
                verify_steps=spec["steps"], spec=spec, launches=launches,
                reclaimed=reclaimed, wall_s=sum(step_s), step_s=step_s,
                decode_s=decode_s, tokens_emitted=eng.tokens_emitted,
                layers=cfg.num_layers, logit_err=logit_err)


def _decode_plain_check(eng):
    """Once 8 sequences decode with no page to grow, run their decode step
    through the kernel and through the plain version on the same pool
    state; return max |logit difference|, or None when not yet possible.
    The K/V both write land at the slots the next real step rewrites, and
    these launches are taken back out of the counts."""
    ps = eng.view.page_size
    seqs = [s for s in eng.scheduler.running
            if s.length >= s.prefill_target and s.length % ps
            and not eng.view.shared(s.pages[s.length // ps])]
    if len(seqs) < 8:
        return None
    d = eng.decoder
    mp = max(len(s.pages) for s in seqs)
    tables = np.zeros((len(seqs), mp), np.int32)
    for i, s in enumerate(seqs):
        tables[i, :len(s.pages)] = s.pages
    lens = np.asarray([s.length for s in seqs], np.int64)
    toks = np.asarray([[s.tokens[-1]] for s in seqs], np.int64)
    args = (d._t(toks), d._t(tables, torch.int32), d._t(lens, torch.int32),
            d._t(lens))
    saved = dict(kernel.LAUNCHES)
    fast = d.decode_step(*args).float()
    impl, d.impl = d.impl, "reference"
    try:
        plain = d.decode_step(*args).float()
    finally:
        d.impl = impl
    kernel.LAUNCHES.update(saved)
    err, ties = _logits_gate(fast, plain, "decode step")
    log(f"decode step, kernel vs plain version, full width: max |logit "
        f"diff| {err:.4g} (bf16 gate {LOGIT_TOL}; |logit| up to "
        f"{float(plain.abs().max()):.3g}), argmax equal on "
        f"{len(seqs) - ties}/{len(seqs)} rows, the rest exact ties")
    return err


def _bf16_ulp(x):
    """One bf16 ulp of each |x| (8 significant bits)."""
    top = x.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(top)) - 7)


def _gate_misses(fast, plain, scaled: bool = False):
    """What ``_logits_gate`` would refuse, without refusing it: (max
    |diff|, rows with a logit over its bound, argmax flips as (row, the
    plain version's margin between its token and the kernel's, the
    kernel's margin between the two) where both margins are non-zero,
    argmax flips that are exact ties)."""
    fast, plain = fast.float(), plain.float()
    diff = (fast - plain).abs()
    bound = torch.full_like(plain, LOGIT_TOL)
    if scaled:
        bound = torch.maximum(bound, _bf16_ulp(plain))
    # NaN is over every bound
    over = torch.nonzero((~(diff <= bound)).any(-1)).flatten().tolist()
    af, ap = fast.argmax(-1), plain.argmax(-1)
    flips = [(i, float(plain[i, ap[i]] - plain[i, af[i]]),
              float(fast[i, af[i]] - fast[i, ap[i]]))
             for i in torch.nonzero(af != ap).flatten().tolist()]
    wrong = [f for f in flips if f[1] != 0.0 and f[2] != 0.0]
    return float(diff.max()), over, wrong, len(flips) - len(wrong)


def _logits_gate(fast, plain, what, *, scaled: bool = False
                 ) -> tuple[float, int]:
    """The gate of every phase that holds logits through the kernels
    against the plain version's on the same inputs (``[rows, vocab]``):
    max |diff| <= ``LOGIT_TOL`` (with ``scaled``, each logit's |diff| <=
    the larger of ``LOGIT_TOL`` and one bf16 ulp of the plain logit: for
    logits far above 1, where one ulp outgrows ``LOGIT_TOL``), and on
    every row some token is an argmax of both versions. bf16 logits can
    tie exactly, in either version, and ``argmax`` then takes the lower
    index: where the argmaxes differ, the row passes if the two tokens tie
    exactly in the plain version or in the kernel's, and fails if both
    margins are non-zero. Returns (max |diff|, tied rows whose argmaxes
    differ)."""
    err, over, wrong, ties = _gate_misses(fast, plain, scaled)
    bound = (f"{LOGIT_TOL}" if not scaled else
             f"max({LOGIT_TOL}, 1 bf16 ulp of the logit)")
    check(not over, f"{what}: logits differ by up to {err} > {bound} on "
          f"rows {over}")
    check(not wrong,
          f"{what}: no token is an argmax of both the kernel's and the "
          f"plain version's logits on (row, plain margin, kernel margin) "
          f"{wrong}")
    return err, ties


def _check_instances(cfg, r) -> None:
    """Every paged launch of a serving run went to the instance that the
    config's compute dtype and head dim select, and none to the other."""
    inst = kernel.instance(getattr(torch, cfg.compute_dtype), cfg.head_dim_)
    other = ({"paged_walk", "paged_walk_wgmma"} - {inst}).pop()
    n = sum(r["launches"][k] for k in ("paged_attention",
                                         "paged_prefill_attention_batch",
                                         "paged_prefill_attention"))
    check(n > 0 and r["launches"][inst] == n and r["launches"][other] == 0,
          f"{cfg.name}: paged launches {r['launches']}, want all {n} on "
          f"{inst}")


def _report(tag, r) -> None:
    p50 = float(np.median(r["step_s"])) * 1e3
    dec = sum(r["decode_s"])
    log(f"{tag}: {r['finished']} requests, {r['steps']} engine steps "
        f"({r['prefill_steps']} with prefill, {r['decode_steps']} decode), "
        f"wall {r['wall_s']:.3f} s (sum of synchronised steps), p50 step "
        f"{p50:.2f} ms, decode "
        f"{r['tokens_emitted'] / max(dec, 1e-9):.1f} tok/s "
        f"({r['tokens_emitted']} tokens over {dec:.3f} s of decode steps) "
        f"-- {smi_line()}; launches {r['launches']}")


def phase_serve(device, cfg) -> dict:
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    params = LM(cfg).init(torch.Generator(device=device).manual_seed(0),
                          device=device)
    torch.cuda.synchronize()
    log(f"{cfg.name} params: {cfg.num_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab_size}, {cfg.param_dtype} params / "
        f"{cfg.compute_dtype} compute, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 769, 8)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
    r = serve(cfg, params, device, prompts, check_decode=True)
    _report(f"full-width {cfg.name} greedy serving", r)
    nl = cfg.num_layers
    check(r["finished"] == 8 and r["produced"] == [32] * 8,
          f"finished {r['finished']}, produced {r['produced']}")
    check(r["launches"]["paged_attention"] == r["decode_steps"] * nl,
          "a decode step did not go through the decode kernel")
    check(r["launches"]["paged_prefill_attention_batch"]
          == r["prefill_steps"] * nl,
          "a prefill step did not go through the prefill kernel")
    check(r["launches"]["flash_attention"] == 0
          and r["launches"]["flash_attention_wgmma"] == 0,
          "the incremental path ran a full-sequence forward")
    check(r["reclaimed"], "pool not fully reclaimed")
    check(r["logit_err"] is not None, "decode check never ran")
    _check_instances(cfg, r)
    return dict(cfg=cfg, params=params, greedy=r, prompts=prompts)


def phase_spec(device, cfg, params) -> dict:
    from repro_torch.scheduler.workload import WorkloadSpec, generate
    from repro_torch.serve.spec import PromptLookupDrafter
    trace = generate(WorkloadSpec(
        kind="poisson", num_requests=8, mean_interarrival_s=0.05,
        prompt_mean=256, prompt_max=768, max_new=32,
        vocab_size=cfg.vocab_size, seed=0, prompt_loop_len=4))
    # all requests at once (as in phase 4): the virtual clock advances by
    # Eq.-1 seconds only, so spaced arrivals would serialise the requests
    prompts = [list(t.prompt) for t in trace]
    greedy = serve(cfg, params, device, prompts)
    spec = serve(cfg, params, device, prompts,
                 drafter=PromptLookupDrafter(max_tokens=4))
    _report("full-width speculative serving", spec)
    nl = cfg.num_layers
    check(spec["finished"] == 8 and spec["reclaimed"],
          "speculative run did not finish and reclaim the pool")
    check(spec["verify_steps"] > 0, "no verify step ran")
    check(spec["launches"]["paged_prefill_attention_batch"]
          == (spec["prefill_steps"] + spec["verify_steps"]) * nl,
          "a prefill or verify step did not go through the prefill kernel")
    check(spec["launches"]["paged_attention"]
          == (spec["decode_steps"] - spec["verify_steps"]) * nl,
          "a plain decode step did not go through the decode kernel")
    _check_instances(cfg, spec)
    same = greedy["tokens"] == spec["tokens"]
    differ = sum(greedy["tokens"][k] != spec["tokens"].get(k)
                 for k in greedy["tokens"])
    log(f"speculative: drafted {spec['spec']['drafted']}, accepted "
        f"{spec['spec']['accepted']}, {spec['verify_steps']} verify steps, "
        f"decode steps {spec['decode_steps']} vs greedy "
        f"{greedy['decode_steps']}; tokens equal greedy's: {same} "
        f"({differ} of 8 sequences differ; an observation, not a gate: "
        f"CUDA matmul rounding depends on shape)")
    return spec


def _profile(tag: str, fn, reps: int, unit: str) -> None:
    """torch.profiler over ``reps`` calls of ``fn``: the device's busy share
    of the window and the kernels that fill it. Informational: nothing
    here gates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"profile, {tag}: {1e3 * wall / reps:.2f} ms per {unit} (profiler "
        f"on), device busy {busy / wall:.1%} of the window -- {smi_line()}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms/{unit} "
            f"{e.count // reps:5d}/{unit}  {e.key[:90]}")


def phase_profile(device, cfg, params) -> None:
    """The profile of 3 full-width decode steps at batch 8 (context
    ~400)."""
    from repro_torch.placement.pool import BwapPagePool
    from repro_torch.serve.engine import ServeEngine
    pool = BwapPagePool(cfg, _domains(), page_size=PS, device=device)
    eng = ServeEngine(cfg, params, pool, max_batch=8, max_new=8,
                      wall_clock=False, device=device)
    rng = np.random.default_rng(3)
    for _ in range(8):
        eng.submit(rng.integers(1, cfg.vocab_size, 400).tolist())
    while eng.waiting or any(s.produced == 0 for s in eng.active):
        eng.step()                               # prefill, first token
    eng.step()
    _profile(f"{cfg.name}, 3 decode steps at batch 8", eng.step, 3, "step")


# -- phases 7 and 8 ------------------------------------------------------------

def _forward(lm, params, toks, step) -> tuple[dict, dict]:
    """``LM.prefill`` then ``make_eval_step`` on ``toks``, each with the
    flash counters zeroed just before and read just after (launches per
    instance); the prefill's wall time is synchronised."""
    torch.cuda.synchronize()
    fkernel.reset_launch_counts()
    t0 = time.perf_counter()
    logits = lm.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"prefill": dict(fkernel.LAUNCHES)}
    fkernel.reset_launch_counts()
    metrics = step(params, {"tokens": toks})
    loss = float(metrics["loss"])
    launches["eval"] = dict(fkernel.LAUNCHES)
    return dict(logits=logits[:, 0].float(), loss=loss, wall=wall), launches


def phase_prefill(device, arch, batch, params=None) -> int:
    """Full-width ``LM.prefill`` and ``make_eval_step`` at S = 4096 (seeded
    random weights and tokens): first through the flash kernel, exactly
    ``num_layers`` launches per forward, then through the plain chunked
    path (``attn_impl = "reference"``); logits and loss compared. Every
    flash launch of the kernel forwards (bf16, h 64 or 256) must be the
    tensor-core instance's. Returns those launches."""
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from repro_torch.train.trainstep import make_eval_step
    cfg = registry.get_config(arch)
    lm = LM(cfg)
    if params is None:
        params = lm.init(torch.Generator(device=device).manual_seed(0),
                         device=device)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (batch, PREFILL_S))).to(device)
    step = make_eval_step(lm)
    nl = cfg.num_layers
    lm.prefill(params, {"tokens": toks})          # warm-up, not timed
    fast, n_fast = _forward(lm, params, toks, step)
    lm.attn_impl = "reference"
    plain, n_plain = _forward(lm, params, toks, step)
    lm.attn_impl = None
    err, ties = _logits_gate(fast["logits"], plain["logits"], arch)
    dloss = abs(fast["loss"] - plain["loss"])
    tok_s = batch * PREFILL_S / fast["wall"]
    log(f"full-width prefill {arch} ({nl} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, h {cfg.head_dim_}, B={batch}, "
        f"S={PREFILL_S}): flash launches {n_fast} through the kernel, "
        f"{n_plain} through the plain path; prefill wall "
        f"{fast['wall']:.4f} s ({tok_s:.0f} tokens/s) vs plain chunked path "
        f"{plain['wall']:.4f} s; last-token logits max |diff| {err:.4g} "
        f"(gate {LOGIT_TOL}; |logit| up to "
        f"{float(plain['logits'].abs().max()):.3g}), argmax equal on "
        f"{batch - ties}/{batch} rows, the rest exact ties; loss {fast['loss']:.6f} vs "
        f"{plain['loss']:.6f} (|diff| {dloss:.3g}, gate {LOSS_TOL}) -- "
        f"{smi_line()}")
    want = {"flash_attention": 0, "flash_attention_wgmma": nl}
    check(n_fast == {"prefill": want, "eval": want},
          f"{arch}: flash launches {n_fast}, want {nl} per forward, all "
          f"on the tensor-core instance")
    check(all(n == 0 for f in n_plain.values() for n in f.values()),
          f"{arch}: the plain path launched the kernel")
    check(all(np.isfinite([fast["loss"], plain["loss"]]))
          and bool(torch.isfinite(fast["logits"]).all()),
          f"{arch}: non-finite logits or loss")
    check(dloss <= LOSS_TOL, f"{arch}: loss differs by {dloss} > {LOSS_TOL}")
    _profile(f"{arch} prefill forward, B={batch}, S={PREFILL_S}",
             lambda: lm.prefill(params, {"tokens": toks}), 2, "forward")
    return (n_fast["prefill"]["flash_attention_wgmma"]
            + n_fast["eval"]["flash_attention_wgmma"])


GRAD_S = 512                     # the gradient check's sequence (B = 1)


def _loss_grads(lm, params, toks) -> tuple[list, dict]:
    """Grads of ``lm.loss`` w.r.t. fresh leaves over ``params``' storage
    (the shared params keep ``requires_grad`` off), in ``tree_leaves``
    order, and the flash launches of that forward and backward."""
    from torch.utils._pytree import tree_leaves, tree_map
    tree = tree_map(lambda t: t.detach().requires_grad_(), params)
    fkernel.reset_launch_counts()
    loss, _ = lm.loss(tree, {"tokens": toks})
    loss.backward()
    torch.cuda.synchronize()
    return [t.grad for t in tree_leaves(tree)], dict(fkernel.LAUNCHES)


def phase_grads(device, cfg, params) -> None:
    """Full-width ``LM.loss`` under autograd (B = 1, S = ``GRAD_S``): with
    ``attn_impl=None`` and ``"flash"`` the forward launches the flash
    kernel once a layer and the backward raises, naming
    ``attn_impl='reference'``, instead of dropping attention's gradients;
    with ``"reference"`` (the chunked branch, as the reference trains) no
    kernel launches and the grads reach wq, wk, wv, finite and non-zero."""
    from repro_torch.models.lm import LM
    lm = LM(cfg)
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (1, GRAD_S))).to(device)
    t0 = time.perf_counter()
    for impl in (None, "flash"):
        lm.attn_impl = impl
        raised = False
        try:
            _loss_grads(lm, params, toks)
        except NotImplementedError as e:
            raised = ("no backward kernel" in str(e)
                      and "attn_impl='reference'" in str(e))
        n = dict(fkernel.LAUNCHES)
        check(raised, f"attn_impl={impl!r}: a backward through the flash "
              f"kernel did not raise its error")
        check(n["flash_attention_wgmma"] == cfg.num_layers,
              f"attn_impl={impl!r} under autograd: flash launches {n}")
    lm.attn_impl = "reference"
    grads, n = _loss_grads(lm, params, toks)
    check(sum(n.values()) == 0,
          f"attn_impl='reference' under autograd launched flash: {n}")
    from torch.utils._pytree import tree_leaves
    qkv = [params["groups"][0]["attn"][k] for k in ("wq", "wk", "wv")]
    attn = [g for g, t in zip(grads, tree_leaves(params))
            if any(t is w for w in qkv)]
    check(len(attn) == 3 and all(bool(torch.isfinite(g).all())
                                 and float(g.abs().max()) > 0
                                 for g in attn),
          "wq/wk/wv grads missing, zero or not finite")
    log(f"{cfg.name} loss grads (B=1, S={GRAD_S}): attn_impl=None and "
        f"'flash' launched {cfg.num_layers} flash kernels each and their "
        f"backward raised; attn_impl='reference' launched none and its "
        f"grads reach wq/wk/wv; {time.perf_counter() - t0:.1f} s -- "
        f"{smi_line()}")


def phase_recompute(device, cfg, params, prompts, greedy) -> dict:
    """Phase 4's trace with ``incremental_prefill=False``: each prefill
    chunk recomputes the prompt prefix with ``LM.hidden`` (the engine's
    exactness oracle), every layer through the flash kernel."""
    r = serve(cfg, params, device, prompts, incremental_prefill=False)
    _report("full-width recompute-prefill serving", r)
    nl = cfg.num_layers
    check(r["finished"] == 8 and r["produced"] == [32] * 8,
          f"finished {r['finished']}, produced {r['produced']}")
    check(r["prefill_chunks"] > 0
          and r["launches"]["flash_attention_wgmma"]
          == nl * r["prefill_chunks"]
          and r["launches"]["flash_attention"] == 0,
          f"flash launches {r['launches']}, want {nl} x "
          f"{r['prefill_chunks']} recompute chunks on the tensor-core "
          f"instance")
    check(r["launches"]["paged_prefill_attention_batch"] == 0,
          "the recompute path ran the paged prefill kernel")
    check(r["launches"]["paged_attention"] == r["decode_steps"] * nl,
          "a decode step did not go through the decode kernel")
    check(r["reclaimed"], "pool not fully reclaimed")
    _check_instances(cfg, r)
    same = sum(greedy["tokens"][k] == r["tokens"].get(k)
               for k in greedy["tokens"])
    log(f"recompute prefill: {r['prefill_chunks']} chunks, "
        f"{r['launches']['flash_attention_wgmma']} flash launches; tokens "
        f"equal the incremental run's for {same} of 8 sequences (an "
        f"observation, "
        f"not a gate: the two paths run different kernels; workload seed 0)")
    return r


# -- phase 10 ------------------------------------------------------------------

# coda_compare's Eq.-1 bandwidths times the ratio of a full-width
# qwen2-0.5b page's bytes (24 layers x 4 slots x 2 KV heads x 64 x K, V x
# 2 B = 49152) to the smoke page's (1 x 4 x 2 x 16 x 2 x 4 B = 1024): every
# Eq.-1 time, and so the schedule, is the smoke run's up to rounding
CODA_BW_SCALE = 48


def _coda_engine(cfg, params, device, policy, obs: bool):
    """``coda_compare``'s pool, scheduler and engine at full width, with an
    observatory (tracer and heat, no drift) when ``obs``."""
    from benchmarks.torch_scheduler_bench import coda_engine
    pool, eng, o = coda_engine(
        cfg, params, policy, bw_scale=CODA_BW_SCALE, device=device,
        observatory=dict(tracer=True, heat=True, drift=False) if obs
        else None)
    check(pool.page_bytes == CODA_BW_SCALE * 1024,
          f"page bytes {pool.page_bytes}, want {CODA_BW_SCALE * 1024}")
    return pool, eng, o


def _plain_gate(eng, seqs, what) -> tuple[float, int]:
    """The decode step of ``seqs`` through the kernel and through the plain
    version on the same pool state, held by ``_logits_gate``. The K/V both
    write land at the slots the real launch rewrites; these launches are
    taken back out of the counts."""
    d = eng.decoder
    mp = max(len(s.pages) for s in seqs)
    tables = np.zeros((len(seqs), mp), np.int32)
    for i, s in enumerate(seqs):
        tables[i, :len(s.pages)] = s.pages
    lens = np.asarray([s.length for s in seqs], np.int64)
    toks = np.asarray([[s.tokens[-1]] for s in seqs], np.int64)
    args = (d._t(toks), d._t(tables, torch.int32),
            d._t(lens, torch.int32), d._t(lens))
    saved = dict(kernel.LAUNCHES)
    fast = d.decode_step(*args).float()
    impl, d.impl = d.impl, "reference"
    try:
        plain = d.decode_step(*args).float()
    finally:
        d.impl = impl
    kernel.LAUNCHES.update(saved)
    return _logits_gate(fast, plain, what)


class _MultiLaunchCheck:
    """On the first multi-launch step, and the first after a re-homing:
    before each micro-batch's launch, its decode step through the kernel
    and through the plain version on the same pool state (logits within
    ``LOGIT_TOL`` and the tie rule of ``_logits_gate``);
    during it, every layer's attention inputs and output; after the step's
    last launch, one full-batch launch per layer over the same tables,
    whose rows must equal each micro-batch launch's bit for bit. Launches
    made here are taken back out of the counts."""

    def __init__(self, eng):
        self.eng, self.groups, self.done = eng, None, []
        self.want_after_rehome = False
        self._schedule = eng.scheduler.schedule
        self._launch = eng._decode_launch
        eng.scheduler.schedule = self.schedule
        eng._decode_launch = self.launch
        self.logit_err, self.records, self.launches = 0.0, [], 0
        self.ties = 0

    def armed(self) -> bool:
        return not self.done or (self.want_after_rehome
                                 and len(self.done) < 2)

    def schedule(self):
        plan = self._schedule()
        g = plan.launch_groups
        self.groups = g if g is not None and len(g) > 1 and self.armed() \
            else None
        self.launches, self.records = 0, []
        return plan

    def launch(self, seqs):
        if self.groups is None:
            return self._launch(seqs)
        err, ties = _plain_gate(
            self.eng, seqs, f"coda micro-batch (step {len(self.done) + 1} "
            f"checked, {len(seqs)} rows)")
        self.logit_err = max(self.logit_err, err)
        self.ties += ties
        # the real launch, each layer's attention recorded
        rec, orig = [], ops.paged_attention

        def recording(q, kp, vp, tbl, seen, **kw):
            out = orig(q, kp, vp, tbl, seen, **kw)
            rec.append((q.clone(), kp, vp, tbl.clone(), seen.clone(),
                        out.clone()))
            return out
        ops.paged_attention = recording
        try:
            self._launch(seqs)
        finally:
            ops.paged_attention = orig
        self.records.append(rec)
        self.launches += 1
        if self.launches == len(self.groups):
            self._full_batch()

    def _full_batch(self) -> None:
        saved = dict(kernel.LAUNCHES)
        for layer in zip(*self.records):
            q = torch.cat([r[0] for r in layer])
            mp = max(r[3].shape[1] for r in layer)
            tbl = torch.cat([torch.nn.functional.pad(
                r[3], (0, mp - r[3].shape[1])) for r in layer])
            seen = torch.cat([r[4] for r in layer])
            full = ops.paged_attention(q, layer[0][1], layer[0][2], tbl,
                                       seen)
            row = 0
            for r in layer:
                n = r[0].shape[0]
                check(torch.equal(full[row:row + n], r[5]),
                      "a coda micro-batch launch's rows differ from the "
                      "same rows of one full-batch launch")
                row += n
        kernel.LAUNCHES.update(saved)
        self.done.append((len(self.groups),
                          [len(r[0][0]) for r in self.records]))
        self.groups = None


def _coda_run(cfg, params, device, trace, policy, *, obs=True,
              gate=False) -> dict:
    """Serve ``trace`` under ``policy``; launch counts zeroed just before
    the first step and read after the last. With ``gate``: the micro-batch
    checks (``_MultiLaunchCheck``) and the re-homed pages' bytes."""
    pool, eng, o = _coda_engine(cfg, params, device, policy, obs)
    view = eng.view
    remapped = []
    if gate:
        mlc = _MultiLaunchCheck(eng)

        def bytes_moved(moves):
            old = torch.tensor(list(moves), device=device)
            new = torch.tensor(list(moves.values()), device=device)
            remapped.append((len(moves), all(
                torch.equal(a.index_select(1, new), a.index_select(1, old))
                for a in (view.k_pool, view.v_pool))))
            mlc.want_after_rehome = True
        view.on_page_remap(bytes_moved)
    for t in trace:
        eng.submit(t.prompt, max_new=t.max_new, arrival_s=t.arrival_s)
    infos, step_s = [], []
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    fkernel.reset_launch_counts()
    while eng.active or eng.waiting:
        c0 = eng.prefill_chunks_run
        s0 = time.perf_counter()
        info = eng.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - s0)
        infos.append(dict(launches=info.get("launches", 0),
                          rehomed=info.get("rehomed", 0),
                          prefill=eng.prefill_chunks_run > c0))
        check(len(infos) < 3000, "coda serving did not finish")
    launches = {**kernel.LAUNCHES, **fkernel.LAUNCHES}
    view.fabric.check_invariants()
    reclaimed = (pool.free_count() + int(pool.reserved.sum())
                 == pool.total_pages and not pool.table.ref)
    slo = eng.scheduler.slo.summary(eng.scheduler.now)
    out = dict(policy=policy, finished=len(eng.finished),
               tokens={s.sid: list(s.tokens) for s in eng.finished},
               steps=len(infos), infos=infos, step_s=step_s,
               multi=sum(i["launches"] > 1 for i in infos),
               rehomed=eng.rehomed_pages, makespan=eng.scheduler.now,
               goodput=slo["goodput_tok_s"], launches=launches,
               reclaimed=reclaimed, obs=o, remapped=remapped)
    if gate:
        out.update(logit_err=mlc.logit_err, checked=mlc.done, ties=mlc.ties)
    return out


def phase_coda(device, cfg, params) -> dict:
    """``coda`` serving at full width: ``coda_compare``'s trace under
    ``coda`` (micro-batch decode, heat-driven re-homing) and under
    ``bwap_dwp``, then the observatory's host cost."""
    from benchmarks.torch_scheduler_bench import coda_trace
    trace = coda_trace(cfg.vocab_size)
    nl = cfg.num_layers
    coda = _coda_run(cfg, params, device, trace, "coda", gate=True)
    glob = _coda_run(cfg, params, device, trace, "bwap_dwp")
    for r in (coda, glob):
        check(r["finished"] == len(trace) and r["reclaimed"],
              f"{r['policy']}: {r['finished']}/{len(trace)} finished, "
              f"pool reclaimed: {r['reclaimed']}")
        decode = [i for i in r["infos"] if i["launches"]]
        check(r["launches"]["paged_attention"]
              == nl * sum(i["launches"] for i in decode),
              f"{r['policy']}: {r['launches']['paged_attention']} decode "
              f"launches, want {nl} a micro-batch")
        check(r["launches"]["paged_prefill_attention_batch"]
              == nl * sum(i["prefill"] for i in r["infos"]),
              f"{r['policy']}: a prefill step missed the prefill kernel")
        check(r["launches"]["flash_attention"] == 0
              and r["launches"]["flash_attention_wgmma"] == 0,
              f"{r['policy']}: the incremental path ran a full-sequence "
              f"forward")
        _check_instances(cfg, r)
    check(coda["rehomed"] > 0 and coda["multi"] > 0,
          f"coda: {coda['rehomed']} pages re-homed, {coda['multi']} "
          f"multi-launch steps")
    check(glob["rehomed"] == 0 and glob["multi"] == 0,
          f"bwap_dwp: {glob['rehomed']} re-homed, {glob['multi']} "
          f"multi-launch steps")
    check(sum(n for n, _ in coda["remapped"]) == coda["rehomed"]
          and all(ok for _, ok in coda["remapped"]),
          f"re-homed pages' K/V bytes differ from their sources "
          f"({coda['remapped']})")
    check(len(coda["checked"]) == 2,
          f"micro-batch checks ran on {len(coda['checked'])} steps, want "
          f"the first multi-launch step and the first after a re-homing")
    tr = coda["obs"].tracer
    for sid in coda["tokens"]:
        for name in ("admit", "prefill", "decode", "finish"):
            check(tr.spans(name, sid=sid),
                  f"request {sid} has no {name!r} span")
    rehome_steps = sum(i["rehomed"] > 0 for i in coda["infos"])
    check(len(tr.spans("rehome")) == rehome_steps,
          f"{len(tr.spans('rehome'))} rehome spans, {rehome_steps} steps "
          f"re-homed")
    bench = json.loads((ROOT / "BENCH_coda.json").read_text())
    ratio = coda["goodput"] / max(glob["goodput"], 1e-9)
    same = sum(coda["tokens"][k] == glob["tokens"].get(k)
               for k in coda["tokens"])
    log(f"coda at full width ({cfg.name}, {cfg.compute_dtype}, page 4, "
        f"bandwidths x "
        f"{CODA_BW_SCALE}): {coda['steps']} steps ({coda['multi']} "
        f"multi-launch), {coda['rehomed']} pages re-homed, goodput ratio "
        f"{ratio:.4f} on the virtual clock; BENCH_coda.json (smoke config, "
        f"CPU): {bench['coda']['steps']} steps, "
        f"{bench['coda']['multi_launch_steps']} multi-launch, "
        f"{bench['coda']['rehomed_pages']} re-homed, ratio "
        f"{bench['goodput_ratio']:.4f}; bwap_dwp {glob['steps']} steps")
    log(f"coda micro-batch checks on steps with (launches, rows per launch) "
        f"{coda['checked']}: full-batch rows equal bit for bit, logits "
        f"max |diff| {coda['logit_err']:.4g} (gate {LOGIT_TOL}), argmax "
        f"equal on every row but {coda['ties']} where the two tokens tie "
        f"exactly in one version; "
        f"re-homed "
        f"pages' K/V equal their sources on {len(coda['remapped'])} "
        f"re-homings; {len(tr.events)} trace events")
    log(f"coda vs bwap_dwp tokens equal for {same} of {len(trace)} requests "
        f"(an observation, not a gate: bf16 GEMM bits depend on the "
        f"micro-batch's shape)")
    for r in (coda, glob):
        dec = [s for s, i in zip(r["step_s"], r["infos"]) if i["launches"]]
        ls = [i["launches"] for i in r["infos"] if i["launches"]]
        log(f"{r['policy']}: p50 step {1e3 * np.median(r['step_s']):.2f} ms, "
            f"p50 decode step {1e3 * np.median(dec):.2f} ms, "
            f"{np.mean(ls):.3f} decode launches a decode step, launches "
            f"{r['launches']} -- {smi_line()}")
    # the observatory's host cost: interleaved pairs; the spread of the
    # runs without it says how small a cost the pairs can resolve
    pairs = 5
    base, traced, same_runs = [], [], 0
    for _ in range(pairs):
        for with_obs, into in ((False, base), (True, traced)):
            r = _coda_run(cfg, params, device, trace, "coda", obs=with_obs)
            check(r["infos"] == coda["infos"],
                  "a repeated coda run changed its schedule")
            same_runs += r["tokens"] == coda["tokens"]
            into.append(sum(r["step_s"]) / r["steps"])
    diff = [t - b for b, t in zip(base, traced)]
    log(f"observatory host cost: {1e3 * min(base):.3f} ms a step without, "
        f"{1e3 * min(traced):.3f} ms with (best of {pairs} interleaved "
        f"pairs, {coda['steps']} steps a run; "
        f"{1e3 * (min(traced) - min(base)):+.3f} ms, "
        f"{100 * (min(traced) / min(base) - 1):+.2f} %); median paired "
        f"difference {1e3 * float(np.median(diff)):+.3f} ms; runs without "
        f"it span {1e3 * min(base):.3f}-{1e3 * max(base):.3f} ms "
        f"({100 * (max(base) / min(base) - 1):.2f} %); {same_runs} of "
        f"{2 * pairs} repeated runs give the gated run's tokens -- "
        f"{smi_line()}")
    return coda


# -- phases 11 and 12 ------------------------------------------------------------

def _smoke_page_bytes(page_size: int) -> int:
    """A smoke-config page's bytes (1 fp32 layer, 2 KV heads of 16): the
    Eq.-1 scale of phases 10-12 is a full-width page's over this."""
    return 1 * page_size * 2 * 16 * 2 * 4


def _synced_ms(fn, *a, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _timed_calls(owner, name: str, into: list) -> None:
    """Replace ``owner.name`` (an object's method or a module's function)
    by a version that appends each call's synchronised wall ms to
    ``into``."""
    orig = getattr(owner, name)

    def timed(*a, **kw):
        out, ms = _synced_ms(orig, *a, **kw)
        into.append(ms)
        return out
    setattr(owner, name, timed)


class _FirstDecodeGate:
    """Before an engine's first decode launch: its rows through the kernel
    and through the plain version (``_plain_gate``)."""

    def __init__(self, eng, what):
        self.eng, self.what, self.rows = eng, what, 0
        self.err = self.ties = None
        self._launch = eng._decode_launch
        eng._decode_launch = self.launch

    def launch(self, seqs):
        if self.err is None:
            self.err, self.ties = _plain_gate(self.eng, seqs, self.what)
            self.rows = len(seqs)
        return self._launch(seqs)


def _paged_counts(launches, what) -> None:
    check(launches["paged_attention"] > 0
          and launches["paged_prefill_attention_batch"] > 0,
          f"{what}: paged launches {launches}")
    check(launches["flash_attention"] == 0
          and launches["flash_attention_wgmma"] == 0,
          f"{what}: the incremental path ran a full-sequence forward")


def phase_persist(device, cfg, params) -> dict:
    """``persist_compare``'s three engines at full width, then a
    demote/promote round trip and a range's trip over the wire on pages
    of that run's prefill."""
    import hashlib
    import tempfile

    from benchmarks.torch_scheduler_bench import persist_run
    from repro_torch.checkpoint.ckpt import host_array
    from repro_torch.placement.fabric import as_view
    from repro_torch.placement.persist import (PersistentTier,
                                               deserialize_range,
                                               serialize_range)
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain
    from repro_torch.scheduler import KVSwapManager

    engines, ms = {}, {k: [] for k in ("export", "import", "demote",
                                       "promote", "range export",
                                       "serialize", "deserialize",
                                       "range import")}
    gate = {}

    def hook(name, eng):
        engines[name] = eng
        check(eng.view.page_bytes == CODA_BW_SCALE * _smoke_page_bytes(4),
              f"page bytes {eng.view.page_bytes}")
        tier = eng.view.fabric.persist
        if name == "oracle":
            _timed_calls(tier, "export_prefixes", ms["export"])
        elif name == "warm":
            _timed_calls(tier, "import_prefixes", ms["import"])
            gate["warm"] = _FirstDecodeGate(
                eng, "warm restart, first decode step")

    with tempfile.TemporaryDirectory() as store:
        torch.cuda.synchronize()
        kernel.reset_launch_counts()
        fkernel.reset_launch_counts()
        r = persist_run(cfg, params, store, bw_scale=CODA_BW_SCALE,
                        hook=hook, device=device)
        torch.cuda.synchronize()
        launches = {**kernel.LAUNCHES, **fkernel.LAUNCHES}
    _paged_counts(launches, "persist")
    _check_instances(cfg, {"launches": launches})
    bench = json.loads((ROOT / "BENCH_persist.json").read_text())
    got = (len(r["manifest"]["chains"]), r["restored"],
           r["warm"]["first_step_prefix_hit_pages"],
           r["oracle"]["first_step_prefix_hit_pages"],
           r["cold"]["first_step_prefix_hit_pages"],
           r["oracle"]["steps"], r["warm"]["steps"], r["cold"]["steps"])
    want = (bench["exported_chains"], bench["restored_pages"],
            bench["warm"]["first_step_prefix_hit_pages"],
            bench["oracle"]["first_step_prefix_hit_pages"],
            bench["cold"]["first_step_prefix_hit_pages"],
            bench["oracle"]["steps"], bench["warm"]["steps"],
            bench["cold"]["steps"])
    check(got == want, f"persist counters (chains, restored, warm/oracle/"
          f"cold first-step hits, oracle/warm/cold steps) {got}, "
          f"BENCH_persist.json {want}")
    check(r["warm"]["tokens"] == r["oracle"]["tokens"],
          "the warm restart's tokens differ from the uninterrupted "
          "engine's")
    g = gate["warm"]
    check(g.err is not None, "the warm engine's decode gate never ran")
    for eng in engines.values():
        eng.view.fabric.check_invariants()

    # (a), (b): pages of the oracle's prefill, still held by its pins
    view_a = engines["oracle"].view
    tier_a = view_a.fabric.persist
    pin = next(iter(tier_a._pins.values()))
    src = list(pin["pages"])
    pool = BwapPagePool(cfg, [MemoryDomain("hbm_local", 12, 819.0, True),
                              MemoryDomain("hbm_peer", 12, 0.05, False),
                              MemoryDomain("host", 16, 0.016, False)],
                        page_size=4, device=device)
    view = as_view(pool)
    tier = PersistentTier(bw_gbps=0.008, capacity_pages=32)
    view.fabric.attach_persist(tier)
    _timed_calls(tier, "demote", ms["demote"])
    _timed_calls(tier, "promote", ms["promote"])
    swap = KVSwapManager(pool, reserve_fraction=0.5)
    pages = []
    for _ in range(4):
        view.append_page(pages)
    pool.k_pool[:, pages] = view_a.k_pool[:, src[:4]]
    pool.v_pool[:, pages] = view_a.v_pool[:, src[:4]]
    orig = (pool.k_pool[:, pages].clone(), pool.v_pool[:, pages].clone())
    parked, _ = swap.swap_out(pages)
    demoted, _ = swap.demote_cold(2)
    check(demoted == 2 and sum(p < 0 for p in parked) == 2,
          f"demoted {demoted}, parked list {parked}")
    view.fabric.check_invariants()
    back, _ = swap.swap_in(parked)
    view.fabric.check_invariants()
    check(torch.equal(pool.k_pool[:, back], orig[0])
          and torch.equal(pool.v_pool[:, back], orig[1]),
          "promoted K/V differ from the pages' prefill bytes")
    view.release(back)
    swap.close()
    view.fabric.check_invariants()
    blob, t = _synced_ms(tier_a.export_range, view_a, src,
                         tokens=pin["tokens"], ntokens=len(pin["tokens"]))
    ms["range export"].append(t)
    data, t = _synced_ms(serialize_range, blob)
    ms["serialize"].append(t)
    blob2, t = _synced_ms(deserialize_range, data)
    ms["deserialize"].append(t)
    (new_ids, _), t = _synced_ms(tier.import_range, view, blob2)
    ms["range import"].append(t)
    host_sha = hashlib.sha256(host_array(
        view_a.k_pool[:, src].cpu()).tobytes()).hexdigest()
    check(blob["sha256"]["k"] == blob2["sha256"]["k"] == host_sha
          == hashlib.sha256(host_array(
              pool.k_pool[:, new_ids].cpu()).tobytes()).hexdigest(),
          "range sha256 differs from the host's")
    check(torch.equal(pool.k_pool[:, new_ids], view_a.k_pool[:, src])
          and torch.equal(pool.v_pool[:, new_ids], view_a.v_pool[:, src]),
          "the imported range's K/V differ from the exporter's")
    got_pages = []
    check(view.probe_prefix(pin["tokens"], got_pages, count=False)
          == len(pin["tokens"]), "the imported range's chain is not in "
          "the importer's trie")
    view.release(got_pages)
    view.release(new_ids)
    view.fabric.check_invariants()
    view_a.fabric.check_invariants()

    same = sum(a == b for a, b in zip(r["cold"]["tokens"],
                                      r["oracle"]["tokens"]))
    ratio = r["cold"]["ttft_mean_s"] / max(r["warm"]["ttft_mean_s"], 1e-9)
    log(f"persistence at full width ({cfg.name}, {cfg.compute_dtype}, page "
        f"4, bandwidths x {CODA_BW_SCALE}): {got[0]} chains exported, "
        f"{got[1]} pages restored, first-step prefix hits warm {got[2]} / "
        f"oracle {got[3]} / cold {got[4]}, steps {got[5]}/{got[6]}/{got[7]} "
        f"(BENCH_persist.json: {want}); warm restart tokens equal the "
        f"uninterrupted engine's on {len(r['warm']['tokens'])} of "
        f"{len(r['warm']['tokens'])}; cold restart on {same} of "
        f"{len(r['cold']['tokens'])} (an observation: its bf16 prefill "
        f"runs other chunks); TTFT cold/warm {ratio:.4f} on the virtual "
        f"clock (BENCH_persist.json: {bench['ttft_cold_over_warm']:.4f})")
    log(f"warm restart's first decode step ({g.rows} rows over restored "
        f"pages): logits max |diff| {g.err:.4g} (gate {LOGIT_TOL}), "
        f"{g.ties} exact ties; demote/promote of 2 of 4 prefill pages and "
        f"a {len(src)}-page range over the wire bit-equal, sha256 equal "
        f"to the host's; launches {launches}")
    log("persistence wall ms (synchronised): " + ", ".join(
        f"{k} {np.median(v):.3f}" for k, v in ms.items()
        if v) + f" -- {smi_line()}")
    return dict(launches=launches)


def phase_disagg(device, cfg, params) -> dict:
    """``disagg_compare`` at full width: one host, then a prefill host
    (page 4) handing each prompt's range to a decode host (page 8)."""
    from benchmarks.torch_scheduler_bench import disagg_run
    from repro_torch.cluster import transport

    stages = ("export", "serialize", "deserialize", "convert", "import")
    ms = {k: [] for k in stages}
    objs, gate, first = {}, {}, {}

    def hook(name, obj):
        objs[name] = obj
        if name == "router":
            ch = obj.channel
            send, recv = ch.send, ch.recv

            def first_send(view, pages, **kw):
                first.setdefault("src", (view, list(pages), kw["ntokens"]))
                return send(view, pages, **kw)

            def first_recv(view, **kw):
                new_ids, parcel, secs = recv(view, **kw)
                if "ok" not in first:
                    first["ok"] = _handoff_equal(first["src"], view,
                                                 new_ids)
                return new_ids, parcel, secs
            ch.send, ch.recv = first_send, first_recv
            return
        ps = obj.view.page_size
        check(obj.view.page_bytes == CODA_BW_SCALE * _smoke_page_bytes(ps),
              f"{name}: page bytes {obj.view.page_bytes}")
        tier = obj.view.fabric.persist
        if name == "prefill":
            _timed_calls(tier, "export_range", ms["export"])
        elif name == "decode":
            _timed_calls(tier, "import_range", ms["import"])
            gate["decode"] = _FirstDecodeGate(
                obj, "decode host, first decode step over imported pages")

    saved = {k: getattr(transport, k) for k in
             ("serialize_range", "deserialize_range", "convert_range")}
    for k in saved:
        _timed_calls(transport, k, ms[k.split("_")[0]])
    try:
        torch.cuda.synchronize()
        kernel.reset_launch_counts()
        fkernel.reset_launch_counts()
        r = disagg_run(cfg, params, bw_scale=CODA_BW_SCALE, hook=hook,
                       device=device)
        torch.cuda.synchronize()
        launches = {**kernel.LAUNCHES, **fkernel.LAUNCHES}
    finally:
        for k, fn in saved.items():
            setattr(transport, k, fn)
    _paged_counts(launches, "disagg")
    _check_instances(cfg, {"launches": launches})
    d, single = r["disagg"], r["single"]
    n = r["prompts"]
    check((d["finished"], single["finished"], d["handoffs"],
           d["converted_imports"], d["fallbacks"]) == (n, n, n, n, 0),
          f"disagg finished {d['finished']}/{single['finished']}, "
          f"handoffs {d['handoffs']}, converted {d['converted_imports']}, "
          f"fallbacks {d['fallbacks']}")
    check(first.get("ok") is True,
          "the first handoff's re-chunked K/V differ from the prefill "
          "host's")
    g = gate["decode"]
    check(g.err is not None, "the decode host's gate never ran")
    bench = json.loads((ROOT / "BENCH_disagg.json").read_text())
    same = sum(a == b for a, b in zip(d["tokens"], single["tokens"]))
    ratio = d["ttft_weighted_goodput"] \
        / max(single["ttft_weighted_goodput"], 1e-9)
    log(f"disaggregation at full width ({cfg.name}, {cfg.compute_dtype}, "
        f"pages 4 -> 8, bandwidths x {CODA_BW_SCALE}): {d['handoffs']} "
        f"handoffs, {d['converted_imports']} converted imports, "
        f"{d['fallbacks']} fallbacks; wire {d['wire_bytes']} bytes "
        f"(BENCH_disagg.json, smoke page: {bench['disagg']['wire_bytes']}); "
        f"TTFT-weighted goodput ratio {ratio:.4f} on the virtual clock "
        f"({bench['ttft_goodput_ratio']:.4f}); single-host steps "
        f"{single['steps']} ({bench['single']['steps']}); tokens equal to "
        f"the single host's for {same} of {n} requests (an observation: "
        f"the decode host re-prefills only the tail page)")
    log(f"first handoff: decode host's re-chunked K/V equal the prefill "
        f"host's token for token; decode host's first decode step "
        f"({g.rows} rows over imported pages): logits max |diff| "
        f"{g.err:.4g} (gate {LOGIT_TOL}), {g.ties} exact ties; launches "
        f"{launches}")
    log("handoff wall ms (synchronised, median of "
        f"{len(ms['export'])} handoffs): " + ", ".join(
            f"{k} {np.median(v):.3f}" for k, v in ms.items() if v)
        + f" -- {smi_line()}")
    return dict(launches=launches)


def _handoff_equal(src, view, new_ids) -> bool:
    """The imported range's tokens equal the exported range's, K and V:
    pages flattened to a token axis, the valid ``ntokens`` compared."""
    sview, pages, ntokens = src

    def tokens(pool_array, ids, ps):
        a = pool_array[:, ids]
        return a.reshape(a.shape[0], len(ids) * ps, *a.shape[3:])[
            :, :ntokens]
    return all(torch.equal(tokens(sa, pages, sview.page_size),
                           tokens(da, new_ids, view.page_size))
               for sa, da in ((sview.k_pool, view.k_pool),
                              (sview.v_pool, view.v_pool)))


# -- phases 13 and 14 ------------------------------------------------------------

# zoo_compare's arena (capacities and bandwidths) times a full-width
# qwen2-0.5b page's bytes over the smoke page's, as phases 10-12: the chat
# group is funded with the smoke run's 64 pages and runs its Eq.-1 clock
ZOO_SCALE = CODA_BW_SCALE


def phase_zoo(device, cfg, params) -> dict:
    """``zoo_compare``'s setup with the chat tenant at full width, under
    the capacity market and under static partitions. The SSM and ASR
    tenants keep the smoke configs' geometries: ``xlstm-125m``'s published
    state page (3,557,376 B) is larger than the x 48 ``hbm_local`` domain,
    and ``whisper-tiny``'s three encoder blocks (27.6 MB) are larger than
    the x 48 ASR share (6.3 MB); neither runs a model."""
    from benchmarks.torch_scheduler_bench import smoke, zoo_run

    # the CPU at the smoke size: the digests the drivers must reproduce
    scfg, sparams = smoke(device="cpu")
    cpu = {m: zoo_run(scfg, sparams, market=m, device="cpu")
           for m in (True, False)}
    runs = {}
    for market in (True, False):
        mode = "market" if market else "static"
        seen, step_ms = {}, []

        def hook(name, obj):
            seen[name] = obj
            if name == "server":
                _timed_calls(obj, "step", step_ms)
            elif name == "engine":
                check(obj.view.page_bytes
                      == ZOO_SCALE * _smoke_page_bytes(4),
                      f"zoo chat page bytes {obj.view.page_bytes}")
                seen["gate"] = _FirstDecodeGate(
                    obj, f"zoo ({mode}), first decode step")

        torch.cuda.synchronize()
        kernel.reset_launch_counts()
        fkernel.reset_launch_counts()
        r = zoo_run(cfg, params, market=market, scale=ZOO_SCALE,
                    invariants_every=1, hook=hook, device=device)
        torch.cuda.synchronize()
        launches = {**kernel.LAUNCHES, **fkernel.LAUNCHES}
        _paged_counts(launches, f"zoo ({mode})")
        _check_instances(cfg, {"launches": launches})
        g = seen["gate"]
        check(g.err is not None, f"zoo ({mode}): the decode gate never ran")
        check(r["finished"] == 12 and r["failed"] == 0,
              f"zoo ({mode}): {r['finished']} finished, {r['failed']} "
              f"failed")
        check(r["funding_restored"], f"zoo ({mode}): funding not restored")
        seen["zoo"].check_invariants()
        runs[mode] = dict(r, launches=launches, gate=g, step_ms=step_ms,
                          stats=seen["zoo"].stats())
    mkt, sta = runs["market"], runs["static"]
    check(mkt["idle_lenders"] and mkt["granted_bytes"] > 0
          and mkt["repaid_bytes"] == mkt["granted_bytes"]
          and mkt["outstanding_bytes"] == 0,
          f"zoo (market): lenders {mkt['idle_lenders']}, granted "
          f"{mkt['granted_bytes']}, repaid {mkt['repaid_bytes']}, "
          f"outstanding {mkt['outstanding_bytes']}")
    check(sta["granted_bytes"] == 0, f"zoo (static): granted "
          f"{sta['granted_bytes']}")
    for tenant in ("ssm_digests", "asr_digests"):
        check(mkt[tenant] == sta[tenant] == cpu[True][tenant]
              == cpu[False][tenant],
              f"zoo {tenant}: market {mkt[tenant]}, static {sta[tenant]}, "
              f"CPU smoke {cpu[True][tenant]} / {cpu[False][tenant]}")
    bench = json.loads((ROOT / "BENCH_zoo.json").read_text())
    ratio = mkt["goodput_tok_s"] / max(sta["goodput_tok_s"], 1e-9)
    same = sum(a == b for a, b in zip(mkt["tokens"], sta["tokens"]))
    groups = mkt["stats"]["groups"]
    log(f"zoo at full width ({cfg.name}, {cfg.compute_dtype}, page 4, "
        f"{groups['chat']['page_bytes']} B a chat page; arena x "
        f"{ZOO_SCALE}: {mkt['stats']['capacity_bytes']} B; SSM and ASR at "
        f"the smoke geometries, {groups['ssm']['page_bytes']} B and "
        f"{groups['asr']['page_bytes']} B pages): steps market "
        f"{mkt['steps']} / static {sta['steps']} (BENCH_zoo.json, smoke "
        f"config, CPU: {bench['market']['steps']} / "
        f"{bench['static']['steps']}); goodput ratio {ratio:.4f} on the "
        f"virtual clock ({bench['goodput_ratio']:.4f}); granted / repaid "
        f"{mkt['granted_bytes']} / {mkt['repaid_bytes']} B from "
        f"{mkt['idle_lenders']} (smoke run's 49152 B x {ZOO_SCALE} = "
        f"{49152 * ZOO_SCALE}), outstanding {mkt['outstanding_bytes']}; "
        f"CPU smoke run: steps {cpu[True]['steps']} / "
        f"{cpu[False]['steps']}, granted {cpu[True]['granted_bytes']}")
    log(f"zoo digests equal across modes and to the CPU smoke run's: SSM "
        f"{mkt['ssm_digests']}, ASR {mkt['asr_digests']}; chat tokens "
        f"market vs static equal for {same} of {len(mkt['tokens'])} "
        f"requests (an observation, not a gate: each mode batches "
        f"differently, so bf16 GEMM bits differ)")
    for mode, r in runs.items():
        g = r["gate"]
        log(f"zoo ({mode}): p50 zoo step {np.median(r['step_ms']):.2f} ms "
            f"over {len(r['step_ms'])} steps (synchronised); first decode "
            f"step ({g.rows} rows): logits max |diff| {g.err:.4g} (gate "
            f"{LOGIT_TOL}), {g.ties} exact ties; launches {r['launches']} "
            f"-- {smi_line()}")
    return {"launches": {k: mkt["launches"][k] + sta["launches"][k]
                         for k in mkt["launches"]}}


def phase_placement(device) -> None:
    """``torch_placement_bench.suite`` at ``benchmarks/run.py``'s size (the
    reference geometry; batched equal to looped, >= 5x), then the executor
    at qwen2-0.5b's full-width pool geometry in bf16."""
    from benchmarks import torch_placement_bench as pb

    rows = pb.suite(pages=1024, device=device)
    heads = MAIN
    geometry = (24, PS, heads["nkv"], heads["h"])
    moves = 1024
    full = pb.bench_migration(moves, geometry=geometry,
                              dtype=torch.bfloat16, device=device)
    page = 2 * 24 * PS * heads["nkv"] * heads["h"] * 2   # K + V, bf16
    check(full["bytes_moved"] == moves * page,
          f"executor moved {full['bytes_moved']} B, want {moves * page}")
    traffic = 2 * full["bytes_moved"]          # each page read and written
    bound_ms = 1e3 * traffic / HBM_BYTES_PER_S
    mig = rows["migration"]
    log(f"executor at the reference geometry (fp32 [1, 2048, 2, 1, 8], "
        f"1024 moves): batched {1e3 * mig['batched_s']:.4f} ms, looped "
        f"{1e3 * mig['per_page_loop_s']:.3f} ms, {mig['speedup']:.1f}x "
        f"(floor 5x), equal bit for bit; allocation "
        f"{rows['alloc']['pages_per_s']:.0f} pages/s (host)")
    log(f"executor at qwen2-0.5b's full-width pool (bf16 [24, "
        f"{2 * moves}, {PS}, {heads['nkv']}, {heads['h']}] for k and "
        f"for v, {page} B a page, {moves} moves, {traffic / 1e6:.1f} MB "
        f"read and written): batched {1e3 * full['batched_s']:.4f} ms "
        f"({traffic / full['batched_s'] / 1e9:.1f} GB/s), looped "
        f"{1e3 * full['per_page_loop_s']:.3f} ms "
        f"({traffic / full['per_page_loop_s'] / 1e9:.1f} GB/s), bound "
        f"{bound_ms:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s; equal "
        f"bit for bit -- {smi_line()}")


# -- phase 15 ------------------------------------------------------------------

DENSE_NEW = 16                   # tokens decoded after the gated step
G3_LAYERS, G3_S = 6, 1100        # gemma3-27b's depth cut, prompt length


def _dense_cache(lm, eng, s, cap):
    """A B = 1 dense cache of ``cap`` slots holding ``s``'s K/V copied from
    its pool pages (positions 0..length-1)."""
    ps = eng.view.page_size
    n = s.length
    dev = eng.view.k_pool.device
    pos = torch.arange(n, device=dev)
    pids = torch.as_tensor(s.pages, device=dev)[pos // ps]
    cache = lm.init_cache(1, cap, device=dev)
    check(len(cache) == 1 and isinstance(cache[0], dict),
          f"{lm.cfg.name}: want one stacked cache group")
    c = cache[0]
    c["k"][:, 0, :n] = eng.view.k_pool[:, pids, pos % ps]
    c["v"][:, 0, :n] = eng.view.v_pool[:, pids, pos % ps]
    c["pos"][:, 0, :n] = pos.to(torch.int32)
    return cache


def phase_dense_decode(device, cfg, params, *, watch: bool) -> dict:
    """The paged engine against ``LM.decode_step`` on the same K/V: serve 8
    prompts until each has prefilled (and none waits on a page boundary or
    a shared page), copy each sequence's K/V from its pool pages into a
    dense cache, then run one decode step through ``PagedDecoder
    .decode_step`` (the kernel) and through ``LM.decode_step``, one
    sequence at a time (B = 1: ``decode_step`` takes one position, as the
    reference's, and the rows' positions differ), gated by
    ``_logits_gate``. With ``watch``, 16 more tokens through the engine
    (batch 8) and through dense decode; equal tokens are printed, not
    gated."""
    from repro_torch.models.lm import LM
    from repro_torch.placement.pool import BwapPagePool
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    lm = LM(cfg)
    pool = BwapPagePool(cfg, _domains(), page_size=PS, device=device)
    eng = ServeEngine(cfg, params, pool, max_batch=8, max_new=64,
                      wall_clock=False, device=device)
    rng = np.random.default_rng(7)
    for n in rng.integers(128, 769, 8):
        eng.submit(rng.integers(1, cfg.vocab_size, n).tolist())
    ps = eng.view.page_size

    def ready(seqs):
        return len(seqs) == 8 and all(
            s.length >= s.prefill_target and s.length % ps
            and not eng.view.shared(s.pages[s.length // ps]) for s in seqs)
    steps = 0
    while not ready(eng.scheduler.running):
        eng.step()
        steps += 1
        check(steps < 200 and not eng.finished,
              f"{cfg.name}: 8 sequences never ready for the dense check")
    seqs = list(eng.scheduler.running)
    check(not watch or all(s.produced + DENSE_NEW + 1 < s.max_new
                           for s in seqs),
          f"{cfg.name}: too few tokens left, produced "
          f"{[s.produced for s in seqs]}")
    d = eng.decoder
    saved, fsaved = dict(kernel.LAUNCHES), dict(fkernel.LAUNCHES)
    caches, paged, dense, dense_ms = [], [], [], []
    for s in seqs:
        n = s.length
        caches.append(_dense_cache(lm, eng, s,
                                   n + (DENSE_NEW + 1 if watch else 1)))
        tok = np.asarray([[s.tokens[-1]]], np.int64)
        lens = np.asarray([n], np.int64)
        paged.append(d.decode_step(
            d._t(tok), d._t(np.asarray([s.pages], np.int32), torch.int32),
            d._t(lens, torch.int32), d._t(lens)).float())
        before = dict(kernel.LAUNCHES)
        (lg, _), ms = _synced_ms(lm.decode_step, params, caches[-1],
                                 d._t(tok), torch.tensor(n, device=device))
        check(kernel.LAUNCHES == before and fkernel.LAUNCHES == fsaved,
              f"{cfg.name}: dense decode launched a kernel")
        dense.append(lg[:, 0].float())
        dense_ms.append(ms)
    paged, dense = torch.cat(paged), torch.cat(dense)
    err, ties = _logits_gate(paged, dense,
                             f"{cfg.name} paged vs dense decode")
    kernel.LAUNCHES.update(saved)
    gated_s = time.perf_counter() - t0
    ms = float(np.median(dense_ms))
    log(f"dense decode, {cfg.name} (full width, {cfg.num_layers} layers): "
        f"{steps} engine steps to prefill 8 prompts of "
        f"{sorted(s.prefill_target + 1 for s in seqs)} tokens; paged engine "
        f"vs LM.decode_step on the same K/V, B=1 each: max |logit diff| "
        f"{err:.4g} (gate {LOGIT_TOL}; |logit| up to "
        f"{float(dense.abs().max()):.3g}), argmax equal on "
        f"{8 - ties}/8 rows, the rest exact ties; LM.decode_step p50 "
        f"{ms:.2f} ms (B=1, synchronised wall); {gated_s:.1f} s -- "
        f"{smi_line()}")
    if not watch:
        return dict(err=err, ties=ties, ms=ms)
    # 16 more tokens: the engine at batch 8, dense decode per sequence
    n0 = [len(s.tokens) for s in seqs]
    at = [s.length for s in seqs]
    for _ in range(DENSE_NEW + 1):
        eng.step()
    check(all(len(s.tokens) == n + DENSE_NEW + 1 for s, n in zip(seqs, n0)),
          f"{cfg.name}: the engine did not decode {DENSE_NEW + 1} tokens a "
          f"sequence")
    equal = 0
    for i, s in enumerate(seqs):
        toks = [int(dense[i].argmax())]
        for j in range(DENSE_NEW):
            (lg, _), ms = _synced_ms(
                lm.decode_step, params, caches[i],
                torch.tensor([[toks[-1]]], device=device),
                torch.tensor(at[i] + 1 + j, device=device))
            toks.append(int(lg[0, 0].float().argmax()))
            dense_ms.append(ms)
        equal += toks == list(s.tokens[n0[i]:])
    ms = float(np.median(dense_ms))
    log(f"dense decode, {cfg.name}: tokens equal over {DENSE_NEW + 1} more "
        f"steps (the engine at batch 8, dense B=1) for {equal}/8 sequences "
        f"(watched, not gated); LM.decode_step p50 {ms:.2f} ms; "
        f"{time.perf_counter() - t0 - gated_s:.1f} s")
    return dict(err=err, ties=ties, equal=equal, ms=ms)


def phase_window_decode(device) -> dict:
    """gemma3-27b at full width, depth cut to 6 layers (5 windowed at 1024,
    then 1 global; bf16 params): one 1100-token prompt stepped token by
    token through ``LM.decode_step`` from position 0 (one group mixing
    windowed and global layers: 1100 slots, the window applied by the
    mask), its logits at positions 1022-1026 and 1095-1099 held against
    ``LM.hidden`` + ``logits`` over the whole sequence, whose attention is
    the flash kernel with ``window=1024`` on five layers."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config("gemma3-27b"),
                              num_layers=G3_LAYERS, param_dtype="bfloat16")
    lm = LM(cfg)
    w = cfg.sliding_window
    check(lm.windows.tolist() == [w] * 5 + [0],
          f"gemma3-27b cut: windows {lm.windows.tolist()}")
    # across the window's edge, and the prompt's last positions
    keep = list(range(w - 2, w + 3)) + list(range(G3_S - 5, G3_S))
    params = lm.init(torch.Generator(device=device).manual_seed(0),
                     device=device)
    toks = torch.from_numpy(np.random.default_rng(11).integers(
        1, cfg.vocab_size, (1, G3_S))).to(device)
    cache = lm.init_cache(1, G3_S, device=device)
    check(tuple(cache[0]["k"].shape) == (G3_LAYERS, 1, G3_S,
                                         cfg.num_kv_heads, cfg.head_dim_),
          f"gemma3-27b cache {tuple(cache[0]['k'].shape)}")
    positions = torch.arange(G3_S, dtype=torch.int32, device=device)
    kept = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for t in range(G3_S):
        lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1],
                                   positions[t])
        if t in keep:
            kept.append(lg[0, 0])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1) / G3_S
    check(int(cache[0]["pos"][0, 0, -1]) == G3_S - 1,
          "the dense cache does not hold the last position")
    fkernel.reset_launch_counts()
    with torch.no_grad():
        x = lm.embed(params, {"tokens": toks})
        h, _, _ = lm.hidden(params, x, positions[None])
        full = lm.logits(params, h[0, keep])
    n = dict(fkernel.LAUNCHES)
    check(n == {"flash_attention": 0, "flash_attention_wgmma": G3_LAYERS},
          f"gemma3-27b forward: flash launches {n}")
    dec = torch.stack(kept)
    # each token's own logit reaches ~74 here (tied embeddings scaled by
    # sqrt(d)), where one bf16 ulp is 0.5: a logit may differ by one ulp
    err, ties = _logits_gate(full, dec, "gemma3-27b flash forward vs "
                             "dense decode", scaled=True)
    # the same forward blind to the window must miss that gate on some row
    # past the window, or the gate could not tell a wrong window
    windows, lm.windows = lm.windows, np.zeros_like(lm.windows)
    with torch.no_grad():
        h, _, _ = lm.hidden(params, x, positions[None])
        blind = lm.logits(params, h[0, keep])
    lm.windows = windows
    blind_err, over, wrong, _ = _gate_misses(blind[5:], dec[5:], True)
    missed = sorted(set(over) | {i for i, _, _ in wrong})
    check(missed, f"gemma3-27b: a window-blind forward passes the gate "
          f"(max |diff| {blind_err})")
    log(f"gemma3-27b window-blind forward vs dense decode at "
        f"{keep[5]}-{keep[-1]}: max |diff| {blind_err:.4g}, rows "
        f"{[keep[5] + i for i in missed]} miss the gate")
    log(f"dense decode, gemma3-27b (d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}, h {cfg.head_dim_}; depth cut "
        f"to {G3_LAYERS} layers, windows {lm.windows.tolist()}, bf16 "
        f"params): {G3_S} tokens decoded one by one, {step_ms:.2f} ms a "
        f"decode_step (B=1, mean over the prompt); logits at positions "
        f"{keep[0]}-{keep[4]} and {keep[5]}-{keep[-1]} vs the "
        f"flash forward ({n['flash_attention_wgmma']} launches, window "
        f"{w} on 5): max |diff| {err:.4g} (gate max({LOGIT_TOL}, 1 bf16 "
        f"ulp of the logit); |logit| up to {float(dec.abs().max()):.3g}), "
        f"argmax equal on "
        f"{len(keep) - ties}/{len(keep)}, the rest exact ties; "
        f"{time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return dict(err=err, ties=ties, ms=step_ms, blind_err=blind_err,
                blind_missed=len(missed))


# -- phase 16 ------------------------------------------------------------------

VL_PATCHES = 1024                # qwen2-vl-7b's published stub patches
GATE_S = 64                      # the decode gates' prompt
GATE_KEEP = list(range(GATE_S - 5, GATE_S))   # positions held: 59-63
DS_LAYERS, DS_LOSS_S = 4, 512    # deepseek-v3's depth cut, its loss length


def _no_drop(cfg):
    """``cfg`` with a capacity factor of ``num_experts / top_k``: each
    expert's capacity is the row's length, so no copy is dropped (the
    decode gates' setting, as the reference's MLA decode test's 8)."""
    import dataclasses
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def _gb(params) -> float:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9


class _Routing:
    """MoE routing (``moe._route_one_row``) recorded on one pass and
    replayed on another, so that two paths take the same experts. A
    measurement device of this script, not of the port: the router reads
    bf16 activations, and the bf16 rounding that separates the flash
    kernel's attention from the chunked path's changes ~12 % of granite's
    (layer, token) top-8 sets at S = 4096 on an H100 (the count is printed
    each run), so two correct paths that route on their own differ by
    more than the logits gate. As the reference's MLA decode test takes a
    no-drop capacity to keep capacity drops out of its comparison, these
    gates keep routing flips out of theirs; the gaps with each path's own
    routing are printed beside them.

    ``with _Routing() as r:`` records each call's result and capacity in
    ``r.calls``; ``with _Routing(r.calls):`` returns them in order
    instead. With ``per_token`` each call (one token, as in
    ``decode_step``) takes token ``i // n`` of recorded call ``i % n`` (n
    recorded calls, each over a whole sequence with no copy dropped), its
    copies re-slotted at the call's own capacity."""

    def __init__(self, replay=None, per_token=False):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe._route_one_row
        self.replay, self.per_token = replay, per_token
        self.calls, self.used = [], 0

    def __enter__(self):
        self.moe._route_one_row = self._call
        return self

    def __exit__(self, *exc):
        self.moe._route_one_row = self.route
        if exc[0] is None and self.replay is not None:
            n = len(self.replay) * (GATE_S if self.per_token else 1)
            check(self.used == n, f"routing replay used {self.used} of {n} "
                  f"recorded routings")

    def _call(self, xf, router, cfg, cap):
        if self.replay is None:
            out = self.route(xf, router, cfg, cap)
            self.calls.append((*out, cap))
            return out
        i, self.used = self.used, self.used + 1
        k, e = cfg.moe.top_k, cfg.moe.num_experts
        if not self.per_token:
            dest, weights, counts, probs, _ = self.replay[i]
            check(dest.numel() == xf.shape[0] * k, "routing replay: the "
                  "passes route other shapes")
            return dest, weights, counts, probs
        n = len(self.replay)
        dest, weights, _, probs, cap_f = self.replay[i % n]
        t = i // n
        d = dest[t * k:(t + 1) * k]
        check(xf.shape[0] == 1 and bool((d < e * cap_f).all()),
              "routing replay: want one token a call and no dropped copy")
        experts = d // cap_f
        counts = torch.zeros(e, dtype=d.dtype, device=d.device)
        counts.scatter_add_(0, experts, torch.ones_like(experts))
        # a token's copies go to distinct experts: rank 0 in each
        return (experts * cap, weights[t * k:(t + 1) * k], counts,
                probs[t:t + 1])


def _top_sets(probs, k):
    return torch.topk(probs, k, dim=-1).indices.sort(-1).values


def _flips(a, b, k) -> tuple[int, int]:
    """Tokens whose top-k set differs between two recorded passes of the
    same shapes, summed over the calls, and the calls where the last token
    flips."""
    tot = last = 0
    for ra, rb in zip(a, b):
        diff = (_top_sets(ra[3], k) != _top_sets(rb[3], k)).any(-1)
        tot += int(diff.sum())
        last += int(diff[-1])
    return tot, last


def _decode_gate(lm, params, device, what, seed) -> dict:
    """``LM.hidden`` + ``logits`` over a ``GATE_S``-token prompt (its
    flash launches counted from 0; its routing recorded), then
    ``LM.decode_step`` over the same prompt from position 0 (no kernel:
    dense and MLA decode are plain torch) with the forward's routing
    replayed, its logits at ``GATE_KEEP`` held against the forward's by
    ``_logits_gate``; then the same decode routing on its own, whose gap
    and flipped tokens are returned, not gated."""
    cfg = lm.cfg
    k = cfg.moe.top_k
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (1, GATE_S))).to(device)
    positions = torch.arange(GATE_S, dtype=torch.int32, device=device)
    fkernel.reset_launch_counts()
    with torch.no_grad(), _Routing() as fwd:
        x = lm.embed(params, {"tokens": toks})
        h, _, _ = lm.hidden(params, x, positions[None])
        full = lm.logits(params, h[0, GATE_KEEP])
    n = dict(fkernel.LAUNCHES)

    def decode(routing):
        cache = lm.init_cache(1, GATE_S, device=device)
        saved, fsaved = dict(kernel.LAUNCHES), dict(fkernel.LAUNCHES)
        kept = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), routing:
            for t in range(GATE_S):
                lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1],
                                           positions[t])
                if t in GATE_KEEP:
                    kept.append(lg[0, 0])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / GATE_S
        check(kernel.LAUNCHES == saved and fkernel.LAUNCHES == fsaved,
              f"{what}: decode_step launched a kernel")
        return torch.stack(kept), ms

    dec, step_ms = decode(_Routing(fwd.calls, per_token=True))
    err, ties = _logits_gate(full, dec, f"{what}: forward vs decode_step "
                             "(the forward's routing)")
    own = _Routing()
    dec_own, _ = decode(own)
    nf = len(fwd.calls)
    flips = sum(int((_top_sets(c[3], k) != _top_sets(
        fwd.calls[i % nf][3][i // nf:i // nf + 1], k)).any())
        for i, c in enumerate(own.calls))
    return dict(err=err, ties=ties, step_ms=step_ms, launches=n,
                top=float(dec.float().abs().max()),
                own_err=float((full.float() - dec_own.float()).abs().max()),
                flips=flips, routed=len(own.calls))


def _family_vlm(device) -> dict:
    """qwen2-vl-7b at full width, bf16 params: phase 4's serving (every
    paged launch on the h = 128 tensor-core instance, one decode step held
    against the plain version), then ``LM.prefill`` at B = 1 over the
    published 1024 stub patches and 1024 tokens through the flash kernel
    (28 launches) against the chunked path."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config("qwen2-vl-7b"),
                              param_dtype="bfloat16")
    inst = kernel.instance(torch.bfloat16, cfg.head_dim_)
    check(cfg.head_dim_ == 128 and inst == "paged_walk_wgmma",
          f"qwen2-vl-7b: head dim {cfg.head_dim_}, instance {inst}")
    s = phase_serve(device, cfg)
    params, r = s["params"], s["greedy"]
    paged = {k: r["launches"][k] for k in (
        "paged_attention", "paged_prefill_attention_batch",
        "paged_prefill_attention")}
    serve_s = time.perf_counter() - t0
    log(f"qwen2-vl-7b serving ({cfg.num_layers} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}/{cfg.head_dim_}, "
        f"{_gb(params):.1f} GB of bf16 params): paged launches by entry "
        f"point {paged}, all {r['launches'][inst]} on {inst}; "
        f"{serve_s:.1f} s")
    lm = LM(cfg)
    rng = np.random.default_rng(3)
    batch = {"patch_embeds": torch.from_numpy(rng.standard_normal(
        (1, VL_PATCHES, cfg.d_model)) * 0.02).to(device, torch.bfloat16),
        "tokens": torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (1, VL_PATCHES))).to(device)}
    with torch.no_grad():
        lm.prefill(params, batch)                 # warm-up, not timed
        fkernel.reset_launch_counts()
        fast, ms = _synced_ms(lm.prefill, params, batch)
        n_fast = dict(fkernel.LAUNCHES)
        lm.attn_impl = "reference"
        fkernel.reset_launch_counts()
        plain, plain_ms = _synced_ms(lm.prefill, params, batch)
        n_plain = dict(fkernel.LAUNCHES)
    nl = cfg.num_layers
    check(n_fast == {"flash_attention": 0, "flash_attention_wgmma": nl},
          f"qwen2-vl-7b prefill: flash launches {n_fast}, want {nl} on the "
          f"tensor-core instance")
    check(sum(n_plain.values()) == 0,
          f"qwen2-vl-7b: the chunked path launched flash {n_plain}")
    fast, plain = fast[:, 0].float(), plain[:, 0].float()
    check(bool(torch.isfinite(fast).all()), "qwen2-vl-7b: non-finite logits")
    err, ties = _logits_gate(fast, plain, "qwen2-vl-7b prefill with stub "
                             "patches")
    log(f"qwen2-vl-7b prefill, B=1, {VL_PATCHES} stub patches + "
        f"{VL_PATCHES} tokens (S={2 * VL_PATCHES}, M-RoPE at the default "
        f"positions): flash launches {n_fast['flash_attention_wgmma']}; "
        f"forward {ms:.2f} ms vs chunked path {plain_ms:.2f} ms "
        f"(synchronised wall); last-token logits max |diff| {err:.4g} "
        f"(gate {LOGIT_TOL}; |logit| up to {float(plain.abs().max()):.3g}), "
        f"argmax equal{' but for an exact tie' if ties else ''}; "
        f"{time.perf_counter() - t0:.1f} s in all -- {smi_line()}")
    return dict(served=r["launches"], flash=n_fast["flash_attention_wgmma"])


def _family_granite(device) -> dict:
    """granite-moe-3b-a800m at full width (fp32 params, the config's):
    ``LM.prefill`` and the loss at B = 1, S = 4096 through the flash kernel
    (32 launches each) against the chunked path; then ``decode_step`` over
    a 64-token prompt at the no-drop capacity against the kernel forward
    at positions 59-63."""
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from repro_torch.train.trainstep import make_eval_step
    t0 = time.perf_counter()
    cfg = registry.get_config("granite-moe-3b-a800m")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(0),
                     device=device)
    check(tuple(params["groups"][0]["moe"]["w_gate"].shape[:2]) == (32, 48)
          and params["groups"][0]["moe"]["router"].shape[-1] == 40,
          "granite: want 40 routed experts padded to 48")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, cfg.vocab_size, (1, PREFILL_S))).to(device)
    step = make_eval_step(lm)
    nl = cfg.num_layers
    with _Routing() as kern:
        fast, n_fast = _forward(lm, params, toks, step)
    lm.attn_impl = "reference"
    with _Routing(kern.calls):           # the kernel path's routing
        plain, n_plain = _forward(lm, params, toks, step)
    with _Routing() as chunked:          # its own routing
        own, _ = _forward(lm, params, toks, step)
    lm.attn_impl = None
    flips, last = _flips(kern.calls[:nl], chunked.calls[:nl],
                         cfg.moe.top_k)
    own_err = float((fast["logits"] - own["logits"]).abs().max())
    own_dloss = abs(fast["loss"] - own["loss"])
    want = {"flash_attention": 0, "flash_attention_wgmma": nl}
    check(n_fast == {"prefill": want, "eval": want},
          f"granite: flash launches {n_fast}, want {nl} per forward")
    check(all(n == 0 for f in n_plain.values() for n in f.values()),
          "granite: the chunked path launched the kernel")
    check(all(np.isfinite([fast["loss"], plain["loss"]]))
          and bool(torch.isfinite(fast["logits"]).all()),
          "granite: non-finite logits or loss")
    err, ties = _logits_gate(fast["logits"], plain["logits"],
                             "granite (the kernel path's routing)")
    dloss = abs(fast["loss"] - plain["loss"])
    check(max(dloss, own_dloss) <= LOSS_TOL,
          f"granite: loss differs by {dloss} (same routing), {own_dloss} "
          f"(each path's own) > {LOSS_TOL}")
    log(f"granite-moe-3b-a800m forward ({nl} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}/{cfg.head_dim_}, 40 experts "
        f"top-8 padded to 48, {_gb(params):.1f} GB of fp32 params), B=1, "
        f"S={PREFILL_S}: flash launches {n_fast}; prefill "
        f"{1e3 * fast['wall']:.1f} ms vs chunked path "
        f"{1e3 * plain['wall']:.1f} ms; with the kernel path's routing: "
        f"last-token logits max |diff| {err:.4g} (gate {LOGIT_TOL}; |logit| "
        f"up to {float(plain['logits'].abs().max()):.3g}), argmax equal"
        f"{' but for an exact tie' if ties else ''}, loss "
        f"{fast['loss']:.6f} vs {plain['loss']:.6f} (|diff| {dloss:.3g}, "
        f"gate {LOSS_TOL}); with each path's own routing (logits not "
        f"gated): {flips} of {nl * PREFILL_S} (layer, token) top-8 sets "
        f"differ, the last token's in {last} of {nl} layers, logits max "
        f"|diff| {own_err:.4g}, loss |diff| {own_dloss:.3g} (gate "
        f"{LOSS_TOL}) -- {smi_line()}")
    dec = _decode_gate(LM(_no_drop(cfg)), params, device, "granite", 9)
    check(dec["launches"] == want,
          f"granite decode gate's forward: flash launches {dec['launches']}")
    log(f"granite-moe-3b-a800m decode_step (B=1, capacity factor "
        f"{_no_drop(cfg).moe.capacity_factor}: no drops; the forward's "
        f"routing) over a {GATE_S}-token prompt vs the kernel forward at "
        f"positions {GATE_KEEP[0]}-{GATE_KEEP[-1]}: max |diff| "
        f"{dec['err']:.4g} (gate {LOGIT_TOL}; |logit| up to "
        f"{dec['top']:.3g}), argmax equal on "
        f"{len(GATE_KEEP) - dec['ties']}/{len(GATE_KEEP)}, the rest exact "
        f"ties; routing on its own (not gated): {dec['flips']} of "
        f"{dec['routed']} (layer, token) top-8 sets differ from the "
        f"forward's, max |diff| {dec['own_err']:.4g}; "
        f"{dec['step_ms']:.2f} ms a decode_step; "
        f"{time.perf_counter() - t0:.1f} s in all -- {smi_line()}")
    return dict(flash=2 * nl + dec["launches"]["flash_attention_wgmma"])


def _family_deepseek(device) -> dict:
    """deepseek-v3-671b at full width, depth cut to 4 layers (3 dense, then
    1 MoE of 256 routed experts and 1 shared; MLA; the MTP head; bf16
    params, the config's): the loss with MTP at B = 1, S = 512, then MLA's
    absorbed decode over a 64-token prompt at the no-drop capacity against
    the materialised forward at positions 59-63."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config("deepseek-v3-671b"),
                              num_layers=DS_LAYERS)
    lm = LM(cfg)
    check([(g.kind, len(g.indices)) for g in lm.groups]
          == [("moe_dense", 3), ("moe", 1)],
          f"deepseek cut: groups {lm.groups}")
    params = lm.init(torch.Generator(device=device).manual_seed(0),
                     device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        1, cfg.vocab_size, (1, DS_LOSS_S))).to(device)
    saved, fsaved = dict(kernel.LAUNCHES), dict(fkernel.LAUNCHES)
    with torch.no_grad():
        (loss, metrics), loss_ms = _synced_ms(lm.loss, params,
                                              {"tokens": toks})
    check(kernel.LAUNCHES == saved and fkernel.LAUNCHES == fsaved,
          "deepseek: MLA's forward launched a kernel")
    vals = {k: float(v) for k, v in metrics.items()}
    check(set(vals) == {"ce", "aux", "mtp_ce"}
          and all(np.isfinite([float(loss), *vals.values()])),
          f"deepseek loss {float(loss)}, metrics {vals}")
    log(f"deepseek-v3-671b (d {cfg.d_model}, {cfg.num_heads} MLA heads, "
        f"depth cut to {DS_LAYERS} of 61 layers: 3 dense + 1 MoE of 256 "
        f"experts; MTP head; {_gb(params):.1f} GB of bf16 params, init "
        f"{init_s:.1f} s): loss at B=1, S={DS_LOSS_S} {float(loss):.6f} "
        f"(ce {vals['ce']:.6f}, aux {vals['aux']:.6g}, mtp_ce "
        f"{vals['mtp_ce']:.6f}) in {loss_ms:.1f} ms (synchronised wall)")
    dec = _decode_gate(LM(_no_drop(cfg)), params, device, "deepseek", 10)
    check(sum(dec["launches"].values()) == 0,
          f"deepseek: the MLA forward launched flash {dec['launches']}")
    log(f"deepseek-v3-671b absorbed MLA decode_step (B=1, capacity factor "
        f"{_no_drop(cfg).moe.capacity_factor}: no drops; the forward's "
        f"routing) over a {GATE_S}-token prompt vs the materialised forward "
        f"at positions {GATE_KEEP[0]}-{GATE_KEEP[-1]}: max |diff| "
        f"{dec['err']:.4g} (gate {LOGIT_TOL}; |logit| up to "
        f"{dec['top']:.3g}), argmax equal on "
        f"{len(GATE_KEEP) - dec['ties']}/{len(GATE_KEEP)}, the rest exact "
        f"ties; routing on its own (not gated): {dec['flips']} of "
        f"{dec['routed']} (layer, token) top-8 sets differ from the "
        f"forward's, max |diff| {dec['own_err']:.4g}; "
        f"{dec['step_ms']:.2f} ms a decode_step; "
        f"{time.perf_counter() - t0:.1f} s in all -- {smi_line()}")
    return {}


def phase_families(device) -> dict:
    """Phase 16: qwen2-vl-7b, granite-moe-3b-a800m and deepseek-v3-671b
    (cut to 4 layers) at full width, each model freed before the next is
    built. Returns the launches for the JSON record."""
    import gc
    out = {}
    for name, part in (("qwen2-vl-7b", _family_vlm),
                       ("granite-moe-3b-a800m", _family_granite),
                       ("deepseek-v3-671b", _family_deepseek)):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 16, {name}: {torch.cuda.memory_allocated() / 1e9:.1f} "
            f"GB allocated on the card before the model is built")
        out[name] = part(device)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- main --------------------------------------------------------------------

def main() -> int:
    global torch, kernel, ops, fkernel, fops
    import torch as _torch
    torch = _torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device (torch.cuda.is_available() is "
            "False); nothing was run")
        return 2
    if not (SRC / "repro_torch").is_dir():
        log(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
            "checkout of the repository")
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.flash_attention import kernel as _fk
    from repro_torch.kernels.flash_attention import ops as _fo
    from repro_torch.kernels.paged_attention import kernel as _k
    from repro_torch.kernels.paged_attention import ops as _o
    kernel, ops, fkernel, fops = _k, _o, _fk, _fo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()

    def done(phases: str) -> None:
        log(f"[{time.perf_counter() - t0:.1f} s] phase {phases} done")
    phase_build()
    done("1")
    errs = phase_correctness()
    ferrs = phase_flash_correctness()
    done("2")
    times = phase_timing()
    done("3")
    from repro_torch.configs import registry
    s = phase_serve(device, registry.get_config("qwen2-0.5b"))
    phase_spec(device, s["cfg"], s["params"])
    phase_profile(device, s["cfg"], s["params"])
    done("4-6")
    flash_launches = {
        "qwen2-0.5b": phase_prefill(device, "qwen2-0.5b", 4, s["params"]),
        "gemma-2b": phase_prefill(device, "gemma-2b", 1)}
    phase_grads(device, s["cfg"], s["params"])
    phase_recompute(device, s["cfg"], s["params"], s["prompts"],
                    s["greedy"])
    done("7-8")
    g = phase_serve(device, registry.get_config("gemma-2b"))
    phase_profile(device, g["cfg"], g["params"])
    done("9")
    coda = phase_coda(device, s["cfg"], s["params"])
    done("10")
    persist = phase_persist(device, s["cfg"], s["params"])
    done("11")
    disagg = phase_disagg(device, s["cfg"], s["params"])
    done("12")
    zoo = phase_zoo(device, s["cfg"], s["params"])
    done("13")
    phase_placement(device)
    done("14")
    phase_dense_decode(device, s["cfg"], s["params"], watch=True)
    phase_dense_decode(device, g["cfg"], g["params"], watch=False)
    phase_window_decode(device)
    done("15")
    del s["params"], g["params"]           # phase 16 needs the room
    fam = phase_families(device)
    done("16")
    served = {"qwen2-0.5b": s["greedy"]["launches"],
              "gemma-2b": g["greedy"]["launches"],
              "qwen2-vl-7b": fam["qwen2-vl-7b"]["served"]}
    paged_src = "src/repro_torch/csrc/paged_attention.cu"
    paged_tpu = "src/repro/kernels/paged_attention/kernel.py"
    # (name, timed row, source, TPU kernel's pallas_call); a row per entry
    # point and heads (and decode at context 4096), its launches from that
    # model's run (serving for the paged kernel, the phase-7 forwards for
    # flash; phase 16 for qwen2-vl-7b and granite), its error from the bf16
    # cases at that head dim
    table = [
        ("paged_attention", "paged_attention", paged_src, f"{paged_tpu}:317"),
        ("paged_attention", ("paged_attention", LONG_CTX), paged_src,
         f"{paged_tpu}:317"),
        ("paged_prefill_attention_batch", "paged_prefill_attention_batch",
         paged_src, f"{paged_tpu}:233"),
        ("paged_prefill_attention", "paged_prefill_attention", paged_src,
         f"{paged_tpu}:276"),
        ("flash_attention_bh", "flash_attention_bh",
         "src/repro_torch/csrc/flash_attention.cu",
         "src/repro/kernels/flash_attention/kernel.py:114"),
    ]
    rows = []
    # the rows at qwen2-vl-7b heads carry the error of their own timed
    # inputs against the plain version; the others phase 2's at that dtype
    # and head dim
    for tag, heads, entries in (
            ("qwen2-0.5b", MAIN, table), ("gemma-2b", GEMMA, table),
            ("qwen2-vl-7b", QWEN_VL, table),
            ("granite-moe-3b-a800m", GRANITE, table[-1:])):
        h = heads["h"]
        for name, timed, source, replaces in entries:
            if name == "flash_attention_bh":
                launches = (fam[tag]["flash"] if tag in fam
                            else flash_launches[tag])
                err = ferrs["bfloat16", h]
                inst = fkernel.instance(torch.bfloat16, h)
            else:
                launches = served[tag][name]
                err = errs[name, "bfloat16", h]
                inst = kernel.instance(torch.bfloat16, h)
            if name != "paged_prefill_attention":   # no call site on a path
                check(launches > 0, f"{name} never launched on the "
                      f"{tag} path")
            row = dict(times[timed, tag])
            err = row.pop("max_abs_err", err)
            rows.append(dict(name=name, route="cuda", source=source,
                             replaces=replaces, launches=launches,
                             max_abs_err=err, **row, instance=inst,
                             heads=f"{tag} {heads['nq']}/{heads['nkv']}/"
                                   f"{h}"))
            if tag == "qwen2-0.5b" and name != "flash_attention_bh":
                # phases 10-12, each counted apart from phase 4's
                rows[-1]["coda_launches"] = coda["launches"][name]
                rows[-1]["persist_launches"] = persist["launches"][name]
                rows[-1]["disagg_launches"] = disagg["launches"][name]
                rows[-1]["zoo_launches"] = zoo["launches"][name]
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
