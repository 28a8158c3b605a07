#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on a GPU.

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases (each failed check raises; the script then exits non-zero):

1. environment and build: torch/CUDA versions, the card's name and power
   limit, the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc for
   sm_90a;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes (qwen2-0.5b heads, bf16) and the smoke shapes (fp32), plus
   three bitwise properties on the kernel itself;
3. timing with CUDA events (L2 flushed before every launch) of kernel,
   plain version and a ``scaled_dot_product_attention`` yardstick, beside
   the least time the card could take (bytes at the HBM rate, or flops at
   the card's dense peak for the input type, whichever is larger);
4. full-width qwen2-0.5b serving (24 layers, seeded random weights) through
   ``ServeEngine`` on the BWAP pool: 8 requests x 32 new tokens, launch
   counters zeroed just before and read just after; one decode step is also
   run through the plain version and the logits compared;
5. speculative decode at full width on a repetition-friendly trace, counters
   zeroed again, verify steps through the prefill kernel;
6. a ``torch.profiler`` window over 3 full-width decode steps: the device's
   busy share and the kernels that fill it (informational).

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name and power limit; the last line is the result JSON.
Nothing here imports JAX: the machine with the card has none.
"""

from __future__ import annotations

import json
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
PS = 16                          # serving page size
MAIN = dict(nq=14, nkv=2, h=64)  # qwen2-0.5b attention heads
SMOKE = dict(nq=4, nkv=2, h=16)  # qwen2 smoke config heads
FLUSH_BYTES = 64 << 20           # > the H100's 50 MB L2

torch = None
kernel = ops = None


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
    for name, out in build.LOGS.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {line.strip()}")


# -- inputs --------------------------------------------------------------------

def _data(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        .to("cuda").to(getattr(torch, dtype))


def _ints(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to("cuda")


def _pools(rng, pool, nkv, h, dtype):
    return (_data(rng, (pool, PS, nkv, h), dtype),
            _data(rng, (pool, PS, nkv, h), dtype))


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


def phase_correctness() -> dict[str, float]:
    rng = np.random.default_rng(1)
    errs = {"paged_attention": 0.0, "paged_prefill_attention_batch": 0.0,
            "paged_prefill_attention": 0.0}

    def upd(name, e):
        errs[name] = max(errs[name], e)

    for heads, dtype in ((MAIN, "bfloat16"), (MAIN, "float32"),
                         (SMOKE, "float32")):
        nq, nkv, h = heads["nq"], heads["nkv"], heads["h"]
        pool, b, mp = 1280, 8, 60
        kp, vp = _pools(rng, pool, nkv, h, dtype)
        # decode: lengths on and next to page edges, up to 800 tokens
        lens = np.asarray([1, 15, 16, 17, 256, 257, 799, 800], np.int32)
        tbl = _ints(_tables(rng, -(-lens // PS), mp, pool))
        q = _data(rng, (b, nq, h), dtype)
        out = ops.paged_attention(q, kp, vp, tbl, _ints(lens))
        want = ops.paged_attention(q, kp, vp, tbl, _ints(lens),
                                   impl="reference")
        upd("paged_attention", _max_err(out, want, dtype))
        # prefill / verify chunks at ragged starts, context up to 800
        for t in (256, 7, 1):
            qs = np.asarray([0, 15, 16, 17, 240, 287, 500, 800 - t],
                            np.int32)
            tb = _ints(_tables(rng, -(-(qs + t) // PS), mp, pool))
            q = _data(rng, (b, t, nq, h), dtype)
            out = ops.paged_prefill_attention_batch(q, kp, vp, tb, _ints(qs))
            want = ops.paged_prefill_attention_batch(q, kp, vp, tb,
                                                     _ints(qs),
                                                     impl="reference")
            upd("paged_prefill_attention_batch", _max_err(out, want, dtype))
        q = _data(rng, (37, nq, h), dtype)
        tb1 = _ints(_tables(rng, [5], 5, pool)[0])
        out = ops.paged_prefill_attention(q, kp, vp, tb1, 40)
        want = ops.paged_prefill_attention(q, kp, vp, tb1, 40,
                                           impl="reference")
        upd("paged_prefill_attention", _max_err(out, want, dtype))
        _bitwise(rng, kp, vp, pool, heads, dtype)
    torch.cuda.synchronize()
    log("kernel vs plain version: max |err| " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tolerance {TOL['float32']} fp32 / {TOL['bfloat16']} bf16, "
        f"and bf16 within {BF16_ULPS[0]} |want| + {BF16_ULPS[1]})")
    return errs


def _bitwise(rng, kp, vp, pool, heads, dtype) -> None:
    """On the kernel: a fully masked trailing page changes nothing; decode
    equals verify row 0; real rows do not change when the batch is padded
    with extra rows."""
    nq, h = heads["nq"], heads["h"]
    b, t = 4, 5
    qs = np.asarray([37, 16, 790, 0], np.int32)
    need = -(-(qs + t) // PS)
    base_t = _tables(rng, need, need.max(), pool, repeat=False)
    ext_t = np.concatenate([base_t, rng.integers(0, pool, (b, 3))
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
    pad_q = torch.cat([q, _data(rng, (3, t, nq, h), dtype)])
    pad_t = np.concatenate([base_t, _tables(rng, [1, 2, 3], base_t.shape[1],
                                            pool)])
    pad_qs = np.concatenate([qs, np.asarray([3, 20, 40], np.int32)])
    padded = ops.paged_prefill_attention_batch(pad_q, kp, vp, _ints(pad_t),
                                               _ints(pad_qs))
    check(torch.equal(padded[:b], base), "batch padding changed bits")
    log(f"bitwise properties hold on the kernel ({dtype}, h={h})")


# -- phase 3 -----------------------------------------------------------------

def _timed(fn, iters: int = 20) -> float:
    """Mean ms per call; the L2 is flushed (not timed) before each call."""
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        scratch.zero_()
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
    ctx = int(max(q_start)) + t
    mp = -(-ctx // PS)
    idx = torch.as_tensor(tables[:, :mp], device="cuda").long()
    k = kp[idx].reshape(b, mp * PS, -1, h)[:, :ctx].transpose(1, 2)
    v = vp[idx].reshape(b, mp * PS, -1, h)[:, :ctx].transpose(1, 2)
    qpos = torch.as_tensor(q_start, device="cuda")[:, None] + \
        torch.arange(t, device="cuda")
    mask = torch.arange(ctx, device="cuda")[None, None] <= qpos[:, :, None]
    return (q4.transpose(1, 2).contiguous(), k.contiguous(), v.contiguous(),
            mask[:, None])


def phase_timing() -> dict[str, dict]:
    import torch.nn.functional as F
    rng = np.random.default_rng(2)
    heads, dtype, pool, b = MAIN, "bfloat16", 1280, 8
    nq, nkv, h = heads["nq"], heads["nkv"], heads["h"]
    kp, vp = _pools(rng, pool, nkv, h, dtype)
    rows = {}
    for name, t in (("paged_attention", 1),
                    ("paged_prefill_attention_batch", 256)):
        if t == 1:
            lens = rng.integers(128, 801, b).astype(np.int32)
            q_start = lens - 1
        else:
            q_start = rng.integers(0, 800 - t + 1, b).astype(np.int32)
        tables = _tables(rng, -(-(q_start + t) // PS), 50, pool,
                         repeat=False)
        tb = _ints(tables)
        q4 = _data(rng, (b, t, nq, h), dtype)
        if t == 1:
            q, ln = q4[:, 0].contiguous(), _ints(q_start + 1)
            run = lambda: ops.paged_attention(q, kp, vp, tb, ln)
            plain = lambda: ops.paged_attention(q, kp, vp, tb, ln,
                                                impl="reference")
        else:
            qs = _ints(q_start)
            run = lambda: ops.paged_prefill_attention_batch(q4, kp, vp, tb,
                                                            qs)
            plain = lambda: ops.paged_prefill_attention_batch(
                q4, kp, vp, tb, qs, impl="reference")
        sq, sk, sv, mask = _sdpa_inputs(q4, kp, vp, tables, q_start, t)
        lib = lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask, enable_gqa=True)
        got = run().float().reshape(b, t, nq, h)
        ref_out = lib().transpose(1, 2).float()
        lib_err = float((got - ref_out).abs().max())
        ms, plain_ms, lib_ms = _timed(run), _timed(plain, 5), _timed(lib)
        bound_ms, bound_by, core_ms = _bound(q_start, t, tables, heads,
                                             dtype)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=bound_ms, bound_by=bound_by)
        log(f"time {name} (B={b}, T={t}, ctx<=800, bf16, qwen2-0.5b heads):"
            f" kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"yardstick (SDPA over pre-gathered K/V, never called by the "
            f"port) {lib_ms:.4f} ms [|kernel-SDPA| {lib_err:.3g}], bound "
            f"{bound_ms:.5f} ms ({bound_by}; {dtype} peak "
            f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, HBM "
            f"{HBM_BYTES_PER_S / 1e12} TB/s) -- {smi_line()}")
        log(f"  {name}: the same flops on fp32 CUDA cores (what this kernel "
            f"uses, {CUDA_CORE_FLOPS / 1e12:.0f} TFLOP/s) take "
            f"{core_ms:.5f} ms; not the bound")
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
          check_decode=False) -> dict:
    """Drive ServeEngine over ``prompts`` (all submitted at once) on a fresh
    pool; launch counts zeroed just before the first step, read after the
    last. Returns tokens, counters, step times."""
    from repro_torch.placement.pool import BwapPagePool
    from repro_torch.serve.engine import ServeEngine
    pool = BwapPagePool(cfg, _domains(), page_size=PS, device=device)
    eng = ServeEngine(cfg, params, pool, max_batch=8, max_new=max_new,
                      wall_clock=False, drafter=drafter, device=device)
    for prompt in prompts:
        eng.submit(prompt)
    logit_err = None
    step_s, decode_s, prefill_steps = [], [], 0
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
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
    launches = dict(kernel.LAUNCHES)
    eng.view.fabric.check_invariants()
    reclaimed = (pool.free_count() + int(pool.reserved.sum())
                 == pool.total_pages and not pool.table.ref)
    spec = pool.telemetry.snapshot()["spec"]
    return dict(tokens={s.sid: list(s.tokens) for s in eng.finished},
                produced=[s.produced for s in eng.finished],
                finished=len(eng.finished), steps=len(step_s),
                decode_steps=eng.decode_steps, prefill_steps=prefill_steps,
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
    err = float((fast - plain).abs().max())
    agree = int((fast.argmax(-1) == plain.argmax(-1)).sum())
    log(f"decode step, kernel vs plain version, full width: max |logit "
        f"diff| {err:.4g} (bf16 gate {LOGIT_TOL}; |logit| up to "
        f"{float(plain.abs().max()):.3g}), argmax agrees on {agree}/"
        f"{len(seqs)} rows")
    check(err <= LOGIT_TOL, f"decode logits differ by {err} > {LOGIT_TOL}")
    return err


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
    _report("full-width greedy serving", r)
    nl = cfg.num_layers
    check(r["finished"] == 8 and r["produced"] == [32] * 8,
          f"finished {r['finished']}, produced {r['produced']}")
    check(r["launches"]["paged_attention"] == r["decode_steps"] * nl,
          "a decode step did not go through the decode kernel")
    check(r["launches"]["paged_prefill_attention_batch"]
          == r["prefill_steps"] * nl,
          "a prefill step did not go through the prefill kernel")
    check(r["reclaimed"], "pool not fully reclaimed")
    check(r["logit_err"] is not None, "decode check never ran")
    return dict(cfg=cfg, params=params, greedy=r)


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


def phase_profile(device, cfg, params) -> None:
    """torch.profiler over 3 full-width decode steps at batch 8 (context
    ~400): the device's busy share of the window and the kernels that fill
    it. Informational: nothing here gates."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    log(f"profile, {steps} decode steps at batch 8: {1e3 * wall / steps:.2f}"
        f" ms per step (profiler on), device busy {busy / wall:.1%} of the "
        f"window -- {smi_line()}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count // steps:5d}/step  {e.key[:90]}")


# -- main --------------------------------------------------------------------

def main() -> int:
    global torch, kernel, ops
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
    from repro_torch.kernels.paged_attention import kernel as _k
    from repro_torch.kernels.paged_attention import ops as _o
    kernel, ops = _k, _o
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()
    phase_build()
    errs = phase_correctness()
    times = phase_timing()
    from repro_torch.configs import registry
    s = phase_serve(device, registry.get_config("qwen2-0.5b"))
    phase_spec(device, s["cfg"], s["params"])
    phase_profile(device, s["cfg"], s["params"])
    greedy = s["greedy"]
    replaces = {"paged_attention":
                "src/repro/kernels/paged_attention/kernel.py:317",
                "paged_prefill_attention_batch":
                "src/repro/kernels/paged_attention/kernel.py:233"}
    rows = []
    for name in ("paged_attention", "paged_prefill_attention_batch"):
        check(greedy["launches"][name] > 0, f"{name} never launched")
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/paged_attention.cu",
            replaces=replaces[name], launches=greedy["launches"][name],
            max_abs_err=errs[name], **times[name]))
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
