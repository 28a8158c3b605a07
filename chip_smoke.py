#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (``src/repro_torch``) runs on a GPU.

    python3 chip_smoke.py            # one CUDA card, no arguments

Phases (each failed check raises; the script then exits non-zero):

1. environment and build: torch/CUDA versions, the card's name and power
   limit, the CUDA kernels built from ``src/repro_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, all started together); ptxas registers,
   spills and dynamic shared memory per kernel instance, and ptxas's
   performance warnings (serialised wgmma in a tensor-core instance fails
   the phase, and any warning or spill in the weight product's or the
   fused add + RMSNorm's); the norm's 32 vector-layout instances must load
   and store 128 bits at a time in their SASS (``LDG.E.128``,
   ``STG.E.128``); the bf16 flash instances, the bf16 paged instances at
   h = 64, 128, 256 (four a head dim: the split and the serial route, each
   with two walking consumer warpgroups or one) and the weight product's
   bf16 instances (``rowwise_matmul.kernel.INSTANCES``) must hold HGMMA
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
   at each; flash at S = T = 4096 at qwen2-0.5b, gemma-2b, qwen2-vl-7b,
   granite-moe-3b-a800m, hymba-1.5b (window 1024; SDPA given the window
   as a boolean mask) and whisper-tiny heads (the last four held against
   the plain version on the timed inputs, as the qwen2-vl-7b paged
   rows);
4. full-width qwen2-0.5b serving (24 layers, seeded random weights) through
   ``ServeEngine`` on the BWAP pool: 8 requests x 32 new tokens, launch
   counters zeroed just before and read just after, every paged launch on
   the instance its dtype and head dim select; one decode step is also
   run through the plain version and the logits compared (within 0.1, and
   on every row a token that is an argmax of both versions: bf16 logits
   can tie exactly in either, and a tie passes either token; the gate of
   phases 4, 7 and 9-12);
5. speculative decode at full width on a repetition-friendly trace, counters
   zeroed again, verify steps through the prefill kernel; its tokens equal
   greedy's on 8 of 8 sequences (gated: the decoder's weight products and
   norms are row-invariant, phases 25 and 26);
6. a ``torch.profiler`` window over 3 full-width decode steps: the device's
   busy share, the device kernels a step and the kernels that fill it, by
   time and by count (informational);
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
   request's spans and one ``rehome`` span a re-homing step; the two
   policies' tokens equal on every request (a micro-batch's rows compute
   the global batch's bits). Printed: the counters beside
   ``BENCH_coda.json``'s, p50 step times and launches a step, and the
   observatory's
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
   The cold restart's tokens equal the uninterrupted engine's (its
   prefill runs other chunks, whose rows compute the same bits). Printed:
   the TTFT ratio beside ``BENCH_persist.json``'s, synchronised wall ms of
   each step;
12. prefill/decode disaggregation at full width: ``disagg_run`` (a prefill
   host at page 4 hands each prompt's range over the Eq.-5-striped wire to
   a decode host at page 8; every Eq.-1 bandwidth x 48, the wire's links
   too, and the wire's chunk size, so a handoff takes the smoke run's
   chunks). Gates: 10 handoffs, 10 converted imports, 0 fallbacks, both
   fabrics' invariants; the first handoff's re-chunked K/V equal the
   prefill host's token for token; the decode host's first decode step
   over imported pages holds the plain logits; tokens equal the single
   host's on every request. Printed: wire bytes beside
   ``BENCH_disagg.json``'s, and
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
   gate), every paged launch on the tensor-core instance, the chat
   tokens equal across the two modes. Printed: steps, goodput ratio and
   granted bytes beside ``BENCH_zoo.json``'s, p50 zoo step;
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
   ms a forward and a ``decode_step``;
17. the hybrid, xLSTM and encoder-decoder families at full width, each
   model freed before the next is built: hymba-1.5b (32 layers, d 1600,
   25/5 heads of 64, SSM state 16, inner 3200; fp32 params): prefill and
   loss at B = 1, S = 4096, exactly 32 flash launches a forward, 29 at
   window 1024 and 3 global (the windows the op receives are recorded),
   the loss (1e-2) against the chunked path; every launch of a third
   forward held against the plain version on the model's own activations
   (two bf16 ulps), and its logits at the last 64 positions against the
   chunked path within the larger of 0.1 and the chunked path's own move
   when the embedding is nudged one bf16 ulp (measured in the same run:
   32 bf16 layers amplify rounding past 0.1), the last token's argmax by
   phase 4's rule, and a window-blind forward must miss that bound on
   every row; then, cut to 4 layers (layer 0 global, 1-3 at window
   1024), ``decode_step`` over an 1100-token prompt against the flash
   forward, each logit at every
   position within the larger of 0.1 and one bf16 ulp of it, the argmax
   rule of phase 4's gate at positions 1022-1026 and 1095-1099 (over all
   positions the argmax flips are printed, not gated); xlstm-125m (12
   layers, d 768, 4 heads of 192, sLSTM at 3 and 9; fp32 params): the
   forward and the loss at B = 1, S = 4096, finite, no kernel launched,
   then ``decode_step`` over 512 tokens (two mLSTM chunks) against the
   forward, in bf16 compute (the gap printed: the exponential gates of
   12 layers amplify bf16 rounding) and in fp32 compute, each logit at
   every position within 0.1, the argmax rule at 254-258 and 507-511;
   whisper-tiny (4 + 4 layers, d 384, 6/6 heads of
   64, vocab 51865; fp32 params): prefill and loss at B = 8 over 1500
   seeded frames and 448 tokens, exactly 4 flash launches a forward (the
   decoder's self-attention; the encoder and the cross-attention take the
   chunked path), logits (0.1) and loss (1e-2) against the chunked path;
   then ``ck``/``cv`` written from ``encode`` and 64 tokens decoded, the
   last step against ``prefill`` of the same tokens. Printed: ms a
   forward and a ``decode_step``;
18. the training path: (a) qwen2-0.5b at full width and depth (fp32
   params, bf16 compute, ``remat="full"``) trained 3 steps by
   ``make_train_step`` at global batch 8 (``train_4k``'s 256, cut) and
   S = 4096, as 2 microbatches of 4 (``accum_steps_for``), from a seeded
   ``ShardedTokenDataset``: ``make_eval_step`` on the step-0 batch's last
   microbatch launches exactly 24 flash kernels (tensor-core instance)
   and its loss is within 1e-2 of step 0's training loss (the chunked
   branch), the training steps launch none, losses and grad norms are
   finite; ms a step, tokens/s and the peak of
   ``max_memory_allocated`` printed, then a ``torch.profiler`` window
   over one more step (informational, as phase 6's). At 2 layers (the
   head's fp32 logits at B = 8, S = 4096 fit no depth without
   accumulation), S = 2048: the
   grads of 2 microbatches of 4 against one batch of 8 within 2e-2
   relative L2 (bf16 compute); at 2 layers, B = 2, S = 1024: a
   ``Trainer`` with ``fail_at_step`` raises ``SimulatedFailure``, a new
   one resumes from the last checkpoint and ends within 2e-4 of an
   uninterrupted run's params. (b) 8 layers, B = 1, S = 4096: the grads
   with ``remat="full"`` equal ``"none"``'s bit for bit (deterministic
   algorithms on) at a lower peak. (c) deepseek-v3's optimizer layout
   (int8 moments, no fp32 master) on qwen2-0.5b with bf16 params, 3
   steps at B = 2: finite losses, int8 ``q`` and fp32 ``scale`` in every
   moment, a checkpoint round trip of the state bit for bit. (d)
   ``compressed_psum_grads`` over a one-rank NCCL group on the full-depth
   gradients: the reference test's error bound and residual identity.
   (e) ``python -m repro_torch.launch.train --smoke`` and
   ``examples/torch_train_lm.py``, 3 steps each on the card;
19. the dry-run (``repro_torch.launch.dryrun``, fake tensors on the host)
   held against the card, three cells, each record printed on a line of
   its own: (a) qwen2-0.5b's train cell on a one-device mesh at phase
   18a's shape (B = 8 as 2 x 4, S = 4096, ``remat="full"``): its FLOPs
   equal ``FlopCounterMode`` over one real ``make_train_step`` step on
   the card exactly, its predicted peak is within 10 % of phase 18a's
   ``max_memory_allocated`` and of that step's own, and its compute bound
   is at or below phase 18a's measured step (measured / bound printed,
   and against the memory term); (b) qwen2-0.5b's ``decode_32k`` cell (B
   = 128) on a one-device mesh: its argument bytes within 1 % of
   ``memory_allocated`` after ``init`` and ``init_cache`` on the card,
   and its FLOPs equal ``FlopCounterMode`` over one real ``decode_step``
   exactly; (c) xlstm-125m x ``decode_32k`` x the single-pod mesh under
   the reference test's limits (OK, a memory term, under 16 GiB a
   device).

20. sharded compute (the train and eval steps on DTensor params): (a) a
   real one-rank NCCL group (its store a TCP store on localhost) and a
   (1, 1) (data, model) ``DeviceMesh``; qwen2-0.5b at full width and
   depth, B = 4 as 2 microbatches of 2 at S = 4096, ``remat="full"``: the
   sharded ``make_train_step`` with ``grad_specs`` and ``mb_specs`` on the
   params of one one-device step (phase 18a's function): loss within 1e-2,
   updated params within 2e-2 relative L2 (phase 18's gate), ``grad_norm``
   within 1e-2 relative; ``make_eval_step`` on the DTensor params launches
   the flash kernel 24 times on each rank's local heads (``on_shards``),
   its loss within 1e-2 of the train loss. (b) one rank of the production
   single-pod mesh: a fake process group of 256 ranks (a ``HashStore``; it
   moves no data) and a (16, 16) mesh; internlm2-20b at full width and
   depth (48 layers, ``act_spec`` on), 16 sequences of 4096 (one a data
   rank), accumulation 1, ``remat="full"``, params and state made shard by
   shard. The dry-run's traced record of that cell (printed on a line of
   its own) holds the real step: its peak within 10 % of
   ``max_memory_allocated``, its FLOPs equal to ``RankFlops`` over the
   step, its collectives by kind equal to ``CommDebugMode``'s. The loss is
   not gated (the collectives move no data) and the step time printed is
   rank 0's compute with collectives that move nothing.
21. sharded prefill and decode: (a) qwen2-0.5b on phase 20's one-rank
   group: the sharded prefill (24 flash launches on local heads) and 64
   decode steps over a shard-local cache against the one-device path
   (``_logits_gate``, equal greedy tokens); (b) rank 0 of
   deepseek-v3-671b's ``decode_32k`` cell on a fake group of 256
   (``_production_cell``): peak and arguments within 10 % of the
   dry-run's traced record, FLOPs and collectives by kind equal, no
   collective takes or gathers a ``ckv``/``kpe`` shard.
22. the VLM, hybrid, SSM and encoder-decoder families on shards: (a) on a
   one-rank NCCL group and a (1, 1) mesh, hymba-1.5b, qwen2-vl-7b (1024
   stub patches, ``act_spec`` on), whisper-tiny and xlstm-125m at full
   width and depth: the sharded prefill at B 2 x S 4096 against the
   one-device prefill (flash launches on local heads exactly 32, 28, 4
   and 0; ``_logits_gate``), 2 prompt and 16 greedy decode tokens over a
   shard-local cache equal to the one-device path's; one sharded hymba
   train step (B 2 x S 1024) against the one-device step (phase 20a's
   gates); (b) rank 0 of qwen2-vl-7b's ``prefill_32k`` and hymba-1.5b's
   ``decode_32k`` cells on a fake group of 256, nothing cut, against
   their dry-run records (traced by two processes while (a) runs): 21b's
   gates, no collective taking or gathering a ``k``/``v``/``h``/``conv``
   shard.
23. the engine cases of the reference's page-table, scheduler and
   speculation tests at full width (qwen2-0.5b, phase 4's weights,
   page 16; runs after phase 15, while those weights are alive): the
   reference tests' pools, with prompts scaled so a sequence holds the
   reference's pages (``_cq``). Prefix sharing (4 prefix-hit pages, fewer
   prefill tokens than unshared); the CoW fork on a full prompt match
   (the clone bit-equal to its source when made, the source untouched
   by the write through the clone); a swap round trip with two shared
   pages pinned (the parked bytes and, after the swap-in, every K/V
   position bit-equal to the bytes before); forced preemption at decode
   steps 0, 2 and 5 (completes, ledgers drain, tokens equal an
   unpressured run's: one sequence, the same GEMM shapes); speculation
   with every draft rejected across two mid-page sequences (after each
   step free lists, refcounts, trie, allocation cycle and page ids equal
   a greedy engine's, and every K/V slot but the committed ones bit for
   bit); 12 bursty requests oversubscribing the pool (zero failures,
   swaps out equal swaps in), infeasible submits refused and joint
   exhaustion raising. The fabric's invariants hold after every step;
   each scenario also runs on the host at the one-layer fp32 smoke
   config and its control plane (page ids after every step, free lists,
   refcounts, trie, cycle) must equal the card's; every prefill and
   verify step goes through ``paged_prefill_attention_batch`` and every
   decode step through ``paged_attention``, on the tensor-core instance,
   and nothing launches flash; shared serving's tokens equal unshared
   serving's, and after a rejected verify the committed slots' K/V and
   the tokens equal greedy's (a row's bits do not depend on the GEMM's
   row count);
24. the entry points on the card: ``torch_serve_bench.speculative_compare``
   at the reference's smoke config (zero failures and greedy's tokens
   gated, the step ratio logged against the reference's 1.3), then
   ``python -m benchmarks.torch_run --device cuda`` in its own process
   (exit 0, every ``BENCH_torch_*.json`` written and passing
   ``torch_artifacts.check()``; each section's seconds printed); then the
   serving CLIs side by side, each in a process of its own on the card
   with its defaults and then with ``--device cpu``:
   ``python -m repro_torch.launch.serve`` (4/4 sequences served on cuda,
   sequences and steps equal to the host run's),
   ``examples/torch_serve_paged.py`` (N/N finished, swaps out equal swaps
   in), its ``--restart-demo`` (the restored trie matches every exported
   page) and ``examples/torch_coscheduled.py`` (tokens equal between the
   fabric run and isolated partitions, the loan ending with 0
   outstanding); each exits 0 and prints the host run's summary, token
   snippets aside;
25. the row-invariant kernels (``csrc/rowwise_matmul.cu``,
   ``csrc/rowwise_rmsnorm.cu``; runs after phase 3): the product at every
   weight shape of qwen2-0.5b, gemma-2b and qwen2-vl-7b (each weight the
   transpose of a contiguous [N, K], as the decoder stores it on a card;
   the tied heads the embedding's), bf16 and fp32: each row of launches of
   1, 8, 40 rows at offsets 0, 7 and the end equal bit for bit to the same
   row of a 256-row launch (the engine's largest prefill chunk); the RMS
   error against an fp64 product no larger than ``torch.matmul``'s on the
   same inputs (up to three standard errors); bf16 times at M = 8, 40,
   256 beside ``torch.matmul`` and the bound, each shape's plan (wgmma
   width, splits of K, blocks a row tile) and the wrapper's host
   microseconds a call. The fused residual add + RMSNorm at each model's
   width, both dtypes: ``s`` equal to torch's ``x + y``, the rows of ``s``
   and ``h`` bit-equal across M (with ``y`` and without), ``h`` within two
   bf16 ulps of the plain version; whether torch's own reduction keeps
   rows across M, logged; times at M = 8 and 256 beside torch's ``x + y``
   followed by the launch without ``y`` (the two launches it replaces) or
   by ``F.rms_norm`` (the library pair), and the bound;
26. a row through the whole full-width decoder (qwen2-0.5b, phase 4's
   weights; runs after phase 4): alone, in a batch-8 decode step and in
   an 8 x 25 verify chunk, the same logits and K/V bit for bit, every
   batch row equal to row 0 of its chunk; the same rows with the products
   as ``a @ w`` and with the norms as torch's add and reduction, logged
   (F7's
   cause);
27. the reference's observability contract at full width
   (``tests/test_obs.py``'s ``traced_runs``; qwen2-0.5b, phase 4's
   weights; runs after phase 23): a poisson trace of 5 requests in two
   classes (drawn over the smoke config's vocabulary) over domains of 8,
   8 and 40 pages at page 4, Eq.-1 bandwidths x 48 as phases 10-13,
   ``max_batch`` 3, 90 % of the slow domains reserved for swap, the
   virtual clock at 0.01 s a step; once with ``Observatory(pool,
   drift=False)`` and once without, a contract validator on every fabric
   event, counts zeroed before the two runs. Gates: equal tokens, swaps
   out (> 0) equal swaps in; the preempted request's admit, prefill,
   decode, swap_out, swap_in and finish spans, no queued span negative,
   its track opening with admit and closing with finish; the exported
   trace Perfetto-loadable by the reference case's rules and its events
   (names, tracks, virtual-clock times, arguments) equal to the same
   scenario's on the host at the one-layer fp32 smoke config; 5 admits
   and 5 finishes; the step-latency histogram's count and p50 above 0;
   no contract violation and no subscriber error; every Prometheus line
   a HELP, TYPE or sample line, every family of the host run present;
   every prefill step through ``paged_prefill_attention_batch`` and every
   decode step through ``paged_attention`` (24 a step) on the
   tensor-core instance, nothing through flash.

The lines before the last two are phases 19-22's records, then the
kernels' JSON record (a row per entry
point at qwen2-0.5b, gemma-2b and qwen2-vl-7b heads and flash at
granite-moe-3b-a800m, hymba-1.5b and whisper-tiny heads, each naming its
instance and context, and the context-4096 decode rows; the rows at
qwen2-vl-7b, granite, hymba and whisper heads carry the error of their
phase-3 inputs against the plain version, and their launches from phases
16 and 17; the qwen2-0.5b
paged rows also carry phases 10-13's ``coda_launches``,
``persist_launches``, ``disagg_launches`` and ``zoo_launches``, the last
summed over the zoo's two modes, phase 23's ``contract_launches`` and
phase 27's ``obs_launches``;
then a ``rowwise_matmul`` and a ``rowwise_rmsnorm`` row at qwen2-0.5b,
gemma-2b and qwen2-vl-7b, timed by phase 25 at decode (the head's
product, the final norm with its residual add), launched by that model's
serving run (the norm's row with its fused launches, ``add_launches``,
and, since no one PyTorch call adds and normalises, ``library_ms`` null
beside ``library_pair_ms``, torch's ``x + y`` then ``F.rms_norm``), the
qwen2-0.5b rows with phase 5's ``spec_launches``, phase 10's
``coda_launches`` and phase 27's ``obs_launches``) and the card's
``nvidia-smi`` name and power limit; the last
line is the result JSON. Nothing here imports JAX: the machine with the
card has none.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
HYMBA = dict(nq=25, nkv=5, h=64)     # hymba-1.5b attention heads
HYMBA_WINDOW = 1024                  # hymba-1.5b's sliding window
WHISPER = dict(nq=6, nkv=6, h=64)    # whisper-tiny attention heads
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
rkernel = rref = None            # row-invariant weight product
nkernel = nref = None            # row-invariant RMSNorm


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


def _reset_counts() -> None:
    """Every kernel's launch counts to 0."""
    for m in (kernel, fkernel, rkernel, nkernel):
        m.reset_launch_counts()


def _counts() -> dict:
    """Every kernel's launch counts, by wrapper and instance."""
    return {**kernel.LAUNCHES, **fkernel.LAUNCHES, **rkernel.LAUNCHES,
            **nkernel.LAUNCHES}


def _snap() -> list:
    """The counts of the kernels a decode step launches, to put back after
    launches made only to compare with a plain version (``_restore``)."""
    return [(m, dict(m.LAUNCHES)) for m in (kernel, rkernel, nkernel)]


def _restore(saved) -> None:
    for m, counts in saved:
        m.LAUNCHES.update(counts)


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
    spills = []
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
            # the weight product's tensor-core instances and the norm's
            # instances must not spill
            if ("rowwise_wgmma" in fn or name == "rowwise_rmsnorm") and \
                    "0 bytes spill stores, 0 bytes spill loads" not in spill:
                spills.append(f"{fn}: {spill}")
        # ptxas's performance warnings; serialised wgmma (C7510-C7520)
        # in a tensor-core instance fails the phase, any C75xx warning in
        # the weight product's or the norm's
        for line in out.splitlines():
            if "(C75" in line:
                log(f"  ptxas[{name}] {line.split('info', 1)[-1].strip()}")
                check("serialized" not in line or "wgmma_kernel" not in line,
                      f"ptxas serialised a tensor-core instance's wgmma: "
                      f"{line.strip()}")
                check("rowwise_wgmma" not in line
                      and name != "rowwise_rmsnorm",
                      f"ptxas warns on {name}: {line.strip()}")
    check(not spills, f"ptxas spills in the weight product or the norm: "
          f"{spills}")
    _check_norm_vectors(build)
    _check_tensor_cores(build, "flash_attention", "flash_wgmma_kernel",
                        len(fkernel.WGMMA_HEAD_DIMS))
    # a paged instance per head dim, route, and block shape (two consumer
    # warpgroups, or one for launches of at most 64 rows)
    _check_tensor_cores(build, "paged_attention", "paged_wgmma_kernel",
                        len(kernel.WGMMA_HEAD_DIMS) * len(kernel.ROUTES) * 2)
    # the weight product's bf16 instances (wgmma width, tile columns, rows)
    _check_tensor_cores(build, "rowwise_matmul", "rowwise_wgmma",
                        len(rkernel.INSTANCES))
    for inst in rkernel.INSTANCES:
        check(rkernel.smem_bytes(*inst) > 0,
              f"rowwise_matmul: no bf16 instance {inst} built")
    log("rowwise_matmul bf16 instances (wgmma width, tile columns x rows: "
        "dynamic shared memory): " + ", ".join(
            f"{b}, {t} x {r}: {rkernel.smem_bytes(b, t, r)} bytes"
            for b, t, r in rkernel.INSTANCES))
    for h in kernel.WGMMA_HEAD_DIMS:
        check(kernel.layout(h) == (kernel.TILE_KEYS[h], kernel.CHUNK_TILES[h]),
              f"paged h={h}: built layout {kernel.layout(h)} != the "
              f"wrapper's (keys a tile, tiles a chunk)")
    log("paged tensor-core layout (keys a tile, tiles a key chunk): "
        + ", ".join(f"h {h}: {kernel.TILE_KEYS[h]}, {kernel.CHUNK_TILES[h]}"
                    for h in kernel.WGMMA_HEAD_DIMS))


def _check_norm_vectors(build) -> None:
    """Every instance of the fused add + RMSNorm built for the vector
    layout (16-byte chunks: template argument VEC 8 in bf16, 4 in fp32)
    loads and stores 128 bits at a time in its SASS (``LDG.E.128``,
    ``STG.E.128``); the scalar instances are listed beside them."""
    so = build.library_path("rowwise_rmsnorm")
    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "LDG.E.128" in line
            counts[fn][1] += "STG.E.128" in line
    vec, scalar, bad = [], [], []
    for name, (ld, st) in zip(_short_names(build, list(counts)),
                              counts.values()):
        m = re.match(r"add_rmsnorm_rows<\w+, \w+, (\d+), \d+, \w+>", name)
        if m is None:
            continue
        wide = int(m.group(1)) > 1
        (vec if wide else scalar).append(f"{name} {ld}/{st}")
        if wide and (ld == 0 or st == 0):
            bad.append(name)
    log(f"SASS of {so.name}: 128-bit loads/stores per vector instance: "
        + ", ".join(vec) + f"; {len(scalar)} scalar instances")
    check(len(vec) == 32 and not bad,
          f"rowwise_rmsnorm: {len(vec)} vector instances, want 32; "
          f"without 128-bit loads or stores: {bad}")


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


def _check_tensor_cores(build, lib, tc_kernel, n_tc, op="HGMMA") -> None:
    """The ``n_tc`` tensor-core instances of library ``lib`` (the kernels
    named ``tc_kernel``) have ``op`` instructions in their SASS
    (``cuobjdump -sass``): HGMMA (wgmma) or HMMA (mma.sync)."""
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
        elif fn is not None and op in line:
            counts[fn] += 1
    wgmma = {k: v for k, v in counts.items() if tc_kernel in k}
    names = _short_names(build, list(counts))
    log(f"SASS of {so.name}: {op} instructions per kernel "
        + ", ".join(f"{n} {v}" for n, v in zip(names, counts.values())))
    check(len(wgmma) == n_tc and all(v > 0 for v in wgmma.values()),
          f"the tensor-core instances of {lib} lack {op}: {wgmma}")


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


def _flash_row(rng, heads, s, tag, gate=False, window=0) -> dict:
    """Time the flash kernel, its plain version (S <= 4096: it holds
    [B,nkv,g,S,T] fp32 scores) and SDPA (causal, GQA; with a ``window``
    its mask as a boolean [S,T] ``attn_mask``) at B = 1, S = T, bf16,
    causal. With ``gate`` (S <= 4096) the kernel is first held against its
    plain version on these inputs, and the row carries that error."""
    import torch.nn.functional as F
    dtype = "bfloat16"
    q, k, v = _flash_inputs(rng, 1, s, s, heads, dtype)
    run = lambda: fops.flash_attention(q, k, v, window=window)
    plain = lambda: fops.flash_attention(q, k, v, window=window,
                                         impl="reference")
    sq, sk, sv = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window:
        i = torch.arange(s, device=q.device)
        d = i[:, None] - i[None, :]
        mask = (d >= 0) & (d < window)
        lib = lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(
            sq, sk, sv, is_causal=True, enable_gqa=True)
    lib_err = float((run().float() - lib().transpose(1, 2).float())
                    .abs().max())
    long = s > PREFILL_S         # the plain version would need > 8 GB
    iters, warm = (3, 1) if long else (20, 3)
    ms = _timed(run, iters, warm)
    lib_ms = _timed(lib, iters, warm)
    plain_ms = None if long else _timed(plain, 3, 1)
    bound_ms, bound_by = _flash_bound(1, s, s, heads, dtype, window)
    plain_txt = "not run (S > 4096)" if long else f"{plain_ms:.4f} ms"
    how = f"window {window} mask" if window else "is_causal"
    log(f"time flash_attention ({tag} heads nq {heads['nq']}/nkv "
        f"{heads['nkv']}/h {heads['h']}, B=1, S=T={s}, bf16, causal"
        f"{f', window {window}' if window else ''}): "
        f"kernel {ms:.4f} ms, plain {plain_txt}, library yardstick (SDPA, "
        f"{how}, enable_gqa; never called by the port) {lib_ms:.4f} ms "
        f"[|kernel-SDPA| {lib_err:.3g}], bound {bound_ms:.5f} ms "
        f"({bound_by}; bf16 peak {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, "
        f"HBM {HBM_BYTES_PER_S / 1e12} TB/s), kernel/bound "
        f"{ms / bound_ms:.1f}x, kernel/SDPA {ms / lib_ms:.2f}x -- "
        f"{smi_line()}")
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if window:
        row["window"] = window
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
    the flash rows (and flash at granite-moe-3b-a800m, hymba-1.5b (window
    1024) and whisper-tiny heads); keyed (entry point, heads) for the JSON
    record. The rows at the heads of phase 16's and 17's models also hold
    the kernel against its plain version on their inputs."""
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
    for tag, heads, window in (("qwen2-vl-7b", QWEN_VL, 0),
                               ("granite-moe-3b-a800m", GRANITE, 0),
                               ("hymba-1.5b", HYMBA, HYMBA_WINDOW),
                               ("whisper-tiny", WHISPER, 0)):
        rows["flash_attention_bh", tag] = _flash_row(
            frng, heads, PREFILL_S, tag, gate=True, window=window)
    for key in ("qwen2-0.5b", "gemma-2b", "qwen2-vl-7b",
                "granite-moe-3b-a800m", "hymba-1.5b", "whisper-tiny"):
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
    step_s, decode_s, prefill_s = [], [], []
    torch.cuda.synchronize()
    _reset_counts()
    while eng.active or eng.waiting:
        if check_decode and logit_err is None:
            logit_err = _decode_plain_check(eng)
        c0, d0 = eng.prefill_chunks_run, eng.decode_steps
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - s0
        step_s.append(dt)
        if eng.prefill_chunks_run > c0:
            prefill_s.append(dt)
        if eng.decode_steps > d0:
            decode_s.append(dt)
        check(len(step_s) < 10_000, "serving did not finish")
    launches = _counts()
    eng.view.fabric.check_invariants()
    reclaimed = (pool.free_count() + int(pool.reserved.sum())
                 == pool.total_pages and not pool.table.ref)
    spec = pool.telemetry.snapshot()["spec"]
    return dict(tokens={s.sid: list(s.tokens) for s in eng.finished},
                produced=[s.produced for s in eng.finished],
                finished=len(eng.finished), steps=len(step_s),
                decode_steps=eng.decode_steps, prefill_steps=len(prefill_s),
                prefill_chunks=eng.prefill_chunks_run,
                verify_steps=spec["steps"], spec=spec, launches=launches,
                reclaimed=reclaimed, wall_s=sum(step_s), step_s=step_s,
                decode_s=decode_s, prefill_s=prefill_s,
                tokens_emitted=eng.tokens_emitted,
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
    saved = _snap()
    fast = d.decode_step(*args).float()
    impl, d.impl = d.impl, "reference"
    try:
        plain = d.decode_step(*args).float()
    finally:
        d.impl = impl
    _restore(saved)
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


def _check_rowwise(cfg, r) -> None:
    """Every weight product and norm of serving run ``r`` went through the
    row-invariant kernels, on the instance the compute dtype selects: a
    forward runs 4 attention and 2 or 3 MLP products and 2 norms a layer,
    and the head and the final norm where it returns logits (a decode
    launch or a verify step, not a prefill step). Every norm but layer 0's
    first adds its residual in the same launch, but in a prefill step the
    last layer's add, which nothing reads: 2L fused launches a logits
    forward, 2L - 1 a prefill step."""
    nl, n = cfg.num_layers, r["launches"]
    per_layer = 4 + (3 if cfg.act in ("silu", "geglu") else 2)
    logits = n["paged_attention"] // nl + r["verify_steps"]
    prefill = r["prefill_steps"]
    want_mm = logits * (per_layer * nl + 1) + prefill * per_layer * nl
    want_norm = logits * (2 * nl + 1) + prefill * 2 * nl
    want_add = logits * 2 * nl + prefill * (2 * nl - 1)
    inst = rkernel.instance(getattr(torch, cfg.compute_dtype))
    check(n["rowwise_matmul"] == want_mm and n[inst] == want_mm,
          f"{cfg.name}: {n['rowwise_matmul']} row-invariant products "
          f"({n[inst]} on {inst}), want {want_mm}")
    check(n["rowwise_rmsnorm"] == want_norm,
          f"{cfg.name}: {n['rowwise_rmsnorm']} row-invariant norms, want "
          f"{want_norm}")
    check(n["rowwise_add_rmsnorm"] == want_add,
          f"{cfg.name}: {n['rowwise_add_rmsnorm']} fused residual adds, "
          f"want {want_add}")


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
    _check_rowwise(cfg, r)
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
    _check_rowwise(cfg, spec)
    same = sum(greedy["tokens"][k] == spec["tokens"].get(k)
               for k in greedy["tokens"])
    log(f"speculative: drafted {spec['spec']['drafted']}, accepted "
        f"{spec['spec']['accepted']}, {spec['verify_steps']} verify steps, "
        f"decode steps {spec['decode_steps']} vs greedy "
        f"{greedy['decode_steps']}; tokens equal greedy's on {same} of 8 "
        f"sequences (gated: the weight products and norms are "
        f"row-invariant, so a verify row computes greedy's bits)")
    check(same == 8 and spec["finished"] == greedy["finished"] == 8,
          f"speculative tokens equal greedy's on {same} of 8 sequences")
    return spec


def _profile(tag: str, fn, reps: int, unit: str, cpu: bool = True) -> float:
    """torch.profiler over ``reps`` calls of ``fn``: the device's busy share
    of the window, the number of device kernels a call and the kernels that
    fill it. Informational: nothing here gates. ``cpu=False`` records the
    device's activity only (a train step's ~10^5 host ops take longer to
    process than the step). Returns the device kernels a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launched = sum(e.count for e in kernels) / reps
    log(f"profile, {tag}: {1e3 * wall / reps:.2f} ms per {unit} (profiler "
        f"on), device busy {busy / wall:.1%} of the window, {launched:g} "
        f"device kernels a {unit} -- {smi_line()}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms/{unit} "
            f"{e.count // reps:5d}/{unit}  {e.key[:90]}")
    log("  by count: " + ", ".join(
        f"{e.count / reps:g} {e.key[:60]}"
        for e in sorted(kernels, key=lambda e: -e.count)[:8]))
    return launched


def phase_profile(device, cfg, params) -> float:
    """The profile of 3 full-width decode steps at batch 8 (context
    ~400); returns the device kernels a step."""
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
    return _profile(f"{cfg.name}, 3 decode steps at batch 8", eng.step, 3,
                    "step")


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


def _loss_grads(lm, params, toks, forward=None) -> tuple[list, dict]:
    """Grads of ``lm.loss`` w.r.t. fresh leaves over ``params``' storage
    (the shared params keep ``requires_grad`` off), in ``tree_leaves``
    order, and the flash launches of that forward and backward. The
    forward's own launches are also written into ``forward`` before the
    backward runs (under remat the backward recomputes a layer's forward,
    and a backward through the kernel raises)."""
    from torch.utils._pytree import tree_leaves, tree_map
    tree = tree_map(lambda t: t.detach().requires_grad_(), params)
    fkernel.reset_launch_counts()
    loss, _ = lm.loss(tree, {"tokens": toks})
    if forward is not None:
        forward.update(fkernel.LAUNCHES)
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
        n = {}                           # the forward's launches
        try:
            _loss_grads(lm, params, toks, n)
        except NotImplementedError as e:
            raised = ("no backward kernel" in str(e)
                      and "attn_impl='reference'" in str(e))
        check(raised, f"attn_impl={impl!r}: a backward through the flash "
              f"kernel did not raise its error")
        check(n["flash_attention_wgmma"] == cfg.num_layers,
              f"attn_impl={impl!r} under autograd: forward flash launches "
              f"{n}")
    lm.attn_impl = "reference"
    fwd = {}
    grads, n = _loss_grads(lm, params, toks, fwd)
    check(sum(n.values()) == 0 and sum(fwd.values()) == 0,
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
        f"'flash' launched {cfg.num_layers} flash kernels each in the "
        f"forward and their backward raised; attn_impl='reference' "
        f"launched none and its "
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
    saved = _snap()
    fast = d.decode_step(*args).float()
    impl, d.impl = d.impl, "reference"
    try:
        plain = d.decode_step(*args).float()
    finally:
        d.impl = impl
    _restore(saved)
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
    _reset_counts()
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
    launches = _counts()
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
        f"(gated: a micro-batch's rows compute the global batch's bits)")
    check(same == len(trace) == len(glob["tokens"]),
          f"coda vs bwap_dwp tokens equal for {same} of {len(trace)} "
          f"requests")
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
        f"{len(r['cold']['tokens'])} (gated: its prefill runs other chunks, "
        f"whose rows compute the same bits); TTFT cold/warm {ratio:.4f} on "
        f"the virtual clock (BENCH_persist.json: "
        f"{bench['ttft_cold_over_warm']:.4f})")
    check(same == len(r["cold"]["tokens"]) == len(r["oracle"]["tokens"]),
          f"cold restart tokens equal the uninterrupted engine's on {same} "
          f"of {len(r['cold']['tokens'])}")
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
        f"the single host's for {same} of {n} requests (gated: the "
        f"decode host re-prefills only the tail page, whose rows compute "
        f"the single host's bits)")
    check(same == n == len(single["tokens"]),
          f"disaggregation: tokens equal the single host's for {same} of "
          f"{n} requests")
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
        f"requests (gated: each mode batches differently, and a row's "
        f"bits do not depend on its batch)")
    check(same == len(mkt["tokens"]) == len(sta["tokens"]),
          f"zoo: chat tokens market vs static equal for {same} of "
          f"{len(mkt['tokens'])} requests")
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


# -- phase 17 ------------------------------------------------------------------

HY_LAYERS, HY_S = 4, 1100        # hymba's decode depth cut, prompt length
XL_DECODE = 512                  # xlstm's decode prompt: two mLSTM chunks
# xlstm's bf16 decode against the fp32 forward, over the bf16 forward's
# gap: mean and max |diff| (the CPU test's bounds)
XL_MEAN_RATIO, XL_MAX_RATIO = 1.05, 1.1
WH_B, WH_S = 8, 448              # whisper: batch, published text context
WH_DECODE = 64                   # whisper's decode prompt


class _FlashCalls:
    """Within the block, the ``window`` of every call of the flash op that
    ``full_attention`` makes; with ``plain``, each call's output is also
    held against the op's plain version on the same inputs (``_max_err``:
    two bf16 ulps) and its error kept. The op itself runs unchanged, and
    the plain version launches no kernel."""

    def __init__(self, plain: bool = False):
        self.plain = plain

    def __enter__(self):
        from repro_torch.models import attention
        self.seen, self.errs = [], []
        self._mod = attention.flash_ops
        self._orig = op = self._mod.flash_attention

        def recorded(q, k, v, *, window=0, causal=True, impl=None):
            self.seen.append(int(window))
            out = op(q, k, v, window=window, causal=causal, impl=impl)
            if self.plain:
                want = op(q, k, v, window=window, causal=causal,
                          impl="reference")
                self.errs.append(_max_err(out, want, str(q.dtype)[6:]))
            return out
        self._mod.flash_attention = recorded
        return self

    def __exit__(self, *exc):
        self._mod.flash_attention = self._orig
        return False


def _all_rows_gate(fast, plain, keep, what, *, scaled: bool) -> dict:
    """Every row: each logit within ``_logits_gate``'s bound (logged
    before it is checked, with the argmax flips over all rows: (row, plain
    margin, kernel margin), watched); then ``_logits_gate`` itself, argmax
    rule included, on the rows ``keep``."""
    err, over, wrong, ties = _gate_misses(fast, plain, scaled)
    big = max((min(abs(m), abs(n)) for _, m, n in wrong), default=0.0)
    log(f"{what}: over all {plain.shape[0]} rows max |diff| {err:.4g}, "
        f"{len(over)} rows over the bound {over[:8]}, argmax flips with "
        f"non-zero margins on {len(wrong)} rows (watched, not gated; the "
        f"larger of the two margins at most {big:.4g}: {wrong[:4]}), "
        f"{ties} exact ties")
    check(not over, f"{what}: logits differ by up to {err} over the bound "
          f"on rows {over}")
    kerr, kties = _logits_gate(fast[keep], plain[keep], what, scaled=scaled)
    return dict(err=err, flips=len(wrong), ties=ties, keep_err=kerr,
                keep_ties=kties)


HY_ROWS = 64                     # the forward gate's last positions


def _noise_floor_gate(lm, params, toks) -> dict:
    """hymba's forward gate. Its 32 bf16 layers amplify rounding: the
    chunked path against itself with the embedding nudged by one bf16 ulp
    (seeded signs) moves the logits by more than ``LOGIT_TOL`` (this gate
    prints by how much). So: every flash launch of the kernel forward is
    held against its plain version on the model's own activations
    (``_FlashCalls(plain=True)``, two bf16 ulps); the logits at the last
    ``HY_ROWS`` positions, kernel against chunked path, within the larger
    of ``LOGIT_TOL`` and that nudge's gap, measured here; the last
    token's argmax by ``_logits_gate``'s rule; and a window-blind kernel
    forward must miss that bound on every row."""
    s = toks.shape[1]
    rows = list(range(s - HY_ROWS, s))
    pos = torch.arange(s, dtype=torch.int32, device=toks.device)[None]

    def logits(p, impl, windows=None):
        saved = lm.windows
        lm.attn_impl = impl
        if windows is not None:
            lm.windows = windows
        try:
            with torch.no_grad():
                h, _, _ = lm.hidden(p, lm.embed(p, {"tokens": toks}), pos)
                return lm.logits(p, h[0, rows]).float()
        finally:
            lm.attn_impl, lm.windows = None, saved

    fkernel.reset_launch_counts()
    with _FlashCalls(plain=True) as calls:
        fast = logits(params, None)
    n = dict(fkernel.LAUNCHES)
    plain = logits(params, "reference")
    gen = torch.Generator(device=toks.device).manual_seed(0)
    sign = torch.randint(0, 2, params["embed"].shape, generator=gen,
                         device=toks.device) * 2.0 - 1
    nudge = dict(params, embed=params["embed"] * (1 + sign * 2.0 ** -8))
    nudged = logits(nudge, "reference")
    fkernel.reset_launch_counts()
    blind = logits(params, None, np.zeros_like(lm.windows))
    n_blind = dict(fkernel.LAUNCHES)
    gap = float((fast - plain).abs().max())
    floor = float((nudged - plain).abs().max())
    bound = max(LOGIT_TOL, floor)
    blind_min = float((blind - plain).abs().amax(-1).min())
    _, _, wrong, ties = _gate_misses(fast[-1:], plain[-1:])
    nl = lm.cfg.num_layers
    want = {"flash_attention": 0, "flash_attention_wgmma": nl}
    check(len(calls.errs) == nl and n == want and n_blind == want,
          f"hymba gate: flash launches {n}, {len(calls.errs)} held, window-"
          f"blind {n_blind}, want {nl}")
    check(gap <= bound, f"hymba: logits differ by up to {gap} > "
          f"max({LOGIT_TOL}, one-ulp nudge {floor})")
    check(not wrong, f"hymba: the last token's argmax differs {wrong}")
    check(blind_min > bound, f"hymba: a window-blind forward passes the "
          f"gate on some row (min row |diff| {blind_min} <= {bound})")
    return dict(errs=calls.errs, gap=gap, floor=floor, bound=bound,
                ties=ties, blind=blind_min, launches=n,
                top=float(plain.abs().max()))


def _family_hymba(device) -> dict:
    """hymba-1.5b at full width and depth (fp32 params, the config's):
    ``LM.prefill`` and the loss at B = 1, S = 4096 through the flash
    kernel (32 launches a forward, 29 at window 1024 and 3 global) against
    the chunked path (``_noise_floor_gate``); then, cut to 4 layers (layer
    0 global, 1-3 at window 1024), ``decode_step`` over an 1100-token
    prompt against the flash forward at every position."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    from repro_torch.train.trainstep import make_eval_step
    t0 = time.perf_counter()
    cfg = registry.get_config("hymba-1.5b")
    lm = LM(cfg)
    nl, w = cfg.num_layers, cfg.sliding_window
    wins = lm.windows.tolist()
    check(w == HYMBA_WINDOW and wins.count(0) == 3
          and wins.count(w) == nl - 3,
          f"hymba windows {wins}")
    params = lm.init(torch.Generator(device=device).manual_seed(0),
                     device=device)
    toks = torch.from_numpy(np.random.default_rng(12).integers(
        1, cfg.vocab_size, (1, PREFILL_S))).to(device)
    step = make_eval_step(lm)
    with torch.no_grad():
        lm.prefill(params, {"tokens": toks})      # warm-up, not timed
    with _FlashCalls() as seen:
        fast, n_fast = _forward(lm, params, toks, step)
    lm.attn_impl = "reference"
    plain, n_plain = _forward(lm, params, toks, step)
    lm.attn_impl = None
    want = {"flash_attention": 0, "flash_attention_wgmma": nl}
    dloss = abs(fast["loss"] - plain["loss"])
    log(f"hymba-1.5b forward ({nl} layers, d {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}/{cfg.head_dim_}, SSM state "
        f"{cfg.ssm.state_dim}, inner {cfg.ssm.expand * cfg.d_model}, "
        f"{_gb(params):.1f} GB of fp32 params), B=1, S={PREFILL_S}: flash "
        f"launches {n_fast}, windows {sorted(set(seen.seen))} "
        f"({seen.seen.count(w)} at {w}, {seen.seen.count(0)} global over "
        f"both forwards); prefill {1e3 * fast['wall']:.1f} ms vs chunked "
        f"path {1e3 * plain['wall']:.1f} ms; loss {fast['loss']:.6f} vs "
        f"{plain['loss']:.6f} (|diff| {dloss:.3g}, gate {LOSS_TOL})")
    check(n_fast == {"prefill": want, "eval": want},
          f"hymba: flash launches {n_fast}, want {nl} per forward")
    check(seen.seen == wins * 2, f"hymba: flash windows {seen.seen}, want "
          f"{wins} per forward")
    check(all(n == 0 for f in n_plain.values() for n in f.values()),
          "hymba: the chunked path launched the kernel")
    check(all(np.isfinite([fast["loss"], plain["loss"]]))
          and bool(torch.isfinite(fast["logits"]).all()),
          "hymba: non-finite logits or loss")
    check(dloss <= LOSS_TOL, f"hymba: loss differs by {dloss} > {LOSS_TOL}")
    gate = _noise_floor_gate(lm, params, toks)
    log(f"hymba-1.5b flash kernel on the model's own activations: "
        f"{len(gate['errs'])} launches, each within two bf16 ulps of its "
        f"plain version (max |err| {max(gate['errs']):.4g}); logits at the "
        f"last {HY_ROWS} positions, kernel vs chunked path: max |diff| "
        f"{gate['gap']:.4g} (|logit| up to {gate['top']:.3g}); the chunked "
        f"path against itself with the embedding nudged one bf16 ulp: "
        f"{gate['floor']:.4g}; gate max({LOGIT_TOL}, that floor) = "
        f"{gate['bound']:.4g}; the last token's argmax equal"
        f"{' but for an exact tie' if gate['ties'] else ''}; a window-blind "
        f"kernel forward misses the gate on every row (min row |diff| "
        f"{gate['blind']:.4g}); {time.perf_counter() - t0:.1f} s -- "
        f"{smi_line()}")
    # decode, cut to 4 layers: the first 4 of the stacked layers' params
    cut = dataclasses.replace(cfg, num_layers=HY_LAYERS, global_layers=(0,))
    lm4 = LM(cut)
    check(lm4.windows.tolist() == [0] + [w] * (HY_LAYERS - 1)
          and [g.scanned for g in lm4.groups] == [True],
          f"hymba cut: windows {lm4.windows.tolist()}")
    p4 = dict(params, groups=[_layers(params["groups"][0], HY_LAYERS)])
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        1, cfg.vocab_size, (1, HY_S))).to(device)
    positions = torch.arange(HY_S, dtype=torch.int32, device=device)
    cache = lm4.init_cache(1, HY_S, device=device)
    saved, fsaved = dict(kernel.LAUNCHES), dict(fkernel.LAUNCHES)
    kept = []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        for t in range(HY_S):
            lg, cache = lm4.decode_step(p4, cache, toks[:, t:t + 1],
                                        positions[t])
            kept.append(lg[0, 0])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t1) / HY_S
    check(kernel.LAUNCHES == saved and fkernel.LAUNCHES == fsaved,
          "hymba: decode_step launched a kernel")
    fkernel.reset_launch_counts()
    with torch.no_grad(), _FlashCalls() as seen:
        x = lm4.embed(p4, {"tokens": toks})
        h, _, _ = lm4.hidden(p4, x, positions[None])
        full = lm4.logits(p4, h[0])
    n = dict(fkernel.LAUNCHES)
    check(n == {"flash_attention": 0, "flash_attention_wgmma": HY_LAYERS}
          and seen.seen == lm4.windows.tolist(),
          f"hymba cut forward: flash launches {n}, windows {seen.seen}")
    keep = list(range(w - 2, w + 3)) + list(range(HY_S - 5, HY_S))
    g = _all_rows_gate(full, torch.stack(kept), keep, "hymba-1.5b flash "
                       "forward vs decode_step", scaled=True)
    log(f"hymba-1.5b decode (depth cut to {HY_LAYERS} layers, windows "
        f"{lm4.windows.tolist()}): {HY_S} tokens decoded one by one, "
        f"{step_ms:.2f} ms a decode_step (B=1, mean over the prompt); "
        f"every position vs the flash forward: max |diff| {g['err']:.4g} "
        f"(gate max({LOGIT_TOL}, 1 bf16 ulp of the logit); |logit| up to "
        f"{float(full.float().abs().max()):.3g}); the argmax rule at "
        f"positions {keep[0]}-{keep[4]} and {keep[5]}-{keep[-1]}: max "
        f"|diff| {g['keep_err']:.4g}, {g['keep_ties']} exact ties; "
        f"{time.perf_counter() - t0:.1f} s in all -- {smi_line()}")
    # the model's own forwards; not the window-blind one, which runs
    # windows the config does not have
    flash = sum(f["flash_attention_wgmma"] for f in
                (n_fast["prefill"], n_fast["eval"], gate["launches"], n))
    return dict(flash=flash, step_ms=step_ms)


def _layers(tree, n):
    """The first ``n`` layers of a stacked group's params."""
    return {k: (_layers(v, n) if isinstance(v, dict) else v[:n])
            for k, v in tree.items()}


def _family_xlstm(device) -> dict:
    """xlstm-125m at full width and depth (fp32 params): the forward and
    the loss at B = 1, S = 4096 in the config's bf16 compute, finite, no
    kernel launched (mLSTM, sLSTM and the head are plain torch); then
    ``decode_step`` over a 512-token prompt (two mLSTM chunks) against the
    forward at every position, gated in fp32 compute (the chunkwise and
    the recurrent form are one recurrence; in bf16 their roundings part
    through the exponential gates of 12 layers, and that gap is printed,
    not gated); and in bf16, the decode no further from the fp32 forward
    than the bf16 forward is (``XL_MEAN_RATIO``, ``XL_MAX_RATIO``)."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    cfg = registry.get_config("xlstm-125m")
    lm = LM(cfg)
    kinds = [(g.kind, len(g.indices)) for g in lm.groups]
    check(kinds == [("mlstm", 3), ("slstm", 1), ("mlstm", 5), ("slstm", 1),
                    ("mlstm", 2)], f"xlstm groups {kinds}")
    params = lm.init(torch.Generator(device=device).manual_seed(0),
                     device=device)
    toks = torch.from_numpy(np.random.default_rng(14).integers(
        1, cfg.vocab_size, (1, PREFILL_S))).to(device)
    batch = {"tokens": toks}
    saved, fsaved = dict(kernel.LAUNCHES), dict(fkernel.LAUNCHES)
    with torch.no_grad():
        lm.prefill(params, {"tokens": toks[:, :256]})   # warm-up
        logits, fwd_ms = _synced_ms(lm.prefill, params, batch)
        (loss, _), loss_ms = _synced_ms(lm.loss, params, batch)
    check(kernel.LAUNCHES == saved and fkernel.LAUNCHES == fsaved,
          "xlstm: its forward launched a kernel")
    check(bool(torch.isfinite(logits).all()) and np.isfinite(float(loss)),
          f"xlstm: non-finite logits or loss {float(loss)}")
    log(f"xlstm-125m forward ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.head_dim_}, sLSTM at "
        f"{cfg.xlstm.slstm_at}, {_gb(params):.2f} GB of fp32 params, bf16 "
        f"compute), B=1, S={PREFILL_S}: prefill {fwd_ms:.1f} ms, loss "
        f"{float(loss):.6f} in {loss_ms:.1f} ms (synchronised wall; no "
        f"kernel on this path)")
    dtoks = toks[:, :XL_DECODE]
    positions = torch.arange(XL_DECODE, dtype=torch.int32, device=device)

    def decode_and_forward(model):
        cache = model.init_cache(1, XL_DECODE, device=device)
        kept = []
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            for t in range(XL_DECODE):
                lg, cache = model.decode_step(params, cache,
                                              dtoks[:, t:t + 1],
                                              positions[t])
                kept.append(lg[0, 0])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1) / XL_DECODE
            x = model.embed(params, {"tokens": dtoks})
            h, _, _ = model.hidden(params, x, positions[None])
            full = model.logits(params, h[0])
        check(kernel.LAUNCHES == saved and fkernel.LAUNCHES == fsaved,
              "xlstm: decode launched a kernel")
        return full, torch.stack(kept), ms

    full16, dec16, step_ms = decode_and_forward(lm)
    berr, bover, bwrong, _ = _gate_misses(full16, dec16)
    log(f"xlstm-125m decode in bf16 compute: {XL_DECODE} tokens decoded "
        f"one by one, {step_ms:.2f} ms a decode_step (B=1, mean over the "
        f"prompt); vs the bf16 forward (watched, not gated): max |diff| "
        f"{berr:.4g}, {len(bover)} of {XL_DECODE} rows over {LOGIT_TOL}, "
        f"argmax flips with non-zero margins on {len(bwrong)} rows")
    lm32 = LM(dataclasses.replace(cfg, compute_dtype="float32"))
    full, dec, step32_ms = decode_and_forward(lm32)
    keep = list(range(254, 259)) + list(range(XL_DECODE - 5, XL_DECODE))
    g = _all_rows_gate(full, dec, keep, "xlstm-125m forward vs "
                       "decode_step (fp32 compute)", scaled=False)
    log(f"xlstm-125m decode in fp32 compute: {step32_ms:.2f} ms a "
        f"decode_step; every position vs the forward: max |diff| "
        f"{g['err']:.4g} (gate {LOGIT_TOL}; |logit| up to "
        f"{float(full.abs().max()):.3g}); the argmax rule at positions "
        f"{keep[0]}-{keep[4]} (across the first chunk's end) and "
        f"{keep[5]}-{keep[-1]}: max |diff| {g['keep_err']:.4g}, "
        f"{g['keep_ties']} exact ties")
    # bf16: the decode strays from the fp32 forward no further than the
    # bf16 forward does (tests/test_torch_decode.py's
    # test_bf16_decode_tracks_fp32_forward at full width)
    fwd_gap = (full16.float() - full).abs()
    dec_gap = (dec16.float() - full).abs()
    mean = float(dec_gap.mean()) / float(fwd_gap.mean())
    top = float(dec_gap.max()) / float(fwd_gap.max())
    log(f"xlstm-125m bf16 against the fp32 forward, every position: the "
        f"forward mean |diff| {float(fwd_gap.mean()):.4g}, max "
        f"{float(fwd_gap.max()):.4g}; decode_step mean "
        f"{float(dec_gap.mean()):.4g}, max {float(dec_gap.max()):.4g}; "
        f"ratios {mean:.4g} (gate {XL_MEAN_RATIO}) and {top:.4g} (gate "
        f"{XL_MAX_RATIO}); {time.perf_counter() - t0:.1f} s in all -- "
        f"{smi_line()}")
    check(mean <= XL_MEAN_RATIO and top <= XL_MAX_RATIO,
          f"xlstm: the bf16 decode strays from the fp32 forward {mean}x "
          f"(mean) / {top}x (max) as far as the bf16 forward does")
    return dict(fwd_ms=fwd_ms, step_ms=step_ms, bf16_gap=berr)


def _family_whisper(device) -> dict:
    """whisper-tiny at full width (fp32 params): ``prefill`` and the loss
    at B = 8 over 1500 seeded frames and 448 tokens, the decoder's
    self-attention through the flash kernel (4 launches a forward), against
    the chunked path, and every launch of a kernel forward against its
    plain version on the model's activations; then ``ck``/``cv`` written
    from ``encode`` and 64 tokens decoded, the last step against
    ``prefill`` of those tokens."""
    from repro_torch.configs import registry
    from repro_torch.models.whisper import EncDecLM
    t0 = time.perf_counter()
    cfg = registry.get_config("whisper-tiny")
    model = registry.make_model(cfg)
    check(isinstance(model, EncDecLM), f"whisper: {type(model)}")
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    rng = np.random.default_rng(15)
    frames = torch.from_numpy(rng.standard_normal(
        (WH_B, cfg.enc_frames, cfg.d_model)).astype(np.float32)).to(device)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (WH_B, WH_S))).to(device)
    batch = {"frames": frames, "tokens": toks}
    nl = cfg.num_layers

    def forward():
        torch.cuda.synchronize()
        fkernel.reset_launch_counts()
        with torch.no_grad():
            logits, ms = _synced_ms(model.prefill, params, batch)
            n = {"prefill": dict(fkernel.LAUNCHES)}
            fkernel.reset_launch_counts()
            loss, _ = model.loss(params, batch)
            n["loss"] = dict(fkernel.LAUNCHES)
        return logits[:, 0].float(), float(loss), ms, n

    with torch.no_grad():
        model.prefill(params, batch)              # warm-up, not timed
    fast, fast_loss, ms, n_fast = forward()
    model.attn_impl = "reference"
    plain, plain_loss, plain_ms, n_plain = forward()
    model.attn_impl = None
    want = {"flash_attention": 0, "flash_attention_wgmma": nl}
    check(n_fast == {"prefill": want, "loss": want},
          f"whisper: flash launches {n_fast}, want {nl} per forward")
    check(all(n == 0 for f in n_plain.values() for n in f.values()),
          "whisper: the chunked path launched the kernel")
    check(all(np.isfinite([fast_loss, plain_loss]))
          and bool(torch.isfinite(fast).all()),
          "whisper: non-finite logits or loss")
    # every launch of a kernel forward at this shape against its plain
    # version on the model's own activations
    fkernel.reset_launch_counts()
    with torch.no_grad(), _FlashCalls(plain=True) as calls:
        model.prefill(params, batch)
    n_held = dict(fkernel.LAUNCHES)
    check(len(calls.errs) == nl and n_held == want,
          f"whisper: flash launches {n_held}, {len(calls.errs)} held, want "
          f"{nl}")
    err, ties = _logits_gate(fast, plain, "whisper-tiny")
    dloss = abs(fast_loss - plain_loss)
    check(dloss <= LOSS_TOL, f"whisper: loss differs by {dloss} > "
          f"{LOSS_TOL}")
    log(f"whisper-tiny forward ({cfg.enc_layers}+{nl} layers, d "
        f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads}/"
        f"{cfg.head_dim_}, vocab {cfg.vocab_size}, {_gb(params):.2f} GB of "
        f"fp32 params), B={WH_B}, {cfg.enc_frames} frames, {WH_S} tokens: "
        f"flash launches {n_fast}; prefill {ms:.1f} ms vs chunked path "
        f"{plain_ms:.1f} ms; {len(calls.errs)} launches each within two "
        f"bf16 ulps of the plain version on the model's own activations "
        f"(max |err| {max(calls.errs):.4g}); last-token logits max |diff| "
        f"{err:.4g} (gate "
        f"{LOGIT_TOL}; |logit| up to {float(plain.abs().max()):.3g}), argmax "
        f"equal on {WH_B - ties}/{WH_B} rows, the rest exact ties; loss "
        f"{fast_loss:.6f} vs {plain_loss:.6f} (|diff| {dloss:.3g}, gate "
        f"{LOSS_TOL})")
    # decode: the cross K/V from the encoder, as the caller must write them
    cdt = getattr(torch, cfg.compute_dtype)
    f, nkv, hd = cfg.enc_frames, cfg.num_kv_heads, cfg.head_dim_
    dtoks = toks[:, :WH_DECODE]
    saved, fsaved = dict(kernel.LAUNCHES), dict(fkernel.LAUNCHES)
    with torch.no_grad():
        enc = model.encode(params, frames)
        cache = model.init_cache(params, WH_B, WH_DECODE, f, device=device)
        for c, p_l in zip(cache, params["dec"]):
            pc = p_l["cross"]
            c["ck"].copy_((enc @ pc["wk"].to(cdt)).reshape(WH_B, f, nkv, hd))
            c["cv"].copy_((enc @ pc["wv"].to(cdt)).reshape(WH_B, f, nkv, hd))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(WH_DECODE):
            lg, cache = model.decode_step(params, cache, dtoks[:, t:t + 1],
                                          torch.tensor(t, device=device))
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t1) / WH_DECODE
        check(kernel.LAUNCHES == saved and fkernel.LAUNCHES == fsaved,
              "whisper: decode launched a kernel")
        fkernel.reset_launch_counts()
        full = model.prefill(params, {"frames": frames, "tokens": dtoks})
        n = dict(fkernel.LAUNCHES)
    check(n == want, f"whisper decode gate's prefill: flash launches {n}")
    derr, dties = _logits_gate(full[:, 0].float(), lg[:, 0].float(),
                               "whisper-tiny prefill vs decode_step")
    log(f"whisper-tiny decode (B={WH_B}, cross K/V written from encode): "
        f"{WH_DECODE} tokens, {step_ms:.2f} ms a decode_step; the last "
        f"step vs prefill of the same tokens: max |diff| {derr:.4g} (gate "
        f"{LOGIT_TOL}), argmax equal on {WH_B - dties}/{WH_B} rows, the "
        f"rest exact ties; {time.perf_counter() - t0:.1f} s in all -- "
        f"{smi_line()}")
    flash = sum(f["flash_attention_wgmma"] for f in
                (n_fast["prefill"], n_fast["loss"], n_held, n))
    return dict(flash=flash, step_ms=step_ms)


def phase_families_17(device) -> dict:
    """Phase 17: hymba-1.5b, xlstm-125m and whisper-tiny at full width,
    each model freed before the next is built. Returns the flash launches
    for the JSON record."""
    import gc
    out = {}
    for name, part in (("hymba-1.5b", _family_hymba),
                       ("xlstm-125m", _family_xlstm),
                       ("whisper-tiny", _family_whisper)):
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 17, {name}: {torch.cuda.memory_allocated() / 1e9:.1f} "
            f"GB allocated on the card before the model is built")
        out[name] = part(device)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 18 ------------------------------------------------------------------

TRAIN_B = 8                      # global batch (train_4k's 256, cut)
TRAIN_STEPS = 3                  # full-depth train steps
TRAIN_CUT = 2                    # layers of the accumulation and crash cells
ACCUM_S = 2048                   # the accumulation cell's sequence
ACCUM_TOL = 2e-2                 # rel. L2, accumulated vs whole-batch grads
CRASH_B, CRASH_S, CRASH_STEPS = 2, 1024, 4
CRASH_TOL = 2e-4                 # tests/test_fault_tolerance.py:90-92
REMAT_LAYERS = 8                 # the remat cell (one stacked group)
Q8_B, Q8_STEPS = 2, 3            # the int8-moment cell
TRAIN_DIR = ROOT / "build" / "chip_smoke_train"   # checkpoints, removed after
TRAIN_18A: dict = {}             # 18a's steady step (ms) and peak (bytes)


def _peak_bytes() -> int:
    return torch.cuda.max_memory_allocated()


def _train_batches(cfg, seq, batch, seed, device):
    """step -> tokens [batch, seq] on ``device``: shard 0 of a seeded
    ``ShardedTokenDataset`` (the launcher's synthetic stream)."""
    from repro_torch.data.pipeline import ShardedTokenDataset
    ds = ShardedTokenDataset(cfg.vocab_size, seq, num_shards=8, seed=seed)
    return lambda step: torch.from_numpy(ds.batch(0, step, batch)).to(device)


def _leaves(tree):
    from repro_torch.train.optimizer import tree_leaves
    return tree_leaves(tree)


def _rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over every leaf of two grad trees, in fp64."""
    num = sum(float((x.double() - y.double()).square().sum())
              for x, y in zip(_leaves(a), _leaves(b)))
    den = sum(float(y.double().square().sum()) for y in _leaves(b))
    return (num / den) ** 0.5


def _qwen_train_cfg():
    from repro_torch.configs import registry
    cfg = registry.get_config("qwen2-0.5b")
    check(cfg.remat == "full" and cfg.param_dtype == "float32"
          and cfg.compute_dtype == "bfloat16",
          f"qwen2-0.5b: remat {cfg.remat}, params {cfg.param_dtype}, "
          f"compute {cfg.compute_dtype}")
    return cfg


def _train_full(device) -> dict:
    """18a: qwen2-0.5b at full width and depth, ``TRAIN_STEPS`` steps of
    ``make_train_step`` at global batch ``TRAIN_B`` and S = 4096, the
    accumulation steps from ``accum_steps_for``. The eval step on the
    step-0 batch's last microbatch goes through the flash kernel (one
    launch a layer); the train steps launch none, and step 0's loss (the
    same microbatch, chunked branch) must be within ``LOSS_TOL`` of it."""
    from repro_torch.models.lm import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    cfg = _qwen_train_cfg()
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(18),
                     device=device)
    toks = _train_batches(cfg, PREFILL_S, TRAIN_B, 18, device)
    accum = ts.accum_steps_for(cfg, TRAIN_B, PREFILL_S, dp_size=1)
    ocfg = ts.opt_config_for(cfg, lr=1e-3, warmup_steps=2,
                             total_steps=TRAIN_STEPS)
    b0 = toks(0)
    mb = b0[TRAIN_B - TRAIN_B // accum:]          # the last microbatch
    fkernel.reset_launch_counts()
    with torch.no_grad():
        ev, eval_ms = _synced_ms(ts.make_eval_step(lm), params,
                                 {"tokens": mb})
    eval_loss = float(ev["loss"])
    n_eval = dict(fkernel.LAUNCHES)
    check(n_eval == {"flash_attention": 0,
                     "flash_attention_wgmma": cfg.num_layers},
          f"18a eval: flash launches {n_eval}, want {cfg.num_layers} on "
          f"the tensor-core instance")
    step = ts.make_train_step(lm, ocfg, accum_steps=accum)
    state = opt.init_opt_state(ocfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fkernel.reset_launch_counts()
    ms, losses, norms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = {"tokens": b0 if i == 0 else toks(i)}
        (params, state, m), t = _synced_ms(step, params, state, batch)
        ms.append(t)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = _peak_bytes() / 1e9
    TRAIN_18A.update(peak=_peak_bytes(), ms=float(np.mean(ms[1:])))
    n_train = dict(fkernel.LAUNCHES)
    check(sum(n_train.values()) == 0,
          f"18a: the train steps launched the flash kernel: {n_train}")
    check(lm.attn_impl is None, "18a: the train step left attn_impl set")
    check(bool(np.isfinite(losses + norms).all()),
          f"18a: losses {losses}, grad norms {norms}")
    gap = abs(losses[0] - eval_loss)
    check(gap <= LOSS_TOL, f"18a: step-0 train loss {losses[0]} vs eval "
          f"loss {eval_loss} through the kernel: {gap} > {LOSS_TOL}")
    steady = float(np.mean(ms[1:]))
    log(f"18a qwen2-0.5b training ({cfg.num_layers} layers, d "
        f"{cfg.d_model}, fp32 params, bf16 compute, remat {cfg.remat}; "
        f"B={TRAIN_B} as {accum} microbatches of {TRAIN_B // accum} "
        f"(accum_steps_for), S={PREFILL_S}): step ms "
        f"{', '.join(f'{t:.1f}' for t in ms)} (steady {steady:.1f} ms, "
        f"{TRAIN_B * PREFILL_S / steady * 1e3:.0f} tokens/s); peak "
        f"{peak:.2f} GB (max_memory_allocated); losses "
        f"{', '.join(f'{x:.5f}' for x in losses)}, grad norms "
        f"{', '.join(f'{x:.4f}' for x in norms)}; eval loss through the "
        f"kernel {eval_loss:.5f} ({n_eval['flash_attention_wgmma']} "
        f"launches, {eval_ms:.1f} ms), step-0 train loss {losses[0]:.5f}: "
        f"gap {gap:.3g} (gate {LOSS_TOL}); no flash launch while "
        f"training -- {smi_line()}")
    _profile(f"qwen2-0.5b train step, B={TRAIN_B} as {accum} x "
             f"{TRAIN_B // accum}, S={PREFILL_S}",
             lambda: step(params, state, {"tokens": toks(TRAIN_STEPS)}), 1,
             "step", cpu=False)
    return dict(lm=lm, params=params, mb=mb,
                flash=n_eval["flash_attention_wgmma"])


def _train_compress(device, lm, params, mb) -> None:
    """18d: ``compressed_psum_grads`` over a one-rank NCCL group on the
    full-depth model's gradients (18a's trained params, its last
    microbatch): every leaf within the reference test's error bound
    (max |g|/127 of the leaf, x 1.01) and its residual identity
    (``res == g - red``)."""
    import socket

    import torch.distributed as dist

    from repro_torch.train import compress
    from repro_torch.train import trainstep as ts
    grads, _ = ts.accumulated_grads(lm, params, {"tokens": mb})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        (red, res), ms = _synced_ms(compress.compressed_psum_grads, grads,
                                    compress.init_residuals(grads))
    finally:
        dist.destroy_process_group()
    worst, ident = 0.0, 0.0
    for g, r, e in zip(_leaves(grads), _leaves(red), _leaves(res)):
        scale = float(g.abs().max()) / 127.0
        err = float((r - g).abs().max())
        check(err <= scale * 1.01, f"18d: error {err} > {scale} x 1.01")
        worst = max(worst, err / scale if scale else 0.0)
        lost = g - r
        check(bool(torch.allclose(e, lost, rtol=1e-5, atol=1e-6)),
              "18d: the residual is not what was lost")
        ident = max(ident, float((e - lost).abs().max()))
    n = sum(g.numel() for g in _leaves(grads))
    log(f"18d compressed_psum_grads (one-rank NCCL group) on {n} gradient "
        f"elements of the full-depth model: max error {worst:.4f} of the "
        f"reference's bound (max|g|/127), residual identity within "
        f"{ident:.3g}; {ms:.1f} ms")


def _train_accum(device) -> None:
    """18a's accumulation gate, at ``TRAIN_CUT`` layers and S =
    ``ACCUM_S`` (the head's fp32 logits at B = 8, S = 4096 take 19.9 GB
    and several live copies in the backward: no depth fits them without
    accumulation): the grads of 2 microbatches of 4 against one batch of
    8, relative L2 within ``ACCUM_TOL`` in bf16 compute."""
    import dataclasses

    from repro_torch.models.lm import LM
    from repro_torch.train import trainstep as ts
    cut = dataclasses.replace(_qwen_train_cfg(), num_layers=TRAIN_CUT)
    lm = LM(cut)
    p = lm.init(torch.Generator(device=device).manual_seed(19),
                device=device)
    batch = {"tokens": _train_batches(cut, ACCUM_S, TRAIN_B, 19,
                                      device)(0)}
    g1, m1 = ts.accumulated_grads(lm, p, batch, 1)
    g2, m2 = ts.accumulated_grads(lm, p, batch, 2)
    rel = _rel_l2(g2, g1)
    check(np.isfinite(rel) and rel <= ACCUM_TOL,
          f"18a accumulation: rel. L2 {rel} > {ACCUM_TOL}")
    log(f"18a accumulation ({TRAIN_CUT} layers, B={TRAIN_B}, S={ACCUM_S}, "
        f"bf16 compute): grads of 2 x {TRAIN_B // 2} vs 1 x {TRAIN_B}: "
        f"relative L2 {rel:.4g} (gate {ACCUM_TOL}); losses "
        f"{float(m1['loss']):.5f} (whole batch), {float(m2['loss']):.5f} "
        f"(last microbatch)")


def _train_crash(device) -> None:
    """18a's crash-restart gate, at ``TRAIN_CUT`` layers, B = ``CRASH_B``,
    S = ``CRASH_S`` (checkpoints of the full depth's params and moments
    are ~6 GB): a ``Trainer`` with ``fail_at_step`` raises
    ``SimulatedFailure``, a new one resumes from its last checkpoint, and
    the params end within ``CRASH_TOL`` of an uninterrupted run's."""
    import dataclasses

    from repro_torch.models.lm import LM
    from repro_torch.train import trainstep as ts
    from repro_torch.train.loop import LoopConfig, SimulatedFailure, Trainer
    cut = dataclasses.replace(_qwen_train_cfg(), num_layers=TRAIN_CUT)
    toks = _train_batches(cut, CRASH_S, CRASH_B, 20, device)
    ocfg = ts.opt_config_for(cut, lr=1e-3, warmup_steps=2,
                             total_steps=CRASH_STEPS)

    def trainer(name, every, fail=-1):
        return Trainer(LM(cut), ocfg, LoopConfig(
            total_steps=CRASH_STEPS, ckpt_every=every, keep_last=1,
            log_every=100, fail_at_step=fail), str(TRAIN_DIR / name),
            lambda s: {"tokens": toks(s)}, device=device)

    t0 = time.perf_counter()
    _, p_ref, _, _ = trainer("a", CRASH_STEPS).run()
    failed = None
    try:
        trainer("b", 2, fail=3).run()
    except SimulatedFailure as e:
        failed = str(e)
    check(failed is not None, "18a crash: no SimulatedFailure at step 3")
    resumed = trainer("b", 2)
    check(resumed.ckpt.latest_step() == 2,
          f"18a crash: last checkpoint {resumed.ckpt.latest_step()}")
    step, p_res, _, _ = resumed.run()
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(_leaves(p_ref), _leaves(p_res)))
    check(step == CRASH_STEPS and diff <= CRASH_TOL,
          f"18a crash: resumed to step {step}, params {diff} from the "
          f"uninterrupted run's (gate {CRASH_TOL})")
    log(f"18a crash-restart ({TRAIN_CUT} layers, B={CRASH_B}, S={CRASH_S},"
        f" {CRASH_STEPS} steps): {failed!r}, resumed from step 2, params "
        f"max |diff| {diff:.3g} from the uninterrupted run (gate "
        f"{CRASH_TOL}); {time.perf_counter() - t0:.1f} s with 3 "
        f"checkpoints")


def _train_remat(device) -> None:
    """18b: ``REMAT_LAYERS`` layers (one stacked group), B = 1, S = 4096:
    the grads with ``remat="full"`` equal ``"none"``'s bit for bit (with
    deterministic algorithms on, so the embedding's scatter-add does not
    reorder), and the peak memory of the backward is lower."""
    import dataclasses
    import gc
    import warnings

    from repro_torch.models.lm import LM
    from repro_torch.train import trainstep as ts
    base = dataclasses.replace(_qwen_train_cfg(), num_layers=REMAT_LAYERS)
    p = LM(base).init(torch.Generator(device=device).manual_seed(21),
                      device=device)
    batch = {"tokens": _train_batches(base, PREFILL_S, 1, 21, device)(0)}
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            for remat in ("none", "full"):
                lm = LM(dataclasses.replace(base, remat=remat))
                check(lm.groups[0].scanned, "18b: the group is not stacked")
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                g, _ = ts.accumulated_grads(lm, p, batch)
                torch.cuda.synchronize()
                out[remat] = (g, _peak_bytes() - before)
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b) for a, b in
               zip(_leaves(out["full"][0]), _leaves(out["none"][0])))
    full, none = out["full"][1] / 1e9, out["none"][1] / 1e9
    check(same, "18b: remat='full' grads differ from remat='none'")
    check(full < none, f"18b: peak {full} GB with remat, {none} without")
    log(f"18b remat ({REMAT_LAYERS} layers, B=1, S={PREFILL_S}): peak "
        f"above the params {full:.3f} GB with 'full', {none:.3f} GB with "
        f"'none'; grads equal bit for bit")


def _train_q8(device) -> None:
    """18c: deepseek-v3's optimizer layout (int8 block moments, no fp32
    master) on qwen2-0.5b with bf16 params, ``Q8_STEPS`` steps at B =
    ``Q8_B``, S = 4096: finite losses, int8 ``q`` and fp32 ``scale`` in
    every moment, and a checkpoint round trip of the state equal bit for
    bit."""
    import dataclasses

    from repro_torch.checkpoint.ckpt import CheckpointManager
    from repro_torch.models.lm import LM
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    cfg = dataclasses.replace(_qwen_train_cfg(), param_dtype="bfloat16")
    lm = LM(cfg)
    p = lm.init(torch.Generator(device=device).manual_seed(22),
                device=device)
    ocfg = ts.opt_config_for(cfg, quantized_moments=True, master_fp32=False,
                             lr=1e-3, warmup_steps=2, total_steps=Q8_STEPS)
    state = opt.init_opt_state(ocfg, p)
    toks = _train_batches(cfg, PREFILL_S, Q8_B, 22, device)
    step = ts.make_train_step(lm, ocfg)
    losses, ms = [], []
    for i in range(Q8_STEPS):
        (p, state, m), t = _synced_ms(step, p, state, {"tokens": toks(i)})
        losses.append(float(m["loss"]))
        ms.append(t)
    check(bool(np.isfinite(losses).all()), f"18c: losses {losses}")
    check("master" not in state and int(state["step"]) == Q8_STEPS,
          f"18c: state keys {sorted(state)}, step {int(state['step'])}")
    kinds = set()
    for k in ("m", "v"):       # each param's moment is one {"q", "scale"}
        opt.tree_map(lambda x, mo: kinds.add((mo["q"].dtype,
                                              mo["scale"].dtype)),
                     p, state[k])
    check(kinds == {(torch.int8, torch.float32)},
          f"18c: moment dtypes {kinds}")
    cm = CheckpointManager(TRAIN_DIR / "q8")
    t0 = time.perf_counter()
    cm.save(Q8_STEPS, {"opt": state})
    got_step, back = cm.restore(like={"opt": state})
    rt = time.perf_counter() - t0
    same = all(torch.equal(a.cpu(), b) for a, b in
               zip(_leaves(state), _leaves(back["opt"])))
    check(got_step == Q8_STEPS and same,
          "18c: the checkpointed state differs from the saved one")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(state))
    log(f"18c int8 moments, no master (qwen2-0.5b, bf16 params, B={Q8_B}, "
        f"S={PREFILL_S}): losses {', '.join(f'{x:.5f}' for x in losses)}, "
        f"step ms {', '.join(f'{t:.1f}' for t in ms)}; state "
        f"{nbytes / 1e9:.3f} GB, int8 q and fp32 scale in every moment; "
        f"checkpoint round trip equal bit for bit ({rt:.1f} s)")


def _train_entry_points(device) -> None:
    """18e: ``python -m repro_torch.launch.train --smoke`` and
    ``examples/torch_train_lm.py``, a few steps each on the card (their
    default device), through their ``main``."""
    import runpy

    from repro_torch.launch import train
    step, m = train.main(["--arch", "qwen2-0.5b", "--smoke", "--steps",
                          "3", "--ckpt", str(TRAIN_DIR / "launch")])
    check(step == 3 and np.isfinite(float(m["loss"])),
          f"18e launch.train: step {step}, loss {m.get('loss')}")
    main = runpy.run_path(str(ROOT / "examples" / "torch_train_lm.py"))[
        "main"]
    step, m = main(["--steps", "3", "--ckpt", str(TRAIN_DIR / "example")])
    check(step == 3 and np.isfinite(float(m["loss"])),
          f"18e torch_train_lm.py: step {step}, loss {m.get('loss')}")
    log("18e repro_torch.launch.train --smoke and examples/"
        "torch_train_lm.py: 3 steps each on the card, finished")


def phase_train(device) -> int:
    """Phase 18: the training path. Returns the flash launches (18a's
    eval step) for the JSON record."""
    import gc
    import shutil
    t0 = time.perf_counter()
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    def done(part: str) -> None:
        log(f"[{time.perf_counter() - t0:.1f} s of phase 18] {part} done")
    try:
        a = _train_full(device)
        done("18a")
        _train_compress(device, a["lm"], a["params"], a["mb"])
        done("18d")
        flash = a["flash"]
        del a
        for name, part in (("18a accumulation", _train_accum),
                           ("18a crash-restart", _train_crash),
                           ("18b", _train_remat), ("18c", _train_q8),
                           ("18e", _train_entry_points)):
            gc.collect()
            torch.cuda.empty_cache()
            part(device)
            done(name)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 18: {time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return flash


# -- phase 19 ------------------------------------------------------------------

DRY_PEAK_TOL = 0.10              # dry-run peak vs max_memory_allocated
DRY_ARG_TOL = 0.01               # decode argument bytes vs memory_allocated
DRY_CELL_LIMIT = 16 * 2**30      # tests/test_system.py's small cell


def _dry_cell(arch, shape, **kw) -> dict:
    """One dry-run record with its roofline terms, printed on a line."""
    from repro_torch.launch import dryrun
    t = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, verbose=False, **kw)
    check(rec["status"] == "OK", f"19 {arch} x {shape}: {rec}")
    rec["roofline"] = dryrun.roofline_record(rec)
    rec["wall_s"] = time.perf_counter() - t
    print(json.dumps({"dryrun": rec}, default=float), flush=True)
    return rec


def _flops_of(fn, *a):
    """(FlopCounterMode's total, fn's result) of one real call."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        out = fn(*a)
    torch.cuda.synchronize()
    return fc.get_total_flops(), out


def _dry_train(device) -> None:
    """19a: qwen2-0.5b's train cell on a one-device mesh at 18a's shape
    against one real step on the card and 18a's measurements."""
    import gc
    from repro_torch.launch.dryrun import StandInMesh
    from repro_torch.models.lm import LM
    from repro_torch.roofline import analyze
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    rec = _dry_cell("qwen2-0.5b", "train_4k",
                    mesh=StandInMesh(("data", "model"), (1, 1)),
                    batch=TRAIN_B, seq=PREFILL_S)
    rl, mem = rec["roofline"], rec["memory"]
    cfg = _qwen_train_cfg()
    accum = ts.accum_steps_for(cfg, TRAIN_B, PREFILL_S, dp_size=1)
    check(rec["accum_steps"] == accum, f"19a: accum {rec['accum_steps']} "
          f"vs 18a's {accum}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(19),
                     device=device)
    ocfg = ts.opt_config_for(cfg, lr=1e-3, warmup_steps=2,
                             total_steps=TRAIN_STEPS)
    state = opt.init_opt_state(ocfg, params)
    batch = {"tokens": _train_batches(cfg, PREFILL_S, TRAIN_B, 19,
                                      device)(0)}
    step = ts.make_train_step(lm, ocfg, accum_steps=accum)
    flops, (params, state, m) = _flops_of(step, params, state, batch)
    own_peak = torch.cuda.max_memory_allocated() - base
    check(bool(np.isfinite(float(m["loss"]))), f"19a: loss {m['loss']}")
    del lm, params, state, batch, m
    check(flops == rec["full"]["flops"],
          f"19a: dry-run FLOPs {rec['full']['flops']:.0f} != the real "
          f"step's {flops}")
    pred = mem["peak_bytes_per_device"]
    for what, real in (("phase 18a's", TRAIN_18A["peak"]),
                       ("the counted step's", own_peak)):
        check(abs(pred - real) <= DRY_PEAK_TOL * real,
              f"19a: predicted peak {pred / 1e9:.2f} GB vs {what} "
              f"max_memory_allocated {real / 1e9:.2f} GB: more than "
              f"{DRY_PEAK_TOL:.0%} apart")
    step_s = TRAIN_18A["ms"] / 1e3
    check(rl["t_compute"] <= step_s,
          f"19a: compute bound {rl['t_compute']:.4f} s above 18a's step "
          f"{step_s:.4f} s")
    log(f"19a qwen2-0.5b train_4k on a 1x1 mesh (B={TRAIN_B} as {accum} x "
        f"{TRAIN_B // accum}, S={PREFILL_S}, remat {cfg.remat}): FLOPs "
        f"{flops} = the real step's (FlopCounterMode on the card); "
        f"predicted peak {pred / 1e9:.3f} GB vs 18a's "
        f"{TRAIN_18A['peak'] / 1e9:.3f} GB ({pred / TRAIN_18A['peak']:.4f}x)"
        f" and the counted step's {own_peak / 1e9:.3f} GB "
        f"({pred / own_peak:.4f}x); total_bytes_per_device "
        f"{mem['total_bytes_per_device'] / 1e9:.3f} GB; bound: compute "
        f"{rl['t_compute'] * 1e3:.1f} ms (at {analyze.H100_PEAK_FLOPS:.3g} "
        f"FLOP/s), memory {rl['t_memory'] * 1e3:.1f} ms (eager bytes "
        f"{rl['bytes_hbm'] / 1e12:.3f} TB at {analyze.H100_HBM_BW:.3g} B/s); "
        f"18a's step {TRAIN_18A['ms']:.1f} ms = "
        f"{TRAIN_18A['ms'] / (rl['t_compute'] * 1e3):.2f}x the compute "
        f"bound ({rl['t_compute'] * 1e3 / TRAIN_18A['ms']:.2%} of it), "
        f"{TRAIN_18A['ms'] / (rl['t_memory'] * 1e3):.2f}x the memory term; "
        f"trace {rec['lower_compile_s']:.1f} s, cell {rec['wall_s']:.1f} s")


def _dry_decode(device) -> None:
    """19b: qwen2-0.5b's decode_32k cell on a one-device mesh: argument
    bytes against the card's allocation, FLOPs against one real step."""
    import gc
    from repro_torch.configs import registry
    from repro_torch.launch.dryrun import StandInMesh
    from repro_torch.models.lm import LM
    shape = registry.SHAPES["decode_32k"]
    rec = _dry_cell("qwen2-0.5b", "decode_32k",
                    mesh=StandInMesh(("data", "model"), (1, 1)))
    args = rec["memory"]["argument_size_in_bytes"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg = registry.get_config("qwen2-0.5b")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(19),
                     device=device)
    cache = lm.init_cache(shape.global_batch, shape.seq_len, device=device)
    tokens = torch.zeros((shape.global_batch, 1), dtype=torch.int32,
                         device=device)
    position = torch.zeros((), dtype=torch.int32, device=device)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    check(abs(args - alloc) <= DRY_ARG_TOL * alloc,
          f"19b: argument bytes {args} vs memory_allocated {alloc}: more "
          f"than {DRY_ARG_TOL:.0%} apart")
    torch.cuda.reset_peak_memory_stats()
    flops, (logits, _) = _flops_of(lm.decode_step, params, cache, tokens,
                                   position)
    peak = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(logits).all()), "19b: decode logits")
    del lm, params, cache, tokens, position, logits
    check(flops == rec["full"]["flops"],
          f"19b: dry-run FLOPs {rec['full']['flops']:.0f} != the real "
          f"decode step's {flops}")
    rl = rec["roofline"]
    log(f"19b qwen2-0.5b decode_32k on a 1x1 mesh (B={shape.global_batch},"
        f" cache {shape.seq_len}): argument bytes {args / 1e9:.4f} GB vs "
        f"memory_allocated after init and init_cache {alloc / 1e9:.4f} GB "
        f"({args / alloc:.5f}x); FLOPs {flops} = the real step's; "
        f"predicted peak {rec['memory']['peak_bytes_per_device'] / 1e9:.3f}"
        f" GB vs the step's {peak / 1e9:.3f} GB; bound: memory "
        f"{rl['t_memory'] * 1e3:.2f} ms, compute "
        f"{rl['t_compute'] * 1e3:.3f} ms")


def phase_dryrun(device) -> None:
    """Phase 19: the dry-run against the card."""
    import gc
    t0 = time.perf_counter()
    _dry_train(device)
    log(f"[{time.perf_counter() - t0:.1f} s of phase 19] 19a done")
    gc.collect()
    torch.cuda.empty_cache()
    _dry_decode(device)
    log(f"[{time.perf_counter() - t0:.1f} s of phase 19] 19b done")
    gc.collect()
    torch.cuda.empty_cache()
    rec = _dry_cell("xlstm-125m", "decode_32k", multi_pod=False)
    rl, total = rec["roofline"], rec["memory"]["total_bytes_per_device"]
    check(rl["t_memory"] > 0 and total < DRY_CELL_LIMIT,
          f"19c: t_memory {rl['t_memory']}, {total} bytes a device")
    log(f"19c xlstm-125m decode_32k single: OK, {total / 2**30:.3f} GiB a "
        f"device (limit 16), t_memory {rl['t_memory'] * 1e6:.2f} us, "
        f"{rl['bottleneck']}-bound")
    log(f"phase 19: {time.perf_counter() - t0:.1f} s -- {smi_line()}")


# -- phase 20 ------------------------------------------------------------------

SHARD_B, SHARD_ACCUM = 4, 2      # 20a: B = 4 as 2 microbatches of 2
SHARD_TOL = 2e-2                 # rel. L2 of the updated params (phase 18)
PROD_MESH = (16, 16)             # 20b: the single-pod (data, model) mesh
PROD_B = 16                      # 20b: one sequence a data rank


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _scalar(x) -> float:
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def _sharded_one_rank(device) -> int:
    """20a: the sharded train and eval steps on a one-rank NCCL group
    against the one-device step. Returns the eval step's flash
    launches."""
    import gc

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models.lm import LM
    from repro_torch.sharding import specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    cfg = _qwen_train_cfg()
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(20),
                     device=device)
    ocfg = ts.opt_config_for(cfg, lr=1e-3, warmup_steps=2,
                             total_steps=TRAIN_STEPS)
    tokens = _train_batches(cfg, PREFILL_S, SHARD_B, 20, device)(0)
    one, one_ms = _synced_ms(ts.make_train_step(lm, ocfg, SHARD_ACCUM),
                             params, opt.init_opt_state(ocfg, params),
                             {"tokens": tokens})
    p1, m1 = one[0], one[2]
    del one
    gc.collect()
    torch.cuda.empty_cache()
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        pspecs = lm.param_specs()
        batch = {"tokens": tokens}
        bsh = specs.batch_shardings(cfg, mesh, batch)
        sparams = specs.place(params, specs.param_shardings(cfg, mesh,
                                                            pspecs))
        del params
        state = opt.init_opt_state(ocfg, sparams, specs.opt_shardings(
            cfg, mesh, opt.opt_state_specs(ocfg, pspecs)))
        step = ts.make_train_step(lm, ocfg, SHARD_ACCUM,
                                  specs.grad_shardings(cfg, mesh, pspecs),
                                  specs.mb_shardings(bsh))
        fkernel.reset_launch_counts()
        (p2, _, m2), sharded_ms = _synced_ms(step, sparams, state,
                                             specs.place(batch, bsh))
        check(sum(fkernel.LAUNCHES.values()) == 0,
              f"20a: the sharded train step launched {fkernel.LAUNCHES}")
        loss1, loss2 = float(m1["loss"]), _scalar(m2["loss"])
        gn1, gn2 = float(m1["grad_norm"]), _scalar(m2["grad_norm"])
        check(abs(loss2 - loss1) <= LOSS_TOL,
              f"20a: sharded loss {loss2} vs one-device {loss1}")
        check(abs(gn2 / gn1 - 1) <= LOSS_TOL,
              f"20a: sharded grad_norm {gn2} vs one-device {gn1}")
        rel = _rel_l2(opt.tree_map(lambda t: t.full_tensor(), p2), p1)
        check(rel <= SHARD_TOL, f"20a: updated params {rel:.3g} apart "
              f"(rel. L2) > {SHARD_TOL}")
        del p1, p2, state
        gc.collect()
        torch.cuda.empty_cache()
        # the eval step on the DTensor params: the flash kernel on each
        # rank's local heads, one launch a layer
        mb = specs.place({"tokens": tokens[SHARD_B - SHARD_B
                                           // SHARD_ACCUM:]}, bsh)
        fkernel.reset_launch_counts()
        with torch.no_grad():
            ev, eval_ms = _synced_ms(ts.make_eval_step(lm), sparams, mb)
        flash = dict(fkernel.LAUNCHES)
        check(flash == {"flash_attention": 0,
                        "flash_attention_wgmma": cfg.num_layers},
              f"20a eval: flash launches {flash}, want {cfg.num_layers}")
        eval_loss = _scalar(ev["loss"])
        check(abs(eval_loss - loss2) <= LOSS_TOL,
              f"20a: eval loss through the kernel {eval_loss} vs the "
              f"sharded train loss {loss2}")
    finally:
        dist.destroy_process_group()
    log(f"20a qwen2-0.5b on a one-rank NCCL group, (1, 1) mesh (B="
        f"{SHARD_B} as {SHARD_ACCUM} x {SHARD_B // SHARD_ACCUM}, S="
        f"{PREFILL_S}, remat {cfg.remat}, grad_specs and mb_specs): "
        f"sharded step {sharded_ms:.1f} ms vs one-device {one_ms:.1f} ms; "
        f"loss {loss2:.5f} vs {loss1:.5f} (gap {abs(loss2 - loss1):.3g}, "
        f"gate {LOSS_TOL}); grad_norm {gn2:.5f} vs {gn1:.5f}; params "
        f"{rel:.3g} apart (rel. L2, gate {SHARD_TOL}); eval on the DTensor "
        f"params: {flash['flash_attention_wgmma']} flash launches on local "
        f"heads, loss {eval_loss:.5f} ({eval_ms:.1f} ms)")
    return flash["flash_attention_wgmma"]


def _production_rank(device) -> None:
    """20b: rank 0 of internlm2-20b's (16, 16) mesh on a fake process
    group, against the dry-run's traced record of the same cell."""
    import gc
    import math

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.roofline import counter
    from repro_torch.sharding import dtensor, specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    arch = "internlm2-20b"
    cfg = registry.get_config(arch)
    shape = registry.SHAPES["train_4k"]
    world = math.prod(PROD_MESH)
    dtensor.init_fake_group(world)
    try:
        stand_in = dryrun.StandInMesh(("data", "model"), PROD_MESH)
        t = time.perf_counter()
        rec = dryrun.run_cell(arch, "train_4k", verbose=False,
                              mesh=stand_in, batch=PROD_B, seq=PREFILL_S)
        check(rec["status"] == "OK" and rec["full"]["partition"]
              == "traced", f"20b dry-run: {rec.get('status')} "
              f"{rec.get('full', {}).get('partition')}")
        rec["roofline"] = dryrun.roofline_record(rec)
        rec["wall_s"] = time.perf_counter() - t
        print(json.dumps({"dryrun": rec}, default=float), flush=True)
        mesh = dryrun.device_mesh(stand_in, "cuda")
        model = registry.make_model(cfg)
        model.attn_impl = "reference"
        accum = rec["accum_steps"]
        pspecs = model.param_specs()
        ocfg = ts.opt_config_for(cfg)
        ospecs = opt.opt_state_specs(ocfg, pspecs)
        bspecs = registry.input_specs(cfg, shape, batch=PROD_B,
                                      seq=PREFILL_S)
        gen = torch.Generator(device=device).manual_seed(21)

        def draw(local_shape, dtype, dev):
            if dtype.is_floating_point:
                return (torch.randn(local_shape, generator=gen,
                                    device=dev) * 0.02).to(dtype)
            return torch.randint(0, cfg.vocab_size, local_shape,
                                 generator=gen, device=dev).to(dtype)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        clear = dryrun.launcher_constraints(model, cfg, mesh, "train")
        try:
            params = specs.make_leaves(
                pspecs, specs.param_shardings(cfg, mesh, pspecs), draw)
            state = opt.init_opt_state(ocfg, params, specs.opt_shardings(
                cfg, mesh, ospecs))
            batch = specs.make_leaves(
                bspecs, specs.batch_shardings(cfg, mesh, bspecs), draw)
            torch.cuda.synchronize()
            args = torch.cuda.memory_allocated() - base
            step = ts.make_train_step(model, ocfg, accum)
            with CommDebugMode() as comm, counter.RankFlops() as flops:
                (new_p, new_s, m), counted_ms = _synced_ms(
                    step, params, state, batch)
            peak = torch.cuda.max_memory_allocated() - base
            loss = _scalar(m["loss"])
            del new_p, new_s, m
            gc.collect()
            _, step_ms = _synced_ms(step, params, state, batch)
        finally:
            clear()
        del params, state, batch
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    full, mem = rec["full"], rec["memory"]
    pred = mem["peak_bytes_per_device"]
    check(abs(pred - peak) <= DRY_PEAK_TOL * peak,
          f"20b: dry-run peak {pred / 1e9:.2f} GB vs max_memory_allocated "
          f"{peak / 1e9:.2f} GB: more than {DRY_PEAK_TOL:.0%} apart")
    check(full["flops"] == flops.flops, f"20b: dry-run FLOPs "
          f"{full['flops']} != RankFlops over the real step {flops.flops}")
    real = {counter.KINDS[str(op).split(".")[-1]]: n
            for op, n in comm.get_comm_counts().items()}
    traced: dict[str, int] = {}
    for c in full["collectives"]:
        traced[c["kind"]] = traced.get(c["kind"], 0) + c["count"]
    check(traced == real, f"20b: dry-run collectives {traced} vs "
          f"CommDebugMode on the card {real}")
    nbytes: dict[str, int] = {}
    for c in full["collectives"]:
        key = f"{c['kind']} over {'+'.join(c['mesh_dims'])}"
        nbytes[key] = nbytes.get(key, 0) + c["result_bytes"] * c["count"]
    print(json.dumps({"phase20b": {
        "arch": arch, "mesh": list(PROD_MESH), "batch": PROD_B,
        "seq": PREFILL_S, "accum": accum, "peak_bytes": peak,
        "dry_peak_bytes": pred, "argument_bytes": args,
        "dry_argument_bytes": mem["argument_size_in_bytes"],
        "rank_flops": flops.flops, "collectives": real,
        "collective_result_bytes": nbytes, "step_ms": step_ms,
        "counted_step_ms": counted_ms, "loss_not_gated": loss}}),
        flush=True)
    log(f"20b internlm2-20b, rank 0 of a {PROD_MESH} mesh on a fake process "
        f"group of {world} ({cfg.num_layers} layers, act_spec on, B="
        f"{PROD_B} x S={PREFILL_S}, accum {accum}, remat {cfg.remat}): "
        f"peak {peak / 1e9:.3f} GB vs the dry-run's {pred / 1e9:.3f} GB "
        f"({pred / peak:.4f}x); arguments {args / 1e9:.3f} GB vs "
        f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB; FLOPs {flops.flops}"
        f" = the dry-run's; collectives {real} = the dry-run's; step "
        f"{step_ms:.1f} ms of rank 0's compute, collectives not moving "
        f"data ({counted_ms:.1f} ms under the counters); loss {loss:.4f} "
        f"not gated (the fake group moves no data)")


def phase_sharded(device) -> int:
    """Phase 20: sharded compute. Returns 20a's flash launches."""
    t0 = time.perf_counter()
    flash = _sharded_one_rank(device)
    log(f"[{time.perf_counter() - t0:.1f} s of phase 20] 20a done")
    _production_rank(device)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return flash


# -- phase 21 ------------------------------------------------------------------

INFER_B = 4                      # 21a: prompts of a batch
INFER_PROMPT, INFER_NEW = 32, 32  # 21a: prompt fed a token a step, greedy
PROD_DECODE = "deepseek-v3-671b"  # 21b: the production decode cell's model


def _infer_one_rank(device) -> int:
    """21a: sharded prefill and decode of full-width qwen2-0.5b on a
    one-rank NCCL group, a (1, 1) mesh, against the one-device path on the
    same params. Returns the sharded prefill's flash launches."""
    import gc

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.models.lm import LM
    from repro_torch.sharding import specs
    cfg = registry.get_config("qwen2-0.5b")
    lm = LM(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(21),
                     device=device)
    rng = np.random.default_rng(21)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        INFER_B, PREFILL_S))).to(device)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        INFER_PROMPT, INFER_B, 1))).to(device=device, dtype=torch.int32)
    steps = INFER_PROMPT + INFER_NEW
    with torch.no_grad():
        one_prefill = lm.prefill(params, {"tokens": toks})[:, 0].float()
    dist.init_process_group("nccl",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        sparams = specs.place(params, specs.param_shardings(
            cfg, mesh, lm.param_specs()))
        batch = {"tokens": toks}
        clear = dryrun.launcher_constraints(lm, cfg, mesh, "prefill")
        try:
            batch = specs.place(batch, specs.batch_shardings(cfg, mesh,
                                                             batch))
            fkernel.reset_launch_counts()
            with torch.no_grad():
                logits, prefill_ms = _synced_ms(lm.prefill, sparams, batch)
            flash = dict(fkernel.LAUNCHES)
        finally:
            clear()
        check(flash == {"flash_attention": 0,
                        "flash_attention_wgmma": cfg.num_layers},
              f"21a prefill: flash launches {flash}, want "
              f"{cfg.num_layers} on local heads")
        check(tuple(logits.placements) == tuple(
            specs.placements(mesh, (("data",), None, "model"))),
              f"21a prefill: logits placed {logits.placements}")
        err_p, _ = _logits_gate(logits.full_tensor()[:, 0].float(),
                                one_prefill, "21a sharded prefill")
        del logits, batch, one_prefill
        gc.collect()
        torch.cuda.empty_cache()
        bsh = specs.batch_shardings(cfg, mesh, registry.input_specs(
            cfg, registry.SHAPES["decode_32k"], batch=INFER_B,
            seq=PREFILL_S))
        clear = dryrun.launcher_constraints(lm, cfg, mesh, "decode")
        try:
            cache = lm.init_cache(INFER_B, PREFILL_S,
                                  shardings=bsh["cache"])
            cache1 = lm.init_cache(INFER_B, PREFILL_S, device=device)
            check(all(leaf.device_mesh is mesh for leaf in _leaves(cache)),
                  "21a: the cache is not on the mesh")
            tok, tok1 = prompt[0], prompt[0]
            out, out1, ms, ms1, errs = [], [], [], [], []
            fkernel.reset_launch_counts()
            with torch.no_grad():
                for t in range(steps):
                    pos = torch.tensor(t, dtype=torch.int32, device=device)
                    (lg, cache), m = _synced_ms(
                        lm.decode_step, sparams, cache,
                        specs.place(tok, bsh["tokens"]),
                        specs.place(pos, bsh["position"]))
                    (lg1, cache1), m1 = _synced_ms(lm.decode_step, params,
                                                   cache1, tok1, pos)
                    lg = lg.full_tensor()[:, 0].float()
                    lg1 = lg1[:, 0].float()
                    errs.append(_logits_gate(lg, lg1,
                                             f"21a decode step {t}")[0])
                    ms.append(m)
                    ms1.append(m1)
                    if t + 1 < INFER_PROMPT:
                        tok = tok1 = prompt[t + 1]
                    else:
                        tok = lg.argmax(-1).to(torch.int32)[:, None]
                        tok1 = lg1.argmax(-1).to(torch.int32)[:, None]
                        out.append(tok)
                        out1.append(tok1)
            decode_flash = dict(fkernel.LAUNCHES)
        finally:
            clear()
        got = torch.cat(out[:INFER_NEW], 1)
        want = torch.cat(out1[:INFER_NEW], 1)
        check(torch.equal(got, want), f"21a: sharded decode tokens "
              f"{got.tolist()} != the one-device decode_step's "
              f"{want.tolist()}")
        check(sum(decode_flash.values()) == 0,
              f"21a decode launched flash {decode_flash}")
        del cache, cache1, sparams
    finally:
        dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    p50, p50_1 = float(np.median(ms[1:])), float(np.median(ms1[1:]))
    log(f"21a qwen2-0.5b on a one-rank NCCL group, (1, 1) mesh: prefill B="
        f"{INFER_B} x S={PREFILL_S} on DTensor params: "
        f"{flash['flash_attention_wgmma']} flash launches on local heads, "
        f"{prefill_ms:.1f} ms, last-token logits max |diff| {err_p:.4g} vs "
        f"the one-device prefill (gate {LOGIT_TOL}); decode B={INFER_B} "
        f"on a shard-local cache of {PREFILL_S} slots: a {INFER_PROMPT}-"
        f"token prompt fed a token a step, then {INFER_NEW} greedy tokens "
        f"equal to the one-device decode_step's; logits max |diff| "
        f"{max(errs):.4g} over {steps} steps; p50 step {p50:.2f} ms "
        f"sharded vs {p50_1:.2f} ms one-device (same call, not gated)")
    return flash["flash_attention_wgmma"]


def _storage_ptr(a):
    """A tensor's storage's data pointer (None for anything else, or for a
    storage Python cannot reach, as a collective's in-flight output)."""
    if not isinstance(a, torch.Tensor):
        return None
    try:
        return a.untyped_storage().data_ptr()
    except RuntimeError:
        return None


def _input_watch(keys):
    """A dispatch mode that records each collective (on a rank's local
    tensors) whose input shares a storage whose data pointer is in
    ``keys`` (in ``hits``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.sharding import dtensor

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.hits = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, dtensor._dtensor()) for t in types):
                return NotImplemented
            if func.namespace == "_c10d_functional" and any(
                    _storage_ptr(a) in keys for a in args):
                self.hits.append(func._opname)
            return func(*args, **(kwargs or {}))
    return Watch()


def _production_cell(device, tag, arch, shape_name, watch=(),
                     rec=None) -> None:
    """Rank 0 of ``arch``'s ``shape_name`` cell on the ``PROD_MESH`` mesh
    over a fake process group (21b: deepseek-v3-671b ``decode_32k``; 22b:
    qwen2-vl-7b ``prefill_32k`` and hymba-1.5b ``decode_32k``), at full
    width and depth, params, batch and cache made shard by shard, against
    the dry-run's traced record of the same cell: peak and argument bytes
    within ``DRY_PEAK_TOL``, FLOPs and collectives by kind exact, and no
    collective takes a shard of a cache leaf named in ``watch`` as its
    input, or is as large as one layer's share of it times its smallest
    split (a gather of it). ``rec`` is the cell's record if it was traced
    already (``_dry_in_background``). The fake group moves no data, so the
    logits are not a result."""
    import gc
    import math

    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.roofline import counter
    from repro_torch.sharding import dtensor, specs
    cfg = registry.get_config(arch)
    shape = registry.SHAPES[shape_name]
    world = math.prod(PROD_MESH)
    dtensor.init_fake_group(world)
    try:
        stand_in = dryrun.StandInMesh(("data", "model"), PROD_MESH)
        if rec is None:
            t = time.perf_counter()
            rec = dryrun.run_cell(arch, shape_name, verbose=False,
                                  mesh=stand_in)
            rec["roofline"] = dryrun.roofline_record(rec)
            rec["wall_s"] = time.perf_counter() - t
        check(rec["status"] == "OK" and rec["full"]["partition"]
              == "traced", f"{tag} dry-run: {rec.get('status')} "
              f"{rec.get('full', {}).get('partition')}")
        print(json.dumps({"dryrun": rec}, default=float), flush=True)
        mesh = dryrun.device_mesh(stand_in, "cuda")
        model = registry.make_model(cfg)
        model.attn_impl = "reference"
        b, seq = shape.global_batch, shape.seq_len
        pspecs = model.param_specs()
        bspecs = registry.input_specs(cfg, shape)
        bsh = specs.batch_shardings(cfg, mesh, bspecs)
        gen = torch.Generator(device=device).manual_seed(22)

        def draw(local_shape, dtype, dev):
            if dtype.is_floating_point:
                return (torch.randn(local_shape, generator=gen,
                                    device=dev) * 0.02).to(dtype)
            return torch.randint(0, cfg.vocab_size, local_shape,
                                 generator=gen, device=dev).to(dtype)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        clear = dryrun.launcher_constraints(model, cfg, mesh, shape.kind)
        try:
            params = specs.make_leaves(
                pspecs, specs.param_shardings(cfg, mesh, pspecs), draw)
            batch = {k: specs.make_leaves(v, bsh[k], draw)
                     for k, v in bspecs.items()
                     if k not in ("cache", "position")}
            if shape.kind == "decode":
                batch["cache"] = model.init_cache(b, seq,
                                                  shardings=bsh["cache"])
                batch["position"] = specs.place(
                    torch.tensor(seq // 2, dtype=torch.int32),
                    bsh["position"])
            torch.cuda.synchronize()
            args = torch.cuda.memory_allocated() - base
            # each watched leaf: its local shape, one layer's share in
            # bytes, its last dim, dtype and smallest split
            watched, shares, slots = [], set(), set()

            def see(path, leaf):
                if specs._leaf_name(path) not in watch:
                    return
                local = leaf.to_local()
                one = local[0] if model.groups[path[0]].scanned else local
                watched.append(leaf)
                slots.add(tuple(local.shape))
                shares.add((one.numel() * one.element_size(),
                            leaf.shape[-1], leaf.dtype,
                            min(mesh.size(d) for d, p in enumerate(
                                leaf.placements) if p.is_shard())))
            specs.map_with_path(see, batch.get("cache", {}))
            keys = {leaf.to_local().untyped_storage().data_ptr()
                    for leaf in watched}
            torch.cuda.reset_peak_memory_stats()
            step = registry.step_fn(cfg, shape, model)
            with torch.no_grad():
                watch_ = _input_watch(keys)
                with CommDebugMode() as comm, counter.RankFlops() as flops, \
                        counter.CollectiveLog() as log_, watch_:
                    out, counted_ms = _synced_ms(step, params, batch)
                peak = torch.cuda.max_memory_allocated() - base
                logits = out[0] if shape.kind == "decode" else out
                finite = bool(torch.isfinite(logits.to_local()).all())
                del out, logits
        finally:
            clear()
        del params, batch, watched
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    full, mem = rec["full"], rec["memory"]
    pred = mem["peak_bytes_per_device"]
    check(abs(pred - peak) <= DRY_PEAK_TOL * peak,
          f"{tag}: dry-run peak {pred / 1e9:.3f} GB vs max_memory_allocated"
          f" {peak / 1e9:.3f} GB: more than {DRY_PEAK_TOL:.0%} apart")
    darg = mem["argument_size_in_bytes"]
    check(abs(darg - args) <= DRY_PEAK_TOL * args,
          f"{tag}: dry-run arguments {darg / 1e9:.3f} GB vs the allocation "
          f"{args / 1e9:.3f} GB: more than {DRY_PEAK_TOL:.0%} apart")
    check(full["flops"] == flops.flops, f"{tag}: dry-run FLOPs "
          f"{full['flops']} != RankFlops over the real step {flops.flops}")
    real = {counter.KINDS[str(op).split(".")[-1]]: n
            for op, n in comm.get_comm_counts().items()}
    traced: dict[str, int] = {}
    for c in full["collectives"]:
        traced[c["kind"]] = traced.get(c["kind"], 0) + c["count"]
    check(traced == real, f"{tag}: dry-run collectives {traced} vs "
          f"CommDebugMode on the card {real}")
    # no gather of a watched leaf (tests/test_torch_sharded_decode.py's
    # rule): no collective takes its shard as input, and none of its dtype
    # and last dim reaches one layer's share of it times its smallest split
    big = [(k, n, shape_) for k, n, _, shape_, dt in log_.ops
           for share, last, dtype, split in shares
           if dt == dtype and shape_[-1] == last and n >= share * split]
    check(not big, f"{tag}: collectives as large as a gathered "
          f"{'/'.join(watch)} leaf: {big}")
    check(not watch_.hits, f"{tag}: collectives took a "
          f"{'/'.join(watch)} shard as input: {watch_.hits}")
    nbytes: dict[str, int] = {}
    for c in full["collectives"]:
        key = f"{c['kind']} over {'+'.join(c['mesh_dims'])}"
        nbytes[key] = nbytes.get(key, 0) + c["result_bytes"] * c["count"]
    extra = ({"pos_read_bytes": full["pos_read_bytes"]}
             if shape.kind == "decode" else {})
    print(json.dumps({f"phase{tag}": {
        "arch": arch, "shape": shape_name, "mesh": list(PROD_MESH),
        "batch": b, "seq": seq, "watched_local_shapes": sorted(slots),
        "peak_bytes": peak, "dry_peak_bytes": pred, "argument_bytes": args,
        "dry_argument_bytes": darg, "rank_flops": flops.flops,
        "collectives": real, "collective_result_bytes": nbytes, **extra,
        "counted_step_ms": counted_ms, "logits_finite_not_gated": finite}}),
        flush=True)
    log(f"{tag} {arch} {shape_name}, rank 0 of a {PROD_MESH} mesh on a fake"
        f" process group of {world} ({cfg.num_layers} layers, B={b}, "
        f"sequence {seq}; watched {'/'.join(watch) or 'nothing'}, local "
        f"shapes {sorted(slots)}): peak {peak / 1e9:.3f} GB vs the "
        f"dry-run's {pred / 1e9:.3f} GB ({pred / peak:.4f}x); arguments "
        f"{args / 1e9:.3f} GB vs {darg / 1e9:.3f} GB; FLOPs {flops.flops} = "
        f"the dry-run's; collectives {real} = the dry-run's; no gather of "
        f"a watched leaf; step {counted_ms:.1f} ms of rank 0's compute "
        f"under the counters, collectives not moving data; dry-run trace "
        f"{rec['wall_s']:.1f} s; logits not gated (the fake group moves no "
        f"data)")


def phase_infer_sharded(device) -> int:
    """Phase 21: sharded prefill and decode. Returns 21a's flash
    launches."""
    t0 = time.perf_counter()
    flash = _infer_one_rank(device)
    log(f"[{time.perf_counter() - t0:.1f} s of phase 21] 21a done")
    _production_cell(device, "21b", PROD_DECODE, "decode_32k",
                     ("ckv", "kpe"))
    log(f"phase 21: {time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return flash


# -- phase 22 -----------------------------------------------------------------

FAMILY_B = 2                     # 22a: prompts of a batch (S = PREFILL_S)
FAMILY_PROMPT, FAMILY_NEW = 2, 16  # 22a decode: prompt a token a step, greedy
# 22a: flash launches of one forward, on local heads (an attention layer
# each: hymba's 32, qwen2-vl's 28, whisper's 4 decoder self-attentions;
# xlstm has none)
FAMILY_FLASH = {"hymba-1.5b": 32, "qwen2-vl-7b": 28, "whisper-tiny": 4,
                "xlstm-125m": 0}
PROD_FAMILY = (("22b", "qwen2-vl-7b", "prefill_32k", ()),
               ("22b", "hymba-1.5b", "decode_32k", ("k", "v", "h", "conv")))


def _family_batch(cfg, device, rng) -> dict:
    """22a's batch of ``FAMILY_B`` rows of ``PREFILL_S``: tokens; whisper's
    frame embeddings ahead of its tokens' decoder; qwen2-vl's
    ``VL_PATCHES`` stub patches ahead of its tokens (its M-RoPE positions
    the model's own: the flash branch refuses caller-given ones, F3)."""
    from repro_torch.device import dtype_of
    cdt = dtype_of(cfg.compute_dtype)
    s = PREFILL_S
    batch = {}
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (FAMILY_B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
            ).to(device=device, dtype=cdt)
    if cfg.frontend == "vision_stub":
        batch["patch_embeds"] = (0.02 * torch.from_numpy(
            rng.standard_normal((FAMILY_B, VL_PATCHES, cfg.d_model)).astype(
                np.float32))).to(device=device, dtype=cdt)
        s -= VL_PATCHES
    batch["tokens"] = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (FAMILY_B, s))).to(device=device,
                                              dtype=torch.int32)
    return batch


def _family_cache(lm, params, batch, cap, **kw):
    """A decode cache of ``cap`` slots for ``batch``'s rows (``kw``:
    ``device`` or ``shardings``); an encoder-decoder's cross K/V written
    from the batch's frames."""
    b = batch["tokens"].shape[0]
    if lm.cfg.enc_dec:
        cache = lm.init_cache(None, b, cap, lm.cfg.enc_frames, **kw)
        return lm.write_cross(params, cache, batch["frames"])
    return lm.init_cache(b, cap, **kw)


def _family_infer(device, mesh, arch) -> int:
    """22a for one model: its sharded prefill and greedy decode on the
    one-rank mesh against the one-device path on the same params. Returns
    the sharded prefill's flash launches."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.sharding import specs
    cfg = registry.get_config(arch)
    lm = registry.make_model(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(22),
                     device=device)
    rng = np.random.default_rng(22)
    batch = _family_batch(cfg, device, rng)
    prompt = torch.from_numpy(rng.integers(1, cfg.vocab_size, (
        FAMILY_PROMPT, FAMILY_B, 1))).to(device=device, dtype=torch.int32)
    fkernel.reset_launch_counts()
    with torch.no_grad():
        one, one_ms = _synced_ms(lm.prefill, params, batch)
    one_flash = sum(fkernel.LAUNCHES.values())
    one = one[:, 0].float()
    sparams = specs.place(params, specs.param_shardings(
        cfg, mesh, lm.param_specs()))
    clear = dryrun.launcher_constraints(lm, cfg, mesh, "prefill")
    try:
        sbatch = specs.place(batch, specs.batch_shardings(cfg, mesh, batch))
        fkernel.reset_launch_counts()
        with torch.no_grad():
            logits, ms = _synced_ms(lm.prefill, sparams, sbatch)
        flash = dict(fkernel.LAUNCHES)
    finally:
        clear()
    want = FAMILY_FLASH[arch]
    check(flash.get("flash_attention_wgmma", 0) == want == one_flash
          and flash.get("flash_attention", 0) == 0,
          f"22a {arch} prefill: flash launches {flash} (one device "
          f"{one_flash}), want {want} on local heads")
    got = logits.full_tensor()[:, 0].float()
    err_p = float((got - one).abs().max())
    _logits_gate(got, one, f"22a {arch} sharded prefill")
    del logits, got, one
    gc.collect()
    torch.cuda.empty_cache()
    cap = FAMILY_PROMPT + FAMILY_NEW
    dsh = specs.batch_shardings(cfg, mesh, registry.input_specs(
        cfg, registry.SHAPES["decode_32k"], batch=FAMILY_B, seq=cap))
    with torch.no_grad():
        cache = _family_cache(lm, sparams, sbatch, cap,
                              shardings=dsh["cache"])
        cache1 = _family_cache(lm, params, batch, cap, device=device)
    check(all(leaf.device_mesh is mesh for leaf in _leaves(cache)),
          f"22a {arch}: the cache is not on the mesh")
    tok = tok1 = prompt[0]
    out, out1, errs, ms_d = [], [], [], []
    fkernel.reset_launch_counts()
    with torch.no_grad():
        for t in range(cap):
            pos = torch.tensor(t, dtype=torch.int32, device=device)
            (lg, cache), m = _synced_ms(
                lm.decode_step, sparams, cache,
                specs.place(tok, dsh["tokens"]),
                specs.place(pos, dsh["position"]))
            lg1, cache1 = lm.decode_step(params, cache1, tok1, pos)
            lg = lg.full_tensor()[:, 0].float()
            lg1 = lg1[:, 0].float()
            errs.append(float((lg - lg1).abs().max()))
            _logits_gate(lg, lg1, f"22a {arch} decode step {t}")
            ms_d.append(m)
            if t + 1 < FAMILY_PROMPT:
                tok = tok1 = prompt[t + 1]
            else:
                tok = lg.argmax(-1).to(torch.int32)[:, None]
                tok1 = lg1.argmax(-1).to(torch.int32)[:, None]
                out.append(tok)
                out1.append(tok1)
    decode_flash = sum(fkernel.LAUNCHES.values())
    got, want_t = torch.cat(out[:FAMILY_NEW], 1), torch.cat(
        out1[:FAMILY_NEW], 1)
    check(torch.equal(got, want_t), f"22a {arch}: sharded decode tokens "
          f"{got.tolist()} != the one-device decode_step's "
          f"{want_t.tolist()}")
    check(decode_flash == 0, f"22a {arch} decode launched flash")
    del cache, cache1, sparams, params, sbatch, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"22a {arch} (full width and depth, {cfg.num_layers} layers, "
        f"{cfg.param_dtype} params, {cfg.compute_dtype} compute) on the "
        f"one-rank mesh: prefill B={FAMILY_B} x "
        f"S={PREFILL_S} on DTensor params: {want} flash launches on local "
        f"heads, {ms:.1f} ms (one device {one_ms:.1f} ms), last-token "
        f"logits max |diff| {err_p:.4g} vs the one-device prefill; decode "
        f"on a shard-local cache of {cap} slots: {FAMILY_PROMPT} prompt "
        f"tokens, then {FAMILY_NEW} greedy tokens equal to the one-device "
        f"path's, logits max |diff| {max(errs):.4g}, p50 step "
        f"{float(np.median(ms_d[1:])):.2f} ms")
    return want


# 22a: hymba's train step, B x S. S 4096 fits (19.3 s a step on one device,
# 20.6 s sharded), but phase 22's 120 s does not hold both steps at it
# beside 22b; at S 2048 (9.4 and 14.1 s) the phase took 118.5 s
HY_TRAIN_B, HY_TRAIN_S = 2, 1024
DRY_DIR = ROOT / "build" / "chip_smoke_dry"   # 22b's records, removed after


def _family_train(device, mesh) -> None:
    """22a: one sharded train step of full-width hymba-1.5b on the
    one-rank mesh against the one-device step (phase 20a's gates)."""
    import gc

    from repro_torch.configs import registry
    from repro_torch.sharding import specs
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainstep as ts
    arch = "hymba-1.5b"
    cfg = registry.get_config(arch)
    lm = registry.make_model(cfg)
    params = lm.init(torch.Generator(device=device).manual_seed(23),
                     device=device)
    ocfg = ts.opt_config_for(cfg, lr=1e-3, warmup_steps=2,
                             total_steps=TRAIN_STEPS)
    tokens = _train_batches(cfg, HY_TRAIN_S, HY_TRAIN_B, 23, device)(0)
    one, one_ms = _synced_ms(ts.make_train_step(lm, ocfg), params,
                             opt.init_opt_state(ocfg, params),
                             {"tokens": tokens})
    p1, m1 = one[0], one[2]
    del one
    gc.collect()
    torch.cuda.empty_cache()
    pspecs = lm.param_specs()
    batch = {"tokens": tokens}
    bsh = specs.batch_shardings(cfg, mesh, batch)
    sparams = specs.place(params, specs.param_shardings(cfg, mesh, pspecs))
    del params
    state = opt.init_opt_state(ocfg, sparams, specs.opt_shardings(
        cfg, mesh, opt.opt_state_specs(ocfg, pspecs)))
    fkernel.reset_launch_counts()
    (p2, _, m2), ms = _synced_ms(ts.make_train_step(lm, ocfg), sparams,
                                 state, specs.place(batch, bsh))
    check(sum(fkernel.LAUNCHES.values()) == 0,
          f"22a: the sharded train step launched {fkernel.LAUNCHES}")
    loss1, loss2 = float(m1["loss"]), _scalar(m2["loss"])
    gn1, gn2 = float(m1["grad_norm"]), _scalar(m2["grad_norm"])
    check(abs(loss2 - loss1) <= LOSS_TOL,
          f"22a {arch}: sharded loss {loss2} vs one-device {loss1}")
    check(abs(gn2 / gn1 - 1) <= LOSS_TOL,
          f"22a {arch}: sharded grad_norm {gn2} vs one-device {gn1}")
    rel = _rel_l2(opt.tree_map(lambda t: t.full_tensor(), p2), p1)
    check(rel <= SHARD_TOL, f"22a {arch}: updated params {rel:.3g} apart "
          f"(rel. L2) > {SHARD_TOL}")
    del p1, p2, state, sparams
    gc.collect()
    torch.cuda.empty_cache()
    log(f"22a {arch} train step on the one-rank mesh (B={HY_TRAIN_B} x "
        f"S={HY_TRAIN_S}, remat {cfg.remat}, the chunked attention path): "
        f"sharded {ms:.1f} ms vs one-device {one_ms:.1f} ms; loss "
        f"{loss2:.5f} vs {loss1:.5f} (gap {abs(loss2 - loss1):.3g}, gate "
        f"{LOSS_TOL}); grad_norm {gn2:.5f} vs {gn1:.5f}; params {rel:.3g} "
        f"apart (rel. L2, gate {SHARD_TOL})")


def _dry_in_background(cells):
    """The dry-run of each (arch, shape) cell on the single-pod mesh (=
    ``PROD_MESH``), each in a process of its own (``python -m
    repro_torch.launch.dryrun``, its record into ``DRY_DIR``), started now
    so that the host traces while the card runs 22a. Returns a function
    that waits for them and gives each cell's record (its ``wall_s`` the
    process's, import included)."""
    import os
    import shutil
    assert PROD_MESH == (16, 16)
    shutil.rmtree(DRY_DIR, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    procs = {(arch, shape): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--force", "--out",
         str(DRY_DIR)], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for arch, shape in cells}

    def wait() -> dict:
        recs = {}
        try:
            for (arch, shape), p in procs.items():
                out, _ = p.communicate(timeout=600)
                check(p.returncode == 0, f"dry-run of {arch} {shape}: exit "
                      f"{p.returncode}\n{out[-2000:]}")
                rec = json.loads((DRY_DIR / f"{arch}__{shape}__single.json"
                                  ).read_text())
                rec["wall_s"] = time.perf_counter() - t0
                recs[arch, shape] = rec
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            shutil.rmtree(DRY_DIR, ignore_errors=True)
        return recs
    return wait


def phase_families_sharded(device) -> dict:
    """Phase 22: the VLM, hybrid, SSM and encoder-decoder families on
    shards. Returns 22a's flash launches by model."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    t0 = time.perf_counter()
    records = _dry_in_background([(arch, shape)
                                  for _, arch, shape, _ in PROD_FAMILY])
    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            launches = {arch: _family_infer(device, mesh, arch)
                        for arch in FAMILY_FLASH}
            log(f"[{time.perf_counter() - t0:.1f} s of phase 22] 22a "
                "prefill and decode done")
            _family_train(device, mesh)
        finally:
            dist.destroy_process_group()
    finally:
        recs = records()
    log(f"[{time.perf_counter() - t0:.1f} s of phase 22] 22a done")
    for tag, arch, shape, watch in PROD_FAMILY:
        _production_cell(device, tag, arch, shape, watch,
                         rec=recs[arch, shape])
    log(f"phase 22: {time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return launches


# -- phase 23 ------------------------------------------------------------------

CQ = PS // 4        # the reference tests' pages hold 4 tokens, these PS
CV = 256            # prompt tokens below the smoke config's vocabulary


def _cq(n: int) -> int:
    """A reference test's prompt length at page size ``PS``: its prefill
    target (all but the last token) times ``CQ``, so a sequence holds the
    reference's pages."""
    return (n - 1) * CQ + 1


def _c_pool(cfg, device, fast, peer, host, bws=(819.0, 0.05, 0.016)):
    """A pool of the reference test's domains (pages and Eq.-1
    bandwidths; the DWP tuner frozen), page size ``PS``."""
    from repro_torch.core.dwp import DWPConfig
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain
    doms = [MemoryDomain("hbm_local", fast, bws[0], True),
            MemoryDomain("hbm_peer", peer, bws[1], False),
            MemoryDomain("host", host, bws[2], False)]
    return BwapPagePool(cfg, doms, page_size=PS,
                        dwp_config=DWPConfig(n=10 ** 6, c=1), device=device)


def _c_engine(cfg, params, device, pool, **kw):
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(cfg, params, pool, wall_clock=False, device=device,
                       **kw)


def _c_plane(eng) -> tuple:
    """The control plane an engine step left: the batch's page ids, the
    free lists' lengths, the refcounts."""
    v = eng.view
    return ([(s.sid, [int(p) for p in s.pages]) for s in eng.active],
            [len(f) for f in v.pool.free],
            sorted((int(p), int(n)) for p, n in v.table.ref.items()))


def _c_table(pool) -> dict:
    """Free lists, refcounts, trie nodes and the allocation cycle."""
    t = pool.table
    return {"free": [[int(p) for p in f] for f in pool.free],
            "ref": sorted((int(p), int(n)) for p, n in t.ref.items()),
            "trie": sorted((int(i), int(n.parent), tuple(n.block),
                            int(n.phys)) for i, n in t._nodes.items()),
            "cycle": int(pool._cycle_pos)}


def _c_reclaimed(pool) -> bool:
    return (pool.free_count() + int(pool.reserved.sum()) == pool.total_pages
            and not pool.table.ref)


def _c_kv(view, pages, n):
    """K and V of positions [0, n) of a sequence holding ``pages``:
    ``[layers, n, nkv, h]`` copies."""
    ids = torch.tensor([int(p) for p in pages], device=view.k_pool.device)
    k, v = (a[:, ids].flatten(1, 2)[:, :n].clone()
            for a in (view.k_pool, view.v_pool))
    return k, v


def _c_same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _c_tokens(eng) -> dict:
    return {s.sid: list(s.tokens) for s in eng.finished}


class _Tally:
    """The steps of phase 23's engines on one device: a step that ran
    prefill chunks runs one batched prefill launch a layer, a verify step
    one more, a plain decode step one decode launch a layer. The fabric's
    invariants are checked after every step."""

    def __init__(self):
        self.prefill = self.verify = self.decode = 0

    def step(self, eng, trail=None) -> None:
        c0, d0 = eng.prefill_chunks_run, eng.decode_steps
        v0 = eng.view.telemetry.snapshot()["spec"]["steps"]
        eng.step()
        eng.view.fabric.check_invariants()
        v = eng.view.telemetry.snapshot()["spec"]["steps"] - v0
        self.prefill += eng.prefill_chunks_run > c0
        self.verify += v
        self.decode += eng.decode_steps - d0 - v
        if trail is not None:
            trail.append(_c_plane(eng))

    def drain(self, eng, trail=None, cap=2000) -> None:
        n = 0
        while eng.active or eng.waiting:
            self.step(eng, trail)
            n += 1
            check(n < cap, "engine did not drain")


def _contract_sharing(device, cfg, params, tally):
    """``test_prefix_sharing_saves_pages_tokens_identical``: three
    requests share a two-page prefix (the donor's registers before the
    others arrive); the matchers map it onto the donor's pages. Gates:
    4 prefix-hit pages (2 matchers x 2 pages), fewer prefill tokens than
    unshared serving, the pool reclaimed. Logged: tokens against unshared
    serving (the prefill shapes differ)."""
    from repro_torch.scheduler import RequestScheduler
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, CV, 2 * PS).tolist()
    prompts = [prefix + rng.integers(1, CV, CQ * (3 + i)).tolist()
               for i in range(3)]
    rec, runs = {}, {}
    for reuse in (True, False):
        pool = _c_pool(cfg, device, 64, 16, 16)
        sched = RequestScheduler(pool, max_batch=8,
                                 prefill_token_budget=64 * CQ,
                                 default_max_new=5 * CQ)
        eng = _c_engine(cfg, params, device, pool, scheduler=sched,
                        sim_step_s=0.01, prefix_reuse=reuse)
        trail = []
        for p in prompts:                 # one arrival a step, as 0.02 s
            eng.submit(p)                 # apart at the reference's pace
            tally.step(eng, trail)
        tally.drain(eng, trail)
        check(len(eng.finished) == 3 and _c_reclaimed(pool),
              f"sharing (reuse {reuse}): not finished or not reclaimed")
        st = pool.table.stats()
        runs[reuse] = eng
        rec[reuse] = (trail, st, eng.prefill_tokens_computed,
                      _c_table(pool))
    on, off = runs[True], runs[False]
    hits = rec[True][1]["prefix_hit_pages"]
    check(hits == 2 * 2, f"sharing: {hits} prefix-hit pages, want 4")
    check(on.prefill_tokens_computed < off.prefill_tokens_computed,
          "sharing computed no fewer prefill tokens")
    same = sum(_c_tokens(on)[k] == v for k, v in _c_tokens(off).items())
    check(same == 3, f"sharing: tokens equal unshared serving's on "
          f"{same}/3 sequences")
    return rec, f"prefix-hit pages {hits}, prefill tokens " \
        f"{on.prefill_tokens_computed} vs {off.prefill_tokens_computed} " \
        f"unshared; tokens equal unshared serving's on {same}/3 sequences " \
        f"(gated: shared pages hold the bits a row-invariant prefill " \
        f"writes)"


def _contract_cow(device, cfg, params, tally):
    """``test_cow_fork_on_full_prompt_match_is_exact``: a prompt wholly
    covered by the donor's registered pages; its first decode step writes
    its last prompt position into a shared page, which forks. Gates: the
    clone's K/V equal the source's bit for bit when it is made; after the
    step the source is untouched and the clone differs from it at most in
    the written slot; the pool reclaimed."""
    from repro_torch.scheduler import RequestScheduler
    rng = np.random.default_rng(3)
    prefix = rng.integers(1, CV, 3 * PS).tolist()
    donor = prefix + rng.integers(1, CV, 5 * CQ).tolist()
    pool = _c_pool(cfg, device, 64, 16, 16)
    sched = RequestScheduler(pool, max_batch=8,
                             prefill_token_budget=64 * CQ,
                             default_max_new=5 * CQ)
    eng = _c_engine(cfg, params, device, pool, scheduler=sched,
                    sim_step_s=0.01)
    view, forks = eng.view, []
    fork = view.fork_for_write

    def spy(pages, idx):
        src = int(pages[idx])
        out = fork(pages, idx)
        if int(pages[idx]) != src:
            forks.append((src, int(pages[idx]),
                          (view.k_pool[:, src].clone(),
                           view.v_pool[:, src].clone()),
                          (view.k_pool[:, pages[idx]].clone(),
                           view.v_pool[:, pages[idx]].clone())))
        return out

    view.fork_for_write = spy
    trail = []
    eng.submit(donor)
    tally.step(eng, trail)
    eng.submit(list(prefix))
    while not forks:
        check(eng.active or eng.waiting, "the CoW fork never fired")
        tally.step(eng, trail)
    src, clone, at_src, at_clone = forks[0]
    check(_c_same(at_src, at_clone),
          "CoW: the clone's K/V differ from the source's when made")
    check(_c_same(at_src, (view.k_pool[:, src], view.v_pool[:, src])),
          "CoW: a write through the clone reached the source page")
    slot = (len(prefix) - 1) % PS         # the matcher's first decode write
    keep = [i for i in range(PS) if i != slot]
    check(_c_same((at_src[0][:, keep], at_src[1][:, keep]),
                  (view.k_pool[:, clone][:, keep],
                   view.v_pool[:, clone][:, keep])),
          "CoW: the clone changed outside the written slot")
    tally.drain(eng, trail)
    check(pool.table.cow_faults >= 1 and _c_reclaimed(pool),
          "CoW: no fault counted or the pool not reclaimed")
    return (trail, [(s, c) for s, c, _, _ in forks], pool.table.cow_faults,
            _c_table(pool)), f"{len(forks)} fork(s): page {src} -> " \
        f"{clone}, bit-equal at the fork, source untouched after the write"


def _contract_swap(device, cfg, params, tally):
    """``test_swap_roundtrip_pins_shared_pages`` through the engine: a
    victim holding two pages it shares with a donor and two of its own is
    swapped out (forced) and back in by the scheduler. Gates: the shared
    pages keep their ids, the exclusive ones park in slow domains; the
    parked bytes and, after the swap-in, every K/V position the victim
    held equal the bytes before, bit for bit; the pool reclaimed."""
    from repro_torch.scheduler import KVSwapManager, RequestScheduler
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, CV, 2 * PS).tolist()
    pool = _c_pool(cfg, device, 8, 12, 12)
    swap = KVSwapManager(pool, reserve_fraction=0.8)
    sched = RequestScheduler(pool, max_batch=4,
                             prefill_token_budget=64 * CQ,
                             default_max_new=4 * CQ, swap=swap)
    eng = _c_engine(cfg, params, device, pool, scheduler=sched,
                    sim_step_s=0.01)
    view, trail = eng.view, []
    eng.submit(prefix + rng.integers(1, CV, PS).tolist())
    tally.step(eng, trail)
    vid = eng.submit(prefix + rng.integers(1, CV, 2 * PS).tolist())
    victim = None
    while victim is None or victim.length < victim.prefill_target:
        tally.step(eng, trail)
        victim = next((r for r in sched.running if r.sid == vid), None)
    n = victim.length
    before, ids = _c_kv(view, victim.pages, n), list(victim.pages)
    shared = [p for p in ids if view.shared(p)]
    check(len(shared) == 2, f"swap: victim shares {shared}, want 2 pages")
    sched._swap_out(victim)
    parked = list(victim.pages)
    check([p for p in parked if p in shared] == shared
          and all(view.domain_of(p) in view.slow_domains
                  for p in parked if p not in shared),
          "swap: a shared page moved or an exclusive page did not park")
    check(_c_same(before, _c_kv(view, parked, n)),
          "swap: parked K/V differ from the bytes before")
    while victim not in sched.running:
        tally.step(eng, trail)
    back = list(victim.pages)
    check(back[:2] == shared, "swap: shared pages moved on the swap-in")
    check(_c_same(before, _c_kv(view, back, n)),
          "swap: K/V after the round trip differ from the bytes before")
    tally.drain(eng, trail)
    check(_c_reclaimed(pool) and swap.slots_free() == swap.reserved_total,
          "swap: the pool or the swap slots not reclaimed")
    return (trail, ids, parked, back, _c_table(pool)), \
        f"{len(parked) - 2} pages parked and back, {n} positions bit-equal"


def _contract_preempt(device, cfg, params, tally):
    """``test_forced_preemption_at_point_is_exact`` at decode steps 0, 2
    and 5: one sequence swapped out by force and resumed. Gates: the run
    completes, the pool and the swap slots drain; the tokens equal an
    unpressured run's (one sequence, one prefill chunk: the same GEMM
    shapes on both sides)."""
    from repro_torch.scheduler import (KVSwapManager, RequestScheduler,
                                       State)
    prompt = [3, 17, 29, 5, 41, 11] * CQ
    prompt = prompt[:_cq(6)]
    pool = _c_pool(cfg, device, 64, 8, 8)
    sched = RequestScheduler(pool, max_batch=1,
                             prefill_token_budget=64 * CQ,
                             default_max_new=8 * CQ)
    eng = _c_engine(cfg, params, device, pool, scheduler=sched)
    eng.submit(list(prompt))
    tally.drain(eng)
    want = eng.finished[0].tokens
    rec = []
    for at in (0, 2, 5):
        pool = _c_pool(cfg, device, 16, 8, 40)
        swap = KVSwapManager(pool, reserve_fraction=0.8)
        sched = RequestScheduler(pool, max_batch=1,
                                 prefill_token_budget=64 * CQ,
                                 default_max_new=8 * CQ, swap=swap)
        eng = _c_engine(cfg, params, device, pool, scheduler=sched)
        eng.submit(list(prompt))
        trail = []
        for _ in range(at + 1):
            tally.step(eng, trail)
        victim = sched.running[0]
        sched._swap_out(victim)
        check(victim.state is State.SWAPPED, "preempt: not swapped")
        parked = list(victim.pages)
        tally.drain(eng, trail)
        check(len(eng.finished) == 1 and _c_reclaimed(pool)
              and swap.slots_free() == swap.reserved_total,
              f"preempt at {at}: not finished or the ledgers not drained")
        check(eng.finished[0].tokens == want,
              f"preempt at {at}: tokens differ from the unpressured run's")
        rec.append((at, parked, trail, _c_table(pool)))
    return rec, "steps 0, 2, 5: completed, drained, tokens equal the " \
        "unpressured run's"


class _WrongDrafter:
    """Drafts the model's argmax does not confirm (the reference test's
    ``AlwaysWrongDrafter``): every draft rejects, so every lookahead page
    and every speculative slot must roll back."""

    def __init__(self, vocab: int, max_tokens: int):
        self.vocab, self.max_tokens = vocab, max_tokens

    def draft(self, tokens):
        t = self.vocab - 1 if tokens[-1] != self.vocab - 1 else 1
        return [t] * self.max_tokens


def _c_state(eng):
    pool = eng.view.pool
    return pool.k_pool.clone(), pool.v_pool.clone(), _c_table(pool), \
        [(s.sid, [int(p) for p in s.pages]) for s in eng.scheduler.running]


def _contract_rollback(device, cfg, params, tally):
    """``test_spec_multiseq_all_rejected_restores_allocator``: two
    sequences mid-page for two steps, every draft (``6 x CQ`` tokens, so
    each verify crosses a page boundary) rejected. After each step,
    gated against a greedy engine's: free lists, refcounts, trie, the
    allocation cycle and page ids equal; every K/V slot but the one each
    sequence committed equal bit for bit (the rejected slots restored).
    Logged: the committed slots' K/V and the tokens (the verify's GEMMs
    run 6 x CQ + 1 rows a sequence, greedy's one)."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, CV, _cq(7)).tolist(),
               rng.integers(1, CV, _cq(6)).tolist()]

    def mk(drafter):
        pool = _c_pool(cfg, device, 32, 16, 16, bws=(819.0, 50.0, 16.0))
        eng = _c_engine(cfg, params, device, pool, max_batch=4,
                        max_new=8 * CQ, sim_step_s=0.001, drafter=drafter)
        for p in prompts:
            eng.submit(list(p))
        while len(eng.scheduler.running) < 2:
            tally.step(eng)
        return eng

    g, s = mk(None), mk(_WrongDrafter(cfg.vocab_size, 6 * CQ))
    gs, ss = _c_state(g), _c_state(s)
    check(_c_same(gs[:2], ss[:2]) and gs[2:] == ss[2:],
          "rollback: speculative and greedy engines start apart")
    rec, diff = [], []
    for _ in range(2):
        check(all(r.length % PS for r in s.scheduler.running),
              "rollback: a sequence is not mid-page")
        tally.step(g)
        tally.step(s)
        gs, ss = _c_state(g), _c_state(s)
        check(gs[2:] == ss[2:], "rollback: free lists, refcounts, trie, "
              "cycle or page ids differ from greedy")
        keep = torch.ones(gs[0].shape[1:3], dtype=torch.bool,
                          device=gs[0].device)
        for r in s.scheduler.running:
            pos = r.length - 1
            keep[r.pages[pos // PS], pos % PS] = False
        for a, b in zip(gs[:2], ss[:2]):
            check(torch.equal(a[:, keep], b[:, keep]),
                  "rollback: a rejected slot's K/V not restored bit for bit")
            diff.append(float((a[:, ~keep].float()
                               - b[:, ~keep].float()).abs().max()))
        rec.append(ss[2:])
    sp = s.view.telemetry.snapshot()["spec"]
    check(sp["drafted"] > 0 and sp["accepted"] == 0,
          f"rollback: drafted {sp['drafted']}, accepted {sp['accepted']}")
    tally.drain(g)
    tally.drain(s)
    check(_c_reclaimed(g.view.pool) and _c_reclaimed(s.view.pool),
          "rollback: a pool not reclaimed")
    same = sum(_c_tokens(g)[k] == v for k, v in _c_tokens(s).items())
    check(max(diff) == 0 and same == 2,
          f"rollback: committed slots' K/V max |diff| {max(diff):.4g} "
          f"against greedy, tokens equal greedy's on {same}/2 sequences")
    return (rec, sp["drafted"]), \
        f"drafted {sp['drafted']}, accepted 0; committed slots' K/V max " \
        f"|diff| {max(diff):.4g} against greedy; tokens equal greedy's on " \
        f"{same}/2 sequences (both gated: a verify row computes a decode " \
        f"row's bits)"


def _contract_pressure(device, cfg, params, tally):
    """``test_oversubscribed_completes_with_zero_failures`` (12 bursty
    requests, footprint over the fast domain, 90 % of the slow domains
    reserved for swap), ``test_infeasible_request_rejected_at_submit`` and
    ``test_joint_exhaustion_raises_not_spins`` (through the engine). Gates:
    zero failures, every request its tokens, swaps out equal swaps in, the
    pool and slots drained; an infeasible prompt refused at submit; two
    feasible ones that cannot both grow raise within 60 x CQ steps."""
    from repro_torch.scheduler import (KVSwapManager, RequestScheduler,
                                       WorkloadSpec, generate,
                                       total_kv_pages)
    pool = _c_pool(cfg, device, 10, 10, 50)
    swap = KVSwapManager(pool, reserve_fraction=0.9)
    sched = RequestScheduler(pool, max_batch=6,
                             prefill_token_budget=24 * CQ,
                             default_max_new=8 * CQ, swap=swap)
    eng = _c_engine(cfg, params, device, pool, scheduler=sched,
                    sim_step_s=0.01)
    trace = generate(WorkloadSpec(
        kind="bursty", num_requests=12, mean_interarrival_s=0.005,
        prompt_mean=12 * CQ, prompt_max=20 * CQ, max_new=8 * CQ,
        vocab_size=CV, seed=1))
    check(total_kv_pages(trace, PS) > 10, "pressure: not oversubscribed")
    for t in trace:                       # all at once: no clock dependence
        eng.submit(list(t.prompt), max_new=t.max_new)
    trail = []
    tally.drain(eng, trail)
    tel = pool.telemetry
    check(len(eng.finished) == 12
          and all(r.produced == r.max_new for r in eng.finished),
          "pressure: a request failed or came short")
    check(tel.swap_outs > 0 and tel.swap_outs == tel.swap_ins,
          f"pressure: swaps out {tel.swap_outs}, in {tel.swap_ins}")
    check(_c_reclaimed(pool) and swap.slots_free() == swap.reserved_total,
          "pressure: pool or slots not drained")
    refused = []
    tiny = RequestScheduler(_c_pool(cfg, device, 2, 1, 1), max_batch=2,
                            default_max_new=4 * CQ)
    pool2 = _c_pool(cfg, device, 4, 8, 8)
    walled = RequestScheduler(pool2, max_batch=2, default_max_new=4 * CQ,
                              swap=KVSwapManager(pool2,
                                                 reserve_fraction=1.0))
    check(walled.allocatable_pages() == 4, "infeasible: allocatable pages")
    for sch, n in ((tiny, 40), (walled, 20)):
        try:
            sch.submit(list(range(1, _cq(n))))
        except ValueError as e:
            refused.append("allocatable" in str(e))
    check(refused == [True, True], f"infeasible: refused {refused}")
    pool3 = _c_pool(cfg, device, 4, 2, 2)
    eng3 = _c_engine(cfg, params, device, pool3,
                     scheduler=RequestScheduler(
                         pool3, max_batch=2, prefill_token_budget=6 * CQ,
                         default_max_new=20 * CQ))
    for _ in range(2):
        eng3.submit(list(range(1, _cq(13) + 1)))
    raised, steps = None, 0
    while raised is None and steps < 60 * CQ:
        try:
            tally.step(eng3)
        except RuntimeError as e:
            raised = str(e)
        steps += 1
    check(raised is not None and re.search("exhausted|grow", raised),
          f"joint exhaustion: {raised!r} after {steps} steps")
    return (trail, tel.swap_outs, _c_table(pool), steps, raised), \
        f"12/12 finished, {tel.swap_outs} swaps out and in; infeasible " \
        f"prompts refused at submit; joint exhaustion raised after " \
        f"{steps} steps"


CONTRACT = (("prefix sharing", _contract_sharing),
            ("CoW fork", _contract_cow),
            ("swap round trip", _contract_swap),
            ("forced preemption", _contract_preempt),
            ("rejected speculation", _contract_rollback),
            ("oversubscription", _contract_pressure))


def _smoke_model():
    """The one-layer fp32 qwen2 smoke model on the host, seeded: the CPU
    run whose control plane phase 23's card run must equal."""
    import dataclasses
    from repro_torch.configs import registry
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(registry.get_smoke_config("qwen2-0.5b"),
                              num_layers=1, compute_dtype="float32")
    return cfg, LM(cfg).init(torch.Generator().manual_seed(0), device="cpu")


def phase_contract(device, cfg, params) -> dict:
    """Phase 23: the engine-level cases of the reference's own tests of
    the page table, scheduler and speculation, at full width through the
    paged kernels (see the module docstring). Each scenario also runs on
    the host at the smoke config, where the same code path runs the plain
    versions: the control plane (page ids after every step, free lists,
    refcounts, trie, cycle) must be equal; it does not depend on the
    model's width or values."""
    t0 = time.perf_counter()
    scfg, sparams = _smoke_model()
    torch.cuda.synchronize()
    kernel.reset_launch_counts()
    fkernel.reset_launch_counts()
    tally = _Tally()
    for name, run in CONTRACT:
        t1 = time.perf_counter()
        rec, note = run(device, cfg, params, tally)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        want, _ = run("cpu", scfg, sparams, _Tally())
        check(rec == want, f"phase 23, {name}: the control plane differs "
              f"from the host run's at the smoke config")
        log(f"phase 23, {name}: {note}; control plane equal to the host "
            f"run's ({t2 - t1:.1f} s on the card, "
            f"{time.perf_counter() - t2:.1f} s on the host)")
    launches = {**kernel.LAUNCHES, **fkernel.LAUNCHES}
    nl = cfg.num_layers
    check(launches["paged_prefill_attention_batch"]
          == (tally.prefill + tally.verify) * nl,
          f"phase 23: a prefill or verify step missed the prefill kernel "
          f"({launches}, {tally.prefill} prefill and {tally.verify} verify "
          f"steps)")
    check(launches["paged_attention"] == tally.decode * nl,
          f"phase 23: a decode step missed the decode kernel ({launches}, "
          f"{tally.decode} decode steps)")
    check(launches["flash_attention"] == 0
          and launches["flash_attention_wgmma"] == 0,
          "phase 23 ran a full-sequence forward")
    _check_instances(cfg, {"launches": launches})
    log(f"phase 23: {tally.prefill} prefill, {tally.verify} verify and "
        f"{tally.decode} decode steps at full width, launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return {"launches": launches}


# -- phase 24 ------------------------------------------------------------------

SERVE_MIN_RATIO = 1.3            # serve_bench.speculative_compare's gate


def phase_entry_points(device) -> float:
    """Phase 24: ``torch_serve_bench.speculative_compare`` on the card at
    the reference's smoke config (seeded random params): zero failed
    requests and greedy's tokens, gated; the decode-step ratio logged
    against the reference's 1.3 (its counters follow the params). Then
    ``python -m benchmarks.torch_run --device cuda`` in a process of its
    own: exit 0, which includes its ``torch_artifacts.check()``, and the
    check again here; each section's seconds printed. Then the serving
    CLIs (``phase_clis``). Returns the CLIs' seconds."""
    from benchmarks import torch_artifacts, torch_serve_bench
    t0 = time.perf_counter()
    rows = torch_serve_bench.speculative_compare(device=device, check=False)
    g, sp = rows["greedy"], rows["speculative"]
    check(g["failed"] == 0 and sp["failed"] == 0,
          f"phase 24: failed requests greedy {g['failed']}, speculative "
          f"{sp['failed']}")
    check(rows["token_identical"],
          "phase 24: speculative tokens differ from greedy's")
    log(f"phase 24, speculative_compare on the card: decode steps "
        f"{g['decode_steps']} greedy / {sp['decode_steps']} speculative, "
        f"ratio {rows['decode_step_ratio']:.3f} (the reference's gate "
        f"{SERVE_MIN_RATIO}, logged), drafted {sp['spec']['drafted']}, "
        f"accepted {sp['spec']['accepted']}, tokens equal greedy's "
        f"(gated), {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "benchmarks.torch_run", "--device", "cuda"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": f"{SRC}:{ROOT}"},
        capture_output=True, text=True, timeout=600)
    for line in r.stdout.splitlines():
        if line.startswith(("[section", "[port artifacts", "[benchmarks")):
            log(f"  torch_run {line}")
    check(r.returncode == 0, f"phase 24: benchmarks.torch_run exited "
          f"{r.returncode}:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    torch_artifacts.check()
    log(f"phase 24: torch_run {time.perf_counter() - t1:.1f} s -- "
        f"{smi_line()}")
    t2 = time.perf_counter()
    phase_clis()
    cli_s = time.perf_counter() - t2
    log(f"phase 24: the serving CLIs {cli_s:.1f} s, the phase "
        f"{time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return cli_s


# the serving CLIs README.md lists for the card: (tag, arguments after the
# interpreter); each runs with its defaults on the card and again with
# ``--device cpu``
CLIS = (("launch.serve", ("-m", "repro_torch.launch.serve")),
        ("serve_paged", ("examples/torch_serve_paged.py",)),
        ("serve_paged --restart-demo",
         ("examples/torch_serve_paged.py", "--restart-demo")),
        ("coscheduled", ("examples/torch_coscheduled.py",)))
CLI_TIMEOUT = 300
CLI_REQUESTS = 4                 # launch.serve's default --requests
_SNIPPET = re.compile(r"^\s+seq \d+ \[\w+\]: \[")   # token snippets


def _summary(out: str) -> list[str]:
    """What an example prints alike on every device: all but its token
    snippets (``tests/_torch_parity.example_summary``)."""
    return [ln for ln in out.splitlines() if not _SNIPPET.match(ln)]


def _cli_gates(tag, card: str, host: str) -> str:
    """A CLI's own printed checks on the card, and its summary against the
    host run's; returns what it printed that the log keeps."""
    def find(pattern, out, what):
        m = re.search(pattern, out)
        check(m, f"phase 24, {tag} ({what}): no {pattern!r} in:\n{out}")
        return m
    if tag == "launch.serve":
        pat = r"served (\d+) sequences in (\d+) engine steps on (\w+)"
        m, h = find(pat, card, "card"), find(pat, host, "host")
        check(int(m[1]) == CLI_REQUESTS and m[3] == "cuda",
              f"phase 24, {tag}: served {m[1]}/{CLI_REQUESTS} on {m[3]}")
        check(m.groups()[:2] == h.groups()[:2],
              f"phase 24, {tag}: {m[0]!r} on the card, {h[0]!r} on the host")
        return m[0]
    check(_summary(card) == _summary(host),
          f"phase 24, {tag}: the summary differs from the host run's:\n"
          f"{card}\n--- host ---\n{host}")
    if tag == "serve_paged":
        m = find(r"finished (\d+)/(\d+) sequences in [\d.]+ virtual s; "
                 r"swaps (\d+) out / (\d+) in", card, "card")
        check(m[1] == m[2] and m[3] == m[4] and int(m[3]) > 0,
              f"phase 24, {tag}: {m[0]!r}")
        return m[0]
    if tag.endswith("--restart-demo"):
        e = find(r"exported (\d+) chain\(s\) \((\d+) pages\)", card, "card")
        m = find(r"matched (\d+) pages from the restored trie", card, "card")
        check(int(e[1]) > 0 and m[1] == e[2],
              f"phase 24, {tag}: {e[0]!r}, {m[0]!r}")
        return f"{e[0]}; {m[0]}"
    find(r"token-identical outputs fabric vs isolated: True", card, "card")
    m = find(r"swap-slot loan A->B: granted [1-9]\d* slots, .*outstanding 0",
             card, "card")
    f = find(r"A finished \d+ sequences", card, "card")
    return f"{m[0]}; {f[0]}; tokens equal fabric vs isolated"


def phase_clis() -> None:
    """Phase 24's serving CLIs: ``python -m repro_torch.launch.serve``,
    ``examples/torch_serve_paged.py`` (with and without
    ``--restart-demo``) and ``examples/torch_coscheduled.py``, each in a
    process of its own on the card (their defaults), then with
    ``--device cpu``; the four CLIs run side by side, each on the card
    first and then on the host (the two restart demos share one on-disk
    store). Gates: exit 0, each
    script's own printed checks, and its summary equal to the host run's
    (token snippets aside; for ``launch.serve``, sequences and steps)."""
    from concurrent.futures import ThreadPoolExecutor
    # two threads each: four processes share the host's cores
    env = {**os.environ, "PYTHONPATH": f"{SRC}:{ROOT}",
           "OMP_NUM_THREADS": "2"}
    store = ROOT / "benchmarks" / "results" / "torch_persist_store_demo"
    existed = store.exists()

    def run(argv, host: bool):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, *argv,
                            *(("--device", "cpu") if host else ())],
                           cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=CLI_TIMEOUT)
        return r, time.perf_counter() - t

    def chain(argv):
        return [run(argv, host) for host in (False, True)]

    try:
        with ThreadPoolExecutor(max_workers=len(CLIS)) as pool:
            results = dict(zip([tag for tag, _ in CLIS],
                               pool.map(chain, [a for _, a in CLIS])))
    finally:
        if not existed:
            shutil.rmtree(store, ignore_errors=True)
    for tag, _ in CLIS:
        (card, card_s), (host, host_s) = results[tag]
        for r, where in ((card, "card"), (host, "host")):
            check(r.returncode == 0, f"phase 24, {tag} on the {where} "
                  f"exited {r.returncode}:\n{r.stdout[-3000:]}\n"
                  f"{r.stderr[-3000:]}")
        note = _cli_gates(tag, card.stdout, host.stdout)
        log(f"phase 24, {tag}: exit 0 on the card ({card_s:.1f} s) and "
            f"with --device cpu ({host_s:.1f} s), summary equal; {note}")


# -- phase 27 ------------------------------------------------------------------

# tests/test_obs.py's traced_runs: its pool (pages, Eq.-1 bandwidths) at
# page 4, the bandwidths x CODA_BW_SCALE on the card so the schedule is
# the smoke run's; its trace is drawn over the smoke config's vocabulary
# on both devices, so the prompts are the same too
OBS_DOMAINS = (("hbm_local", 8, 819.0, True), ("hbm_peer", 8, 0.05, False),
               ("host", 40, 0.016, False))
OBS_SPANS = ("admit", "prefill", "decode", "swap_out", "swap_in", "finish")
_PROM_LINE = re.compile(r"^(# (HELP|TYPE) \S+ .*|[a-zA-Z_:][a-zA-Z0-9_:]*"
                        r"(\{.*\})? \S+)$")


def _obs_trace(vocab: int):
    from repro_torch.scheduler import WorkloadSpec, generate
    return generate(WorkloadSpec(
        kind="poisson", num_requests=5, mean_interarrival_s=0.005,
        prompt_mean=10, prompt_max=20, max_new=6, vocab_size=vocab,
        class_mix=(("hi", 0.4), ("lo", 0.6)), seed=0))


def _obs_run(cfg, params, device, trace, tally, *, with_obs,
             scale) -> dict:
    """``traced_runs``'s ``run`` on ``device``: the engine over the
    scenario's pool (bandwidths x ``scale``), a contract validator on every
    fabric event, an ``Observatory(pool, drift=False)`` when
    ``with_obs``; the fabric's invariants after every step (``tally``)."""
    from repro_torch.core.dwp import DWPConfig
    from repro_torch.obs import Observatory
    from repro_torch.placement.fabric import (EVENT_FIELDS, EVENTS,
                                              SHARE_KIND_FIELDS)
    from repro_torch.placement.pool import BwapPagePool, MemoryDomain
    from repro_torch.scheduler import (KVSwapManager, PriorityClass,
                                       RequestScheduler, SloSpec)
    from repro_torch.serve.engine import ServeEngine
    pool = BwapPagePool(cfg, [MemoryDomain(n, p, bw * scale, fast)
                              for n, p, bw, fast in OBS_DOMAINS],
                        page_size=4, dwp_config=DWPConfig(n=10 ** 6, c=1),
                        device=device)
    swap = KVSwapManager(pool, placement="bwap_canonical",
                         reserve_fraction=0.9)
    sched = RequestScheduler(
        pool, max_batch=3, prefill_token_budget=16,
        classes=[PriorityClass("hi", 2, SloSpec(ttft_s=0.5, tpot_s=0.1)),
                 PriorityClass("lo", 0)],
        default_class="lo", default_max_new=6, swap=swap)
    eng = ServeEngine(cfg, params, pool, scheduler=sched, wall_clock=False,
                      sim_step_s=0.01, device=device)
    fab, violations, events = eng.view.fabric, [], []

    def validator(event):
        def check_fields(**kw):
            need = set(EVENT_FIELDS[event])
            if event == "share":
                need |= set(SHARE_KIND_FIELDS.get(kw.get("kind"), ()))
            events.append(event)
            if not need <= set(kw):
                violations.append((event, sorted(need - set(kw))))
        return check_fields

    for ev in EVENTS:
        fab.subscribe(ev, validator(ev))
    obs = Observatory(pool, drift=False) if with_obs else None
    for t in trace:
        eng.submit(list(t.prompt), cls=t.cls, max_new=t.max_new,
                   arrival_s=t.arrival_s)
    tally.drain(eng)
    tel = pool.telemetry
    return dict(tokens=[list(s.tokens) for s in sorted(
                    eng.finished, key=lambda s: s.sid)],
                obs=obs, swaps=(tel.swap_outs, tel.swap_ins),
                violations=violations, events=len(events),
                errors=tel.subscriber_errors, reclaimed=_c_reclaimed(pool),
                page_bytes=pool.page_bytes)


def _obs_spans(run, what) -> int:
    """The reference case's gates on a preempted request's spans; returns
    its sid."""
    tr = run["obs"].tracer
    preempted = sorted({e["tid"] - 1 for e in tr.spans("swap_out")})
    check(preempted, f"{what}: no request was swapped out")
    sid = preempted[0]
    for name in OBS_SPANS:
        check(tr.spans(name, sid=sid),
              f"{what}: preempted request {sid} has no {name!r} span")
    check(all(e["dur"] >= 0 for e in tr.spans("queued")),
          f"{what}: a queued span has a negative duration")
    track = sorted(tr.spans(sid=sid), key=lambda e: e["ts"])
    check(track[0]["name"] == "admit" and track[-1]["name"] == "finish",
          f"{what}: request {sid}'s track runs {track[0]['name']} .. "
          f"{track[-1]['name']}, want admit .. finish")
    return sid


def _perfetto(path, what) -> list:
    """The reference case's rules for a trace Perfetto loads; returns its
    events."""
    data = json.loads(Path(path).read_text())
    check(data["displayTimeUnit"] == "ms", f"{what}: displayTimeUnit")
    evs = data["traceEvents"]
    check(evs and all("ph" in e and "pid" in e and "tid" in e for e in evs),
          f"{what}: an event without ph, pid or tid")
    names = {e["name"] for e in evs if e["ph"] == "M"}
    check({"process_name", "thread_name"} <= names,
          f"{what}: no process or thread names")
    check(all(e["dur"] >= 0 and e["ts"] >= 0 for e in evs if e["ph"] == "X"),
          f"{what}: a span at a negative time or of negative duration")
    return evs


def _obs_lifecycle(obs, what) -> tuple[int, float]:
    req = obs.metrics.get("repro_requests_total")
    admits = sum(req.value("admit", "default", c) for c in ("hi", "lo"))
    finishes = sum(req.value("finish", "default", c) for c in ("hi", "lo"))
    check(admits == 5 and finishes == 5,
          f"{what}: {admits} admits and {finishes} finishes, want 5 and 5")
    lat = obs.metrics.get("repro_step_latency_seconds").labels("default")
    check(lat.count > 0 and lat.quantile(0.5) > 0,
          f"{what}: step latency count {lat.count}, p50 "
          f"{lat.quantile(0.5)}")
    return lat.count, lat.quantile(0.5)


def _prom_families(text, what) -> set:
    bad = [ln for ln in text.splitlines() if not _PROM_LINE.match(ln)]
    check(not bad, f"{what}: lines neither HELP, TYPE nor a sample: "
          f"{bad[:3]}")
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def phase_obs(device, cfg, params) -> dict:
    """Phase 27: the reference's observability contract
    (``tests/test_obs.py``'s ``traced_runs`` and its cases) at full width
    through the paged kernels, once with the observatory and once
    without; the same scenario on the host at the smoke config gives the
    trace the card's must equal (see the module docstring)."""
    t0 = time.perf_counter()
    scfg, sparams = _smoke_model()
    trace = _obs_trace(scfg.vocab_size)
    torch.cuda.synchronize()
    _reset_counts()
    tally = _Tally()
    traced = _obs_run(cfg, params, device, trace, tally, with_obs=True,
                      scale=CODA_BW_SCALE)
    base = _obs_run(cfg, params, device, trace, tally, with_obs=False,
                    scale=CODA_BW_SCALE)
    torch.cuda.synchronize()
    launches = _counts()
    t1 = time.perf_counter()
    host = _obs_run(scfg, sparams, "cpu", trace, _Tally(),
                    with_obs=True, scale=1)
    t2 = time.perf_counter()
    check(traced["page_bytes"] == CODA_BW_SCALE * host["page_bytes"],
          f"phase 27: page bytes {traced['page_bytes']}, want "
          f"{CODA_BW_SCALE} x the host's {host['page_bytes']}")
    for r, what in ((traced, "traced"), (base, "untraced"), (host, "host")):
        check(len(r["tokens"]) == 5 and r["reclaimed"],
              f"phase 27, {what}: {len(r['tokens'])}/5 finished, pool "
              f"reclaimed {r['reclaimed']}")
        check(not r["violations"] and r["errors"] == 0,
              f"phase 27, {what}: contract violations {r['violations'][:3]}"
              f", subscriber errors {r['errors']}")
    check(traced["tokens"] == base["tokens"],
          "phase 27: the traced run's tokens differ from the untraced run's")
    outs, ins = traced["swaps"]
    check(outs > 0 and outs == ins and base["swaps"] == traced["swaps"]
          == host["swaps"],
          f"phase 27: swaps {traced['swaps']} traced, {base['swaps']} "
          f"untraced, {host['swaps']} on the host")
    sid = _obs_spans(traced, "phase 27")
    _obs_spans(host, "phase 27, host")
    with tempfile.TemporaryDirectory() as out:
        evs = _perfetto(traced["obs"].tracer.export(Path(out) / "card.json"),
                        "phase 27")
        hevs = _perfetto(host["obs"].tracer.export(Path(out) / "host.json"),
                         "phase 27, host")
    check(evs == hevs, f"phase 27: the exported trace's events ({len(evs)}) "
          f"differ from the host run's ({len(hevs)})")
    count, p50 = _obs_lifecycle(traced["obs"], "phase 27")
    _obs_lifecycle(host["obs"], "phase 27, host")
    fams = _prom_families(traced["obs"].metrics.prometheus_text(),
                          "phase 27")
    hfams = _prom_families(host["obs"].metrics.prometheus_text(),
                           "phase 27, host")
    check(hfams <= fams, f"phase 27: families of the host run missing on "
          f"the card: {sorted(hfams - fams)}")
    nl = cfg.num_layers
    check(launches["paged_prefill_attention_batch"] == tally.prefill * nl
          and tally.verify == 0,
          f"phase 27: a prefill step missed the prefill kernel ({launches}, "
          f"{tally.prefill} prefill steps)")
    check(launches["paged_attention"] == tally.decode * nl,
          f"phase 27: a decode step missed the decode kernel ({launches}, "
          f"{tally.decode} decode steps)")
    check(launches["flash_attention"] == 0
          and launches["flash_attention_wgmma"] == 0,
          "phase 27 ran a full-sequence forward")
    _check_instances(cfg, {"launches": launches})
    log(f"phase 27, the observability contract at full width ({cfg.name}, "
        f"{cfg.compute_dtype}, page 4, bandwidths x {CODA_BW_SCALE}): "
        f"tokens equal with and without the observatory; swaps {outs} out "
        f"/ {ins} in; preempted request {sid} holds "
        f"{', '.join(OBS_SPANS)}; {len(evs)} trace events, Perfetto-"
        f"loadable and equal to the host run's; 5 admits, 5 finishes; step latency count "
        f"{count}, p50 {p50:.4g} s; {traced['events']} bus events, 0 "
        f"contract violations, 0 subscriber errors; {len(fams)} metric "
        f"families ({len(hfams)} on the host)")
    log(f"phase 27: {tally.prefill} prefill and {tally.decode} decode steps "
        f"over both card runs, launches {launches}; {t1 - t0:.1f} s on the "
        f"card, {t2 - t1:.1f} s on the host, the phase "
        f"{time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return {"launches": launches, "seconds": time.perf_counter() - t0}


# -- phases 25 and 26 ----------------------------------------------------------

ROW_ARCHS = ("qwen2-0.5b", "gemma-2b", "qwen2-vl-7b")
# rows a weight product runs: a row alone, decode at batch 8, a verify step
# of 8 sequences x (1 + 4 drafts) (phase 5's drafter), the engine's largest
# prefill chunk (RequestScheduler's prefill_token_budget, 256 tokens)
ROW_M = (1, 8, 40, 256)
ROW_TIMED = (8, 40, 256)
VERIFY_T = 25                    # the layer check's verify chunk: 8 x 25


def _row_products():
    """{(K, N, tied): [arch product, ...]} over the served decoders' weight
    products (their K and V projections share a shape, as do gate and
    up); ``tied`` is a head read as the embedding's transpose."""
    from repro_torch.configs import registry
    out = {}
    for arch in ROW_ARCHS:
        cfg = registry.get_config(arch)
        d, ff = cfg.d_model, cfg.d_ff
        q = cfg.num_heads * cfg.head_dim_
        kv = cfg.num_kv_heads * cfg.head_dim_
        for name, k, n, tied in (
                ("wq", d, q, False), ("wk/wv", d, kv, False),
                ("wo", q, d, False), ("w_gate/w_up", d, ff, False),
                ("w_down", ff, d, False),
                ("head", d, cfg.vocab_size, cfg.tie_embeddings)):
            out.setdefault((k, n, tied), []).append(f"{arch} {name}")
    return out


def _rms(x) -> float:
    return float(x.double().square().mean().sqrt())


def _row_bound(m, k, n) -> tuple[float, str]:
    """Least ms of a bf16 [m, k] @ [k, n]: its bytes (each input read
    once, the output written once) at the HBM rate, or 2mnk flops at the
    bf16 dense peak, whichever is larger."""
    t_mem = 2 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    t_ops = 2 * m * n * k / PEAK_FLOPS["bfloat16"]
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else \
        "operations"


def _host_us(fn, calls: int = 50, batches: int = 21) -> float:
    """Host microseconds of ``fn`` a call, enqueue only: the least over
    ``batches`` of the mean of ``calls`` calls (no sync inside a batch;
    50 calls stay well inside the launch queue), so that the host's other
    work, which only adds, stays out of the number."""
    fn()
    means = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t) / calls * 1e6)
    torch.cuda.synchronize()
    return min(means)


def _row_plan(k, n) -> str:
    """The bf16 product's plan at [K, N] on this card, as the wrapper
    takes it (``rowwise_matmul.kernel.launch_args``)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    (_, _, _, bn, splits, _), (_, cols) = rkernel.launch_args(1, n, k, sms)
    return f"plan BN {bn}, splits {splits}, {cols} blocks a row tile"


def _row_case(k, n, tied, dtype, gen, what) -> tuple:
    """One product shape in one dtype: every row of launches of M in
    ``ROW_M`` rows, at offsets 0, 7 and the end of a 256-row input, equal
    bit for bit to the same row of the 256-row launch; the kernel's RMS
    error against an fp64 product no larger than ``torch.matmul``'s on
    the same inputs, up to three standard errors of an RMS over the
    outputs (1 + 3 / sqrt(n)). Returns (a, w, log text)."""
    big = max(ROW_M)
    a = torch.randn(big, k, generator=gen, device="cuda").to(dtype)
    # [N, K] stored, read as .T: an embedding table, or a projection as
    # the decoder stores it on a card (rowwise_matmul.ops.weight)
    scale = 0.02 if tied else k ** -0.5
    w = (torch.randn(n, k, generator=gen, device="cuda") * scale).to(dtype).T
    whole = rkernel.rowwise_matmul(a, w)
    for m in ROW_M[:-1]:
        for lo in sorted({0, 7, big - m}):
            part = rkernel.rowwise_matmul(a[lo:lo + m], w)
            check(torch.equal(part, whole[lo:lo + m]),
                  f"rowwise_matmul {what} {dtype}: rows {lo}..{lo + m} of "
                  f"an M = {m} launch differ from the M = {big} launch's")
    want = a.double() @ w.double()
    lib = torch.matmul(a, w)
    e_k, e_l = _rms(whole.double() - want), _rms(lib.double() - want)
    x_k = float((whole.double() - want).abs().max())
    x_l = float((lib.double() - want).abs().max())
    del want
    margin = 1 + 3 / whole.numel() ** 0.5
    check(e_k <= e_l * margin,
          f"rowwise_matmul {what} {dtype}: RMS error vs fp64 {e_k:.4g} > "
          f"torch.matmul's {e_l:.4g} x {margin:.5f}")
    return a, w, (f"RMS err vs fp64 {e_k:.4g} (torch.matmul {e_l:.4g}), max "
                  f"{x_k:.4g} ({x_l:.4g})")


def _norm_case(d, dtype, gen, arch) -> tuple:
    """The fused add + RMSNorm at width ``d``: ``s`` equal to torch's ``x +
    y`` bit for bit; the rows of ``s`` and ``h`` of M-row launches (offsets
    0, 7 and the end) equal bit for bit to the same rows of a 256-row
    launch, and the launch without ``y`` alike; ``h`` within two bf16 ulps
    of the plain version (fp32: 1e-6 relative), with ``y`` and without;
    whether torch's own reduction (the plain version on the card) keeps
    rows across M, logged. Returns (x, y, gamma, max |err|, that flag)."""
    big = max(ROW_M)
    x = (torch.randn(big, d, generator=gen, device="cuda") * 3).to(dtype)
    y = torch.randn(big, d, generator=gen, device="cuda").to(dtype)
    g = torch.randn(d, generator=gen, device="cuda") * 0.1
    what = f"rowwise_rmsnorm {arch} d {d} {dtype}"
    s, h = nkernel.add_rmsnorm(x, y, g, 1e-6)
    alone = nkernel.rmsnorm(x, g, 1e-6)
    check(torch.equal(s, x + y), f"{what}: s differs from torch's x + y")
    plain, plain_alone = nref.add_rmsnorm_ref(x, y, g, 1e-6)[1], \
        nref.rmsnorm_ref(x, g, 1e-6)
    torch_rows = True
    for m in ROW_M[:-1]:
        for lo in sorted({0, 7, big - m}):
            rows = slice(lo, lo + m)
            sm, hm = nkernel.add_rmsnorm(x[rows], y[rows], g, 1e-6)
            check(torch.equal(sm, s[rows]) and torch.equal(hm, h[rows])
                  and torch.equal(nkernel.rmsnorm(x[rows], g, 1e-6),
                                  alone[rows]),
                  f"{what}: rows {lo}..{lo + m} of an M = {m} launch differ "
                  f"from the M = {big} launch's")
        torch_rows &= torch.equal(nref.rmsnorm_ref(x[:m], g, 1e-6),
                                  plain_alone[:m])
    worst = 0.0
    for got, want in ((h, plain), (alone, plain_alone)):
        err = (got.float() - want.float()).abs()
        if dtype == torch.bfloat16:
            bound = BF16_ULPS[0] * want.float().abs() + BF16_ULPS[1]
        else:
            bound = 1e-6 * want.abs() + 1e-7
        check(bool((err <= bound).all()),
              f"{what}: max |err| vs the plain version {float(err.max()):.4g}")
        worst = max(worst, float(err.max()))
    return x, y, g, worst, torch_rows


def _norm_bound(m, d) -> float:
    """Least ms of the fused launch in bf16 with fp32 gamma: x and y read,
    s and h written (2 bytes each), gamma read (4 bytes), at the HBM
    rate."""
    return 1e3 * (2 * 4 * m * d + 4 * d) / HBM_BYTES_PER_S


def phase_rowwise() -> dict:
    """Phase 25: the row-invariant product at every weight shape of the
    served decoders and the fused add + RMSNorm at their widths, in bf16
    and fp32; times (bf16) against torch.matmul, against torch's ``x + y``
    followed by the norm's launch without ``y`` or by ``F.rms_norm``, and
    the bound. Returns the kernels line's rows a model (the head's product
    at decode, the final norm at decode)."""
    import torch.nn.functional as F
    from repro_torch.configs import registry
    t0 = time.perf_counter()
    card = smi_line()
    gen = torch.Generator(device="cuda").manual_seed(25)
    rows = {}
    for (k, n, tied), users in _row_products().items():
        what = f"[{k} x {n}{', tied' if tied else ''}] ({', '.join(users)})"
        for dtype in (torch.float32, torch.bfloat16):
            a, w, text = _row_case(k, n, tied, dtype, gen, what)
            line = f"rowwise_matmul {what} {str(dtype)[6:]}: rows bit-equal " \
                   f"across M {ROW_M}; {text}"
            if dtype == torch.bfloat16:
                host = _host_us(lambda: rkernel.rowwise_matmul(a[:8], w))
                times = [_row_plan(k, n), f"wrapper {host:.2f} us a call "
                         f"on the host (M 8)"]
                for m in ROW_TIMED:
                    ms = _timed(lambda: rkernel.rowwise_matmul(a[:m], w))
                    lib = _timed(lambda: torch.matmul(a[:m], w))
                    bound, by = _row_bound(m, k, n)
                    times.append(f"M {m}: {ms:.5f} ms (torch.matmul "
                                 f"{lib:.5f}, bound {bound:.5f}, {by})")
                    if m == 8 and any(u.endswith(" head") for u in users):
                        plain = _timed(
                            lambda: rref.rowwise_matmul_ref(a[:m], w),
                            iters=5)
                        want = rref.rowwise_matmul_ref(a[:m], w).float()
                        err = (rkernel.rowwise_matmul(a[:m], w).float()
                               - want).abs()
                        check(bool((err <= BF16_ULPS[0] * want.abs()
                                    + BF16_ULPS[1]).all()),
                              f"rowwise_matmul {what}: max |err| vs the "
                              f"plain version {float(err.max()):.4g}")
                        for u in users:
                            rows[u.split()[0]] = dict(
                                ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=by, library_ms=lib,
                                max_abs_err=float(err.max()),
                                shape=f"[8, {k}] x [{k}, {n}]"
                                      f"{' tied' if tied else ''}")
                line += "; " + "; ".join(times) + f" -- {card}"
            log(line)
            del a, w
    norms = {}
    for arch in ROW_ARCHS:
        d = registry.get_config(arch).d_model
        for dtype in (torch.float32, torch.bfloat16):
            x, y, g, err, torch_rows = _norm_case(d, dtype, gen, arch)
            vec, cpt, threads = nkernel.layout(d, dtype)
            line = (f"rowwise_rmsnorm {arch} d {d} {str(dtype)[6:]} (layout "
                    f"{vec} elements a chunk, {cpt} chunks a thread, "
                    f"{threads} threads): s = torch's x + y; rows of s and "
                    f"h bit-equal across M {ROW_M}, with y and without; max "
                    f"|err| vs the plain version {err:.4g}; torch's "
                    f"reduction keeps rows across M: {torch_rows}")
            if dtype == torch.bfloat16:
                w1 = 1 + g       # the library's weight, made once
                times = []
                for m in (8, 256):
                    xm, ym = x[:m], y[:m]
                    ms = _timed(lambda: nkernel.add_rmsnorm(xm, ym, g, 1e-6))
                    two = _timed(lambda: nkernel.rmsnorm(xm + ym, g, 1e-6))
                    pair = _timed(lambda: F.rms_norm(xm + ym, (d,), w1,
                                                     1e-6))
                    bound = _norm_bound(m, d)
                    times.append(f"M {m}: {ms:.5f} ms (x + y then the "
                                 f"launch without y {two:.5f}, x + y then "
                                 f"F.rms_norm {pair:.5f}, bound {bound:.5f}"
                                 f", bytes)")
                    if m == 8:
                        plain = _timed(lambda: nref.add_rmsnorm_ref(
                            xm, ym, g, 1e-6))
                        norms[arch] = dict(
                            ms=ms, plain_ms=plain, bound_ms=bound,
                            bound_by="bytes", library_ms=None,
                            library_pair_ms=pair, two_launch_ms=two,
                            shape=f"[8, {d}] + [8, {d}]", max_abs_err=err)
                line += "; " + "; ".join(times) + f" -- {card}"
            log(line)
            del x, y
    torch.cuda.empty_cache()
    log(f"phase 25: {time.perf_counter() - t0:.1f} s -- {smi_line()}")
    return {"matmul": rows, "rmsnorm": norms}


def _fill_pool(pool, gen) -> None:
    """Every slot of the pool holds random K/V (a prefix the layer check's
    rows attend over, the same for every variant)."""
    for t in (pool.k_pool, pool.v_pool):
        t.copy_(torch.randn(t.shape, generator=gen, device=t.device))


def _row_variants(dec, starts, toks, tables):
    """Sequence 3's first verify row through the whole decoder (every
    layer's norms, products and attention, and the head) three ways: a
    decode step of it alone, a decode step of all 8 sequences, and an 8 x
    ``VERIFY_T`` verify chunk; also every sequence's row of the batch-8
    decode and of the chunk. Returns the logits and the K/V the row wrote
    (every layer) after each."""
    ps = dec.view.page_size
    pool = dec.view.pool
    b = len(starts)
    out = {}

    def kv_at(i):
        pos = int(starts[i])
        pid = int(tables[i, pos // ps])
        return (pool.k_pool[:, pid, pos % ps].clone(),
                pool.v_pool[:, pid, pos % ps].clone())

    def decode(idx):
        t = torch.as_tensor(tables[idx], device=dec.device)
        st = torch.as_tensor(starts[idx], device=dec.device)
        tk = torch.as_tensor(toks[idx, :1], device=dec.device)
        return dec.decode_step(tk, t, st.to(torch.int32), st)
    out["alone"] = (decode([3])[0], kv_at(3))
    batch = decode(list(range(b)))
    out["batch"] = (batch[3], kv_at(3))
    chunks = [(toks[i].tolist(), tables[i].tolist(), int(starts[i]))
              for i in range(b)]
    chunk = dec.forward_chunks(chunks, want_logits=True)
    out["chunk"] = (chunk[3, 0], kv_at(3))
    out["rows"] = torch.equal(batch, chunk[:, 0])
    return out


def phase_layer_rows(device, cfg, params) -> None:
    """Phase 26: one row through the full-width decoder (phase 4's
    weights) alone, inside a batch-8 decode step and inside an 8 x 25
    verify chunk must give the same logits and write the same K/V, bit
    for bit; every row of the batch-8 step must equal row 0 of its chunk.
    Then the same rows with the products as ``a @ w`` (a library GEMM) and
    with the norms as torch's add and reduction, logged: what F7 was."""
    from repro_torch.models import layers as L
    from repro_torch.placement.pool import BwapPagePool
    from repro_torch.serve.engine import PagedDecoder
    t0 = time.perf_counter()
    pool = BwapPagePool(cfg, _domains(), page_size=PS, device=device)
    dec = PagedDecoder(cfg, params, pool)
    gen = torch.Generator(device=device).manual_seed(26)
    rng = np.random.default_rng(26)
    b = 8
    starts = rng.integers(100, 700, b)
    mp = -(-(int(starts.max()) + VERIFY_T) // PS)
    tables = np.arange(b * mp, dtype=np.int32).reshape(b, mp)
    toks = rng.integers(1, cfg.vocab_size, (b, VERIFY_T))
    _fill_pool(pool, gen)
    got = _row_variants(dec, starts, toks, tables)
    for name in ("batch", "chunk"):
        check(torch.equal(got[name][0], got["alone"][0]),
              f"phase 26: sequence 3's logits {name} differ from alone")
        check(all(torch.equal(x, y) for x, y in zip(got[name][1],
                                                      got["alone"][1])),
              f"phase 26: sequence 3's K/V written {name} differ from "
              f"alone")
    check(got["rows"], "phase 26: a batch-8 decode row differs from row 0 "
          "of its verify chunk")
    seen = {}
    def torch_norm(p, x, delta):
        s = x if delta is None else x + delta
        return s, L.apply_norm(cfg, p, s)
    for what, mm, norm in (
            ("the products as a library GEMM (a @ w)", lambda a, w: a @ w,
             None),
            ("the norms as torch's add and reduction", None, torch_norm)):
        if mm is not None:
            dec._mm = mm
        if norm is not None:
            dec._add_norm = norm
        _fill_pool(pool, gen.manual_seed(26))
        r = _row_variants(dec, starts, toks, tables)
        seen[what] = (torch.equal(r["batch"][0], r["alone"][0]),
                      torch.equal(r["chunk"][0], r["alone"][0]),
                      r["rows"])
        dec.__dict__.pop("_mm", None)
        dec.__dict__.pop("_add_norm", None)
    log(f"phase 26 ({cfg.name}, {cfg.num_layers} layers, {cfg.compute_dtype}"
        f", positions {starts.tolist()}): a row alone, in a batch-8 decode "
        f"step and in an 8 x {VERIFY_T} verify chunk gives equal logits and "
        f"K/V bit for bit, every batch row equal to its chunk's row 0. "
        + "; ".join(f"with {w}: batch = alone {a}, chunk = alone {c}, "
                    f"batch rows = chunk rows {rr}"
                    for w, (a, c, rr) in seen.items())
        + f" -- {time.perf_counter() - t0:.1f} s, {smi_line()}")


# -- main --------------------------------------------------------------------

def main() -> int:
    """Every phase, or with ``--rowwise`` phases 1, 25 and 26 alone (the
    build, the row-invariant kernels at every served shape, and a row
    through the whole decoder; qwen2-0.5b's weights from phase 4's seed);
    ``--rowwise`` prints no kernels line."""
    global torch, kernel, ops, fkernel, fops, rkernel, rref, nkernel, nref
    argv = sys.argv[1:]
    if argv not in ([], ["--rowwise"]):
        log(f"chip_smoke: unknown arguments {argv}; takes none, or "
            "--rowwise")
        return 2
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
    from repro_torch.kernels.rowwise_matmul import kernel as _rk
    from repro_torch.kernels.rowwise_matmul import ref as _rr
    from repro_torch.kernels.rowwise_rmsnorm import kernel as _nk
    from repro_torch.kernels.rowwise_rmsnorm import ref as _nr
    kernel, ops, fkernel, fops = _k, _o, _fk, _fo
    rkernel, rref, nkernel, nref = _rk, _rr, _nk, _nr
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t0 = time.perf_counter()

    def done(phases: str) -> None:
        log(f"[{time.perf_counter() - t0:.1f} s] phase {phases} done")
    phase_build()
    done("1")
    if argv == ["--rowwise"]:
        from repro_torch.configs import registry
        from repro_torch.models.lm import LM
        phase_rowwise()
        done("25")
        cfg = registry.get_config("qwen2-0.5b")
        params = LM(cfg).init(torch.Generator(device=device).manual_seed(0),
                              device=device)
        phase_layer_rows(device, cfg, params)
        done("26")
        log(smi_line())
        return 0
    errs = phase_correctness()
    ferrs = phase_flash_correctness()
    done("2")
    times = phase_timing()
    done("3")
    t_new = time.perf_counter()
    rowwise = phase_rowwise()
    added = time.perf_counter() - t_new      # phases 24-26's seconds
    done("25")
    from repro_torch.configs import registry
    s = phase_serve(device, registry.get_config("qwen2-0.5b"))
    t_new = time.perf_counter()
    phase_layer_rows(device, s["cfg"], s["params"])
    added += time.perf_counter() - t_new
    done("4, 26")
    spec = phase_spec(device, s["cfg"], s["params"])
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
    contract = phase_contract(device, s["cfg"], s["params"])
    done("23")
    obs = phase_obs(device, s["cfg"], s["params"])
    done("27")
    del s["params"], g["params"]           # phase 16 needs the room
    fam = phase_families(device)
    done("16")
    fam.update(phase_families_17(device))
    done("17")
    flash_launches["qwen2-0.5b"] += phase_train(device)
    done("18")
    phase_dryrun(device)
    done("19")
    flash_launches["qwen2-0.5b"] += phase_sharded(device)
    done("20")
    flash_launches["qwen2-0.5b"] += phase_infer_sharded(device)
    done("21")
    for tag, n in phase_families_sharded(device).items():
        if n:                              # a model with a flash row
            fam[tag]["flash"] += n
    done("22")
    t_new = time.perf_counter()
    cli_s = phase_entry_points(device)
    added += time.perf_counter() - t_new
    done("24")
    served = {"qwen2-0.5b": s["greedy"]["launches"],
              "gemma-2b": g["greedy"]["launches"],
              "qwen2-vl-7b": fam["qwen2-vl-7b"]["served"]}
    paged_src = "src/repro_torch/csrc/paged_attention.cu"
    paged_tpu = "src/repro/kernels/paged_attention/kernel.py"
    # (name, timed row, source, TPU kernel's pallas_call); a row per entry
    # point and heads (and decode at context 4096), its launches from that
    # model's run (serving for the paged kernel, the phase-7 forwards for
    # flash, plus phases 18's and 20's eval steps and 21's sharded prefill
    # at qwen2-0.5b; phase 16 for granite, phases 16 and 22's sharded
    # prefill for qwen2-vl-7b, phases 17 and 22 for hymba and whisper), its
    # error
    # from the bf16 cases at that head dim
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
    # the rows at the heads of phases 16 and 17 carry the error of their
    # own timed inputs against the plain version; the others phase 2's at
    # that dtype and head dim
    for tag, heads, entries in (
            ("qwen2-0.5b", MAIN, table), ("gemma-2b", GEMMA, table),
            ("qwen2-vl-7b", QWEN_VL, table),
            ("granite-moe-3b-a800m", GRANITE, table[-1:]),
            ("hymba-1.5b", HYMBA, table[-1:]),
            ("whisper-tiny", WHISPER, table[-1:])):
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
                rows[-1]["contract_launches"] = contract["launches"][name]
                rows[-1]["obs_launches"] = obs["launches"][name]
    # the row-invariant kernels replace no pallas_call: "replaces" names
    # the reference decoder's XLA code they stand for (its products, and
    # its residual adds with the norms that read them, fused by XLA;
    # src/repro/serve/engine.py); each row's time is one shape of phase 25
    # at decode (the head's product, the final norm with its add), its
    # launches a model's phase-4 serving run (phase 9 for gemma-2b, 16 for
    # qwen2-vl-7b), and on qwen2-0.5b phase 5's and 10's runs too; the
    # norm's row also counts its fused launches (``add_launches``)
    ref_engine = "src/repro/serve/engine.py"
    for tag in ROW_ARCHS:
        for name, key, src, replaces in (
                ("rowwise_matmul", "matmul",
                 "src/repro_torch/csrc/rowwise_matmul.cu",
                 f"none (XLA's dot: {ref_engine}:112-141, 158-185)"),
                ("rowwise_rmsnorm", "rmsnorm",
                 "src/repro_torch/csrc/rowwise_rmsnorm.cu",
                 f"none (XLA-fused x + ... and apply_norm: {ref_engine}"
                 f":111, 131-135, 139, 159, 178-182)")):
            launches = served[tag][name]
            check(launches > 0, f"{name} never launched on the {tag} path")
            row = dict(rowwise[key][tag])
            err = row.pop("max_abs_err")
            rows.append(dict(
                name=name, route="cuda", source=src, replaces=replaces,
                launches=launches, max_abs_err=err, **row,
                instance=(rkernel.instance(torch.bfloat16)
                          if key == "matmul" else name), heads=tag))
            if key == "rmsnorm":
                rows[-1]["add_launches"] = served[tag]["rowwise_add_rmsnorm"]
            if tag == "qwen2-0.5b":
                rows[-1]["spec_launches"] = spec["launches"][name]
                rows[-1]["coda_launches"] = coda["launches"][name]
                rows[-1]["obs_launches"] = obs["launches"][name]
    log(f"total {time.perf_counter() - t0:.1f} s, of it phases 24-26 "
        f"{added:.1f} s, phase 27 and phase 24's CLIs "
        f"{obs['seconds'] + cli_s:.1f} s ({obs['seconds']:.1f} + "
        f"{cli_s:.1f}) -- {smi_line()}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
