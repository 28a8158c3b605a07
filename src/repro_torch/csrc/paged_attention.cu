// Paged attention over a BWAP-placed KV page pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels on the serving main path:
//   src/repro/kernels/paged_attention/kernel.py::paged_prefill_attention_batch
//     (body _paged_prefill_batch_kernel, pl.pallas_call at :233)
//   src/repro/kernels/paged_attention/kernel.py::paged_attention
//     (body _paged_kernel, pl.pallas_call at :317)
// and serves the single-sequence paged_prefill_attention (:276) as B = 1.
//
// One page walk, in batched prefill mode. Query (b, t) sits at
// absolute position q_start[b] + t and sees every key at a position <= its
// own through row b of the page table. Decode is the T = 1 instance with
// q_start = lens - 1 (qoff = -1): `kpos <= lens - 1` is the decode mask
// `kpos < lens`, so decode equals verify row 0 bit for bit by construction.
//
// Layout. q/out [B, T, nq, h]; pools [P, ps, nkv, h] (one layer); table
// [B, mp] int32 padded with page 0; qstart [B] int32. The g = nq / nkv query
// heads of one KV head form rows laid out [nkv, T*g] (row r = t*g + head),
// exactly the Pallas kernel's accumulator rows.
//
// Two instances, chosen by element type and head dim only (never by T, B,
// mp or the data, so a row's bits never depend on them):
//
// 1. bf16 at H = 64, 128, 256: the tensor-core instance (paged_wgmma_kernel).
//    A block of three warpgroups owns 128 rows of one KV head and walks
//    WK-key tiles at absolute key positions (tile i holds keys WK*i ..
//    WK*i + WK - 1, pages i*WK/ps ..), up to the one that holds its last
//    row's position. WK is the instance's tile width (WgLayout<H>::WK): 64
//    keys at H = 64, 128 and 48 at H = 256, where O alone takes 128
//    registers a consumer thread.
//    - Warpgroup 0 is the producer: its 128 threads gather each tile's K
//      and V rows through the row's page table with cp.async, 16 bytes a
//      copy, into a ring of 6 (H = 64), 4 (H = 128) or 3 (H = 256) stages
//      laid out as TMA's 128-byte swizzle would lay them, so the wgmma
//      descriptors of the flash kernel read them as they are. A key past
//      the table (page index >= mp) reads as zeros. Each thread's copies
//      signal the stage's mbarrier when they land
//      (cp.async.mbarrier.arrive.noinc); the Q rows of the block are
//      gathered the same way once (zeros past T*g). TMA would need a page
//      size that is a multiple of 8 rows for its swizzle; cp.async takes
//      any page size.
//    - Warpgroups 1 and 2 consume 64 rows each, with the flash kernel's
//      pipelined walk (wgmma_attention.cuh): S = Q K^T and O += P V on
//      wgmma, the online softmax in fp32 in the accumulator layout, P as
//      the hi/lo bf16 pair (a single bf16 P breaks the gate of two bf16
//      ulps of the plain version). A key is visible to a row when its
//      position is <= the row's and inside the table.
//    Key chunks. CH consecutive tiles at absolute positions form a chunk
//    (chunk j holds tiles j*CH .. j*CH + CH - 1; CH = WgLayout<H>::CH, a
//    constant of the instance). Each chunk's walk starts fresh (m = NEG_INF,
//    l = 0, O = 0), and a row's result is the fold of its chunks' (m, l, O)
//    in ascending j, from (M, L, Acc) = (NEG_INF, 0, 0):
//      M' = max(M, m); a = 2^(M - M'); b = 2^(m - M');
//      L' = fma(L, a, l b); Acc' = fma(Acc, a, O b); out = Acc / L
//    (fold_factors, fold_elem: written-out intrinsics, so no place that
//    runs the fold contracts it otherwise). A chunk that no key of a row
//    reaches is an exact no-op of the fold (a = 1, b = 0), and folding
//    chunk 0 into the start state gives chunk 0, so a row whose keys all
//    lie in chunk 0 gets the bits of the walk without chunks.
//    Two routes schedule the same chunks and fold (the wrapper picks by
//    the launch's shape; kSplit is a template argument):
//    - split: grid (B, nkv, row blocks * chunks); a block walks one chunk
//      and writes its real rows' (m, l, O) in fp32 to a workspace; the
//      block that draws the row block's last ticket (an int per row block,
//      after __threadfence; it sets the ticket back to 0) folds the
//      chunks in ascending order, four elements of a row a thread. Decode
//      (T = 1: g of a block's 128 rows real, 7 at qwen2-0.5b, 8 at
//      gemma-2b) launches B * nkv * chunks blocks this way instead of
//      B * nkv walks one after another.
//    - serial: grid (B, nkv, row blocks); a block walks all its chunks in
//      one pipelined pass and folds each as its last tile's P V lands
//      (consume_pipelined's chunk_end), the second accumulator in a
//      workspace of the block's own (H / 2 floats a consumer thread,
//      through the L2), the fold state in shared memory. Launches with
//      enough row blocks to fill the card (prefill chunks) take it: their
//      partials would cost HBM traffic on the split route.
//    A launch of at most 64 rows (T * g <= 64: decode, verify) has all its
//    real rows in consumer warpgroup 0, which then walks alone (kSolo: no
//    turns to take, the empty barriers count 4 warps); warpgroup 1 skips
//    the walk and only helps the split route's merge. Its rows' arithmetic
//    is the same, so their bits are too.
// 2. fp32 at every head dim and bf16 at H = 16, 32: the CUDA-core instance
//    (paged_walk_kernel), the port's first design. Grid (B, nkv,
//    ceil(T*g / ROWS)); a block of WARPS warps owns ROWS rows of one KV
//    head and walks the row's pages in table order. Each page's K and V
//    slice for the KV head is loaded into shared memory as fp32 and shared
//    by all ROWS rows. A warp handles ROWS_PER_WARP rows; per row it keeps
//    (m, l, acc[h]) in fp32 registers, lane j scores slots j and j + 32,
//    and lane i owns acc[i], acc[i + 32], ... fp32 stays here for its 2e-5
//    gate (TF32 tensor cores keep about three decimal digits).
//
// Bit-invariance. A row's arithmetic does not depend on T, B, mp, the route
// or the tile it lands in. In the tensor-core instance, tiles and chunks
// sit at absolute key positions, the softmax is written out so that masked
// and unmasked paths round alike (see wgmma_attention.cuh), and both routes
// fold the same chunk partials in the same order. In the CUDA-core instance,
// the dot product over h runs in fixed order d = 0..h-1 (one fmaf chain per
// slot), the row max and the sum of p are the same xor butterfly for every
// row, and the p.v sum runs over slots in order; pages are never split. A
// block stops at the first page (tile) whose absolute start lies past the
// last position of its rows; such a page is fully masked for every row and
// an exact no-op (alpha = 1, every p, hi and lo = 0), so stopping there, or
// walking trailing table padding, changes no bits. NEG_INF is the finite
// -2e38 of the plain version (exp(-inf - -inf) would be NaN). A row whose
// walk saw no key (l = 0) gives 0.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s dense bf16). Decode is
// memory-bound: it must read the K and V bytes of the pages each row
// actually covers, ~1 us at B = 8, 800 tokens, qwen2-0.5b heads, per layer;
// a walk of one block per (sequence, KV head) reads them at a fraction of
// the card's rate (a latency chain per tile on 8-16 of 132 SMs), hence the
// split route.
// Prefill at T = 256 does 4*T*g*context*h flops per (b, kvh); at the bf16
// peak that takes about as long as its bytes (~3 us), which only the tensor
// cores can approach.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// The CUDA-core instance: fp32 at every head dim, bf16 at H = 16, 32.
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;   // query rows per block
constexpr int MAX_PS = 64;                    // two slots per lane

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// xor butterfly: partners add (a + b) and (b + a), which are equal, so
// every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename Elem, int H>
__global__ void __launch_bounds__(WARPS * 32)
paged_walk_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k_pool,
                  const Elem* __restrict__ v_pool,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ qstart, Elem* __restrict__ out,
                  int t_len, int nq, int nkv, int ps, int mp, int qoff,
                  float scale) {
  constexpr int NV = (H + 31) / 32;   // acc elements per lane
  constexpr int KS = H + 1;           // padded K row: conflict-free columns
  extern __shared__ float smem[];
  float* ks = smem;                   // [ps][H + 1]
  float* vs = ks + ps * KS;           // [ps][H]
  float* qs = vs + ps * H;            // [ROWS][H]

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = nq / nkv;
  const int n_rows = t_len * g;
  const int r0 = blockIdx.z * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_start = qstart[b] + qoff;

  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) {
    const int r = r0 + i / H, d = i % H;
    float x = 0.f;
    if (r < n_rows) {
      const int t = r / g, head = kvh * g + r % g;
      x = to_f32(q[(((size_t)b * t_len + t) * nq + head) * H + d]);
    }
    qs[i] = x;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][NV];
#pragma unroll
  for (int w = 0; w < ROWS_PER_WARP; ++w) {
    m[w] = NEG_INF;
    l[w] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[w][i] = 0.f;
  }

  // the last query position among this block's rows
  const int r_last = min(r0 + ROWS, n_rows) - 1;
  const int q_last = q_start + r_last / g;
  const size_t slot_stride = (size_t)nkv * H;

  for (int pi = 0; pi < mp; ++pi) {
    const int page_start = pi * ps;
    if (page_start > q_last) break;   // fully masked for every row: no-op
    const size_t base =
        ((size_t)table[(size_t)b * mp + pi] * ps * nkv + kvh) * H;
    __syncthreads();                  // previous page fully consumed
    for (int i = threadIdx.x; i < ps * H; i += blockDim.x) {
      const int j = i / H, d = i % H;
      const size_t off = base + j * slot_stride + d;
      ks[j * KS + d] = to_f32(k_pool[off]);
      vs[j * H + d] = to_f32(v_pool[off]);
    }
    __syncthreads();

#pragma unroll
    for (int w = 0; w < ROWS_PER_WARP; ++w) {
      const int rr = warp + w * WARPS;
      const int r = r0 + rr;
      if (r >= n_rows) continue;      // uniform across the warp
      const int qpos = q_start + r / g;
      const float* qrow = qs + rr * H;
      const bool has0 = lane < ps, has1 = lane + 32 < ps;
      float s0 = NEG_INF, s1 = NEG_INF;
      if (has0) {
        const float* krow = ks + lane * KS;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < H; ++d) dot = fmaf(qrow[d], krow[d], dot);
        if (page_start + lane <= qpos) s0 = dot * scale;
      }
      if (has1) {
        const float* krow = ks + (lane + 32) * KS;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < H; ++d) dot = fmaf(qrow[d], krow[d], dot);
        if (page_start + lane + 32 <= qpos) s1 = dot * scale;
      }
      const float m_new = fmaxf(m[w], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m[w] - m_new);
      const float p0 = has0 ? expf(s0 - m_new) : 0.f;
      const float p1 = has1 ? expf(s1 - m_new) : 0.f;
      l[w] = l[w] * alpha + warp_sum(p0 + p1);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[w][i] *= alpha;
      for (int j = 0; j < ps; ++j) {
        const float pj = __shfl_sync(FULL, j < 32 ? p0 : p1, j & 31);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int d = lane + 32 * i;
          if (d < H) acc[w][i] = fmaf(pj, vs[j * H + d], acc[w][i]);
        }
      }
      m[w] = m_new;
    }
  }

#pragma unroll
  for (int w = 0; w < ROWS_PER_WARP; ++w) {
    const int r = r0 + warp + w * WARPS;
    if (r >= n_rows) continue;
    const int t = r / g, head = kvh * g + r % g;
    Elem* orow = out + (((size_t)b * t_len + t) * nq + head) * H;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < H) store(orow + d, l[w] == 0.f ? 0.f : acc[w][i] / l[w]);
    }
  }
}

// dynamic shared memory of a CUDA-core launch: K, V pages and Q rows, fp32
constexpr size_t walk_smem_bytes(int h, int ps) {
  return sizeof(float) * ((size_t)ps * (h + 1) + (size_t)ps * h + ROWS * h);
}

template <typename Elem, int H>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* qstart, void* out, int b, int t,
           int nq, int nkv, int ps, int mp, int qoff, float scale,
           cudaStream_t stream) {
  const size_t smem = walk_smem_bytes(H, ps);
  auto kern = paged_walk_kernel<Elem, H>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (t * (nq / nkv) + ROWS - 1) / ROWS;
  dim3 grid(b, nkv, tiles);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k_pool),
      static_cast<const Elem*>(v_pool), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(qstart), static_cast<Elem*>(out), t, nq,
      nkv, ps, mp, qoff, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16 at H = 64, 128, 256 (see the top of file).
// ---------------------------------------------------------------------------

constexpr int PRODUCER_THREADS = 128;
// setmaxnreg budgets: 128 * 40 + 256 * 232 = 64512 registers, the launch's
// 384 * 168 (128 * 64 + 256 * 216 at H = 256, where the producer's 12 rows
// a tile of 32 units each spilled at 40 and ran slower, and the consumers
// need fewer than 216).
template <int H>
constexpr int PRODUCER_REGS = H == 256 ? 64 : 40;
template <int H>
constexpr int CONSUMER_REGS = H == 256 ? 216 : 232;

// 16 bytes from global to shared memory, asynchronously; with bytes = 0 it
// reads nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// one arrival on `bar` once every cp.async this thread has issued so far has
// landed (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   bar)
               : "memory");
}

// shared-memory address of 16-byte unit u (of H / 8) of row `row` in a
// [ROWS][H] bf16 tile stored as H / 64 chunks of [ROWS][64]: the 128-byte
// swizzle of TMA's SWIZZLE_128B (unit u % 8 of a row at u % 8 ^ row % 8),
// which the wgmma descriptors read
template <int ROWS>
__device__ __forceinline__ uint32_t swizzled(uint32_t base, int row, int u) {
  return base + (u / 8) * (ROWS * ROW_BYTES) + row * ROW_BYTES +
         ((u % 8) ^ (row % 8)) * 16;
}

// The online softmax of one tile of scores s (keys k0 ..): a key is
// visible to a row at or before the row's position and inside the table
// (k_end keys); masked keys (tested only where the tile can hold one for a
// row of this warpgroup, whose least position is q_first) go to -inf;
// (m, l) move to the tile; s becomes p = 2^(s c2 - m) in fp32; returns the
// factors alpha that O must take. flash_attention.cu's softmax_tile with
// this kernel's mask.
template <int WK>
__device__ __forceinline__ void softmax_tile(float (&s)[WK / 2], Rows& r,
                                             int k0, int q_first, int k_end,
                                             float c2, float& al_a,
                                             float& al_b) {
  const bool edge = k0 + WK - 1 > q_first || k0 + WK > k_end;
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int n = 0; n < WK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e];
      if (edge) {
        const int kpos = k0 + 8 * n + r.kc + (e & 1);
        const int qpos = e < 2 ? r.qa : r.qb;
        const bool ok = kpos <= qpos && kpos < k_end;
        x = ok ? x : __int_as_float(0xff800000);
      }
      s[4 * n + e] = x;
      if (e < 2)
        mx_a = fmaxf(mx_a, x);
      else
        mx_b = fmaxf(mx_b, x);
    }
  mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
  mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
  mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
  const float mn_a = fmaxf(r.m_a, __fmul_rn(mx_a, c2));
  const float mn_b = fmaxf(r.m_b, __fmul_rn(mx_b, c2));
  al_a = ex2(r.m_a - mn_a);
  al_b = ex2(r.m_b - mn_b);
  r.m_a = mn_a;
  r.m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int n = 0; n < WK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(__fmaf_rn(s[4 * n + e], c2, e < 2 ? -mn_a : -mn_b));
      s[4 * n + e] = p;
      if (e < 2)
        sum_a += p;
      else
        sum_b += p;
    }
  sum_a += __shfl_xor_sync(FULL, sum_a, 1);
  sum_a += __shfl_xor_sync(FULL, sum_a, 2);
  sum_b += __shfl_xor_sync(FULL, sum_b, 1);
  sum_b += __shfl_xor_sync(FULL, sum_b, 2);
  r.l_a = __fmaf_rn(r.l_a, al_a, sum_a);
  r.l_b = __fmaf_rn(r.l_b, al_b, sum_b);
}

// The running (M, L) of a consumer thread's rows a and b over the chunks
// folded so far, M in log2 units; starts at (NEG_INF, 0).
struct Fold {
  float m_a, m_b, l_a, l_b;
};

// Folds the (m, l) of the next chunk into f and returns its four factors:
// Acc' = Acc * x[0] + O * x[1] for row a, Acc * x[2] + O * x[3] for row b
// (fold_elem). Every product and sum is a written-out intrinsic, so no
// place that runs it contracts it otherwise. A chunk that no key of a row
// reaches (m = NEG_INF, l = 0, O = 0) is an exact no-op for it (factors 1
// and 0); folding chunk 0 into the start state gives chunk 0 itself.
__device__ __forceinline__ void fold_factors(Fold& f, float m_a, float m_b,
                                             float l_a, float l_b,
                                             float (&x)[4]) {
  const float mn_a = fmaxf(f.m_a, m_a), mn_b = fmaxf(f.m_b, m_b);
  x[0] = ex2(f.m_a - mn_a);
  x[1] = ex2(m_a - mn_a);
  x[2] = ex2(f.m_b - mn_b);
  x[3] = ex2(m_b - mn_b);
  f.l_a = __fmaf_rn(f.l_a, x[0], __fmul_rn(l_a, x[1]));
  f.l_b = __fmaf_rn(f.l_b, x[2], __fmul_rn(l_b, x[3]));
  f.m_a = mn_a;
  f.m_b = mn_b;
}

// element e (of 4) of an accumulator group: e < 2 on row a, else row b
__device__ __forceinline__ float fold_elem(float acc, float o,
                                           const float (&x)[4], int e) {
  return e < 2 ? __fmaf_rn(acc, x[0], __fmul_rn(o, x[1]))
               : __fmaf_rn(acc, x[2], __fmul_rn(o, x[3]));
}

// Folds a finished chunk (O in o, its (m, l) given) into the running
// (f, Acc). Acc is the serial route's second accumulator, in a workspace of
// the block's own (one float4 per 4-element group q = 8 j + n of O's
// layout, at acc[q * 256]; L2-resident, H / 2 floats a consumer thread,
// written and read back by the same thread): beside O and the walk's S and
// P it would not fit in registers at H = 128, 256. The chunk is chunk 0
// when `first` (Acc then reads as 0); when `last`, the result goes to o,
// else to Acc and o starts the next chunk at 0.
template <int H>
__device__ __forceinline__ void fold_chunk(Fold& f, float4* acc,
                                           float (&o)[H / CHUNK][32],
                                           float4 ml, bool first, bool last) {
  float x[4];
  fold_factors(f, ml.x, ml.y, ml.z, ml.w, x);
#pragma unroll
  for (int j = 0; j < H / CHUNK; ++j) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int q = 8 * j + n;
      const float4 a =
          first ? make_float4(0.f, 0.f, 0.f, 0.f) : __ldcg(acc + q * 256);
      const float4 v = make_float4(fold_elem(a.x, o[j][4 * n], x, 0),
                                   fold_elem(a.y, o[j][4 * n + 1], x, 1),
                                   fold_elem(a.z, o[j][4 * n + 2], x, 2),
                                   fold_elem(a.w, o[j][4 * n + 3], x, 3));
      if (last) {
        o[j][4 * n] = v.x;
        o[j][4 * n + 1] = v.y;
        o[j][4 * n + 2] = v.z;
        o[j][4 * n + 3] = v.w;
      } else {
        __stcg(acc + q * 256, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][4 * n + e] = 0.f;
      }
    }
  }
}

// A serial-route consumer thread's fold state, in shared memory so that it
// takes no registers over the walk: [0] the running (M_a, M_b, L_a, L_b),
// [1] the (m_a, m_b, l_a, l_b) of the chunk that the last tile closed.
__device__ __forceinline__ float4* fold_slots(int ctid) {
  __shared__ float4 slots[2 * 256];
  return slots + 2 * ctid;
}

// set by the consumer that draws a row block's last ticket
__device__ __forceinline__ int& merge_turn() {
  __shared__ int flag;
  return flag;
}

// One block of the tensor-core instance. kSplit: the split route (this
// block walks chunk blockIdx.z % nsplit of its row block, nsplit = the
// table's chunks); else the serial route (all chunks, nsplit = 1). kSolo:
// the launch has at most 64 rows (T * g <= 64: decode, verify), all in
// consumer warpgroup 0, which walks alone; warpgroup 1 only helps merge.
template <int H, bool kSplit, bool kSolo>
__global__ void __launch_bounds__(WG_THREADS, 1)
paged_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_pool,
                   const __nv_bfloat16* __restrict__ v_pool,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ qstart,
                   __nv_bfloat16* __restrict__ out, int t_len, int nq,
                   int nkv, int ps, int mp, int qoff, float scale,
                   int nsplit, float* ws, int* tickets) {
  using L = WgLayout<H>;
  constexpr int NC = L::NC, WK = L::WK, CH = L::CH;
  constexpr int UPR = H / 8;                        // 16-byte units a row
  constexpr int RSTEP = PRODUCER_THREADS / UPR;     // rows between copies
  extern __shared__ uint8_t pw_smem[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(pw_smem)) + 1023u) &
      ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF, q_full = bars;

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = nq / nkv;
  const int n_rows = t_len * g;
  const int rblocks = gridDim.z / nsplit;
  const int rblk = blockIdx.z / nsplit, chunk = blockIdx.z % nsplit;
  const int r0 = rblk * WQ;
  const int q_start = qstart[b] + qoff;
  // the last query position among this block's rows, and the keys the
  // table covers; tiles at absolute positions up to the one that holds
  // q_last (a tile past it is fully masked for every row: a no-op)
  const int q_last = q_start + (min(r0 + WQ, n_rows) - 1) / g;
  const int k_end = mp * ps;
  const int n_tiles =
      q_last < 0 ? 0 : min(q_last / WK + 1, (k_end + WK - 1) / WK);
  // this block's tiles: chunk `chunk` (split route), or all of them
  const int t_lo = kSplit ? chunk * CH : 0;
  const int n_walk = kSplit ? max(min(CH, n_tiles - t_lo), 0) : n_tiles;

  if (threadIdx.x == 0) {
    if constexpr (!L::TRAP) wait_abandoned() = 0;
    mbar_init(q_full, PRODUCER_THREADS);
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(L::full_k(bars, st), PRODUCER_THREADS);
      mbar_init(L::full_v(bars, st), PRODUCER_THREADS);
      mbar_init(L::empty(bars, st), kSolo ? 4 : 8);   // a walking warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's index, warp-uniform to the compiler (a shuffle from
  // lane 0), so that each role gets its own register budget
  const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: thread tid copies unit u of rows tid / UPR, + RSTEP, ...
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS<H>)
                 : "memory");
    if (n_walk == 0) return;
    const int tid = threadIdx.x, u = tid % UPR;
    for (int row = tid / UPR; row < WQ; row += RSTEP) {
      const int r = r0 + row;
      const bool ok = r < n_rows;
      const __nv_bfloat16* src = q;
      if (ok)
        src = q + (((size_t)b * t_len + r / g) * nq + kvh * g + r % g) * H +
              u * 8;
      cp_async16(swizzled<WQ>(q_s, row, u), src, ok ? 16 : 0);
    }
    cp_async_arrive(q_full);
    const int32_t* trow = table + (size_t)b * mp;
    const size_t slot_stride = (size_t)nkv * H;
    constexpr int NR = WK / RSTEP;                  // rows a tile, a thread
    // the pool rows (page * ps + slot) of keys k0 + tid / UPR + j * RSTEP,
    // through the table; -1 past it
    auto pool_rows = [&](int k0, int (&pr)[NR]) {
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int kpos = k0 + tid / UPR + j * RSTEP, pi = kpos / ps;
        pr[j] = pi < mp ? trow[pi] * ps + (kpos - pi * ps) : -1;
      }
    };
    auto gather = [&](const __nv_bfloat16* pool, uint32_t dst,
                      const int (&pr)[NR]) {
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const __nv_bfloat16* src =
            pr[j] < 0 ? pool
                      : pool + (size_t)pr[j] * slot_stride + (size_t)kvh * H +
                            u * 8;
        cp_async16(swizzled<WK>(dst, tid / UPR + j * RSTEP, u), src,
                   pr[j] < 0 ? 0 : 16);
      }
    };
    for (int i = 0; i < n_walk; ++i) {
      const int st = i % L::STAGES;
      int pr[NR];
      pool_rows((t_lo + i) * WK, pr);   // table loads in flight over the wait
      mbar_wait<L::TRAP>(L::empty(bars, st), ((i / L::STAGES) & 1) ^ 1);
      gather(k_pool, k_s + st * L::KV_BYTES, pr);
      cp_async_arrive(L::full_k(bars, st));
      gather(v_pool, v_s + st * L::KV_BYTES, pr);
      cp_async_arrive(L::full_v(bars, st));
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }
  // consumers: warpgroup cw owns rows row0 .. row0 + 63 of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS<H>)
               : "memory");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int row0 = r0 + 64 * cw;
  const int ra = row0 + 16 * warp + lane / 4, rb = ra + 8;
  const int kc = 2 * (lane % 4);
  Rows r;
  r.qa = q_start + ra / g;
  r.qb = q_start + rb / g;
  r.kc = kc;
  r.m_a = r.m_b = NEG_INF;
  r.l_a = r.l_b = 0.f;
  Fold f{NEG_INF, NEG_INF, 0.f, 0.f};
  const float c2 = __fmul_rn(scale, LOG2E);       // scores to log2 units
  const int q_first = q_start + row0 / g;         // least of this warpgroup
  float o[NC][32];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  const uint64_t dq = gmma_desc(q_s + cw * 64 * ROW_BYTES, 16, 1024);
  // Both warpgroups (warpgroup 0 alone with kSolo) compute every tile of
  // the block's range: a tile that a warpgroup's rows cannot see is fully
  // masked for them, a no-op.
  const bool walks = !kSolo || cw == 0;
  if (n_walk > 0 && walks) {
    mbar_wait<L::TRAP>(q_full, 0);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }

  if constexpr (kSplit) {
    // the online softmax of tile i of the walk (absolute tile t_lo + i)
    auto softmax = [&](float (&s)[WK / 2], int i, float& al_a,
                       float& al_b) {
      softmax_tile<WK>(s, r, (t_lo + i) * WK, q_first, k_end, c2, al_a,
                       al_b);
    };
    if (n_walk > 0 && walks)
      consume_pipelined<H, true, kSolo>(o, dq, k_s, v_s, bars, n_walk, cw,
                                        lane, softmax);
    // the chunk's (m, l, O) of each real row to the workspace,
    // [b][kvh][chunk][row] (O: H floats; after all O, (m, l)); the block
    // that draws the row block's last ticket folds the chunks in order
    const size_t o_all = (size_t)gridDim.x * nkv * nsplit * n_rows * H;
    const size_t chunk0 = ((size_t)b * nkv + kvh) * nsplit;
    const size_t tk = ((size_t)b * nkv + kvh) * rblocks + rblk;
    if (n_walk > 0) {
      const size_t at = (chunk0 + chunk) * n_rows;
      const float ml[2][2] = {{r.m_a, r.l_a}, {r.m_b, r.l_b}};
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int row = hb ? rb : ra;
        if (row >= n_rows) continue;
        float* po = ws + (at + row) * H + kc;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            __stcg(reinterpret_cast<float2*>(po + j * CHUNK + 8 * n),
                   make_float2(o[j][4 * n + 2 * hb],
                               o[j][4 * n + 2 * hb + 1]));
        if (lane % 4 == 0)
          __stcg(reinterpret_cast<float2*>(ws + o_all + 2 * (at + row)),
                 make_float2(ml[hb][0], ml[hb][1]));
      }
      __threadfence();
    }
    named_sync(3);
    if (threadIdx.x == 128)
      merge_turn() = atomicAdd(tickets + tk, 1) == nsplit - 1;
    named_sync(3);
    if (!merge_turn()) return;
    __threadfence();
    if (threadIdx.x == 128) tickets[tk] = 0;   // for the next launch
    // The ordered fold, 4 elements of a row a thread at a time over the
    // block's real rows x H (coalesced): per element the same operations
    // in the same order as the serial route's.
    const int ctid = threadIdx.x - 128;
    const int n_chunks = (n_tiles + CH - 1) / CH;
    const int real = min(WQ, n_rows - r0) * H;
    for (int e = 4 * ctid; e < real; e += 4 * 256) {
      const int row = r0 + e / H, col = e % H;
      float mm = NEG_INF, ll = 0.f;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int c = 0; c < n_chunks; ++c) {
        const size_t at = (chunk0 + c) * n_rows + row;
        const float2 ml =
            __ldcg(reinterpret_cast<const float2*>(ws + o_all + 2 * at));
        const float4 ov =
            __ldcg(reinterpret_cast<const float4*>(ws + at * H + col));
        const float mn = fmaxf(mm, ml.x);
        const float fa = ex2(mm - mn), fb = ex2(ml.x - mn);
        ll = __fmaf_rn(ll, fa, __fmul_rn(ml.y, fb));
        mm = mn;
        acc.x = __fmaf_rn(acc.x, fa, __fmul_rn(ov.x, fb));
        acc.y = __fmaf_rn(acc.y, fa, __fmul_rn(ov.y, fb));
        acc.z = __fmaf_rn(acc.z, fa, __fmul_rn(ov.z, fb));
        acc.w = __fmaf_rn(acc.w, fa, __fmul_rn(ov.w, fb));
      }
      __nv_bfloat16* po = out +
          (((size_t)b * t_len + row / g) * nq + kvh * g + row % g) * H + col;
      reinterpret_cast<__nv_bfloat162*>(po)[0] = __floats2bfloat162_rn(
          ll == 0.f ? 0.f : acc.x / ll, ll == 0.f ? 0.f : acc.y / ll);
      reinterpret_cast<__nv_bfloat162*>(po)[1] = __floats2bfloat162_rn(
          ll == 0.f ? 0.f : acc.z / ll, ll == 0.f ? 0.f : acc.w / ll);
    }
    return;
  } else if (n_tiles > 0 && walks) {
    // serial route: fold each chunk into (M, L, Acc) as its last tile's
    // P V lands; the last fold leaves the result in o and (M, L) in f
    const int ctid = threadIdx.x - 128;
    auto softmax = [&](float (&s)[WK / 2], int i, float& al_a,
                       float& al_b) {
      if (i > 0 && i % CH == 0) {   // a new chunk: keep the closed one's
        fold_slots(ctid)[1] = make_float4(r.m_a, r.m_b, r.l_a, r.l_b);
        r.m_a = r.m_b = NEG_INF;
        r.l_a = r.l_b = 0.f;
      }
      softmax_tile<WK>(s, r, i * WK, q_first, k_end, c2, al_a, al_b);
    };
    auto chunk_end = [&](float (&oo)[NC][32], int i) {
      const bool last = i == n_tiles - 1;
      if (!last && (i + 1) % CH != 0) return;
      const bool first = i < CH;
      float4* slot = fold_slots(ctid);
      Fold fs{NEG_INF, NEG_INF, 0.f, 0.f};
      if (!first) {
        const float4 v = slot[0];
        fs = Fold{v.x, v.y, v.z, v.w};
      }
      float4* acc = reinterpret_cast<float4*>(ws) +
                    (((size_t)b * nkv + kvh) * rblocks + rblk) * (H / 8) *
                        256 +
                    ctid;
      fold_chunk<H>(fs, acc, oo,
                    last ? make_float4(r.m_a, r.m_b, r.l_a, r.l_b) : slot[1],
                    first, last);
      slot[0] = make_float4(fs.m_a, fs.m_b, fs.l_a, fs.l_b);
    };
    consume_pipelined<H, true, kSolo>(o, dq, k_s, v_s, bars, n_tiles, cw,
                                      lane, softmax, chunk_end);
    const float4 v = fold_slots(ctid)[0];
    f = Fold{v.x, v.y, v.z, v.w};
  }

  // out = Acc / L at rows ra and rb, 0 where a row saw no key
  const float l_a = f.l_a, l_b = f.l_b;
  const auto row_out = [&](int row) {
    return out + (((size_t)b * t_len + row / g) * nq + kvh * g + row % g) * H;
  };
  __nv_bfloat16* oa = row_out(ra);
  __nv_bfloat16* ob = row_out(rb);
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = j * CHUNK + 8 * n + kc;
      if (ra < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(oa + col) = __floats2bfloat162_rn(
            l_a == 0.f ? 0.f : o[j][4 * n] / l_a,
            l_a == 0.f ? 0.f : o[j][4 * n + 1] / l_a);
      if (rb < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(
            l_b == 0.f ? 0.f : o[j][4 * n + 2] / l_b,
            l_b == 0.f ? 0.f : o[j][4 * n + 3] / l_b);
    }
}

// Chunks of CH tiles the table's keys span: the split route's CTAs per row
// block, and the most chunks any row block of the launch walks.
template <int H>
int n_chunks_max(int ps, int mp) {
  using L = WgLayout<H>;
  const long long tiles = ((long long)mp * ps + L::WK - 1) / L::WK;
  return (int)((tiles + L::CH - 1) / L::CH);
}

// Workspace bytes a launch of the H instance needs on its route.
template <int H>
long long ws_bytes(int b, int t, int nq, int nkv, int ps, int mp, bool split) {
  const long long rows = (long long)t * (nq / nkv);
  if (split) return 4ll * b * nkv * n_chunks_max<H>(ps, mp) * rows * (H + 2);
  return 4ll * b * nkv * ((rows + WQ - 1) / WQ) * 256 * (H / 2);
}

template <int H>
int launch_wgmma(const void* q, const void* k_pool, const void* v_pool,
                 const void* table, const void* qstart, void* out, int b,
                 int t, int nq, int nkv, int ps, int mp, int qoff,
                 float scale, int split, void* ws, long long ws_size,
                 void* tickets, long long n_tickets, cudaStream_t stream) {
  // cp.async copies 16-byte units: every row starts on one
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pool) |
       reinterpret_cast<uintptr_t>(v_pool) |
       reinterpret_cast<uintptr_t>(ws)) % 16)
    return -1;
  const int rblocks = (t * (nq / nkv) + WQ - 1) / WQ;
  const int nsplit = split && n_chunks_max<H>(ps, mp) > 1
                         ? n_chunks_max<H>(ps, mp) : 1;
  if (ws_size < ws_bytes<H>(b, t, nq, nkv, ps, mp, nsplit > 1) ||
      (nsplit > 1 && n_tickets < (long long)b * nkv * rblocks) ||
      (long long)rblocks * nsplit > 65535)
    return -1;
  constexpr int smem = WgLayout<H>::BYTES;
  const bool solo = t * (nq / nkv) <= 64;
  auto kern = nsplit > 1 ? (solo ? paged_wgmma_kernel<H, true, true>
                                 : paged_wgmma_kernel<H, true, false>)
                         : (solo ? paged_wgmma_kernel<H, false, true>
                                 : paged_wgmma_kernel<H, false, false>);
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(b, nkv, rblocks * nsplit);
  kern<<<grid, WG_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(qstart),
      static_cast<__nv_bfloat16*>(out), t, nq, nkv, ps, mp, qoff, scale,
      nsplit, static_cast<float*>(ws), static_cast<int*>(tickets));
  return (int)cudaGetLastError();
}

#define PAGED_ARGS                                                         \
  q, k_pool, v_pool, table, qstart, out, b, t, nq, nkv, ps, mp, qoff, scale, \
      s
#define WGMMA_ARGS                                                         \
  q, k_pool, v_pool, table, qstart, out, b, t, nq, nkv, ps, mp, qoff, scale, \
      split, ws, ws_size, tickets, n_tickets, s

int dispatch_f32(int h, const void* q, const void* k_pool, const void* v_pool,
                 const void* table, const void* qstart, void* out, int b,
                 int t, int nq, int nkv, int ps, int mp, int qoff, float scale,
                 cudaStream_t s) {
  switch (h) {
    case 16: return launch<float, 16>(PAGED_ARGS);
    case 32: return launch<float, 32>(PAGED_ARGS);
    case 64: return launch<float, 64>(PAGED_ARGS);
    case 128: return launch<float, 128>(PAGED_ARGS);
    case 256: return launch<float, 256>(PAGED_ARGS);
    default: return -1;
  }
}

int dispatch_bf16(int h, const void* q, const void* k_pool,
                  const void* v_pool, const void* table, const void* qstart,
                  void* out, int b, int t, int nq, int nkv, int ps, int mp,
                  int qoff, float scale, int split, void* ws,
                  long long ws_size, void* tickets, long long n_tickets,
                  cudaStream_t s) {
  switch (h) {
    case 16: return launch<__nv_bfloat16, 16>(PAGED_ARGS);
    case 32: return launch<__nv_bfloat16, 32>(PAGED_ARGS);
    case 64: return launch_wgmma<64>(WGMMA_ARGS);
    case 128: return launch_wgmma<128>(WGMMA_ARGS);
    case 256: return launch_wgmma<256>(WGMMA_ARGS);
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory a launch of the (h, dtype) instance asks for at page
// size ps, in bytes; -1 for an instance that does not exist.
extern "C" int bwap_paged_smem_bytes(int h, int ps, int dtype) {
  if (ps <= 0 || ps > MAX_PS || (dtype != 0 && dtype != 1) ||
      (h != 16 && h != 32 && h != 64 && h != 128 && h != 256))
    return -1;
  if (dtype == 1 && (h == 64 || h == 128 || h == 256))
    return h == 64 ? WgLayout<64>::BYTES
                   : h == 128 ? WgLayout<128>::BYTES : WgLayout<256>::BYTES;
  return (int)walk_smem_bytes(h, ps);
}

// The tensor-core instance's layout at head dim h: keys a tile (WK) and
// tiles a key chunk (CH); -1 for a head dim it does not serve.
extern "C" int bwap_paged_tile_keys(int h) {
  return h == 64 ? WgLayout<64>::WK
                 : h == 128 ? WgLayout<128>::WK
                            : h == 256 ? WgLayout<256>::WK : -1;
}
extern "C" int bwap_paged_chunk_tiles(int h) {
  return h == 64 ? WgLayout<64>::CH
                 : h == 128 ? WgLayout<128>::CH
                            : h == 256 ? WgLayout<256>::CH : -1;
}

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns cudaGetLastError() (0 = success); -1 for a shape, type
// or alignment the kernel does not take. Query (b, t) sits at qstart[b] +
// qoff + t. The instance: bf16 at h = 64, 128, 256 runs on tensor cores, the
// rest on CUDA cores. The tensor-core instance takes its route from `split`
// (the split route only where the table spans more than one chunk), a
// workspace of ws_size bytes (ws_bytes; -1 if it is smaller) and, on the
// split route, n_tickets >= B * nkv * row blocks ints, all 0 (each launch
// leaves them 0); the CUDA-core instance ignores the four.
extern "C" int bwap_paged_attention(const void* q, const void* k_pool,
                                    const void* v_pool, const void* table,
                                    const void* qstart, void* out, int b,
                                    int t, int nq, int nkv, int h, int ps,
                                    int mp, int qoff, float scale, int dtype,
                                    int split, void* ws, long long ws_size,
                                    void* tickets, long long n_tickets,
                                    void* stream) {
  if (b <= 0 || t <= 0 || mp <= 0 || nkv <= 0 || nq % nkv != 0 || ps <= 0 ||
      ps > MAX_PS)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(h, PAGED_ARGS);
  if (dtype == 1) return dispatch_bf16(h, WGMMA_ARGS);
  return -1;
}
