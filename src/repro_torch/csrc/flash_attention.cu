// Full-sequence flash attention (GQA, causal or not, sliding window), for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_bh
//     (body _flash_kernel :30-88, pl.pallas_call :114)
// together with its GQA wrapper (flash_attention/ops.py:15-33), which
// repeats the KV heads in memory; here query head `head` reads KV head
// head / g by index, so no K/V byte is copied.
//
// What it computes: q [B, S, nq, H] against k/v [B, T, nkv, H] -> out
// [B, S, nq, H]. Query row s sits at position s and key t at position t
// (top-left aligned, also when S != T). A key is seen when t < T, t <= s
// under `causal`, and s - t < window when window > 0. Scores are scaled by
// 1/sqrt(H); the softmax is online, in fp32 (m, l, acc); out = acc / l
// rounded once to the element type, and 0 where l == 0 (no key seen).
//
// What bounds it on the H100: causal prefill at S = 4096 with qwen2-0.5b
// heads does 4*H*nq*S(S+1)/2 = 30 GFLOP and moves 17 MB, so it is bound by
// operations: ~30 us at the 989 TFLOP/s dense bf16 tensor-core peak, against
// ~5 us for the bytes at 3.35 TB/s. Only the tensor cores can approach that.
// Two instances, chosen by element type and head dim only (never by S, T,
// B or window, so a row's bits never depend on them):
//
// 1. bf16, H = 64, 128, 256: the tensor-core instance (flash_wgmma_kernel).
//    A block of three warpgroups owns BQ = 128 query rows of one (b, head)
//    and walks WK-key tiles: WK = 64 at H = 64, 128 and 48 at H = 256
//    (WgLayout<H>::WK, wgmma_attention.cuh).
//    - Warpgroup 0 is the producer: one thread issues TMA loads from 4-D
//      tensor maps over [B, len, heads, H] (a box is one head's [rows x 64]
//      slab, 128-byte swizzled; rows past S or T read as zeros), Q once and
//      K and V through a ring of 6, 4 or 3 stages (H = 64, 128, 256),
//      each with an mbarrier for K, one for V and one that the consumers
//      release. It gives its registers away (setmaxnreg 24).
//    - Warpgroups 1 and 2 consume 64 query rows each (setmaxnreg 240; the
//      role is taken from a warp-uniform warpgroup index, without which
//      ptxas spills the pipelined loop as if the consumers had the
//      launch's 168 registers):
//      S = Q K^T by wgmma (bf16 in, fp32 accumulate, both operands from
//      shared memory, K-major), fp32 online softmax in the accumulator
//      layout (a row lives on the 4 lanes of a quad), then O += P V by wgmma
//      with P from registers and V from shared memory as the MN-major
//      (transposed) B operand, so V is never transposed in memory. O is
//      H/64 accumulators of m64n64 (128 fp32 registers a thread at H = 256).
//    - The tiles are pipelined as in FlashAttention-3: S(i+1) = Q K(i+1)^T
//      and O += P(i) V(i) are issued together and the softmax of tile i+1
//      runs while they do; the two warpgroups take turns to issue (named
//      barriers), so one's softmax overlaps the other's products. At
//      H = 256 the 48-key tile (S by wgmma m64n48k16, 24 registers, and 24
//      for the hi/lo P pair) is what leaves room beside O for the second
//      tile in flight.
//    - P goes in as a hi/lo pair, hi = bf16(p), lo = bf16(p - hi), two PV
//      products into one fp32 accumulator. A single bf16 P breaks the gate of
//      two bf16 ulps of the plain version; the pair keeps p to ~16 bits, as
//      close as fp32 P (tests/test_torch_flash.py holds an emulation of this
//      rounding against both gates). It costs 1.5x the nominal flops.
//    - p = 2^(s * scale * log2(e) - m), one fma and one MUFU ex2 per score.
//    Shared memory at H = 256: Q 64 KB + three stages of K and V, 24 KB each
//    = 208 KB, one block per SM.
// 2. fp32 (any H) and bf16 at H = 16, 32: the CUDA-core instance
//    (flash_kernel, the port's first design). fp32 stays on CUDA cores as its
//    gate is 2e-5 and TF32 tensor cores keep about three decimal digits;
//    fp32 is on no full-width path. H = 16 and 32 have 32- and 64-byte rows,
//    which would need the 32- and 64-byte swizzle modes and descriptor
//    layouts of their own for a fraction of the work per key; no full-width
//    configuration uses them.
//
// Masking without the reference's accident. _flash_kernel starts at
// m = -1e38 and lets a row whose first tile is fully masked sum
// exp(0) = 1 over masked keys, which a later alpha = 0 wipes. Here a masked
// key's p is exactly 0 (hi and lo both 0) and never enters the max, m
// starts at the finite -2e38 (exp(-2e38 - -2e38) = 1, never NaN): a tile
// fully masked for a row after its first key leaves m unchanged, so
// alpha = 1, p = 0, and (m, l, acc) keep their bits; before its first key
// it leaves l = acc = 0 (in the tensor-core instance, whose max is taken on
// raw scores, m may move from -2e38 to -2e38 * scale * log2(e), which gives
// alpha = 0 at the first key all the same). Keys at or past T and rows at
// or past S are zero in shared memory, so no stale value reaches a product
// (0 * NaN would not be 0).
//
// Bitwise invariance (the engine's recompute oracle equals one-shot prefill
// bit for bit). A row's arithmetic does not depend on S, T (once they
// exceed the row), B, or the block it lands in: query tiles start at
// multiples of BQ and key tiles at multiples of WK in absolute position,
// each score is one product over d = 0..H-1 in an order fixed by the
// instance, the row max and the row sum of p are one xor butterfly over the
// lanes that hold the row (equal bits on each), every multiply and fma of the
// softmax is written out (__fmul_rn, __fmaf_rn) so that the masked and the
// unmasked code paths round alike, and PV adds a tile's keys in a fixed
// order. Tiles past a row's last visible key are exact no-ops for it, so a
// longer S or T changes none of its bits.

#include <cuda.h>           // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// The CUDA-core instance: fp32 at every head dim, bf16 at H = 16, 32.
// Grid (ceil(S/BQ), nq, B), heaviest query tiles first; a block of 256
// threads owns BQ = 64 query rows of one (b, head) and walks BK = 64-key
// tiles in ascending order of their absolute index, from the first tile the
// window can reach to the last tile causality allows (the tile skipping of
// :46-51, keyed on absolute starts). Q (once), each K and V tile are
// converted to fp32 in shared memory (Q and K stored transposed, [H][64], so
// the score loop reads float4s). Thread (ty, tx) of a 16 x 16 grid owns rows
// ty*4..ty*4+3: it scores keys tx*4..tx*4+3 of the tile (a 4 x 4 register
// tile) and accumulates output dims tx*VEC + 16*VEC*c + e (VEC = min(4,
// H/16)). The tile's probabilities go through shared memory (P, [64][64])
// from the score layout to the PV layout. Each score is one fmaf chain over
// d; the row max and sum are xor butterflies over the 16 lanes of a row.
// ---------------------------------------------------------------------------

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 256;           // 16 x 16 thread grid
constexpr int RPT = 4;                 // rows per thread
constexpr int KPT = 4;                 // keys per thread (scores)

// 16 bytes of Elem -> fp32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N == 4) {
    load16(p, out);
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

// butterfly over the 16 lanes of a row group: every lane ends with the same
// bits (partners add (a + b) and (b + a), which are equal)
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// rows [r0, r0 + n) x H of a [rows, heads, H] slab (row stride `stride`
// elements) into dst[d][n] transposed, zero past `valid`
template <typename Elem, int H, int N>
__device__ __forceinline__ void load_transposed(const Elem* src, size_t stride,
                                                int r0, int valid,
                                                float* dst) {
  constexpr int VG = 16 / sizeof(Elem);
  for (int i = threadIdx.x; i < N * (H / VG); i += THREADS) {
    const int r = i % N, dc = i / N;
    float x[VG];
    if (r0 + r < valid) {
      load16(src + (size_t)(r0 + r) * stride + dc * VG, x);
    } else {
#pragma unroll
      for (int e = 0; e < VG; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VG; ++e) dst[(dc * VG + e) * N + r] = x[e];
  }
}

template <typename Elem, int H>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const Elem* __restrict__ q, const Elem* __restrict__ k,
             const Elem* __restrict__ v, Elem* __restrict__ out, int s_len,
             int t_len, int nq, int nkv, int causal, int window,
             float scale) {
  constexpr int VEC = H / 16 < 4 ? H / 16 : 4;   // dims per vector
  constexpr int DPT = H / 16;                    // output dims per thread
  constexpr int VG = 16 / sizeof(Elem);
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [H][BQ]
  float* kt = qs + H * BQ;          // [H][BK]
  float* vs = kt + H * BK;          // [BK][H]
  float* ps = vs + BK * H;          // [BQ][BK]

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int g = nq / nkv, kvh = head / g;
  const int q0 = qt * BQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const Elem* qb = q + ((size_t)b * s_len * nq + head) * H;
  const Elem* kb = k + ((size_t)b * t_len * nkv + kvh) * H;
  const Elem* vb = v + ((size_t)b * t_len * nkv + kvh) * H;
  load_transposed<Elem, H, BQ>(qb, (size_t)nq * H, q0, s_len, qs);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }

  // KV tiles this block needs: from the first the window reaches to the
  // last causality allows, by absolute key position
  const int q_last = min(q0 + BQ, s_len) - 1;
  int kt_hi = (t_len - 1) / BK;
  if (causal) kt_hi = min(kt_hi, q_last / BK);
  int kt_lo = 0;
  if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;

  for (int tile = kt_lo; tile <= kt_hi; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                  // previous tile fully consumed
    load_transposed<Elem, H, BK>(kb, (size_t)nkv * H, k0, t_len, kt);
    for (int i = threadIdx.x; i < BK * (H / VG); i += THREADS) {
      const int key = i / (H / VG), dc = i % (H / VG);
      float x[VG];
      if (k0 + key < t_len) {
        load16(vb + (size_t)(k0 + key) * nkv * H + dc * VG, x);
      } else {
#pragma unroll
        for (int e = 0; e < VG; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VG; ++e) vs[key * H + dc * VG + e] = x[e];
    }
    __syncthreads();

    // scores: one fmaf chain over d per (row, key)
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < H; ++d) {
      float qv[RPT], kv[KPT];
      load16(qs + d * BQ + ty * RPT, qv);
      load16(kt + d * BK + tx * KPT, kv);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over the tile; masked keys get p = 0 exactly
    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty * RPT + i;
      bool ok[KPT];
      float tmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + tx * KPT + j;
        ok[j] = kpos < t_len && (!causal || kpos <= qpos) &&
                (window <= 0 || qpos - kpos < window);
        s[i][j] *= scale;
        if (ok[j]) tmax = fmaxf(tmax, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(tmax));
      alpha[i] = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += s[i][j];
      }
      l[i] = l[i] * alpha[i] + group_sum(psum);
      m[i] = m_new;
      *reinterpret_cast<float4*>(ps + (ty * RPT + i) * BK + tx * KPT) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // acc = acc * alpha + P V, keys of the tile in order
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha[i];
#pragma unroll 2
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float pr[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        load16(ps + (ty * RPT + i) * BK + k4 * 4, pr[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vrow = vs + (k4 * 4 + kk) * H;
        float vv[DPT];
#pragma unroll
        for (int c = 0; c < DPT / VEC; ++c)
          lds<VEC>(vrow + tx * VEC + 16 * VEC * c, vv + c * VEC);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < DPT; ++c)
            acc[i][c] = fmaf(pr[i][kk], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = q0 + ty * RPT + i;
    if (row >= s_len) continue;
    Elem* orow = out + (((size_t)b * s_len + row) * nq + head) * H;
#pragma unroll
    for (int c = 0; c < DPT / VEC; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(orow + tx * VEC + 16 * VEC * c + e,
              l[i] == 0.f ? 0.f : acc[i][c * VEC + e] / l[i]);
  }
}

// Q^T, K^T, V and P in fp32
constexpr int simt_smem_bytes(int h) {
  return (int)sizeof(float) * (h * BQ + h * BK + BK * h + BQ * BK);
}

template <typename Elem, int H>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int nq, int nkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = simt_smem_bytes(H);
  auto kern = flash_kernel<Elem, H>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((s + BQ - 1) / BQ, nq, b);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<Elem*>(out), s, t, nq, nkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core instance: bf16 at H = 64, 128, 256 (see the top of file);
// the machinery it shares with the paged kernel is in wgmma_attention.cuh.
// ---------------------------------------------------------------------------

// one box of a 4-D tensor map into shared memory, signalling `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// The online softmax of one tile of scores s (keys k0 ..): masked keys
// (tested only where the tile can hold one for a row of this warpgroup,
// whose first row is row0) go to -inf; (m, l) move to the tile; s becomes
// p = 2^(s c2 - m) in fp32; returns the factors alpha that O must take.
template <int WK>
__device__ __forceinline__ void softmax_tile(float (&s)[WK / 2], Rows& r,
                                             int k0, int row0, int t_len,
                                             int causal, int window, float c2,
                                             float& al_a, float& al_b) {
  const bool edge = k0 + WK > t_len || (causal && k0 + WK - 1 > row0) ||
                    (window > 0 && row0 + 63 - k0 >= window);
  float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
  for (int n = 0; n < WK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e];
      if (edge) {
        const int kpos = k0 + 8 * n + r.kc + (e & 1);
        const int qpos = e < 2 ? r.qa : r.qb;
        const bool ok = kpos < t_len && (!causal || kpos <= qpos) &&
                        (window <= 0 || qpos - kpos < window);
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

template <int H>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int s_len, int t_len,
                   int nq, int nkv, int causal, int window, float scale) {
  using L = WgLayout<H>;
  constexpr int NC = L::NC, WK = L::WK;
  extern __shared__ uint8_t wg_smem[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem)) + 1023u) &
      ~1023u;
  const uint32_t q_s = base, k_s = base + L::K_OFF, v_s = base + L::V_OFF;
  const uint32_t bars = base + L::BAR_OFF, q_full = bars;

  const int qt = gridDim.x - 1 - blockIdx.x;      // heaviest tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (nq / nkv);
  const int q0 = qt * WQ;
  // KV tiles this block needs: from the first the window reaches to the
  // last causality allows, by absolute key position
  const int q_last = min(q0 + WQ, s_len) - 1;
  int kt_hi = (t_len - 1) / WK;
  if (causal) kt_hi = min(kt_hi, q_last / WK);
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / WK : 0;
  const int n_tiles = kt_hi - kt_lo + 1;          // may be <= 0

  if (threadIdx.x == 0) {
    if constexpr (!L::TRAP) wait_abandoned() = 0;
    mbar_init(q_full, 1);
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(L::full_k(bars, st), 1);
      mbar_init(L::full_v(bars, st), 1);
      mbar_init(L::empty(bars, st), 8);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's index, warp-uniform to the compiler (a shuffle from
  // lane 0), so that each role gets its own register budget
  const int wg = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer: one thread keeps the K/V ring filled
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        tma_load(q_s + c * WQ * ROW_BYTES, &tq, q_full, c * CHUNK, head, q0,
                 b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % L::STAGES;
        const int k0 = (kt_lo + i) * WK;
        mbar_wait<L::TRAP>(L::empty(bars, st), ((i / L::STAGES) & 1) ^ 1);
        const uint32_t kd = k_s + st * L::KV_BYTES;
        const uint32_t vd = v_s + st * L::KV_BYTES;
        mbar_expect_tx(L::full_k(bars, st), L::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load(kd + c * WK * ROW_BYTES, &tk, L::full_k(bars, st),
                   c * CHUNK, kvh, k0, b);
        mbar_expect_tx(L::full_v(bars, st), L::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          tma_load(vd + c * WK * ROW_BYTES, &tv, L::full_v(bars, st),
                   c * CHUNK, kvh, k0, b);
      }
    }
  } else {
    // consumers: warpgroup cw owns rows row0 .. row0 + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;" ::: "memory");
    const int cw = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int row0 = q0 + 64 * cw;
    Rows r;
    r.qa = row0 + 16 * warp + lane / 4;
    r.qb = r.qa + 8;
    r.kc = 2 * (lane % 4);
    r.m_a = r.m_b = NEG_INF;
    r.l_a = r.l_b = 0.f;
    const float c2 = __fmul_rn(scale, LOG2E);     // scores to log2 units
    float o[NC][32];
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
    const uint64_t dq = gmma_desc(q_s + cw * 64 * ROW_BYTES, 16, 1024);
    // the online softmax of tile i (keys from (kt_lo + i) * WK)
    auto softmax = [&](float (&s)[WK / 2], int i, float& al_a,
                       float& al_b) {
      softmax_tile<WK>(s, r, (kt_lo + i) * WK, row0, t_len, causal, window,
                       c2, al_a, al_b);
    };
    // Every tile of the block's range is computed by both warpgroups: a
    // tile that a warpgroup's rows cannot see is fully masked for them, an
    // exact no-op, and no wgmma sits under a data-dependent branch.
    mbar_wait<L::TRAP>(q_full, 0);
    if (n_tiles > 0)
      consume_pipelined<H, false>(o, dq, k_s, v_s, bars, n_tiles, cw, lane,
                                  softmax);
    const int qa = r.qa, qb = r.qb, kc = r.kc;
    const float l_a = r.l_a, l_b = r.l_b;

    // out = O / l, 0 where the row saw no key
    const size_t row_stride = (size_t)nq * H;
    __nv_bfloat16* oa = out + ((size_t)b * s_len + qa) * row_stride +
                        (size_t)head * H;
    __nv_bfloat16* ob = oa + 8 * row_stride;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = j * CHUNK + 8 * n + kc;
        if (qa < s_len)
          *reinterpret_cast<__nv_bfloat162*>(oa + col) = __floats2bfloat162_rn(
              l_a == 0.f ? 0.f : o[j][4 * n] / l_a,
              l_a == 0.f ? 0.f : o[j][4 * n + 1] / l_a);
        if (qb < s_len)
          *reinterpret_cast<__nv_bfloat162*>(ob + col) = __floats2bfloat162_rn(
              l_b == 0.f ? 0.f : o[j][4 * n + 2] / l_b,
              l_b == 0.f ? 0.f : o[j][4 * n + 3] / l_b);
      }
  }
}

// 4-D map over a contiguous bf16 [n, len, heads, H] (innermost first): a
// box is one head's [rows x 64] slab, 128-byte swizzled; rows past len read
// as zeros. Returns 0, or -3 when the driver refuses the map.
template <int H>
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int n,
             int len, int heads, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)H, (cuuint64_t)heads,
                              (cuuint64_t)len, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)H * 2, (cuuint64_t)heads * H * 2,
                                 (cuuint64_t)len * heads * H * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CHUNK, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

template <int H>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int b, int s, int t, int nq, int nkv, int causal, int window,
                 float scale, cudaStream_t stream) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -2;
  CUtensorMap tq, tk, tv;
  if (make_map<H>(enc, &tq, q, b, s, nq, WQ) ||
      make_map<H>(enc, &tk, k, b, t, nkv, WgLayout<H>::WK) ||
      make_map<H>(enc, &tv, v, b, t, nkv, WgLayout<H>::WK))
    return -3;
  constexpr int smem = WgLayout<H>::BYTES;
  auto kern = flash_wgmma_kernel<H>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((s + WQ - 1) / WQ, nq, b);
  kern<<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), s, t, nq, nkv, causal,
      window, scale);
  return (int)cudaGetLastError();
}

#define FLASH_ARGS q, k, v, out, b, s, t, nq, nkv, causal, window, scale, st

int dispatch_f32(int h, const void* q, const void* k, const void* v,
                 void* out, int b, int s, int t, int nq, int nkv, int causal,
                 int window, float scale, cudaStream_t st) {
  switch (h) {
    case 16: return launch<float, 16>(FLASH_ARGS);
    case 32: return launch<float, 32>(FLASH_ARGS);
    case 64: return launch<float, 64>(FLASH_ARGS);
    case 128: return launch<float, 128>(FLASH_ARGS);
    case 256: return launch<float, 256>(FLASH_ARGS);
    default: return -1;
  }
}

int dispatch_bf16(int h, const void* q, const void* k, const void* v,
                  void* out, int b, int s, int t, int nq, int nkv, int causal,
                  int window, float scale, cudaStream_t st) {
  switch (h) {
    case 16: return launch<__nv_bfloat16, 16>(FLASH_ARGS);
    case 32: return launch<__nv_bfloat16, 32>(FLASH_ARGS);
    case 64: return launch_wgmma<64>(FLASH_ARGS);
    case 128: return launch_wgmma<128>(FLASH_ARGS);
    case 256: return launch_wgmma<256>(FLASH_ARGS);
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory a launch of the (h, dtype) instance asks for, in
// bytes; -1 for an instance that does not exist.
extern "C" int bwap_flash_smem_bytes(int h, int dtype) {
  if (dtype == 1 && (h == 64 || h == 128 || h == 256))
    return h == 64 ? WgLayout<64>::BYTES
                   : h == 128 ? WgLayout<128>::BYTES : WgLayout<256>::BYTES;
  if ((dtype != 0 && dtype != 1) ||
      (h != 16 && h != 32 && h != 64 && h != 128 && h != 256))
    return -1;
  return simt_smem_bytes(h);
}

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. q [b, s, nq,
// h], k/v [b, t, nkv, h], out [b, s, nq, h], all contiguous and 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError() (0 =
// success); -1 for a shape or type the kernel does not take, -2 when the
// driver has no cuTensorMapEncodeTiled, -3 when it refuses a tensor map.
// The instance: bf16 at h = 64, 128, 256 runs on tensor cores, the rest on
// CUDA cores.
extern "C" int bwap_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int b, int s,
                                    int t, int nq, int nkv, int h, int causal,
                                    int window, float scale, int dtype,
                                    void* stream) {
  if (b <= 0 || s <= 0 || t <= 0 || nkv <= 0 || nq % nkv != 0 ||
      nq > 65535 || b > 65535)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_f32(h, FLASH_ARGS);
  if (dtype == 1)
    return dispatch_bf16(h, FLASH_ARGS);
  return -1;
}
