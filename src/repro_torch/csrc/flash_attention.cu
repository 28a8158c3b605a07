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
// Design (simple first). Grid (ceil(S/BQ), nq, B), heaviest query tiles
// first; a block of 256 threads owns BQ = 64 query rows of one (b, head)
// and walks BK = 64-key tiles in ascending order of their absolute index,
// from the first tile the window can reach to the last tile causality
// allows (the tile skipping of :46-51, keyed on absolute starts). Q (once),
// each K and V tile are converted to fp32 in shared memory (Q and K stored
// transposed, [H][64], so the score loop reads float4s). Thread (ty, tx) of
// a 16 x 16 grid owns rows ty*4..ty*4+3: it scores keys tx*4..tx*4+3 of the
// tile (a 4 x 4 register tile) and accumulates output dims
// tx*VEC + 16*VEC*c + e (VEC = min(4, H/16)). The tile's probabilities go
// through shared memory (P, [64][64]) from the score layout to the PV
// layout. All arithmetic is fp32 on CUDA cores.
//
// Masking without the reference's accident. _flash_kernel starts at
// m = -1e38 and lets a row whose first tile is fully masked sum
// exp(0) = 1 over masked keys, which a later alpha = 0 wipes. Here a masked
// key's p is set to exactly 0 and never enters the max, m starts at the
// finite -2e38 (exp(-2e38 - -2e38) = 1, never NaN): a tile fully masked for
// a row leaves m unchanged, so alpha = 1, p = 0, and (m, l, acc) keep their
// bits. Keys at or past T and rows at or past S are zero-filled in shared
// memory, so no stale value reaches an fma (0 * NaN would not be 0).
//
// Bitwise invariance. A row's arithmetic does not depend on S, T (once they
// exceed the row), B, or the block it lands in: tiles start at multiples of
// 64 in absolute key position, each score is one fmaf chain over d = 0..H-1,
// the row max and the row sum of p are one xor butterfly over the 16 lanes
// of the row group (equal bits on every lane), and PV adds keys 0..63 of a
// tile in order. Tiles past a row's last visible key are exact no-ops for
// it, so a longer S or T changes none of its bits.
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s HBM): causal
// prefill at S = 4096 with qwen2-0.5b heads does 4*H*nq*S(S+1)/2 = 30 GFLOP
// and moves 17 MB, so it is bound by operations (~30 us at the bf16 peak).
// This kernel runs those flops on fp32 CUDA cores (67 TFLOP/s peak, so
// ~0.45 ms at best). Left for later: wgmma for QK^T and PV (with p kept
// accurate enough for the fp32 gates), TMA double-buffering of the next
// K/V tile, and warp specialisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int THREADS = 256;           // 16 x 16 thread grid
constexpr int RPT = 4;                 // rows per thread
constexpr int KPT = 4;                 // keys per thread (scores)
constexpr unsigned FULL = 0xffffffffu;

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

template <typename Elem, int H>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int t, int nq, int nkv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)H * BQ + (size_t)H * BK + (size_t)BK * H +
                       (size_t)BQ * BK);
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

template <typename Elem>
int dispatch_h(int h, const void* q, const void* k, const void* v, void* out,
               int b, int s, int t, int nq, int nkv, int causal, int window,
               float scale, cudaStream_t st) {
  switch (h) {
    case 16:
      return launch<Elem, 16>(q, k, v, out, b, s, t, nq, nkv, causal, window,
                              scale, st);
    case 32:
      return launch<Elem, 32>(q, k, v, out, b, s, t, nq, nkv, causal, window,
                              scale, st);
    case 64:
      return launch<Elem, 64>(q, k, v, out, b, s, t, nq, nkv, causal, window,
                              scale, st);
    case 128:
      return launch<Elem, 128>(q, k, v, out, b, s, t, nq, nkv, causal,
                               window, scale, st);
    case 256:
      return launch<Elem, 256>(q, k, v, out, b, s, t, nq, nkv, causal,
                               window, scale, st);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. q [b, s, nq,
// h], k/v [b, t, nkv, h], out [b, s, nq, h], all contiguous and 16-byte
// aligned. Launches on `stream` and returns cudaGetLastError() (0 =
// success); -1 for a shape or type the kernel does not take.
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
    return dispatch_h<float>(h, q, k, v, out, b, s, t, nq, nkv, causal,
                             window, scale, st);
  if (dtype == 1)
    return dispatch_h<__nv_bfloat16>(h, q, k, v, out, b, s, t, nq, nkv,
                                     causal, window, scale, st);
  return -1;
}
