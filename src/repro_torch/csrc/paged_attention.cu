// Paged attention over a BWAP-placed KV page pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels on the serving main path:
//   src/repro/kernels/paged_attention/kernel.py::paged_prefill_attention_batch
//     (body _paged_prefill_batch_kernel, pl.pallas_call at :233)
//   src/repro/kernels/paged_attention/kernel.py::paged_attention
//     (body _paged_kernel, pl.pallas_call at :317)
// and serves the single-sequence paged_prefill_attention (:276) as B = 1.
//
// One kernel, the batched prefill-mode page walk. Query (b, t) sits at
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
// Design (simple first). Grid (B, nkv, ceil(T*g / ROWS)); a block of
// WARPS warps owns ROWS rows of one KV head and walks the row's pages in
// table order in a loop. Each page's K and V slice for the KV head
// (ps x h, 2 KB each in bf16 at ps = 16, h = 64) is loaded into shared
// memory as fp32 and shared by all ROWS rows. A warp handles ROWS_PER_WARP
// rows; per row it keeps (m, l, acc[h]) in fp32 registers, lane j scores
// slots j and j + 32, and lane i owns acc[i], acc[i + 32], ...
//
// Bit-invariance. A row's arithmetic does not depend on T, B, mp, ROWS or
// the tile it lands in: the dot product over h runs in fixed order d = 0..h-1
// (one fmaf chain per slot), the row max and the sum of p are the same xor
// butterfly for every row, and the p.v sum runs over slots in order. Pages
// are never split. The block stops at the first page whose absolute start
// lies past the last position of its rows; such a page is fully masked for
// every row and an exact no-op (alpha = 1, every p = 0), so stopping there
// changes no bits. NEG_INF is the finite -2e38 of the plain version, for
// both the init and the mask (exp(-inf - -inf) would be NaN). A row whose
// walk saw no key (l = 0) gives 0.
//
// Bound on the H100 (3.35 TB/s HBM, 989 TFLOP/s dense bf16). Decode is
// memory-bound: it must read the K and V bytes of the pages each row
// actually covers, ~1 us at B = 8, 800 tokens, qwen2-0.5b heads, per layer.
// Prefill at T = 256 does 4*T*g*context*h flops per (b, kvh); at the bf16
// peak that takes about as long as its bytes (~3 us), but this kernel runs
// them on fp32 CUDA cores (67 TFLOP/s, ~35 us). This simple design leaves
// for later: wgmma for the QK^T and PV products, TMA / cp.async
// double-buffering of the next page while the current one computes, and
// splitting a long page walk across SMs (decode launches only B*nkv blocks)
// with a fixed-order merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;   // query rows per block
constexpr int MAX_PS = 64;                    // two slots per lane
constexpr unsigned FULL = 0xffffffffu;

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

template <typename Elem, int H>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* qstart, void* out, int b, int t,
           int nq, int nkv, int ps, int mp, int qoff, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) *
                      ((size_t)ps * (H + 1) + (size_t)ps * H + ROWS * H);
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

template <typename Elem>
int dispatch_h(int h, const void* q, const void* k_pool, const void* v_pool,
               const void* table, const void* qstart, void* out, int b,
               int t, int nq, int nkv, int ps, int mp, int qoff, float scale,
               cudaStream_t s) {
  switch (h) {
    case 16:
      return launch<Elem, 16>(q, k_pool, v_pool, table, qstart, out, b, t,
                              nq, nkv, ps, mp, qoff, scale, s);
    case 32:
      return launch<Elem, 32>(q, k_pool, v_pool, table, qstart, out, b, t,
                              nq, nkv, ps, mp, qoff, scale, s);
    case 64:
      return launch<Elem, 64>(q, k_pool, v_pool, table, qstart, out, b, t,
                              nq, nkv, ps, mp, qoff, scale, s);
    case 128:
      return launch<Elem, 128>(q, k_pool, v_pool, table, qstart, out, b, t,
                               nq, nkv, ps, mp, qoff, scale, s);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns cudaGetLastError() (0 = success); -1 for a shape or
// type the kernel does not take. Query (b, t) sits at qstart[b] + qoff + t.
extern "C" int bwap_paged_attention(const void* q, const void* k_pool,
                                    const void* v_pool, const void* table,
                                    const void* qstart, void* out, int b,
                                    int t, int nq, int nkv, int h, int ps,
                                    int mp, int qoff, float scale, int dtype,
                                    void* stream) {
  if (b <= 0 || t <= 0 || mp <= 0 || nkv <= 0 || nq % nkv != 0 || ps <= 0 ||
      ps > MAX_PS)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_h<float>(h, q, k_pool, v_pool, table, qstart, out, b, t,
                             nq, nkv, ps, mp, qoff, scale, s);
  if (dtype == 1)
    return dispatch_h<__nv_bfloat16>(h, q, k_pool, v_pool, table, qstart, out,
                                     b, t, nq, nkv, ps, mp, qoff, scale, s);
  return -1;
}
