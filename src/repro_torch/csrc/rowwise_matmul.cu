// Row-invariant weight product out = a @ w, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's paged decoder leaves its weight
// products to XLA (`x @ w` in src/repro/serve/engine.py). It was added
// because a GEMM library rounds a row's dot products by how many rows share
// the launch (its kernel, tiling and split-K follow M), so on a card a
// speculative verify chunk (T rows a sequence) or a `coda` micro-batch
// wrote other K/V and logits than greedy decode at the same positions, and
// the tokens could part from greedy's. Here each output element's K
// reduction runs in one order that the instance alone fixes:
//   - K is walked in BK-wide steps in ascending order, with no split-K;
//     each step's products are summed into a fresh fp32 partial, which is
//     then added to the running sum (two levels: a step's rounding does not
//     grow with K);
//   - one block shape (BM x BN) for every M, N and K;
//   - bf16: mma.sync m16n8k16 on the tensor cores with fp32 accumulators.
//     An output element comes from its row of A, its column of W and its
//     own accumulator only, so the other rows of a tile (other sequences,
//     or the zeros past M) change none of its bits;
//   - fp32: one fmaf a k, ascending, on the CUDA cores (no TF32).
// A row's bits therefore depend on its own values, W and K, never on M or
// on where the row sits in a tile.
//
// Bound: at decode (M = 8) and at the engine's prefill chunks (M <= 256)
// the weight's bytes (K * N * 2 at 3.35 TB/s) outweigh the operations
// (2 M N K at 989 TFLOP/s) at the served widths. This first version does
// little about it: 16-byte loads into registers one K step (128 deep)
// ahead of the tensor cores, a 32 x 64 block. A weight with few columns
// (the K/V projections) fills few SMs, and split-K, the usual cure, would
// change the order. Making it fast is later work.
//
// Layout: a [M, K] row-major; out [M, N] row-major; w [N, K] row-major,
// the layout of a tied head's embedding table [V, d], so the vocabulary
// matrix is never copied; the decoder stores its projections so on a card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// bf16 instance: 4 warps, each a 16 x 32 tile (four m16n8 accumulators)
constexpr int BM = 32, BN = 64, BK = 128, THREADS = 128;
constexpr int LDA = BK + 8;        // an A row in shared memory: 272 bytes
// W's tile in shared memory keeps its global layout, [BN][BK] rows of k
// (read as mma's B by 32-bit loads); rows padded by 16 bytes, so the eight
// rows of one fragment load fall in distinct banks
constexpr int LDW = BK + 8;

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One block owns out[m0 : m0 + BM, n0 : n0 + BN]. Per K step every thread
// brings 4 16-byte vectors of the A tile and 8 of the W tile into registers
// (the next step's while the tensor cores run this one) and stores them to
// shared memory as they lie in device memory.
__global__ void __launch_bounds__(THREADS)
rowwise_bf16(const __nv_bfloat16* __restrict__ a,
             const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ out, int m, int n, int k) {
  constexpr int AV = BM * BK / 8 / THREADS, WV = BN * BK / 8 / THREADS;
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * LDW];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 32;
  const int g = lane >> 2, tg = lane & 3;

  uint4 ra[AV], rb[WV];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < AV; ++i) {                   // A: 32 rows x 16 vectors
      const int j = tid + i * THREADS, r = j >> 4, c = (j & 15) * 8;
      ra[i] = load16(a + (size_t)(m0 + r) * k + k0 + c,
                     m0 + r < m && k0 + c < k);
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {                   // W: 64 n x 16 vectors
      const int j = tid + i * THREADS, r = j >> 4, c = (j & 15) * 8;
      rb[i] = load16(w + (size_t)(n0 + r) * k + k0 + c,
                     n0 + r < n && k0 + c < k);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < AV; ++i) {
      const int j = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&As[(j >> 4) * LDA + (j & 15) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < WV; ++i) {
      const int j = tid + i * THREADS;
      *reinterpret_cast<uint4*>(&Bs[(j >> 4) * LDW + (j & 15) * 8]) = rb[i];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  const int steps = (k + BK - 1) / BK;
  fetch(0);
  for (int s = 0; s < steps; ++s) {
    stash();
    __syncthreads();
    if (s + 1 < steps) fetch((s + 1) * BK);
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[j][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {           // ascending k, always
      const __nv_bfloat16* ap = &As[(wm + g) * LDA + kk + 2 * tg];
      const uint32_t a0 = lds32(ap), a1 = lds32(ap + 8 * LDA);
      const uint32_t a2 = lds32(ap + 8), a3 = lds32(ap + 8 * LDA + 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* bp = &Bs[(wn + 8 * j + g) * LDW + kk + 2 * tg];
        mma_bf16(part[j], a0, a1, a2, a3, lds32(bp), lds32(bp + 8));
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = __fadd_rn(acc[j][q], part[j][q]);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * tg;       // n % 8 == 0: both in
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + g + 8 * h;
      if (row < m)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
}

// fp32 instance: a thread a column, FBM rows of accumulators, one fmaf a k
constexpr int FBM = 16, FBN = 128, FBK = 32;

__global__ void __launch_bounds__(FBN)
rowwise_f32(const float* __restrict__ a, const float* __restrict__ w,
            float* __restrict__ out, int m, int n, int k) {
  __shared__ float As[FBM][FBK];
  __shared__ float Ws[FBK][FBN + 1];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * FBM, n0 = blockIdx.x * FBN;
  float acc[FBM];
#pragma unroll
  for (int r = 0; r < FBM; ++r) acc[r] = 0.f;
  for (int k0 = 0; k0 < k; k0 += FBK) {
    for (int i = tid; i < FBM * FBK; i += FBN) {
      const int r = i / FBK, kk = i % FBK;
      As[r][kk] = (m0 + r < m && k0 + kk < k)
                      ? a[(size_t)(m0 + r) * k + k0 + kk] : 0.f;
    }
    for (int i = tid; i < FBK * FBN; i += FBN) {    // coalesced along k
      const int nn = i / FBK, kk = i % FBK;
      Ws[kk][nn] = (k0 + kk < k && n0 + nn < n)
                       ? w[(size_t)(n0 + nn) * k + k0 + kk] : 0.f;
    }
    __syncthreads();
    float part[FBM];
#pragma unroll
    for (int r = 0; r < FBM; ++r) part[r] = 0.f;
    for (int kk = 0; kk < FBK; ++kk) {              // ascending k, always
      const float wv = Ws[kk][tid];
#pragma unroll
      for (int r = 0; r < FBM; ++r) part[r] = fmaf(As[r][kk], wv, part[r]);
    }
#pragma unroll
    for (int r = 0; r < FBM; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
    __syncthreads();
  }
  if (n0 + tid < n) {
#pragma unroll
    for (int r = 0; r < FBM; ++r)
      if (m0 + r < m) out[(size_t)(m0 + r) * n + n0 + tid] = acc[r];
  }
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. Launches on
// `stream` and returns cudaGetLastError() (0 = success); -1 for a shape,
// type or alignment the kernel does not take (bf16: N and K multiples of 8,
// 16-byte aligned pointers).
extern "C" int bwap_rowwise_matmul(const void* a, const void* w, void* out,
                                   int m, int n, int k, int dtype,
                                   void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) |
                           reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(out);
    if (n % 8 || k % 8 || (ptrs & 15)) return -1;
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    if (grid.y > 65535) return -1;
    const auto* a16 = static_cast<const __nv_bfloat16*>(a);
    const auto* w16 = static_cast<const __nv_bfloat16*>(w);
    auto* o16 = static_cast<__nv_bfloat16*>(out);
    rowwise_bf16<<<grid, THREADS, 0, s>>>(a16, w16, o16, m, n, k);
  } else if (dtype == 0) {
    const dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
    if (grid.y > 65535) return -1;
    rowwise_f32<<<grid, FBN, 0, s>>>(static_cast<const float*>(a),
                                     static_cast<const float*>(w),
                                     static_cast<float*>(out), m, n, k);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
