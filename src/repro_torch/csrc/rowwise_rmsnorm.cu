// Row-invariant RMSNorm, for Hopper (sm_90a):
//   out[r] = x[r] * rsqrt(mean(x[r]^2) + eps) * (1 + gamma), in fp32.
//
// Replaces no TPU kernel: the reference normalises with jnp ops that XLA
// fuses. It was added beside csrc/rowwise_matmul.cu for the same reason:
// PyTorch's CUDA reduction picks its block shape from the number of rows
// (with few rows it spreads one row's sum over more threads), so
// `x.square().mean(-1)` summed a row in another order in a decode step (B
// rows) than in a verify chunk (B x T rows), and a speculative token could
// part from greedy's. A per-row reduction with one fixed order is what the
// fix needs; it is a small fused reduction, written here in CUDA so the
// port builds all its kernels one way.
//
// One block of THREADS threads a row: thread t sums x[t], x[t + THREADS],
// ... in ascending order, each square rounded to fp32 and then added; the
// warps fold by a fixed butterfly and the eight warp sums are added in warp
// order. Nothing depends on the number of rows. Bound: the bytes (x read
// once, out written once, at 3.35 TB/s).
//
// Layout: x, out [M, d] row-major, of one dtype (fp32 or bf16); gamma [d]
// fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, typename G>
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows(const T* __restrict__ x, const G* __restrict__ gamma,
             T* __restrict__ out, int d, float eps) {
  __shared__ float part[THREADS / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float v = to_f(xr[i]);
    s = __fadd_rn(s, __fmul_rn(v, v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) tot = __fadd_rn(tot, part[w]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(tot, (float)d), eps));
  for (int i = threadIdx.x; i < d; i += THREADS)
    put(orow + i, __fmul_rn(__fmul_rn(to_f(xr[i]), r),
                            __fadd_rn(1.f, to_f(gamma[i]))));
}

template <typename T>
int launch(const void* x, const void* gamma, int gamma_dtype, void* out,
           int m, int d, float eps, cudaStream_t s) {
  if (gamma_dtype == 0)
    rmsnorm_rows<T, float><<<m, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<T*>(out), d, eps);
  else if (gamma_dtype == 1)
    rmsnorm_rows<T, __nv_bfloat16><<<m, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const __nv_bfloat16*>(gamma),
        static_cast<T*>(out), d, eps);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry for ctypes. dtype, gamma_dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns cudaGetLastError() (0 = success); -1 for
// a shape or type the kernel does not take.
extern "C" int bwap_rowwise_rmsnorm(const void* x, const void* gamma,
                                    void* out, int m, int d, float eps,
                                    int dtype, int gamma_dtype,
                                    void* stream) {
  if (m <= 0 || d <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, gamma_dtype, out, m, d, eps, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, gamma_dtype, out, m, d, eps, s);
  return -1;
}
