// Fused residual add + row-invariant RMSNorm, for Hopper (sm_90a):
//   s[r] = x[r] + y[r]                      (rounded to x's dtype)
//   h[r] = s[r] * rsqrt(mean(s[r]^2) + eps) * (1 + gamma), in fp32,
// or, with y null, the plain norm h[r] of x[r] (s not written).
//
// Replaces no TPU kernel: the reference decoder adds each residual and
// normalises with jnp ops that XLA fuses (src/repro/serve/engine.py:111,
// 131-135, 139 in the prefill forward; :159, 178-182 in decode). This is
// the port's counterpart of that fusion: the add that precedes every norm
// but layer 0's first (its result read only by the norm and by the next
// add) runs in the norm's launch. The norm is row-invariant, as the
// decoder needs (F7): PyTorch's CUDA reduction picks its block shape from
// the number of rows, so `x.square().mean(-1)` would sum a row in another
// order in a decode step (B rows) than in a verify chunk (B x T rows).
//
// Bound: bytes. x and y read, s and h written, gamma read: (4 M + 1) d
// elements at 3.35 TB/s, about 0.01 us at M 8, d 896 in bf16. The whole
// cost is latency: a launch and the trips to device memory. So the design
// makes one trip:
//   - a row is cut in 16-byte chunks (8 bf16 or 4 fp32 elements); thread t
//     of a block takes chunks t, t + T, ... (T threads), and issues all its
//     16-byte loads of x, y and gamma (gamma does not depend on x) before
//     any arithmetic;
//   - the row stays in registers: s is computed, rounded and stored
//     (16-byte stores) as the sum of squares runs, and h is made from the
//     same registers after the reduction; x is never read twice;
//   - one block a row, so M sets only the grid.
// The reduction has one fixed order: each thread adds its squares in
// ascending element order (each square rounded to fp32, then added), the
// warp folds by a fixed xor butterfly, and the warp sums go through shared
// memory, behind one barrier, and are added in warp order by every thread.
// The block shape, a thread's chunks and so the whole order are chosen by
// (d, dtype) alone (kernels/rowwise_rmsnorm/kernel.py `layout`): a row's
// bits never depend on M. Where d does not split into 16-byte chunks the
// scalar layout (chunks of one element) is taken, again by d alone; the
// wrapper refuses a pointer misaligned for the vector layout rather than
// take another path whose sum order would differ.
//
// Layout: x, y, s, h [M, d] row-major, of one dtype (fp32 or bf16); gamma
// [d] fp32 or bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

// N elements of E held as their raw 32-bit words (one 16-bit word for a
// single bf16), loaded with the widest access N * sizeof(E) allows
template <typename E, int N>
struct Chunk {
  static constexpr int BYTES = N * static_cast<int>(sizeof(E));
  static constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const E* p) {
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
      for (int i = 0; i < BYTES / 16; ++i) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = q.x;
        w[4 * i + 1] = q.y;
        w[4 * i + 2] = q.z;
        w[4 * i + 3] = q.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = q.x;
      w[1] = q.y;
    } else if constexpr (BYTES == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    } else {
      static_assert(BYTES == 2, "a chunk is 2, 4, 8 or 16k bytes");
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    }
  }

  // element i as fp32 (exact: bf16 is fp32's upper half)
  __device__ __forceinline__ float get(int i) const {
    if constexpr (sizeof(E) == 4) {
      return __uint_as_float(w[i]);
    } else {
      const uint32_t v = w[i >> 1];
      return __uint_as_float((i & 1) ? (v & 0xffff0000u) : (v << 16));
    }
  }
};

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v rounded to T (round to nearest even for bf16), back in fp32
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else {
    return __uint_as_float(bf16_bits(v) << 16);
  }
}

// N fp32 values stored as T at p, with the widest access the chunk allows
template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float (&v)[N]) {
  using C = Chunk<T, N>;
  uint32_t w[C::WORDS];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) w[i] = __float_as_uint(v[i]);
  } else if constexpr (N == 1) {
    w[0] = bf16_bits(v[0]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
  }
  if constexpr (C::BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < C::BYTES / 16; ++i)
      reinterpret_cast<uint4*>(p)[i] =
          make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if constexpr (C::BYTES == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (C::BYTES == 4) {
    *reinterpret_cast<unsigned int*>(p) = w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
  }
}

// One block of blockDim.x threads (a multiple of 32, at most MAX_THREADS)
// a row; VEC elements a chunk, CPT chunks a thread (the layout)
template <typename T, typename G, int VEC, int CPT, bool HAS_Y>
__global__ void __launch_bounds__(MAX_THREADS)
add_rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ y,
                 const G* __restrict__ gamma, T* __restrict__ s,
                 T* __restrict__ h, int d, float eps) {
  __shared__ float part[MAX_THREADS / 32];
  const size_t row = static_cast<size_t>(blockIdx.x) * d;
  const int nt = blockDim.x;
  const int nv = d / VEC;                  // chunks in a row
  Chunk<T, VEC> xc[CPT], yc[CPT];
  Chunk<G, VEC> gc[CPT];
  // every load first: x, y and gamma are independent of one another
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * nt;
    if (c < nv) {
      xc[k].load(x + row + static_cast<size_t>(c) * VEC);
      if constexpr (HAS_Y) yc[k].load(y + row + static_cast<size_t>(c) * VEC);
      gc[k].load(gamma + static_cast<size_t>(c) * VEC);
    }
  }
  // s, rounded to T as torch's x + y rounds it (an fp32 sum, round to
  // nearest even), stored at once; the sum of squares of the rounded s
  float v[CPT][VEC];
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * nt;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float e = 0.f;
      if (c < nv) {
        e = xc[k].get(i);
        if constexpr (HAS_Y) e = round_to<T>(__fadd_rn(e, yc[k].get(i)));
      }
      v[k][i] = e;
      acc = __fadd_rn(acc, __fmul_rn(e, e));
    }
    if constexpr (HAS_Y) {
      if (c < nv) store<T, VEC>(s + row + static_cast<size_t>(c) * VEC, v[k]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int w = 0; w < MAX_THREADS / 32; ++w)
    if (w < (nt >> 5)) tot = __fadd_rn(tot, part[w]);
  const float r = rsqrtf(__fadd_rn(__fdiv_rn(tot, static_cast<float>(d)),
                                   eps));
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * nt;
    if (c < nv) {
      float o[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] = __fmul_rn(__fmul_rn(v[k][i], r),
                         __fadd_rn(1.f, gc[k].get(i)));
      store<T, VEC>(h + row + static_cast<size_t>(c) * VEC, o);
    }
  }
}

struct Args {
  const void *x, *y, *gamma;
  void *s, *h;
  int m, d, threads;
  float eps;
  cudaStream_t stream;
};

template <typename T, typename G, int VEC, int CPT, bool HAS_Y>
int go(const Args& a) {
  add_rmsnorm_rows<T, G, VEC, CPT, HAS_Y>
      <<<a.m, a.threads, 0, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const T*>(a.y),
          static_cast<const G*>(a.gamma), static_cast<T*>(a.s),
          static_cast<T*>(a.h), a.d, a.eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename G, int VEC, int CPT>
int with_y(const Args& a) {
  return a.y ? go<T, G, VEC, CPT, true>(a) : go<T, G, VEC, CPT, false>(a);
}

template <typename T, typename G, int VEC>
int with_cpt(const Args& a, int cpt) {
  switch (cpt) {
    case 1: return with_y<T, G, VEC, 1>(a);
    case 2: return with_y<T, G, VEC, 2>(a);
    case 4: return with_y<T, G, VEC, 4>(a);
    case 8: return with_y<T, G, VEC, 8>(a);
    default: return -1;
  }
}

template <typename T, typename G>
int with_vec(const Args& a, int vec, int cpt) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  if (vec == V) return with_cpt<T, G, V>(a, cpt);
  if (vec == 1) return with_cpt<T, G, 1>(a, cpt);
  return -1;
}

template <typename T>
int with_gamma(const Args& a, int gamma_dtype, int vec, int cpt) {
  if (gamma_dtype == 0) return with_vec<T, float>(a, vec, cpt);
  if (gamma_dtype == 1) return with_vec<T, __nv_bfloat16>(a, vec, cpt);
  return -1;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Plain C entry for ctypes. y and s null for the plain norm. dtype,
// gamma_dtype: 0 = float32, 1 = bfloat16. The layout (vec elements a
// chunk, cpt chunks a thread, threads a block) is the wrapper's `layout(d,
// dtype)`, checked here against d. Launches on `stream` and returns
// cudaGetLastError() (0 = success); -1 for a shape, type or layout the
// kernel does not take, -2 for a pointer misaligned for the layout.
extern "C" int bwap_rowwise_rmsnorm(const void* x, const void* y,
                                    const void* gamma, void* s, void* h,
                                    int m, int d, float eps, int dtype,
                                    int gamma_dtype, int vec, int cpt,
                                    int threads, void* stream) {
  if (m <= 0 || d <= 0 || (y == nullptr) != (s == nullptr)) return -1;
  if (threads <= 0 || threads > MAX_THREADS || threads % 32 != 0 ||
      d % vec != 0 || static_cast<long>(threads) * cpt < d / vec ||
      static_cast<long>(threads - 32) * cpt >= d / vec)
    return -1;
  const int esize = dtype == 0 ? 4 : 2;
  const int gsize = gamma_dtype == 0 ? 4 : 2;
  const int vbytes = vec * esize;
  const int gbytes = vec * gsize < 16 ? vec * gsize : 16;
  if (!aligned(x, vbytes) || !aligned(h, vbytes) ||
      (y && (!aligned(y, vbytes) || !aligned(s, vbytes))) ||
      !aligned(gamma, gbytes))
    return -2;
  const Args a{x, y, gamma, s, h, m, d, threads, eps,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return with_gamma<float>(a, gamma_dtype, vec, cpt);
  if (dtype == 1) return with_gamma<__nv_bfloat16>(a, gamma_dtype, vec, cpt);
  return -1;
}
