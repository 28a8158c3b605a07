// Hopper (sm_90a) machinery shared by the port's tensor-core kernels: the
// attention kernels (through wgmma_attention.cuh) and the row-invariant
// weight product (rowwise_matmul.cu). mbarriers and their waits, wgmma
// shared-memory descriptors, issue, fences and waits, named barriers over two
// consumer warpgroups, and, on the host, cuTensorMapEncodeTiled from the
// driver. kernels/build.py hashes every header into every library's name.

#pragma once

#include <cuda.h>           // CUtensorMap and its enums: types only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
// arrive, and expect `bytes` more from the copies that signal this barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// set once a wait of this block has given up (mbar_wait<false>); a kernel
// that waits so clears it before its first wait
__device__ __forceinline__ int& wait_abandoned() {
  __shared__ int flag;
  return flag;
}

// spin until the phase of parity `parity` has completed. A wait that
// outlasts ~2^34 cycles (seconds) ends the launch instead of holding the
// card: with kTrap by a trap, an error the host sees at its next sync; else
// by giving up, and every later wait of the block gives up at once, so the
// launch ends with wrong output that any check against the plain version
// catches. WgLayout<H>::TRAP picks: a trap anywhere in the H = 256
// instances makes ptxas serialise their wgmma ("insufficient register
// resources", C7512) and spill, so they give up instead.
template <bool kTrap>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if constexpr (kTrap) {
      if (!done && clock64() - t0 > (1ll << 34)) __trap();
    } else if (!done && (*static_cast<volatile int*>(&wait_abandoned()) ||
                         clock64() - t0 > (1ll << 34))) {
      wait_abandoned() = 1;
      break;
    }
  }
}

// wgmma shared-memory matrix descriptor for a 128-byte swizzled operand:
// start address, leading and stride byte offsets (stored in 16-byte units)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N committed wgmma groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define ACC32_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"
#define ACC32_OPERANDS(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),    \
      "+f"(d[30]), "+f"(d[31])

#define ACC24_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23}"
#define ACC24_OPERANDS(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),             \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),         \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),    \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])

// the "+f" operands of eight accumulator registers d[i] .. d[i + 7]
#define ACC8(d, i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

#define ACC16_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define ACC16_OPERANDS(d) ACC8(d, 0), ACC8(d, 8)

#define ACC64_LIST                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define ACC64_OPERANDS(d)                                                 \
  ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), \
  ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)

#define ACC128_LIST                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"
#define ACC128_OPERANDS(d)                                                \
  ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), \
  ACC8(d, 32), ACC8(d, 40), ACC8(d, 48), ACC8(d, 56), \
  ACC8(d, 64), ACC8(d, 72), ACC8(d, 80), ACC8(d, 88), \
  ACC8(d, 96), ACC8(d, 104), ACC8(d, 112), ACC8(d, 120)

// d (+)= A B for A [64 x 16] and B [16 x N], both bf16 in shared memory,
// K-major; d = A B when `accumulate` is 0. N = 48, 64: the attention
// kernels' S tiles; N = 32, 64, 128, 256: the weight product's tiles.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 48 || N == 64 || N == 128 || N == 256,
                "wgmma_ss takes N = 32, 48, 64, 128 or 256");
  if constexpr (N == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
        ", %32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC32_OPERANDS(d)
        : "l"(da), "l"(db), "r"(accumulate));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 " ACC24_LIST
        ", %24, %25, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC24_OPERANDS(d)
        : "l"(da), "l"(db), "r"(accumulate));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " ACC16_LIST
        ", %16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC16_OPERANDS(d)
        : "l"(da), "l"(db), "r"(accumulate));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC64_LIST
        ", %64, %65, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC64_OPERANDS(d)
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " ACC128_LIST
        ", %128, %129, p, 1, 1, 0, 0;\n"
        "}\n"
        : ACC128_OPERANDS(d)
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// named barriers over the consumer warpgroups (N threads: two by default)
template <int N = 256>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(N) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
