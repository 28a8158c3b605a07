// Row-invariant weight product out = a @ w, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's paged decoder leaves its weight
// products to XLA (`x @ w` in src/repro/serve/engine.py). It was added
// because a GEMM library rounds a row's dot products by how many rows share
// the launch (its kernel, tiling and split-K follow M), so on a card a
// speculative verify chunk (T rows a sequence) or a `coda` micro-batch
// wrote other K/V and logits than greedy decode at the same positions, and
// the tokens could part from greedy's. Here everything that sets an output
// element's order of summation is a function of (N, K, dtype) and the
// card's SM count alone, never of M or of where a row sits in a tile:
//   - bf16 (rowwise_wgmma): the wrapper's plan(N, K) (kernels/
//     rowwise_matmul/kernel.py, no argument for M) fixes the wgmma width
//     BNI and `splits`. K is cut into BK = 64-deep steps and the steps
//     into `splits` contiguous ranges, split s taking steps [s * steps /
//     splits, (s + 1) * steps / splits). Within a split, wgmma m64nBNIk16
//     (bf16 in, fp32 accumulators) sums the steps in ascending k, 16 at a
//     time, into an accumulator that starts at zero. The splits' partials
//     are folded in ascending split index, p0 + p1 + ..., in fp32, and
//     rounded to bf16 once. Where a launch spreads a column tile's splits
//     over blocks, each writes its fp32 partial to a workspace and the
//     block that draws the tile's last ticket (an int per tile, taken
//     behind a GPU-scope fence; it sets the ticket back to 0) reads them
//     all in index order, its own in its place; where one block walks all
//     of K, it folds each split into a second set of registers as it
//     ends. The two give the same bits. No float atomics. An output
//     element comes from its row of A, its column of W and its own
//     accumulator only, so the other rows of a tile (other sequences, or
//     TMA's zeros past M) change none of its bits, and so do the tile's
//     height and width, which the launch picks by M;
//   - fp32 (rowwise_f32, as written first; it serves only the fp32
//     one-layer smoke configs): one fmaf a k, ascending, on the CUDA cores
//     (no TF32), in 32-deep steps each summed into a fresh partial that is
//     then added to the running sum; one block shape for every M.
// A row's bits therefore depend on its own values, W and K, never on M or
// on where the row sits in a tile.
//
// Bound, on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at decode (M = 8) and
// verify (M = 40) the weight's bytes (K * N * 2) outweigh the operations
// (2 M N K) at every served shape, so the kernel must stream W at the HBM
// rate; at a 256-row prefill chunk the two are close (the heads), and the
// L2's traffic to the SMs (A once a column tile, W once a row tile) is
// what the tile shape must keep down. What the bf16 design does, against
// the first version (a 32 x 64 mma.sync block a (row tile, column tile),
// no split of K, loads through registers one step ahead):
//   1. The weight is read from HBM once per launch. Tiles are numbered with
//      the row tile fastest and the grid's persistent blocks walk every
//      gridDim-th tile, so the blocks that share a W tile run side by side
//      and meet it in the L2. (The first version swept W once per 32 rows:
//      eight times at M = 256.)
//   2. Narrow, deep products fill the card. plan(N, K) takes the widest
//      BNI of 256, 128, 64 whose column tiles reach the SM count; where
//      none does, BNI = 32 and K splits so that column tiles x splits
//      reach it (or every step is a split). A launch of at most 64 rows
//      runs one such tile a block, 64 rows by BNI columns, two blocks an
//      SM up to 128 columns. (qwen2-0.5b's K/V projection ran 2 blocks on
//      132 SMs; gemma-2b's down projection 32 blocks 16384 deep.)
//   3. Wider launches take wider tiles. Over 64 rows pick() chooses among
//      64 x BNI tiles, 128 x BNI and 128 x 128 (T / BNI wgmma blocks side
//      by side, each its own accumulator chain), with the splits through
//      the workspace or in registers, by a model of its busiest SM. The
//      bf16 result leaves the accumulators through a quad transpose as
//      16-byte stores, each quad writing 64 contiguous bytes of a row.
//   4. Many bytes in flight. A producer thread issues TMA copies from two
//      2-D tensor maps (A [M, K] and W [N, K], K-major, 64-deep boxes,
//      128-byte swizzled, rows past M or N and k past K read as zeros;
//      the maps are cached per pointer and shape) into a ring of up to 12
//      stages (~96 KB where two blocks share an SM, ~200 KB else) with
//      full and empty mbarriers, and runs ahead into the next tile while
//      the consumers finish one. The consumers issue wgmma from shared
//      memory with one step's products in flight behind the next.
// On an H100 80GB HBM3 at 700 W (chip_ab.py): 1.09x / 1.08x / 1.25x
// torch.matmul at M 8 / 40 / 256 (geometric means over the served
// decoders' 15 products), at most 1.90x; the heads at 77-87 % of their
// bytes bound at M 8.
//
// Layout: a [M, K] row-major; out [M, N] row-major; w [N, K] row-major,
// the layout of a tied head's embedding table [V, d], so the vocabulary
// matrix is never copied; the decoder stores its projections so on a card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: the tensor-core instances rowwise_wgmma<BNI, T, kSolo>
// ---------------------------------------------------------------------------

constexpr int BK = 64;              // k a step: one 128-byte swizzled row
// the widest tile that can fold its splits in registers (a second set of
// accumulators, at most 32 a thread beside the first)
constexpr int FOLD_COLS = 64;

// An instance: wgmma m64nBNIk16, BNI fixed by the plan, R = T / BNI of them
// side by side in a tile of T columns, and one consumer warpgroup (kSolo:
// 64 rows a tile) then one producer warp, or two (128 rows) then a
// producer warpgroup that gives its registers to them (setmaxnreg: 232 a
// consumer thread, where the launch bound of 384 threads gives 168; a
// 256-column tile's accumulators alone are 128). Its dynamic shared memory,
// from a 1024-byte aligned base: per stage the A box [ROWS][64] then the W
// box [T][64] (each 128-byte swizzled), then the mbarriers full[STAGES],
// empty[STAGES]. A one-consumer instance of up to 128 columns keeps its
// ring within half an SM, so that two blocks share an SM; the others fill
// ~200 KB, one block an SM.
template <int BNI, int T, bool kSolo>
struct Ring {
  static_assert(T % BNI == 0 && T <= 256, "T columns: R wgmma blocks");
  static constexpr int R = T / BNI;
  static constexpr int ROWS = kSolo ? 64 : 128;
  static constexpr int NT = kSolo ? 128 : 256;   // consumer threads
  static constexpr int THREADS = NT + (kSolo ? 32 : 128);
  static constexpr int BLOCKS = kSolo && T <= 128 ? 2 : 1;   // an SM
  static constexpr int A_BYTES = ROWS * BK * 2;
  static constexpr int STAGE = A_BYTES + T * BK * 2;  // a multiple of 1024
  static constexpr int RING = BLOCKS == 2 ? 96 * 1024 : 200 * 1024;
  static constexpr int STAGES = RING / STAGE < 12 ? RING / STAGE : 12;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  // the block may fold a tile's splits in its registers
  static constexpr bool FOLD = T <= FOLD_COLS;
  // splits in flight a thread in a workspace fold (fold_partials): 4 in a
  // one-consumer instance wider than 32 columns, within the registers two
  // blocks an SM leave (the plan splits only 32-column tiles)
  static constexpr int FOLD_S = kSolo && T > 32 ? 4 : 8;
  static __device__ uint32_t full(uint32_t bars, int st) {
    return bars + 8 * st;
  }
  static __device__ uint32_t empty(uint32_t bars, int st) {
    return bars + 8 * (STAGES + st);
  }
};

// one box of a 2-D tensor map into shared memory, signalling `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// the first K step of split s (split s ends where split s + 1 begins)
__device__ __forceinline__ int split_lo(int s, int steps, int splits) {
  return static_cast<int>(static_cast<long long>(s) * steps / splits);
}

// Tile t of a launch: row tile t % m_tiles, then split (`per` a column
// tile: the splits where they go through the workspace, else 1), then
// column tile.
struct Tile {
  int mt, s, nt;
  __device__ Tile(int t, int m_tiles, int per)
      : mt(t % m_tiles), s(t / m_tiles % per), nt(t / m_tiles / per) {}
};

__device__ __forceinline__ float4 add4(float4 v, float4 u) {
  return make_float4(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y),
                     __fadd_rn(v.z, u.z), __fadd_rn(v.w, u.w));
}

// Out[rows r0.., columns n0..] of one tile from its `splits` partials in
// the workspace ([split][m][n] fp32), summed in ascending split index and
// rounded once. Each of the NT threads takes 2 float4 column groups at a
// time and keeps up to 2 x S loads in flight (the partials lie in the L2).
template <int NT, int S>
__device__ __forceinline__ void fold_partials(
    const float* __restrict__ ws, __nv_bfloat16* __restrict__ out, int m,
    int n, int splits, int r0, int rows, int n0, int cols, int tid) {
  constexpr int E = 2;
  const int q = cols / 4;                 // float4 groups a row
  const int total = rows * q;
  const size_t part = (size_t)m * n;
  for (int e0 = tid; e0 < total; e0 += E * NT) {
    size_t at[E];
    float4 v[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = min(e0 + i * NT, total - 1);   // a repeat past the end
      at[i] = (size_t)(r0 + e / q) * n + n0 + 4 * (e % q);
    }
    for (int s0 = 0; s0 < splits; s0 += S) {
      float4 u[E][S];
#pragma unroll
      for (int j = 0; j < S; ++j)
#pragma unroll
        for (int i = 0; i < E; ++i)
          if (s0 + j < splits)
            u[i][j] = __ldcg(reinterpret_cast<const float4*>(
                ws + (s0 + j) * part + at[i]));
#pragma unroll
      for (int j = 0; j < S; ++j)
#pragma unroll
        for (int i = 0; i < E; ++i)
          if (s0 + j < splits)
            v[i] = s0 + j == 0 ? u[i][j] : add4(v[i], u[i][j]);
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (e0 + i * NT >= total) continue;
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(v[i].x, v[i].y);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(v[i].z, v[i].w);
      *reinterpret_cast<uint2*>(out + at[i]) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&p0),
                     *reinterpret_cast<const uint32_t*>(&p1));
    }
  }
}

// Among the 4 lanes of a quad (t = lane % 4), x[q] of lane t becomes
// lane q's x[t] (a 4 x 4 transpose in two shuffle stages): lane t then
// holds all 8 columns of the 8-column group whose pairs the quad held at
// index t, ready for one 16-byte store.
__device__ __forceinline__ void quad_transpose(uint32_t (&x)[4], int t) {
  const bool hi = t & 2, odd = t & 1;
  uint32_t r0 = __shfl_xor_sync(FULL, hi ? x[0] : x[2], 2);
  uint32_t r1 = __shfl_xor_sync(FULL, hi ? x[1] : x[3], 2);
  if (hi) {
    x[0] = r0;
    x[1] = r1;
  } else {
    x[2] = r0;
    x[3] = r1;
  }
  r0 = __shfl_xor_sync(FULL, odd ? x[0] : x[1], 1);
  r1 = __shfl_xor_sync(FULL, odd ? x[2] : x[3], 1);
  if (odd) {
    x[0] = r0;
    x[2] = r1;
  } else {
    x[1] = r0;
    x[3] = r1;
  }
}

// `dist`: each split of a column tile is a tile of its own, whose fp32
// partial goes to the workspace and is folded by the tile's last split to
// arrive (a ticket per (row tile, column tile)); else a block walks all of
// K for its tile and folds the splits in its registers as each ends. Both
// fold the same partials in the same order: the same bits.
template <int BNI, int T, bool kSolo>
__global__ void __launch_bounds__(Ring<BNI, T, kSolo>::THREADS,
                                  Ring<BNI, T, kSolo>::BLOCKS)
rowwise_wgmma(const __grid_constant__ CUtensorMap ta,
              const __grid_constant__ CUtensorMap tw,
              __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
              int* __restrict__ tickets, int m, int n, int k, int splits,
              int dist) {
  using L = Ring<BNI, T, kSolo>;
  constexpr int NT = L::NT;
  constexpr int R = L::R;
  extern __shared__ uint8_t rw_smem[];
  __shared__ int fold_here;
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(rw_smem)) + 1023u) &
      ~1023u;
  const uint32_t bars = base + L::BAR_OFF;
  const int m_tiles = (m + L::ROWS - 1) / L::ROWS;
  const int n_tiles = (n + T - 1) / T;
  const int steps = (k + BK - 1) / BK;
  const int per = dist ? splits : 1;
  const int tiles = m_tiles * n_tiles * per;

  if (threadIdx.x == 0) {
    wait_abandoned() = 0;
    for (int st = 0; st < L::STAGES; ++st) {
      mbar_init(L::full(bars, st), 1);
      mbar_init(L::empty(bars, st), NT / 32);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform to the compiler, so that each gets its own
  // register budget
  if (__shfl_sync(FULL, threadIdx.x >= NT, 0)) {
    // producer: one thread keeps the ring filled, tile after tile
    if constexpr (!kSolo)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == NT) {
      for (const CUtensorMap* map : {&ta, &tw})
        asm volatile("prefetch.tensormap [%0];" ::"l"(
                         reinterpret_cast<uint64_t>(map))
                     : "memory");
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Tile tl(t, m_tiles, per);
        const int lo = dist ? split_lo(tl.s, steps, splits) : 0;
        const int hi = dist ? split_lo(tl.s + 1, steps, splits) : steps;
        for (int j = lo; j < hi; ++j, ++it) {
          const int st = it % L::STAGES;
          mbar_wait<false>(L::empty(bars, st), ((it / L::STAGES) & 1) ^ 1);
          const uint32_t a_s = base + st * L::STAGE;
          mbar_expect_tx(L::full(bars, st), L::STAGE);
          tma_load_2d(a_s, &ta, L::full(bars, st), j * BK, tl.mt * L::ROWS);
          tma_load_2d(a_s + L::A_BYTES, &tw, L::full(bars, st), j * BK,
                      tl.nt * T);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw (warp-uniform to the compiler) owns rows
  // 64 cw .. 64 cw + 63 of each tile. Both always compute (a warpgroup
  // whose rows lie past M multiplies TMA's zeros), so no wgmma sits under
  // a data-dependent branch.
  if constexpr (!kSolo)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int cw = __shfl_sync(FULL, (int)threadIdx.x / 128, 0);
  const int ctid = threadIdx.x;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tl(t, m_tiles, per);
    const int row0 = tl.mt * L::ROWS + 64 * cw, n0 = tl.nt * T;
    const int s_end = dist ? tl.s + 1 : splits;
    float acc[R][BNI / 2];
    float fold[L::FOLD ? R : 1][L::FOLD ? BNI / 2 : 1];
    for (int s = dist ? tl.s : 0; s < s_end; ++s) {
      const int lo = split_lo(s, steps, splits);
      const int hi = split_lo(s + 1, steps, splits);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int i = 0; i < BNI / 2; ++i) acc[r][i] = 0.f;
      for (int j = lo; j < hi; ++j, ++it) {
        const int st = it % L::STAGES;
        mbar_wait<false>(L::full(bars, st), (it / L::STAGES) & 1);
        const uint32_t a_s = base + st * L::STAGE;
        uint64_t da = gmma_desc(a_s + cw * 64 * 128, 16, 1024);
        uint64_t dw = gmma_desc(a_s + L::A_BYTES, 16, 1024);
#pragma unroll
        for (int r = 0; r < R; ++r) keep(acc[r]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)   // ascending k, 32 bytes a step
#pragma unroll
          for (int r = 0; r < R; ++r)          // column block r: BNI rows of W
            wgmma_ss<BNI>(acc[r], da + 2 * kk, dw + r * BNI * 8 + 2 * kk,
                          j > lo || kk > 0);
        wg_commit();
        wg_wait<1>();                     // the previous step's are in
#pragma unroll
        for (int r = 0; r < R; ++r) keep(acc[r]);
        __syncwarp();
        if (j > lo && lane == 0)
          mbar_arrive(L::empty(bars, (it - 1) % L::STAGES));
      }
      wg_wait<0>();
#pragma unroll
      for (int r = 0; r < R; ++r) keep(acc[r]);
      __syncwarp();
      if (lane == 0) mbar_arrive(L::empty(bars, (it - 1) % L::STAGES));
      if constexpr (L::FOLD) {
        if (!dist) {                      // fold = p0 + p1 + ..., in order
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int i = 0; i < BNI / 2; ++i)
              fold[r][i] = s == 0 ? acc[r][i] : __fadd_rn(fold[r][i],
                                                           acc[r][i]);
        }
      }
    }
    // this thread's sums: rows ra and ra + 8, in each 8-column group g of
    // block r columns c + 8 g and c + 8 g + 1 ([r][4 g + 2 h + e])
    const bool partial = dist && splits > 1;
    const int ra = row0 + 16 * warp + lane / 4;
    const int c = n0 + 2 * (lane % 4);
    if (!partial) {
      // bf16, four 8-column groups at a time: after a quad transpose each
      // lane stores one group of its row, 16 bytes, and a quad 64
      // contiguous bytes
      __nv_bfloat16* row_a = out + (size_t)ra * n;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g0 = 0; g0 < BNI / 8; g0 += 4)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t x[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int i = 4 * (g0 + q) + 2 * h;
              float u = acc[r][i], v = acc[r][i + 1];
              if constexpr (L::FOLD) {
                if (!dist) u = fold[r][i], v = fold[r][i + 1];
              }
              const __nv_bfloat162 p = __floats2bfloat162_rn(u, v);
              x[q] = *reinterpret_cast<const uint32_t*>(&p);
            }
            quad_transpose(x, lane % 4);
            const int col = n0 + r * BNI + 8 * (g0 + lane % 4);
            // n % 8 == 0: a group is in or out
            if (ra + 8 * h < m && col < n)
              *reinterpret_cast<uint4*>(row_a + (size_t)8 * h * n + col) =
                  make_uint4(x[0], x[1], x[2], x[3]);
          }
      continue;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < BNI / 8; ++g) {
        const int col = c + r * BNI + 8 * g;  // n % 8 == 0: both in or out
        if (col >= n) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = ra + 8 * h;
          if (row < m)
            __stcg(reinterpret_cast<float2*>(
                       ws + ((size_t)tl.s * m + row) * n + col),
                   make_float2(acc[r][4 * g + 2 * h],
                               acc[r][4 * g + 2 * h + 1]));
        }
      }
    // the tile's last split to arrive folds every split's partial, in
    // ascending split index (its own in its place), and rounds once.
    // After the barrier one thread fences (acq_rel, GPU scope, cumulative
    // over the block's partial stores that the barrier ordered before it)
    // and takes the ticket; in the folding block it fences again before
    // the barrier, so that every thread's loads see every split's partial
    // (one fence a block where each thread fenced before).
    named_sync<NT>(1);
    const int tk = tl.nt * m_tiles + tl.mt;
    if (ctid == 0) {
      int drawn;
      asm volatile(
          "fence.acq_rel.gpu;\n"
          "atom.relaxed.gpu.global.add.s32 %0, [%1], 1;"
          : "=r"(drawn)
          : "l"(tickets + tk)
          : "memory");
      fold_here = drawn == splits - 1;
      if (fold_here) {
        asm volatile("fence.acq_rel.gpu;" ::: "memory");
        tickets[tk] = 0;                    // for the next launch
      }
    }
    named_sync<NT>(1);
    if (!fold_here) continue;
    const int r0 = tl.mt * L::ROWS;
    fold_partials<NT, L::FOLD_S>(ws, out, m, n, splits, r0,
                                 min(L::ROWS, m - r0), n0, min(T, n - n0),
                                 ctid);
  }
}

// 2-D map over a row-major bf16 [rows, inner]: a box is [box_rows x 64],
// 128-byte swizzled; rows past `rows` and columns past `inner` read as
// zeros. Returns 0, or -3 when the driver refuses the map.
int make_map_2d(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                int inner, int rows, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -3;
}

// make_map_2d through a small per-thread cache: a map is a function of
// (pointer, rows, inner, box rows) alone, and the decoder passes the same
// weights, and from PyTorch's caching allocator often the same activation
// buffers, step after step.
int cached_map_2d(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                  int inner, int rows, int box_rows) {
  struct Entry {
    const void* ptr;
    int inner, rows, box_rows;
    CUtensorMap map;
  };
  static thread_local Entry cache[256];
  const uintptr_t h = reinterpret_cast<uintptr_t>(ptr);
  Entry& e = cache[(h >> 8 ^ h >> 16 ^ (uintptr_t)rows * 31 ^
                    (uintptr_t)box_rows) & 255];
  if (e.ptr == ptr && e.inner == inner && e.rows == rows &&
      e.box_rows == box_rows) {
    *map = e.map;
    return 0;
  }
  const int r = make_map_2d(enc, map, ptr, inner, rows, box_rows);
  if (r == 0) e = Entry{ptr, inner, rows, box_rows, *map};
  return r;
}

struct Args {
  const void *a, *w;
  void* out;
  int m, n, k, splits, sms;
  float* ws;
  long long ws_floats;
  int* tickets;
  long long n_tickets;
  cudaStream_t stream;
};

template <int BNI, int T, bool kSolo>
int launch_wgmma(const Args& x, int dist) {
  using L = Ring<BNI, T, kSolo>;
  const long long m_tiles = (x.m + L::ROWS - 1) / L::ROWS;
  const long long n_tiles = (x.n + T - 1) / T;
  const long long tiles = m_tiles * n_tiles * (dist ? x.splits : 1);
  if (tiles > INT_MAX) return -1;
  if (!L::FOLD && !dist && x.splits > 1) return -4;
  if (dist && x.splits > 1 &&
      (x.ws == nullptr || x.tickets == nullptr ||
       x.ws_floats < (long long)x.splits * x.m * x.n ||
       x.n_tickets < m_tiles * n_tiles))
    return -4;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -2;
  CUtensorMap ta, tw;
  if (cached_map_2d(enc, &ta, x.a, x.k, x.m, L::ROWS) ||
      cached_map_2d(enc, &tw, x.w, x.k, x.n, T))
    return -3;
  auto kern = rowwise_wgmma<BNI, T, kSolo>;
  // the shared-memory limit is raised once a device (a bit per device)
  static unsigned long long raised = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !(raised >> dev & 1)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised |= 1ull << dev;
  }
  const long long slots = (long long)x.sms * L::BLOCKS;
  const int grid = (int)(tiles < slots ? tiles : slots);
  kern<<<grid, L::THREADS, L::BYTES, x.stream>>>(
      ta, tw, static_cast<__nv_bfloat16*>(x.out), x.ws, x.tickets, x.m, x.n,
      x.k, x.splits, dist);
  return (int)cudaGetLastError();
}

// A launch of more than 64 rows picks its tile: 128 rows (two consumer
// warpgroups, one block an SM) by BNI or 128 columns (256 where BNI is),
// or 64 rows by BNI columns (one consumer warpgroup, two blocks an SM up
// to 128 columns); and where the splits
// fold (dist: through the workspace, a tile a split; else in a block's
// registers). It takes the least time by a model of its busiest SM: each
// round of tiles takes the longer of the tile's bytes (A once a column
// tile, W once a row tile, the partials written and read) at the block's
// share of an SM's L2 read rate and its K steps at the least a step takes,
// plus a fold's dependent L2 round trips and a tile's fixed cost. The
// constants were fitted on the H100 (chip_ab.py --plans: the served
// decoders' products at M 256, every tile; the pick within 11 % of the
// best tile at each). None of it changes an element's order of
// summation. A launch of at most 64 rows takes 64 x BNI tiles, its splits
// through the workspace.
struct Shape {
  int rows, t, dist;
};

constexpr double SM_BYTES_PER_US = 75e3;    // an SM's L2 read rate
constexpr double STEP_US = 0.35;            // the least a K step takes
constexpr double ROUND_TRIP_US = 1.0;       // an L2 round trip in a fold
constexpr double TILE_US = 1.0;             // a tile's start and epilogue

Shape pick(int bni, const Args& x) {
  if (x.m <= 64) return {64, bni, x.splits > 1};
  const double a_b = 2.0 * x.m * x.k, w_b = 2.0 * x.n * x.k;
  const int steps = (x.k + BK - 1) / BK;
  Shape best{64, bni, x.splits > 1};
  double best_us = -1.0;
  for (const int rows : {64, 128}) {
    // an SM's blocks (two of 64 rows where the tile is at most 128 wide)
    const int per_sm = rows == 64 && bni <= 128 ? 2 : 1;
    const long long m_t = (x.m + rows - 1) / rows;
    for (const int t : {bni, rows == 128 && bni < 128 ? 128 : bni}) {
      for (int dist = 0; dist <= 1; ++dist) {
        if (dist == 0 && t > FOLD_COLS && x.splits > 1) continue;
        if (dist == 1 && x.splits == 1) continue;
        const long long n_t = (x.n + t - 1) / t;
        const long long tiles = m_t * n_t * (dist ? x.splits : 1);
        const long long rounds =
            (tiles + (long long)x.sms * per_sm - 1) / (x.sms * per_sm);
        double bytes = a_b * n_t + w_b * m_t, fold_us = 0.0;
        if (dist) {
          bytes += 8.0 * x.splits * x.m * x.n;
          // fold_partials: 2 groups of 4 columns a thread, and FOLD_S
          // splits of each in flight
          const int at_once = 2 * (rows == 64 ? 128 : 256);
          const int s = rows == 64 && t > 32 ? 4 : 8;
          const long long groups = (long long)rows * t / 4;
          fold_us = ROUND_TRIP_US * ((groups + at_once - 1) / at_once) *
                    ((x.splits + s - 1) / s);
        }
        const double tile_us =
            std::max(bytes / tiles / (SM_BYTES_PER_US / per_sm),
                     STEP_US * steps / (dist ? x.splits : 1));
        const double us = rounds * (tile_us + fold_us + TILE_US);
        if (best_us < 0.0 || us < best_us)
          best = {rows, t, dist}, best_us = us;
      }
    }
  }
  return best;
}

// a shape pick() must return (rows > 0), for measuring the others
Shape forced{0, 0, 0};

template <int BNI>
int launch_width(const Args& x) {
  const int steps = (x.k + BK - 1) / BK;
  if (x.splits < 1 || x.splits > steps || x.sms < 1) return -4;
  const Shape sh = forced.rows > 0 && x.m > 64 ? forced : pick(BNI, x);
  if (sh.rows == 64)
    return sh.t == BNI ? launch_wgmma<BNI, BNI, true>(x, sh.dist) : -4;
  if (sh.t == BNI) return launch_wgmma<BNI, BNI, false>(x, sh.dist);
  if constexpr (BNI < 128)
    if (sh.t == 128) return launch_wgmma<BNI, 128, false>(x, sh.dist);
  return -4;
}

// ---------------------------------------------------------------------------
// fp32: rowwise_f32
// ---------------------------------------------------------------------------

// a thread a column, FBM rows of accumulators, one fmaf a k
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

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16. bf16 takes
// the plan (bn: 64, 128 or 256; splits: 1 .. ceil(K / 64)) from the
// wrapper, the card's SM count (the persistent grid), and with splits > 1
// a workspace of at least splits * m * n floats and ceil(m / 128) *
// ceil(n / bn) tickets, all 0 (each launch leaves them 0); fp32 ignores
// them. Launches on `stream` and returns cudaGetLastError() (0 =
// success); -1 for a shape, type or alignment the kernel does not take
// (bf16: N and K multiples of 8, 16-byte aligned pointers), -2 when the
// driver has no cuTensorMapEncodeTiled, -3 when it refuses a tensor map,
// -4 for a plan or workspace the launch cannot run.
extern "C" int bwap_rowwise_matmul(const void* a, const void* w, void* out,
                                   int m, int n, int k, int dtype, int bn,
                                   int splits, int sms, void* ws,
                                   long long ws_floats, void* tickets,
                                   long long n_tickets, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a) |
                           reinterpret_cast<uintptr_t>(w) |
                           reinterpret_cast<uintptr_t>(out);
    if (n % 8 || k % 8 || (ptrs & 15)) return -1;
    const Args x{a, w, out, m, n, k, splits, sms, static_cast<float*>(ws),
                 ws_floats, static_cast<int*>(tickets), n_tickets, s};
    switch (bn) {
      case 32: return launch_width<32>(x);
      case 64: return launch_width<64>(x);
      case 128: return launch_width<128>(x);
      case 256: return launch_width<256>(x);
      default: return -4;
    }
  }
  if (dtype != 0) return -1;
  const dim3 grid((n + FBN - 1) / FBN, (m + FBM - 1) / FBM);
  if (grid.y > 65535) return -1;
  rowwise_f32<<<grid, FBN, 0, s>>>(static_cast<const float*>(a),
                                   static_cast<const float*>(w),
                                   static_cast<float*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the bf16 instance of wgmma width bn at its
// one-consumer shape (solo = 1: 64 rows, bn columns a tile) or at its
// two-consumer shape of `cols` columns (-1: none built).
extern "C" int bwap_rowwise_smem_bytes(int bn, int solo, int cols) {
  if (solo) {
    switch (bn) {
      case 32: return Ring<32, 32, true>::BYTES;
      case 64: return Ring<64, 64, true>::BYTES;
      case 128: return Ring<128, 128, true>::BYTES;
      case 256: return Ring<256, 256, true>::BYTES;
      default: return -1;
    }
  }
  switch (bn * 1000 + cols) {
    case 32032: return Ring<32, 32, false>::BYTES;
    case 32128: return Ring<32, 128, false>::BYTES;
    case 64064: return Ring<64, 64, false>::BYTES;
    case 64128: return Ring<64, 128, false>::BYTES;
    case 128128: return Ring<128, 128, false>::BYTES;
    case 256256: return Ring<256, 256, false>::BYTES;
    default: return -1;
  }
}

// Makes every later launch of more than 64 rows take tiles of `rows` x
// `cols` and fold through the workspace (dist = 1) or in registers (0);
// rows = 0 returns to pick(). For measuring the tiles pick() does not
// take (chip_ab.py --plans); a launch no instance can run fails (-4).
extern "C" void bwap_rowwise_force_shape(int rows, int cols, int dist) {
  forced = Shape{rows, cols, dist};
}
