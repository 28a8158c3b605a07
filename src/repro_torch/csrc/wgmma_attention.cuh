// The tensor-core attention machinery shared by the flash kernel
// (flash_attention.cu) and the paged kernel (paged_attention.cu), for Hopper
// (sm_90a): the K/V ring's shared-memory layout and mbarriers, the S and
// P V issue (the generic mbarrier, descriptor and wgmma helpers are in
// sm90.cuh), the online softmax in the wgmma accumulator layout,
// P as a hi/lo bf16 pair, and the consumer warpgroups' pipelined walk over
// the ring, at every head dim of the tensor-core instances (64, 128, 256).
// Each kernel brings its own producer (TMA for flash, cp.async page gathers
// for paged) and its own online softmax (softmax_tile) with its mask
// written inline: with the mask passed in as a functor, ptxas
// scheduled the flash kernel's softmax otherwise, and the kernel ran
// measurably slower at S = 32768 on the H100. kernels/build.py hashes every
// header into every library's name.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float NEG_INF = -2.0e38f;

constexpr int WQ = 128;                // query rows per block
constexpr int WG_THREADS = 384;        // producer warpgroup + two consumers
constexpr int CHUNK = 64;              // bf16 of one 128-byte swizzled row
constexpr int ROW_BYTES = 128;
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory of the H instance, from a 1024-byte aligned base:
// Q as H/64 chunks of [WQ][64], then per stage K and V as H/64 chunks of
// [WK][64] (each chunk one TMA box, 128-byte swizzled), then the mbarriers:
// q_full, full_k[STAGES], full_v[STAGES], empty[STAGES].
//
// The tile width WK is the instance's: 64 keys at H = 64, 128 and 48 at
// H = 256, as FlashAttention-3 narrows its key tile at head dim 256. At
// H = 256 the O accumulator alone is 128 fp32 registers a consumer thread,
// and a 64-key tile's S (32) and hi/lo P pair (32) beside it, with the next
// S in flight, leave too few; a 48-key tile takes 24 for S (wgmma
// m64n48k16) and 24 for the pair, so the walk is pipelined at every head
// dim. Its K or V tile is 24 KB, and the ring holds 3 stages beside Q's
// 64 KB (208 KB). On the H100, 48 keys ran the flash instance faster than
// 32 (4 stages) or 64 (2 stages), and the paged one slightly faster than
// 32.
template <int H>
struct WgLayout {
  static constexpr int NC = H / CHUNK;
  static constexpr int WK = H == 256 ? 48 : 64;   // keys per tile
  // K/V ring depth: as deep as shared memory allows
  static constexpr int STAGES = H == 64 ? 6 : H == 128 ? 4 : 3;
  // how a wait that never completes ends the launch (mbar_wait)
  static constexpr bool TRAP = H <= 128;
  // tiles in a key chunk of the paged kernel (chunk j holds tiles
  // j*CH .. j*CH + CH - 1 at absolute positions: 256 keys at H = 64, 512
  // at H = 128, 384 at H = 256); the flash kernel has none. Fewer tiles
  // split decode finer; more fold less often on the serial route, whose
  // fold moves H / 2 floats a thread through the L2. On the H100, 4 kept
  // H = 64 prefill within 9 % of the walk without chunks (8: 25 % at
  // B = 1), and 8 kept H = 256 prefill within 13 % (4: 31 %).
  static constexpr int CH = H == 64 ? 4 : 8;
  static constexpr int Q_BYTES = WQ * H * 2;
  static constexpr int KV_BYTES = WK * H * 2;     // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  // mbarrier addresses of stage st, from the barriers' base
  static __device__ uint32_t full_k(uint32_t bars, int st) {
    return bars + 8 * (1 + st);
  }
  static __device__ uint32_t full_v(uint32_t bars, int st) {
    return bars + 8 * (1 + STAGES + st);
  }
  static __device__ uint32_t empty(uint32_t bars, int st) {
    return bars + 8 * (1 + 2 * STAGES + st);
  }
};


// d += A B for A [64 x 16] bf16 in registers (four bf16 pairs a thread, the
// accumulator layout of S) and B [16 x 64] bf16 in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC32_OPERANDS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// 2^x (the MUFU approximation; -inf -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}


__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Per-thread state of a consumer: the thread holds rows a and b (8 apart)
// of its warpgroup's 64, whose query positions are qa and qb; in each 8-key
// group of a tile, keys kc and kc + 1. A WK-key tile of S is WK / 2
// registers a thread: s[4n + e] holds key 8n + kc + (e & 1) of row a
// (e < 2) or b.
struct Rows {
  int qa, qb, kc;
  float m_a, m_b, l_a, l_b;     // running max (log2 units) and sum
};

// S = Q K^T for one WK-key tile, 16 dims a step (issued, committed)
template <int H, int WK>
__device__ __forceinline__ void issue_qk(float (&s)[WK / 2], uint64_t dq,
                                         uint64_t dk) {
#pragma unroll
  for (int e = 0; e < WK / 2; ++e) s[e] = 0.f;
  keep(s);
  // at H = 256 the compiler hoisted the 16 steps' Q descriptors out of the
  // tile loop, and the paged instance spilled; derived per tile they don't
  if constexpr (H > 128) asm volatile("" : "+l"(dq));
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    // chunk kk / 4 of the row, 32 bytes a step within its 128 bytes
    const uint32_t off = (kk % 4) * 2;            // 16-byte units
    wgmma_ss<WK>(s, dq + (kk / 4) * (WQ * ROW_BYTES / 16) + off,
                 dk + (kk / 4) * (WK * ROW_BYTES / 16) + off, kk > 0);
  }
  wg_commit();
}

// O += P_hi V + P_lo V for one WK-key tile, 16 keys a step (issued,
// committed)
template <int NC, int WK>
__device__ __forceinline__ void issue_pv(float (&o)[NC][32],
                                         const uint32_t (&ph)[WK / 4],
                                         const uint32_t (&pl)[WK / 4],
                                         uint64_t dv) {
#pragma unroll
  for (int j = 0; j < NC; ++j) keep(o[j]);
  wg_fence();
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      const uint64_t d = dv + (j * WK * ROW_BYTES + kk * 16 * ROW_BYTES) / 16;
      wgmma_rs(o[j], ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2],
               ph[4 * kk + 3], d);
      wgmma_rs(o[j], pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2],
               pl[4 * kk + 3], d);
    }
  wg_commit();
}

// p (fp32) -> the hi/lo bf16 pair, the A operand of P V: pair r holds
// p[2r], p[2r+1] (row a for even r, b for odd), register r % 4 of key step
// r / 4. Then O = O * alpha, ready for the tile's P V.
template <int NC, int WK>
__device__ __forceinline__ void stage_p(const float (&s)[WK / 2],
                                        uint32_t (&ph)[WK / 4],
                                        uint32_t (&pl)[WK / 4],
                                        float (&o)[NC][32], float al_a,
                                        float al_b) {
#pragma unroll
  for (int r = 0; r < WK / 4; ++r) {
    const __nv_bfloat162 hi = __floats2bfloat162_rn(s[2 * r], s[2 * r + 1]);
    const float2 hf = __bfloat1622float2(hi);
    ph[r] = bf16x2_bits(hi);
    pl[r] = bf16x2_bits(__floats2bfloat162_rn(__fsub_rn(s[2 * r], hf.x),
                                              __fsub_rn(s[2 * r + 1], hf.y)));
  }
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[j][4 * n] = __fmul_rn(o[j][4 * n], al_a);
      o[j][4 * n + 1] = __fmul_rn(o[j][4 * n + 1], al_a);
      o[j][4 * n + 2] = __fmul_rn(o[j][4 * n + 2], al_b);
      o[j][4 * n + 3] = __fmul_rn(o[j][4 * n + 3], al_b);
    }
}

// The default chunk_end of consume_pipelined: no hook.
struct NoChunkEnd {
  template <int NC>
  __device__ __forceinline__ void operator()(float (&)[NC][32], int) const {}
};

// The walk of consumer warpgroup cw (of two) over tiles 0 .. n_tiles - 1 of
// the K/V ring, n_tiles >= 1, at the instance's tile width WgLayout<H>::WK.
// The products S(i+1) = Q K(i+1)^T and O += P(i) V(i) are issued together,
// and the softmax of tile i+1 runs while they (and the other warpgroup's)
// do, as in FlashAttention-3, at every head dim. The two
// warpgroups take turns to issue (named barriers 1 and 2), so that one's
// softmax runs beside the other's products. `softmax(s, i, al_a, al_b)` is
// the online softmax of tile i under the kernel's mask. With
// kProxyFence each wait for a full stage is followed by a proxy fence: a
// producer's cp.async writes shared memory through the generic proxy, which
// wgmma reads through the async proxy (TMA writes need none).
// `chunk_end(o, i)` runs once O += P(i) V(i) is in and before the next
// tile's rescale of O, with no wgmma in flight: the paged kernel may fold a
// finished key chunk there (the flash kernel passes no hook). kSolo: only
// this warpgroup walks (the block's other consumer warpgroup has no real
// row), so there are no turns to take.
template <int H, bool kProxyFence, bool kSolo = false, class Softmax,
          class ChunkEnd = NoChunkEnd>
__device__ __forceinline__ void consume_pipelined(
    float (&o)[H / CHUNK][32], uint64_t dq, uint32_t k_s, uint32_t v_s,
    uint32_t bars, int n_tiles, int cw, int lane, Softmax softmax,
    ChunkEnd chunk_end = {}) {
  using L = WgLayout<H>;
  constexpr int NC = L::NC, WK = L::WK;
  float s[WK / 2], al_a, al_b;
  uint32_t ph[WK / 4], pl[WK / 4];
  // descriptors of stage st, derived per use so that the compiler does not
  // keep every step's in registers
  auto dk_of = [&](int st) {
    uint64_t d = gmma_desc(k_s + st * L::KV_BYTES, 16, 1024);
    asm volatile("" : "+l"(d));
    return d;
  };
  auto dv_of = [&](int st) {
    uint64_t d = gmma_desc(v_s + st * L::KV_BYTES, WK * ROW_BYTES, 1024);
    asm volatile("" : "+l"(d));
    return d;
  };
  auto wait_full = [&](uint32_t bar, uint32_t parity) {
    mbar_wait<L::TRAP>(bar, parity);
    if constexpr (kProxyFence)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };
  const int my_turn = 1 + cw, other_turn = 2 - cw;
  auto take_turn = [&] {
    if constexpr (!kSolo) named_sync(my_turn);
  };
  auto pass_turn = [&] {
    if constexpr (!kSolo) named_arrive(other_turn);
  };
  if (!kSolo && cw == 1) named_arrive(1);   // warpgroup 0 goes first
  wait_full(L::full_k(bars, 0), 0);
  take_turn();
  issue_qk<H, WK>(s, dq, dk_of(0));
  pass_turn();
  wg_wait<0>();
  keep(s);
  softmax(s, 0, al_a, al_b);
  stage_p<NC, WK>(s, ph, pl, o, al_a, al_b);
  for (int i = 0; i + 1 < n_tiles; ++i) {
    const int st = i % L::STAGES, nx = (i + 1) % L::STAGES;
    wait_full(L::full_k(bars, nx), ((i + 1) / L::STAGES) & 1);
    wait_full(L::full_v(bars, st), (i / L::STAGES) & 1);
    take_turn();
    issue_qk<H, WK>(s, dq, dk_of(nx));
    issue_pv<NC, WK>(o, ph, pl, dv_of(st));
    pass_turn();
    wg_wait<1>();                           // S(i+1) is in
    keep(s);
    softmax(s, i + 1, al_a, al_b);
    wg_wait<0>();                           // O += P(i) V(i) is in
#pragma unroll
    for (int j = 0; j < NC; ++j) keep(o[j]);
    __syncwarp();
    if (lane == 0) mbar_arrive(L::empty(bars, st));
    chunk_end(o, i);
    stage_p<NC, WK>(s, ph, pl, o, al_a, al_b);
  }
  const int st = (n_tiles - 1) % L::STAGES;
  wait_full(L::full_v(bars, st), ((n_tiles - 1) / L::STAGES) & 1);
  take_turn();
  issue_pv<NC, WK>(o, ph, pl, dv_of(st));
  pass_turn();
  wg_wait<0>();
#pragma unroll
  for (int j = 0; j < NC; ++j) keep(o[j]);
  __syncwarp();
  if (lane == 0) mbar_arrive(L::empty(bars, st));
  chunk_end(o, n_tiles - 1);
  // warpgroup 0 takes the turn that warpgroup 1 passed after its last
  // issue, so that no barrier is left half arrived
  if (!kSolo && cw == 0) named_sync(1);
}

}  // namespace
