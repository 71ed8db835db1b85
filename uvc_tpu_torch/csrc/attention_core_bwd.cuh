// The backward of the bare attention core for Hopper: kernels A8
// (uvc_tpu/ops/attention.py::_bwd_ctx_kernel) and A9's backward
// (::_bwd_kernel), on [B, H, N, dh] operands at any strides.  Only
// attention_core.cu includes it; the sublayer backwards of attention.cu
// (A2, A7) keep the mma.sync core of attention_core.cuh.
//
// Numerics: the Pallas bodies' rounding order, as attention_bwd_ctx_plain
// in uvc_tpu_torch/ops/attention.py writes it: logits = (q . k^T) * scale
// in f32, probs = p / s in f32 with p = exp(logit - max), ctx =
// bf16(probs) . V, row = sum(dp * probs) with dp = dO . V^T,
// ds = bf16(probs * (dp - row)), dq = ds . K * scale, dv = bf16(probs)^T .
// dO, dk = ds^T . Q * scale; f32 accumulators, one rounding to bf16 per
// output.  Two changes of order, both in f32: (max, s) come from one pass
// over 64-key tiles, the running sum rescaled by 2^(old max - new max)
// when a tile raises the max (the online softmax), where the Pallas kernel
// takes the max first and sums after it; and p / s is evaluated as
// 2^(logit * log2 e - max) * (1 / s) (MUFU.EX2 and one reciprocal per row,
// the max kept in base 2), a few instructions per element where expf and
// a division take several times as many.
//
// Design.  Two launches, no float atomics, each output tile written by one
// CTA (two launches give the same bits):
//   core_bwd_q_wg_kernel, one CTA per (64-query tile, head, image): three
//     passes over the 64-key tiles: (max, s) online; row = sum(dp * probs)
//     and, for A8, ctx = bf16(probs) . V; ds and dq = ds . K.  Writes dq,
//     ctx and (max * log2 e, 1 / s, row) per query.
//   core_bwd_kv_wg_kernel, one CTA per (64-key tile, head, image): one
//     pass over the 64-query tiles with those statistics: the transposed
//     logits K . Q^T and dp^T = V . dO^T, dv += bf16(probs^T) . dO and
//     dk += ds^T . Q.
// One warpgroup (four warps) does the arithmetic with wgmma, 64 rows at a
// time: S and dp from shared memory (m64n64k16, both operands K-major);
// ctx, dq, dv and dk from registers (m64nDHPk16), their A operand the
// accumulator of S or dp converted to bf16 in place (the accumulator's
// layout is wgmma's register layout of A), their B operand the streamed
// tile read along its rows (MN-major).  The other side's rows stream
// through a ring of two stages of 64-row tiles, the next tile in flight
// while the warpgroup works on the current one, so a CTA's shared memory
// does not depend on N: 62.5 KB (query side) and 64.5 KB (key side) at
// head dim 80.  The query side fits 168 registers a thread and runs three
// CTAs (twelve warps) per SM, the key side, with two m64n80 accumulators
// held across its loop, two (eight warps).  A third stage on either side,
// or three key-side CTAs in 168 registers (which spill), ran no faster on
// the H100.
//
// Shared-memory tiles: 16-column boxes of 64 rows x 32 bytes in the
// 32-byte swizzle (the 16-byte halves of a row swapped on rows 4-7 of
// every 8), which TMA writes and wgmma reads as its B32 layout; a head of
// 80 is five boxes, so no head dim needs the 128-byte swizzle's 64-column
// rows.  Loads: TMA (cp.async.bulk.tensor, completion on an mbarrier) when
// every operand is a full tile (dh equal to the padded head dim, 16-byte
// strides and base: A8's head views of the qkv rows, A9's contiguous heads
// of 16-80); otherwise cp.async into the same layout at the widest copy
// the operands allow (16 or 4 bytes; at an odd head dim, aligned 4-byte
// loads shifted into place), the columns past dh and the rows past N
// zero-filled, as TMA fills rows past N.  The columns past dh add zero to
// every product.
#pragma once

#include <cuda.h>

#include <utility>

#include "attention_core.cuh"

namespace uvc {

constexpr int BWD_T = 64;                       // rows of a tile
constexpr int BWD_BOX = BWD_T * 16 * 2;         // bytes of a 16-column box
constexpr int BWD_STAGES = 2;                   // the streamed ring
constexpr int BWD_STAT_BYTES = BWD_T * 16;      // a tile's (max, 1/s, row, 0)
constexpr float LOG2E = 1.4426950408889634f;

// 2^x (MUFU.EX2, relative error below 2^-22; results below 2^-126 flush
// to zero)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of element (r, c) in a tile of 16-column boxes, 32-byte
// swizzle (bit 4 of the address XOR bit 7)
__device__ __forceinline__ int tile_off(int r, int c) {
  return (c >> 4) * BWD_BOX + r * 32 + ((((c >> 3) ^ (r >> 2)) & 1) << 4) +
         ((c & 7) << 1);
}

// ---------------------------------------------------------------------------
// mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of `parity` to complete.  A transfer that never
// lands (a byte count that disagrees with the copies) traps after about
// two seconds instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// a box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes (16-byte aligned) into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// makes this thread's generic-proxy writes to shared memory (stores,
// cp.async) visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// after wg_wait: the accumulators' values are read from here on, not
// earlier
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, layout B32: start address, leading and
// stride byte offsets
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (3ull << 62);
}

// a tile as a K-major operand (its rows along M or N, the head dim along
// K), head-dim columns 16 kk .. 16 kk + 15: box kk, 8-row groups 256 bytes
// apart
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile,
                                                int kk) {
  return gmma_desc(tile + kk * BWD_BOX, 16, 256);
}

// a tile as the MN-major B operand (its rows along K, the head dim along
// N), rows 16 s .. 16 s + 15: 16-column boxes BWD_BOX apart along N,
// 8-row groups 256 bytes apart along K
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile,
                                                 int s) {
  return gmma_desc(tile + s * 512, BWD_BOX, 256);
}

// d (+)= A . B^T for a 64-row A and a 64-row B, both K-major in shared
// memory (m64n64k16); acc = 0 overwrites d
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                          uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (+)= A . B, A (64 x 16) in registers (four bf16 pairs per thread, the
// accumulator layout of the product that made it), B (16 x N) MN-major in
// shared memory (m64nNk16); acc = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int acc);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---------------------------------------------------------------------------
// tiles
// ---------------------------------------------------------------------------

// One operand as a TMA tensor map: 4-d, the head dim innermost, then row,
// head and batch in the order of their strides; slot[0..2] is the
// coordinate position (1..3) of row, head and batch.
struct TileMap {
  CUtensorMap map;
  int slot[3];
};

struct CoreMaps {
  TileMap q, k, v, dout;
};

// rows row0 .. row0 + 63 of head (b, h) by TMA, one box per 16 columns;
// one thread issues it
template <int DHP>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const TileMap& tm,
                                         uint64_t* bar, int b, int h,
                                         int row0) {
  auto at = [&](int pos) {
    return tm.slot[0] == pos ? row0 : tm.slot[1] == pos ? h : b;
  };
  const int c1 = at(1), c2 = at(2), c3 = at(3);
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk)
    tma_load_4d(dst + kk * BWD_BOX, &tm.map, bar, kk * 16, c1, c2, c3);
}

// the same rows by cp.async, vec (8 or 2) elements per copy, or with
// vec == 1 by loads and stores (done when this returns), the columns past
// dh and the rows past n zero-filled; every thread takes part
template <int DHP>
__device__ __forceinline__ void async_tile(unsigned char* dst,
                                           const InHeads& x, int b, int h,
                                           int row0, int n, int dh, int vec,
                                           int tid) {
  const bf16* src = x.head(b, h);
  if (vec == 8) {
    for (int i = tid; i < BWD_T * (DHP / 8); i += CORE_THREADS) {
      const int r = i / (DHP / 8), c = (i % (DHP / 8)) * 8, gr = row0 + r;
      const bool ok = gr < n && c < dh;
      cp_async16(dst + tile_off(r, c), src + (ok ? gr * x.sr + c : 0), ok);
    }
  } else if (vec == 2) {
    for (int i = tid; i < BWD_T * (DHP / 2); i += CORE_THREADS) {
      const int r = i / (DHP / 2), c = (i % (DHP / 2)) * 2, gr = row0 + r;
      const bool ok = gr < n && c < dh;
      cp_async4(dst + tile_off(r, c), src + (ok ? gr * x.sr + c : 0), ok);
    }
  } else {
    // rows on 2-byte boundaries (an odd head dim): eight elements at a
    // time from the aligned 4-byte words that hold them, shifted into
    // place and stored as one 16-byte chunk; a word that reaches past
    // either end of the row is read as its one element inside it
    for (int i = tid; i < BWD_T * (DHP / 8); i += CORE_THREADS) {
      const int r = i / (DHP / 8), c = (i % (DHP / 8)) * 8, gr = row0 + r;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (gr < n && c < dh) {
        const bf16* row = src + gr * x.sr;
        const int lead = (int)((reinterpret_cast<uintptr_t>(row) >> 1) & 1);
        const uint32_t* wp = reinterpret_cast<const uint32_t*>(
            reinterpret_cast<uintptr_t>(row + c) & ~uintptr_t(3));
        const unsigned short* hp =
            reinterpret_cast<const unsigned short*>(wp);
        uint32_t w[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          // word j holds elements lo and lo + 1 of the row
          const int lo = c + 2 * j - lead;
          const bool vlo = lo >= 0 && lo < dh && (j < 4 || lead);
          const bool vhi = lo + 1 < dh && (j < 4 || lead);
          w[j] = vlo && vhi ? __ldg(wp + j)
                 : vlo      ? (uint32_t)__ldg(hp + 2 * j)
                 : vhi      ? (uint32_t)__ldg(hp + 2 * j + 1) << 16
                            : 0u;
        }
        out = lead ? make_uint4(__funnelshift_r(w[0], w[1], 16),
                                __funnelshift_r(w[1], w[2], 16),
                                __funnelshift_r(w[2], w[3], 16),
                                __funnelshift_r(w[3], w[4], 16))
                   : make_uint4(w[0], w[1], w[2], w[3]);
      }
      *reinterpret_cast<uint4*>(dst + tile_off(r, c)) = out;
    }
  }
}

// the dynamic shared memory from its first 1024-byte boundary (TMA's and
// wgmma's swizzle read the address bits)
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

__device__ __forceinline__ void init_bars(uint64_t* bar, int tid) {
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= BWD_STAGES; ++i) mbar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------

// d = A . B^T over the head dim for two 64-row tiles (logits, dp); the
// caller fences, commits and waits
template <int DHP>
__device__ __forceinline__ void tile_dot(float (&d)[32],
                                         const unsigned char* a,
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk)
    wgmma_ss64(d, desc_kmajor(a, kk), desc_kmajor(b, kk), kk);
}

// the four k16 A operands (bf16) of a 64-column accumulator: columns
// 16 s .. 16 s + 15 are its values 8 s .. 8 s + 7
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[s][i] = pack_f32(x[8 * s + 2 * i],
                                                   x[8 * s + 2 * i + 1]);
}

// acc += A . tile, A (64 x 64) in registers, over the tile's 64 rows
template <int DHP>
__device__ __forceinline__ void tile_acc(float (&acc)[DHP / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* tile) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_rs<DHP>(acc, a[s], desc_mnmajor(tile, s), 1);
}

// rows g and g + 8 of this warp's 16 of an m64nDHP accumulator, bf16, at
// `row` of each head row; half hh
template <int DHP>
__device__ __forceinline__ void store_acc_row(bf16* row, const float* acc,
                                              int hh, int t, int dh, int vec,
                                              float mul) {
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j)
    store_pair(row, 8 * j + 2 * t, dh, vec, acc[4 * j + 2 * hh] * mul,
               acc[4 * j + 2 * hh + 1] * mul);
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

template <int DHP>
__host__ __device__ constexpr int bwd_tile() {
  return BWD_T * DHP * 2;
}

template <int DHP>
static size_t bwd_q_smem() {
  return 1024 + (size_t)(2 + 2 * BWD_STAGES) * bwd_tile<DHP>() +
         (1 + BWD_STAGES) * 8;
}

template <int DHP>
static size_t bwd_kv_smem() {
  return 1024 + 2 * (size_t)bwd_tile<DHP>() +
         (size_t)BWD_STAGES * (2 * bwd_tile<DHP>() + BWD_STAT_BYTES) +
         (1 + BWD_STAGES) * 8;
}

// Query side: one CTA per (64-query tile, head, image).  Items 0 ..
// 3 tiles - 1 stream the key tiles three times (K, then K and V):
// pass 0 the online (max, s), pass 1 row and ctx, pass 2 dq.  stats:
// [B * H * tiles * 64] (max * log2 e, 1 / s, row, 0), every row of every
// tile.
template <int DHP, bool CTX, bool TMA>
static __global__ void __launch_bounds__(CORE_THREADS, 3)
    core_bwd_q_wg_kernel(const __grid_constant__ CoreMaps maps, InHeads q,
                         InHeads k, InHeads v, InHeads dout, OutHeads dq,
                         OutHeads ctx, float4* __restrict__ stats, int n,
                         int dh, float scale, int vec) {
  if (TMA) dh = DHP, vec = 8;
  constexpr int TILE = bwd_tile<DHP>(), S = BWD_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_1k(smem_raw);
  unsigned char* Ds = Qs + TILE;
  unsigned char* ring = Ds + TILE;  // stage i: K at ring + 2 i TILE, then V
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * S * TILE);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n + BWD_T - 1) / BWD_T, items = 3 * tiles;
  const float c2 = scale * LOG2E;
  if (TMA) init_bars(bar, tid);

  // bar[0]: Q and dO; bar[1 + i]: stage i
  auto issue = [&](int it) {
    if (it < items) {
      const int row0 = (it % tiles) * BWD_T;
      const bool with_v = it >= tiles;
      unsigned char* Ks = ring + 2 * (it % S) * TILE;
      if (TMA) {
        if (tid == 0) {
          uint64_t* full = bar + 1 + it % S;
          mbar_expect_tx(full, with_v ? 2 * TILE : TILE);
          tma_tile<DHP>(Ks, maps.k, full, b, h, row0);
          if (with_v) tma_tile<DHP>(Ks + TILE, maps.v, full, b, h, row0);
        }
      } else {
        async_tile<DHP>(Ks, k, b, h, row0, n, dh, vec, tid);
        if (with_v) async_tile<DHP>(Ks + TILE, v, b, h, row0, n, dh, vec, tid);
      }
    }
    if (!TMA) cp_async_commit();
    __syncwarp();
  };

  if (TMA) {
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * TILE);
      tma_tile<DHP>(Qs, maps.q, bar, b, h, qt * BWD_T);
      tma_tile<DHP>(Ds, maps.dout, bar, b, h, qt * BWD_T);
    }
  } else {
    async_tile<DHP>(Qs, q, b, h, qt * BWD_T, n, dh, vec, tid);
    async_tile<DHP>(Ds, dout, b, h, qt * BWD_T, n, dh, vec, tid);
    cp_async_commit();
  }
  for (int it = 0; it < S - 1; ++it) issue(it);
  if (TMA) mbar_wait(bar, 0);

  // this thread's rows: g and g + 8 of warp's 16 (hh = 0, 1); its columns
  // of a 64-column accumulator: 8 j + 2 t (+ 1) at values 4 j + 2 hh (+ 1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rw[2] = {0.f, 0.f};
  float s[32], dp[32], acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < items; ++it) {
    issue(it + S - 1);
    if (TMA) {
      mbar_wait(bar + 1 + it % S, (it / S) & 1);
      __syncwarp();
    } else {
      cp_async_wait<S - 1>();
      fence_proxy_async();
      __syncthreads();
    }
    const int pass = it / tiles, kt = it % tiles;
    const unsigned char* Ks = ring + 2 * (it % S) * TILE;
    const unsigned char* Vs = Ks + TILE;

    wg_fence();
    tile_dot<DHP>(s, Qs, Ks);
    if (pass > 0) tile_dot<DHP>(dp, Ds, Vs);
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(dp);

    // keys past n: the last tile's columns from n - kt * 64 on
    const int valid = n - kt * BWD_T - 2 * t;
    if (pass == 0) {
      // base-2 logits (logit * log2 e), -inf past n; the running max over
      // the row, then the running sum at it
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = 8 * (i >> 2) + (i & 1) < valid ? s[i] * c2 : -INFINITY;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1)
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], o));
        const float mn = fmaxf(m[hh], mx[hh]);
        l[hh] *= exp2_approx(m[hh] - mn);
        m[hh] = mn;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        l[(i >> 1) & 1] += exp2_approx(s[i] - m[(i >> 1) & 1]);
      if (kt == tiles - 1) {
        // from here on l holds 1 / s
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1)
            l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], o);
          l[hh] = 1.f / l[hh];
        }
      }
    } else {
      // probs = p / s in place of the logits, zero past n
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const float p = exp2_approx(fmaf(s[i], c2, -m[hh])) * l[hh];
        s[i] = 8 * (i >> 2) + (i & 1) < valid ? p : 0.f;
      }
      uint32_t a[4][4];
      if (pass == 1) {
#pragma unroll
        for (int i = 0; i < 32; ++i) rw[(i >> 1) & 1] += dp[i] * s[i];
        if (CTX) {
          pack_a(a, s);
          wg_fence();
          tile_acc<DHP>(acc, a, Vs);
          wg_commit();
          wg_wait();
          fence_acc(acc);
        }
        if (kt == tiles - 1) {
          const long long bh = (long long)b * gridDim.y + h;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
            for (int o = 1; o <= 2; o <<= 1)
              rw[hh] += __shfl_xor_sync(0xffffffffu, rw[hh], o);
            const int qi = qt * BWD_T + warp * 16 + g + 8 * hh;
            if (t == 0)
              stats[bh * tiles * BWD_T + qi] =
                  make_float4(m[hh], l[hh], rw[hh], 0.f);
            if (CTX && qi < n)
              store_acc_row<DHP>(ctx.head(b, h) + qi * ctx.sr, acc, hh, t,
                                 dh, vec, 1.f);
          }
#pragma unroll
          for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
        }
      } else {
        // ds = bf16(probs * (dp - row)), dq += ds . K
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= dp[i] - rw[(i >> 1) & 1];
        pack_a(a, s);
        wg_fence();
        tile_acc<DHP>(acc, a, Ks);
        wg_commit();
        wg_wait();
        fence_acc(acc);
      }
    }
    __syncthreads();  // the stage is free for the next refill
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = qt * BWD_T + warp * 16 + g + 8 * hh;
    if (qi < n)
      store_acc_row<DHP>(dq.head(b, h) + qi * dq.sr, acc, hh, t, dh, vec,
                         scale);
  }
}

// Key side: one CTA per (64-key tile, head, image).  Items 0 .. tiles - 1
// stream the query tiles once: Q, dO and their statistics.
template <int DHP, bool TMA>
static __global__ void __launch_bounds__(CORE_THREADS, 2)
    core_bwd_kv_wg_kernel(const __grid_constant__ CoreMaps maps, InHeads q,
                          InHeads k, InHeads v, InHeads dout,
                          const float4* __restrict__ stats, OutHeads dk,
                          OutHeads dv, int n, int dh, float scale, int vec) {
  if (TMA) dh = DHP, vec = 8;
  constexpr int TILE = bwd_tile<DHP>(), S = BWD_STAGES;
  constexpr int STAGE = 2 * TILE + BWD_STAT_BYTES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Ks = smem_1k(smem_raw);
  unsigned char* Vs = Ks + TILE;
  unsigned char* ring = Vs + TILE;  // stage i: Q, dO, stats
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + S * STAGE);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n + BWD_T - 1) / BWD_T;
  const float c2 = scale * LOG2E;
  const float4* st_head =
      stats + ((long long)b * gridDim.y + h) * tiles * BWD_T;
  if (TMA) init_bars(bar, tid);

  auto issue = [&](int it) {
    if (it < tiles) {
      unsigned char* Qs = ring + (it % S) * STAGE;
      if (TMA) {
        if (tid == 0) {
          uint64_t* full = bar + 1 + it % S;
          mbar_expect_tx(full, STAGE);
          tma_tile<DHP>(Qs, maps.q, full, b, h, it * BWD_T);
          tma_tile<DHP>(Qs + TILE, maps.dout, full, b, h, it * BWD_T);
          bulk_load(Qs + 2 * TILE, st_head + it * BWD_T, BWD_STAT_BYTES,
                    full);
        }
      } else {
        async_tile<DHP>(Qs, q, b, h, it * BWD_T, n, dh, vec, tid);
        async_tile<DHP>(Qs + TILE, dout, b, h, it * BWD_T, n, dh, vec, tid);
        if (tid < BWD_T)
          cp_async16(Qs + 2 * TILE + 16 * tid, st_head + it * BWD_T + tid,
                     true);
      }
    }
    if (!TMA) cp_async_commit();
    __syncwarp();
  };

  if (TMA) {
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * TILE);
      tma_tile<DHP>(Ks, maps.k, bar, b, h, kt * BWD_T);
      tma_tile<DHP>(Vs, maps.v, bar, b, h, kt * BWD_T);
    }
  } else {
    async_tile<DHP>(Ks, k, b, h, kt * BWD_T, n, dh, vec, tid);
    async_tile<DHP>(Vs, v, b, h, kt * BWD_T, n, dh, vec, tid);
    cp_async_commit();
  }
  for (int it = 0; it < S - 1; ++it) issue(it);
  if (TMA) mbar_wait(bar, 0);

  // this thread's rows (keys): g and g + 8 of warp's 16; its columns
  // (queries) of a 64-column accumulator: 8 j + 2 t (+ 1)
  float s[32], dp[32], ak[DHP / 2], av[DHP / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) ak[i] = av[i] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    issue(it + S - 1);
    if (TMA) {
      mbar_wait(bar + 1 + it % S, (it / S) & 1);
      __syncwarp();
    } else {
      cp_async_wait<S - 1>();
      fence_proxy_async();
      __syncthreads();
    }
    const unsigned char* Qs = ring + (it % S) * STAGE;
    const unsigned char* Ds = Qs + TILE;
    const float4* St = reinterpret_cast<const float4*>(Qs + 2 * TILE);

    wg_fence();
    tile_dot<DHP>(s, Ks, Qs);
    tile_dot<DHP>(dp, Vs, Ds);
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(dp);

    // probs^T in place of the logits, ds^T in place of dp^T; zero for the
    // queries past n
    const int valid = n - it * BWD_T - 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 st0 = St[8 * j + 2 * t], st1 = St[8 * j + 2 * t + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4& st = (e & 1) ? st1 : st0;
        const int i = 4 * j + e;
        const bool ok = 8 * j + (e & 1) < valid;
        const float p = exp2_approx(fmaf(s[i], c2, -st.x)) * st.y;
        dp[i] = ok ? p * (dp[i] - st.z) : 0.f;
        s[i] = ok ? p : 0.f;
      }
    }
    uint32_t ap[4][4], as[4][4];
    pack_a(ap, s);
    pack_a(as, dp);
    wg_fence();
    tile_acc<DHP>(av, ap, Ds);
    tile_acc<DHP>(ak, as, Qs);
    wg_commit();
    wg_wait();
    fence_acc(av);
    fence_acc(ak);
    __syncthreads();  // the stage is free for the next refill
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kt * BWD_T + warp * 16 + g + 8 * hh;
    if (key >= n) continue;
    store_acc_row<DHP>(dk.head(b, h) + key * dk.sr, ak, hh, t, dh, vec,
                       scale);
    store_acc_row<DHP>(dv.head(b, h) + key * dv.sr, av, hh, t, dh, vec, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up once through the runtime's
// entry-point query (the libraries do not link libcuda)
static EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// x's TMA map: boxes of 16 columns x 64 rows of one head in the 32-byte
// swizzle, rows past n zero-filled
static cudaError_t tile_map(TileMap& tm, const InHeads& x, int batch,
                            int heads, int n, int dh) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const long long stride[3] = {x.sr, x.sh, x.sb};
  const cuuint64_t size[3] = {(cuuint64_t)n, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) std::swap(order[i], order[j]);
  cuuint64_t dims[4] = {(cuuint64_t)dh, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {16, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = size[order[i]];
    strides[i] = (cuuint64_t)stride[order[i]] * sizeof(bf16);
    tm.slot[order[i]] = i + 1;
    if (order[i] == 0) box[i + 1] = BWD_T;
  }
  const CUresult r = encode(
      &tm.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
      const_cast<bf16*>(x.p), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DHP, bool CTX, bool TMA>
static cudaError_t run_core_bwd_wg(const CoreMaps& maps, InHeads q, InHeads k,
                                   InHeads v, InHeads dout, OutHeads dq,
                                   OutHeads dk, OutHeads dv, OutHeads ctx,
                                   float4* stats, int batch, int heads, int n,
                                   int dh, float scale, int vec,
                                   cudaStream_t s) {
  const dim3 grid((n + BWD_T - 1) / BWD_T, heads, batch);
  size_t smem = bwd_q_smem<DHP>();
  cudaError_t err = set_smem(core_bwd_q_wg_kernel<DHP, CTX, TMA>, smem);
  if (err != cudaSuccess) return err;
  core_bwd_q_wg_kernel<DHP, CTX, TMA><<<grid, CORE_THREADS, smem, s>>>(
      maps, q, k, v, dout, dq, ctx, stats, n, dh, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = bwd_kv_smem<DHP>();
  err = set_smem(core_bwd_kv_wg_kernel<DHP, TMA>, smem);
  if (err != cudaSuccess) return err;
  core_bwd_kv_wg_kernel<DHP, TMA><<<grid, CORE_THREADS, smem, s>>>(
      maps, q, k, v, dout, stats, dk, dv, n, dh, scale, vec);
  return cudaGetLastError();
}

// Backward, two launches on the caller's stream: dq, dk, dv and, with CTX,
// ctx.  stats: [B * heads * ceil(N / 64) * 64] float4 scratch.
template <int DHP, bool CTX>
static cudaError_t launch_core_bwd_wg(InHeads q, InHeads k, InHeads v,
                                      InHeads dout, OutHeads dq, OutHeads dk,
                                      OutHeads dv, OutHeads ctx,
                                      float4* stats, int batch, int heads,
                                      int n, int dh, float scale,
                                      cudaStream_t s) {
  // ctx is all zeros (any copy width) without CTX
  const int vec = ops_vec(dh, q, k, v, dout, dq, dk, dv, ctx);
  auto strided = [](const InHeads& x) { return x.sb && x.sh && x.sr; };
  if (dh == DHP && vec == 8 && strided(q) && strided(k) && strided(v) &&
      strided(dout)) {
    CoreMaps maps;
    cudaError_t err = tile_map(maps.q, q, batch, heads, n, dh);
    if (err == cudaSuccess) err = tile_map(maps.k, k, batch, heads, n, dh);
    if (err == cudaSuccess) err = tile_map(maps.v, v, batch, heads, n, dh);
    if (err == cudaSuccess)
      err = tile_map(maps.dout, dout, batch, heads, n, dh);
    if (err != cudaSuccess) return err;
    return run_core_bwd_wg<DHP, CTX, true>(maps, q, k, v, dout, dq, dk, dv,
                                           ctx, stats, batch, heads, n, dh,
                                           scale, vec, s);
  }
  return run_core_bwd_wg<DHP, CTX, false>(CoreMaps{}, q, k, v, dout, dq, dk,
                                          dv, ctx, stats, batch, heads, n, dh,
                                          scale, vec, s);
}

}  // namespace uvc
