// The attention core's forward for Hopper, streamed:
//   ctx = softmax(q . k^T * scale) . v
// per (image, head) on [B, H, N, dh] operands at any strides.  It runs
// kernel A9's forward (uvc_tpu/ops/attention.py::_fwd_kernel, through
// attention_core.cu) and the attention step of K1 (::_layer_ln_fwd_kernel)
// and of A7's forward (::_layer_fwd_kernel), both through attention.cu, on
// head views of the packed qkv rows, with the ctx mask.  The head tiles,
// their TMA maps and copies, and the products on them are shared with the
// backward (attention_core_bwd.cuh), which includes this file.
//
// Numerics: the Pallas bodies' order, as attention_plain in
// uvc_tpu_torch/ops/attention.py writes it: logits = (q . k^T) * scale in
// f32, p = exp(logit - max), s = sum(p) of the unrounded p, ctx =
// (bf16(p) . V) / s, the normalisation after P . V; with a mask (K1, A7),
// bf16(bf16(ctx) * mask).  Two changes of order, both in f32, as in the
// backward: the max and s are online over 64-key tiles, the running sum
// and the context accumulator rescaled by 2^(old max - new max) when a
// tile raises the max, so bf16(p) is rounded against the running max and
// not the final one; and p = 2^(logit * log2 e - max) (MUFU.EX2, the max
// kept in base 2), where the Pallas body takes exp.
//
// What bounds it on the H100: the bytes.  At ViT-H/14 (B = 32, H = 16,
// N = 257, dh = 80) it reads q, k, v and writes ctx, 4 x 21.05 MB = 84.2 MB
// (25.1 us at 3.35 TB/s), for 4 B H N^2 dh = 10.8 GFLOP (10.9 us at
// 989 TFLOP/s); the logits and probabilities never leave the chip.
//
// Design: one CTA of one warpgroup per (64-query tile, head, image).  The
// query tile is loaded once; the head's K and V stream through a ring of
// two stages of 64-row tiles, the next tile in flight while the warpgroup
// works on the current one, so shared memory does not depend on N (51 KB
// at head dim 80) and four CTAs (sixteen warps) fit an SM.  Per key tile:
// S = Q . K^T on wgmma (m64n64k16, both operands K-major in shared
// memory), the online softmax in registers, and ctx += bf16(p) . V on
// wgmma (m64nDHPk16) with its A operand S's accumulator converted to bf16
// in place (the accumulator's layout is wgmma's register layout of A) and
// V read along its rows (MN-major).  One pass over the keys, where the
// Pallas body takes two (the max, then p and P . V).
//
// Tiles: 16-column boxes of 64 rows x 32 bytes in the 32-byte swizzle (the
// 16-byte halves of a row swapped on rows 4-7 of every 8), which TMA
// writes and wgmma reads as its B32 layout (the tiles at head dims 16-48
// and on the copy paths); the TMA tiles at head dims 64 and 80, here and
// in the backward, hold their first 64 columns in one box of 64 rows x
// 128 bytes in the 128-byte swizzle instead (wide_tile), so TMA reads a
// row in one or two requests where 16-column boxes take four or five (the
// requests, not the bytes, set the pace of the 16-column tiles on the
// card).  Loads: TMA (cp.async.bulk.tensor, completion on an mbarrier)
// when every operand is a full tile (dh equal to the padded head dim,
// 16-byte strides and base: K1's and A7's head views of qkv at head dims
// 64 and 80, A9's contiguous heads of 16-80); otherwise cp.async into the
// 16-column layout at the widest copy the operands allow (16 or 4 bytes;
// at an odd head dim, aligned 4-byte loads shifted into place), the
// columns past dh and the rows past N zero-filled, as TMA fills rows past
// N.  The columns past dh add zero to every product; the keys past N get
// a logit of -inf.
// Stores: full tiles go through shared memory and out 16 bytes a thread;
// the copy paths store 4 bytes (or one element) a thread from registers.
#pragma once

#include <utility>

#include "attention_core.cuh"
#include "hopper.cuh"

namespace uvc {

// ---------------------------------------------------------------------------
// head tiles
// ---------------------------------------------------------------------------

// One operand as a TMA tensor map: 4-d, the head dim innermost, then row,
// head and batch in the order of their strides; slot[0..2] is the
// coordinate position (1..3) of row, head and batch.
struct TileMap {
  CUtensorMap map;
  int slot[3];
};

// A core's TMA maps of its operands (q, k, v and, for the backward, dout):
// boxes of 16 columns (the head tiles of head dims 16-48, and the last 16
// columns at 80) and of 64 columns (the first 64 at head dims 64 and 80).
template <int OPS>
struct HeadMaps {
  TileMap narrow[OPS], wide[OPS];
};
enum { OP_Q = 0, OP_K = 1, OP_V = 2, OP_DOUT = 3 };
constexpr int WIDE_BOX = TILE_ROWS * 128;  // 64 rows x 64 columns

// A full tile of head dim DHP >= 64 loaded by TMA holds its first 64
// columns in one box of 64 rows x 128 bytes in the 128-byte swizzle
// (WIDE_BOX bytes), its 16 columns past them (head dim 80) in a 16-column
// box after it, so TMA reads a row in one or two requests where 16-column
// boxes take four or five; the products below take both layouts.
template <int DHP, bool TMA>
__host__ __device__ constexpr bool wide_tile() {
  return TMA && DHP >= 64;
}

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
    tma_load_4d(dst + kk * TILE_BOX, &tm.map, bar, kk * 16, c1, c2, c3);
}

// one box of the same rows, from column col0: a box of tm's width
__device__ __forceinline__ void tma_box(unsigned char* dst, const TileMap& tm,
                                        uint64_t* bar, int b, int h, int row0,
                                        int col0) {
  auto at = [&](int pos) {
    return tm.slot[0] == pos ? row0 : tm.slot[1] == pos ? h : b;
  };
  tma_load_4d(dst, &tm.map, bar, col0, at(1), at(2), at(3));
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
    for (int i = tid; i < TILE_ROWS * (DHP / 8); i += CORE_THREADS) {
      const int r = i / (DHP / 8), c = (i % (DHP / 8)) * 8, gr = row0 + r;
      const bool ok = gr < n && c < dh;
      cp_async16(dst + tile_off(r, c), src + (ok ? gr * x.sr + c : 0), ok);
    }
  } else if (vec == 2) {
    for (int i = tid; i < TILE_ROWS * (DHP / 2); i += CORE_THREADS) {
      const int r = i / (DHP / 2), c = (i % (DHP / 2)) * 2, gr = row0 + r;
      const bool ok = gr < n && c < dh;
      cp_async4(dst + tile_off(r, c), src + (ok ? gr * x.sr + c : 0), ok);
    }
  } else {
    // rows on 2-byte boundaries (an odd head dim): eight elements at a
    // time from the aligned 4-byte words that hold them, shifted into
    // place and stored as one 16-byte chunk; a word that reaches past
    // either end of the row is read as its one element inside it
    for (int i = tid; i < TILE_ROWS * (DHP / 8); i += CORE_THREADS) {
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

// the barriers of a kernel with a ring of S stages: one for its own
// tile(s), one per stage
template <int S>
__device__ __forceinline__ void init_bars(uint64_t* bar, int tid) {
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i <= S; ++i) mbar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

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

// rows row0 .. row0 + 63 of operand i by TMA in the tile layout of
// wide_tile; one thread issues it
template <int DHP, int OPS>
__device__ __forceinline__ void tma_rows(unsigned char* dst,
                                         const HeadMaps<OPS>& maps, int i,
                                         uint64_t* bar, int b, int h,
                                         int row0) {
  if constexpr (DHP >= 64) {
    tma_box(dst, maps.wide[i], bar, b, h, row0, 0);
    if constexpr (DHP > 64)
      tma_box(dst + WIDE_BOX, maps.narrow[i], bar, b, h, row0, 64);
  } else {
    tma_tile<DHP>(dst, maps.narrow[i], bar, b, h, row0);
  }
}

// tile_dot on tiles in either layout (WIDE: wide_tile's), k16 step by
// step in the same order
template <int DHP, bool WIDE>
__device__ __forceinline__ void head_dot(float (&d)[32],
                                         const unsigned char* a,
                                         const unsigned char* b) {
  if constexpr (WIDE) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss64(d, gmma_desc128(a + 32 * kk, 16, 1024),
                 gmma_desc128(b + 32 * kk, 16, 1024), kk);
    if constexpr (DHP > 64)
      wgmma_ss64(d, desc_kmajor(a + WIDE_BOX, 0), desc_kmajor(b + WIDE_BOX, 0),
                 1);
  } else {
    tile_dot<DHP>(d, a, b);
  }
}

// tile_acc on a tile in either layout: with WIDE, the n64 part of the
// product from the wide box and the n16 part (head dim 80) from the box
// after it; each output column sums the same k16 steps in the same order
template <int DHP, bool WIDE>
__device__ __forceinline__ void head_acc(float (&acc)[DHP / 2],
                                         const uint32_t (&a)[4][4],
                                         const unsigned char* tile) {
  if constexpr (WIDE) {
    float(&lo)[32] = *reinterpret_cast<float(*)[32]>(acc);
#pragma unroll
    for (int st = 0; st < 4; ++st)
      wgmma_rs<64>(lo, a[st], gmma_desc128(tile + 2048 * st, WIDE_BOX, 1024),
                   1);
    if constexpr (DHP > 64) {
      float(&hi)[8] = *reinterpret_cast<float(*)[8]>(acc + 32);
#pragma unroll
      for (int st = 0; st < 4; ++st)
        wgmma_rs<16>(hi, a[st], desc_mnmajor(tile + WIDE_BOX, st), 1);
    }
  } else {
    tile_acc<DHP>(acc, a, tile);
  }
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

template <int DHP>
__host__ __device__ constexpr int head_tile() {
  return TILE_ROWS * DHP * 2;
}

// x's TMA map: boxes of 16 columns x 64 rows of one head in the 32-byte
// swizzle, or with box_cols = 64 of 64 columns in the 128-byte swizzle;
// rows past n zero-filled
static cudaError_t tile_map(TileMap& tm, const InHeads& x, int batch,
                            int heads, int n, int dh, int box_cols = 16) {
  const long long stride[3] = {x.sr, x.sh, x.sb};
  const cuuint64_t size[3] = {(cuuint64_t)n, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (stride[order[j]] < stride[order[i]]) std::swap(order[i], order[j]);
  cuuint64_t dims[4] = {(cuuint64_t)dh, 0, 0, 0}, strides[3];
  cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = size[order[i]];
    strides[i] = (cuuint64_t)stride[order[i]] * sizeof(bf16);
    tm.slot[order[i]] = i + 1;
    if (order[i] == 0) box[i + 1] = TILE_ROWS;
  }
  return encode_map(tm.map, 4, x.p, dims, strides, box,
                    box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                   : CU_TENSOR_MAP_SWIZZLE_32B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
}

// TMA takes an operand that is a full tile at every (batch, head, row)
// stride: none of them 0
static bool has_strides(const InHeads& x) { return x.sb && x.sh && x.sr; }

// Operands that TMA loads as they lie: dh equal to the padded head dim,
// 16-byte strides and base, no stride 0.
template <int DHP, typename... T>
static bool full_tiles(int dh, const T&... ops) {
  return dh == DHP && ops_vec(dh, ops...) == 8 && (has_strides(ops) && ...);
}

// the maps of the full-tile operands ops[0 .. OPS - 1] in the tile layout
// of wide_tile<DHP, true>
template <int DHP, int OPS>
static cudaError_t head_maps(HeadMaps<OPS>& maps, const InHeads* const* ops,
                             int batch, int heads, int n) {
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < OPS && err == cudaSuccess; ++i) {
    if (DHP % 64) err = tile_map(maps.narrow[i], *ops[i], batch, heads, n,
                                 DHP);
    if (DHP >= 64 && err == cudaSuccess)
      err = tile_map(maps.wide[i], *ops[i], batch, heads, n, DHP, 64);
  }
  return err;
}

// A tile's 64 output rows staged in shared memory at a pitch of DHP + 8
// elements (a warp's stores spread over the banks)
template <int DHP>
constexpr int STAGED_PITCH = DHP + 8;
template <int DHP>
constexpr int STAGED_ROWS = TILE_ROWS * STAGED_PITCH<DHP>;

// rows row0 .. row0 + 63 (those below n) of head (b, h) of out from the
// staged rows, 16 bytes a thread (dh, out's strides and base multiples of
// 8 elements); after a __syncthreads that follows the staging
template <int DHP>
__device__ __forceinline__ void store_staged(const OutHeads& out,
                                             const bf16* rows, int b, int h,
                                             int row0, int n, int dh,
                                             int tid) {
  for (int i = tid; i < TILE_ROWS * (DHP / 8); i += CORE_THREADS) {
    const int r = i / (DHP / 8), c = (i % (DHP / 8)) * 8;
    if (row0 + r < n && c < dh)
      *reinterpret_cast<uint4*>(out.head(b, h) + (row0 + r) * out.sr + c) =
          *reinterpret_cast<const uint4*>(rows + r * STAGED_PITCH<DHP> + c);
  }
}

// ---------------------------------------------------------------------------
// the forward kernel
// ---------------------------------------------------------------------------

constexpr int FWD_STAGES = 2;  // the streamed ring of K and V tiles
constexpr int FWD_CTAS = 4;    // CTAs per SM (128 registers a thread)

template <int DHP>
static size_t fwd_smem() {
  return 1024 + (size_t)(1 + 2 * FWD_STAGES) * head_tile<DHP>() +
         (1 + FWD_STAGES) * 8;
}

// the forward's maps of q, k and v
typedef HeadMaps<3> FwdMaps;

// One CTA per (64-query tile, head, image).  Items 0 .. tiles - 1 stream
// the key tiles once, K and V.  mask: with MASK, [heads * dh], dh even.
// TMA at head dims 64 and 80 loads the tiles of wide_tile.
template <int DHP, bool MASK, bool TMA>
static __global__ void __launch_bounds__(CORE_THREADS, FWD_CTAS)
    core_fwd_wg_kernel(const __grid_constant__ FwdMaps maps, InHeads q,
                       InHeads k, InHeads v, OutHeads out,
                       const bf16* __restrict__ mask, int n, int dh,
                       float scale, int vec) {
  static_assert(DHP <= 80, "head dims up to 80");
  constexpr bool WIDE = wide_tile<DHP, TMA>();
  if (TMA) dh = DHP, vec = 8;
  constexpr int TILE = head_tile<DHP>(), S = FWD_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_1k(smem_raw);
  unsigned char* ring = Qs + TILE;  // stage i: K at ring + 2 i TILE, then V
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * S * TILE);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const float c2 = scale * LOG2E;
  if (TMA) init_bars<S>(bar, tid);

  // bar[0]: Q; bar[1 + i]: stage i
  auto issue = [&](int it) {
    if (it < tiles) {
      unsigned char* Ks = ring + 2 * (it % S) * TILE;
      if (TMA) {
        if (tid == 0) {
          uint64_t* full = bar + 1 + it % S;
          mbar_expect_tx(full, 2 * TILE);
          tma_rows<DHP>(Ks, maps, OP_K, full, b, h, it * TILE_ROWS);
          tma_rows<DHP>(Ks + TILE, maps, OP_V, full, b, h, it * TILE_ROWS);
        }
      } else {
        async_tile<DHP>(Ks, k, b, h, it * TILE_ROWS, n, dh, vec, tid);
        async_tile<DHP>(Ks + TILE, v, b, h, it * TILE_ROWS, n, dh, vec, tid);
      }
    }
    if (!TMA) cp_async_commit();
    __syncwarp();
  };

  if (TMA) {
    if (tid == 0) {
      mbar_expect_tx(bar, TILE);
      tma_rows<DHP>(Qs, maps, OP_Q, bar, b, h, qt * TILE_ROWS);
    }
  } else {
    async_tile<DHP>(Qs, q, b, h, qt * TILE_ROWS, n, dh, vec, tid);
    cp_async_commit();
  }
  for (int it = 0; it < S - 1; ++it) issue(it);
  if (TMA) mbar_wait(bar, 0);

  // this thread's rows: g and g + 8 of warp's 16 (hh = 0, 1); its columns
  // of a 64-column accumulator: 8 j + 2 t (+ 1) at values 4 j + 2 hh (+ 1)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[32], acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;

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
    const unsigned char* Ks = ring + 2 * (it % S) * TILE;
    const unsigned char* Vs = Ks + TILE;

    // S = Q . K^T over the head dim, k16 step by step
    wg_fence();
    head_dot<DHP, WIDE>(s, Qs, Ks);
    wg_commit();
    wg_wait();
    fence_acc(s);

    // base-2 logits (logit * log2 e), -inf for the keys past n (the last
    // tile's columns from n - it * 64 on); the row max over the tile, then
    // the running max, sum and accumulator rescaled to it
    if (it == tiles - 1) {
      const int valid = n - it * TILE_ROWS - 2 * t;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = 8 * (i >> 2) + (i & 1) < valid ? s[i] * c2 : -INFINITY;
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= c2;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], o));
      const float mn = fmaxf(m[hh], mx[hh]);
      alpha[hh] = exp2_approx(m[hh] - mn);
      l[hh] *= alpha[hh];
      m[hh] = mn;
    }
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    // p = 2^(logit - max) in place of the logits; s sums the unrounded p
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2_approx(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }

    // ctx += bf16(p) . V, over the tile's 64 keys in k16 steps
    uint32_t a[4][4];
    pack_a(a, s);
    wg_fence();
    head_acc<DHP, WIDE>(acc, a, Vs);
    wg_commit();
    wg_wait();
    fence_acc(acc);
    __syncthreads();  // the stage is free for the next refill
  }

  // ctx = acc / s, with MASK bf16(bf16(ctx) * mask)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1)
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], o);
  }
  auto ctx_pair = [&](int j, int hh, float& c0, float& c1) {
    const int c = 8 * j + 2 * t;
    c0 = acc[4 * j + 2 * hh] / l[hh];
    c1 = acc[4 * j + 2 * hh + 1] / l[hh];
    if (MASK && c < dh) {
      c0 = bf2f(f2bf(c0)) * bf2f(mask[h * dh + c]);
      c1 = bf2f(f2bf(c1)) * bf2f(mask[h * dh + c + 1]);
    }
  };
  if constexpr (TMA) {
    // full tiles, 16-byte rows: the tile's rows through shared memory (the
    // ring, free now), then 16 bytes a thread
    bf16* rows = reinterpret_cast<bf16*>(ring);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + 8 * hh;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        float c0, c1;
        ctx_pair(j, hh, c0, c1);
        *reinterpret_cast<uint32_t*>(rows + r * STAGED_PITCH<DHP> + 8 * j +
                                     2 * t) = pack_f32(c0, c1);
      }
    }
    __syncthreads();
    store_staged<DHP>(out, rows, b, h, qt * TILE_ROWS, n, dh, tid);
  } else {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qi = qt * TILE_ROWS + warp * 16 + g + 8 * hh;
      if (qi >= n) continue;
      bf16* row = out.head(b, h) + qi * out.sr;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        float c0, c1;
        ctx_pair(j, hh, c0, c1);
        store_pair(row, 8 * j + 2 * t, dh, vec, c0, c1);
      }
    }
  }
}

template <int DHP, bool MASK, bool TMA>
static cudaError_t run_core_fwd_wg(const FwdMaps& maps, InHeads q, InHeads k,
                                   InHeads v, OutHeads out, const bf16* mask,
                                   int batch, int heads, int n, int dh,
                                   float scale, int vec, cudaStream_t s) {
  const size_t smem = fwd_smem<DHP>();
  const cudaError_t err = smem_once<core_fwd_wg_kernel<DHP, MASK, TMA>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE_ROWS - 1) / TILE_ROWS, heads, batch);
  core_fwd_wg_kernel<DHP, MASK, TMA><<<grid, CORE_THREADS, smem, s>>>(
      maps, q, k, v, out, mask, n, dh, scale, vec);
  return cudaGetLastError();
}

// Forward, one launch on the caller's stream; with MASK, ctx =
// bf16(bf16(ctx) * mask) for mask [heads * dh] (dh even).
template <int DHP, bool MASK>
static cudaError_t launch_core_fwd_wg(InHeads q, InHeads k, InHeads v,
                                      OutHeads out, const bf16* mask,
                                      int batch, int heads, int n, int dh,
                                      float scale, cudaStream_t s) {
  const int vec = ops_vec(dh, q, k, v, out);
  if (vec == 8 && full_tiles<DHP>(dh, q, k, v)) {
    FwdMaps maps;
    const InHeads* ops[3] = {&q, &k, &v};
    const cudaError_t err = head_maps<DHP>(maps, ops, batch, heads, n);
    if (err != cudaSuccess) return err;
    return run_core_fwd_wg<DHP, MASK, true>(maps, q, k, v, out, mask, batch,
                                            heads, n, dh, scale, vec, s);
  }
  return run_core_fwd_wg<DHP, MASK, false>(FwdMaps{}, q, k, v, out, mask,
                                           batch, heads, n, dh, scale, vec,
                                           s);
}

}  // namespace uvc
