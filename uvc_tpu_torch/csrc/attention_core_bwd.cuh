// The backward of the attention core for Hopper, streamed: kernels A8
// (uvc_tpu/ops/attention.py::_bwd_ctx_kernel) and A9's backward
// (::_bwd_kernel), on [B, H, N, dh] operands at any strides
// (attention_core.cu), and the attention step of the sublayer backwards
// A2 and A7 (::_layer_ln_bwd_kernel, ::_layer_bwd_kernel, attention.cu),
// on head views of the packed qkv, dctx and dqkv rows.  K1, A7's forward
// and A9's forward run the streamed forward of attention_core_fwd.cuh.
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
// What the query side writes of ctx besides dq (CtxMode): nothing (A9),
// ctx rounded to bf16 (A8), or the sublayers' ctxm = bf16(ctx * mask)
// (for dWproj) and per-CTA partial sums of dmask = sum(t * ctx), ctx in
// f32 as the Pallas body takes it, with t = do . Wproj^T read back.
//
// Design.  Two launches (after the pack where it applies, below), no float
// atomics, each output tile written by one CTA (two calls give the same
// bits):
//   core_bwd_q_wg_kernel, one CTA per (64-query tile, head, image): three
//     passes over the 64-key tiles: (max, s) online; row = sum(dp * probs)
//     and, for A8 and the sublayers, ctx = bf16(probs) . V; ds and
//     dq = ds . K.  Writes dq, ctx and (max * log2 e, 1 / s, row) per query.
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
// does not depend on N: 62.5 KB (query side; 63.8 KB with the sublayers'
// dmask sums) and 64.5 KB (key side) at head dim 80.  The query side fits 168 registers a thread and runs three
// CTAs (twelve warps) per SM, the key side, with two m64n80 accumulators
// held across its loop, two (eight warps).  A third stage on either side,
// or three key-side CTAs in 168 registers (which spill), ran no faster on
// the H100.
//
// Tiles and loads: those of the forward (attention_core_fwd.cuh, which
// holds them and the products on them).  Operands that are full tiles
// (head dim equal to its padded width, 16-byte strides and base: A8's and
// the sublayers' head views of the qkv rows at head dims 64 and 80, A9's
// contiguous heads at 16-80) load by TMA as they lie, at head dims 64 and
// 80 in wide_tile's layout (the first 64 columns in one 128-byte-swizzled
// box, one or two requests a row where 16-column boxes take four or five;
// the K-major products S and dp and the MN-major reads of the register-A
// products take it as the forward's do).  A9's and A8's other operands
// (the Dense variant's head dims 41 and 74, head views on 2- or 4-byte
// strides) are first packed by pack_heads_kernel into zero-padded
// contiguous [B, H, N, DHP] scratch, one launch for the four, and load by
// TMA from there: the padded copy (72 MB at the Dense variant's head dim
// 41, B 64, H 8, N 197: ~22 us at 3.35 TB/s) costs less than the copy
// path, whose loads at an odd head dim are synchronous and at 4 bytes
// take 37 requests a row.  The sublayers' head views at resnext's head
// dim 12 keep the copy path (cp.async, 4 bytes), as do operands that
// allow 16-byte copies at a head dim below its padded width (no main
// path's).  The outputs are written at the true dh into the caller's
// layout: on the TMA path staged through shared memory and stored 16
// bytes a thread where every output allows it, else 4 bytes (or one
// element) a thread from registers.  (Staged on the copy path too, the
// 6-CTA "ragged" call of chip_smoke.py ran ~3% slower on the H100: a sync
// and a round trip through shared memory at the end of every CTA.)
#pragma once

#include "attention_core_fwd.cuh"

namespace uvc {

constexpr int BWD_STAGES = 2;                     // the streamed ring
constexpr int BWD_STAT_BYTES = TILE_ROWS * 16;    // a tile's (max, 1/s, row, 0)

// the backward's maps of q, k, v and dout
typedef HeadMaps<4> CoreMaps;

// what the query side writes of ctx = bf16(probs) . V
enum CtxMode { CTX_NONE = 0, CTX_BF16 = 1, CTX_SUBLAYER = 2 };

// Its outputs, element (b, h, i, d) at b sb + h sh + i sr + d: with
// CTX_BF16, ctx rounded to bf16 into out (A8); with CTX_SUBLAYER (A2, A7),
// ctxm = bf16(ctx * mask) into out, mask [heads * dh] with dh even, and
// the partial sums of dmask = sum(t * ctx) over each CTA's 64 rows into
// dmask [B * tiles, heads * dh] (row (b, query tile)), t f32 at out's
// strides, so that ctx itself, in f32, never leaves the chip.
struct CtxOut {
  bf16* out;
  const float* t;
  float* dmask;
  const bf16* mask;
  long long sb, sh, sr;
  Heads<bf16> heads() const { return {out, sb, sh, sr}; }
};

// ctxm = bf16(ctx * mask) of rows g and g + 8 of this warp's 16 of an
// m64nDHP accumulator at element offset off, half hh (CTX_SUBLAYER)
template <int DHP>
__device__ __forceinline__ void store_ctxm_row(const CtxOut& cx, long long off,
                                               int h, const float* acc,
                                               int hh, int t, int dh) {
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (c < dh)
      *reinterpret_cast<uint32_t*>(cx.out + off + c) =
          pack_f32(acc[4 * j + 2 * hh] * bf2f(cx.mask[h * dh + c]),
                   acc[4 * j + 2 * hh + 1] * bf2f(cx.mask[h * dh + c + 1]));
  }
}

// This CTA's partial sums of dmask = sum(t * ctx) over its 64 query rows
// (q0 = the thread's first) of head h (CTX_SUBLAYER): per column
// 8 j + 2 t (+ 1), the thread's two rows (rows past n add nothing), the
// eight lanes that share t in a fixed tree, then the four warps in order
// through red [4][DHP] in shared memory; thread c writes column c to row
// (b, qt) of cx.dmask.  Every thread of the CTA calls it.
template <int DHP>
__device__ __forceinline__ void dmask_partial(const CtxOut& cx,
                                              const float* acc, float* red,
                                              int b, int h, int heads, int qt,
                                              int tiles, int tid, int q0,
                                              int n, int dh) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const float* t0 = cx.t + (long long)b * cx.sb + (long long)h * cx.sh +
                    (long long)q0 * cx.sr;
  const float* t1 = t0 + 8 * cx.sr;
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    const int c = 8 * j + 2 * t;
    float s0 = 0.f, s1 = 0.f;
    if (c < dh && q0 < n) {
      const float2 v = *reinterpret_cast<const float2*>(t0 + c);
      s0 = v.x * acc[4 * j];
      s1 = v.y * acc[4 * j + 1];
    }
    if (c < dh && q0 + 8 < n) {
      const float2 v = *reinterpret_cast<const float2*>(t1 + c);
      s0 += v.x * acc[4 * j + 2];
      s1 += v.y * acc[4 * j + 3];
    }
#pragma unroll
    for (int o = 4; o <= 16; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (g == 0) {
      red[warp * DHP + c] = s0;
      red[warp * DHP + c + 1] = s1;
    }
  }
  __syncthreads();
  if (tid < dh)
    cx.dmask[((long long)b * tiles + qt) * heads * dh + h * dh + tid] =
        red[tid] + red[DHP + tid] + red[2 * DHP + tid] + red[3 * DHP + tid];
}

// An m64nDHP accumulator's 64 rows as bf16(acc * mul) in shared memory
// for store_staged; every thread of the CTA calls it
template <int DHP>
__device__ __forceinline__ void stage_rows(bf16* rows,
                                           const float (&acc)[DHP / 2],
                                           float mul, int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j)
      *reinterpret_cast<uint32_t*>(rows + r * STAGED_PITCH<DHP> + 8 * j +
                                   2 * t) =
          pack_f32(acc[4 * j + 2 * hh] * mul, acc[4 * j + 2 * hh + 1] * mul);
  }
}

// The pack: q, k, v and dout (any strides, dh columns) copied into
// zero-padded contiguous [B, H, N, DHP] heads, one after another in pack,
// so that the core's TMA path loads them as full tiles.  The columns past
// dh are zeros, which add exact zeros to every product: the tiles in
// shared memory hold what the copy path writes there.  Thread i writes
// the 16 bytes of columns 8 (i % (DHP / 8)) .. + 7 of row i / (DHP / 8)
// of operand blockIdx.y, reading them 16, 4 or 2 bytes at a time as vec
// allows (8, 2, 1).
constexpr int PACK_THREADS = 256;

struct PackOps {
  InHeads x[4];
};

template <int DHP>
static __global__ void __launch_bounds__(PACK_THREADS)
    pack_heads_kernel(const __grid_constant__ PackOps ops,
                      bf16* __restrict__ pack, int heads,
                      int n, int dh, int vec, long long rows) {
  constexpr int CH = DHP / 8;
  const long long i = (long long)blockIdx.x * PACK_THREADS + threadIdx.x;
  if (i >= rows * CH) return;
  const long long r = i / CH;
  const int c = (int)(i % CH) * 8, row = (int)(r % n);
  const long long bh = r / n;
  const InHeads& x = ops.x[blockIdx.y];
  const bf16* src = x.head((int)(bh / heads), (int)(bh % heads)) +
                    row * x.sr + c;
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (c < dh) {
    if (vec == 8) {
      out = *reinterpret_cast<const uint4*>(src);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (vec == 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + 2 * e < dh) w[e] = *reinterpret_cast<const uint32_t*>(
                                  src + 2 * e);
      } else {
        const unsigned short* hs = reinterpret_cast<const unsigned short*>(
            src);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c + e < dh) w[e >> 1] |= (uint32_t)hs[e] << (16 * (e & 1));
      }
      out = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  *reinterpret_cast<uint4*>(pack + ((long long)blockIdx.y * rows + r) * DHP +
                            c) = out;
}

// q, k, v, dout packed into pack (4 [batch, heads, n, DHP] bf16) and
// returned as its heads
template <int DHP>
static cudaError_t launch_pack_heads(InHeads (&ops)[4], bf16* pack,
                                     int batch, int heads, int n, int dh,
                                     cudaStream_t s) {
  const int vec = ops_vec(dh, ops[0], ops[1], ops[2], ops[3]);
  const long long rows = (long long)batch * heads * n;
  const long long chunks = rows * (DHP / 8);
  const dim3 grid((unsigned)((chunks + PACK_THREADS - 1) / PACK_THREADS), 4);
  pack_heads_kernel<DHP><<<grid, PACK_THREADS, 0, s>>>(
      PackOps{{ops[0], ops[1], ops[2], ops[3]}}, pack, heads, n, dh, vec,
      rows);
  for (int i = 0; i < 4; ++i)
    ops[i] = {pack + i * rows * DHP, (long long)heads * n * DHP,
              (long long)n * DHP, DHP};
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// with CTX_SUBLAYER, the four warps' dmask sums besides (below the key
// side's shared memory at every head dim)
template <int DHP, int CTX>
static size_t bwd_q_smem() {
  return 1024 + (size_t)(2 + 2 * BWD_STAGES) * head_tile<DHP>() +
         (1 + BWD_STAGES) * 8 + (CTX == CTX_SUBLAYER ? 4 * DHP * 4 : 0);
}

template <int DHP>
static size_t bwd_kv_smem() {
  return 1024 + 2 * (size_t)head_tile<DHP>() +
         (size_t)BWD_STAGES * (2 * head_tile<DHP>() + BWD_STAT_BYTES) +
         (1 + BWD_STAGES) * 8;
}

// Query side: one CTA per (64-query tile, head, image).  Items 0 ..
// 3 tiles - 1 stream the key tiles three times (K, then K and V):
// pass 0 the online (max, s), pass 1 row and ctx, pass 2 dq.  stats:
// [B * H * tiles * 64] (max * log2 e, 1 / s, row, 0), every row of every
// tile.
template <int DHP, int CTX, bool TMA>
static __global__ void __launch_bounds__(CORE_THREADS, 3)
    core_bwd_q_wg_kernel(const __grid_constant__ CoreMaps maps, InHeads q,
                         InHeads k, InHeads v, InHeads dout, OutHeads dq,
                         CtxOut cx, float4* __restrict__ stats, int n,
                         int dh, float scale, int vec) {
  constexpr bool WIDE = wide_tile<DHP, TMA>();
  constexpr int TILE = head_tile<DHP>(), S = BWD_STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_1k(smem_raw);
  unsigned char* Ds = Qs + TILE;
  unsigned char* ring = Ds + TILE;  // stage i: K at ring + 2 i TILE, then V
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + 2 * S * TILE);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n + TILE_ROWS - 1) / TILE_ROWS, items = 3 * tiles;
  const float c2 = scale * LOG2E;
  if (TMA) init_bars<BWD_STAGES>(bar, tid);

  // bar[0]: Q and dO; bar[1 + i]: stage i
  auto issue = [&](int it) {
    if (it < items) {
      const int row0 = (it % tiles) * TILE_ROWS;
      const bool with_v = it >= tiles;
      unsigned char* Ks = ring + 2 * (it % S) * TILE;
      if (TMA) {
        if (tid == 0) {
          uint64_t* full = bar + 1 + it % S;
          mbar_expect_tx(full, with_v ? 2 * TILE : TILE);
          tma_rows<DHP>(Ks, maps, OP_K, full, b, h, row0);
          if (with_v) tma_rows<DHP>(Ks + TILE, maps, OP_V, full, b, h, row0);
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
      tma_rows<DHP>(Qs, maps, OP_Q, bar, b, h, qt * TILE_ROWS);
      tma_rows<DHP>(Ds, maps, OP_DOUT, bar, b, h, qt * TILE_ROWS);
    }
  } else {
    async_tile<DHP>(Qs, q, b, h, qt * TILE_ROWS, n, dh, vec, tid);
    async_tile<DHP>(Ds, dout, b, h, qt * TILE_ROWS, n, dh, vec, tid);
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
    head_dot<DHP, WIDE>(s, Qs, Ks);
    if (pass > 0) head_dot<DHP, WIDE>(dp, Ds, Vs);
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(dp);

    // keys past n: the last tile's columns from n - kt * 64 on
    const int valid = n - kt * TILE_ROWS - 2 * t;
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
        if (CTX != CTX_NONE) {
          pack_a(a, s);
          wg_fence();
          head_acc<DHP, WIDE>(acc, a, Vs);
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
            const int qi = qt * TILE_ROWS + warp * 16 + g + 8 * hh;
            if (t == 0)
              stats[bh * tiles * TILE_ROWS + qi] =
                  make_float4(m[hh], l[hh], rw[hh], 0.f);
            const long long off = (long long)b * cx.sb +
                                  (long long)h * cx.sh + qi * cx.sr;
            if (CTX == CTX_BF16 && qi < n)
              store_acc_row<DHP>(cx.out + off, acc, hh, t, dh, vec, 1.f);
            if (CTX == CTX_SUBLAYER && qi < n)
              store_ctxm_row<DHP>(cx, off, h, acc, hh, t, dh);
          }
          if (CTX == CTX_SUBLAYER)
            dmask_partial<DHP>(cx, acc, reinterpret_cast<float*>(bar + 1 + S),
                               b, h, gridDim.y, qt, tiles, tid,
                               qt * TILE_ROWS + warp * 16 + g, n, dh);
#pragma unroll
          for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
        }
      } else {
        // ds = bf16(probs * (dp - row)), dq += ds . K
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= dp[i] - rw[(i >> 1) & 1];
        pack_a(a, s);
        wg_fence();
        head_acc<DHP, WIDE>(acc, a, Ks);
        wg_commit();
        wg_wait();
        fence_acc(acc);
      }
    }
    __syncthreads();  // the stage is free for the next refill
  }

  // the ring is free: on the TMA path dq's rows through it where they
  // take 16-byte stores
  if (TMA && vec == 8) {
    stage_rows<DHP>(reinterpret_cast<bf16*>(ring), acc, scale, tid);
    __syncthreads();
    store_staged<DHP>(dq, reinterpret_cast<const bf16*>(ring), b, h,
                      qt * TILE_ROWS, n, dh, tid);
    return;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = qt * TILE_ROWS + warp * 16 + g + 8 * hh;
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
  constexpr bool WIDE = wide_tile<DHP, TMA>();
  constexpr int TILE = head_tile<DHP>(), S = BWD_STAGES;
  constexpr int STAGE = 2 * TILE + BWD_STAT_BYTES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Ks = smem_1k(smem_raw);
  unsigned char* Vs = Ks + TILE;
  unsigned char* ring = Vs + TILE;  // stage i: Q, dO, stats
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + S * STAGE);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = (n + TILE_ROWS - 1) / TILE_ROWS;
  const float c2 = scale * LOG2E;
  const float4* st_head =
      stats + ((long long)b * gridDim.y + h) * tiles * TILE_ROWS;
  if (TMA) init_bars<BWD_STAGES>(bar, tid);

  auto issue = [&](int it) {
    if (it < tiles) {
      unsigned char* Qs = ring + (it % S) * STAGE;
      if (TMA) {
        if (tid == 0) {
          uint64_t* full = bar + 1 + it % S;
          mbar_expect_tx(full, STAGE);
          tma_rows<DHP>(Qs, maps, OP_Q, full, b, h, it * TILE_ROWS);
          tma_rows<DHP>(Qs + TILE, maps, OP_DOUT, full, b, h, it * TILE_ROWS);
          bulk_load(Qs + 2 * TILE, st_head + it * TILE_ROWS, BWD_STAT_BYTES,
                    full);
        }
      } else {
        async_tile<DHP>(Qs, q, b, h, it * TILE_ROWS, n, dh, vec, tid);
        async_tile<DHP>(Qs + TILE, dout, b, h, it * TILE_ROWS, n, dh, vec, tid);
        if (tid < TILE_ROWS)
          cp_async16(Qs + 2 * TILE + 16 * tid, st_head + it * TILE_ROWS + tid,
                     true);
      }
    }
    if (!TMA) cp_async_commit();
    __syncwarp();
  };

  if (TMA) {
    if (tid == 0) {
      mbar_expect_tx(bar, 2 * TILE);
      tma_rows<DHP>(Ks, maps, OP_K, bar, b, h, kt * TILE_ROWS);
      tma_rows<DHP>(Vs, maps, OP_V, bar, b, h, kt * TILE_ROWS);
    }
  } else {
    async_tile<DHP>(Ks, k, b, h, kt * TILE_ROWS, n, dh, vec, tid);
    async_tile<DHP>(Vs, v, b, h, kt * TILE_ROWS, n, dh, vec, tid);
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
    head_dot<DHP, WIDE>(s, Ks, Qs);
    head_dot<DHP, WIDE>(dp, Vs, Ds);
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(dp);

    // probs^T in place of the logits, ds^T in place of dp^T; zero for the
    // queries past n
    const int valid = n - it * TILE_ROWS - 2 * t;
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
    head_acc<DHP, WIDE>(av, ap, Ds);
    head_acc<DHP, WIDE>(ak, as, Qs);
    wg_commit();
    wg_wait();
    fence_acc(av);
    fence_acc(ak);
    __syncthreads();  // the stage is free for the next refill
  }

  // the ring is free: on the TMA path dk's and dv's rows through it where
  // they take 16-byte stores
  if (TMA && vec == 8) {
    bf16* rows = reinterpret_cast<bf16*>(ring);
    stage_rows<DHP>(rows, ak, scale, tid);
    stage_rows<DHP>(rows + STAGED_ROWS<DHP>, av, 1.f, tid);
    __syncthreads();
    store_staged<DHP>(dk, rows, b, h, kt * TILE_ROWS, n, dh, tid);
    store_staged<DHP>(dv, rows + STAGED_ROWS<DHP>, b, h, kt * TILE_ROWS, n,
                      dh, tid);
    return;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kt * TILE_ROWS + warp * 16 + g + 8 * hh;
    if (key >= n) continue;
    store_acc_row<DHP>(dk.head(b, h) + key * dk.sr, ak, hh, t, dh, vec,
                       scale);
    store_acc_row<DHP>(dv.head(b, h) + key * dv.sr, av, hh, t, dh, vec, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int DHP, int CTX, bool TMA>
static cudaError_t run_core_bwd_wg(const CoreMaps& maps, InHeads q, InHeads k,
                                   InHeads v, InHeads dout, OutHeads dq,
                                   OutHeads dk, OutHeads dv, const CtxOut& cx,
                                   float4* stats, int batch, int heads, int n,
                                   int dh, float scale, int vec,
                                   cudaStream_t s) {
  const dim3 grid((n + TILE_ROWS - 1) / TILE_ROWS, heads, batch);
  size_t smem = bwd_q_smem<DHP, CTX>();
  cudaError_t err = set_smem(core_bwd_q_wg_kernel<DHP, CTX, TMA>, smem);
  if (err != cudaSuccess) return err;
  core_bwd_q_wg_kernel<DHP, CTX, TMA><<<grid, CORE_THREADS, smem, s>>>(
      maps, q, k, v, dout, dq, cx, stats, n, dh, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = bwd_kv_smem<DHP>();
  err = set_smem(core_bwd_kv_wg_kernel<DHP, TMA>, smem);
  if (err != cudaSuccess) return err;
  core_bwd_kv_wg_kernel<DHP, TMA><<<grid, CORE_THREADS, smem, s>>>(
      maps, q, k, v, dout, stats, dk, dv, n, dh, scale, vec);
  return cudaGetLastError();
}

// Backward on the caller's stream: dq, dk, dv and what CTX asks of ctx
// (cx; unused with CTX_NONE).  stats: [B * heads * ceil(N / 64) * 64]
// float4 scratch.  The route follows the operands: inputs that are full
// tiles (full_tiles) load by TMA as they lie; inputs that allow 16-byte
// copies load by cp.async (a head dim below its padded width); the
// others, given pack (4 [B, heads, N, DHP] bf16 scratch), are packed into
// it by one more launch first and load by TMA from there, and without
// pack load by cp.async 4 or 2 bytes wide (the sublayers at resnext's
// head dim 12).  The outputs are written at dh into the caller's layout,
// on the TMA path staged through shared memory where every output takes
// 16-byte stores.
template <int DHP, int CTX>
static cudaError_t launch_core_bwd_wg(InHeads q, InHeads k, InHeads v,
                                      InHeads dout, OutHeads dq, OutHeads dk,
                                      OutHeads dv, const CtxOut& cx,
                                      float4* stats, bf16* pack, int batch,
                                      int heads, int n, int dh, float scale,
                                      cudaStream_t s) {
  // cx is all zeros (any copy width) with CTX_NONE
  const int out_vec = ops_vec(dh, dq, dk, dv, cx.heads());
  const int in_vec = ops_vec(dh, q, k, v, dout);
  InHeads in[4] = {q, k, v, dout};
  bool full = full_tiles<DHP>(dh, q, k, v, dout);
  if (in_vec < 8 && pack != nullptr) {
    const cudaError_t err =
        launch_pack_heads<DHP>(in, pack, batch, heads, n, dh, s);
    if (err != cudaSuccess) return err;
    full = true;
  }
  if (full) {
    CoreMaps maps;
    const InHeads* ops[4] = {&in[0], &in[1], &in[2], &in[3]};
    const cudaError_t err = head_maps<DHP>(maps, ops, batch, heads, n);
    if (err != cudaSuccess) return err;
    return run_core_bwd_wg<DHP, CTX, true>(maps, in[0], in[1], in[2], in[3],
                                           dq, dk, dv, cx, stats, batch,
                                           heads, n, dh, scale, out_vec, s);
  }
  return run_core_bwd_wg<DHP, CTX, false>(
      CoreMaps{}, q, k, v, dout, dq, dk, dv, cx, stats, batch, heads, n, dh,
      scale, std::min(out_vec, in_vec), s);
}

}  // namespace uvc
