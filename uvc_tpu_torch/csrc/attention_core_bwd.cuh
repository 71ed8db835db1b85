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
// Design.  Two launches, no float atomics, each output tile written by one
// CTA (two launches give the same bits):
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
// holds them and the products on them): 32-byte-swizzled 16-column boxes,
// TMA when every operand is a full tile (A8's and the sublayers' head
// views of the qkv rows at head dims 64 and 80, A9's contiguous heads of
// 16-80), else cp.async at the widest copy the operands allow (the
// sublayers' 4-byte copies at resnext's head dim 12).
#pragma once

#include "attention_core_fwd.cuh"

namespace uvc {

constexpr int BWD_STAGES = 2;                     // the streamed ring
constexpr int BWD_STAT_BYTES = TILE_ROWS * 16;    // a tile's (max, 1/s, row, 0)

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
  if (TMA) dh = DHP, vec = 8;
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
      tma_tile<DHP>(Qs, maps.q, bar, b, h, qt * TILE_ROWS);
      tma_tile<DHP>(Ds, maps.dout, bar, b, h, qt * TILE_ROWS);
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
    tile_dot<DHP>(s, Qs, Ks);
    if (pass > 0) tile_dot<DHP>(dp, Ds, Vs);
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
  if (TMA) dh = DHP, vec = 8;
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
          tma_tile<DHP>(Qs, maps.q, full, b, h, it * TILE_ROWS);
          tma_tile<DHP>(Qs + TILE, maps.dout, full, b, h, it * TILE_ROWS);
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
      tma_tile<DHP>(Ks, maps.k, bar, b, h, kt * TILE_ROWS);
      tma_tile<DHP>(Vs, maps.v, bar, b, h, kt * TILE_ROWS);
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
    tile_dot<DHP>(s, Ks, Qs);
    tile_dot<DHP>(dp, Vs, Ds);
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

// Backward, two launches on the caller's stream: dq, dk, dv and what CTX
// asks of ctx (cx; unused with CTX_NONE).  stats: [B * heads *
// ceil(N / 64) * 64] float4 scratch.
template <int DHP, int CTX>
static cudaError_t launch_core_bwd_wg(InHeads q, InHeads k, InHeads v,
                                      InHeads dout, OutHeads dq, OutHeads dk,
                                      OutHeads dv, const CtxOut& cx,
                                      float4* stats, int batch, int heads,
                                      int n, int dh, float scale,
                                      cudaStream_t s) {
  // cx is all zeros (any copy width) with CTX_NONE
  const int vec = ops_vec(dh, q, k, v, dout, dq, dk, dv, cx.heads());
  if (dh == DHP && vec == 8 && has_strides(q) && has_strides(k) &&
      has_strides(v) && has_strides(dout)) {
    CoreMaps maps;
    cudaError_t err = tile_map(maps.q, q, batch, heads, n, dh);
    if (err == cudaSuccess) err = tile_map(maps.k, k, batch, heads, n, dh);
    if (err == cudaSuccess) err = tile_map(maps.v, v, batch, heads, n, dh);
    if (err == cudaSuccess)
      err = tile_map(maps.dout, dout, batch, heads, n, dh);
    if (err != cudaSuccess) return err;
    return run_core_bwd_wg<DHP, CTX, true>(maps, q, k, v, dout, dq, dk, dv,
                                           cx, stats, batch, heads, n, dh,
                                           scale, vec, s);
  }
  return run_core_bwd_wg<DHP, CTX, false>(CoreMaps{}, q, k, v, dout, dq, dk,
                                          dv, cx, stats, batch, heads, n, dh,
                                          scale, vec, s);
}

}  // namespace uvc
