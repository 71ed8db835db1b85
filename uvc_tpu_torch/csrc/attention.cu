// LN-fused attention sublayer, forward:
//   out = x + (mask * MHA(LN1(x) @ Wqkv + bqkv)) @ Wproj + bproj
//
// Replaces uvc_tpu/ops/attention.py::_layer_ln_fwd_kernel (called through
// _call_layer_ln_fwd).  The backward, uvc_layer_attention_ln_bwd, replaces
// _layer_ln_bwd_kernel, and uvc_layer_attention / uvc_layer_attention_bwd
// replace _layer_fwd_kernel / _layer_bwd_kernel (the same sublayer without
// LayerNorm and residual); their notes (bound, design) are at their entry
// points at the end of this file.
//
// What bounds it on the H100: at DeiT-Small widths (dm = 384, N = 197,
// head dim 64) the three matrix products carry ~18.7 GFLOP per batch of 64
// against ~20 MB of input and output, so the tensor cores, not the 3.35 TB/s
// of device memory, set the floor (~19 us at 989 TFLOP/s).
//
// Design: four launches on the caller's stream (2-4 are sublayer_fwd).
//   1. layer_norm_kernel: a_in = bf16(LN1(x)) in f32 -> [B*N, dm].
//   2. gemm_kernel<EPI_BIAS>: qkv = bf16(a_in @ Wqkv + bqkv) -> [B*N, 3*da].
//   3. attention_kernel (below): one CTA per (64-query tile, head, image);
//      K and V of the head live in shared memory, keys at or beyond N are
//      masked inside the kernel (no padding of N), f32 logits and softmax,
//      the normalisation applied after P @ V as the Pallas body does;
//      ctx = bf16(bf16(ctx) * mask) -> ctx [B*N, da], head-major.
//   4. gemm_kernel<EPI_RESID>: out = bf16(x + (ctx @ Wproj + bproj)).
// The TPU kernel kept a_in, qkv and ctx in VMEM; here they make one round
// trip each through device memory (~10 x 9.7 MB at B = 64, dm = da = 384).
// Fusing them back is later work.  The attention width da = 64 * heads may
// differ from dm (compacted layers).
#include "common.cuh"

namespace uvc {

constexpr int ATT_DH = 64;       // head dim the kernel is written for
constexpr int ATT_QT = 64;       // query rows per CTA (16 per warp)
constexpr int ATT_LD = ATT_DH + 8;  // shared-memory row stride (elements)
constexpr int ATT_THREADS = 128;

static size_t attention_smem_bytes(int n) {
  const int np = (n + 15) & ~15;
  return (size_t)(ATT_QT + 2 * np) * ATT_LD * sizeof(bf16);
}

static __global__ void __launch_bounds__(ATT_THREADS)
    attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ mask,
                     bf16* __restrict__ ctx, int n, int da, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + ATT_QT * ATT_LD;
  bf16* Vs = Ks + np * ATT_LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * n;
  const int ld = 3 * da;

  // stage the query tile and the head's K and V, all copies in flight at
  // once; rows past n are zero-filled
  const bf16* head = qkv + row0 * ld + h * ATT_DH;
  for (int c = tid; c < ATT_QT * (ATT_DH / 8); c += ATT_THREADS) {
    const int r = c / (ATT_DH / 8), dc = (c % (ATT_DH / 8)) * 8;
    const int q = qt * ATT_QT + r;
    cp_async16(Qs + r * ATT_LD + dc, head + (q < n ? (size_t)q * ld + dc : 0),
               q < n);
  }
  for (int c = tid; c < np * (ATT_DH / 8); c += ATT_THREADS) {
    const int r = c / (ATT_DH / 8), dc = (c % (ATT_DH / 8)) * 8;
    const size_t off = r < n ? (size_t)r * ld + dc : 0;
    cp_async16(Ks + r * ATT_LD + dc, head + off + da, r < n);
    cp_async16(Vs + r * ATT_LD + dc, head + off + 2 * da, r < n);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // this warp's 16 query rows as A fragments over the head dim
  uint32_t qf[ATT_DH / 16][4];
  {
    const bf16* q0 = Qs + (warp * 16 + g) * ATT_LD;
    const bf16* q8 = q0 + 8 * ATT_LD;
#pragma unroll
    for (int kk = 0; kk < ATT_DH / 16; ++kk) {
      qf[kk][0] = *reinterpret_cast<const uint32_t*>(q0 + kk * 16 + 2 * t);
      qf[kk][1] = *reinterpret_cast<const uint32_t*>(q8 + kk * 16 + 2 * t);
      qf[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + kk * 16 + 2 * t + 8);
      qf[kk][3] = *reinterpret_cast<const uint32_t*>(q8 + kk * 16 + 2 * t + 8);
    }
  }

  // logits of 8 keys starting at key j: s[0..1] row g, s[2..3] row g + 8,
  // keys j + 2t and j + 2t + 1
  auto logits8 = [&](int j, float (&s)[4]) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
    const bf16* kr = Ks + (j + g) * ATT_LD;
#pragma unroll
    for (int kk = 0; kk < ATT_DH / 16; ++kk) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 2 * t);
      const uint32_t b1 =
          *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 2 * t + 8);
      mma_bf16(s, qf[kk], b0, b1);
    }
  };

  // pass 1: the row max over all valid keys
  float mx0 = -INFINITY, mx1 = -INFINITY;
  for (int j = 0; j < np; j += 8) {
    float s[4];
    logits8(j, s);
    const int k0 = j + 2 * t;
    if (k0 < n) {
      mx0 = fmaxf(mx0, s[0] * scale);
      mx1 = fmaxf(mx1, s[2] * scale);
    }
    if (k0 + 1 < n) {
      mx0 = fmaxf(mx0, s[1] * scale);
      mx1 = fmaxf(mx1, s[3] * scale);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }

  // pass 2: p = exp(logit - max) in f32, row sums of the unrounded p,
  // P (bf16) @ V accumulated in f32, 16 keys at a time
  float o[ATT_DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < ATT_DH / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < np; j += 16) {
    float s0[4], s1[4];
    logits8(j, s0);
    logits8(j + 8, s1);
    float p0[4], p1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j + 2 * t + (e & 1);
      const float m = (e < 2) ? mx0 : mx1;
      p0[e] = (key < n) ? expf(s0[e] * scale - m) : 0.f;
      p1[e] = (key + 8 < n) ? expf(s1[e] * scale - m) : 0.f;
    }
    l0 += p0[0] + p0[1] + p1[0] + p1[1];
    l1 += p0[2] + p0[3] + p1[2] + p1[3];
    const uint32_t pa[4] = {pack_f32(p0[0], p0[1]), pack_f32(p0[2], p0[3]),
                            pack_f32(p1[0], p1[1]), pack_f32(p1[2], p1[3])};
    // V fragments of two 8-wide column tiles per ldmatrix (V is [key][d])
#pragma unroll
    for (int dp = 0; dp < ATT_DH / 16; ++dp) {
      uint32_t vb[4];
      ldmatrix_x4_trans(
          vb, Vs + (j + (lane & 15)) * ATT_LD + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // ctx = bf16(bf16(o / l) * mask), written head-major into [B*N, da]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = qt * ATT_QT + warp * 16 + g + 8 * hh;
    if (q >= n) continue;
    const float l = hh ? l1 : l0;
    bf16* out = ctx + (row0 + q) * da + h * ATT_DH;
#pragma unroll
    for (int dn = 0; dn < ATT_DH / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      const float c0 = bf2f(f2bf(o[dn][2 * hh] / l)) * bf2f(mask[h * ATT_DH + c]);
      const float c1 =
          bf2f(f2bf(o[dn][2 * hh + 1] / l)) * bf2f(mask[h * ATT_DH + c + 1]);
      *reinterpret_cast<uint32_t*>(out + c) = pack_f32(c0, c1);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward (port of _layer_ln_bwd_kernel).  See the note at the entry point
// uvc_layer_attention_ln_bwd below.
// ---------------------------------------------------------------------------

// shared memory of either backward attention kernel: two 64-row tiles,
// two whole-sequence operands, and (key kernel) one float4 of softmax
// statistics per query
static size_t attention_bwd_smem_bytes(int n) {
  const int np = (n + 15) & ~15;
  return (size_t)(2 * ATT_QT + 2 * np) * ATT_LD * sizeof(bf16) +
         (size_t)np * sizeof(float4);
}

// A fragments (16 rows x 64) of this warp's rows of a [rows][ATT_LD] tile
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[ATT_DH / 16][4],
                                             const bf16* tile, int warp,
                                             int g, int t) {
  const bf16* r0 = tile + (warp * 16 + g) * ATT_LD;
  const bf16* r8 = r0 + 8 * ATT_LD;
#pragma unroll
  for (int kk = 0; kk < ATT_DH / 16; ++kk) {
    f[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + kk * 16 + 2 * t);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(r8 + kk * 16 + 2 * t);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + kk * 16 + 2 * t + 8);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(r8 + kk * 16 + 2 * t + 8);
  }
}

// s[16 x 8] = A(16 x 64) . B^T for the 8 rows j..j+7 of a [rows][ATT_LD]
// operand B: s[0..1] row g, s[2..3] row g + 8, columns j + 2t and + 1
__device__ __forceinline__ void dot8(const uint32_t (&a)[ATT_DH / 16][4],
                                     const bf16* b, int j, int g, int t,
                                     float (&s)[4]) {
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const bf16* br = b + (j + g) * ATT_LD;
#pragma unroll
  for (int kk = 0; kk < ATT_DH / 16; ++kk) {
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br + kk * 16 + 2 * t);
    const uint32_t b1 =
        *reinterpret_cast<const uint32_t*>(br + kk * 16 + 2 * t + 8);
    mma_bf16(s, a[kk], b0, b1);
  }
}

// acc[64 cols] += P(16 x 16, packed A fragment) . B[j..j+15][0..63]
__device__ __forceinline__ void acc_pv(float (&acc)[ATT_DH / 8][4],
                                       const uint32_t (&pa)[4], const bf16* b,
                                       int j, int lane) {
#pragma unroll
  for (int dp = 0; dp < ATT_DH / 16; ++dp) {
    uint32_t vb[4];
    ldmatrix_x4_trans(
        vb, b + (j + (lane & 15)) * ATT_LD + dp * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
    mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
  }
}

// Stage `rows` rows of a head slice (64 wide, global row stride ld) into a
// [rows][ATT_LD] tile; rows at or past `valid` are zero-filled.
__device__ __forceinline__ void stage_rows(bf16* tile, const bf16* src,
                                           int first, int rows, int valid,
                                           int ld, int tid) {
  for (int c = tid; c < rows * (ATT_DH / 8); c += ATT_THREADS) {
    const int r = c / (ATT_DH / 8), dc = (c % (ATT_DH / 8)) * 8;
    const int gr = first + r;
    cp_async16(tile + r * ATT_LD + dc,
               src + (gr < valid ? (size_t)gr * ld + dc : 0), gr < valid);
  }
}

// Query-side kernel: one CTA per (64-query tile, head, image), 16 queries
// per warp, the head's K and V in shared memory.  Four passes over the
// keys, recomputing the logits each time: the row max; s = sum(p); then
// probs = p / s, ctx = bf16(probs) . V, dp = dO . V^T and
// row = sum(dp * probs); then ds = bf16(probs * (dp - row)) and dq = ds . K.
// Writes ctx (f32) and bf16(ctx * mask) [B*N, da], dq * scale into the q
// columns of dqkv, and (max, s, row) per query for the key-side kernel.
static __global__ void __launch_bounds__(ATT_THREADS)
    attention_bwd_q_kernel(const bf16* __restrict__ qkv,
                           const bf16* __restrict__ dctx,
                           const bf16* __restrict__ mask,
                           float* __restrict__ ctx, bf16* __restrict__ ctxm,
                           bf16* __restrict__ dqkv, float4* __restrict__ stats,
                           int n, int da, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + ATT_QT * ATT_LD;
  bf16* Ks = Ds + ATT_QT * ATT_LD;
  bf16* Vs = Ks + np * ATT_LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * n;
  const int ld = 3 * da;
  const bf16* head = qkv + row0 * ld + h * ATT_DH;
  const bf16* dhead = dctx + row0 * da + h * ATT_DH;

  stage_rows(Qs, head, qt * ATT_QT, ATT_QT, n, ld, tid);
  stage_rows(Ds, dhead, qt * ATT_QT, ATT_QT, n, da, tid);
  stage_rows(Ks, head + da, 0, np, n, ld, tid);
  stage_rows(Vs, head + 2 * da, 0, np, n, ld, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[ATT_DH / 16][4], df[ATT_DH / 16][4];
  load_a_frags(qf, Qs, warp, g, t);
  load_a_frags(df, Ds, warp, g, t);

  // pass 1: the row max over all valid keys
  float mx0 = -INFINITY, mx1 = -INFINITY;
  for (int j = 0; j < np; j += 8) {
    float s[4];
    dot8(qf, Ks, j, g, t, s);
    const int k0 = j + 2 * t;
    if (k0 < n) {
      mx0 = fmaxf(mx0, s[0] * scale);
      mx1 = fmaxf(mx1, s[2] * scale);
    }
    if (k0 + 1 < n) {
      mx0 = fmaxf(mx0, s[1] * scale);
      mx1 = fmaxf(mx1, s[3] * scale);
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
  }

  // pass 2: s = sum of p = exp(logit - max) over the valid keys
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < np; j += 8) {
    float s[4];
    dot8(qf, Ks, j, g, t, s);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = (j + 2 * t + (e & 1) < n)
                          ? expf(s[e] * scale - ((e < 2) ? mx0 : mx1))
                          : 0.f;
      if (e < 2) l0 += p; else l1 += p;
    }
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // probs of 16 keys from j: pr0 keys j + 2t (+1), pr1 keys j + 8 + 2t (+1)
  auto probs16 = [&](int j, float (&pr0)[4], float (&pr1)[4]) {
    float s0[4], s1[4];
    dot8(qf, Ks, j, g, t, s0);
    dot8(qf, Ks, j + 8, g, t, s1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j + 2 * t + (e & 1);
      const float m = (e < 2) ? mx0 : mx1;
      const float l = (e < 2) ? l0 : l1;
      pr0[e] = (key < n) ? expf(s0[e] * scale - m) / l : 0.f;
      pr1[e] = (key + 8 < n) ? expf(s1[e] * scale - m) / l : 0.f;
    }
  };

  // pass 3: ctx = bf16(probs) . V, row = sum(dp * probs)
  float acc[ATT_DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < ATT_DH / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float rw0 = 0.f, rw1 = 0.f;
  for (int j = 0; j < np; j += 16) {
    float pr0[4], pr1[4], dp0[4], dp1[4];
    probs16(j, pr0, pr1);
    dot8(df, Vs, j, g, t, dp0);
    dot8(df, Vs, j + 8, g, t, dp1);
    rw0 += dp0[0] * pr0[0] + dp0[1] * pr0[1] + dp1[0] * pr1[0] +
           dp1[1] * pr1[1];
    rw1 += dp0[2] * pr0[2] + dp0[3] * pr0[3] + dp1[2] * pr1[2] +
           dp1[3] * pr1[3];
    const uint32_t pa[4] = {pack_f32(pr0[0], pr0[1]), pack_f32(pr0[2], pr0[3]),
                            pack_f32(pr1[0], pr1[1]), pack_f32(pr1[2], pr1[3])};
    acc_pv(acc, pa, Vs, j, lane);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    rw0 += __shfl_xor_sync(0xffffffffu, rw0, o);
    rw1 += __shfl_xor_sync(0xffffffffu, rw1, o);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = qt * ATT_QT + warp * 16 + g + 8 * hh;
    if (q >= n) continue;
    const size_t off = (row0 + q) * da + h * ATT_DH;
#pragma unroll
    for (int dn = 0; dn < ATT_DH / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      const float c0 = acc[dn][2 * hh], c1 = acc[dn][2 * hh + 1];
      *reinterpret_cast<float2*>(ctx + off + c) = make_float2(c0, c1);
      *reinterpret_cast<uint32_t*>(ctxm + off + c) =
          pack_f32(c0 * bf2f(mask[h * ATT_DH + c]),
                   c1 * bf2f(mask[h * ATT_DH + c + 1]));
    }
    if (t == 0)
      stats[((size_t)b * heads + h) * n + q] =
          make_float4(hh ? mx1 : mx0, hh ? l1 : l0, hh ? rw1 : rw0, 0.f);
  }

  // pass 4: ds = bf16(probs * (dp - row)), dq = ds . K
#pragma unroll
  for (int dn = 0; dn < ATT_DH / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int j = 0; j < np; j += 16) {
    float pr0[4], pr1[4], dp0[4], dp1[4];
    probs16(j, pr0, pr1);
    dot8(df, Vs, j, g, t, dp0);
    dot8(df, Vs, j + 8, g, t, dp1);
    float ds0[4], ds1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = (e < 2) ? rw0 : rw1;
      ds0[e] = pr0[e] * (dp0[e] - r);
      ds1[e] = pr1[e] * (dp1[e] - r);
    }
    const uint32_t pa[4] = {pack_f32(ds0[0], ds0[1]), pack_f32(ds0[2], ds0[3]),
                            pack_f32(ds1[0], ds1[1]), pack_f32(ds1[2], ds1[3])};
    acc_pv(acc, pa, Ks, j, lane);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = qt * ATT_QT + warp * 16 + g + 8 * hh;
    if (q >= n) continue;
    bf16* out = dqkv + (row0 + q) * ld + h * ATT_DH;
#pragma unroll
    for (int dn = 0; dn < ATT_DH / 8; ++dn)
      *reinterpret_cast<uint32_t*>(out + dn * 8 + 2 * t) =
          pack_f32(acc[dn][2 * hh] * scale, acc[dn][2 * hh + 1] * scale);
  }
}

// Key-side kernel: one CTA per (64-key tile, head, image), 16 keys per
// warp, the head's Q and dO and the per-query statistics in shared memory.
// One pass over the queries computes the transposed logits K . Q^T, then
// probs^T = exp(logit - max[q]) / s[q], dp^T = V . dO^T,
// ds^T = bf16(probs^T * (dp^T - row[q])), and accumulates
// dv = bf16(probs^T) . dO and dk = ds^T . Q in registers.  Writes dk * scale
// and dv into the k and v columns of dqkv.
static __global__ void __launch_bounds__(ATT_THREADS)
    attention_bwd_kv_kernel(const bf16* __restrict__ qkv,
                            const bf16* __restrict__ dctx,
                            const float4* __restrict__ stats,
                            bf16* __restrict__ dqkv, int n, int da,
                            float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + 15) & ~15;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + ATT_QT * ATT_LD;
  bf16* Qs = Vs + ATT_QT * ATT_LD;
  bf16* Ds = Qs + np * ATT_LD;
  float4* St = reinterpret_cast<float4*>(Ds + np * ATT_LD);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * n;
  const int ld = 3 * da;
  const bf16* head = qkv + row0 * ld + h * ATT_DH;
  const bf16* dhead = dctx + row0 * da + h * ATT_DH;

  stage_rows(Ks, head + da, kt * ATT_QT, ATT_QT, n, ld, tid);
  stage_rows(Vs, head + 2 * da, kt * ATT_QT, ATT_QT, n, ld, tid);
  stage_rows(Qs, head, 0, np, n, ld, tid);
  stage_rows(Ds, dhead, 0, np, n, da, tid);
  cp_async_commit();
  const float4* st = stats + ((size_t)b * heads + h) * n;
  for (int q = tid; q < np; q += ATT_THREADS)
    St[q] = q < n ? st[q] : make_float4(0.f, 1.f, 0.f, 0.f);
  cp_async_wait<0>();
  __syncthreads();

  uint32_t kf[ATT_DH / 16][4], vf[ATT_DH / 16][4];
  load_a_frags(kf, Ks, warp, g, t);
  load_a_frags(vf, Vs, warp, g, t);

  float dk[ATT_DH / 8][4], dv[ATT_DH / 8][4];
#pragma unroll
  for (int dn = 0; dn < ATT_DH / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;

  for (int j = 0; j < np; j += 16) {
    float lt0[4], lt1[4], dt0[4], dt1[4];
    dot8(kf, Qs, j, g, t, lt0);
    dot8(kf, Qs, j + 8, g, t, lt1);
    dot8(vf, Ds, j, g, t, dt0);
    dot8(vf, Ds, j + 8, g, t, dt1);
    float pr0[4], pr1[4], ds0[4], ds1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q0 = j + 2 * t + (e & 1), q1 = q0 + 8;
      const float4 a = St[q0], c = St[q1];
      pr0[e] = q0 < n ? expf(lt0[e] * scale - a.x) / a.y : 0.f;
      pr1[e] = q1 < n ? expf(lt1[e] * scale - c.x) / c.y : 0.f;
      ds0[e] = pr0[e] * (dt0[e] - a.z);
      ds1[e] = pr1[e] * (dt1[e] - c.z);
    }
    const uint32_t pa[4] = {pack_f32(pr0[0], pr0[1]), pack_f32(pr0[2], pr0[3]),
                            pack_f32(pr1[0], pr1[1]), pack_f32(pr1[2], pr1[3])};
    const uint32_t sa[4] = {pack_f32(ds0[0], ds0[1]), pack_f32(ds0[2], ds0[3]),
                            pack_f32(ds1[0], ds1[1]), pack_f32(ds1[2], ds1[3])};
    acc_pv(dv, pa, Ds, j, lane);
    acc_pv(dk, sa, Qs, j, lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kt * ATT_QT + warp * 16 + g + 8 * hh;
    if (key >= n) continue;
    bf16* out = dqkv + (row0 + key) * ld + h * ATT_DH;
#pragma unroll
    for (int dn = 0; dn < ATT_DH / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(out + da + c) =
          pack_f32(dk[dn][2 * hh] * scale, dk[dn][2 * hh + 1] * scale);
      *reinterpret_cast<uint32_t*>(out + 2 * da + c) =
          pack_f32(dv[dn][2 * hh], dv[dn][2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch sequences shared by the LN-fused sublayer (K1 / A2) and the bare
// sublayer (A7): everything between the qkv projection's input `a` and the
// output projection, forward and backward.
// ---------------------------------------------------------------------------

// qkv = bf16(a . Wqkv + bqkv); ctx = bf16(bf16(MHA(qkv)) * mask);
// out = bf16(resid + (ctx . Wproj + bproj)), or bf16(ctx . Wproj + bproj)
// when resid is null.  Three launches.
static cudaError_t sublayer_fwd(const bf16* a, const bf16* wqkv,
                                const bf16* bqkv, const bf16* wproj,
                                const bf16* bproj, const bf16* mask,
                                const bf16* resid, bf16* qkv, bf16* ctx,
                                bf16* out, int batch, int n, int dm, int da,
                                int heads, float scale, cudaStream_t s) {
  const int rows = batch * n;
  GemmArgs p = {};
  p.a = a;
  p.w = wqkv;
  p.bias = bqkv;
  p.out = qkv;
  p.M = rows;
  p.N = 3 * da;
  p.K = dm;
  cudaError_t err = launch_gemm<EPI_BIAS>(p, s);
  if (err != cudaSuccess) return err;

  const size_t smem = attention_smem_bytes(n);
  err = cudaFuncSetAttribute(attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + ATT_QT - 1) / ATT_QT, heads, batch);
  attention_kernel<<<grid, ATT_THREADS, smem, s>>>(qkv, mask, ctx, n, da,
                                                    scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  GemmArgs q = {};
  q.a = ctx;
  q.w = wproj;
  q.bias = bproj;
  q.out = out;
  q.M = rows;
  q.N = dm;
  q.K = da;
  q.resid = resid;
  return resid ? launch_gemm<EPI_RESID>(q, s) : launch_gemm<EPI_BIAS>(q, s);
}

// Scratch and outputs of the sublayer backward below the qkv input.
struct SublayerBwd {
  const bf16 *a, *wqkv, *bqkv, *wproj, *mask, *dout;
  bf16* qkv;       // [rows, 3 da]
  float* t32;      // [rows, da]   do . Wproj^T
  bf16* dctx;      // [rows, da]   bf16(t * mask)
  float* ctx;      // [rows, da]   bf16(probs) . V
  bf16* ctxm;      // [rows, da]   bf16(ctx * mask)
  float4* stats;   // [B * heads * N]  (max, s, row) per query
  bf16* dqkv;      // [rows, 3 da]
  float* part;     // column-sum partials
  bf16 *dwqkv, *dbqkv, *dwproj, *dbproj, *dmask;
  int batch, n, dm, da, heads;
  float scale;
};

// Recomputes qkv from a, then emits dqkv (attention core), dWqkv, dWproj,
// dbqkv, dbproj and dmask = sum(t * ctx).  Twelve launches:
//   1. gemm <EPI_BIAS>: qkv = bf16(a . Wqkv + bqkv).
//   2. gemm <EPI_F32_MASK, [N][K] B>: t = do . Wproj^T (f32),
//      dctx = bf16(t * mask).
//   3. attention_bwd_q_kernel: ctx (f32), bf16(ctx * mask), dq, and the
//      per-query (max, s, row) -- per (query tile, head, image).
//   4. attention_bwd_kv_kernel: dk, dv -- per (key tile, head, image),
//      a loop over the queries takes the place of the Pallas kernel's
//      sequential accumulation, so no two CTAs write one output.
//   5. gemm <EPI_SCALE, [K][M] A>: dWqkv = a^T . dqkv over the B*N rows
//      (ragged K), summed in f32 and rounded once.
//   6. gemm <EPI_SCALE, [K][M] A>: dWproj = bf16(ctx * mask)^T . do.
//   7-12. three column sums, each partials per 128 rows and then an
//      in-order pass: dbqkv, dbproj, dmask.
// The caller takes d a = dqkv . Wqkv^T from dqkv.
static cudaError_t sublayer_bwd(const SublayerBwd& b, cudaStream_t s) {
  const int rows = b.batch * b.n;
  GemmArgs p = {};
  p.a = b.a;
  p.w = b.wqkv;
  p.bias = b.bqkv;
  p.out = b.qkv;
  p.M = rows;
  p.N = 3 * b.da;
  p.K = b.dm;
  cudaError_t err = launch_gemm<EPI_BIAS>(p, s);
  if (err != cudaSuccess) return err;

  p = {};
  p.a = b.dout;
  p.w = b.wproj;
  p.mask = b.mask;
  p.out32 = b.t32;
  p.out = b.dctx;
  p.M = rows;
  p.N = b.da;
  p.K = b.dm;
  err = launch_gemm<EPI_F32_MASK, false, true>(p, s);
  if (err != cudaSuccess) return err;

  const size_t smem = attention_bwd_smem_bytes(b.n);
  const dim3 grid((b.n + ATT_QT - 1) / ATT_QT, b.heads, b.batch);
  err = cudaFuncSetAttribute(attention_bwd_q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  attention_bwd_q_kernel<<<grid, ATT_THREADS, smem, s>>>(
      b.qkv, b.dctx, b.mask, b.ctx, b.ctxm, b.dqkv, b.stats, b.n, b.da,
      b.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attention_bwd_kv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  attention_bwd_kv_kernel<<<grid, ATT_THREADS, smem, s>>>(
      b.qkv, b.dctx, b.stats, b.dqkv, b.n, b.da, b.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  p = {};
  p.a = b.a;
  p.w = b.dqkv;
  p.out = b.dwqkv;
  p.M = b.dm;
  p.N = 3 * b.da;
  p.K = rows;
  err = launch_gemm<EPI_SCALE, true, false>(p, s);
  if (err != cudaSuccess) return err;

  p = {};
  p.a = b.ctxm;
  p.w = b.dout;
  p.out = b.dwproj;
  p.M = b.da;
  p.N = b.dm;
  p.K = rows;
  err = launch_gemm<EPI_SCALE, true, false>(p, s);
  if (err != cudaSuccess) return err;

  err = column_sum(b.dqkv, static_cast<const bf16*>(nullptr), rows, 3 * b.da,
                   b.part, nullptr, nullptr, b.dbqkv, s);
  if (err != cudaSuccess) return err;
  err = column_sum(b.dout, static_cast<const bf16*>(nullptr), rows, b.dm,
                   b.part, nullptr, nullptr, b.dbproj, s);
  if (err != cudaSuccess) return err;
  return column_sum(static_cast<const float*>(b.t32),
                    static_cast<const float*>(b.ctx), rows, b.da, b.part,
                    nullptr, nullptr, b.dmask, s);
}

}  // namespace uvc

using uvc::bf16;

// Returns 0 or the first CUDA error code.  All buffers are device pointers;
// a_in [B*N, dm], qkv [B*N, 3*da] and ctx [B*N, da] (bf16) are scratch that
// the caller allocates.
extern "C" int uvc_layer_attention_ln(
    const void* x, const void* g1, const void* b1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* bproj, const void* mask,
    void* a_in, void* qkv, void* ctx, void* out, int batch, int n, int dm,
    int da, int heads, float scale, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = uvc::launch_layer_norm(
      static_cast<const bf16*>(x), static_cast<const float*>(g1),
      static_cast<const float*>(b1), batch * n, dm, eps,
      static_cast<bf16*>(a_in), s);
  if (err != cudaSuccess) return (int)err;
  return (int)uvc::sublayer_fwd(
      static_cast<const bf16*>(a_in), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const bf16*>(bproj), static_cast<const bf16*>(mask),
      static_cast<const bf16*>(x), static_cast<bf16*>(qkv),
      static_cast<bf16*>(ctx), static_cast<bf16*>(out), batch, n, dm, da,
      heads, scale, s);
}

// The attention sublayer without LayerNorm and residual, forward:
//   out = (mask * MHA(x @ Wqkv + bqkv)) @ Wproj + bproj
// The port of uvc_tpu/ops/attention.py::_layer_fwd_kernel (called through
// _fused_layer), kernel A7: the separate-LN branch of a block whose
// sublayer output is scaled before the residual add (part gating,
// drop-path).  It is uvc_layer_attention_ln without launch 1 (the
// LayerNorm pass) and with the bias epilogue in place of the residual one
// in launch 4: three launches, the same bound (~18.7 GFLOP against ~20 MB
// at B = 64, N = 197, dm = da = 384: the tensor cores, ~19 us).  qkv
// [B*N, 3*da] and ctx [B*N, da] (bf16) are scratch that the caller
// allocates.
extern "C" int uvc_layer_attention(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* mask, void* qkv, void* ctx, void* out,
    int batch, int n, int dm, int da, int heads, float scale, void* stream) {
  return (int)uvc::sublayer_fwd(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const bf16*>(bproj), static_cast<const bf16*>(mask),
      nullptr, static_cast<bf16*>(qkv), static_cast<bf16*>(ctx),
      static_cast<bf16*>(out), batch, n, dm, da, heads, scale,
      static_cast<cudaStream_t>(stream));
}


// Backward of the LN-fused attention sublayer: the port of
// uvc_tpu/ops/attention.py::_layer_ln_bwd_kernel (called through
// _call_layer_ln_bwd).  Emits dx (the residual included), dgamma1, dbeta1,
// dWqkv, dbqkv, dWproj, dbproj and dmask.
//
// What bounds it on the H100: at the stage-1 train shape (B = 64, N = 197,
// dm = da = 384, 6 heads) it does ~52.3 GFLOP: the qkv recompute, t and
// dWproj (3.72 each), dqkv . Wqkv^T and dWqkv (11.15 each), and the
// attention core (12 N^2 dh per (image, head) over 384 pairs, 11.44)
// against ~30 MB of inputs and outputs, so the tensor cores set the floor:
// ~53 us at 989 TFLOP/s.
//
// Design: seventeen launches on the caller's stream, no float atomics.
//   1. layer_norm_kernel: a_in = bf16(LN1(x)).
//   2-13. sublayer_bwd above with a = a_in: qkv recompute, t and dctx, the
//      two attention kernels, dWqkv, dWproj, dbqkv, dbproj, dmask.
//  14. gemm <EPI_F32, [N][K] B>: d a_in = dqkv . Wqkv^T (f32).
//  15. ln_bwd_kernel: dx = bf16(LN VJP + do), partial dgamma1 / dbeta1;
//      16-17. their fixed-order reductions.
// The TPU kernel kept every intermediate in VMEM.  Here a_in, qkv, t, dctx,
// ctx, dqkv and d a_in make a round trip through device memory (~9.7 MB
// each in bf16 at the train shape, twice that in f32); the logits and
// probabilities never do: each attention kernel recomputes them from q and
// k in registers.  Fusing the GEMM epilogues further and wgmma/TMA are
// later work.
extern "C" int uvc_layer_attention_ln_bwd(
    const void* x, const void* g1, const void* b1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* mask, const void* dout,
    void* a_in, void* qkv, void* t32, void* dctx, void* ctx, void* ctxm,
    void* stats, void* dqkv, void* da_in, void* part, void* dx, void* dg1,
    void* db1, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
    void* dmask, int batch, int n, int dm, int da, int heads, float scale,
    float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = batch * n;
  const bf16* xb = static_cast<const bf16*>(x);
  float* partf = static_cast<float*>(part);
  cudaError_t err = uvc::launch_layer_norm(
      xb, static_cast<const float*>(g1), static_cast<const float*>(b1), rows,
      dm, eps, static_cast<bf16*>(a_in), s);
  if (err != cudaSuccess) return (int)err;

  const uvc::SublayerBwd b = {
      static_cast<const bf16*>(a_in), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const bf16*>(mask), static_cast<const bf16*>(dout),
      static_cast<bf16*>(qkv), static_cast<float*>(t32),
      static_cast<bf16*>(dctx), static_cast<float*>(ctx),
      static_cast<bf16*>(ctxm), static_cast<float4*>(stats),
      static_cast<bf16*>(dqkv), partf, static_cast<bf16*>(dwqkv),
      static_cast<bf16*>(dbqkv), static_cast<bf16*>(dwproj),
      static_cast<bf16*>(dbproj), static_cast<bf16*>(dmask), batch, n, dm,
      da, heads, scale};
  err = uvc::sublayer_bwd(b, s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs p = {};
  p.a = b.dqkv;
  p.w = b.wqkv;
  p.out32 = static_cast<float*>(da_in);
  p.M = rows;
  p.N = dm;
  p.K = 3 * da;
  err = uvc::launch_gemm<uvc::EPI_F32, false, true>(p, s);
  if (err != cudaSuccess) return (int)err;

  uvc::LnBwdArgs l = {};
  const int lnp = uvc::ln_bwd_ctas(rows);
  l.x = xb;
  l.gamma = static_cast<const float*>(g1);
  l.dy = static_cast<const float*>(da_in);
  l.resid = b.dout;
  l.dx = static_cast<bf16*>(dx);
  l.part_dg = partf;
  l.part_db = partf + (size_t)lnp * dm;
  l.rows = rows;
  l.dm = dm;
  l.eps = eps;
  err = uvc::launch_ln_bwd(l, s);
  if (err != cudaSuccess) return (int)err;
  err = uvc::launch_reduce(l.part_dg, lnp, dm, nullptr,
                           static_cast<float*>(dg1), nullptr, s);
  if (err != cudaSuccess) return (int)err;
  return (int)uvc::launch_reduce(l.part_db, lnp, dm, nullptr,
                                 static_cast<float*>(db1), nullptr, s);
}

// Backward of the bare attention sublayer: the port of
// uvc_tpu/ops/attention.py::_layer_bwd_kernel (called through
// _fused_layer_bwd, its ng == 1 branch), kernel A7.  Emits
// dx = bf16(dqkv . Wqkv^T) (no residual, no LN VJP), dWqkv with x itself
// as the A operand, dbqkv, dWproj, dbproj and dmask = sum(t * ctx).
//
// What bounds it: the same products as uvc_layer_attention_ln_bwd (~52.3
// GFLOP at the train shape against ~30 MB: the tensor cores, ~53 us).
// Design: sublayer_bwd with a = x (twelve launches), then one GEMM
// <EPI_SCALE, [N][K] B> that rounds dx = dqkv . Wqkv^T to bf16 in its
// epilogue: A2's sequence without the LayerNorm pass, the LN backward and
// its two reductions.  Thirteen launches, no float atomics.
extern "C" int uvc_layer_attention_bwd(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* mask, const void* dout, void* qkv, void* t32, void* dctx,
    void* ctx, void* ctxm, void* stats, void* dqkv, void* part, void* dx,
    void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dmask,
    int batch, int n, int dm, int da, int heads, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uvc::SublayerBwd b = {
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const bf16*>(mask), static_cast<const bf16*>(dout),
      static_cast<bf16*>(qkv), static_cast<float*>(t32),
      static_cast<bf16*>(dctx), static_cast<float*>(ctx),
      static_cast<bf16*>(ctxm), static_cast<float4*>(stats),
      static_cast<bf16*>(dqkv), static_cast<float*>(part),
      static_cast<bf16*>(dwqkv), static_cast<bf16*>(dbqkv),
      static_cast<bf16*>(dwproj), static_cast<bf16*>(dbproj),
      static_cast<bf16*>(dmask), batch, n, dm, da, heads, scale};
  cudaError_t err = uvc::sublayer_bwd(b, s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs p = {};
  p.a = b.dqkv;
  p.w = b.wqkv;
  p.out = static_cast<bf16*>(dx);
  p.M = batch * n;
  p.N = dm;
  p.K = 3 * da;
  return (int)uvc::launch_gemm<uvc::EPI_SCALE, false, true>(p, s);
}
