// The staged attention core of the sublayer kernels of attention.cu:
//   ctx = softmax(q . k^T * scale) . v
// per (image, head), forward and backward, on head-split operands at any
// strides: A7's forward (the ctx mask) and the backwards of A2 and A7
// (even head dims up to 80, the ctx mask, and the f32 ctx that dmask
// needs), on the packed qkv rows.  K1 and A9's forward run the streamed
// forward of attention_core_fwd.cuh, A8 and A9's backward the streamed
// backward of attention_core_bwd.cuh; this file also holds the head
// operands (Heads), copy widths and head-dim dispatch that those share.
//
// Design: one CTA of four warps per (64-row tile, head, image), 16 rows per
// warp, mma.sync m16n8k16 with f32 accumulators; the other operand's whole
// sequence sits in shared memory, and keys (or queries) at or past N are
// masked inside the kernel, where the Pallas wrappers pad N to 128 and add
// a -1e30 bias.
//   forward (core_fwd_kernel): the row max, then p = exp(logit - max) in
//     f32, the row sums of the unrounded p and bf16(p) . V in f32;
//     ctx = bf16((p . V) / s), the normalisation after P . V as the Pallas
//     bodies do; with a mask, bf16(bf16(ctx) * mask).
//   backward, two launches and no float atomics (two launches give the same
//     bits): a query-side kernel (core_bwd_q_kernel; four passes over the
//     keys: the max, s, row = sum(dp * probs) with probs = p / s and
//     dp = dO . V^T, then ds = bf16(probs * (dp - row)) and
//     dq = ds . K * scale) that also writes (max, s, row) per query and,
//     from its third pass, ctx = bf16(probs) . V in f32 and
//     bf16(ctx * mask) for the sublayers' dmask; and a key-side kernel
//     (core_bwd_kv_kernel) that loops over the queries with those
//     statistics: dv = bf16(probs)^T . dO and dk = ds^T . Q * scale.  The
//     loop over the queries takes the place of the Pallas kernels'
//     sequential accumulation, so no two CTAs write one output.
//
// Head dim: each kernel is a template on the padded head dim DHP (a
// multiple of 16) and takes any dh <= DHP.  Columns dh..DHP-1 of every
// staged tile are zero-filled in shared memory, which is exact: they add
// zero to every dot product, and the outputs' columns past dh are never
// written.  The copies are as wide as every operand allows (heads_vec):
// 16 bytes (cp.async) where dh, the strides and the base are multiples of
// 8 elements, 4 bytes where they are even, and one element otherwise (an
// odd head dim).  The stores are 4 bytes wide, or one element at a time.
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace uvc {

constexpr int CORE_QT = 64;  // query (or key) rows per CTA, 16 per warp
constexpr int CORE_THREADS = 128;

// One head-split operand: element (b, h, i, d) at
// p[b * sb + h * sh + i * sr + d].
template <typename T>
struct Heads {
  T* p;
  long long sb, sh, sr;
  __device__ __forceinline__ T* head(int b, int h) const {
    return p + (long long)b * sb + (long long)h * sh;
  }
};
typedef Heads<const bf16> InHeads;
typedef Heads<bf16> OutHeads;

// What the query-side kernel writes of ctx = bf16(probs) . V besides dq:
// the sublayer backward's ctx in f32 and ctxm = bf16(ctx * mask) at one
// layout (sb, sh, sr), mask [heads * dh] with dh even (A2/A7).
struct CtxOut {
  float* ctx;
  bf16* ctxm;
  const bf16* mask;
  long long sb, sh, sr;
};

// Elements per copy that an operand allows: 8 (16 bytes) where dh, its
// strides and its base are multiples of 8 elements, 2 where they are
// even, else 1.
template <typename T>
static int heads_vec(const Heads<T>& x, int dh) {
  auto fits = [&](int v) {
    return dh % v == 0 && x.sb % v == 0 && x.sh % v == 0 && x.sr % v == 0 &&
           reinterpret_cast<uintptr_t>(x.p) % (2 * v) == 0;
  };
  return fits(8) ? 8 : fits(2) ? 2 : 1;
}

template <typename... T>
static int ops_vec(int dh, const T&... ops) {
  return std::min({heads_vec(ops, dh)...});
}

// Rows [first, first + rows) of one head (row stride sr) into a
// [rows][DHP + 8] tile, vec elements per copy; columns at or past dh and
// rows at or past n are zero-filled.
template <int DHP>
__device__ __forceinline__ void stage_head(bf16* tile, const bf16* src,
                                           long long sr, int first, int rows,
                                           int n, int dh, int vec, int tid) {
  constexpr int LD = DHP + 8;
  if (vec == 8) {
    for (int c = tid; c < rows * (DHP / 8); c += CORE_THREADS) {
      const int r = c / (DHP / 8), d = (c % (DHP / 8)) * 8;
      const int gr = first + r;
      const bool ok = gr < n && d < dh;
      cp_async16(tile + r * LD + d, src + (ok ? gr * sr + d : 0), ok);
    }
  } else if (vec == 2) {
    for (int c = tid; c < rows * (DHP / 2); c += CORE_THREADS) {
      const int r = c / (DHP / 2), d = (c % (DHP / 2)) * 2;
      const int gr = first + r;
      const bool ok = gr < n && d < dh;
      cp_async4(tile + r * LD + d, src + (ok ? gr * sr + d : 0), ok);
    }
  } else {
    // through the read-only cache, as a __restrict__ operand would be
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    for (int c = tid; c < rows * DHP; c += CORE_THREADS) {
      const int r = c / DHP, d = c % DHP;
      const int gr = first + r;
      tile[r * LD + d] = (gr < n && d < dh)
                             ? __ushort_as_bfloat16(__ldg(s + gr * sr + d))
                             : f2bf(0.f);
    }
  }
}

// A fragments (16 rows x DHP) of this warp's rows of a [rows][DHP + 8] tile
template <int DHP>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[DHP / 16][4],
                                             const bf16* tile, int warp,
                                             int g, int t) {
  constexpr int LD = DHP + 8;
  const bf16* r0 = tile + (warp * 16 + g) * LD;
  const bf16* r8 = r0 + 8 * LD;
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    f[kk][0] = *reinterpret_cast<const uint32_t*>(r0 + kk * 16 + 2 * t);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(r8 + kk * 16 + 2 * t);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + kk * 16 + 2 * t + 8);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(r8 + kk * 16 + 2 * t + 8);
  }
}

// s[16 x 8] = A(16 x DHP) . B^T for the 8 rows j..j+7 of a [rows][DHP + 8]
// operand B: s[0..1] row g, s[2..3] row g + 8, columns j + 2t and + 1
template <int DHP>
__device__ __forceinline__ void dot8(const uint32_t (&a)[DHP / 16][4],
                                     const bf16* b, int j, int g, int t,
                                     float (&s)[4]) {
  constexpr int LD = DHP + 8;
  s[0] = s[1] = s[2] = s[3] = 0.f;
  const bf16* br = b + (j + g) * LD;
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk) {
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(br + kk * 16 + 2 * t);
    const uint32_t b1 =
        *reinterpret_cast<const uint32_t*>(br + kk * 16 + 2 * t + 8);
    mma_bf16(s, a[kk], b0, b1);
  }
}

// acc[DHP cols] += P(16 x 16, packed A fragment) . B[j..j+15][0..DHP-1]
// (B is [key][d]: two 8-wide column tiles per ldmatrix)
template <int DHP>
__device__ __forceinline__ void acc_pv(float (&acc)[DHP / 8][4],
                                       const uint32_t (&pa)[4], const bf16* b,
                                       int j, int lane) {
  constexpr int LD = DHP + 8;
#pragma unroll
  for (int dp = 0; dp < DHP / 16; ++dp) {
    uint32_t vb[4];
    ldmatrix_x4_trans(vb,
                      b + (j + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], pa, vb[0], vb[1]);
    mma_bf16(acc[2 * dp + 1], pa, vb[2], vb[3]);
  }
}

// The row max over the valid keys of this warp's 16 rows, reduced over the
// four lanes that share a row.
template <int DHP>
__device__ __forceinline__ void row_max(const uint32_t (&qf)[DHP / 16][4],
                                        const bf16* Ks, int n, int np,
                                        float scale, int g, int t, float& mx0,
                                        float& mx1) {
  mx0 = -INFINITY;
  mx1 = -INFINITY;
  for (int j = 0; j < np; j += 8) {
    float s[4];
    dot8<DHP>(qf, Ks, j, g, t, s);
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
}

// row[c], row[c + 1] = bf16(v0), bf16(v1) for the columns below dh; one
// 4-byte store when vec >= 2 (dh even, every row on a 4-byte boundary)
__device__ __forceinline__ void store_pair(bf16* row, int c, int dh, int vec,
                                           float v0, float v1) {
  if (vec >= 2) {
    if (c < dh) *reinterpret_cast<uint32_t*>(row + c) = pack_f32(v0, v1);
  } else {
    if (c < dh) row[c] = f2bf(v0);
    if (c + 1 < dh) row[c + 1] = f2bf(v1);
  }
}

template <int DHP>
static size_t core_smem_bytes(int n, bool backward) {
  const int np = (n + 15) & ~15;
  const size_t ld = DHP + 8;
  return backward ? (2 * CORE_QT + 2 * np) * ld * sizeof(bf16) +
                        (size_t)np * sizeof(float4)
                  : (CORE_QT + 2 * np) * ld * sizeof(bf16);
}

// Forward: one CTA per (64-query tile, head, image).  mask: null, or
// [heads * dh] with dh even.
template <int DHP, bool FULL>
static __global__ void __launch_bounds__(CORE_THREADS)
    core_fwd_kernel(InHeads q, InHeads k, InHeads v, OutHeads out,
                    const bf16* __restrict__ mask, int n, int dh, float scale,
                    int vec) {
  if (FULL) dh = DHP, vec = 8;
  constexpr int LD = DHP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + CORE_QT * LD;
  bf16* Vs = Ks + np * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  stage_head<DHP>(Qs, q.head(b, h), q.sr, qt * CORE_QT, CORE_QT, n, dh, vec,
                  tid);
  stage_head<DHP>(Ks, k.head(b, h), k.sr, 0, np, n, dh, vec, tid);
  stage_head<DHP>(Vs, v.head(b, h), v.sr, 0, np, n, dh, vec, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[DHP / 16][4];
  load_a_frags<DHP>(qf, Qs, warp, g, t);
  float mx0, mx1;
  row_max<DHP>(qf, Ks, n, np, scale, g, t, mx0, mx1);

  // p = exp(logit - max) in f32, row sums of the unrounded p, bf16(p) . V
  // accumulated in f32, 16 keys at a time
  float o[DHP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
    o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < np; j += 16) {
    float s0[4], s1[4];
    dot8<DHP>(qf, Ks, j, g, t, s0);
    dot8<DHP>(qf, Ks, j + 8, g, t, s1);
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
    acc_pv<DHP>(o, pa, Vs, j, lane);
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = qt * CORE_QT + warp * 16 + g + 8 * hh;
    if (qi >= n) continue;
    const float l = hh ? l1 : l0;
    bf16* row = out.head(b, h) + qi * out.sr;
#pragma unroll
    for (int dn = 0; dn < DHP / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      float c0 = o[dn][2 * hh] / l, c1 = o[dn][2 * hh + 1] / l;
      if (mask != nullptr && c < dh) {
        c0 = bf2f(f2bf(c0)) * bf2f(mask[h * dh + c]);
        c1 = bf2f(f2bf(c1)) * bf2f(mask[h * dh + c + 1]);
      }
      store_pair(row, c, dh, vec, c0, c1);
    }
  }
}

// Backward, query side: one CTA per (64-query tile, head, image), the
// head's K and V in shared memory.  Writes dq, (max, s, row) per query and
// the sublayer's ctx.
template <int DHP, bool FULL>
static __global__ void __launch_bounds__(CORE_THREADS)
    core_bwd_q_kernel(InHeads q, InHeads k, InHeads v, InHeads dout,
                      OutHeads dq, float4* __restrict__ stats, CtxOut cx,
                      int n, int dh, float scale, int vec) {
  if (FULL) dh = DHP, vec = 8;
  constexpr int LD = DHP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ds = Qs + CORE_QT * LD;
  bf16* Ks = Ds + CORE_QT * LD;
  bf16* Vs = Ks + np * LD;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * gridDim.y + h;

  stage_head<DHP>(Qs, q.head(b, h), q.sr, qt * CORE_QT, CORE_QT, n, dh, vec,
                  tid);
  stage_head<DHP>(Ds, dout.head(b, h), dout.sr, qt * CORE_QT, CORE_QT, n, dh,
                  vec, tid);
  stage_head<DHP>(Ks, k.head(b, h), k.sr, 0, np, n, dh, vec, tid);
  stage_head<DHP>(Vs, v.head(b, h), v.sr, 0, np, n, dh, vec, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qf[DHP / 16][4], df[DHP / 16][4];
  load_a_frags<DHP>(qf, Qs, warp, g, t);
  load_a_frags<DHP>(df, Ds, warp, g, t);

  // pass 1: the row max; pass 2: s = sum of p = exp(logit - max)
  float mx0, mx1;
  row_max<DHP>(qf, Ks, n, np, scale, g, t, mx0, mx1);
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < np; j += 8) {
    float s[4];
    dot8<DHP>(qf, Ks, j, g, t, s);
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
    dot8<DHP>(qf, Ks, j, g, t, s0);
    dot8<DHP>(qf, Ks, j + 8, g, t, s1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j + 2 * t + (e & 1);
      const float m = (e < 2) ? mx0 : mx1;
      const float l = (e < 2) ? l0 : l1;
      pr0[e] = (key < n) ? expf(s0[e] * scale - m) / l : 0.f;
      pr1[e] = (key + 8 < n) ? expf(s1[e] * scale - m) / l : 0.f;
    }
  };

  // pass 3: row = sum(dp * probs), dp = dO . V^T; ctx = bf16(probs) . V
  float acc[DHP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float rw0 = 0.f, rw1 = 0.f;
  for (int j = 0; j < np; j += 16) {
    float pr0[4], pr1[4], dp0[4], dp1[4];
    probs16(j, pr0, pr1);
    dot8<DHP>(df, Vs, j, g, t, dp0);
    dot8<DHP>(df, Vs, j + 8, g, t, dp1);
    rw0 += dp0[0] * pr0[0] + dp0[1] * pr0[1] + dp1[0] * pr1[0] +
           dp1[1] * pr1[1];
    rw1 += dp0[2] * pr0[2] + dp0[3] * pr0[3] + dp1[2] * pr1[2] +
           dp1[3] * pr1[3];
    const uint32_t pa[4] = {pack_f32(pr0[0], pr0[1]),
                            pack_f32(pr0[2], pr0[3]),
                            pack_f32(pr1[0], pr1[1]),
                            pack_f32(pr1[2], pr1[3])};
    acc_pv<DHP>(acc, pa, Vs, j, lane);
  }
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    rw0 += __shfl_xor_sync(0xffffffffu, rw0, o);
    rw1 += __shfl_xor_sync(0xffffffffu, rw1, o);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = qt * CORE_QT + warp * 16 + g + 8 * hh;
    if (qi >= n) continue;
    const long long off = (long long)b * cx.sb + (long long)h * cx.sh +
                          qi * cx.sr;
#pragma unroll
    for (int dn = 0; dn < DHP / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      if (c >= dh) continue;
      const float c0 = acc[dn][2 * hh], c1 = acc[dn][2 * hh + 1];
      *reinterpret_cast<float2*>(cx.ctx + off + c) = make_float2(c0, c1);
      *reinterpret_cast<uint32_t*>(cx.ctxm + off + c) =
          pack_f32(c0 * bf2f(cx.mask[h * dh + c]),
                   c1 * bf2f(cx.mask[h * dh + c + 1]));
    }
    if (t == 0)
      stats[bh * n + qi] = make_float4(hh ? mx1 : mx0, hh ? l1 : l0,
                                       hh ? rw1 : rw0, 0.f);
  }

  // pass 4: ds = bf16(probs * (dp - row)), dq = ds . K
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int j = 0; j < np; j += 16) {
    float pr0[4], pr1[4], dp0[4], dp1[4];
    probs16(j, pr0, pr1);
    dot8<DHP>(df, Vs, j, g, t, dp0);
    dot8<DHP>(df, Vs, j + 8, g, t, dp1);
    float ds0[4], ds1[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = (e < 2) ? rw0 : rw1;
      ds0[e] = pr0[e] * (dp0[e] - r);
      ds1[e] = pr1[e] * (dp1[e] - r);
    }
    const uint32_t pa[4] = {pack_f32(ds0[0], ds0[1]), pack_f32(ds0[2], ds0[3]),
                            pack_f32(ds1[0], ds1[1]), pack_f32(ds1[2], ds1[3])};
    acc_pv<DHP>(acc, pa, Ks, j, lane);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = qt * CORE_QT + warp * 16 + g + 8 * hh;
    if (qi >= n) continue;
    bf16* row = dq.head(b, h) + qi * dq.sr;
#pragma unroll
    for (int dn = 0; dn < DHP / 8; ++dn)
      store_pair(row, dn * 8 + 2 * t, dh, vec, acc[dn][2 * hh] * scale,
                 acc[dn][2 * hh + 1] * scale);
  }
}

// Backward, key side: one CTA per (64-key tile, head, image), the head's Q,
// dO and per-query statistics in shared memory.  One pass over the queries
// computes the transposed logits K . Q^T, probs^T = exp(logit - max[q]) /
// s[q], dp^T = V . dO^T and ds^T = bf16(probs^T * (dp^T - row[q])), and
// accumulates dv = bf16(probs^T) . dO and dk = ds^T . Q in registers.
template <int DHP, bool FULL>
static __global__ void __launch_bounds__(CORE_THREADS)
    core_bwd_kv_kernel(InHeads q, InHeads k, InHeads v, InHeads dout,
                       const float4* __restrict__ stats, OutHeads dk,
                       OutHeads dv, int n, int dh, float scale, int vec) {
  if (FULL) dh = DHP, vec = 8;
  constexpr int LD = DHP + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int np = (n + 15) & ~15;
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + CORE_QT * LD;
  bf16* Qs = Vs + CORE_QT * LD;
  bf16* Ds = Qs + np * LD;
  float4* St = reinterpret_cast<float4*>(Ds + np * LD);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = (long long)b * gridDim.y + h;

  stage_head<DHP>(Ks, k.head(b, h), k.sr, kt * CORE_QT, CORE_QT, n, dh, vec,
                  tid);
  stage_head<DHP>(Vs, v.head(b, h), v.sr, kt * CORE_QT, CORE_QT, n, dh, vec,
                  tid);
  stage_head<DHP>(Qs, q.head(b, h), q.sr, 0, np, n, dh, vec, tid);
  stage_head<DHP>(Ds, dout.head(b, h), dout.sr, 0, np, n, dh, vec, tid);
  cp_async_commit();
  const float4* st = stats + bh * n;
  for (int i = tid; i < np; i += CORE_THREADS)
    St[i] = i < n ? st[i] : make_float4(0.f, 1.f, 0.f, 0.f);
  cp_async_wait<0>();
  __syncthreads();

  uint32_t kf[DHP / 16][4], vf[DHP / 16][4];
  load_a_frags<DHP>(kf, Ks, warp, g, t);
  load_a_frags<DHP>(vf, Vs, warp, g, t);

  float ak[DHP / 8][4], av[DHP / 8][4];
#pragma unroll
  for (int dn = 0; dn < DHP / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[dn][e] = av[dn][e] = 0.f;

  for (int j = 0; j < np; j += 16) {
    float lt0[4], lt1[4], dt0[4], dt1[4];
    dot8<DHP>(kf, Qs, j, g, t, lt0);
    dot8<DHP>(kf, Qs, j + 8, g, t, lt1);
    dot8<DHP>(vf, Ds, j, g, t, dt0);
    dot8<DHP>(vf, Ds, j + 8, g, t, dt1);
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
    acc_pv<DHP>(av, pa, Ds, j, lane);
    acc_pv<DHP>(ak, sa, Qs, j, lane);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = kt * CORE_QT + warp * 16 + g + 8 * hh;
    if (key >= n) continue;
    bf16* krow = dk.head(b, h) + key * dk.sr;
    bf16* vrow = dv.head(b, h) + key * dv.sr;
#pragma unroll
    for (int dn = 0; dn < DHP / 8; ++dn) {
      const int c = dn * 8 + 2 * t;
      store_pair(krow, c, dh, vec, ak[dn][2 * hh] * scale,
                 ak[dn][2 * hh + 1] * scale);
      store_pair(vrow, c, dh, vec, av[dn][2 * hh], av[dn][2 * hh + 1]);
    }
  }
}

template <typename K>
static cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// A full tile (dh == DHP and 16-byte copies: the sublayers' heads of 64
// and 80) runs the FULL instantiation, which folds away every column and
// copy-width check.
template <int DHP, bool FULL>
static cudaError_t run_core_fwd(InHeads q, InHeads k, InHeads v, OutHeads out,
                                const bf16* mask, int batch, int heads, int n,
                                int dh, float scale, int vec, cudaStream_t s) {
  const size_t smem = core_smem_bytes<DHP>(n, false);
  cudaError_t err = set_smem(core_fwd_kernel<DHP, FULL>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + CORE_QT - 1) / CORE_QT, heads, batch);
  core_fwd_kernel<DHP, FULL><<<grid, CORE_THREADS, smem, s>>>(
      q, k, v, out, mask, n, dh, scale, vec);
  return cudaGetLastError();
}

// Forward, one launch on the caller's stream.
template <int DHP>
static cudaError_t launch_core_fwd(InHeads q, InHeads k, InHeads v,
                                   OutHeads out, const bf16* mask, int batch,
                                   int heads, int n, int dh, float scale,
                                   cudaStream_t s) {
  const int vec = ops_vec(dh, q, k, v, out);
  return dh == DHP && vec == 8
             ? run_core_fwd<DHP, true>(q, k, v, out, mask, batch, heads, n,
                                       dh, scale, vec, s)
             : run_core_fwd<DHP, false>(q, k, v, out, mask, batch, heads, n,
                                        dh, scale, vec, s);
}

template <int DHP, bool FULL>
static cudaError_t run_core_bwd(InHeads q, InHeads k, InHeads v, InHeads dout,
                                OutHeads dq, OutHeads dk, OutHeads dv,
                                float4* stats, CtxOut cx, int batch,
                                int heads, int n, int dh, float scale,
                                int vec, cudaStream_t s) {
  const size_t smem = core_smem_bytes<DHP>(n, true);
  const dim3 grid((n + CORE_QT - 1) / CORE_QT, heads, batch);
  cudaError_t err = set_smem(core_bwd_q_kernel<DHP, FULL>, smem);
  if (err != cudaSuccess) return err;
  core_bwd_q_kernel<DHP, FULL><<<grid, CORE_THREADS, smem, s>>>(
      q, k, v, dout, dq, stats, cx, n, dh, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem(core_bwd_kv_kernel<DHP, FULL>, smem);
  if (err != cudaSuccess) return err;
  core_bwd_kv_kernel<DHP, FULL><<<grid, CORE_THREADS, smem, s>>>(
      q, k, v, dout, stats, dk, dv, n, dh, scale, vec);
  return cudaGetLastError();
}

// The sublayer backward, two launches on the caller's stream; stats:
// [B * heads * N] float4 scratch.
template <int DHP>
static cudaError_t launch_core_bwd(InHeads q, InHeads k, InHeads v,
                                   InHeads dout, OutHeads dq, OutHeads dk,
                                   OutHeads dv, float4* stats, CtxOut cx,
                                   int batch, int heads, int n, int dh,
                                   float scale, cudaStream_t s) {
  const int vec = ops_vec(dh, q, k, v, dout, dq, dk, dv);
  return dh == DHP && vec == 8
             ? run_core_bwd<DHP, true>(q, k, v, dout, dq, dk, dv, stats, cx,
                                       batch, heads, n, dh, scale, vec, s)
             : run_core_bwd<DHP, false>(q, k, v, dout, dq, dk, dv, stats, cx,
                                        batch, heads, n, dh, scale, vec, s);
}

template <int DHP>
using HeadDim = std::integral_constant<int, DHP>;

// f(HeadDim<DHP>()) for the padded head dim DHP of dh (16, 32, 48, 64 or
// 80: the instantiations every entry point is built for), or
// cudaErrorInvalidValue for a head dim outside 1..80.
template <typename F>
static cudaError_t with_head_dim(int dh, F f) {
  if (dh <= 0) return cudaErrorInvalidValue;
  switch ((dh + 15) / 16) {
    case 1: return f(HeadDim<16>());
    case 2: return f(HeadDim<32>());
    case 3: return f(HeadDim<48>());
    case 4: return f(HeadDim<64>());
    case 5: return f(HeadDim<80>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace uvc
