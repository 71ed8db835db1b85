// The staged attention core of A7's forward (attention.cu's sublayer_fwd):
//   ctx = bf16(bf16(softmax(q . k^T * scale) . v) * mask)
// per (image, head), on head views of the packed qkv rows at any strides,
// even head dims up to 80.  K1 and A9's forward run the streamed forward
// of attention_core_fwd.cuh, the sublayer backwards A2 and A7, A8 and A9's
// backward the streamed backward of attention_core_bwd.cuh; this file also
// holds the head operands (Heads), copy widths and head-dim dispatch that
// those share.
//
// Design: one CTA of four warps per (64-query tile, head, image), 16 rows
// per warp, mma.sync m16n8k16 with f32 accumulators; the head's whole K and
// V sit in shared memory, which bounds N, and keys at or past N are masked
// inside the kernel, where the Pallas wrappers pad N to 128 and add a
// -1e30 bias.  The row max, then p = exp(logit - max) in f32, the row sums
// of the unrounded p and bf16(p) . V in f32; ctx = bf16((p . V) / s), the
// normalisation after P . V as the Pallas bodies do; with a mask,
// bf16(bf16(ctx) * mask).
//
// Head dim: the kernel is a template on the padded head dim DHP (a
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

// the query tile and the head's whole K and V, at a row stride of DHP + 8
template <int DHP>
static size_t core_smem_bytes(int n) {
  const int np = (n + 15) & ~15;
  return (CORE_QT + 2 * np) * (size_t)(DHP + 8) * sizeof(bf16);
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

template <typename K>
static cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// A full tile (dh == DHP and 16-byte copies: A7's heads of 64 and 80)
// runs the FULL instantiation, which folds away every column and
// copy-width check.
template <int DHP, bool FULL>
static cudaError_t run_core_fwd(InHeads q, InHeads k, InHeads v, OutHeads out,
                                const bf16* mask, int batch, int heads, int n,
                                int dh, float scale, int vec, cudaStream_t s) {
  const size_t smem = core_smem_bytes<DHP>(n);
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
