// Shared device code of the kernels (attention.cu, attention_core.cu,
// mlp.cu, performer.cu): the LayerNorm pass, one bf16 tensor-core GEMM
// (mma.sync m16n8k16, f32 accumulators: the performer's; the sublayers
// run gemm_wg.cuh) in the three operand layouts with its epilogues, the
// GEMMs' argument block and epilogue codes, and the in-order reduction of
// per-CTA partials that the backwards' sums end with.
//
// Numerics follow the Pallas bodies (uvc_tpu/ops/attention.py
// _layer_ln_fwd_kernel / _layer_ln_bwd_kernel, uvc_tpu/ops/mlp.py
// _mlp_ln_fwd_kernel / _mlp_ln_bwd_kernel / _mlp_ln_blend_fwd_kernel /
// _mlp_ln_blend_bwd_kernel): f32 LayerNorm whose output is rounded to
// bf16 before the matmul, bf16 matmul inputs with f32 accumulation, the
// bias added in f32, and one rounding to bf16 where the Pallas body
// casts.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace uvc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }

// two bf16 in one 32-bit register, the lower-indexed element in the low half
// (the register layout of the mma.sync fragments)
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(f2bf(lo), f2bf(hi));
}

// D = A(16x16, row) * B(16x8, col) + D; bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row (l % 8) of matrix (l / 8).  Without .trans, register i of lane l
// holds row l / 4, columns 2 * (l % 4) and + 1 of matrix i (an mma A
// fragment, or a B fragment from an [n][k] layout); with .trans, rows
// 2 * (l % 4) and + 1 of column l / 4 (a B fragment from a [k][n] layout).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// 16-byte asynchronous copy to shared memory; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// 4-byte asynchronous copy to shared memory (both addresses on a 4-byte
// boundary); zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm: one warp per row, in f32, two passes over the row (mean, then
// the mean of squared deviations) as _ln_rows computes them;
// out = bf16((x - mean) * rstd * gamma + beta).  dm is a multiple of 8.
// ---------------------------------------------------------------------------

static __global__ void layer_norm_kernel(const bf16* __restrict__ x,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta,
                                         int rows, int dm, float eps,
                                         bf16* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * dm;
  float s = 0.f;
  for (int c = lane * 8; c < dm; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += bf2f(e[j]);
  }
  const float mean = warp_sum(s) / dm;
  float q = 0.f;
  for (int c = lane * 8; c < dm; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = bf2f(e[j]) - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / dm + eps);
  bf16* orow = out + (size_t)row * dm;
  for (int c = lane * 8; c < dm; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = f2bf((bf2f(e[j]) - mean) * rstd * gamma[c + j] + beta[c + j]);
    *reinterpret_cast<uint4*>(orow + c) = v;
  }
}

static inline cudaError_t launch_layer_norm(const bf16* x, const float* gamma,
                                            const float* beta, int rows,
                                            int dm, float eps, bf16* out,
                                            cudaStream_t stream) {
  const int warps_per_block = 8;
  const int blocks = (rows + warps_per_block - 1) / warps_per_block;
  layer_norm_kernel<<<blocks, warps_per_block * 32, 0, stream>>>(
      x, gamma, beta, rows, dm, eps, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM: out[M, N] = epilogue(op(A) @ op(B)), bf16 inputs, f32 accumulators.
// Three operand layouts (template flags):
//   A_KM = false: A stored [M][K];  A_KM = true: A stored [K][M] (A^T @ ..)
//   B_NK = false: B stored [K][N] (linear kernels, stored (in, out) as the
//                 JAX package stores them);  B_NK = true: B stored [N][K]
//                 (.. @ W^T)
// 128x64 output tile per CTA, four warps of 64x32, k-step 32; a
// three-stage cp.async ring keeps two tiles in flight while the tensor
// cores work on the third, and fragments come from shared memory through
// ldmatrix (.trans where the stored layout is the transpose of the mma
// fragment's).  The contiguous dimension of each stored operand must be
// a multiple of 8 (16-byte copies); the other one may be ragged: rows
// past the end are zero-filled.  So K may be ragged when A_KM and !B_NK
// (the weight-gradient products over B*N rows), and must be a multiple of
// 8 otherwise.  N is a multiple of 8 always.
// Split over K (kchunk > 0, a multiple of GEMM_BK, EPI_F32 only): CTA z of
// the grid sums rows [z * kchunk, (z + 1) * kchunk) of K and writes its f32
// partial to out32 + z * M * N, for a reduction in index order after it
// (the weight-gradient products of few outputs over B*N rows).
// ---------------------------------------------------------------------------

enum Epilogue {
  EPI_BIAS = 0,       // bf16(acc + bias)                        (qkv)
  EPI_GELU_MASK = 1,  // bf16(gelu_erf(acc + bias) * mask)       (fc1)
  EPI_RESID = 2,      // bf16(resid + (acc + bias))              (proj, fc2)
  EPI_BLEND = 3,      // bf16(d1 * (resid + (acc + bias)) + d0 * xin)
                      //   (K3's fc2; gemm_wg.cuh only)
  EPI_F32 = 4,        // out32 = acc (+ bias when bias is given)
  EPI_F32_MASK = 5,   // out32 = acc, out = bf16(acc * mask)     (do @ Wproj^T)
  EPI_SCALE = 6,      // bf16(acc * d[1]), or bf16(acc) when d is null
  EPI_RESID32 = 7,    // bf16(resid32 + (acc + bias))            (performer fc2)
};

struct GemmArgs {
  const bf16* a;      // [M, K] or [K, M]
  const bf16* w;      // [K, N] or [N, K]
  const bf16* bias;   // [N]
  bf16* out;          // [M, N]
  int M, N, K;
  const bf16* mask;   // [N]  (EPI_GELU_MASK, EPI_F32_MASK; null: all ones)
  const bf16* resid;  // [M, N] (EPI_RESID, EPI_BLEND)
  const bf16* xin;    // [M, N] (EPI_BLEND)
  const float* d;     // [2]  (EPI_BLEND, EPI_SCALE): (skip, keep)
  float* out32;       // [M, N] (EPI_F32, EPI_F32_MASK); [K / kchunk, M, N]
                      //   split; gemm_act_bwd: [tiles_m, tiles_n] dd1
  const float* resid32;  // [M, N] (EPI_RESID32)
  int kchunk;         // rows of K per CTA along z; 0: all of K
  // gemm_wg.cuh's gemm_act_bwd: its second product's A [M, K] and B [N, K],
  // its second output and its column-sum partials
  const bf16* a2;
  const bf16* w2;
  bf16* out2;         // [M, N] dh
  float* part;        // [tiles_m, N] dmask, then [tiles_m, N] db1
};

constexpr int GEMM_BM = 128;
constexpr int GEMM_BN = 64;
constexpr int GEMM_BK = 32;
constexpr int GEMM_STAGES = 3;
constexpr int GEMM_THREADS = 128;
// padded row strides (elements): 80, 144 and 272 bytes, so the eight rows
// an ldmatrix phase reads fall in distinct 16-byte bank groups
constexpr int GEMM_LDA = GEMM_BK + 8;    // A tile [m][k]
constexpr int GEMM_LDAT = GEMM_BM + 8;   // A tile [k][m]
constexpr int GEMM_LDB = GEMM_BN + 8;    // B tile [k][n]
constexpr int GEMM_LDBT = GEMM_BK + 8;   // B tile [n][k]

template <int EPI, bool A_KM, bool B_NK>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(GemmArgs p) {
  constexpr int A_TILE = A_KM ? GEMM_BK * GEMM_LDAT : GEMM_BM * GEMM_LDA;
  constexpr int B_TILE = B_NK ? GEMM_BN * GEMM_LDBT : GEMM_BK * GEMM_LDB;
  __shared__ __align__(16) bf16 As[GEMM_STAGES][A_TILE];
  __shared__ __align__(16) bf16 Bs[GEMM_STAGES][B_TILE];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;  // warp tile: rows 64*wm, cols 32*wn
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * GEMM_BM;
  const int n0 = blockIdx.x * GEMM_BN;
  const int kbeg = p.kchunk ? blockIdx.z * p.kchunk : 0;
  const int kend = p.kchunk ? min(p.K, kbeg + p.kchunk) : p.K;
  const int ktiles = (kend - kbeg + GEMM_BK - 1) / GEMM_BK;

  auto load_tile = [&](int stage, int kt) {
    const int k0 = kbeg + kt * GEMM_BK;
    if (A_KM) {
      // 32 rows (k) x 16 chunks of 8 (m)
#pragma unroll
      for (int i = 0; i < GEMM_BM * GEMM_BK / 8 / GEMM_THREADS; ++i) {
        const int c = tid + i * GEMM_THREADS;
        const int r = c >> 4, mc = (c & 15) * 8;
        const int gk = k0 + r, gm = m0 + mc;
        const bool ok = gk < kend && gm < p.M;
        cp_async16(&As[stage][r * GEMM_LDAT + mc],
                   p.a + (ok ? (size_t)gk * p.M + gm : 0), ok);
      }
    } else {
      // 128 rows (m) x 4 chunks of 8 (k)
#pragma unroll
      for (int i = 0; i < GEMM_BM * GEMM_BK / 8 / GEMM_THREADS; ++i) {
        const int c = tid + i * GEMM_THREADS;
        const int r = c >> 2, kc = (c & 3) * 8;
        const int gr = m0 + r, gk = k0 + kc;
        const bool ok = gr < p.M && gk < kend;
        cp_async16(&As[stage][r * GEMM_LDA + kc],
                   p.a + (ok ? (size_t)gr * p.K + gk : 0), ok);
      }
    }
    if (B_NK) {
      // 64 rows (n) x 4 chunks of 8 (k)
#pragma unroll
      for (int i = 0; i < GEMM_BK * GEMM_BN / 8 / GEMM_THREADS; ++i) {
        const int c = tid + i * GEMM_THREADS;
        const int r = c >> 2, kc = (c & 3) * 8;
        const int gn = n0 + r, gk = k0 + kc;
        const bool ok = gn < p.N && gk < kend;
        cp_async16(&Bs[stage][r * GEMM_LDBT + kc],
                   p.w + (ok ? (size_t)gn * p.K + gk : 0), ok);
      }
    } else {
      // 32 rows (k) x 8 chunks of 8 (n)
#pragma unroll
      for (int i = 0; i < GEMM_BK * GEMM_BN / 8 / GEMM_THREADS; ++i) {
        const int c = tid + i * GEMM_THREADS;
        const int r = c >> 3, nc = (c & 7) * 8;
        const int gk = k0 + r, gn = n0 + nc;
        const bool ok = gk < kend && gn < p.N;
        cp_async16(&Bs[stage][r * GEMM_LDB + nc],
                   p.w + (ok ? (size_t)gk * p.N + gn : 0), ok);
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // prologue: the first STAGES - 1 tiles in flight (empty groups past K
  // keep the group count uniform)
#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < ktiles) load_tile(s, s);
    cp_async_commit();
  }

  // ldmatrix lane offsets.  Row-major source ([m][k] A, [n][k] B): lane l
  // addresses row (l % 8) + 8 * (l / 16), column block 8 * ((l / 8) % 2)
  // for B and row l % 16, column block 8 * (l / 16) for A; transposed
  // source ([k][m] A, [k][n] B): the roles of rows and columns swap.
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  const int l8 = lane & 7, lhi = (lane >> 4) * 8, lmid = ((lane >> 3) & 1) * 8;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();
    // refill the stage consumed one iteration ago
    const int next = kt + GEMM_STAGES - 1;
    if (next < ktiles) load_tile(next % GEMM_STAGES, next);
    cp_async_commit();

    const bf16* A = As[kt % GEMM_STAGES];
    const bf16* B = Bs[kt % GEMM_STAGES];
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int mrow = wm * 64 + mi * 16;
        if (A_KM)
          ldmatrix_x4_trans(af[mi],
                            A + (kk + lhi + l8) * GEMM_LDAT + mrow + lmid);
        else
          ldmatrix_x4(af[mi], A + (mrow + lrow) * GEMM_LDA + kk + lcol);
      }
      // bfr[j] = {b0, b1} of n-tile 2j, then {b0, b1} of n-tile 2j + 1
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ncol = wn * 32 + j * 16;
        if (B_NK)
          ldmatrix_x4(bfr[j], B + (ncol + lhi + l8) * GEMM_LDBT + kk + lmid);
        else
          ldmatrix_x4_trans(bfr[j], B + (kk + lrow) * GEMM_LDB + ncol + lcol);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bfr[ni >> 1][(ni & 1) * 2],
                   bfr[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator element e of tile (mi, ni) sits at
  // row g + 8 * (e / 2), column 2 * t + (e % 2)
  float d1 = 1.f;
  if (EPI == EPI_SCALE && p.d != nullptr) d1 = p.d[1];
  const bool has_bias = EPI <= EPI_RESID || EPI == EPI_RESID32 ||
                        (EPI == EPI_F32 && p.bias);
  float* out32 = p.out32 ? p.out32 + (size_t)blockIdx.z * p.M * p.N : nullptr;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int col = n0 + wn * 32 + ni * 8 + 2 * t;
    if (col >= p.N) continue;
    float bias0 = 0.f, bias1 = 0.f;
    if (has_bias) {
      bias0 = bf2f(p.bias[col]);
      bias1 = bf2f(p.bias[col + 1]);
    }
    float mask0 = 1.f, mask1 = 1.f;
    if (EPI == EPI_GELU_MASK && p.mask) {
      mask0 = bf2f(p.mask[col]);
      mask1 = bf2f(p.mask[col + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm * 64 + mi * 16 + g + 8 * hh;
        if (row >= p.M) continue;
        const size_t off = (size_t)row * p.N + col;
        float v0 = acc[mi][ni][2 * hh] + bias0;
        float v1 = acc[mi][ni][2 * hh + 1] + bias1;
        if (EPI == EPI_F32) {
          *reinterpret_cast<float2*>(out32 + off) = make_float2(v0, v1);
          continue;
        } else if (EPI == EPI_SCALE) {
          v0 *= d1;
          v1 *= d1;
        } else if (EPI == EPI_GELU_MASK) {
          v0 = v0 * (0.5f * (1.f + erff(v0 * 0.70710678118654752f))) * mask0;
          v1 = v1 * (0.5f * (1.f + erff(v1 * 0.70710678118654752f))) * mask1;
        } else if (EPI == EPI_RESID32) {
          const float2 r = *reinterpret_cast<const float2*>(p.resid32 + off);
          v0 = r.x + v0;
          v1 = r.y + v1;
        } else if (EPI == EPI_RESID) {
          const __nv_bfloat162 r =
              *reinterpret_cast<const __nv_bfloat162*>(p.resid + off);
          v0 = bf2f(r.x) + v0;
          v1 = bf2f(r.y) + v1;
        }
        *reinterpret_cast<uint32_t*>(p.out + off) = pack_f32(v0, v1);
      }
    }
  }
}

template <int EPI, bool A_KM = false, bool B_NK = false>
static inline cudaError_t launch_gemm(const GemmArgs& p, cudaStream_t stream) {
  static_assert(EPI != EPI_F32_MASK && EPI != EPI_BLEND,
                "EPI_F32_MASK and EPI_BLEND run on gemm_wg.cuh");
  const dim3 grid((p.N + GEMM_BN - 1) / GEMM_BN, (p.M + GEMM_BM - 1) / GEMM_BM,
                  p.kchunk ? (p.K + p.kchunk - 1) / p.kchunk : 1);
  gemm_kernel<EPI, A_KM, B_NK><<<grid, GEMM_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward helpers.  Every sum over the B*N rows is taken in a fixed order:
// per-CTA partials over a fixed block of rows, then a second pass that adds
// the partials in index order.  No float atomics, so a run on the card is
// reproducible bit for bit.  The LayerNorm backward and the column sums
// that produce such partials are in ln_bwd.cuh.
// ---------------------------------------------------------------------------

// out[c] = scale * sum_p part[p, c], the partials added in index order
// (32 loads in flight, the adds one after another: the bits of the plain
// loop); scale = d[1] when d is given, else 1.  Written as f32
// and / or bf16.
static __global__ void reduce_parts_kernel(const float* __restrict__ part,
                                           int nparts, int cols,
                                           const float* d, float* out32,
                                           bf16* out16) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const float* col = part + c;
  float s = 0.f;
  int i = 0;
  for (; i + 32 <= nparts; i += 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = col[(size_t)(i + j) * cols];
#pragma unroll
    for (int j = 0; j < 32; ++j) s += v[j];
  }
  for (; i < nparts; ++i) s += col[(size_t)i * cols];
  if (d) s *= d[1];
  if (out32) out32[c] = s;
  if (out16) out16[c] = f2bf(s);
}

static inline cudaError_t launch_reduce(const float* part, int nparts,
                                        int cols, const float* d,
                                        float* out32, bf16* out16,
                                        cudaStream_t stream) {
  reduce_parts_kernel<<<(cols + 127) / 128, 128, 0, stream>>>(
      part, nparts, cols, d, out32, out16);
  return cudaGetLastError();
}

}  // namespace uvc
