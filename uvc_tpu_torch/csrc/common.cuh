// Shared device code of the kernels (attention.cu, attention_core.cu,
// mlp.cu, performer.cu): the LayerNorm pass, the GEMMs' argument block and
// epilogue codes (gemm_wg.cuh runs them), and the in-order reduction of
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
// (the register layout of the wgmma A fragments and of bf16 pairs in memory)
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(f2bf(lo), f2bf(hi));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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
// The GEMMs' epilogues and arguments (gemm_wg.cuh).
// ---------------------------------------------------------------------------

enum Epilogue {
  EPI_BIAS = 0,       // bf16(acc + bias)                        (qkv)
  EPI_GELU_MASK = 1,  // bf16(gelu_erf(acc + bias) * mask)       (fc1)
  EPI_RESID = 2,      // bf16(resid + (acc + bias))              (proj, fc2)
  EPI_BLEND = 3,      // bf16(d1 * (resid + (acc + bias)) + d0 * xin)
                      //   (K3's fc2)
  EPI_F32 = 4,        // out32 = acc (+ bias when bias is given)
  EPI_F32_MASK = 5,   // out32 = acc, out = bf16(acc * mask)     (do @ Wproj^T)
  EPI_SCALE = 6,      // bf16(acc * d[1]), or bf16(acc) when d is null
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
  int kchunk;         // rows of K per CTA along z; 0: all of K
  // gemm_wg.cuh's gemm_act_bwd: its second product's A [M, K] and B [N, K],
  // its second output and its column-sum partials
  const bf16* a2;
  const bf16* w2;
  bf16* out2;         // [M, N] dh
  float* part;        // [tiles_m, N] dmask, then [tiles_m, N] db1
};

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
