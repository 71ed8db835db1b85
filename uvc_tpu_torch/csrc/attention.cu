// LN-fused attention sublayer, forward:
//   out = x + (mask * MHA(LN1(x) @ Wqkv + bqkv)) @ Wproj + bproj
//
// Replaces uvc_tpu/ops/attention.py::_layer_ln_fwd_kernel (called through
// _call_layer_ln_fwd).
//
// What bounds it on the H100: at DeiT-Small widths (dm = 384, N = 197,
// head dim 64) the three matrix products carry ~18.7 GFLOP per batch of 64
// against ~20 MB of input and output, so the tensor cores, not the 3.35 TB/s
// of device memory, set the floor (~19 us at 989 TFLOP/s).
//
// Design: four launches on the caller's stream.
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
  const int rows = batch * n;
  cudaError_t err = uvc::launch_layer_norm(
      static_cast<const bf16*>(x), static_cast<const float*>(g1),
      static_cast<const float*>(b1), rows, dm, eps, static_cast<bf16*>(a_in),
      s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs p = {};
  p.a = static_cast<const bf16*>(a_in);
  p.w = static_cast<const bf16*>(wqkv);
  p.bias = static_cast<const bf16*>(bqkv);
  p.out = static_cast<bf16*>(qkv);
  p.M = rows;
  p.N = 3 * da;
  p.K = dm;
  err = uvc::launch_gemm<uvc::EPI_BIAS>(p, s);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = uvc::attention_smem_bytes(n);
  err = cudaFuncSetAttribute(uvc::attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + uvc::ATT_QT - 1) / uvc::ATT_QT, heads, batch);
  uvc::attention_kernel<<<grid, uvc::ATT_THREADS, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(mask),
      static_cast<bf16*>(ctx), n, da, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs q = {};
  q.a = static_cast<const bf16*>(ctx);
  q.w = static_cast<const bf16*>(wproj);
  q.bias = static_cast<const bf16*>(bproj);
  q.out = static_cast<bf16*>(out);
  q.M = rows;
  q.N = dm;
  q.K = da;
  q.resid = static_cast<const bf16*>(x);
  return (int)uvc::launch_gemm<uvc::EPI_RESID>(q, s);
}
