// LN-fused MLP sublayer, forward, plain and with the block-gating blend:
//   mlp_ln:        out = x + (mask * gelu_erf(LN2(x) @ W1 + b1)) @ W2 + b2
//   mlp_ln_blend:  out = d1 * (x + mlp(LN2(x))) + d0 * xin
//
// Replaces uvc_tpu/ops/mlp.py::_mlp_ln_fwd_kernel (via _call_mlp_fwd) and
// uvc_tpu/ops/mlp.py::_mlp_ln_blend_fwd_kernel (via _call_mlp_blend_fwd).
// Their backwards, uvc_mlp_ln_bwd and uvc_mlp_ln_blend_bwd, replace
// _mlp_ln_bwd_kernel and _mlp_ln_blend_bwd_kernel; their note (bound,
// design) is above mlp_backward at the end of this file.
//
// What bounds it on the H100: the tensor cores.  At DeiT-Small widths
// (dm = 384, F = 1536, N = 197) the two matrix products carry ~29.7 GFLOP
// per batch of 64 against ~22 MB (~31 MB with the blend's second input) of
// input and output (~30 us at 989 TFLOP/s); at ViT-H/14's stage-1 shape
// (B = 32, N = 257, dm = 1280, F = 5120) 215.6 GFLOP against ~68 MB:
// ~218 us.
//
// Design: three launches on the caller's stream.
//   1. layer_norm_kernel: a_in = bf16(LN2(x)) in f32 -> [B*N, dm].
//   2. fc1, hidden = bf16(gelu_erf(a_in @ W1 + b1) * mask) -> [B*N, F]:
//      gemm_wg_kernel<EPI_GELU_MASK> (gemm_wg.cuh: TMA, a producer warp,
//      two wgmma consumer warpgroups, 128 x 256 tiles at F >= 2048 and
//      128 x 128 below, the bias, the GELU and the mask in the f32
//      epilogue staged in shared memory, one rounding).
//   3. fc2 with the residual add in its epilogue: mlp_ln on
//      gemm_wg_kernel<EPI_RESID>, out = bf16(x + (hidden @ W2 + b2));
//      mlp_ln_blend on gemm_wg_kernel<EPI_BLEND>, bf16(d1 * (x + (hidden
//      @ W2 + b2)) + d0 * xin), d read on the device, so the gating
//      distribution never syncs the host, x and xin read 16 bytes a
//      thread.
// Against the bound: the two products run on wgmma from TMA-fed shared
// memory; the blend adds one read of xin to fc2's epilogue.  The TPU
// kernel kept the LN output and the hidden activations in VMEM; here they
// make one round trip each through device memory (~2 x 9.7 MB and ~2 x
// 38.7 MB at B = 64, F = 1536; the hidden layer ~2 x 84 MB at ViT-H/14,
// ~50 us at 3.35 TB/s).  Fusing fc1 and fc2 is later work.
// GELU: erff is exact; the Pallas body uses the Abramowitz-Stegun erf
// (|err| < 1.5e-7), far below the bf16 rounding of the hidden layer.
#include "gemm_wg.cuh"

using uvc::bf16;

namespace {

// K2 (xin null) and K3 (xin and d given)
int mlp_forward(const void* x, const void* xin, const void* d, const void* g2,
                const void* b2, const void* w1, const void* bias1,
                const void* w2, const void* bias2, const void* mask,
                void* a_in, void* hidden, void* out, int rows, int dm, int f,
                float eps, cudaStream_t s) {
  cudaError_t err = uvc::launch_layer_norm(
      static_cast<const bf16*>(x), static_cast<const float*>(g2),
      static_cast<const float*>(b2), rows, dm, eps, static_cast<bf16*>(a_in),
      s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs p = {};
  p.a = static_cast<const bf16*>(a_in);
  p.w = static_cast<const bf16*>(w1);
  p.bias = static_cast<const bf16*>(bias1);
  p.out = static_cast<bf16*>(hidden);
  p.M = rows;
  p.N = f;
  p.K = dm;
  p.mask = static_cast<const bf16*>(mask);
  err = uvc::launch_gemm_wg<uvc::EPI_GELU_MASK>(p, s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs q = {};
  q.a = static_cast<const bf16*>(hidden);
  q.w = static_cast<const bf16*>(w2);
  q.bias = static_cast<const bf16*>(bias2);
  q.out = static_cast<bf16*>(out);
  q.M = rows;
  q.N = dm;
  q.K = f;
  q.resid = static_cast<const bf16*>(x);
  if (xin == nullptr) return (int)uvc::launch_gemm_wg<uvc::EPI_RESID>(q, s);
  q.xin = static_cast<const bf16*>(xin);
  q.d = static_cast<const float*>(d);
  return (int)uvc::launch_gemm_wg<uvc::EPI_BLEND>(q, s);
}

}  // namespace

// Both return 0 or the first CUDA error code.  All buffers are device
// pointers; a_in [rows, dm] and hidden [rows, f] (bf16) are scratch that
// the caller allocates.
extern "C" int uvc_mlp_ln(const void* x, const void* g2, const void* b2,
                          const void* w1, const void* bias1, const void* w2,
                          const void* bias2, const void* mask, void* a_in,
                          void* hidden, void* out, int rows, int dm, int f,
                          float eps, void* stream) {
  return mlp_forward(x, nullptr, nullptr, g2, b2, w1, bias1, w2, bias2, mask,
                     a_in, hidden, out, rows, dm, f, eps,
                     static_cast<cudaStream_t>(stream));
}

extern "C" int uvc_mlp_ln_blend(const void* x, const void* xin, const void* d,
                                const void* g2, const void* b2, const void* w1,
                                const void* bias1, const void* w2,
                                const void* bias2, const void* mask,
                                void* a_in, void* hidden, void* out, int rows,
                                int dm, int f, float eps, void* stream) {
  return mlp_forward(x, xin, d, g2, b2, w1, bias1, w2, bias2, mask, a_in,
                     hidden, out, rows, dm, f, eps,
                     static_cast<cudaStream_t>(stream));
}

namespace uvc {

// The MLP activation backward, elementwise over [rows, F] with per-column
// sums: from h = m_in . W1 + b1 (f32) and dam0 = do . W2^T (f32),
//   a = gelu_erf(h), am = a * mask, dam = d1 * dam0,
//   dh = dam * mask * gelu'(h);
// writes bf16(am) and bf16(dh), the partial column sums of dam * a (dmask)
// and dh (db1) over CS_ROWS rows, and one partial sum of dam0 * am per
// CTA (the sum(dam0 * am) term of dd1).  d1 = d[1], or 1 without d.
static __global__ void __launch_bounds__(CS_THREADS)
    mlp_act_bwd_kernel(const float* __restrict__ h,
                       const float* __restrict__ dam0,
                       const bf16* __restrict__ mask, const float* d,
                       int rows, int f, bf16* __restrict__ am,
                       bf16* __restrict__ dh, float* __restrict__ part_mask,
                       float* __restrict__ part_b1,
                       float* __restrict__ part_dd1) {
  __shared__ float red[CS_THREADS / 32];
  const int c = blockIdx.x * CS_THREADS + threadIdx.x;
  const int r0 = blockIdx.y * CS_ROWS;
  const int r1 = min(rows, r0 + CS_ROWS);
  const float d1 = d ? d[1] : 1.f;
  float sm = 0.f, sb = 0.f, sdd = 0.f;
  if (c < f) {
    const float mk = bf2f(mask[c]);
    for (int r = r0; r < r1; ++r) {
      const size_t off = (size_t)r * f + c;
      const float hv = h[off];
      const float phi = 0.5f * (1.f + erff(hv * 0.70710678118654752f));
      const float pdf = expf(-0.5f * hv * hv) * 0.39894228040143268f;
      const float a = hv * phi;
      const float am32 = a * mk;
      const float d0v = dam0[off];
      const float dam = d0v * d1;
      const float dhv = dam * mk * (phi + hv * pdf);
      am[off] = f2bf(am32);
      dh[off] = f2bf(dhv);
      sm += dam * a;
      sb += dhv;
      sdd += d0v * am32;
    }
    part_mask[(size_t)blockIdx.y * f + c] = sm;
    part_b1[(size_t)blockIdx.y * f + c] = sb;
  }
  sdd = warp_sum(sdd);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = sdd;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < CS_THREADS / 32; ++w) v += red[w];
    part_dd1[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = v;
  }
}

// The blend's gating gradients from the finished sums (one CTA, a fixed
// order): dd0 = sum(do * xin); dd1 = sum(dam0 * am) + sum(do * x)
// + colsum(do) . b2.  sums = {sum(dam0 * am), sum(do * x), sum(do * xin)}.
static __global__ void blend_dd_kernel(const float* __restrict__ sums,
                                       const float* __restrict__ colsum_do,
                                       const bf16* __restrict__ bias2, int dm,
                                       float* __restrict__ dd) {
  __shared__ float red[128];
  float v = 0.f;
  for (int c = threadIdx.x; c < dm; c += 128) v += colsum_do[c] * bf2f(bias2[c]);
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = 64; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    dd[0] = sums[2];
    dd[1] = sums[0] + sums[1] + red[0];
  }
}

}  // namespace uvc

namespace {

// Backward of both MLP sublayers: the port of
// uvc_tpu/ops/mlp.py::_mlp_ln_bwd_kernel (xin == nullptr) and
// _mlp_ln_blend_bwd_kernel (with xin and d; full=True, and the
// hidden-group split's parts at once: the split is a VMEM work-around, and
// one pass over all F hidden units computes what its parts sum to).
// Emits dx, dgamma2, dbeta2, dW1, db1, dW2, db2 and dmask; the blend also
// dxin = d0 * do and dd = (dd0, dd1) from the gating identities of
// mlp.py:185-188, so the pre-blend output is never needed.
//
// What bounds it on the H100: at the stage-1 train shape (B = 64, N = 197,
// dm = 384, F = 1536) five GEMMs of 2 B N dm F = 14.87 GFLOP each (h, dam0,
// dW2, dW1, dmi), ~74 GFLOP, against ~30 MB of inputs and outputs: the
// tensor cores set the floor at ~75 us (989 TFLOP/s).
//
// Design: fifteen launches on the caller's stream (eighteen with the
// blend), no float atomics.
//   1. layer_norm_kernel: m_in = bf16(LN2(x)).
//   2. gemm <EPI_F32, [N][K] B>: dam0 = do . W2^T (f32).
//   3. gemm <EPI_F32>: h = m_in . W1 + b1 (f32).
//   4. mlp_act_bwd_kernel: bf16(am), bf16(dh), partial dmask / db1 / dd1;
//      5-6. dmask and db1 reduced in order (the blend: also dd1's part).
//   7. gemm <EPI_SCALE, [K][M] A>: dW2 = d1 * am^T . do (ragged K = B*N).
//   8. gemm <EPI_SCALE, [K][M] A>: dW1 = m_in^T . dh.
//   9. gemm <EPI_F32, [N][K] B>: dmi = dh . W1^T (f32).
//  10. ln_bwd_kernel: dx = bf16(LN VJP + d1 * do), partial dgamma2 /
//      dbeta2 (and for the blend dxin and the do . x, do . xin sums);
//      11-12. their reductions (the blend: also the two sums).
//  13-15. the column sums of do (partials, then in order), then
//      db2 = d1 * colsum(do).
//  (blend) blend_dd_kernel: dd from the sums and colsum(do) . b2.
// The TPU kernel kept h, the activations and dh in VMEM.  Here h and dam0
// (f32) and am and dh (bf16) make a round trip through device memory
// (~77 MB each in f32 at the train shape); fusing the activation backward
// into the GEMM epilogues and wgmma/TMA are later work.
int mlp_backward(const void* x, const void* xin, const void* d,
                 const void* g2, const void* b2, const void* w1,
                 const void* bias1, const void* w2, const void* bias2,
                 const void* mask, const void* dout, void* m_in, void* h32,
                 void* dam0, void* am, void* dh, void* dmi, void* part,
                 void* sums, void* dx, void* dxin, void* dd, void* dg2,
                 void* db2, void* dw1, void* db1, void* dw2, void* dbias2,
                 void* dmask, int rows, int dm, int f, float eps,
                 cudaStream_t s) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dob = static_cast<const bf16*>(dout);
  const float* dp = static_cast<const float*>(d);
  float* partf = static_cast<float*>(part);
  float* sumsf = static_cast<float*>(sums);
  cudaError_t err = uvc::launch_layer_norm(
      xb, static_cast<const float*>(g2), static_cast<const float*>(b2), rows,
      dm, eps, static_cast<bf16*>(m_in), s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs p = {};
  p.a = dob;
  p.w = static_cast<const bf16*>(w2);
  p.out32 = static_cast<float*>(dam0);
  p.M = rows;
  p.N = f;
  p.K = dm;
  err = uvc::launch_gemm<uvc::EPI_F32, false, true>(p, s);
  if (err != cudaSuccess) return (int)err;

  p = {};
  p.a = static_cast<const bf16*>(m_in);
  p.w = static_cast<const bf16*>(w1);
  p.bias = static_cast<const bf16*>(bias1);
  p.out32 = static_cast<float*>(h32);
  p.M = rows;
  p.N = f;
  p.K = dm;
  err = uvc::launch_gemm<uvc::EPI_F32>(p, s);
  if (err != cudaSuccess) return (int)err;

  const int nparts = uvc::colsum_parts(rows);
  const dim3 agrid((f + uvc::CS_THREADS - 1) / uvc::CS_THREADS, nparts);
  float* part_mask = partf;
  float* part_b1 = partf + (size_t)nparts * f;
  float* part_dd1 = part_b1 + (size_t)nparts * f;
  uvc::mlp_act_bwd_kernel<<<agrid, uvc::CS_THREADS, 0, s>>>(
      static_cast<const float*>(h32), static_cast<const float*>(dam0),
      static_cast<const bf16*>(mask), dp, rows, f, static_cast<bf16*>(am),
      static_cast<bf16*>(dh), part_mask, part_b1, part_dd1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = uvc::launch_reduce(part_mask, nparts, f, nullptr, nullptr,
                           static_cast<bf16*>(dmask), s);
  if (err != cudaSuccess) return (int)err;
  err = uvc::launch_reduce(part_b1, nparts, f, nullptr, nullptr,
                           static_cast<bf16*>(db1), s);
  if (err != cudaSuccess) return (int)err;
  if (xin != nullptr) {
    err = uvc::launch_reduce(part_dd1, nparts * (int)agrid.x, 1, nullptr,
                             sumsf, nullptr, s);
    if (err != cudaSuccess) return (int)err;
  }

  p = {};
  p.a = static_cast<const bf16*>(am);
  p.w = dob;
  p.d = dp;
  p.out = static_cast<bf16*>(dw2);
  p.M = f;
  p.N = dm;
  p.K = rows;
  err = uvc::launch_gemm<uvc::EPI_SCALE, true, false>(p, s);
  if (err != cudaSuccess) return (int)err;

  p = {};
  p.a = static_cast<const bf16*>(m_in);
  p.w = static_cast<const bf16*>(dh);
  p.out = static_cast<bf16*>(dw1);
  p.M = dm;
  p.N = f;
  p.K = rows;
  err = uvc::launch_gemm<uvc::EPI_SCALE, true, false>(p, s);
  if (err != cudaSuccess) return (int)err;

  p = {};
  p.a = static_cast<const bf16*>(dh);
  p.w = static_cast<const bf16*>(w1);
  p.out32 = static_cast<float*>(dmi);
  p.M = rows;
  p.N = dm;
  p.K = f;
  err = uvc::launch_gemm<uvc::EPI_F32, false, true>(p, s);
  if (err != cudaSuccess) return (int)err;

  uvc::LnBwdArgs l = {};
  const int lnp = uvc::ln_bwd_ctas(rows);
  l.x = xb;
  l.gamma = static_cast<const float*>(g2);
  l.dy = static_cast<const float*>(dmi);
  l.resid = dob;
  l.d = dp;
  l.xin = static_cast<const bf16*>(xin);
  l.dx = static_cast<bf16*>(dx);
  l.dxin = static_cast<bf16*>(dxin);
  l.part_dg = partf;
  l.part_db = partf + (size_t)lnp * dm;
  l.part_dot = partf + (size_t)2 * lnp * dm;
  l.rows = rows;
  l.dm = dm;
  l.eps = eps;
  err = uvc::launch_ln_bwd(l, s);
  if (err != cudaSuccess) return (int)err;
  err = uvc::launch_reduce(l.part_dg, lnp, dm, nullptr,
                           static_cast<float*>(dg2), nullptr, s);
  if (err != cudaSuccess) return (int)err;
  err = uvc::launch_reduce(l.part_db, lnp, dm, nullptr,
                           static_cast<float*>(db2), nullptr, s);
  if (err != cudaSuccess) return (int)err;
  if (xin != nullptr) {
    err = uvc::launch_reduce(l.part_dot, lnp, 2, nullptr, sumsf + 1, nullptr,
                             s);
    if (err != cudaSuccess) return (int)err;
  }

  // colsum(do): raw (f32, for dd1) and d1-scaled (db2)
  float* colsum_do = sumsf + 4;
  err = uvc::launch_colsum(dob, static_cast<const bf16*>(nullptr), rows, dm,
                           partf, s);
  if (err != cudaSuccess) return (int)err;
  err = uvc::launch_reduce(partf, nparts, dm, nullptr, colsum_do, nullptr, s);
  if (err != cudaSuccess) return (int)err;
  err = uvc::launch_reduce(colsum_do, 1, dm, dp, nullptr,
                           static_cast<bf16*>(dbias2), s);
  if (err != cudaSuccess) return (int)err;
  if (xin == nullptr) return 0;
  uvc::blend_dd_kernel<<<1, 128, 0, s>>>(sumsf, colsum_do,
                                         static_cast<const bf16*>(bias2), dm,
                                         static_cast<float*>(dd));
  return (int)cudaGetLastError();
}

}  // namespace

// Both return 0 or the first CUDA error code.  All buffers are device
// pointers.  Scratch the caller allocates: m_in [rows, dm], am and dh
// [rows, f] (bf16); h32 and dam0 [rows, f], dmi [rows, dm] (f32); part
// (f32, ceil(rows / 128) * max(2 f + ceil(f / 128), 2 dm + 2) elements)
// and sums (f32, 4 + dm).  Outputs: dx (and dxin) [rows, dm] bf16, dd [2] f32,
// dg2 / db2 [dm] f32, dw1 [dm, f], db1 [f], dw2 [f, dm], dbias2 [dm],
// dmask [f] bf16.
extern "C" int uvc_mlp_ln_bwd(
    const void* x, const void* g2, const void* b2, const void* w1,
    const void* bias1, const void* w2, const void* mask, const void* dout,
    void* m_in, void* h32, void* dam0, void* am, void* dh, void* dmi,
    void* part, void* sums, void* dx, void* dg2, void* db2, void* dw1,
    void* db1, void* dw2, void* dbias2, void* dmask, int rows, int dm, int f,
    float eps, void* stream) {
  return mlp_backward(x, nullptr, nullptr, g2, b2, w1, bias1, w2, nullptr,
                      mask, dout, m_in, h32, dam0, am, dh, dmi, part, sums,
                      dx, nullptr, nullptr, dg2, db2, dw1, db1, dw2, dbias2,
                      dmask, rows, dm, f, eps,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int uvc_mlp_ln_blend_bwd(
    const void* x, const void* xin, const void* d, const void* g2,
    const void* b2, const void* w1, const void* bias1, const void* w2,
    const void* bias2, const void* mask, const void* dout, void* m_in,
    void* h32, void* dam0, void* am, void* dh, void* dmi, void* part,
    void* sums, void* dx, void* dxin, void* dd, void* dg2, void* db2,
    void* dw1, void* db1, void* dw2, void* dbias2, void* dmask, int rows,
    int dm, int f, float eps, void* stream) {
  return mlp_backward(x, xin, d, g2, b2, w1, bias1, w2, bias2, mask, dout,
                      m_in, h32, dam0, am, dh, dmi, part, sums, dx, dxin, dd,
                      dg2, db2, dw1, db1, dw2, dbias2, dmask, rows, dm, f,
                      eps, static_cast<cudaStream_t>(stream));
}
