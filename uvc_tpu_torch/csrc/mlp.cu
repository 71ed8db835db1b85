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
#include "ln_bwd.cuh"

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

namespace {

// Backward of both MLP sublayers: the port of
// uvc_tpu/ops/mlp.py::_mlp_ln_bwd_kernel (A6, xin == nullptr) and
// _mlp_ln_blend_bwd_kernel (A4, with xin and d; full=True, and the
// hidden-group split's parts at once: the split is a VMEM work-around, and
// one pass over all F hidden units computes what its parts sum to).
// Emits dx, dgamma2, dbeta2, dW1, db1, dW2, db2 and dmask; the blend also
// dxin = d0 * do and dd = (dd0, dd1) from the gating identities of
// mlp.py:185-188, so the pre-blend output is never needed.
//
// What bounds it on the H100: the tensor cores.  Five products of
// 2 B N dm F each (dam0, h, dW2, dW1, dmi): at the stage-1 train shape
// (B = 64, N = 197, dm = 384, F = 1536) 14.87 GFLOP each, ~74 GFLOP
// against ~30 MB of inputs and outputs, ~75 us at 989 TFLOP/s; at
// ViT-H/14's (B = 32, N = 257, dm = 1280, F = 5120) 107.8 GFLOP each,
// ~539 GFLOP, ~545 us.
//
// Design: twelve launches on the caller's stream, every product on TMA
// and wgmma (gemm_wg.cuh), no float atomics.
//   1. layer_norm_kernel: m_in = bf16(LN2(x)).
//   2. gemm_act_bwd_kernel: h = m_in . W1 + b1 and dam0 = do . W2^T for one
//      128 x 128 tile in registers, staged in shared memory; the epilogue
//      writes bf16(am) and bf16(dh), with per-tile partials of dmask, db1
//      and dd1's sum(dam0 * am): neither h nor dam0 leaves the tile.
//      3-4. dmask and db1 summed in order.
//   5-6. weight_grad_wg: dW2 = d1 * am^T . do, split over the B*N rows,
//      the partials summed in order and scaled by d1 (one split: the
//      scale in the product's epilogue, no sum).
//   7-8. weight_grad_wg: dW1 = m_in^T . dh.
//   9. gemm_wg <EPI_F32, K-major B>: dmi = dh . W1^T (f32).
//  10-11. ln_bwd_kernel (ln_bwd.cuh): dx = bf16(LN VJP + d1 * do), and
//      per CTA partials of dgamma2, dbeta2 and colsum(do) (and for the
//      blend dxin and the do . x, do . xin sums), then their in-order sum.
//  12. ln_bwd_finish_kernel: dgamma2, dbeta2, db2 = bf16(d1 * colsum(do))
//      and, for the blend, dd (dd1's tile partials summed there).
// Against the bound: the five products on wgmma from TMA-fed shared
// memory; h and dam0 never leave the tile (77.5 MB each in f32 at the
// train shape, written and read back otherwise).  What still
// makes a round trip through device memory: am and dh (bf16), m_in, dmi
// (f32), the split partials of dW1 and dW2, and the LayerNorm backward's
// per-CTA partials.  The TPU kernel kept all of them in VMEM.
int mlp_backward(const void* x, const void* xin, const void* d,
                 const void* g2, const void* b2, const void* w1,
                 const void* bias1, const void* w2, const void* bias2,
                 const void* mask, const void* dout, void* m_in, void* am,
                 void* dh, void* dmi, void* part, void* sums,
                 void* dx, void* dxin, void* dd, void* dg2, void* db2,
                 void* dw1, void* db1, void* dw2, void* dbias2, void* dmask,
                 int rows, int dm, int f, int splits_w2, int splits_w1,
                 float eps, cudaStream_t s) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* dob = static_cast<const bf16*>(dout);
  const float* dp = static_cast<const float*>(d);
  float* partf = static_cast<float*>(part);
  float* sumsf = static_cast<float*>(sums);
  // dd1's per-tile partials of sum(dam0 * am), after the LN sums
  float* act_dd1 = sumsf + uvc::ln_bwd_part_cols(dm);
  cudaError_t err = uvc::launch_layer_norm(
      xb, static_cast<const float*>(g2), static_cast<const float*>(b2), rows,
      dm, eps, static_cast<bf16*>(m_in), s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs p = {};
  p.a = static_cast<const bf16*>(m_in);
  p.w = static_cast<const bf16*>(w1);
  p.a2 = dob;
  p.w2 = static_cast<const bf16*>(w2);
  p.bias = static_cast<const bf16*>(bias1);
  p.mask = static_cast<const bf16*>(mask);
  p.d = dp;
  p.out = static_cast<bf16*>(am);
  p.out2 = static_cast<bf16*>(dh);
  p.part = partf;
  p.out32 = act_dd1;
  p.M = rows;
  p.N = f;
  p.K = dm;
  err = uvc::launch_gemm_act_bwd(p, s);
  if (err != cudaSuccess) return (int)err;
  const int tm = (rows + uvc::GW_BM - 1) / uvc::GW_BM;
  const int tn = (f + uvc::AB_BN - 1) / uvc::AB_BN;
  err = uvc::launch_reduce(partf, tm, f, nullptr, nullptr,
                           static_cast<bf16*>(dmask), s);
  if (err != cudaSuccess) return (int)err;
  err = uvc::launch_reduce(partf + (size_t)tm * f, tm, f, nullptr, nullptr,
                           static_cast<bf16*>(db1), s);
  if (err != cudaSuccess) return (int)err;

  p = {};
  p.a = static_cast<const bf16*>(am);
  p.w = dob;
  p.M = f;
  p.N = dm;
  p.K = rows;
  err = uvc::weight_grad_wg(p, splits_w2, partf, static_cast<bf16*>(dw2), s,
                            dp);
  if (err != cudaSuccess) return (int)err;

  p = {};
  p.a = static_cast<const bf16*>(m_in);
  p.w = static_cast<const bf16*>(dh);
  p.M = dm;
  p.N = f;
  p.K = rows;
  err = uvc::weight_grad_wg(p, splits_w1, partf, static_cast<bf16*>(dw1), s);
  if (err != cudaSuccess) return (int)err;

  p = {};
  p.a = static_cast<const bf16*>(dh);
  p.w = static_cast<const bf16*>(w1);
  p.out32 = static_cast<float*>(dmi);
  p.M = rows;
  p.N = dm;
  p.K = f;
  err = uvc::launch_gemm_wg<uvc::EPI_F32, false, true>(p, s);
  if (err != cudaSuccess) return (int)err;

  uvc::LnBwdArgs l = {};
  l.x = xb;
  l.gamma = static_cast<const float*>(g2);
  l.dy = static_cast<const float*>(dmi);
  l.resid = dob;
  l.d = dp;
  l.xin = static_cast<const bf16*>(xin);
  l.dx = static_cast<bf16*>(dx);
  l.dxin = static_cast<bf16*>(dxin);
  l.part = partf;
  l.rows = rows;
  l.dm = dm;
  l.eps = eps;
  err = uvc::launch_ln_bwd(l, sumsf, s);
  if (err != cudaSuccess) return (int)err;
  return (int)uvc::launch_ln_bwd_finish(
      sumsf, dm, dp, static_cast<float*>(dg2), static_cast<float*>(db2),
      static_cast<bf16*>(dbias2), act_dd1, tm * tn,
      static_cast<const bf16*>(bias2), static_cast<float*>(dd), s);
}

}  // namespace

// Both return 0 or the first CUDA error code.  All buffers are device
// pointers.  Scratch the caller allocates: m_in [rows, dm], am and dh
// [rows, f] (bf16); dmi [rows, dm] (f32); part (f32, the
// largest of the activation partials 2 tm f, the split partials
// splits_w2 * f * dm and splits_w1 * dm * f, and the LayerNorm backward's
// ln_bwd_split(rows, dm).ctas * (3 dm + 2)) and sums (f32, 3 dm + 2 +
// tm tn; tm, tn: the 128 x 128 tiles of gemm_act_bwd_kernel).
// Outputs: dx (and dxin) [rows, dm] bf16, dd [2] f32, dg2 / db2 [dm] f32,
// dw1 [dm, f], db1 [f], dw2 [f, dm], dbias2 [dm], dmask [f] bf16.
// splits_w2 and splits_w1: CTAs along the B*N rows of dW2 and dW1.
extern "C" int uvc_mlp_ln_bwd(
    const void* x, const void* g2, const void* b2, const void* w1,
    const void* bias1, const void* w2, const void* mask, const void* dout,
    void* m_in, void* am, void* dh, void* dmi, void* part, void* sums,
    void* dx, void* dg2, void* db2, void* dw1, void* db1,
    void* dw2, void* dbias2, void* dmask, int rows, int dm, int f,
    int splits_w2, int splits_w1, float eps, void* stream) {
  return mlp_backward(x, nullptr, nullptr, g2, b2, w1, bias1, w2, nullptr,
                      mask, dout, m_in, am, dh, dmi, part, sums, dx,
                      nullptr, nullptr, dg2, db2, dw1, db1, dw2, dbias2,
                      dmask, rows, dm, f, splits_w2, splits_w1, eps,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int uvc_mlp_ln_blend_bwd(
    const void* x, const void* xin, const void* d, const void* g2,
    const void* b2, const void* w1, const void* bias1, const void* w2,
    const void* bias2, const void* mask, const void* dout, void* m_in,
    void* am, void* dh, void* dmi, void* part, void* sums,
    void* dx, void* dxin, void* dd, void* dg2, void* db2, void* dw1,
    void* db1, void* dw2, void* dbias2, void* dmask, int rows, int dm, int f,
    int splits_w2, int splits_w1, float eps, void* stream) {
  return mlp_backward(x, xin, d, g2, b2, w1, bias1, w2, bias2, mask, dout,
                      m_in, am, dh, dmi, part, sums, dx, dxin, dd, dg2,
                      db2, dw1, db1, dw2, dbias2, dmask, rows, dm, f,
                      splits_w2, splits_w1, eps,
                      static_cast<cudaStream_t>(stream));
}
