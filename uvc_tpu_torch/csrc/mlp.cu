// LN-fused MLP sublayer, forward, plain and with the block-gating blend:
//   mlp_ln:        out = x + (mask * gelu_erf(LN2(x) @ W1 + b1)) @ W2 + b2
//   mlp_ln_blend:  out = d1 * (x + mlp(LN2(x))) + d0 * xin
//
// Replaces uvc_tpu/ops/mlp.py::_mlp_ln_fwd_kernel (via _call_mlp_fwd) and
// uvc_tpu/ops/mlp.py::_mlp_ln_blend_fwd_kernel (via _call_mlp_blend_fwd).
//
// What bounds it on the H100: at DeiT-Small widths (dm = 384, F = 1536,
// N = 197) the two matrix products carry ~29.7 GFLOP per batch of 64
// against ~22 MB (~31 MB with the blend's second input) of input and
// output, so the tensor cores set the floor (~30 us at 989 TFLOP/s).
//
// Design: three launches on the caller's stream.
//   1. layer_norm_kernel: a_in = bf16(LN2(x)) in f32 -> [B*N, dm].
//   2. gemm_kernel<EPI_GELU_MASK>:
//      hidden = bf16(gelu_erf(a_in @ W1 + b1) * mask) -> [B*N, F].
//   3. gemm_kernel<EPI_RESID or EPI_BLEND>: the residual add, and for
//      the blend d1 * (x + out) + d0 * xin, in the fc2 epilogue; d is read
//      on the device, so the gating distribution never syncs the host.
// The TPU kernel kept the LN output and the hidden activations in VMEM;
// here they make one round trip each through device memory (~2 x 9.7 MB
// and ~2 x 38.7 MB at B = 64, F = 1536).
// Fusing fc1 and fc2 is later work.
// GELU: erff is exact; the Pallas body uses the Abramowitz-Stegun erf
// (|err| < 1.5e-7), far below the bf16 rounding of the hidden layer.
#include "common.cuh"

using uvc::bf16;

namespace {

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
  err = uvc::launch_gemm<uvc::EPI_GELU_MASK>(p, s);
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
  if (xin == nullptr) return (int)uvc::launch_gemm<uvc::EPI_RESID>(q, s);
  q.xin = static_cast<const bf16*>(xin);
  q.d = static_cast<const float*>(d);
  return (int)uvc::launch_gemm<uvc::EPI_BLEND>(q, s);
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
