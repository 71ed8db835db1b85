// The bare attention core, forward and backward, on [B, H, N, dh] operands:
//   ctx = softmax(q . k^T * scale) . v
//
// uvc_attention replaces uvc_tpu/ops/attention.py::_fwd_kernel and
// uvc_attention_bwd replaces ::_bwd_kernel (kernel A9, called through
// _call_fwd / _call_bwd: the custom VJP _attention_padded behind
// fused_attention and attention_core).  Their callers are the T2T
// architecture ablations (SE, Ghost, Dense), one call per block.
// uvc_attention_bwd_ctx replaces ::_bwd_ctx_kernel (kernel A8, called
// through _call_bwd_ctx by the composed sublayer backward of wide models,
// attention.py:672-701): the backward plus the context it recomputes; its
// note is at its entry point below.
//
// What bounds it on the H100: at the SE / Ghost shape (B = 64, H = 6,
// N = 197, dh = 64) each [B, H, N, dh] bf16 tensor is 9.68 MB.  The forward
// reads q, k, v and writes ctx (38.7 MB, 11.6 us at 3.35 TB/s) for
// 4 B H N^2 dh = 3.8 GFLOP (3.9 us at 989 TFLOP/s); the backward reads q,
// k, v, dO and writes dq, dk, dv (67.8 MB, 20.2 us) for 10 B H N^2 dh =
// 9.5 GFLOP (9.6 us).  At ViT-H/14's (B = 32, H = 16, N = 257, dh = 80)
// the forward moves 84.2 MB (25.1 us) for 10.8 GFLOP.  Both are bound by
// device memory: the logits and the probabilities ([N, N] per head) never
// leave the chip; each kernel recomputes them from q and k in registers.
//
// Design: the forward is the streamed core of attention_core_fwd.cuh
// (K1's attention step runs it too, with the ctx mask), the backward the
// streamed core of attention_core_bwd.cuh (its note there and at
// uvc_attention_bwd_ctx below), both instantiated for the padded head
// dims DHP = 16, 32, 48, 64 and 80, one warpgroup per CTA on wgmma, the
// other side's rows streamed in 64-row tiles, so any N.  Operands are
// read where they lie, at the strides the caller passes (the models hand
// over head views of one projection), and the outputs are written in the
// caller's layout.  Full tiles (dh equal to DHP, 16-byte strides and
// base) load by TMA.  The forward takes any other dh <= DHP by cp.async
// 16 or 4 bytes wide as dh and the strides allow (at an odd head dim as
// aligned 4-byte words shifted into place), zero-filling columns
// dh..DHP-1 of its tiles in shared memory (exact); so does the backward
// where 16-byte copies are allowed.  Where they are not (the Dense
// variant's head dims 41 and 74), the backward, whose operands are read
// many times more, first packs the operands into zero-padded
// [B, H, N, DHP] scratch that the caller allocates, one copy launch, as
// the reference's wrapper pads with jnp.pad, and loads them by TMA from
// there.
#include "attention_core_bwd.cuh"

namespace uvc {

// operand i of a call: its (batch, head, row) element strides are
// strides[3 i .. 3 i + 2]
template <typename T, typename P>
static Heads<T> heads_at(P* p, const long long* strides, int i) {
  return {static_cast<T*>(p), strides[3 * i], strides[3 * i + 1],
          strides[3 * i + 2]};
}

}  // namespace uvc

using uvc::bf16;
using uvc::InHeads;
using uvc::OutHeads;

// Forward.  q, k, v, out: [B, H, N, dh] bf16 device tensors, unit stride
// in dh, strides: their (batch, head, row) strides in elements, four rows
// of three; 0 < dh <= 80.  Returns 0 or a CUDA error code
// (cudaErrorInvalidValue for a head dim the kernels are not built for).
extern "C" int uvc_attention(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int batch,
                             int heads, int n, int dh, float scale,
                             void* stream) {
  const InHeads qh = uvc::heads_at<const bf16>(q, strides, 0),
                kh = uvc::heads_at<const bf16>(k, strides, 1),
                vh = uvc::heads_at<const bf16>(v, strides, 2);
  const OutHeads oh = uvc::heads_at<bf16>(out, strides, 3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)uvc::with_head_dim(dh, [&](auto d) {
    return uvc::launch_core_fwd_wg<decltype(d)::value, false>(
        qh, kh, vh, oh, nullptr, batch, heads, n, dh, scale, s);
  });
}

// The two backwards: A9 (no ctx) and A8 (with ctx).  strides: the
// (batch, head, row) strides of q, k, v, dout, dq, dk, dv and, for A8,
// ctx, in that order.
template <bool CTX>
static int core_backward(const void* q, const void* k, const void* v,
                         const void* dout, void* stats, void* pack, void* ctx,
                         void* dq, void* dk, void* dv,
                         const long long* strides, int batch, int heads,
                         int n, int dh, float scale, void* stream) {
  const InHeads qh = uvc::heads_at<const bf16>(q, strides, 0),
                kh = uvc::heads_at<const bf16>(k, strides, 1),
                vh = uvc::heads_at<const bf16>(v, strides, 2),
                doh = uvc::heads_at<const bf16>(dout, strides, 3);
  const OutHeads dqh = uvc::heads_at<bf16>(dq, strides, 4),
                 dkh = uvc::heads_at<bf16>(dk, strides, 5),
                 dvh = uvc::heads_at<bf16>(dv, strides, 6);
  const OutHeads ch = CTX ? uvc::heads_at<bf16>(ctx, strides, 7)
                         : OutHeads{};
  const uvc::CtxOut cx = {ch.p, nullptr, nullptr, nullptr,
                          ch.sb, ch.sh, ch.sr};
  float4* st = static_cast<float4*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)uvc::with_head_dim(dh, [&](auto d) {
    constexpr int DHP = decltype(d)::value;
    // operands read below 16 bytes a copy go through the pack
    if (pack == nullptr && uvc::ops_vec(dh, qh, kh, vh, doh) < 8)
      return cudaErrorInvalidValue;
    return uvc::launch_core_bwd_wg<DHP, CTX ? uvc::CTX_BF16 : uvc::CTX_NONE>(
        qh, kh, vh, doh, dqh, dkh, dvh, cx, st, static_cast<bf16*>(pack),
        batch, heads, n, dh, scale, s);
  });
}

// Backward, A9's: the port of uvc_tpu/ops/attention.py::_bwd_kernel.
// q, k, v, dout, dq, dk, dv: [B, H, N, dh] bf16, unit stride in dh,
// strides: their (batch, head, row) strides, seven rows of three in that
// order; stats: [B * H * ceil(N / 64) * 64] float4 scratch that the caller
// allocates; pack: [4, B, H, N, DHP] bf16 scratch (DHP the padded head
// dim) where q, k, v and dout do not all allow 16-byte copies (dh, the
// strides and the base multiples of 8 elements), else null; null where
// it is needed is refused (cudaErrorInvalidValue).  Two launches, three
// with the pack.
extern "C" int uvc_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* dout, void* stats, void* pack,
                                 void* dq, void* dk, void* dv,
                                 const long long* strides, int batch,
                                 int heads, int n, int dh, float scale,
                                 void* stream) {
  return core_backward<false>(q, k, v, dout, stats, pack, nullptr, dq, dk,
                              dv, strides, batch, heads, n, dh, scale,
                              stream);
}

// Kernel A8, the port of uvc_tpu/ops/attention.py::_bwd_ctx_kernel: the
// backward above plus ctx = bf16(bf16(probs) . V), the probabilities
// normalised before the product as that kernel does (the forward divides
// after it).  The query-side kernel forms this ctx in its second pass
// and writes it unmasked at its own strides.
//
// What bounds it on the H100: at ViT-H/14 stage 1 (B = 32, H = 16,
// N = 257, dh = 80) each [B, H, N, dh] bf16 tensor is 21.05 MB; it reads
// q, k, v, dO and writes ctx, dq, dk, dv (168.4 MB, 50.3 us at 3.35 TB/s)
// for 12 B H N^2 dh = 32.5 GFLOP (32.8 us at 989 TFLOP/s): device memory.
//
// Design: A9's two launches (attention_core_bwd.cuh), one more output.
// Against the bound: each CTA reads its own tile once and streams the
// other side's tiles from L2 through a three-stage ring (TMA here: the
// head views are full tiles), two CTAs of one warpgroup per SM, the
// products on wgmma; the logits and probabilities never leave the chip.
// The query side recomputes the logits three times and dp twice (7 of the
// 11 N^2 dh products, against 8 of 12 before).  The caller (the composed
// sublayer backward) passes dq, dk, dv as head views of one [B, N, 3 da]
// buffer and ctx as head views of [B, N, da], the layouts its matrix
// products take, so nothing is stacked or transposed after the call.
// strides: eight rows of three, q, k, v, dout, dq, dk, dv, ctx; pack as
// A9's.
extern "C" int uvc_attention_bwd_ctx(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     void* stats, void* pack, void* ctx,
                                     void* dq, void* dk, void* dv,
                                     const long long* strides, int batch,
                                     int heads, int n, int dh, float scale,
                                     void* stream) {
  return core_backward<true>(q, k, v, dout, stats, pack, ctx, dq, dk, dv,
                             strides, batch, heads, n, dh, scale, stream);
}
