// LN-fused attention sublayer, forward (kernel K1):
//   out = x + (mask * MHA(LN1(x) @ Wqkv + bqkv)) @ Wproj + bproj
// and the same sublayer without LayerNorm and residual (A7's forward):
//   out = (mask * MHA(x @ Wqkv + bqkv)) @ Wproj + bproj
//
// Replaces uvc_tpu/ops/attention.py::_layer_ln_fwd_kernel (called through
// _call_layer_ln_fwd) and ::_layer_fwd_kernel (through _fused_layer).  The
// backwards, uvc_layer_attention_ln_bwd and uvc_layer_attention_bwd,
// replace _layer_ln_bwd_kernel and _layer_bwd_kernel; their notes (bound,
// design) are at their entry points below.
//
// What bounds the forward on the H100: the tensor cores.  At ViT-H/14's
// stage-1 shape (B = 32, N = 257, dm = da = 1280, 16 heads of 80) it does
// 118.6 GFLOP (qkv 80.8, the attention core 10.8, the projection 27.0)
// against ~45 MB of inputs, weights and output: 119.9 us at 989 TFLOP/s,
// 13 us at 3.35 TB/s.  At DeiT-Small's (dm = da = 384, N = 197, 6 heads of
// 64, B = 64) ~18.7 GFLOP against ~20 MB: ~19 us.
//
// Design: one sequence of launches on the caller's stream for both
// (layer_ln_fwd below), K1 with a LayerNorm pass in front of it.
//   0. (K1) layer_norm_kernel (common.cuh): a_in = bf16(LN1(x)) in f32 ->
//      [B*N, dm]; A7 takes x itself as a_in.
//   1. gemm_wg_kernel<EPI_BIAS> (gemm_wg.cuh, TMA and wgmma):
//      qkv = bf16(a_in @ Wqkv + bqkv) -> [B*N, 3*da].
//   2. core_fwd_wg_kernel<DHP, MASK> (attention_core_fwd.cuh, the streamed
//      core that A9's forward runs too, at the head dim padded to 16, 32,
//      48, 64 or 80): one CTA per (64-query tile, head, image), q, k and v
//      read as head views of the packed qkv rows (TMA at head dims 64 and
//      80), K and V streamed in 64-row tiles, the softmax online in f32,
//      the normalisation after P @ V as the Pallas body does;
//      ctx = bf16(bf16(ctx) * mask) -> ctx [B*N, da], head-major.
//   3. gemm_wg_kernel<EPI_RESID> (K1): out = bf16(x + (ctx @ Wproj +
//      bproj)); gemm_wg_kernel<EPI_BIAS> (A7): out = bf16(ctx @ Wproj +
//      bproj).
// Against the bound: the two products (107.8 of the 118.6 GFLOP at ViT-H)
// run on wgmma from TMA-fed shared memory, the core on wgmma from
// streamed tiles, and N is not bounded by shared memory.  The TPU kernels
// kept a_in, qkv and ctx in VMEM; here they make one round trip each
// through device memory (~8 x 21 MB at ViT-H: ~50 us at 3.35 TB/s, spread
// over the launches that write and read them).  The attention width
// da = heads * dh, any even head dim up to 80, may differ from dm
// (compacted layers).
#include "attention_core_bwd.cuh"
#include "gemm_wg.cuh"
#include "ln_bwd.cuh"

namespace uvc {

// heads of dh columns of packed rows [B*N, ld] starting at a column: q, k
// or v of qkv [B*N, 3 da] (columns 0, da, 2 da), or one of the [B*N, da]
// rows
static InHeads packed_in(const bf16* rows, int n, int ld, int dh) {
  return {rows, (long long)n * ld, dh, ld};
}

static OutHeads packed_out(bf16* rows, int n, int ld, int dh) {
  return {rows, (long long)n * ld, dh, ld};
}

// The forward's launches 1-3 from a (K1: bf16(LN1(x)); A7: x): qkv on
// gemm_wg, the streamed core with the ctx mask, the projection on gemm_wg,
// out = bf16(x + (ctx . Wproj + bproj)) with the residual x (K1) or
// bf16(ctx . Wproj + bproj) where x is null (A7).
static cudaError_t layer_ln_fwd(const bf16* a, const bf16* wqkv,
                                const bf16* bqkv, const bf16* wproj,
                                const bf16* bproj, const bf16* mask,
                                const bf16* x, bf16* qkv, bf16* ctx, bf16* out,
                                int batch, int n, int dm, int da, int heads,
                                float scale, cudaStream_t s) {
  const int rows = batch * n;
  GemmArgs p = {};
  p.a = a;
  p.w = wqkv;
  p.bias = bqkv;
  p.out = qkv;
  p.M = rows;
  p.N = 3 * da;
  p.K = dm;
  cudaError_t err = launch_gemm_wg<EPI_BIAS>(p, s);
  if (err != cudaSuccess) return err;

  const int ld = 3 * da, dh = da / heads;
  err = with_head_dim(dh, [&](auto d) {
    return launch_core_fwd_wg<decltype(d)::value, true>(
        packed_in(qkv, n, ld, dh), packed_in(qkv + da, n, ld, dh),
        packed_in(qkv + 2 * da, n, ld, dh), packed_out(ctx, n, da, dh), mask,
        batch, heads, n, dh, scale, s);
  });
  if (err != cudaSuccess) return err;

  GemmArgs q = {};
  q.a = ctx;
  q.w = wproj;
  q.bias = bproj;
  q.out = out;
  q.M = rows;
  q.N = dm;
  q.K = da;
  if (x == nullptr) return launch_gemm_wg<EPI_BIAS>(q, s);
  q.resid = x;
  return launch_gemm_wg<EPI_RESID>(q, s);
}

// Scratch and outputs of the sublayer backward below the qkv input.
struct SublayerBwd {
  const bf16 *a, *wqkv, *bqkv, *wproj, *mask, *dout;
  bf16* qkv;       // [rows, 3 da]
  float* t32;      // [rows, da]   do . Wproj^T
  bf16* dctx;      // [rows, da]   bf16(t * mask)
  bf16* ctxm;      // [rows, da]   bf16(ctx * mask), ctx = bf16(probs) . V
  float4* stats;   // [B * heads * ceil(N / 64) * 64]  per query
  bf16* dqkv;      // [rows, 3 da]
  float* part;     // dmask, split-K and column-sum partials
  bf16 *dwqkv, *dbqkv, *dwproj, *dmask;
  int batch, n, dm, da, heads;
  int splits_qkv, splits_proj;  // CTAs along K of dWqkv and dWproj
  float scale;
};

// Recomputes qkv from a, then emits dqkv (attention core), dWqkv, dWproj,
// dbqkv and dmask = sum(t * ctx).  Eleven launches:
//   1. gemm_wg <EPI_BIAS>: qkv = bf16(a . Wqkv + bqkv).
//   2. gemm_wg <EPI_F32_MASK, K-major B>: t = do . Wproj^T (f32),
//      dctx = bf16(t * mask).
//   3. core_bwd_q_wg_kernel<DHP, CTX_SUBLAYER> (attention_core_bwd.cuh):
//      dq, ctxm = bf16(ctx * mask), the per-query statistics and dmask's
//      partial sums over the tile's 64 rows (ctx in f32 against t, read
//      back), per (query tile, head, image), on head views of qkv, dctx
//      and dqkv.
//   4. core_bwd_kv_wg_kernel<DHP>: dk, dv, per (key tile, head, image).
//   5. dmask: the partials summed in order.
//   6-7. gemm_wg <EPI_F32, MN-major A> split over the B*N rows:
//      dWqkv = a^T . dqkv as f32 partials, then their in-order sum,
//      rounded once.
//   8-9. the same for dWproj = ctxm^T . do.
//   10-11. dbqkv: column sums of dqkv (ln_bwd.cuh: partials over blocks
//      of rows that cover the SMs twice), then an in-order pass.
// The caller takes d a = dqkv . Wqkv^T from dqkv, and dbproj = colsum(do):
// A2 in its LayerNorm backward's pass over do, A7 by a column sum.
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
  cudaError_t err = launch_gemm_wg<EPI_BIAS>(p, s);
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
  err = launch_gemm_wg<EPI_F32_MASK, false, true>(p, s);
  if (err != cudaSuccess) return err;

  const int ld = 3 * b.da, dh = b.da / b.heads;
  const CtxOut cx = {b.ctxm, b.t32, b.part, b.mask, (long long)b.n * b.da,
                     dh, b.da};
  err = with_head_dim(dh, [&](auto d) {
    return launch_core_bwd_wg<decltype(d)::value, CTX_SUBLAYER>(
        packed_in(b.qkv, b.n, ld, dh), packed_in(b.qkv + b.da, b.n, ld, dh),
        packed_in(b.qkv + 2 * b.da, b.n, ld, dh),
        packed_in(b.dctx, b.n, b.da, dh), packed_out(b.dqkv, b.n, ld, dh),
        packed_out(b.dqkv + b.da, b.n, ld, dh),
        packed_out(b.dqkv + 2 * b.da, b.n, ld, dh), cx, b.stats, nullptr,
        b.batch, b.heads, b.n, dh, b.scale, s);
  });
  if (err != cudaSuccess) return err;
  // dmask's partials, one row per query tile of an image, in order
  err = launch_reduce(b.part, b.batch * ((b.n + TILE_ROWS - 1) / TILE_ROWS),
                      b.da, nullptr, nullptr, b.dmask, s);
  if (err != cudaSuccess) return err;

  p = {};
  p.a = b.a;
  p.w = b.dqkv;
  p.M = b.dm;
  p.N = 3 * b.da;
  p.K = rows;
  err = weight_grad_wg(p, b.splits_qkv, b.part, b.dwqkv, s);
  if (err != cudaSuccess) return err;

  p = {};
  p.a = b.ctxm;
  p.w = b.dout;
  p.M = b.da;
  p.N = b.dm;
  p.K = rows;
  err = weight_grad_wg(p, b.splits_proj, b.part, b.dwproj, s);
  if (err != cudaSuccess) return err;

  return column_sum(b.dqkv, rows, 3 * b.da, b.part, nullptr, nullptr,
                    b.dbqkv, s);
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
  return (int)uvc::layer_ln_fwd(
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
// drop-path).  What bounds it: the tensor cores, as K1 (~18.7 GFLOP
// against ~20 MB at B = 64, N = 197, dm = da = 384: ~19 us).  Design:
// K1's sequence from x itself (layer_ln_fwd with no residual): qkv on
// gemm_wg, the streamed core with the ctx mask, the projection on gemm_wg
// with the bias epilogue; three launches, any N.  qkv [B*N, 3*da] and ctx
// [B*N, da] (bf16) are scratch that the caller allocates.
extern "C" int uvc_layer_attention(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* bproj, const void* mask, void* qkv, void* ctx, void* out,
    int batch, int n, int dm, int da, int heads, float scale, void* stream) {
  return (int)uvc::layer_ln_fwd(
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
// dm = da = 384, 6 heads) it does ~52.3 GFLOP: the qkv recompute,
// dqkv . Wqkv^T and dWqkv (11.15 each), t = do . Wproj^T and dWproj (3.72
// each), and the attention core (12 N^2 dh per (image, head) over 384
// pairs, 11.44) against ~30 MB of inputs and outputs, so the tensor cores
// set the floor: ~53 us at 989 TFLOP/s.
//
// Design: sixteen launches on the caller's stream, no float atomics.
//   1. layer_norm_kernel: a_in = bf16(LN1(x)).
//   2-12. sublayer_bwd above with a = a_in: the five products on gemm_wg
//      (TMA and wgmma: the qkv recompute, t and dctx, then dWqkv and
//      dWproj split over the B*N rows so that their few output tiles fill
//      the card, each followed by the in-order sum of its f32 partials),
//      the streamed core backward (two launches, with dmask's partials and
//      their sum) and dbqkv's column sums.
//  13. gemm_wg <EPI_F32, K-major B>: d a_in = dqkv . Wqkv^T (f32).
//  14. ln_bwd_kernel (ln_bwd.cuh): dx = bf16(LN VJP + do), a warp a row,
//      about twice as many CTAs as SMs, per CTA partials of dgamma1,
//      dbeta1 and colsum(do) (dbproj); 15. their in-order sum;
//  16. ln_bwd_finish_kernel: dgamma1, dbeta1 and dbproj = bf16(colsum).
// Against the bound: every product on wgmma from TMA-fed shared memory,
// the core streamed with N not bounded by shared memory.  The TPU kernel
// kept every intermediate in VMEM and accumulated the weight gradients
// over its sequential grid; here a_in, qkv, t, dctx, ctxm, dqkv and
// d a_in make a round trip through device memory (~9.7 MB each in bf16 at
// the train shape, twice that in f32), and the split partials one more
// (~9 MB); the logits, the probabilities and the f32 ctx never do.  Any
// dm up to LNB_MAX_DM (1280: ViT-H/14).  PERF.md has the launches' times
// (chip_smoke.py's breakdown).
extern "C" int uvc_layer_attention_ln_bwd(
    const void* x, const void* g1, const void* b1, const void* wqkv,
    const void* bqkv, const void* wproj, const void* mask, const void* dout,
    void* a_in, void* qkv, void* t32, void* dctx, void* ctxm, void* stats,
    void* dqkv, void* da_in, void* part, void* dx, void* dg1,
    void* db1, void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
    void* dmask, int batch, int n, int dm, int da, int heads, int splits_qkv,
    int splits_proj, float scale, float eps, void* stream) {
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
      static_cast<bf16*>(dctx), static_cast<bf16*>(ctxm),
      static_cast<float4*>(stats), static_cast<bf16*>(dqkv), partf,
      static_cast<bf16*>(dwqkv), static_cast<bf16*>(dbqkv),
      static_cast<bf16*>(dwproj), static_cast<bf16*>(dmask), batch, n, dm,
      da, heads, splits_qkv, splits_proj, scale};
  err = uvc::sublayer_bwd(b, s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs p = {};
  p.a = b.dqkv;
  p.w = b.wqkv;
  p.out32 = static_cast<float*>(da_in);
  p.M = rows;
  p.N = dm;
  p.K = 3 * da;
  err = uvc::launch_gemm_wg<uvc::EPI_F32, false, true>(p, s);
  if (err != cudaSuccess) return (int)err;

  uvc::LnBwdArgs l = {};
  l.x = xb;
  l.gamma = static_cast<const float*>(g1);
  l.dy = static_cast<const float*>(da_in);
  l.resid = b.dout;
  l.dx = static_cast<bf16*>(dx);
  l.part = partf;
  l.rows = rows;
  l.dm = dm;
  l.eps = eps;
  // the sums after the partials
  float* sums = partf + (size_t)uvc::ln_bwd_split(rows, dm).ctas *
                            uvc::ln_bwd_part_cols(dm);
  err = uvc::launch_ln_bwd(l, sums, s);
  if (err != cudaSuccess) return (int)err;
  return (int)uvc::launch_ln_bwd_finish(
      sums, dm, nullptr, static_cast<float*>(dg1), static_cast<float*>(db1),
      static_cast<bf16*>(dbproj), nullptr, 0, nullptr, nullptr, s);
}

// Backward of the bare attention sublayer: the port of
// uvc_tpu/ops/attention.py::_layer_bwd_kernel (called through
// _fused_layer_bwd, its ng == 1 branch), kernel A7.  Emits
// dx = bf16(dqkv . Wqkv^T) (no residual, no LN VJP), dWqkv with x itself
// as the A operand, dbqkv, dWproj, dbproj and dmask = sum(t * ctx).
//
// What bounds it: the same products as uvc_layer_attention_ln_bwd (~52.3
// GFLOP at the train shape against ~30 MB: the tensor cores, ~53 us).
// Design: sublayer_bwd with a = x (eleven launches), dbproj's column sums
// of do (two), then one gemm_wg <EPI_SCALE, K-major B> that rounds
// dx = dqkv . Wqkv^T to bf16 in its epilogue: A2's sequence without the
// LayerNorm pass and the LN backward.  Fourteen launches, no float
// atomics.  Any dm: a
// part-gated ViT-H/14 (dm 1280) runs it.
extern "C" int uvc_layer_attention_bwd(
    const void* x, const void* wqkv, const void* bqkv, const void* wproj,
    const void* mask, const void* dout, void* qkv, void* t32, void* dctx,
    void* ctxm, void* stats, void* dqkv, void* part, void* dx,
    void* dwqkv, void* dbqkv, void* dwproj, void* dbproj, void* dmask,
    int batch, int n, int dm, int da, int heads, int splits_qkv,
    int splits_proj, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uvc::SublayerBwd b = {
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const bf16*>(bqkv), static_cast<const bf16*>(wproj),
      static_cast<const bf16*>(mask), static_cast<const bf16*>(dout),
      static_cast<bf16*>(qkv), static_cast<float*>(t32),
      static_cast<bf16*>(dctx), static_cast<bf16*>(ctxm),
      static_cast<float4*>(stats), static_cast<bf16*>(dqkv),
      static_cast<float*>(part), static_cast<bf16*>(dwqkv),
      static_cast<bf16*>(dbqkv), static_cast<bf16*>(dwproj),
      static_cast<bf16*>(dmask), batch, n, dm, da, heads, splits_qkv,
      splits_proj, scale};
  cudaError_t err = uvc::sublayer_bwd(b, s);
  if (err != cudaSuccess) return (int)err;
  err = uvc::column_sum(b.dout, batch * n, dm, b.part, nullptr, nullptr,
                        static_cast<bf16*>(dbproj), s);
  if (err != cudaSuccess) return (int)err;

  uvc::GemmArgs p = {};
  p.a = b.dqkv;
  p.w = b.wqkv;
  p.out = static_cast<bf16*>(dx);
  p.M = batch * n;
  p.N = dm;
  p.K = 3 * da;
  return (int)uvc::launch_gemm_wg<uvc::EPI_SCALE, false, true>(p, s);
}
