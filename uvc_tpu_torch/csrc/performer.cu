// The token-performer stage of the T2T stem, forward (uvc_performer) and
// backward (uvc_performer_bwd).
//
// Replaces uvc_tpu/ops/performer.py::_fwd_merged_kernel and
// _bwd_merged_kernel (A10) and the split pair _sums_kernel +
// _apply_kernel / _bwd1_kernel + _bwd2_kernel (A11).  The two Pallas forms
// compute one function and differ only in how the TPU's VMEM tiles it;
// this file ports that function once, in the split form, which is the
// natural one where blocks run in parallel: the global sums over an
// image's tokens (kptv, kpsum forward; dkptv, dkpsum backward) close one
// pass before the next one reads them.
//
// Shapes: x [B, N, dim] bf16 in an expanded feature layout with fcount
// live slots (fmask), emb = 64, m = 32 random features, dim a multiple of
// 8 up to 1024.  Numerics follow the Pallas bodies: LayerNorms, the random
// features prm(t) = exp(t w^T - |t|^2 / 2) / sqrt(m), the normaliser and
// the global sums in f32; bf16 matmul inputs with f32 accumulation; bf16
// roundings where the Pallas bodies cast.  GELU uses the exact erff.
//
// What bounds it on the H100: at T2T-ViT-14's stage 1 (B = 64, N = 3136,
// dim = 192 with 147 live slots) the forward moves ~103 MB of inputs and
// outputs (x 77 MB, out 26 MB) against ~23 GFLOP, so memory bounds it
// (~31 us at 3.35 TB/s); the backward's ~69 GFLOP with the recompute
// bound it by operations (~70 us at 989 TFLOP/s).
//
// Design (right first; fusing the passes into per-tile CTAs that keep the
// intermediates on chip, and wgmma / TMA, are later work):
//   forward, nine launches --
//     1. ln1_kernel: xn = bf16(LN1(x)) over the live slots.
//     2. gemm <EPI_F32>: kqv = xn . Wkqv + b (f32).
//     3. sums_kernel, CTA per (128-token tile, image): kp = bf16(prm(k)),
//        qp = prm(q) (written, f32), v = bf16(kqv_v) (written), and the
//        tile's partial kptv = v^T kp, kpsum = sum kp;
//     4. reduce_tiles_kernel: the partials added per image in tile order
//        (no float atomics: two launches agree bit for bit).
//     5. apply_kernel: d = qp . kpsum, y = bf16(qp) . bf16(kptv)^T / (d +
//        1e-8) -> bf16.  Pass 2 reads the qp and v that pass 1 wrote
//        (~51 MB at stage 1) instead of re-reading x (77 MB) and redoing
//        LN1 and the q|v projection as _apply_kernel does.
//     6. gemm <EPI_F32>: attn = y . Wproj + b (f32).
//     7. ln2_kernel: attn += v (f32); h2 = bf16(LN2(bf16(attn))).
//     8. gemm <EPI_GELU_MASK>: a = bf16(gelu(h2 . W1 + b1)).
//     9. gemm <EPI_RESID32>: out = bf16(attn + a . W2 + b2).
//   backward, pass 1 recomputes the forward (LN1, kqv, y, attn, h2, the
//   fc1 pre-activation), then the MLP, LN2 and proj gradients, the q path
//   (qpath_kernel) with per-tile partials of dkptv / dkpsum, their
//   reduction, and dx's first half (the q|v columns through LN1's VJP);
//   pass 2 takes the complete dkptv / dkpsum through the k / v path
//   (kvpath_kernel) and adds dx's second half, each half rounded to bf16
//   before the add, as both Pallas forms round them.  Weight gradients are
//   products over the B*N rows: split over K into f32 partials of 2048
//   rows each (the TPU's sequential-grid accumulation into one block does
//   not carry over), then added in index order, as every column sum is.
#include "common.cuh"

using uvc::bf16;
using uvc::bf2f;
using uvc::f2bf;
using uvc::warp_sum;

namespace {

constexpr int EMB = 64;              // token dim
constexpr int M = 32;                // random features
constexpr int KQV = 3 * EMB;
constexpr int WARPS = 8;
constexpr int ROWS_PER_WARP = 16;
constexpr int TILE = WARPS * ROWS_PER_WARP;   // tokens (rows) per CTA
constexpr int MAX_DIM = 1024;
constexpr int CH = MAX_DIM / 256;    // 8-wide chunks of a row per lane
constexpr int KCHUNK = 2048;         // rows of K per split-K CTA
constexpr int PART = EMB * M + M;    // one tile's [emb, m] + [m] partial
constexpr float LN_EPS = 1e-5f;
constexpr float D_EPS = 1e-8f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float rnd(float v) { return bf2f(f2bf(v)); }

// w [m, emb] f32 in shared memory, padded so that lane j reading row j and
// a broadcast column hits 32 distinct banks
struct WShared {
  float w[M][EMB + 1];
};

__device__ void load_w(WShared& s, const float* __restrict__ w) {
  for (int i = threadIdx.x; i < M * EMB; i += blockDim.x)
    s.w[i / EMB][i % EMB] = w[i];
}

// prm(t)_j in lane j for the 64-wide row t held as t[lane], t[lane + 32]
__device__ __forceinline__ float prm_lane(float tlo, float thi,
                                          const WShared& s, int lane) {
  const float xd = warp_sum(tlo * tlo + thi * thi) / 2.f;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc += __shfl_sync(FULL, tlo, i) * s.w[lane][i];
#pragma unroll
  for (int i = 0; i < 32; ++i)
    acc += __shfl_sync(FULL, thi, i) * s.w[lane][32 + i];
  return expf(acc - xd) / 5.65685424949238f;   // sqrt(m)
}

// dt_i (i = lane, lane + 32) of prm's VJP: bf16(dwtx) . bf16(w) - t_i *
// sum(dwtx), given dwtx_j in lane j
__device__ __forceinline__ void prm_vjp(float dwtx, float tlo, float thi,
                                        const WShared& s, int lane,
                                        float& dlo, float& dhi) {
  const float tot = warp_sum(dwtx);
  const float db = rnd(dwtx);
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float dj = __shfl_sync(FULL, db, j);
    lo += dj * rnd(s.w[j][lane]);
    hi += dj * rnd(s.w[j][lane + 32]);
  }
  dlo = lo - tlo * tot;
  dhi = hi - thi * tot;
}

// image b's [emb, m] matrix (kptv or dkptv), rounded to bf16, padded, and
// its [m] vector (kpsum or dkpsum) in f32
struct KShared {
  float k[EMB][M + 1];
  float sum[M];
};

__device__ void load_k(KShared& s, const float* __restrict__ kmat,
                       const float* __restrict__ ksum, int b) {
  kmat += (size_t)b * EMB * M;
  for (int i = threadIdx.x; i < EMB * M; i += blockDim.x)
    s.k[i / M][i % M] = rnd(kmat[i]);
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    s.sum[i] = ksum[(size_t)b * M + i];
}

// The warps' V values per lane, summed over the warps in index order:
// out[i * 32 + lane] = sum_w v_w[i].  All threads of the CTA call it.
struct Red {
  float r[WARPS][16][33];
};

template <int V>
__device__ void reduce_warps(const float (&v)[V], Red& red,
                             float* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i0 = 0; i0 < V; i0 += 16) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i0 + i < V) red.r[warp][i][lane] = v[i0 + i];
    __syncthreads();
    const int cnt = (V - i0 < 16 ? V - i0 : 16) * 32;
    for (int idx = threadIdx.x; idx < cnt; idx += blockDim.x) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red.r[w][idx >> 5][idx & 31];
      out[i0 * 32 + idx] = s;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// LN1 over the live slots, one warp per row: xn = bf16((x - mu) * rstd * g
// + b) with mu and var summed over fmask and divided by fcount
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ln1_stats(const bf16* __restrict__ xr,
                                          const float* __restrict__ fmask,
                                          int dim, float fcount, int lane,
                                          float& mean, float& rstd) {
  float s = 0.f;
  for (int c = lane * 8; c < dim; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += bf2f(e[j]) * fmask[c + j];
  }
  mean = warp_sum(s) / fcount;
  float q = 0.f;
  for (int c = lane * 8; c < dim; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = bf2f(e[j]) - mean;
      q += d * d * fmask[c + j];
    }
  }
  rstd = rsqrtf(warp_sum(q) / fcount + LN_EPS);
}

__global__ void ln1_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ g,
                           const float* __restrict__ b,
                           const float* __restrict__ fmask, int rows, int dim,
                           float fcount, bf16* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * dim;
  float mean, rstd;
  ln1_stats(xr, fmask, dim, fcount, lane, mean, rstd);
  bf16* orow = out + (size_t)row * dim;
  for (int c = lane * 8; c < dim; c += 256) {
    uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = f2bf((bf2f(e[j]) - mean) * rstd * g[c + j] + b[c + j]);
    *reinterpret_cast<uint4*>(orow + c) = v;
  }
}

// LN1's VJP over the live slots with the column sums, one warp per row, a
// CTA per TILE rows: from dxn (f32) and x (xhat, rstd recomputed),
//   v = (gd - sum(gd) / fcount - xhat * sum(gd * xhat) / fcount) * rstd
//       * fmask,  gd = dxn * g * fmask;
//   dx = bf16(v), or bf16(dx_prev + bf16(v)) when dx_prev is given;
// part[blockIdx.x] = (sum dxn * xhat, sum dxn) over the CTA's rows, [2, dim].
__global__ void __launch_bounds__(WARPS * 32)
    ln1_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ fmask, const float* dxn,
                   const bf16* dx_prev, int rows, int dim, float fcount,
                   bf16* dx, float* __restrict__ part) {
  __shared__ float red[WARPS][MAX_DIM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float accg[CH][8], accb[CH][8];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int j = 0; j < 8; ++j) accg[ch][j] = accb[ch][j] = 0.f;

  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int row = blockIdx.x * TILE + warp * ROWS_PER_WARP + i;
    if (row >= rows) break;
    const size_t base = (size_t)row * dim;
    float mean, rstd;
    ln1_stats(x + base, fmask, dim, fcount, lane, mean, rstd);
    float xh[CH][8], gd[CH][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = lane * 8 + ch * 256;
      if (c < dim) {
        const uint4 v = *reinterpret_cast<const uint4*>(x + base + c);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
        const float4 y0 = *reinterpret_cast<const float4*>(dxn + base + c);
        const float4 y1 =
            *reinterpret_cast<const float4*>(dxn + base + c + 4);
        const float yv[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xh[ch][j] = (bf2f(e[j]) - mean) * rstd;
          gd[ch][j] = yv[j] * g[c + j] * fmask[c + j];
          s1 += gd[ch][j];
          s2 += gd[ch][j] * xh[ch][j];
          accg[ch][j] += yv[j] * xh[ch][j];
          accb[ch][j] += yv[j];
        }
      }
    }
    const float m1 = warp_sum(s1) / fcount;
    const float m2 = warp_sum(s2) / fcount;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = lane * 8 + ch * 256;
      if (c < dim) {
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
        uint4 pv = make_uint4(0, 0, 0, 0);
        if (dx_prev) pv = *reinterpret_cast<const uint4*>(dx_prev + base + c);
        const bf16* pe = reinterpret_cast<const bf16*>(&pv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = (gd[ch][j] - m1 - xh[ch][j] * m2) * rstd *
                          fmask[c + j];
          oe[j] = dx_prev ? f2bf(bf2f(pe[j]) + rnd(v)) : f2bf(v);
        }
        *reinterpret_cast<uint4*>(dx + base + c) = o;
      }
    }
  }

  // fixed-order reduction over the CTA's warps
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = lane * 8 + ch * 256;
      if (c < dim)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          red[warp][c + j] = pass == 0 ? accg[ch][j] : accb[ch][j];
    }
    __syncthreads();
    float* out = part + ((size_t)blockIdx.x * 2 + pass) * dim;
    for (int c = threadIdx.x; c < dim; c += blockDim.x) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) v += red[w][c];
      out[c] = v;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// the linear attention, one warp per token row, a CTA per (TILE tokens,
// image): grid (ceil(N / TILE), B).  Lane j holds random feature j; a
// 64-wide row is held as [lane] and [lane + 32].
// ---------------------------------------------------------------------------

// Forward pass 1: kp = bf16(prm(k)), qp = prm(q) -> qp_out (f32), v =
// bf16(kqv_v) -> v_out; part[image, tile] = (sum_t v_t (x) kp_t [emb, m],
// sum_t kp_t [m]).
__global__ void __launch_bounds__(WARPS * 32)
    sums_kernel(const float* __restrict__ kqv, const float* __restrict__ w,
                int n, float* __restrict__ qp_out, bf16* __restrict__ v_out,
                float* __restrict__ part) {
  __shared__ WShared ws;
  __shared__ Red red;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_w(ws, w);
  __syncthreads();
  float acc[EMB];
#pragma unroll
  for (int e = 0; e < EMB; ++e) acc[e] = 0.f;
  float ks = 0.f;
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int tok = blockIdx.x * TILE + warp * ROWS_PER_WARP + i;
    if (tok >= n) break;
    const size_t row = (size_t)blockIdx.y * n + tok;
    const float* kr = kqv + row * KQV;
    const float kp = rnd(prm_lane(kr[lane], kr[32 + lane], ws, lane));
    qp_out[row * M + lane] = prm_lane(kr[64 + lane], kr[96 + lane], ws, lane);
    const bf16 vlo = f2bf(kr[128 + lane]), vhi = f2bf(kr[160 + lane]);
    v_out[row * EMB + lane] = vlo;
    v_out[row * EMB + 32 + lane] = vhi;
    const float vl = bf2f(vlo), vh = bf2f(vhi);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      acc[e] += __shfl_sync(FULL, vl, e) * kp;
      acc[32 + e] += __shfl_sync(FULL, vh, e) * kp;
    }
    ks += kp;
  }
  float* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * PART;
  reduce_warps<EMB>(acc, red, out);
  const float ksv[1] = {ks};
  reduce_warps<1>(ksv, red, out + EMB * M);
}

// The per-tile partials of each image added in tile order:
// part [B, ntiles, PART] -> mat [B, emb, m], vec [B, m].
__global__ void reduce_tiles_kernel(const float* __restrict__ part,
                                    int ntiles, float* __restrict__ mat,
                                    float* __restrict__ vec) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= PART) return;
  float s = 0.f;
  for (int t = 0; t < ntiles; ++t)
    s += part[((size_t)b * ntiles + t) * PART + c];
  if (c < EMB * M)
    mat[(size_t)b * EMB * M + c] = s;
  else
    vec[(size_t)b * M + c - EMB * M] = s;
}

// Forward pass 2: d = qp . kpsum; y = bf16(bf16(qp) . bf16(kptv)^T / (d +
// 1e-8)).
__global__ void __launch_bounds__(WARPS * 32)
    apply_kernel(const float* __restrict__ qp, const float* __restrict__ kptv,
                 const float* __restrict__ kpsum, int n,
                 bf16* __restrict__ y) {
  __shared__ KShared ks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_k(ks, kptv, kpsum, blockIdx.y);
  __syncthreads();
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int tok = blockIdx.x * TILE + warp * ROWS_PER_WARP + i;
    if (tok >= n) break;
    const size_t row = (size_t)blockIdx.y * n + tok;
    const float q = qp[row * M + lane];
    const float den = warp_sum(q * ks.sum[lane]) + D_EPS;
    const float qb = rnd(q);
    float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float qj = __shfl_sync(FULL, qb, j);
      lo += qj * ks.k[lane][j];
      hi += qj * ks.k[lane + 32][j];
    }
    y[row * EMB + lane] = f2bf(lo / den);
    y[row * EMB + 32 + lane] = f2bf(hi / den);
  }
}

// The q side of the backward's recompute for one row: qp (f32) and
// bf16(qp) in lane j, 1 / (d + 1e-8), and y = (bf16(qp) . bf16(kptv)^T)
// / (d + 1e-8) as [lane], [lane + 32] (f32).
struct QRow {
  float qp, qpb, dd_inv, ylo, yhi;
};

__device__ __forceinline__ QRow q_front(const float* kr, const WShared& ws,
                                        const KShared& ks, int lane) {
  QRow f;
  f.qp = prm_lane(kr[64 + lane], kr[96 + lane], ws, lane);
  f.qpb = rnd(f.qp);
  f.dd_inv = 1.f / (warp_sum(f.qp * ks.sum[lane]) + D_EPS);
  float lo = 0.f, hi = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float qj = __shfl_sync(FULL, f.qpb, j);
    lo += qj * ks.k[lane][j];
    hi += qj * ks.k[lane + 32][j];
  }
  f.ylo = lo * f.dd_inv;
  f.yhi = hi * f.dd_inv;
  return f;
}

// Backward pass 1 front: y -> bf16 and v = bf16(kqv_v), both written.
__global__ void __launch_bounds__(WARPS * 32)
    bwd_front_kernel(const float* __restrict__ kqv,
                     const float* __restrict__ w,
                     const float* __restrict__ kptv,
                     const float* __restrict__ kpsum, int n,
                     bf16* __restrict__ y, bf16* __restrict__ v) {
  __shared__ WShared ws;
  __shared__ KShared ks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_w(ws, w);
  load_k(ks, kptv, kpsum, blockIdx.y);
  __syncthreads();
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int tok = blockIdx.x * TILE + warp * ROWS_PER_WARP + i;
    if (tok >= n) break;
    const size_t row = (size_t)blockIdx.y * n + tok;
    const float* kr = kqv + row * KQV;
    const QRow f = q_front(kr, ws, ks, lane);
    y[row * EMB + lane] = f2bf(f.ylo);
    y[row * EMB + 32 + lane] = f2bf(f.yhi);
    v[row * EMB + lane] = f2bf(kr[128 + lane]);
    v[row * EMB + 32 + lane] = f2bf(kr[160 + lane]);
  }
}

// Backward pass 1, the q path: from dy = bf16(dattn) . Wproj^T (f32),
//   dy_pre = bf16(dy / (d + eps)), dd = -sum(dy * y) / (d + eps),
//   dqp = dy_pre . bf16(kptv) + dd * kpsum, dwtx = qp * dqp,
//   dq = bf16(dwtx) . bf16(w) - q * sum(dwtx) -> bf16 into dqv[:, :emb];
// part[image, tile] = (sum_t dy_pre_t (x) bf16(qp_t), sum_t dd_t qp_t) and
// colpart[image * ntiles + tile] = the column sums of dq (f32).
__global__ void __launch_bounds__(WARPS * 32)
    qpath_kernel(const float* __restrict__ kqv, const float* __restrict__ w,
                 const float* __restrict__ kptv,
                 const float* __restrict__ kpsum,
                 const float* __restrict__ dy, int n, bf16* __restrict__ dqv,
                 float* __restrict__ part, float* __restrict__ colpart) {
  __shared__ WShared ws;
  __shared__ KShared ks;
  __shared__ Red red;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_w(ws, w);
  load_k(ks, kptv, kpsum, blockIdx.y);
  __syncthreads();
  float acc[EMB];
#pragma unroll
  for (int e = 0; e < EMB; ++e) acc[e] = 0.f;
  float dks = 0.f;
  float cs[2] = {0.f, 0.f};
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int tok = blockIdx.x * TILE + warp * ROWS_PER_WARP + i;
    if (tok >= n) break;
    const size_t row = (size_t)blockIdx.y * n + tok;
    const float* kr = kqv + row * KQV;
    const QRow f = q_front(kr, ws, ks, lane);
    const float dyl = dy[row * EMB + lane], dyh = dy[row * EMB + 32 + lane];
    const float dd = -warp_sum(dyl * f.ylo + dyh * f.yhi) * f.dd_inv;
    const float pl = rnd(dyl * f.dd_inv), ph = rnd(dyh * f.dd_inv);
    float dqp = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float a = __shfl_sync(FULL, pl, e);
      const float b = __shfl_sync(FULL, ph, e);
      dqp += a * ks.k[e][lane];
      dqp += b * ks.k[32 + e][lane];
      acc[e] += a * f.qpb;
      acc[32 + e] += b * f.qpb;
    }
    dqp += dd * ks.sum[lane];
    dks += dd * f.qp;
    float dlo, dhi;
    prm_vjp(f.qp * dqp, kr[64 + lane], kr[96 + lane], ws, lane, dlo, dhi);
    dqv[row * 2 * EMB + lane] = f2bf(dlo);
    dqv[row * 2 * EMB + 32 + lane] = f2bf(dhi);
    cs[0] += dlo;
    cs[1] += dhi;
  }
  float* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * PART;
  reduce_warps<EMB>(acc, red, out);
  const float dksv[1] = {dks};
  reduce_warps<1>(dksv, red, out + EMB * M);
  reduce_warps<2>(cs, red, colpart +
                  ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * EMB);
}

// Backward pass 2, the k / v path from the complete dkptv / dkpsum:
//   kp = prm(k), dv = bf16(kp) . bf16(dkptv)^T,
//   dkp = v . bf16(dkptv) + dkpsum, dwtx = kp * dkp,
//   dk = bf16(dwtx) . bf16(w) - k * sum(dwtx);
// dkv = bf16([dk | dv]) and colpart[image * ntiles + tile] = the column
// sums of [dk | dv] (f32).
__global__ void __launch_bounds__(WARPS * 32)
    kvpath_kernel(const float* __restrict__ kqv, const float* __restrict__ w,
                  const float* __restrict__ dkptv,
                  const float* __restrict__ dkpsum, int n,
                  bf16* __restrict__ dkv, float* __restrict__ colpart) {
  __shared__ WShared ws;
  __shared__ KShared ks;
  __shared__ Red red;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_w(ws, w);
  load_k(ks, dkptv, dkpsum, blockIdx.y);
  __syncthreads();
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int tok = blockIdx.x * TILE + warp * ROWS_PER_WARP + i;
    if (tok >= n) break;
    const size_t row = (size_t)blockIdx.y * n + tok;
    const float* kr = kqv + row * KQV;
    const float klo = kr[lane], khi = kr[32 + lane];
    const float kp = prm_lane(klo, khi, ws, lane);
    const float kpb = rnd(kp);
    const float vl = rnd(kr[128 + lane]), vh = rnd(kr[160 + lane]);
    float dvlo = 0.f, dvhi = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float kj = __shfl_sync(FULL, kpb, j);
      dvlo += kj * ks.k[lane][j];
      dvhi += kj * ks.k[lane + 32][j];
    }
    float dkp = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      dkp += __shfl_sync(FULL, vl, e) * ks.k[e][lane];
      dkp += __shfl_sync(FULL, vh, e) * ks.k[32 + e][lane];
    }
    dkp += ks.sum[lane];
    float dklo, dkhi;
    prm_vjp(kp * dkp, klo, khi, ws, lane, dklo, dkhi);
    bf16* o = dkv + row * 2 * EMB;
    o[lane] = f2bf(dklo);
    o[32 + lane] = f2bf(dkhi);
    o[64 + lane] = f2bf(dvlo);
    o[96 + lane] = f2bf(dvhi);
    cs[0] += dklo;
    cs[1] += dkhi;
    cs[2] += dvlo;
    cs[3] += dvhi;
  }
  reduce_warps<4>(cs, red, colpart +
                  ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * EMB);
}

// ---------------------------------------------------------------------------
// LN2 and the MLP activation: rows of 64, independent of the image
// ---------------------------------------------------------------------------

// attn = v + proj (f32, in place over proj); h2 = bf16(LN2(bf16(attn)));
// attn_b = bf16(attn) when given.  One warp per row.
__global__ void ln2_kernel(const bf16* __restrict__ v, float* attn,
                           const float* __restrict__ g,
                           const float* __restrict__ b, int rows,
                           bf16* __restrict__ h2, bf16* __restrict__ attn_b) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t o = (size_t)row * EMB;
  const float alo = bf2f(v[o + lane]) + attn[o + lane];
  const float ahi = bf2f(v[o + 32 + lane]) + attn[o + 32 + lane];
  attn[o + lane] = alo;
  attn[o + 32 + lane] = ahi;
  const float xl = rnd(alo), xh = rnd(ahi);
  if (attn_b) {
    attn_b[o + lane] = f2bf(alo);
    attn_b[o + 32 + lane] = f2bf(ahi);
  }
  const float mean = warp_sum(xl + xh) / EMB;
  const float cl = xl - mean, chh = xh - mean;
  const float rstd = rsqrtf(warp_sum(cl * cl + chh * chh) / EMB + LN_EPS);
  h2[o + lane] = f2bf(cl * rstd * g[lane] + b[lane]);
  h2[o + 32 + lane] = f2bf(chh * rstd * g[32 + lane] + b[32 + lane]);
}

// From hh = h2 . W1 + b1 and da = dout . W2^T (f32): a = bf16(gelu(hh)),
// dhh = da * gelu'(hh) -> bf16; part[blockIdx.x] = the column sums of dhh
// over the CTA's TILE rows.  64 threads, one per column.
__global__ void act_bwd_kernel(const float* __restrict__ hh,
                               const float* __restrict__ da, int rows,
                               bf16* __restrict__ a, bf16* __restrict__ dhh,
                               float* __restrict__ part) {
  const int c = threadIdx.x;
  const int r1 = min(rows, (blockIdx.x + 1) * TILE);
  float s = 0.f;
  for (int r = blockIdx.x * TILE; r < r1; ++r) {
    const size_t off = (size_t)r * EMB + c;
    const float h = hh[off];
    const float phi = 0.5f * (1.f + erff(h * 0.70710678118654752f));
    const float pdf = expf(-0.5f * h * h) * 0.39894228040143268f;
    const float d = da[off] * (phi + h * pdf);
    a[off] = f2bf(h * phi);
    dhh[off] = f2bf(d);
    s += d;
  }
  part[(size_t)blockIdx.x * EMB + c] = s;
}

// LN2's VJP with the residual, one warp per row, a CTA per TILE rows:
// xhat, rstd recomputed from attn_b; dattn = do + (gd - mean(gd) - xhat *
// mean(gd * xhat)) * rstd, gd = dh2 * g -> bf16 into dattn and into
// dqv[:, emb:]; part[blockIdx.x] = the column sums of (dh2 * xhat, dh2,
// dattn, do), [4, emb].
__global__ void __launch_bounds__(WARPS * 32)
    ln2_bwd_kernel(const bf16* __restrict__ attn_b,
                   const float* __restrict__ dh2, const float* __restrict__ g,
                   const bf16* __restrict__ dout, int rows,
                   bf16* __restrict__ dattn, bf16* __restrict__ dqv,
                   float* __restrict__ part) {
  __shared__ Red red;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float cs[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cs[i] = 0.f;
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int row = blockIdx.x * TILE + warp * ROWS_PER_WARP + i;
    if (row >= rows) break;
    const size_t o = (size_t)row * EMB;
    float x[2], dh[2], gd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[h] = bf2f(attn_b[o + 32 * h + lane]);
      dh[h] = dh2[o + 32 * h + lane];
      gd[h] = dh[h] * g[32 * h + lane];
    }
    const float mean = warp_sum(x[0] + x[1]) / EMB;
    const float c0 = x[0] - mean, c1 = x[1] - mean;
    const float rstd = rsqrtf(warp_sum(c0 * c0 + c1 * c1) / EMB + LN_EPS);
    const float xh[2] = {c0 * rstd, c1 * rstd};
    const float m1 = warp_sum(gd[0] + gd[1]) / EMB;
    const float m2 = warp_sum(gd[0] * xh[0] + gd[1] * xh[1]) / EMB;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float d32 = bf2f(dout[o + 32 * h + lane]);
      const float da = d32 + (gd[h] - m1 - xh[h] * m2) * rstd;
      const bf16 db = f2bf(da);
      dattn[o + 32 * h + lane] = db;
      dqv[(size_t)row * 2 * EMB + EMB + 32 * h + lane] = db;
      cs[h] += dh[h] * xh[h];
      cs[2 + h] += dh[h];
      cs[4 + h] += da;
      cs[6 + h] += d32;
    }
  }
  reduce_warps<8>(cs, red, part + (size_t)blockIdx.x * 4 * EMB);
}

// ---------------------------------------------------------------------------
// reductions
// ---------------------------------------------------------------------------

// out[c] = sum_i part[i * stride + c] for c < cols, in index order; f32
// and / or bf16.
__global__ void reduce_cols_kernel(const float* __restrict__ part,
                                   int nparts, size_t stride, int cols,
                                   float* __restrict__ out32,
                                   bf16* __restrict__ out16) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float s = 0.f;
  for (int i = 0; i < nparts; ++i) s += part[i * stride + c];
  if (out32) out32[c] = s;
  if (out16) out16[c] = f2bf(s);
}

// The kqv gradient from its two halves ([rows, 2 emb] f32 each): columns
// k from kv[:, :emb], q from qv[:, :emb], v = qv[:, emb:] + kv[:, emb:]
// -> bf16 [rows, 3 emb], as performer.py:1004-1008 assembles it.
__global__ void assemble_kqv_kernel(const float* __restrict__ qv,
                                    const float* __restrict__ kv, int rows,
                                    bf16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * KQV) return;
  const int r = i / KQV, c = i % KQV;
  const size_t h = (size_t)r * 2 * EMB;
  float v;
  if (c < EMB)
    v = kv[h + c];
  else if (c < 2 * EMB)
    v = qv[h + c - EMB];
  else
    v = qv[h + c - EMB] + kv[h + c - EMB];
  out[i] = f2bf(v);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

#define CK(expr)                                  \
  do {                                            \
    const cudaError_t err_ = (expr);              \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// Carves the scratch of one call out of the caller's workspace, each
// buffer on a 256-byte boundary; with a null base it only counts bytes.
struct Carver {
  char* base;
  size_t off = 0;
  template <typename T>
  T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += (count * sizeof(T) + 255) & ~(size_t)255;
    return p;
  }
};

struct Dims {
  int b, n, dim, rows, ntiles, parts, splits;
  Dims(int b_, int n_, int dim_)
      : b(b_), n(n_), dim(dim_), rows(b_ * n_),
        ntiles((n_ + TILE - 1) / TILE), parts((b_ * n_ + TILE - 1) / TILE),
        splits((b_ * n_ + KCHUNK - 1) / KCHUNK) {}
};

struct FwdScratch {
  bf16 *xn, *v, *y, *h2, *a;
  float *kqv, *qp, *part, *attn;
  FwdScratch(Carver& c, const Dims& d) {
    const size_t r = d.rows;
    xn = c.take<bf16>(r * d.dim);
    kqv = c.take<float>(r * KQV);
    qp = c.take<float>(r * M);
    v = c.take<bf16>(r * EMB);
    part = c.take<float>((size_t)d.b * d.ntiles * PART);
    y = c.take<bf16>(r * EMB);
    attn = c.take<float>(r * EMB);
    h2 = c.take<bf16>(r * EMB);
    a = c.take<bf16>(r * EMB);
  }
};

struct BwdScratch {
  bf16 *xn, *y, *v, *attn_b, *h2, *a, *dhh, *dattn, *dqv, *dkv;
  float *kqv, *attn, *hh, *da, *dh2, *dy, *dxn, *part, *dkptv, *dkpsum,
      *colq, *colkv, *part_act, *part_ln2, *part_ln1, *part_w2, *part_w1,
      *part_wproj, *part_qv, *part_kv, *dwqv, *dwkv, *dbqv, *dbkv;
  BwdScratch(Carver& c, const Dims& d) {
    const size_t r = d.rows, t = (size_t)d.b * d.ntiles;
    xn = c.take<bf16>(r * d.dim);
    kqv = c.take<float>(r * KQV);
    y = c.take<bf16>(r * EMB);
    v = c.take<bf16>(r * EMB);
    attn = c.take<float>(r * EMB);
    attn_b = c.take<bf16>(r * EMB);
    h2 = c.take<bf16>(r * EMB);
    hh = c.take<float>(r * EMB);
    da = c.take<float>(r * EMB);
    a = c.take<bf16>(r * EMB);
    dhh = c.take<bf16>(r * EMB);
    dh2 = c.take<float>(r * EMB);
    dattn = c.take<bf16>(r * EMB);
    dy = c.take<float>(r * EMB);
    dqv = c.take<bf16>(r * 2 * EMB);
    dkv = c.take<bf16>(r * 2 * EMB);
    dxn = c.take<float>(r * d.dim);
    part = c.take<float>(t * PART);
    dkptv = c.take<float>((size_t)d.b * EMB * M);
    dkpsum = c.take<float>((size_t)d.b * M);
    colq = c.take<float>(t * EMB);
    colkv = c.take<float>(t * 2 * EMB);
    part_act = c.take<float>((size_t)d.parts * EMB);
    part_ln2 = c.take<float>((size_t)d.parts * 4 * EMB);
    part_ln1 = c.take<float>((size_t)d.parts * 4 * d.dim);
    part_w2 = c.take<float>((size_t)d.splits * EMB * EMB);
    part_w1 = c.take<float>((size_t)d.splits * EMB * EMB);
    part_wproj = c.take<float>((size_t)d.splits * EMB * EMB);
    part_qv = c.take<float>((size_t)d.splits * d.dim * 2 * EMB);
    part_kv = c.take<float>((size_t)d.splits * d.dim * 2 * EMB);
    dwqv = c.take<float>((size_t)d.dim * 2 * EMB);
    dwkv = c.take<float>((size_t)d.dim * 2 * EMB);
    dbqv = c.take<float>(2 * EMB);
    dbkv = c.take<float>(2 * EMB);
  }
};

// out32 = a . w (+ bias), f32; w stored [K][N], or [N][K] with B_NK
template <bool B_NK = false>
cudaError_t gemm_f32(const bf16* a, const bf16* w, const bf16* bias,
                     float* out32, int m, int n, int k, cudaStream_t s) {
  uvc::GemmArgs p = {};
  p.a = a;
  p.w = w;
  p.bias = bias;
  p.out32 = out32;
  p.M = m;
  p.N = n;
  p.K = k;
  return uvc::launch_gemm<uvc::EPI_F32, false, B_NK>(p, s);
}

// part[z] = a[rows of slice z]^T . b[rows of slice z]: a [K][m], b [K][n]
cudaError_t gemm_splitk(const bf16* a, const bf16* b, int m, int n, int k,
                        float* part, cudaStream_t s) {
  uvc::GemmArgs p = {};
  p.a = a;
  p.w = b;
  p.out32 = part;
  p.M = m;
  p.N = n;
  p.K = k;
  p.kchunk = KCHUNK;
  return uvc::launch_gemm<uvc::EPI_F32, true, false>(p, s);
}

cudaError_t reduce(const float* part, int nparts, size_t stride, int cols,
                   float* out32, bf16* out16, cudaStream_t s) {
  reduce_cols_kernel<<<(cols + 255) / 256, 256, 0, s>>>(part, nparts, stride,
                                                        cols, out32, out16);
  return cudaGetLastError();
}

struct Ops {
  const bf16* x;
  const float *g1, *b1;
  const bf16 *wkqv, *bkqv;
  const float *w, *fmask;
  const bf16 *wproj, *bproj;
  const float *g2, *b2;
  const bf16 *wfc1, *bfc1, *wfc2, *bfc2;
};

// LN1 and the kqv projection, the common front of both directions
int front(const Ops& o, const Dims& d, float fcount, bf16* xn, float* kqv,
          cudaStream_t s) {
  ln1_kernel<<<(d.rows + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      o.x, o.g1, o.b1, o.fmask, d.rows, d.dim, fcount, xn);
  CK(cudaGetLastError());
  CK(gemm_f32(xn, o.wkqv, o.bkqv, kqv, d.rows, KQV, d.dim, s));
  return 0;
}

int forward(const Ops& o, bf16* out, float* kptv, float* kpsum, void* ws,
            const Dims& d, float fcount, cudaStream_t s) {
  Carver c{static_cast<char*>(ws)};
  FwdScratch t(c, d);
  const int rows = d.rows;
  const dim3 tiles(d.ntiles, d.b);
  CK((cudaError_t)front(o, d, fcount, t.xn, t.kqv, s));
  sums_kernel<<<tiles, WARPS * 32, 0, s>>>(t.kqv, o.w, d.n, t.qp, t.v,
                                           t.part);
  CK(cudaGetLastError());
  reduce_tiles_kernel<<<dim3((PART + 255) / 256, d.b), 256, 0, s>>>(
      t.part, d.ntiles, kptv, kpsum);
  CK(cudaGetLastError());
  apply_kernel<<<tiles, WARPS * 32, 0, s>>>(t.qp, kptv, kpsum, d.n, t.y);
  CK(cudaGetLastError());
  CK(gemm_f32(t.y, o.wproj, o.bproj, t.attn, rows, EMB, EMB, s));
  ln2_kernel<<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
      t.v, t.attn, o.g2, o.b2, rows, t.h2, nullptr);
  CK(cudaGetLastError());
  uvc::GemmArgs p = {};
  p.a = t.h2;
  p.w = o.wfc1;
  p.bias = o.bfc1;
  p.out = t.a;
  p.M = rows;
  p.N = EMB;
  p.K = EMB;
  CK(uvc::launch_gemm<uvc::EPI_GELU_MASK>(p, s));
  p = {};
  p.a = t.a;
  p.w = o.wfc2;
  p.bias = o.bfc2;
  p.out = out;
  p.resid32 = t.attn;
  p.M = rows;
  p.N = EMB;
  p.K = EMB;
  CK(uvc::launch_gemm<uvc::EPI_RESID32>(p, s));
  return 0;
}

struct Grads {
  bf16* dx;
  float *dg1, *db1;
  bf16 *dwkqv, *dbkqv, *dwproj, *dbproj;
  float *dg2, *db2;
  bf16 *dwfc1, *dbfc1, *dwfc2, *dbfc2;
};

int backward(const Ops& o, const float* kptv, const float* kpsum,
             const bf16* dout, const bf16* wqv, const bf16* wkv,
             const Grads& g, void* ws, const Dims& d, float fcount,
             cudaStream_t s) {
  Carver c{static_cast<char*>(ws)};
  BwdScratch t(c, d);
  const int rows = d.rows, dim = d.dim;
  const dim3 tiles(d.ntiles, d.b);
  const dim3 warp_rows((rows + WARPS - 1) / WARPS);
  // pass 1: recompute the forward
  CK((cudaError_t)front(o, d, fcount, t.xn, t.kqv, s));
  bwd_front_kernel<<<tiles, WARPS * 32, 0, s>>>(t.kqv, o.w, kptv, kpsum, d.n,
                                                t.y, t.v);
  CK(cudaGetLastError());
  CK(gemm_f32(t.y, o.wproj, o.bproj, t.attn, rows, EMB, EMB, s));
  ln2_kernel<<<warp_rows, WARPS * 32, 0, s>>>(t.v, t.attn, o.g2, o.b2, rows,
                                              t.h2, t.attn_b);
  CK(cudaGetLastError());
  CK(gemm_f32(t.h2, o.wfc1, o.bfc1, t.hh, rows, EMB, EMB, s));
  // the MLP, LN2 and proj gradients
  CK(gemm_f32<true>(dout, o.wfc2, nullptr, t.da, rows, EMB, EMB, s));
  act_bwd_kernel<<<d.parts, EMB, 0, s>>>(t.hh, t.da, rows, t.a, t.dhh,
                                         t.part_act);
  CK(cudaGetLastError());
  CK(gemm_splitk(t.a, dout, EMB, EMB, rows, t.part_w2, s));
  CK(gemm_splitk(t.h2, t.dhh, EMB, EMB, rows, t.part_w1, s));
  CK(gemm_f32<true>(t.dhh, o.wfc1, nullptr, t.dh2, rows, EMB, EMB, s));
  ln2_bwd_kernel<<<d.parts, WARPS * 32, 0, s>>>(t.attn_b, t.dh2, o.g2, dout,
                                                rows, t.dattn, t.dqv,
                                                t.part_ln2);
  CK(cudaGetLastError());
  CK(gemm_splitk(t.y, t.dattn, EMB, EMB, rows, t.part_wproj, s));
  CK(gemm_f32<true>(t.dattn, o.wproj, nullptr, t.dy, rows, EMB, EMB, s));
  // the q path and the global cotangents
  qpath_kernel<<<tiles, WARPS * 32, 0, s>>>(t.kqv, o.w, kptv, kpsum, t.dy,
                                            d.n, t.dqv, t.part, t.colq);
  CK(cudaGetLastError());
  reduce_tiles_kernel<<<dim3((PART + 255) / 256, d.b), 256, 0, s>>>(
      t.part, d.ntiles, t.dkptv, t.dkpsum);
  CK(cudaGetLastError());
  // dx's first half, through the q|v columns
  CK(gemm_f32<true>(t.dqv, wqv, nullptr, t.dxn, rows, dim, 2 * EMB, s));
  ln1_bwd_kernel<<<d.parts, WARPS * 32, 0, s>>>(o.x, o.g1, o.fmask, t.dxn,
                                                nullptr, rows, dim, fcount,
                                                g.dx, t.part_ln1);
  CK(cudaGetLastError());
  CK(gemm_splitk(t.xn, t.dqv, dim, 2 * EMB, rows, t.part_qv, s));
  // pass 2: the k / v path, dx's second half added to the first
  kvpath_kernel<<<tiles, WARPS * 32, 0, s>>>(t.kqv, o.w, t.dkptv, t.dkpsum,
                                             d.n, t.dkv, t.colkv);
  CK(cudaGetLastError());
  CK(gemm_f32<true>(t.dkv, wkv, nullptr, t.dxn, rows, dim, 2 * EMB, s));
  ln1_bwd_kernel<<<d.parts, WARPS * 32, 0, s>>>(
      o.x, o.g1, o.fmask, t.dxn, g.dx, rows, dim, fcount, g.dx,
      t.part_ln1 + (size_t)d.parts * 2 * dim);
  CK(cudaGetLastError());
  CK(gemm_splitk(t.xn, t.dkv, dim, 2 * EMB, rows, t.part_kv, s));
  // every sum over the rows, in index order
  const int ww = EMB * EMB, wkqv = dim * 2 * EMB, nt = d.b * d.ntiles;
  CK(reduce(t.part_w2, d.splits, ww, ww, nullptr, g.dwfc2, s));
  CK(reduce(t.part_w1, d.splits, ww, ww, nullptr, g.dwfc1, s));
  CK(reduce(t.part_wproj, d.splits, ww, ww, nullptr, g.dwproj, s));
  CK(reduce(t.part_qv, d.splits, wkqv, wkqv, t.dwqv, nullptr, s));
  CK(reduce(t.part_kv, d.splits, wkqv, wkqv, t.dwkv, nullptr, s));
  CK(reduce(t.part_act, d.parts, EMB, EMB, nullptr, g.dbfc1, s));
  CK(reduce(t.part_ln2, d.parts, 4 * EMB, EMB, g.dg2, nullptr, s));
  CK(reduce(t.part_ln2 + EMB, d.parts, 4 * EMB, EMB, g.db2, nullptr, s));
  CK(reduce(t.part_ln2 + 2 * EMB, d.parts, 4 * EMB, EMB, t.dbqv + EMB,
            g.dbproj, s));
  CK(reduce(t.part_ln2 + 3 * EMB, d.parts, 4 * EMB, EMB, nullptr, g.dbfc2,
            s));
  CK(reduce(t.colq, nt, EMB, EMB, t.dbqv, nullptr, s));
  CK(reduce(t.colkv, nt, 2 * EMB, 2 * EMB, t.dbkv, nullptr, s));
  CK(reduce(t.part_ln1, 2 * d.parts, 2 * dim, dim, g.dg1, nullptr, s));
  CK(reduce(t.part_ln1 + dim, 2 * d.parts, 2 * dim, dim, g.db1, nullptr, s));
  assemble_kqv_kernel<<<(dim * KQV + 255) / 256, 256, 0, s>>>(t.dwqv, t.dwkv,
                                                              dim, g.dwkqv);
  CK(cudaGetLastError());
  assemble_kqv_kernel<<<1, 256, 0, s>>>(t.dbqv, t.dbkv, 1, g.dbkqv);
  CK(cudaGetLastError());
  return 0;
}

Ops ops(const void* x, const void* g1, const void* b1, const void* wkqv,
        const void* bkqv, const void* w, const void* fmask, const void* wproj,
        const void* bproj, const void* g2, const void* b2, const void* wfc1,
        const void* bfc1, const void* wfc2, const void* bfc2) {
  return Ops{static_cast<const bf16*>(x),     static_cast<const float*>(g1),
             static_cast<const float*>(b1),   static_cast<const bf16*>(wkqv),
             static_cast<const bf16*>(bkqv),  static_cast<const float*>(w),
             static_cast<const float*>(fmask), static_cast<const bf16*>(wproj),
             static_cast<const bf16*>(bproj), static_cast<const float*>(g2),
             static_cast<const float*>(b2),   static_cast<const bf16*>(wfc1),
             static_cast<const bf16*>(bfc1),  static_cast<const bf16*>(wfc2),
             static_cast<const bf16*>(bfc2)};
}

}  // namespace

// The workspace of one call, in blocks of 256 bytes: the caller allocates
// that many bytes on the card and passes them as ws.
extern "C" int uvc_performer_workspace(int b, int n, int dim, int backward) {
  Carver c{nullptr};
  const Dims d(b, n, dim);
  if (backward) {
    BwdScratch t(c, d);
  } else {
    FwdScratch t(c, d);
  }
  return (int)(c.off / 256);
}

// Both return 0 or the first CUDA error code.  All buffers are device
// pointers: the operands x [B, N, dim] bf16; g1, b1, fmask [dim] f32;
// wkqv [dim, 192], bkqv [192], wproj / wfc1 / wfc2 [64, 64] (stored (in,
// out)), bproj / bfc1 / bfc2 [64] bf16; w [32, 64] f32; g2, b2 [64] f32.
// Forward outputs: out [B, N, 64] bf16, kptv [B, 64, 32] and kpsum [B, 32]
// f32.  The backward takes kptv, kpsum, dout [B, N, 64] bf16 and wqv = wkqv
// [:, 64:], wkv = wkqv[:, (0:64, 128:192)] ([dim, 128] bf16 each), and
// writes the gradients of the operands but w and fmask, each in its
// operand's type.
extern "C" int uvc_performer(const void* x, const void* g1, const void* b1,
                             const void* wkqv, const void* bkqv, const void* w,
                             const void* fmask, const void* wproj,
                             const void* bproj, const void* g2, const void* b2,
                             const void* wfc1, const void* bfc1,
                             const void* wfc2, const void* bfc2, void* out,
                             void* kptv, void* kpsum, void* ws, int b, int n,
                             int dim, float fcount, void* stream) {
  return forward(ops(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2,
                     wfc1, bfc1, wfc2, bfc2),
                 static_cast<bf16*>(out), static_cast<float*>(kptv),
                 static_cast<float*>(kpsum), ws, Dims(b, n, dim), fcount,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int uvc_performer_bwd(
    const void* x, const void* g1, const void* b1, const void* wkqv,
    const void* bkqv, const void* w, const void* fmask, const void* wproj,
    const void* bproj, const void* g2, const void* b2, const void* wfc1,
    const void* bfc1, const void* wfc2, const void* bfc2, const void* kptv,
    const void* kpsum, const void* dout, const void* wqv, const void* wkv,
    void* dx, void* dg1, void* db1, void* dwkqv, void* dbkqv, void* dwproj,
    void* dbproj, void* dg2, void* db2, void* dwfc1, void* dbfc1,
    void* dwfc2, void* dbfc2, void* ws, int b, int n, int dim, float fcount,
    void* stream) {
  const Grads g = {static_cast<bf16*>(dx),     static_cast<float*>(dg1),
                   static_cast<float*>(db1),   static_cast<bf16*>(dwkqv),
                   static_cast<bf16*>(dbkqv),  static_cast<bf16*>(dwproj),
                   static_cast<bf16*>(dbproj), static_cast<float*>(dg2),
                   static_cast<float*>(db2),   static_cast<bf16*>(dwfc1),
                   static_cast<bf16*>(dbfc1),  static_cast<bf16*>(dwfc2),
                   static_cast<bf16*>(dbfc2)};
  return backward(ops(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2,
                      wfc1, bfc1, wfc2, bfc2),
                  static_cast<const float*>(kptv),
                  static_cast<const float*>(kpsum),
                  static_cast<const bf16*>(dout),
                  static_cast<const bf16*>(wqv), static_cast<const bf16*>(wkv),
                  g, ws, Dims(b, n, dim), fcount,
                  static_cast<cudaStream_t>(stream));
}
