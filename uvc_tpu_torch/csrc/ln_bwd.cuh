// The row and column sums of the sublayer backwards A2 (attention.cu), A4
// and A6 (mlp.cu) and A7's backward: the LayerNorm backward with the
// residual, whose CTAs also sum the sublayer's output cotangent do over
// their rows (dbproj for A2, db2 for A4 and A6), and the column sums of a
// bf16 matrix (A2's and A7's dbqkv, A7's dbproj).  Every sum over the B*N
// rows is taken in a fixed order: per-CTA partials over a fixed block of
// rows, then launch_reduce adds them in index order.  No float atomics,
// so two launches give the same bits.
//
// What bounds them on the H100: bytes.  The LayerNorm backward reads x
// (bf16), d(LN output) (f32) and do (bf16) once and writes dx once: 10
// bytes an element (14 and 4 more for the blend's xin and dxin), ~48 MB
// at DeiT-Small's train shape (B = 64, N = 197, dm = 384; ~15 us at 3.35
// TB/s) and ~84 MB at ViT-H/14's (B = 32, N = 257, dm = 1280; ~25 us).
//
// Design of the LayerNorm backward: a warp a row, the row in registers
// (CH chunks of 8 columns a lane: dm up to 256 CH, LNB_MAX_DM = 1280),
// x, d(LN output), do (and xin) loaded at once; a CTA of `warps` warps
// takes `rows_per_cta` consecutive rows (ln_bwd_split: about twice as
// many CTAs as the card has SMs, so the grid fills it at 2056 rows too,
// 4 to 32 rows a CTA), each warp every warps-th of them,
// adding its rows' dy * xhat, dy and do into its own slot of shared
// memory (lane-interleaved, so a warp's accesses hit 32 banks); then the
// CTA adds its warps' slots in warp order into one partial row
// [dy * xhat | dy | do | do . x, do . xin].
// Design of the column sums: a thread 8 columns (16-byte loads), a warp
// 256 columns, the 8 warps of a CTA every 8th row of the CTA's block of
// rows, four rows in flight, then the warps' sums added in warp order;
// the block of rows sized so that the grid covers the SMs twice.
#pragma once

#include <algorithm>

#include "hopper.cuh"

namespace uvc {

// CTAs the row and column sums aim for: twice the H100's 132 SMs
constexpr int SUMS_TARGET_CTAS = 264;

// ---------------------------------------------------------------------------
// LayerNorm backward with the residual, in f32 (the LN VJP of
// _layer_ln_bwd_kernel / _mlp_ln_bwd_kernel / _mlp_ln_blend_bwd_kernel):
//   xhat, inv recomputed from x;  dg = dy * gamma
//   dx = bf16(inv * (dg - mean(dg) - xhat * mean(dg * xhat)) + c * resid)
// with c = d[1] when d is given (the blend), else 1.  Per CTA one partial
// row of 3 dm + 2 floats: the column sums of dy * xhat (dgamma), dy
// (dbeta) and resid (the output bias's gradient) over its rows, and with
// xin (the blend) the sums of resid * x and resid * xin (terms of dd1 and
// dd0; zeros without xin); with xin also dxin = bf16(d[0] * resid).  dm is
// a multiple of 8 and at most LNB_MAX_DM.
// ---------------------------------------------------------------------------

constexpr int LNB_MAX_DM = 1280;
constexpr int LNB_MIN_ROWS = 4, LNB_MAX_ROWS = 32;   // rows a CTA
constexpr int LNB_MAX_WARPS = 8;

struct LnBwdArgs {
  const bf16* x;        // [rows, dm]
  const float* gamma;   // [dm]
  const float* dy;      // [rows, dm] f32: d(LN output)
  const bf16* resid;    // [rows, dm]: the sublayer's output cotangent
  const float* d;       // [2] or null
  const bf16* xin;      // [rows, dm] or null
  bf16* dx;             // [rows, dm]
  bf16* dxin;           // [rows, dm] (with xin)
  float* part;          // [CTAs, 3 dm + 2]
  int rows, dm;
  float eps;
};

// The partition of the rows: rows a CTA (rows / SUMS_TARGET_CTAS, at
// least LNB_MIN_ROWS, so that the partials' in-order sum stays short, and
// at most LNB_MAX_ROWS), warps a CTA (at most LNB_MAX_WARPS
// and 16 / CH, so that a CTA's slots take at most ~48 KB of shared memory
// and several CTAs fit an SM) and the CTAs.  ops/attention.py's
// _ln_bwd_split mirrors it to size the partials.
struct LnBwdSplit {
  int rows_per_cta, warps, ctas;
};

static inline int ln_bwd_chunks(int dm) { return (dm + 255) / 256; }

static inline LnBwdSplit ln_bwd_split(int rows, int dm) {
  LnBwdSplit s;
  s.rows_per_cta =
      std::max(LNB_MIN_ROWS,
               std::min(LNB_MAX_ROWS, rows / SUMS_TARGET_CTAS));
  s.warps = std::max(1, std::min({s.rows_per_cta, LNB_MAX_WARPS,
                                  16 / ln_bwd_chunks(dm)}));
  s.ctas = (rows + s.rows_per_cta - 1) / s.rows_per_cta;
  return s;
}

// floats of a CTA's partial row
static inline int ln_bwd_part_cols(int dm) { return 3 * dm + 2; }

// CH chunks of 8 columns a lane; XIN: the blend's xin and dxin.
template <int CH, bool XIN>
static __global__ void __launch_bounds__(LNB_MAX_WARPS * 32)
    ln_bwd_kernel(LnBwdArgs p, int rows_per_cta) {
  // slot of warp w: three planes of CH * 256 floats, element j of lane l's
  // chunk ch at ch * 256 + 32 j + l (column ch * 256 + 8 l + j)
  constexpr int PLANE = CH * 256;
  extern __shared__ float red[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dm = p.dm;
  const float* __restrict__ gamma = p.gamma;
  float* slot = red + (size_t)warp * 3 * PLANE;
  float* dots = red + (size_t)warps * 3 * PLANE;   // [warps][2]
#pragma unroll
  for (int i = 0; i < 3 * CH * 8; ++i) slot[i * 32 + lane] = 0.f;
  const float c_res = p.d ? p.d[1] : 1.f;
  const float d0 = p.d ? p.d[0] : 0.f;
  const int r0 = blockIdx.x * rows_per_cta;
  const int r1 = min(p.rows, r0 + rows_per_cta);
  float sx = 0.f, sxin = 0.f;

  for (int row = r0 + warp; row < r1; row += warps) {
    const size_t base = (size_t)row * dm;
    uint4 xr[CH], rr[CH], ir[XIN ? CH : 1];
    float4 yr[CH][2];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = lane * 8 + ch * 256;
      if (c < dm) {
        xr[ch] = *reinterpret_cast<const uint4*>(p.x + base + c);
        yr[ch][0] = *reinterpret_cast<const float4*>(p.dy + base + c);
        yr[ch][1] = *reinterpret_cast<const float4*>(p.dy + base + c + 4);
        rr[ch] = *reinterpret_cast<const uint4*>(p.resid + base + c);
        if constexpr (XIN)
          ir[ch] = *reinterpret_cast<const uint4*>(p.xin + base + c);
      }
    }
    float xh[CH][8];
    float s = 0.f;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
      if (lane * 8 + ch * 256 < dm) {
        const bf16* e = reinterpret_cast<const bf16*>(&xr[ch]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xh[ch][j] = bf2f(e[j]);
          s += xh[ch][j];
        }
      }
    const float mean = warp_sum(s) / dm;
    float q = 0.f;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch)
      if (lane * 8 + ch * 256 < dm)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dv = xh[ch][j] - mean;
          q += dv * dv;
        }
    const float inv = rsqrtf(warp_sum(q) / dm + p.eps);
    // xh becomes xhat; the slot takes dy * xhat and dy
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = lane * 8 + ch * 256;
      if (c < dm) {
        const float yv[8] = {yr[ch][0].x, yr[ch][0].y, yr[ch][0].z,
                             yr[ch][0].w, yr[ch][1].x, yr[ch][1].y,
                             yr[ch][1].z, yr[ch][1].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = (xh[ch][j] - mean) * inv;
          xh[ch][j] = xv;
          const float dg = yv[j] * __ldg(gamma + c + j);
          s1 += dg;
          s2 += dg * xv;
          slot[ch * 256 + j * 32 + lane] += yv[j] * xv;
          slot[PLANE + ch * 256 + j * 32 + lane] += yv[j];
        }
      }
    }
    const float m1 = warp_sum(s1) / dm;
    const float m2 = warp_sum(s2) / dm;
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int c = lane * 8 + ch * 256;
      if (c < dm) {
        const float yv[8] = {yr[ch][0].x, yr[ch][0].y, yr[ch][0].z,
                             yr[ch][0].w, yr[ch][1].x, yr[ch][1].y,
                             yr[ch][1].z, yr[ch][1].w};
        const bf16* re = reinterpret_cast<const bf16*>(&rr[ch]);
        uint4 o;
        bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float r = bf2f(re[j]);
          const float dz =
              (yv[j] * __ldg(gamma + c + j) - m1 - xh[ch][j] * m2) * inv;
          oe[j] = f2bf(dz + c_res * r);
          slot[2 * PLANE + ch * 256 + j * 32 + lane] += r;
        }
        *reinterpret_cast<uint4*>(p.dx + base + c) = o;
        if constexpr (XIN) {
          const bf16* ie = reinterpret_cast<const bf16*>(&ir[ch]);
          const bf16* xe = reinterpret_cast<const bf16*>(&xr[ch]);
          uint4 di;
          bf16* de = reinterpret_cast<bf16*>(&di);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float r = bf2f(re[j]);
            sx += r * bf2f(xe[j]);
            sxin += r * bf2f(ie[j]);
            de[j] = f2bf(d0 * r);
          }
          *reinterpret_cast<uint4*>(p.dxin + base + c) = di;
        }
      }
    }
  }
  sx = warp_sum(sx);
  sxin = warp_sum(sxin);
  if (lane == 0) {
    dots[2 * warp] = sx;
    dots[2 * warp + 1] = sxin;
  }
  __syncthreads();

  // the warps' slots added in warp order: partial row [3 dm + 2], written
  // in column order
  float* out = p.part + (size_t)blockIdx.x * (3 * dm + 2);
  for (int i = threadIdx.x; i < 3 * dm; i += blockDim.x) {
    const int plane = i / dm, col = i % dm;
    const int k = plane * PLANE + (col / 256) * 256 + (col % 8) * 32 +
                  (col % 256) / 8;
    float v = red[k];
    for (int w = 1; w < warps; ++w) v += red[(size_t)w * 3 * PLANE + k];
    out[i] = v;
  }
  if (threadIdx.x < 2) {
    float v = dots[threadIdx.x];
    for (int w = 1; w < warps; ++w) v += dots[2 * w + threadIdx.x];
    out[3 * dm + threadIdx.x] = v;
  }
}

template <int CH>
static cudaError_t run_ln_bwd(const LnBwdArgs& p, const LnBwdSplit& s,
                              cudaStream_t stream) {
  const size_t smem = ((size_t)s.warps * 3 * CH * 256 + 2 * s.warps) * 4;
  const size_t most =
      ((size_t)LNB_MAX_WARPS * 3 * CH * 256 + 2 * LNB_MAX_WARPS) * 4;
  cudaError_t err;
  if (p.xin) {
    err = smem_once<ln_bwd_kernel<CH, true>>(most);
    if (err == cudaSuccess)
      ln_bwd_kernel<CH, true><<<s.ctas, s.warps * 32, smem, stream>>>(
          p, s.rows_per_cta);
  } else {
    err = smem_once<ln_bwd_kernel<CH, false>>(most);
    if (err == cudaSuccess)
      ln_bwd_kernel<CH, false><<<s.ctas, s.warps * 32, smem, stream>>>(
          p, s.rows_per_cta);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The LayerNorm backward's partials [CTAs, 3 dm + 2] into p.part, then
// their in-order sum into sums [3 dm + 2]:
//   sums = [dgamma | dbeta | colsum(resid) | resid . x, resid . xin].
static cudaError_t launch_ln_bwd(const LnBwdArgs& p, float* sums,
                                 cudaStream_t stream) {
  const LnBwdSplit s = ln_bwd_split(p.rows, p.dm);
  cudaError_t err;
  switch (ln_bwd_chunks(p.dm)) {
    case 1: err = run_ln_bwd<1>(p, s, stream); break;
    case 2: err = run_ln_bwd<2>(p, s, stream); break;
    case 3: err = run_ln_bwd<3>(p, s, stream); break;
    case 4: err = run_ln_bwd<4>(p, s, stream); break;
    case 5: err = run_ln_bwd<5>(p, s, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_reduce(p.part, s.ctas, ln_bwd_part_cols(p.dm), nullptr, sums,
                       nullptr, stream);
}

// From the LayerNorm backward's sums: dgamma and dbeta (f32), the output
// bias's gradient dbias = bf16(scale * colsum(resid)) (scale = d[1] when
// d is given, else 1); with dd (the blend, one CTA, a fixed order):
// dd0 = resid . xin, dd1 = act + resid . x + colsum(resid) . bias, act the
// hidden layer's term sum(dam0 * am) from its nact partials (thread t
// adds partials t, t + 256, ... in order, then a tree over the threads).
static __global__ void __launch_bounds__(256)
    ln_bwd_finish_kernel(const float* __restrict__ sums, int dm,
                         const float* d, float* __restrict__ dg,
                         float* __restrict__ db, bf16* __restrict__ dbias,
                         const float* __restrict__ act, int nact,
                         const bf16* __restrict__ bias,
                         float* __restrict__ dd) {
  __shared__ float red[2][256];
  const int t = threadIdx.x;
  const float scale = d ? d[1] : 1.f;
  float v = 0.f, a = 0.f;
  for (int c = t; c < dm; c += 256) {
    const float cs = sums[2 * dm + c];
    dg[c] = sums[c];
    db[c] = sums[dm + c];
    dbias[c] = f2bf(scale * cs);
    if (dd) v += cs * bf2f(bias[c]);
  }
  if (dd == nullptr) return;
  for (int i = t; i < nact; i += 256) a += act[i];
  red[0][t] = v;
  red[1][t] = a;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (t < w) {
      red[0][t] += red[0][t + w];
      red[1][t] += red[1][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    dd[0] = sums[3 * dm + 1];
    dd[1] = red[1][0] + sums[3 * dm] + red[0][0];
  }
}

static cudaError_t launch_ln_bwd_finish(const float* sums, int dm,
                                        const float* d, float* dg, float* db,
                                        bf16* dbias, const float* act,
                                        int nact, const bf16* bias,
                                        float* dd, cudaStream_t stream) {
  ln_bwd_finish_kernel<<<1, 256, 0, stream>>>(sums, dm, d, dg, db, dbias, act,
                                              nact, bias, dd);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Column sums of a bf16 [rows, cols] (cols a multiple of 8):
// part[y, c] = sum of a[r, c] over the rows of block y.
// ---------------------------------------------------------------------------

constexpr int CS_WARPS = 8;
constexpr int CS_COLS = 256;   // columns a CTA: 8 a lane

// Rows of a block: enough blocks that the grid covers SUMS_TARGET_CTAS
// CTAs, a multiple of CS_WARPS and at least CS_WARPS.  ops/attention.py's
// _colsum_split mirrors it to size the partials.
static inline int colsum_rows(int rows, int cols) {
  const long long cb = (cols + CS_COLS - 1) / CS_COLS;
  const long long r = (long long)rows * cb / SUMS_TARGET_CTAS;
  return (int)std::max<long long>(CS_WARPS, r / CS_WARPS * CS_WARPS);
}

static inline int colsum_parts(int rows, int cols) {
  const int r = colsum_rows(rows, cols);
  return (rows + r - 1) / r;
}

static __global__ void __launch_bounds__(CS_WARPS * 32)
    colsum_kernel(const bf16* __restrict__ a, int rows, int cols, int block,
                  float* __restrict__ part) {
  // warp w's sums, element j of lane l at 32 j + l (column 8 l + j)
  __shared__ float red[CS_WARPS][CS_COLS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * CS_COLS + lane * 8;
  const int r0 = blockIdx.y * block;
  const int r1 = min(rows, r0 + block);
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
  if (c < cols) {
    const bf16* col = a + c;
    int r = r0 + warp;
    // four rows in flight, added in row order
    for (; r + 3 * CS_WARPS < r1; r += 4 * CS_WARPS) {
      uint4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = *reinterpret_cast<const uint4*>(
            col + (size_t)(r + k * CS_WARPS) * cols);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += bf2f(e[j]);
      }
    }
    for (; r < r1; r += CS_WARPS) {
      const uint4 v = *reinterpret_cast<const uint4*>(col + (size_t)r * cols);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += bf2f(e[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[warp][j * 32 + lane] = acc[j];
  __syncthreads();
  const int k = threadIdx.x;
  const int col = blockIdx.x * CS_COLS + (k % 32) * 8 + k / 32;
  if (col >= cols) return;
  float v = red[0][k];
#pragma unroll
  for (int w = 1; w < CS_WARPS; ++w) v += red[w][k];
  part[(size_t)blockIdx.y * cols + col] = v;
}

// out = scale * sum over the rows of a (scale = d[1] when d is given):
// the partials into part [colsum_parts, cols], then their in-order sum
static cudaError_t column_sum(const bf16* a, int rows, int cols, float* part,
                              const float* d, float* out32, bf16* out16,
                              cudaStream_t stream) {
  const int block = colsum_rows(rows, cols);
  const dim3 grid((cols + CS_COLS - 1) / CS_COLS, (rows + block - 1) / block);
  colsum_kernel<<<grid, CS_WARPS * 32, 0, stream>>>(a, rows, cols, block,
                                                    part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(part, (int)grid.y, cols, d, out32, out16, stream);
}

}  // namespace uvc
