// The token-performer stage of the T2T stem, forward (uvc_performer) and
// backward (uvc_performer_bwd).
//
// Replaces uvc_tpu/ops/performer.py::_fwd_merged_kernel and
// _bwd_merged_kernel (A10) and the split pair _sums_kernel +
// _apply_kernel / _bwd1_kernel + _bwd2_kernel (A11).  The two Pallas forms
// compute one function and differ only in how the TPU's VMEM tiles it;
// this file ports that function once.  The global sums over an image's
// tokens (kptv, kpsum forward; dkptv, dkpsum backward) close one kernel
// before the next one reads them, as blocks run in no order.
//
// Shapes: x [B, N, dim] bf16 in an expanded feature layout with fcount
// live slots (fmask), emb = 64, m = 32 random features, dim a multiple of
// 8 up to 1024, any N.  Numerics follow the Pallas bodies: LayerNorms, the
// random features prm(t) = exp(t w^T - |t|^2 / 2) / sqrt(m) (exact f32 on
// the CUDA cores), the normaliser and the global sums in f32; bf16 matmul
// inputs with f32 accumulation; bf16 roundings where the Pallas bodies
// cast.  GELU uses the exact erff.
//
// What bounds it on the H100: at T2T-ViT-14's stage 1 (B = 64, N = 3136,
// dim = 192 with 147 live slots) the forward moves ~103 MB of inputs and
// outputs (x 77 MB, out 26 MB) against ~23 GFLOP, so memory bounds it
// (~31 us at 3.35 TB/s); the backward's ~69 GFLOP with the recompute
// bound it by operations (~70 us at 989 TFLOP/s).
//
// Design: per-tile kernels of one warpgroup (128 threads) over 64-token
// tiles of one image, each CTA walking a contiguous run of an image's
// tiles (ops/performer.py::_tile_split), two CTAs an SM (the apply
// kernel four).  Every product runs on wgmma; the intermediates of a tile
// stay in registers (the accumulator layout: a thread holds rows g and
// g + 8 of its warp's 16, columns 8 j + 2 t (+ 1)), where one product's
// output is the next one's A operand.  x and Wkqv stream through a TMA
// ring in 64-column chunks (x [64 rows][64 cols], Wkqv's rows of the chunk
// as [64][64] boxes of k, q or v; the 128-byte swizzle), so the shared
// memory does not grow with dim: a pass takes LN1's statistics (Chan's
// combination of each chunk's; a stage's boxes all x chunks), the next
// builds the A operand bf16(LN1(x)) from the x chunk in registers for the
// kqv product.  The random features run on the CUDA cores in exact f32: a
// thread's 16 columns of its two rows against w (shared memory, four
// 16-byte loads a feature), the quad's partial dots added by a
// reduce-scatter that leaves each thread its 8 features in the layout the
// next product takes.  Sums over rows: per-tile products and
// reduce-scatters over a warp's rows, per-CTA (dLN1: per-tile) partials,
// and in-order sums of the partials; no float atomics, so two launches
// agree bit for bit.  The kernels are latency-bound (one or two
// warpgroups an SM, each step of a tile waiting on the last), so their
// time is that of their dependent steps, not of their bytes.
//   forward, two launches --
//     1. fwd_sums_kernel: LN1 and kqv; kp = bf16(prm(k)), qp = prm(q)
//        (written, f32), v = bf16(v) (written); the CTA's partial kptv =
//        v^T kp (wgmma) and kpsum.
//     2. fwd_apply_kernel: each CTA sums its image's partials in CTA
//        order (the first CTA of an image writes kptv and kpsum), then a
//        tile's y = bf16(qp) bf16(kptv)^T / (d + 1e-8), proj with the v
//        residual, LN2 (a row's statistics from its quad), fc1 with GELU,
//        fc2 with the residual: five products with the weights resident.
//   backward, shaped like _bwd_merged_kernel, eight launches --
//     1. bwd_q_kernel: the front (q|v), the forward's recompute, the MLP,
//        LN2 and proj backward and the q path; the tile's dq | dattn and
//        xn to the dWkqv product's operands, y | h2 | a | dhh to the
//        64 x 64 weight gradients'; dkptv / dkpsum and the column sums into
//        per-CTA partials; each row's LN1 (mean, rstd) to rstat.
//     2. bwd_kv_kernel: the image's dkptv / dkpsum summed in CTA order;
//        LN1's statistics from rstat; the front (k|v), dv, dk; dk | dv to
//        the dWkqv operand; a pass over the chunks for both halves of dxn
//        (dxn1 = bf16(dq | dattn) . Wqv^T, dxn2 = bf16(dk | dv) . Wkv^T):
//        the row sums of LN1's VJP of each, dLN1's column sums; with dx,
//        one more pass, dx = bf16(bf16(dx1) + bf16(dx2)) as the Pallas
//        forms round them.
//     3-6. dWkqv = xn^T [dk | dv | dq | dattn], dWfc2 = a^T do, dWfc1 =
//        h2^T dhh, dWproj = bf16(y)^T dattn on gemm_wg.cuh, split over the
//        B*N rows; 7. the dWkqv partials added in index order and
//        assembled from the two halves as at performer.py:1004-1008; 8.
//        every other partial added in index order.
//   With no dx asked for (the stem's first stage) the dx pass is left
//   out; every other gradient keeps its bits.
#include "gemm_wg.cuh"

using uvc::bf16;
using uvc::bf2f;
using uvc::f2bf;
using uvc::fence_acc;
using uvc::fence_proxy_async;
using uvc::gmma_desc128;
using uvc::mbar_expect_tx;
using uvc::mbar_init;
using uvc::mbar_wait;
using uvc::pack_f32;
using uvc::smem_1k;
using uvc::tma_load_2d;
using uvc::tma_load_3d;
using uvc::wg_commit;
using uvc::wg_fence;
using uvc::wg_wait;

namespace uvc {
namespace performer {

constexpr int EMB = 64;              // token dim
constexpr int M = 32;                // random features
constexpr int KQV = 3 * EMB;
constexpr int TILE = 64;             // tokens (rows) of a tile
constexpr int THREADS = 128;         // one warpgroup
constexpr int BOX = 64 * 64 * 2;     // a [64][64] bf16 tile, 8 KB
constexpr int PART = EMB * M + M;    // a CTA's [emb, m] + [m] partial
constexpr int WW = EMB * EMB;
// bwd_q_kernel's partial row: the column sums of do, dhh, dh2 * xhat2,
// dh2, dattn and dq; bwd_kv_kernel's: those of dk and dv.  dLN1's column
// sums go to a [2][dim] row a tile.
constexpr int Q_SUMS = 6 * EMB;
constexpr int KV_SUMS = 2 * EMB;
constexpr int WP_BYTES = M * EMB * 4;  // w in shared memory
constexpr float LN_EPS = 1e-5f;
constexpr float D_EPS = 1e-8f;
constexpr float SQRT_M = 5.65685424949238f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float rnd(float v) { return bf2f(f2bf(v)); }
__device__ __forceinline__ float lo_f(uint32_t p) {
  return __uint_as_float(p << 16);
}
__device__ __forceinline__ float hi_f(uint32_t p) {
  return __uint_as_float(p & 0xffff0000u);
}

// byte offset of element (r, c) of a [rows][64] bf16 tile in the 128-byte
// swizzle (TMA's SWIZZLE_128B of a 128-byte-wide box)
__device__ __forceinline__ int sw(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}

// a tile as a K-major operand, k16 step kk; as an MN-major one
__device__ __forceinline__ uint64_t kdesc(const unsigned char* t, int kk) {
  return gmma_desc128(t + 32 * kk, 16, 1024);
}
__device__ __forceinline__ uint64_t mdesc(const unsigned char* t, int kk) {
  return gmma_desc128(t + 2048 * kk, BOX, 1024);
}

// ---------------------------------------------------------------------------
// wgmma: m64n64k16 / m64n32k16, A from registers (TB: B MN-major) or both
// operands from shared memory (TA, TB: MN-major); f32 accumulators, acc =
// 0 overwrites d
// ---------------------------------------------------------------------------

template <int TB>
__device__ __forceinline__ void mma_rs64(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void mma_rs32(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc),
        "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss32(float (&d)[16], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
}

__device__ __forceinline__ void wait_all() {
  wg_commit();
  wg_wait();
}

// ---------------------------------------------------------------------------
// the accumulator layout.  An m64nN accumulator's value 4 j + 2 hh + e is
// row R(hh) = 16 warp + g + 8 hh of the tile, column 8 j + 2 t + e (g =
// lane / 4, t = lane % 4).  The A operand of a k16 step s is the pairs of
// columns 16 s + 2 t (a[0], a[1]: rows g, g + 8) and 16 s + 8 + 2 t (a[2],
// a[3]): the accumulator's values 8 s .. 8 s + 7, so one product's output
// is the next one's A.
// ---------------------------------------------------------------------------

template <int S>
__device__ __forceinline__ void pack_a(uint32_t (&a)[S][4],
                                       const float (&x)[8 * S]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[s][i] = pack_f32(x[8 * s + 2 * i], x[8 * s + 2 * i + 1]);
}

// the same from packed bf16 pairs p[4 j + 2 hh] / 2 = p[2 j + hh]
template <int S>
__device__ __forceinline__ void pairs_a(uint32_t (&a)[S][4],
                                        const uint32_t (&p)[4 * S]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[s][i] = p[4 * s + i];
}

// a quad's (the four threads of a row) sum, in every thread of it
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// The sums over the warp's 8 row groups (lanes g) of v[NV], NV / 8 of them
// kept in each lane: out[k] = the sum of v[g NV / 8 + k] over the 8 lanes
// that share this lane's t.  Three exchanges of half the values, each lane
// adding what it keeps to what its partner sends, in a fixed order.
template <int NV>
__device__ __forceinline__ void reduce_g(const float (&v)[NV],
                                         float (&out)[NV / 8]) {
  const int lane = threadIdx.x & 31;
  float a[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) a[i] = v[i];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int half = NV >> (s + 1);
    const bool up = (lane >> (4 - s)) & 1;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? a[i] : a[i + half];
      const float keep = up ? a[i + half] : a[i];
      a[i] = keep + __shfl_xor_sync(FULL, send, 16 >> s);
    }
  }
#pragma unroll
  for (int k = 0; k < NV / 8; ++k) out[k] = a[k];
}

// A column sum of an n64 accumulator-layout tile over its valid rows into
// the lane's running pair: columns 8 g + 2 t (+ 1) of the warp's rows.
__device__ __forceinline__ void col_sum(float (&acc)[2], const float (&x)[32],
                                        const bool (&valid)[2]) {
  float v[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[2 * j + e] = (valid[0] ? x[4 * j + e] : 0.f) +
                     (valid[1] ? x[4 * j + 2 + e] : 0.f);
  float o[2];
  reduce_g<16>(v, o);
  acc[0] += o[0];
  acc[1] += o[1];
}

// The same for an n32 tile: the lane's running value is feature 8 (g / 2)
// + 2 t + g % 2 of the warp's rows.
__device__ __forceinline__ float feat_sum(const float (&x)[16],
                                          const bool (&valid)[2]) {
  float v[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      v[2 * j + e] = (valid[0] ? x[4 * j + e] : 0.f) +
                     (valid[1] ? x[4 * j + 2 + e] : 0.f);
  float o[1];
  reduce_g<8>(v, o);
  return o[0];
}

// ---------------------------------------------------------------------------
// the random features on the CUDA cores, exact f32
// ---------------------------------------------------------------------------

// w [m, emb] f32 into shared memory so that a thread's 16 columns of row
// j, w[j][8 (i / 2) + 2 t + i % 2] (i < 16), are four 16-byte loads: float4
// q of thread t at wp[j][4 t + (q ^ t)], the four t's of a load in distinct
// banks
__device__ __forceinline__ void load_wp(float* wp,
                                        const float* __restrict__ w) {
  for (int idx = threadIdx.x; idx < M * 64; idx += THREADS) {
    const int j = idx >> 6, t = (idx >> 4) & 3, i = idx & 15, q = i >> 2;
    wp[j * 64 + 16 * t + 4 * (q ^ t) + (i & 3)] =
        w[j * EMB + 8 * (i >> 1) + 2 * t + (i & 1)];
  }
}

// p = prm(t) of the thread's two rows: t an n64 accumulator (the 64-wide
// rows), p an n32 one (value 4 j + 2 hh + e: feature 8 j + 2 t + e).  Each
// thread dots its 16 columns with every feature's, and the quad's four
// partial dots of a feature are added by a reduce-scatter (xor 2, then
// xor 1) that leaves each thread its own 8 features.
__device__ __forceinline__ void prm_rows(const float (&x)[32],
                                         const float* wp, float (&p)[16]) {
  const int t = threadIdx.x & 3;
  float dot[2][M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float4* wr = reinterpret_cast<const float4*>(wp + j * 64 + 16 * t);
    float wv[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = wr[q ^ t];
      wv[4 * q] = f.x;
      wv[4 * q + 1] = f.y;
      wv[4 * q + 2] = f.z;
      wv[4 * q + 3] = f.w;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        s += x[4 * (i >> 1) + 2 * hh + (i & 1)] * wv[i];
      dot[hh][j] = s;
    }
  }
  // feature j = 8 a + 4 b + c: keep b = t / 2 (xor 2), then c / 2 = t % 2
  // (xor 1)
  const bool hb = t & 2, lb = t & 1;
  float r1[2][16];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float lo = dot[hh][8 * a + c], hi = dot[hh][8 * a + 4 + c];
        const float send = hb ? lo : hi, keep = hb ? hi : lo;
        r1[hh][4 * a + c] = keep + __shfl_xor_sync(FULL, send, 2);
      }
  float xd[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float v = x[4 * (i >> 1) + 2 * hh + (i & 1)];
      s += v * v;
    }
    xd[hh] = quad_sum(s) / 2.f;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo = r1[hh][4 * a + e], hi = r1[hh][4 * a + 2 + e];
        const float send = lb ? lo : hi, keep = lb ? hi : lo;
        const float dt = keep + __shfl_xor_sync(FULL, send, 1);
        p[4 * a + 2 * hh + e] = expf(dt - xd[hh]) / SQRT_M;
      }
}

// ---------------------------------------------------------------------------
// the front: x and Wkqv's rows through a TMA ring in 64-column chunks
// ---------------------------------------------------------------------------

struct Ring {
  unsigned char* base;
  uint64_t* full;
  int stages, stage_bytes;
};

// The loads of one CTA, in the order it consumes them.  Per tile: with
// cps > 0 a statistics pass of sst = ceil(nk / cps) steps, each cps x
// chunks (a stage's boxes); then `passes` passes over the nk chunks, pass
// p loading the x chunk and nbox[p] boxes of Wkqv (its rows of the chunk,
// columns 64 box[p][j] ..).  A stage holds x, then the boxes in order.
struct Loads {
  const CUtensorMap* xmap;
  const CUtensorMap* wmap;
  int img, t0, ntl, nk, cps, passes;
  int nbox[3];
  int box[3][3];

  __device__ int sst() const { return cps ? (nk + cps - 1) / cps : 0; }
  __device__ int per_tile() const { return sst() + passes * nk; }

  __device__ void issue(const Ring& r, int i) const {
    const int per = per_tile();
    if (i >= ntl * per) return;
    const int tile = t0 + i / per, pos = i % per, ns = sst();
    unsigned char* dst = r.base + (i % r.stages) * r.stage_bytes;
    uint64_t* bar = r.full + i % r.stages;
    if (pos < ns) {
      const int c0 = pos * cps, nc = min(cps, nk - c0);
      mbar_expect_tx(bar, BOX * nc);
      for (int j = 0; j < nc; ++j)
        tma_load_3d(dst + BOX * j, xmap, bar, 64 * (c0 + j), TILE * tile,
                    img);
      return;
    }
    const int pass = (pos - ns) / nk, chunk = (pos - ns) % nk;
    const int nb = nbox[pass];
    mbar_expect_tx(bar, BOX * (1 + nb));
    tma_load_3d(dst, xmap, bar, 64 * chunk, TILE * tile, img);
    for (int j = 0; j < nb; ++j)
      tma_load_2d(dst + BOX * (1 + j), wmap, bar, 64 * box[pass][j],
                  64 * chunk);
  }
};

__device__ __forceinline__ const unsigned char* acquire(const Ring& r, int i) {
  mbar_wait(r.full + i % r.stages, (i / r.stages) & 1);
  return r.base + (i % r.stages) * r.stage_bytes;
}

// every thread is done with load i's stage: refill it
__device__ __forceinline__ void release(const Ring& r, const Loads& l, int i) {
  __syncthreads();
  if (threadIdx.x == 0) l.issue(r, i + r.stages);
}

// barriers and the first loads
__device__ __forceinline__ void ring_start(const Ring& r, const Loads& l) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < r.stages; ++s) mbar_init(r.full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < r.stages; ++s) l.issue(r, s);
}

// LN1's statistics of the tile's rows, each chunk's (count, mean, sum of
// squared deviations over the live slots) combined into the running ones
// (Chan et al.); a lane keeps rows 16 warp + 4 i + lane / 8 (i < 4), the
// 8 lanes of a row 16 bytes of the chunk each
struct Stats {
  float n, mean[4], m2[4];
};

__device__ __forceinline__ void stats_chunk(Stats& s, const unsigned char* xs,
                                            int chunk,
                                            const float* __restrict__ fmask,
                                            int dim) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane & 7;
  const int col = 64 * chunk + 8 * q;
  float fm[8], nc = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    fm[e] = col + e < dim ? fmask[col + e] : 0.f;
    nc += fm[e];
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) nc += __shfl_xor_sync(FULL, nc, o);
  if (nc == 0.f) return;
  const float na = s.n, nab = na + nc, inc = 1.f / nc, wc = nc / nab;
  s.n = nab;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 16 * warp + 4 * i + (lane >> 3);
    const uint4 v =
        *reinterpret_cast<const uint4*>(xs + r * 128 + (((q ^ r) & 7) << 4));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    float x[8], sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = lo_f(w[e]);
      x[2 * e + 1] = hi_f(w[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += x[e] * fm[e];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(FULL, sum, o);
    const float mc = sum * inc;
    float d2 = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = x[e] - mc;
      d2 += d * d * fm[e];
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) d2 += __shfl_xor_sync(FULL, d2, o);
    const float delta = mc - s.mean[i];
    s.mean[i] += delta * wc;
    s.m2[i] += d2 + delta * delta * na * wc;
  }
}

// the statistics pass: (mean, rstd) of each row into st[64]
__device__ __forceinline__ void ln1_stats(const Ring& r, const Loads& l,
                                          int& i,
                                          const float* __restrict__ fmask,
                                          int dim, float fcount, float2* st) {
  Stats s;
  s.n = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) s.mean[k] = s.m2[k] = 0.f;
  for (int k = 0, ns = l.sst(); k < ns; ++k, ++i) {
    const unsigned char* stg = acquire(r, i);
    for (int j = 0, c = k * l.cps; j < l.cps && c < l.nk; ++j, ++c)
      stats_chunk(s, stg + BOX * j, c, fmask, dim);
    release(r, l, i);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((lane & 7) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      st[16 * warp + 4 * k + (lane >> 3)] =
          make_float2(s.mean[k], rsqrtf(s.m2[k] / fcount + LN_EPS));
  }
  __syncthreads();
}

// The A operand of chunk `chunk`'s four k16 steps: bf16(LN1(x)) of rows
// R(0), R(1) from the x chunk xs; with xn, also stored there (rows xn[0],
// xn[1], null where past N).
__device__ __forceinline__ void xn_frags(uint32_t (&a)[4][4],
                                         const unsigned char* xs, int chunk,
                                         const float2 (&s)[2],
                                         const float* __restrict__ g1,
                                         const float* __restrict__ b1, int dim,
                                         bf16* const (&xn)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * kk + 8 * h + 2 * t, col = 64 * chunk + c;
      float2 gg = make_float2(0.f, 0.f), bb = gg;
      if (col < dim) {
        gg = *reinterpret_cast<const float2*>(g1 + col);
        bb = *reinterpret_cast<const float2*>(b1 + col);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + g + 8 * hh;
        const uint32_t p = *reinterpret_cast<const uint32_t*>(xs + sw(r, c));
        const float y0 = (lo_f(p) - s[hh].x) * s[hh].y * gg.x + bb.x;
        const float y1 = (hi_f(p) - s[hh].x) * s[hh].y * gg.y + bb.y;
        const uint32_t v = pack_f32(y0, y1);
        a[kk][2 * h + hh] = v;
        if (xn[hh] != nullptr && col < dim)
          *reinterpret_cast<uint32_t*>(xn[hh] + col) = v;
      }
    }
}

// pass 1: acc[j] = bf16(LN1(x)) . Wkqv[:, 64 box[j] ..] over the chunks
template <int NB>
__device__ __forceinline__ void front(const Ring& r, const Loads& l, int& i,
                                      int nk, const float2* st,
                                      const float* __restrict__ g1,
                                      const float* __restrict__ b1, int dim,
                                      bf16* const (&xn)[2],
                                      float (&acc)[NB][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float2 s[2] = {st[16 * warp + (lane >> 2)],
                       st[16 * warp + (lane >> 2) + 8]};
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[j][k] = 0.f;
  for (int c = 0; c < nk; ++c, ++i) {
    const unsigned char* stg = acquire(r, i);
    uint32_t a[4][4];
    xn_frags(a, stg, c, s, g1, b1, dim, xn);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mma_rs64<1>(acc[j], a[kk], mdesc(stg + BOX * (1 + j), kk), 1);
    wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
    release(r, l, i);
  }
}

// ---------------------------------------------------------------------------
// dx: LN1's VJP of dxn = dkqv_half . W_half^T, the product chunk by chunk
// ---------------------------------------------------------------------------

// dxn's 64 columns of chunk stg: a[s] the A operand (k16 steps 0-3 the
// first half's columns, 4-7 the second's) against the stage's boxes lo and
// hi (1-3)
__device__ __forceinline__ void dxn_chunk(float (&d)[32],
                                          const uint32_t (&a)[8][4],
                                          const unsigned char* stg, int lo,
                                          int hi) {
#pragma unroll
  for (int k = 0; k < 32; ++k) d[k] = 0.f;
  wg_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s)
    mma_rs64<0>(d, a[s], kdesc(stg + BOX * (s < 4 ? lo : hi), s & 3), 1);
  wait_all();
  fence_acc(d);
}

// A pass over the chunks (boxes k, v, q: 1-3): the row sums of LN1's VJP
// of each half of dxn, gd = dxn g1 fmask and gd xhat, over fcount into
// m[hh] = (mean gd, mean gd xhat) of rows R(hh): mq of dxn1 (the q|v half,
// A operand aq), mkv of dxn2 (the k|v half, akv); the tile's dLN1 column
// sums (dxn1 + dxn2) xhat and dxn1 + dxn2 into part[2][dim] (the lanes'
// pairs added over the warp's rows, then the 4 warps in order).
__device__ __forceinline__ void ln1_sums(
    const Ring& r, const Loads& l, int& i, int nk, const uint32_t (&aq)[8][4],
    const uint32_t (&akv)[8][4], const float2* st,
    const float* __restrict__ g1, const float* __restrict__ fmask, int dim,
    float fcount, float* part, float* red, float2 (&mq)[2],
    float2 (&mkv)[2]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float2 s[2] = {st[16 * warp + g], st[16 * warp + g + 8]};
  float s1[2][2] = {}, s2[2][2] = {};  // [half][hh]
  for (int c = 0; c < nk; ++c, ++i) {
    const unsigned char* stg = acquire(r, i);
    float d1[32], d2[32];
    dxn_chunk(d1, aq, stg, 3, 2);
    dxn_chunk(d2, akv, stg, 1, 2);
    float pg[16], pb[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * j + 2 * t + e, col = 64 * c + cc;
        const bool in = col < dim;
        const float gm = in ? g1[col] * fmask[col] : 0.f;
        pg[2 * j + e] = pb[2 * j + e] = 0.f;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rr = 16 * warp + g + 8 * hh;
          const bf16 xv = *reinterpret_cast<const bf16*>(stg + sw(rr, cc));
          const float xh = (bf2f(xv) - s[hh].x) * s[hh].y;
          const float v1 = d1[4 * j + 2 * hh + e], v2 = d2[4 * j + 2 * hh + e];
          const float gd1 = v1 * gm, gd2 = v2 * gm;
          s1[0][hh] += gd1;
          s2[0][hh] += gd1 * xh;
          s1[1][hh] += gd2;
          s2[1][hh] += gd2 * xh;
          const float v = v1 + v2;
          pg[2 * j + e] += v * xh;
          pb[2 * j + e] += v;
        }
      }
    float og[2], ob[2];
    reduce_g<16>(pg, og);
    reduce_g<16>(pb, ob);
    float* rb = red + (c & 1) * 2 * 4 * 64;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rb[warp * 64 + 8 * g + 2 * t + e] = og[e];
      rb[4 * 64 + warp * 64 + 8 * g + 2 * t + e] = ob[e];
    }
    release(r, l, i);
    {
      const int q = tid >> 6, cc = tid & 63, col = 64 * c + cc;
      if (col < dim) {
        const float* rq = rb + q * 4 * 64;
        part[q * dim + col] =
            ((rq[cc] + rq[64 + cc]) + rq[128 + cc]) + rq[192 + cc];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mq[hh] = make_float2(quad_sum(s1[0][hh]) / fcount,
                         quad_sum(s2[0][hh]) / fcount);
    mkv[hh] = make_float2(quad_sum(s1[1][hh]) / fcount,
                          quad_sum(s2[1][hh]) / fcount);
  }
}

// A pass over the chunks (boxes k, v, q: 1-3) writing dx = bf16(bf16(dx1)
// + bf16(dx2)), each half (gd - mean gd - xhat mean(gd xhat)) rstd fmask of
// its dxn: dx1 from the q|v half (A operand aq, row means mq), dx2 from the
// k|v half (akv, mkv); rows dx[hh], null past N.
__device__ __forceinline__ void dx_pass(const Ring& r, const Loads& l, int& i,
                                        int nk, const uint32_t (&aq)[8][4],
                                        const uint32_t (&akv)[8][4],
                                        const float2 (&mq)[2],
                                        const float2 (&mkv)[2],
                                        const float2* st,
                                        const float* __restrict__ g1,
                                        const float* __restrict__ fmask,
                                        int dim, bf16* const (&dx)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float2 s[2] = {st[16 * warp + g], st[16 * warp + g + 8]};
  for (int c = 0; c < nk; ++c, ++i) {
    const unsigned char* stg = acquire(r, i);
    float d1[32], d2[32];
    dxn_chunk(d1, aq, stg, 3, 2);
    dxn_chunk(d2, akv, stg, 1, 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = 8 * j + 2 * t, col = 64 * c + cc;
      if (col >= dim) continue;
      const float2 gg = *reinterpret_cast<const float2*>(g1 + col);
      const float2 fm = *reinterpret_cast<const float2*>(fmask + col);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (dx[hh] == nullptr) continue;
        const int rr = 16 * warp + g + 8 * hh;
        const uint32_t xp =
            *reinterpret_cast<const uint32_t*>(stg + sw(rr, cc));
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xh = ((e ? hi_f(xp) : lo_f(xp)) - s[hh].x) * s[hh].y;
          const float gm = e ? gg.y * fm.y : gg.x * fm.x;
          const float f = s[hh].y * (e ? fm.y : fm.x);
          const float gd1 = d1[4 * j + 2 * hh + e] * gm;
          const float gd2 = d2[4 * j + 2 * hh + e] * gm;
          v[e] = rnd((gd1 - mq[hh].x - xh * mq[hh].y) * f) +
                 rnd((gd2 - mkv[hh].x - xh * mkv[hh].y) * f);
        }
        *reinterpret_cast<uint32_t*>(dx[hh] + col) = pack_f32(v[0], v[1]);
      }
    }
    release(r, l, i);
  }
}

// ---------------------------------------------------------------------------
// small pieces of the kernels
// ---------------------------------------------------------------------------

// a [64][64] bf16 matrix (row-major) into a swizzled tile
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const bf16* __restrict__ m) {
  for (int idx = threadIdx.x; idx < 64 * 8; idx += THREADS) {
    const int r = idx >> 3, q = idx & 7;
    *reinterpret_cast<uint4*>(tile + r * 128 + (((q ^ r) & 7) << 4)) =
        *reinterpret_cast<const uint4*>(m + r * 64 + 8 * q);
  }
}

// an accumulator-layout n64 tile's pairs (rows R(hh), valid or zero) into a
// swizzled [64][64] tile
__device__ __forceinline__ void put_pairs(unsigned char* tile,
                                          const uint32_t (&p)[16],
                                          const bool (&valid)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<uint32_t*>(
          tile + sw(16 * warp + g + 8 * hh, 8 * j + 2 * t)) =
          valid[hh] ? p[2 * j + hh] : 0u;
}

// an n32 accumulator-layout tile (rows R(hh), features) transposed, bf16,
// into a swizzled [32 features][64 rows] tile
__device__ __forceinline__ void put_t32(unsigned char* tile,
                                        const float (&x)[16],
                                        const bool (&valid)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<bf16*>(
            tile + sw(8 * j + 2 * t + e, 16 * warp + g + 8 * hh)) =
            f2bf(valid[hh] ? x[4 * j + 2 * hh + e] : 0.f);
}

template <int NV>
__device__ __forceinline__ void pairs_of(uint32_t (&p)[NV / 2],
                                         const float (&x)[NV]) {
#pragma unroll
  for (int k = 0; k < NV / 2; ++k) p[k] = pack_f32(x[2 * k], x[2 * k + 1]);
}

// pairs p[2 j + hh] of rows `row[hh]` (null: past N) at columns col0 +
// 8 j + 2 t of a bf16 matrix
__device__ __forceinline__ void store_pairs(bf16* const (&row)[2], int col0,
                                            const uint32_t (&p)[16]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (row[hh] == nullptr) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(row[hh] + col0 + 8 * j + 2 * t) =
          p[2 * j + hh];
  }
}

// (rows of the tile past N give zeros)
__device__ __forceinline__ void load_pairs(uint32_t (&p)[16],
                                           const bf16* const (&row)[2],
                                           int col0 = 0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      p[2 * j + hh] = row[hh] ? *reinterpret_cast<const uint32_t*>(
                                    row[hh] + col0 + 8 * j + 2 * t)
                              : 0u;
}

// the lanes' running column pairs of the 4 warps added in warp order into
// out[64] (red: 4 x 64 floats); all threads call it
__device__ __forceinline__ void warps_cols(const float (&acc)[2], float* red,
                                           float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
  red[warp * 64 + 8 * g + 2 * t] = acc[0];
  red[warp * 64 + 8 * g + 2 * t + 1] = acc[1];
  __syncthreads();
  if (threadIdx.x < 64) {
    const int c = threadIdx.x;
    out[c] = ((red[c] + red[64 + c]) + red[128 + c]) + red[192 + c];
  }
}

// the same for a lane's running feature value (feat_sum), into out[32]
__device__ __forceinline__ void warps_feats(float v, float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  __syncthreads();
  red[warp * 32 + 8 * (g >> 1) + 2 * t + (g & 1)] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int j = threadIdx.x;
    out[j] = ((red[j] + red[32 + j]) + red[64 + j]) + red[96 + j];
  }
}

// an n32 accumulator over [64 rows = emb][32 features] into out[emb][m]
__device__ __forceinline__ void store_emb_m(float* out, const float (&x)[16]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(out + (16 * warp + g + 8 * hh) * M + 8 * j +
                                 2 * t) =
          make_float2(x[4 * j + 2 * hh], x[4 * j + 2 * hh + 1]);
}

// An image's [emb, m] matrix and [m] vector: its `parts` partials (stride
// PART) added in index order; bf16 into tiles ka ([emb][m]: K-major for a
// product over m) and kb ([m][emb]: K-major over emb), the vector into
// vec; the sums also into mat / vecout where given.
__device__ __forceinline__ void image_sums(const float* __restrict__ part,
                                           int parts, unsigned char* ka,
                                           unsigned char* kb, float* vec,
                                           float* mat, float* vecout) {
  for (int idx = threadIdx.x; idx < PART; idx += THREADS) {
    float s = 0.f;
    for (int p = 0; p < parts; ++p) s += part[(size_t)p * PART + idx];
    if (idx < EMB * M) {
      const int e = idx / M, j = idx % M;
      const bf16 v = f2bf(s);
      *reinterpret_cast<bf16*>(ka + sw(e, j)) = v;
      if (kb) *reinterpret_cast<bf16*>(kb + sw(j, e)) = v;
      if (mat) mat[idx] = s;
    } else {
      vec[idx - EMB * M] = s;
      if (vecout) vecout[idx - EMB * M] = s;
    }
  }
}

// the thread's rows of the tile: row pointers into a [B*N][cols] matrix
// (null past N) and their validity
struct Rows {
  bool valid[2];
  size_t row[2];
  __device__ Rows(int img, int n, int tok0) {
    const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tok = tok0 + r0 + 8 * hh;
      valid[hh] = tok < n;
      row[hh] = (size_t)img * n + tok;
    }
  }
  template <typename T>
  __device__ void of(T* base, int cols, T* (&p)[2]) const {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      p[hh] = valid[hh] && base ? base + row[hh] * cols : nullptr;
  }
};

// ---------------------------------------------------------------------------
// the kernels' operands
// ---------------------------------------------------------------------------

struct Ops {
  const bf16* x;
  const float *g1, *b1;
  const bf16 *wkqv, *bkqv;
  const float *w, *fmask;
  const bf16 *wproj, *bproj;
  const float *g2, *b2;
  const bf16 *wfc1, *bfc1, *wfc2, *bfc2;
};

struct Shape {
  int b, n, dim, ntiles, nk, per;
  float fcount;
};

// the per-column vectors of the 64-wide part: g2, b2, bproj, bfc1, bfc2
// (f32) into vec[5][64]
__device__ __forceinline__ void load_vecs(float* vec, const Ops& o) {
  for (int c = threadIdx.x; c < 5 * EMB; c += THREADS) {
    const int q = c / EMB, k = c % EMB;
    vec[c] = q == 0   ? o.g2[k]
             : q == 1 ? o.b2[k]
             : q == 2 ? bf2f(o.bproj[k])
             : q == 3 ? bf2f(o.bfc1[k])
                      : bf2f(o.bfc2[k]);
  }
}
enum { V_G2 = 0, V_B2 = 64, V_BPROJ = 128, V_BFC1 = 192, V_BFC2 = 256 };

// adds bias[col] (bf16) to an n64 accumulator
__device__ __forceinline__ void add_bias(float (&x)[32],
                                         const bf16* __restrict__ bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float b0 = bf2f(bias[8 * j + 2 * t]);
    const float b1 = bf2f(bias[8 * j + 2 * t + 1]);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      x[4 * j + 2 * hh] += b0;
      x[4 * j + 2 * hh + 1] += b1;
    }
  }
}

// LN2 of bf16(attn) (rows of 64, statistics from the quad): xb = the
// rounded rows, (mean, rstd) per row
__device__ __forceinline__ void ln2_stats(const float (&attn)[32],
                                          float (&xb)[32], float (&mean)[2],
                                          float (&rstd)[2]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) xb[k] = rnd(attn[k]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      s += xb[4 * j + 2 * hh] + xb[4 * j + 2 * hh + 1];
    mean[hh] = quad_sum(s) / EMB;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = xb[4 * j + 2 * hh + e] - mean[hh];
        q += d * d;
      }
    rstd[hh] = rsqrtf(quad_sum(q) / EMB + LN_EPS);
  }
}

// h2 = LN2 output (f32) from xb and the statistics
__device__ __forceinline__ void ln2_apply(const float (&xb)[32],
                                          const float (&mean)[2],
                                          const float (&rstd)[2],
                                          const float* vec, float (&h2)[32]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e, k = 4 * j + 2 * hh + e;
        h2[k] = (xb[k] - mean[hh]) * rstd[hh] * vec[V_G2 + c] + vec[V_B2 + c];
      }
}

// acc (+)= a . tile over K = 16 S, B MN-major (TB = 1) or K-major
template <int TB, int S>
__device__ __forceinline__ void prod64(float (&d)[32],
                                       const uint32_t (&a)[S][4],
                                       const unsigned char* tile) {
  wg_fence();
#pragma unroll
  for (int s = 0; s < S; ++s)
    mma_rs64<TB>(d, a[s], TB ? mdesc(tile, s) : kdesc(tile, s), 1);
  wait_all();
  fence_acc(d);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) x[k] = 0.f;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  Ops o;
  Shape sh;
  bf16* out;
  float *kptv, *kpsum, *qp;
  bf16* v;
  float* part;   // [B * ctas1][PART]
  int ctas1;
};

constexpr int F1_STAGES = 2, F1_STAGE = 4 * BOX;
constexpr int F1_CPS = 4;  // x chunks a statistics step (a stage's boxes)
constexpr int F1_TV = F1_STAGES * F1_STAGE, F1_TK = F1_TV + BOX;
constexpr int F1_WP = F1_TK + BOX / 2, F1_ST = F1_WP + WP_BYTES;
constexpr int F1_RED = F1_ST + 64 * 8, F1_BAR = F1_RED + 4 * 32 * 4;
constexpr size_t F1_SMEM = 1024 + F1_BAR + F1_STAGES * 8;

__global__ void __launch_bounds__(THREADS, 2)
    fwd_sums_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  unsigned char* tv = sm + F1_TV;
  unsigned char* tk = sm + F1_TK;
  float* wp = reinterpret_cast<float*>(sm + F1_WP);
  float2* st = reinterpret_cast<float2*>(sm + F1_ST);
  float* red = reinterpret_cast<float*>(sm + F1_RED);
  const Shape& sh = a.sh;
  const int img = blockIdx.y, t0 = blockIdx.x * sh.per;
  const int ntl = min(sh.per, sh.ntiles - t0);
  const Ring ring{sm, reinterpret_cast<uint64_t*>(sm + F1_BAR), F1_STAGES,
                  F1_STAGE};
  // LN1's statistics, then the front with k, q and v
  const Loads loads{&xmap, &wmap, img, t0, ntl, sh.nk, F1_CPS, 1,
                    {3, 0, 0}, {{0, 1, 2}, {0, 0, 0}, {0, 0, 0}}};
  load_wp(wp, a.o.w);
  ring_start(ring, loads);

  float kacc[16], ks = 0.f;
  zero(kacc);
  bf16* const noxn[2] = {nullptr, nullptr};
  int i = 0;
  for (int tl = 0; tl < ntl; ++tl) {
    const Rows rows(img, sh.n, TILE * (t0 + tl));
    ln1_stats(ring, loads, i, a.o.fmask, sh.dim, sh.fcount, st);
    float acc[3][32];
    front(ring, loads, i, sh.nk, st, a.o.g1, a.o.b1, sh.dim, noxn, acc);
#pragma unroll
    for (int j = 0; j < 3; ++j) add_bias(acc[j], a.o.bkqv + EMB * j);
    float kp[16], qp[16];
    prm_rows(acc[0], wp, kp);
    prm_rows(acc[1], wp, qp);
#pragma unroll
    for (int k = 0; k < 16; ++k) kp[k] = rnd(kp[k]);
    // qp (f32) and v (bf16) for the second kernel
    float* qrow[2];
    rows.of(a.qp, M, qrow);
    bf16* vrow[2];
    rows.of(a.v, EMB, vrow);
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (qrow[hh])
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(qrow[hh] + 8 * j + 2 * t) =
              make_float2(qp[4 * j + 2 * hh], qp[4 * j + 2 * hh + 1]);
    uint32_t vp[16];
    pairs_of<32>(vp, acc[2]);
    store_pairs(vrow, 0, vp);
    // the tile's kptv = v^T kp (rows past N zero) and kpsum
    put_pairs(tv, vp, rows.valid);
    put_t32(tk, kp, rows.valid);
    ks += feat_sum(kp, rows.valid);
    fence_proxy_async();
    __syncthreads();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss32<1, 0>(kacc, mdesc(tv, kk), kdesc(tk, kk), 1);
    wait_all();
    fence_acc(kacc);
    __syncthreads();
  }
  float* out = a.part + (size_t)(img * a.ctas1 + blockIdx.x) * PART;
  store_emb_m(out, kacc);
  warps_feats(ks, red, out + EMB * M);
}

constexpr int F2_WPROJ = 0, F2_WFC1 = BOX, F2_WFC2 = 2 * BOX, F2_KA = 3 * BOX;
constexpr int F2_VEC = 4 * BOX, F2_KPS = F2_VEC + 5 * EMB * 4;
constexpr size_t F2_SMEM = 1024 + F2_KPS + M * 4;

__global__ void __launch_bounds__(THREADS)
    fwd_apply_kernel(FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  float* vec = reinterpret_cast<float*>(sm + F2_VEC);
  float* kps = reinterpret_cast<float*>(sm + F2_KPS);
  const Shape& sh = a.sh;
  const int img = blockIdx.y, t0 = blockIdx.x * sh.per;
  const int ntl = min(sh.per, sh.ntiles - t0);
  load_tile(sm + F2_WPROJ, a.o.wproj);
  load_tile(sm + F2_WFC1, a.o.wfc1);
  load_tile(sm + F2_WFC2, a.o.wfc2);
  load_vecs(vec, a.o);
  const bool first = blockIdx.x == 0;
  image_sums(a.part + (size_t)img * a.ctas1 * PART, a.ctas1, sm + F2_KA,
             nullptr, kps, first ? a.kptv + (size_t)img * EMB * M : nullptr,
             first ? a.kpsum + (size_t)img * M : nullptr);
  fence_proxy_async();
  __syncthreads();

  const int t = threadIdx.x & 3;
  for (int tl = 0; tl < ntl; ++tl) {
    const Rows rows(img, sh.n, TILE * (t0 + tl));
    const float* qrow[2];
    rows.of<const float>(a.qp, M, qrow);
    const bf16* vrow[2];
    rows.of<const bf16>(a.v, EMB, vrow);
    float qp[16], d[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 q = qrow[hh] ? *reinterpret_cast<const float2*>(
                                        qrow[hh] + 8 * j + 2 * t)
                                  : make_float2(0.f, 0.f);
        qp[4 * j + 2 * hh] = q.x;
        qp[4 * j + 2 * hh + 1] = q.y;
        d[hh] += q.x * kps[8 * j + 2 * t] + q.y * kps[8 * j + 2 * t + 1];
      }
    uint32_t vp[16];
    load_pairs(vp, vrow);
    // y = bf16(qp) bf16(kptv)^T / (d + 1e-8)
    uint32_t aq[2][4];
    pack_a<2>(aq, qp);
    float y[32];
    zero(y);
    prod64<0, 2>(y, aq, sm + F2_KA);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) d[hh] = quad_sum(d[hh]) + D_EPS;
#pragma unroll
    for (int k = 0; k < 32; ++k) y[k] = y[k] / d[(k >> 1) & 1];
    // attn = v + (bf16(y) . Wproj + bproj)
    uint32_t ay[4][4];
    pack_a<4>(ay, y);
    float at[32];
    zero(at);
    prod64<1, 4>(at, ay, sm + F2_WPROJ);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int c = 8 * j + 2 * t, k = 4 * j + 2 * hh;
        const uint32_t p = vp[2 * j + hh];
        at[k] = lo_f(p) + (at[k] + vec[V_BPROJ + c]);
        at[k + 1] = hi_f(p) + (at[k + 1] + vec[V_BPROJ + c + 1]);
      }
    // LN2, fc1 and GELU, fc2 with the residual
    float xb[32], mean[2], rstd[2], h2[32];
    ln2_stats(at, xb, mean, rstd);
    ln2_apply(xb, mean, rstd, vec, h2);
    uint32_t ah[4][4];
    pack_a<4>(ah, h2);
    float hv[32];
    zero(hv);
    prod64<1, 4>(hv, ah, sm + F2_WFC1);
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const float h = hv[k] + vec[V_BFC1 + 8 * (k >> 2) + 2 * t + (k & 1)];
      hv[k] = h * (0.5f * (1.f + erff(h * 0.70710678118654752f)));
    }
    uint32_t aa[4][4];
    pack_a<4>(aa, hv);
    float mo[32];
    zero(mo);
    prod64<1, 4>(mo, aa, sm + F2_WFC2);
#pragma unroll
    for (int k = 0; k < 32; ++k)
      mo[k] = at[k] + (mo[k] + vec[V_BFC2 + 8 * (k >> 2) + 2 * t + (k & 1)]);
    uint32_t op[16];
    pairs_of<32>(op, mo);
    bf16* orow[2];
    rows.of(a.out, EMB, orow);
    store_pairs(orow, 0, op);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  Ops o;
  Shape sh;
  const float *kptv, *kpsum;
  const bf16* dout;
  bf16* dx;      // null: no dx
  // [B*N][dim], [B*N][dk | dv | dq | dattn] and [B*N][y | h2 | a | dhh]:
  // the weight-gradient products' operands
  bf16 *xn, *dbuf, *gbuf;
  // partials: dkptv | dkpsum and the column sums a CTA, dLN1's a tile
  float *kpart, *part, *lnpart;
  // [B*N] a row: LN1's (mean, rstd), for bwd_kv_kernel
  float2* rstat;
  int ctas1;     // bwd_q_kernel's CTAs an image
};

constexpr int BW_STAGE = 3 * BOX;
constexpr int RED_BYTES = 2 * 2 * 4 * 64 * 4;
// two CTAs an SM: TA holds dkptv's A operand, then the CTA's reductions
constexpr int Q_STAGES = 2, Q_RING = Q_STAGES * BW_STAGE;
constexpr int Q_CPS = 3;  // x chunks a statistics step
constexpr int Q_WPROJ = Q_RING, Q_WFC1 = Q_WPROJ + BOX, Q_WFC2 = Q_WFC1 + BOX;
constexpr int Q_KA = Q_WFC2 + BOX, Q_TA = Q_KA + BOX, Q_TB = Q_TA + BOX;
constexpr int Q_KB = Q_TB + BOX / 2, Q_WB = Q_KB + BOX / 2;
constexpr int Q_WP = Q_WB + BOX / 2, Q_VEC = Q_WP + WP_BYTES;
constexpr int Q_KPS = Q_VEC + 5 * EMB * 4, Q_ST = Q_KPS + M * 4;
constexpr int Q_BAR = Q_ST + 64 * 8;
constexpr size_t Q_SMEM = 1024 + Q_BAR + Q_STAGES * 8;
static_assert(4 * 64 * 4 <= BOX, "the reductions in TA");

// wb = bf16(w) [m][emb] into a tile: the MN-major B of r(dwtx) . wb
__device__ __forceinline__ void load_wb(unsigned char* tile,
                                        const float* __restrict__ w) {
  for (int idx = threadIdx.x; idx < M * EMB; idx += THREADS) {
    const int j = idx / EMB, e = idx % EMB;
    *reinterpret_cast<bf16*>(tile + sw(j, e)) = f2bf(w[idx]);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
    bwd_q_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  float* wp = reinterpret_cast<float*>(sm + Q_WP);
  float* vec = reinterpret_cast<float*>(sm + Q_VEC);
  float* kps = reinterpret_cast<float*>(sm + Q_KPS);
  float2* st = reinterpret_cast<float2*>(sm + Q_ST);
  float* red = reinterpret_cast<float*>(sm + Q_TA);
  unsigned char* ta = sm + Q_TA;
  unsigned char* tb = sm + Q_TB;
  const Shape& sh = a.sh;
  const int img = blockIdx.y, t0 = blockIdx.x * sh.per;
  const int ntl = min(sh.per, sh.ntiles - t0);
  const int cta = img * gridDim.x + blockIdx.x;
  const Ring ring{sm, reinterpret_cast<uint64_t*>(sm + Q_BAR), Q_STAGES,
                  BW_STAGE};
  // LN1's statistics, the front with q and v
  const Loads loads{&xmap, &wmap, img, t0, ntl, sh.nk, Q_CPS, 1,
                    {2, 0, 0}, {{1, 2, 0}, {0, 0, 0}, {0, 0, 0}}};
  load_wp(wp, a.o.w);
  load_wb(sm + Q_WB, a.o.w);
  load_tile(sm + Q_WPROJ, a.o.wproj);
  load_tile(sm + Q_WFC1, a.o.wfc1);
  load_tile(sm + Q_WFC2, a.o.wfc2);
  load_vecs(vec, a.o);
  {
    const float* kt = a.kptv + (size_t)img * EMB * M;
    for (int idx = threadIdx.x; idx < EMB * M; idx += THREADS) {
      const int e = idx / M, j = idx % M;
      const bf16 v = f2bf(kt[idx]);
      *reinterpret_cast<bf16*>(sm + Q_KA + sw(e, j)) = v;
      *reinterpret_cast<bf16*>(sm + Q_KB + sw(j, e)) = v;
    }
    if (threadIdx.x < M)
      kps[threadIdx.x] = a.kpsum[(size_t)img * M + threadIdx.x];
  }
  fence_proxy_async();
  ring_start(ring, loads);

  const int t = threadIdx.x & 3;
  float dkt[16], dks = 0.f, cols[6][2];
  zero(dkt);
  for (auto& c : cols) zero(c);
  int i = 0;
  for (int tl = 0; tl < ntl; ++tl) {
    const Rows rows(img, sh.n, TILE * (t0 + tl));
    bf16 *xnrow[2], *grow[2];
    rows.of(a.xn, sh.dim, xnrow);
    rows.of(a.gbuf, 4 * EMB, grow);
    ln1_stats(ring, loads, i, a.o.fmask, sh.dim, sh.fcount, st);
    float acc[2][32];  // q, v
    front(ring, loads, i, sh.nk, st, a.o.g1, a.o.b1, sh.dim, xnrow, acc);
    add_bias(acc[0], a.o.bkqv + EMB);
    add_bias(acc[1], a.o.bkqv + 2 * EMB);
    // the forward's recompute
    float qp[16], dinv[2] = {0.f, 0.f};
    prm_rows(acc[0], wp, qp);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dinv[hh] += qp[4 * j + 2 * hh] * kps[8 * j + 2 * t] +
                    qp[4 * j + 2 * hh + 1] * kps[8 * j + 2 * t + 1];
      dinv[hh] = 1.f / (quad_sum(dinv[hh]) + D_EPS);
    }
    float y[32];
    {
      uint32_t aq[2][4];
      pack_a<2>(aq, qp);
      zero(y);
      prod64<0, 2>(y, aq, sm + Q_KA);
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) y[k] *= dinv[(k >> 1) & 1];
    uint32_t yb[16];
    pairs_of<32>(yb, y);
    store_pairs(grow, 0, yb);
    float xb[32], mean2[2], rstd2[2];
    uint32_t h2b[16];
    {
      uint32_t ay[4][4];
      pairs_a<4>(ay, yb);
      float at[32];
      zero(at);
      prod64<1, 4>(at, ay, sm + Q_WPROJ);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        at[k] = rnd(acc[1][k]) +
                (at[k] + vec[V_BPROJ + 8 * (k >> 2) + 2 * t + (k & 1)]);
      ln2_stats(at, xb, mean2, rstd2);
      float h2[32];
      ln2_apply(xb, mean2, rstd2, vec, h2);
      pairs_of<32>(h2b, h2);
      store_pairs(grow, EMB, h2b);
    }
    float gp[32];
    uint32_t ab[16];
    {
      uint32_t ah[4][4];
      pairs_a<4>(ah, h2b);
      float hv[32];
      zero(hv);
      prod64<1, 4>(hv, ah, sm + Q_WFC1);
      float av[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float h = hv[k] + vec[V_BFC1 + 8 * (k >> 2) + 2 * t + (k & 1)];
        const float phi = 0.5f * (1.f + erff(h * 0.70710678118654752f));
        const float pdf = expf(-0.5f * h * h) * 0.39894228040143268f;
        gp[k] = phi + h * pdf;
        av[k] = h * phi;
      }
      pairs_of<32>(ab, av);
      store_pairs(grow, 2 * EMB, ab);
    }
    // the MLP backward: dhh = (do . Wfc2^T) gelu'(hh)
    uint32_t dop[16];
    {
      const bf16* drow[2];
      rows.of<const bf16>(a.dout, EMB, drow);
      load_pairs(dop, drow);
    }
    float do32[32];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        do32[4 * j + 2 * hh] = lo_f(dop[2 * j + hh]);
        do32[4 * j + 2 * hh + 1] = hi_f(dop[2 * j + hh]);
      }
    col_sum(cols[0], do32, rows.valid);
    float dhh[32];
    {
      uint32_t ad[4][4];
      pairs_a<4>(ad, dop);
      zero(dhh);
      prod64<0, 4>(dhh, ad, sm + Q_WFC2);
#pragma unroll
      for (int k = 0; k < 32; ++k) dhh[k] *= gp[k];
    }
    col_sum(cols[1], dhh, rows.valid);
    uint32_t dhb[16];
    pairs_of<32>(dhb, dhh);
    store_pairs(grow, 3 * EMB, dhb);
    // dh2 = dhh . Wfc1^T; LN2's VJP with the residual
    float dat[32];
    {
      uint32_t ad[4][4];
      pairs_a<4>(ad, dhb);
      float dh2[32];
      zero(dh2);
      prod64<0, 4>(dh2, ad, sm + Q_WFC1);
      float xh[32], gd[32], m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int hh = (k >> 1) & 1;
        xh[k] = (xb[k] - mean2[hh]) * rstd2[hh];
        gd[k] = dh2[k] * vec[V_G2 + 8 * (k >> 2) + 2 * t + (k & 1)];
        m1[hh] += gd[k];
        m2[hh] += gd[k] * xh[k];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        m1[hh] = quad_sum(m1[hh]) / EMB;
        m2[hh] = quad_sum(m2[hh]) / EMB;
      }
      float p[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int hh = (k >> 1) & 1;
        p[k] = dh2[k] * xh[k];
        dat[k] = do32[k] + (gd[k] - m1[hh] - xh[k] * m2[hh]) * rstd2[hh];
      }
      col_sum(cols[2], p, rows.valid);
      col_sum(cols[3], dh2, rows.valid);
    }
    col_sum(cols[4], dat, rows.valid);
    uint32_t datb[16];
    pairs_of<32>(datb, dat);
    // dy = dattn . Wproj^T
    float dy[32];
    {
      uint32_t ad[4][4];
      pairs_a<4>(ad, datb);
      zero(dy);
      prod64<0, 4>(dy, ad, sm + Q_WPROJ);
    }
    // the normaliser and the q path
    float dd[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      dd[(k >> 1) & 1] += dy[k] * y[k];
      dy[k] = rnd(dy[k] * dinv[(k >> 1) & 1]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) dd[hh] = -quad_sum(dd[hh]) * dinv[hh];
    uint32_t dyb[16];
    pairs_of<32>(dyb, dy);
    float dqp[16];
    {
      uint32_t ad[4][4];
      pairs_a<4>(ad, dyb);
      zero(dqp);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma_rs32<0>(dqp, ad[s], kdesc(sm + Q_KB, s), 1);
      wait_all();
      fence_acc(dqp);
    }
    // dkptv += dy_pre^T bf16(qp); dkpsum += dd qp
    put_pairs(ta, dyb, rows.valid);
    put_t32(tb, qp, rows.valid);
    fence_proxy_async();
    __syncthreads();
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss32<1, 0>(dkt, mdesc(ta, kk), kdesc(tb, kk), 1);
    wait_all();
    fence_acc(dkt);
    __syncthreads();
    {
      float p[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) p[k] = dd[(k >> 1) & 1] * qp[k];
      dks += feat_sum(p, rows.valid);
    }
    // dq = bf16(dwtx) . wb - q sum(dwtx), dwtx = qp (dqp + dd kpsum)
    float dq[32];
    {
      float dw[16], sdw[2] = {0.f, 0.f};
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int hh = (k >> 1) & 1;
        const float dq_ = dqp[k] + dd[hh] * kps[8 * (k >> 2) + 2 * t + (k & 1)];
        dw[k] = qp[k] * dq_;
        sdw[hh] += dw[k];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) sdw[hh] = quad_sum(sdw[hh]);
      uint32_t aw[2][4];
      pack_a<2>(aw, dw);
      zero(dq);
      prod64<1, 2>(dq, aw, sm + Q_WB);
#pragma unroll
      for (int k = 0; k < 32; ++k) dq[k] -= acc[0][k] * sdw[(k >> 1) & 1];
    }
    col_sum(cols[5], dq, rows.valid);
    // dqv = [dq | dattn] (bf16): the dWkqv operand and dxn1's for
    // bwd_kv_kernel, with the rows' LN1 statistics
    uint32_t dqb[16];
    pairs_of<32>(dqb, dq);
    {
      bf16* drow[2];
      rows.of(a.dbuf, 4 * EMB, drow);
      store_pairs(drow, 2 * EMB, dqb);
      store_pairs(drow, 3 * EMB, datb);
    }
    if (t == 0) {
      const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (rows.valid[hh]) a.rstat[rows.row[hh]] = st[r0 + 8 * hh];
    }
  }
  // the CTA's partials
  float* prow = a.part + (size_t)cta * Q_SUMS;
#pragma unroll
  for (int q = 0; q < 6; ++q) warps_cols(cols[q], red, prow + q * EMB);
  float* kout = a.kpart + (size_t)cta * PART;
  store_emb_m(kout, dkt);
  warps_feats(dks, red, kout + EMB * M);
}

// stages of x and k, v, q (the dx pass takes both halves)
constexpr int KV_STAGES = 2, KV_STAGE = 4 * BOX, KV_RING = KV_STAGES * KV_STAGE;
constexpr int KV_DA = KV_RING, KV_DB = KV_DA + BOX, KV_WB = KV_DB + BOX / 2;
constexpr int KV_WP = KV_WB + BOX / 2, KV_DKS = KV_WP + WP_BYTES;
constexpr int KV_ST = KV_DKS + M * 4, KV_RED = KV_ST + 64 * 8;
constexpr int KV_BAR = KV_RED + RED_BYTES;
constexpr size_t KV_SMEM = 1024 + KV_BAR + KV_STAGES * 8;

__global__ void __launch_bounds__(THREADS, 2)
    bwd_kv_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm = smem_1k(smem_raw);
  float* wp = reinterpret_cast<float*>(sm + KV_WP);
  float* dks = reinterpret_cast<float*>(sm + KV_DKS);
  float2* st = reinterpret_cast<float2*>(sm + KV_ST);
  float* red = reinterpret_cast<float*>(sm + KV_RED);
  const Shape& sh = a.sh;
  const int img = blockIdx.y, t0 = blockIdx.x * sh.per;
  const int ntl = min(sh.per, sh.ntiles - t0);
  const int cta = img * gridDim.x + blockIdx.x;
  const int passes = a.dx != nullptr ? 3 : 2;
  const Ring ring{sm, reinterpret_cast<uint64_t*>(sm + KV_BAR), KV_STAGES,
                  KV_STAGE};
  // the front with k and v, the sums of LN1's VJP, with dx the dx pass
  const Loads loads{&xmap, &wmap, img, t0, ntl, sh.nk, 0, passes, {2, 3, 3},
                    {{0, 2, 0}, {0, 2, 1}, {0, 2, 1}}};
  load_wp(wp, a.o.w);
  load_wb(sm + KV_WB, a.o.w);
  image_sums(a.kpart + (size_t)img * a.ctas1 * PART, a.ctas1, sm + KV_DA,
             sm + KV_DB, dks, nullptr, nullptr);
  fence_proxy_async();
  ring_start(ring, loads);

  const int t = threadIdx.x & 3;
  float cols[2][2];
  for (auto& c : cols) zero(c);
  bf16* const noxn[2] = {nullptr, nullptr};
  int i = 0;
  for (int tl = 0; tl < ntl; ++tl) {
    const Rows rows(img, sh.n, TILE * (t0 + tl));
    // LN1's statistics, from bwd_q_kernel
    {
      const int r0 = 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
      __syncthreads();
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (t == 0)
          st[r0 + 8 * hh] = rows.valid[hh] ? a.rstat[rows.row[hh]]
                                           : make_float2(0.f, 1.f);
      __syncthreads();
    }
    float acc[2][32];  // k, v
    front(ring, loads, i, sh.nk, st, a.o.g1, a.o.b1, sh.dim, noxn, acc);
    add_bias(acc[0], a.o.bkqv);
    add_bias(acc[1], a.o.bkqv + 2 * EMB);
    float kp[16];
    prm_rows(acc[0], wp, kp);
    // dv = bf16(kp) . bf16(dkptv)^T
    float dv[32];
    {
      uint32_t ak[2][4];
      pack_a<2>(ak, kp);
      zero(dv);
      prod64<0, 2>(dv, ak, sm + KV_DA);
    }
    // dkp = bf16(v) . bf16(dkptv) + dkpsum; dwtx = kp dkp
    float dw[16], sdw[2] = {0.f, 0.f};
    {
      uint32_t av[4][4];
      pack_a<4>(av, acc[1]);
      float dkp[16];
      zero(dkp);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        mma_rs32<0>(dkp, av[s], kdesc(sm + KV_DB, s), 1);
      wait_all();
      fence_acc(dkp);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        dw[k] = kp[k] * (dkp[k] + dks[8 * (k >> 2) + 2 * t + (k & 1)]);
        sdw[(k >> 1) & 1] += dw[k];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) sdw[hh] = quad_sum(sdw[hh]);
    // dk = bf16(dwtx) . wb - k sum(dwtx)
    float dkk[32];
    {
      uint32_t aw[2][4];
      pack_a<2>(aw, dw);
      zero(dkk);
      prod64<1, 2>(dkk, aw, sm + KV_WB);
#pragma unroll
      for (int k = 0; k < 32; ++k) dkk[k] -= acc[0][k] * sdw[(k >> 1) & 1];
    }
    col_sum(cols[0], dkk, rows.valid);
    col_sum(cols[1], dv, rows.valid);
    uint32_t dkb[16], dvb[16];
    pairs_of<32>(dkb, dkk);
    pairs_of<32>(dvb, dv);
    {
      bf16* drow[2];
      rows.of(a.dbuf, 4 * EMB, drow);
      store_pairs(drow, 0, dkb);
      store_pairs(drow, EMB, dvb);
    }
    uint32_t akv[8][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool v = rows.valid[k & 1];
        akv[s][k] = v ? dkb[4 * s + k] : 0u;
        akv[4 + s][k] = v ? dvb[4 * s + k] : 0u;
      }
    // dxn1's A operand, [dq | dattn] as bwd_q_kernel left it
    uint32_t aq[8][4];
    {
      const bf16* drow[2];
      rows.of<const bf16>(a.dbuf, 4 * EMB, drow);
      uint32_t dq[16], dat[16];
      load_pairs(dq, drow, 2 * EMB);
      load_pairs(dat, drow, 3 * EMB);
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          aq[s][k] = dq[4 * s + k];
          aq[4 + s][k] = dat[4 * s + k];
        }
    }
    float2 mq[2], mkv[2];
    ln1_sums(ring, loads, i, sh.nk, aq, akv, st, a.o.g1, a.o.fmask, sh.dim,
             sh.fcount,
             a.lnpart + (size_t)(img * sh.ntiles + t0 + tl) * 2 * sh.dim, red,
             mq, mkv);
    if (a.dx != nullptr) {
      bf16* dxrow[2];
      rows.of(a.dx, sh.dim, dxrow);
      dx_pass(ring, loads, i, sh.nk, aq, akv, mq, mkv, st, a.o.g1, a.o.fmask,
              sh.dim, dxrow);
    }
  }
  float* prow = a.part + (size_t)cta * KV_SUMS;
#pragma unroll
  for (int q = 0; q < 2; ++q) warps_cols(cols[q], red, prow + q * EMB);
}

// dWkqv from the product's partials [parts][dim][256] ([dk | dv | dq |
// dattn] columns), added in index order and assembled: k from dk, q from
// dq, v = dattn's + dv's, rounded once
__global__ void assemble_dw_kernel(const float* __restrict__ part, int parts,
                                   int dim, bf16* __restrict__ dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= dim * KQV) return;
  const int r = idx / KQV, c = idx % KQV;
  const float* p = part + (size_t)r * 4 * EMB;
  const size_t plane = (size_t)dim * 4 * EMB;
  const int c0 = c < EMB ? c : c < 2 * EMB ? c + EMB : c + EMB;
  float s = 0.f;
  for (int z = 0; z < parts; ++z) s += p[z * plane + c0];
  if (c >= 2 * EMB) {
    float s2 = 0.f;
    for (int z = 0; z < parts; ++z) s2 += p[z * plane + c - EMB];
    s += s2;
  }
  dw[idx] = f2bf(s);
}

struct Grads {
  float *dg1, *db1;
  bf16 *dwkqv, *dbkqv, *dwproj, *dbproj;
  float *dg2, *db2;
  bf16 *dwfc1, *dbfc1, *dwfc2, *dbfc2;
};

struct Sums {
  const float* w;     // [3][wstride][64 * 64]: dWfc2, dWfc1, dWproj
  const float* q;     // [qparts][Q_SUMS]
  const float* kv;    // [kvparts][KV_SUMS]
  const float* ln;    // [lnparts][2][dim]
  int wparts, wstride, qparts, kvparts, lnparts, dim;
};

// sum over p < n of part[p * stride], in index order (32 loads in flight)
__device__ __forceinline__ float sum_parts(const float* part, int n,
                                           size_t stride) {
  float s = 0.f;
  int p = 0;
  for (; p + 32 <= n; p += 32) {
    float v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = part[(p + j) * stride];
#pragma unroll
    for (int j = 0; j < 32; ++j) s += v[j];
  }
  for (; p < n; ++p) s += part[p * stride];
  return s;
}

constexpr int FIN_THREADS = 256, FIN_SMALL = 3 * WW + 8 * EMB;
constexpr int LN_COLS = 8, LN_SEGS = FIN_THREADS / LN_COLS;

// The small gradients from the partials, each in index order: blocks
// before `small_blocks` a thread an output (the three 64 x 64 weight
// gradients, then the column sums: dbfc2, dbfc1, dg2, db2, dbproj, and
// dbkqv's k, q and v parts, v = dattn's + dv's); the rest dLN1's, 8 columns
// a block, each column's tile partials in 32 contiguous segments added
// one after the other
__global__ void __launch_bounds__(FIN_THREADS)
    finish_kernel(Sums sm, Grads g, int small_blocks) {
  const int tid = threadIdx.x;
  if ((int)blockIdx.x < small_blocks) {
    const int idx = blockIdx.x * FIN_THREADS + tid;
    if (idx < 3 * WW) {
      const int q = idx / WW, e = idx % WW;
      const float s = sum_parts(sm.w + (size_t)q * sm.wstride * WW + e,
                                sm.wparts, WW);
      (q == 0 ? g.dwfc2 : q == 1 ? g.dwfc1 : g.dwproj)[e] = f2bf(s);
    } else if (idx < FIN_SMALL) {
      const int v = (idx - 3 * WW) / EMB, c = (idx - 3 * WW) % EMB;
      if (v < 5) {
        const float s = sum_parts(sm.q + v * EMB + c, sm.qparts, Q_SUMS);
        if (v == 0) g.dbfc2[c] = f2bf(s);
        if (v == 1) g.dbfc1[c] = f2bf(s);
        if (v == 2) g.dg2[c] = s;
        if (v == 3) g.db2[c] = s;
        if (v == 4) g.dbproj[c] = f2bf(s);
      } else if (v == 5) {
        g.dbkqv[c] = f2bf(sum_parts(sm.kv + c, sm.kvparts, KV_SUMS));
      } else if (v == 6) {
        g.dbkqv[EMB + c] =
            f2bf(sum_parts(sm.q + 5 * EMB + c, sm.qparts, Q_SUMS));
      } else {
        const float s = sum_parts(sm.q + 4 * EMB + c, sm.qparts, Q_SUMS);
        g.dbkqv[2 * EMB + c] =
            f2bf(s + sum_parts(sm.kv + EMB + c, sm.kvparts, KV_SUMS));
      }
    }
    return;
  }
  __shared__ float seg[FIN_THREADS];
  const int cols = 2 * sm.dim, c0 = (blockIdx.x - small_blocks) * LN_COLS;
  const int c = c0 + tid % LN_COLS, k = tid / LN_COLS;
  const int per = (sm.lnparts + LN_SEGS - 1) / LN_SEGS;
  const int p0 = min(sm.lnparts, k * per), p1 = min(sm.lnparts, p0 + per);
  seg[tid] = c < cols ? sum_parts(sm.ln + (size_t)p0 * cols + c, p1 - p0,
                                  cols)
                      : 0.f;
  __syncthreads();
  if (tid < LN_COLS && c < cols) {
    float s = 0.f;
    for (int j = 0; j < LN_SEGS; ++j) s += seg[j * LN_COLS + tid];
    (c < sm.dim ? g.dg1 : g.db1)[c < sm.dim ? c : c - sm.dim] = s;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

#define CK(expr)                                  \
  do {                                            \
    const cudaError_t err_ = (expr);              \
    if (err_ != cudaSuccess) return (int)err_;    \
  } while (0)

// x [B][N][dim] in boxes of 64 columns x 64 tokens of one image (zero past
// dim and N), 128-byte swizzle; Wkqv [dim][192] in [64][64] boxes
static cudaError_t maps(CUtensorMap& xm, CUtensorMap& wm, const Ops& o,
                        const Shape& sh) {
  const cuuint64_t dims[3] = {(cuuint64_t)sh.dim, (cuuint64_t)sh.n,
                              (cuuint64_t)sh.b};
  const cuuint64_t strides[2] = {(cuuint64_t)sh.dim * 2,
                                 (cuuint64_t)sh.n * sh.dim * 2};
  const cuuint32_t box[3] = {64, TILE, 1};
  cudaError_t err = uvc::encode_map(xm, 3, o.x, dims, strides, box,
                                    CU_TENSOR_MAP_SWIZZLE_128B,
                                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (err == cudaSuccess)
    err = uvc::matrix_map(wm, o.wkqv, sh.dim, KQV, KQV, 64, 64);
  return err;
}

Shape shape(int b, int n, int dim, int per, float fcount) {
  return Shape{b, n, dim, (n + TILE - 1) / TILE, (dim + 63) / 64, per, fcount};
}

dim3 grid(const Shape& sh) {
  return dim3((sh.ntiles + sh.per - 1) / sh.per, sh.b);
}

int forward(const Ops& o, bf16* out, float* kptv, float* kpsum, float* qp,
            bf16* v, float* part, int b, int n, int dim, int per1, int per2,
            float fcount, cudaStream_t s) {
  FwdArgs a{};
  a.o = o;
  a.out = out;
  a.kptv = kptv;
  a.kpsum = kpsum;
  a.qp = qp;
  a.v = v;
  a.part = part;
  a.sh = shape(b, n, dim, per1, fcount);
  a.ctas1 = grid(a.sh).x;
  CUtensorMap xm, wm;
  CK(maps(xm, wm, o, a.sh));
  CK(uvc::smem_once<fwd_sums_kernel>(F1_SMEM));
  fwd_sums_kernel<<<grid(a.sh), THREADS, F1_SMEM, s>>>(xm, wm, a);
  CK(cudaGetLastError());
  a.sh.per = per2;
  CK(uvc::smem_once<fwd_apply_kernel>(F2_SMEM));
  fwd_apply_kernel<<<grid(a.sh), THREADS, F2_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// part[z] = A[rows of split z]^T B[rows of split z] (f32, [m][n]) for A
// [rows][m] (row stride lda) and B [rows][n] (ldb) on gemm_wg.cuh, the rows
// split into about `splits` runs of 64-row k-tiles; returns the partials'
// count (1: one run over all the rows) or a negative CUDA error
int product(const bf16* a, int lda, int m, const bf16* b, int ldb, int n,
            int rows, int splits, float* part, cudaStream_t s) {
  uvc::GemmArgs p = {};
  p.M = m;
  p.N = n;
  p.K = rows;
  p.out32 = part;
  int parts = 1;
  if (splits > 1) {
    const int ktiles = (rows + uvc::GW_BK - 1) / uvc::GW_BK;
    p.kchunk = ((ktiles + splits - 1) / splits) * uvc::GW_BK;
    parts = (rows + p.kchunk - 1) / p.kchunk;
  }
  CUtensorMap am, bm;
  cudaError_t err = uvc::matrix_map(am, a, rows, m, lda, 64, uvc::GW_BK);
  if (err == cudaSuccess)
    err = uvc::matrix_map(bm, b, rows, n, ldb, 64, uvc::GW_BK);
  if (err == cudaSuccess)
    err = uvc::smem_once<uvc::gemm_wg_kernel<uvc::EPI_F32, 128, true, false>>(
        uvc::GemmWg<128>::SMEM);
  if (err != cudaSuccess) return -(int)err;
  const dim3 g((n + 127) / 128, (m + uvc::GW_BM - 1) / uvc::GW_BM, parts);
  uvc::gemm_wg_kernel<uvc::EPI_F32, 128, true, false>
      <<<g, uvc::GW_THREADS, uvc::GemmWg<128>::SMEM, s>>>(am, bm, p);
  err = cudaGetLastError();
  return err == cudaSuccess ? parts : -(int)err;
}

int backward(const Ops& o, const float* kptv, const float* kpsum,
             const bf16* dout, bf16* dx, const Grads& g, bf16* xn,
             bf16* dbuf, bf16* gbuf, float* kpart, float* part1,
             float* part2, float* lnpart, float* dpart, float* wpart,
             float* rstat, int b,
             int n, int dim, int per1, int per2, int splits_kqv,
             int splits_w, float fcount, cudaStream_t s) {
  BwdArgs a{};
  a.o = o;
  a.kptv = kptv;
  a.kpsum = kpsum;
  a.dout = dout;
  a.dx = dx;
  a.xn = xn;
  a.dbuf = dbuf;
  a.gbuf = gbuf;
  a.kpart = kpart;
  a.part = part1;
  a.lnpart = lnpart;
  a.rstat = reinterpret_cast<float2*>(rstat);
  a.sh = shape(b, n, dim, per1, fcount);
  const int c1 = grid(a.sh).x, tiles = b * a.sh.ntiles;
  a.ctas1 = c1;
  CUtensorMap xm, wm;
  CK(maps(xm, wm, o, a.sh));
  CK(uvc::smem_once<bwd_q_kernel>(Q_SMEM));
  bwd_q_kernel<<<grid(a.sh), THREADS, Q_SMEM, s>>>(xm, wm, a);
  CK(cudaGetLastError());
  a.part = part2;
  a.sh.per = per2;
  const int c2 = grid(a.sh).x;
  CK(uvc::smem_once<bwd_kv_kernel>(KV_SMEM));
  bwd_kv_kernel<<<grid(a.sh), THREADS, KV_SMEM, s>>>(xm, wm, a);
  CK(cudaGetLastError());
  // dWkqv = xn^T [dk | dv | dq | dattn]; dWfc2 = a^T do, dWfc1 = h2^T dhh,
  // dWproj = bf16(y)^T dattn, each split over the rows
  const int rows = b * n, ld = 4 * EMB;
  const int kparts = product(xn, dim, dim, dbuf, ld, ld, rows, splits_kqv,
                             dpart, s);
  if (kparts < 0) return -kparts;
  const bf16* wa[3] = {gbuf + 2 * EMB, gbuf + EMB, gbuf};
  const bf16* wb[3] = {dout, gbuf + 3 * EMB, dbuf + 3 * EMB};
  int wparts = 1;
  for (int q = 0; q < 3; ++q) {
    wparts = product(wa[q], ld, EMB, wb[q], q ? ld : EMB, EMB, rows, splits_w,
                     wpart + (size_t)q * splits_w * WW, s);
    if (wparts < 0) return -wparts;
  }
  assemble_dw_kernel<<<(dim * KQV + 255) / 256, 256, 0, s>>>(dpart, kparts,
                                                               dim, g.dwkqv);
  CK(cudaGetLastError());
  // the small gradients
  const Sums sums{wpart, part1, part2, lnpart, wparts,
                  splits_w, b * c1, b * c2, tiles, dim};
  const int small = (FIN_SMALL + FIN_THREADS - 1) / FIN_THREADS;
  const int lnb = (2 * dim + LN_COLS - 1) / LN_COLS;
  finish_kernel<<<small + lnb, FIN_THREADS, 0, s>>>(sums, g, small);
  return (int)cudaGetLastError();
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

}  // namespace performer
}  // namespace uvc

// Both return 0 or the first CUDA error code.  All buffers are device
// pointers: the operands x [B, N, dim] bf16; g1, b1, fmask [dim] f32;
// wkqv [dim, 192], bkqv [192], wproj / wfc1 / wfc2 [64, 64] (stored (in,
// out)), bproj / bfc1 / bfc2 [64] bf16; w [32, 64] f32; g2, b2 [64] f32.
// per1 / per2: the 64-token tiles a CTA of the first / second kernel
// walks (ops/performer.py::_tile_split), each image's ceil(N / 64) tiles
// in contiguous runs.
//
// Forward outputs: out [B, N, 64] bf16, kptv [B, 64, 32] and kpsum [B, 32]
// f32; scratch qp [B N, 32] f32, v [B N, 64] bf16, part [B ctas1, 2080]
// f32 (ctas1 = ceil(ceil(N / 64) / per1)).
extern "C" int uvc_performer(const void* x, const void* g1, const void* b1,
                             const void* wkqv, const void* bkqv, const void* w,
                             const void* fmask, const void* wproj,
                             const void* bproj, const void* g2, const void* b2,
                             const void* wfc1, const void* bfc1,
                             const void* wfc2, const void* bfc2, void* out,
                             void* kptv, void* kpsum, void* qp, void* v,
                             void* part, int b, int n, int dim, int per1,
                             int per2, float fcount, void* stream) {
  using namespace uvc::performer;
  return forward(ops(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2,
                     wfc1, bfc1, wfc2, bfc2),
                 static_cast<bf16*>(out), static_cast<float*>(kptv),
                 static_cast<float*>(kpsum), static_cast<float*>(qp),
                 static_cast<bf16*>(v), static_cast<float*>(part), b, n, dim,
                 per1, per2, fcount, static_cast<cudaStream_t>(stream));
}

// The backward takes kptv, kpsum and dout [B, N, 64] bf16, and writes the
// gradients of the operands but w and fmask, each in its operand's type;
// dx may be null (no dx: its passes are left out).  Scratch: xn [B N,
// dim], dbuf and gbuf [B N, 256] bf16; kpart [B ctas1, 2080], part1 [B
// ctas1, 384], part2 [B ctas2, 128], lnpart [B ceil(N / 64), 2 dim],
// dpart [splits_kqv, dim, 256], wpart [3, splits_w, 64 * 64] and rstat
// [B N, 2] f32.
// splits_kqv, splits_w: the runs of rows of the dWkqv and of the 64 x 64
// weight-gradient products (ops/attention.py::_weight_grad_splits).
extern "C" int uvc_performer_bwd(
    const void* x, const void* g1, const void* b1, const void* wkqv,
    const void* bkqv, const void* w, const void* fmask, const void* wproj,
    const void* bproj, const void* g2, const void* b2, const void* wfc1,
    const void* bfc1, const void* wfc2, const void* bfc2, const void* kptv,
    const void* kpsum, const void* dout, void* dx, void* dg1, void* db1,
    void* dwkqv, void* dbkqv, void* dwproj, void* dbproj, void* dg2,
    void* db2, void* dwfc1, void* dbfc1, void* dwfc2, void* dbfc2, void* xn,
    void* dbuf, void* gbuf, void* kpart, void* part1, void* part2,
    void* lnpart, void* dpart, void* wpart, void* rstat, int b, int n,
    int dim, int per1,
    int per2, int splits_kqv, int splits_w, float fcount, void* stream) {
  using namespace uvc::performer;
  const Grads g = {static_cast<float*>(dg1),   static_cast<float*>(db1),
                   static_cast<bf16*>(dwkqv),  static_cast<bf16*>(dbkqv),
                   static_cast<bf16*>(dwproj), static_cast<bf16*>(dbproj),
                   static_cast<float*>(dg2),   static_cast<float*>(db2),
                   static_cast<bf16*>(dwfc1),  static_cast<bf16*>(dbfc1),
                   static_cast<bf16*>(dwfc2),  static_cast<bf16*>(dbfc2)};
  return backward(
      ops(x, g1, b1, wkqv, bkqv, w, fmask, wproj, bproj, g2, b2, wfc1, bfc1,
          wfc2, bfc2),
      static_cast<const float*>(kptv), static_cast<const float*>(kpsum),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx), g,
      static_cast<bf16*>(xn), static_cast<bf16*>(dbuf),
      static_cast<bf16*>(gbuf), static_cast<float*>(kpart),
      static_cast<float*>(part1), static_cast<float*>(part2),
      static_cast<float*>(lnpart), static_cast<float*>(dpart),
      static_cast<float*>(wpart), static_cast<float*>(rstat), b, n, dim, per1,
      per2, splits_kqv, splits_w,
      fcount, static_cast<cudaStream_t>(stream));
}
