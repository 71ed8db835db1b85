// A bf16 GEMM for Hopper on TMA and wgmma, with the epilogues of the
// sublayers' products:
//   out[M, N] = epilogue(A . B),  f32 accumulators,
// in three operand layouts (template flags; wgmma reads each as stored):
//   A_MN = false: A stored [M][K] (K-major);  A_MN = true: A stored [K][M]
//                 (MN-major, wgmma's transposed A: A^T . B, the weight
//                 gradients over the B*N rows)
//   B_K = false:  B stored [K][N] (MN-major: the weight stored (in, out) as
//                 the JAX package stores it);  B_K = true: B stored [N][K]
//                 (K-major: . W^T)
// The two products of K1 and of A7's forward and the five of the sublayer
// backwards A2 and A7 (attention.cu), the fc1 and fc2 of K2 and K3 and
// the products of their backwards A6 and A4 (mlp.cu: dW1, dW2 and dmi
// here, h and dam0 in one tile by gemm_act_bwd_kernel below) and the
// performer backward's dWkqv (performer.cu) run it.
//
// Epilogues (a template parameter; common.cuh's Epilogue values, in f32 in
// the Pallas bodies' order, one rounding to bf16):
//   EPI_BIAS      out = bf16(acc + bias)              (qkv, A7's projection)
//   EPI_GELU_MASK out = bf16(gelu_erf(acc + bias) * mask), mask null: all
//                 ones                                (K2's fc1)
//   EPI_RESID     out = bf16(resid + (acc + bias))    (K1's projection, K2's
//                                                      fc2)
//   EPI_BLEND     out = bf16(d1 (resid + (acc + bias)) + d0 xin), d = p.d
//                 read on the device                  (K3's fc2)
//   EPI_F32       out32 = acc                         (d a_in; split partials)
//   EPI_F32_MASK  out32 = acc, out = bf16(acc * mask) (do . Wproj^T)
//   EPI_SCALE     out = bf16(acc * d[1]), or bf16(acc) when d is null
// Split over K (kchunk > 0, a multiple of 64, EPI_F32 only): CTA z of the
// grid sums rows [z kchunk, (z + 1) kchunk) of K into its f32 partial at
// out32 + z M N, for launch_reduce to add in index order after it: the
// weight gradients, whose few output tiles would otherwise leave most SMs
// idle over K = B*N.
//
// Design: one CTA per 128 x BN output tile, BN = 256 for outputs at least
// GW_WIDE_N wide and 128 otherwise: two consumer warpgroups (64 rows
// each, m64nBNk16 with both operands in shared memory) and one producer
// warp whose one thread keeps TMA loads in flight through a ring of
// 64-deep k-tiles (A 128 x 64 and B 64 x BN, the 128-byte swizzle,
// completion on one mbarrier a stage; the consumers free a stage on
// another once its products are done, one wgmma group staying in flight):
// three stages of 32 KB and two CTAs an SM (112 registers a thread) at
// BN = 128, so that one CTA's epilogue runs while the other's products
// do; four of 48 KB and one CTA at BN = 256.  The boxes: a K-major operand
// as rows of 64 k (128 bytes), 128 (A) or BN (B) rows a box; an MN-major
// one as boxes of [64 k][64 m or n], one per 64 rows or columns of the
// tile.  TMA zero-fills rows and columns past M, N and K, so any M, and N
// and K multiples of 8 (16-byte rows), are taken; the stores are masked.
// The epilogue stages acc (+ bias) in f32 in the ring's shared memory,
// then reads the residual (and the blend's xin) and writes the outputs 16
// bytes a thread (32 for f32), a warp's accesses covering whole rows.
#pragma once

#include "hopper.cuh"

namespace uvc {

constexpr int GW_BM = 128, GW_BK = 64;
// outputs at least this wide take 256-column tiles
constexpr int GW_WIDE_N = 2048;
constexpr int GW_CONSUMERS = 2;                     // warpgroups of 64 rows
constexpr int GW_THREADS = GW_CONSUMERS * 128 + 32;  // + the producer warp

// A tile of BN (128 or 256) columns: the stages of the ring, the CTAs an
// SM holds, and the bytes of a stage: A [128 rows][64 k] and B as BN / 64
// boxes of [64 k][64 n]
template <int BN>
struct GemmWg {
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int CTAS = BN == 128 ? 2 : 1;
  static constexpr int A_BYTES = GW_BM * GW_BK * 2;
  static constexpr int B_BYTES = GW_BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE +
                                 2 * STAGES * 8;
};
constexpr int GW_BOX = GW_BK * 64 * 2;               // a B box, 8 KB

// gemm_act_bwd_kernel's epilogue, from the staged tiles h = acc_h + b1 and
// dam0 = acc_d (f32, rows of LDS = BN + 4) and the mask, in the Pallas
// body's order:
//   a = gelu_erf(h), am32 = a * mask, dam = d1 * dam0 (d1 = p.d[1], or 1),
//   dh = dam * mask * gelu'(h);  out = bf16(am32), out2 = bf16(dh),
// eight columns a thread; then the tile's column sums of dam * a (dmask)
// and dh (db1) over its 128 rows and its sum of dam0 * am32 (dd1), the
// threads' row groups and the warps added in a fixed order in red (shared
// memory after the tiles), into p.part: [tiles_m][N] dmask, then
// [tiles_m][N] db1; dd1's into p.out32 [tiles_m][tiles_n].
template <int BN>
__device__ __forceinline__ void act_bwd_epilogue(const float* tile,
                                                 const float* dtile,
                                                 float* red,
                                                 const GemmArgs& p, int m0,
                                                 int n0, int tid) {
  constexpr int LDS = BN + 4, CHUNKS = BN / 8;
  constexpr int GROUPS = GW_CONSUMERS * 128 / CHUNKS;  // rows in parallel
  const float d1 = p.d != nullptr ? p.d[1] : 1.f;
  const int c = (tid % CHUNKS) * 8, g = tid / CHUNKS, col = n0 + c;
  float sm[8], sb[8], mk[8], sdd = 0.f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sm[e] = sb[e] = 0.f;
    mk[e] = 1.f;
  }
  if (col < p.N) {
    if (p.mask != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) mk[e] = bf2f(p.mask[col + e]);
    }
    for (int r = g; r < GW_BM && m0 + r < p.M; r += GROUPS) {
      const size_t off = (size_t)(m0 + r) * p.N + col;
      const float4 lo = *reinterpret_cast<const float4*>(tile + r * LDS + c);
      const float4 hi =
          *reinterpret_cast<const float4*>(tile + r * LDS + c + 4);
      const float4 dlo =
          *reinterpret_cast<const float4*>(dtile + r * LDS + c);
      const float4 dhi =
          *reinterpret_cast<const float4*>(dtile + r * LDS + c + 4);
      const float h[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      const float d0v[8] = {dlo.x, dlo.y, dlo.z, dlo.w,
                            dhi.x, dhi.y, dhi.z, dhi.w};
      float am[8], dh[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float hv = h[e];
        const float phi = 0.5f * (1.f + erff(hv * 0.70710678118654752f));
        const float pdf = expf(-0.5f * hv * hv) * 0.39894228040143268f;
        const float a = hv * phi;
        am[e] = a * mk[e];
        const float dam = d0v[e] * d1;
        dh[e] = dam * mk[e] * (phi + hv * pdf);
        sm[e] += dam * a;
        sb[e] += dh[e];
        sdd += d0v[e] * am[e];
      }
      *reinterpret_cast<uint4*>(p.out + off) =
          make_uint4(pack_f32(am[0], am[1]), pack_f32(am[2], am[3]),
                     pack_f32(am[4], am[5]), pack_f32(am[6], am[7]));
      *reinterpret_cast<uint4*>(p.out2 + off) =
          make_uint4(pack_f32(dh[0], dh[1]), pack_f32(dh[2], dh[3]),
                     pack_f32(dh[4], dh[5]), pack_f32(dh[6], dh[7]));
    }
  }
  // red: [GROUPS][2][BN] row-group sums, then the 8 warps' dd1 sums
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[(2 * g) * BN + c + e] = sm[e];
    red[(2 * g + 1) * BN + c + e] = sb[e];
  }
  sdd = warp_sum(sdd);
  if ((tid & 31) == 0) red[2 * GROUPS * BN + (tid >> 5)] = sdd;
  asm volatile("bar.sync 1, %0;\n" ::"n"(GW_CONSUMERS * 128) : "memory");
  const size_t plane = (size_t)gridDim.y * p.N;
  for (int j = tid; j < 2 * BN; j += GW_CONSUMERS * 128) {
    const int which = j / BN, cc = j % BN;
    if (n0 + cc >= p.N) continue;
    float v = red[which * BN + cc];
    for (int gg = 1; gg < GROUPS; ++gg) v += red[(2 * gg + which) * BN + cc];
    p.part[which * plane + (size_t)blockIdx.y * p.N + n0 + cc] = v;
  }
  if (tid == 0) {
    float v = red[2 * GROUPS * BN];
#pragma unroll
    for (int w = 1; w < GW_CONSUMERS * 4; ++w) v += red[2 * GROUPS * BN + w];
    p.out32[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = v;
  }
}

// Maps: a K-major A in boxes of 64 k x 128 rows, an MN-major A in boxes
// of 64 m x 64 k; a K-major B in boxes of 64 k x BN rows, an MN-major B in
// boxes of 64 n x 64 k.
template <int EPI, int BN, bool A_MN, bool B_K>
static __global__ void __launch_bounds__(GW_THREADS, GemmWg<BN>::CTAS)
    gemm_wg_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap bmap, GemmArgs p) {
  typedef GemmWg<BN> G;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE);
  uint64_t* empty = full + G::STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * GW_BM, n0 = blockIdx.x * BN;
  // this CTA's k-tiles: all of K, or its chunk of the split
  const int all = (p.K + GW_BK - 1) / GW_BK;
  const int kt0 = p.kchunk ? blockIdx.z * (p.kchunk / GW_BK) : 0;
  const int ktiles = p.kchunk ? max(0, min(all - kt0, p.kchunk / GW_BK))
                              : all;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < G::STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, GW_CONSUMERS * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == GW_CONSUMERS) {
    // producer: stage kt % STAGES holds k-tile kt once the products of
    // the tile before it there are done
    if (tid == GW_CONSUMERS * 128) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % G::STAGES, k0 = (kt0 + kt) * GW_BK;
        if (kt >= G::STAGES) mbar_wait(empty + st, (kt / G::STAGES - 1) & 1);
        unsigned char* a = ring + st * G::STAGE;
        unsigned char* b = a + G::A_BYTES;
        mbar_expect_tx(full + st, G::STAGE);
        if (A_MN) {
          tma_load_2d(a, &amap, full + st, m0, k0);
          tma_load_2d(a + G::A_BYTES / 2, &amap, full + st, m0 + 64, k0);
        } else {
          tma_load_2d(a, &amap, full + st, k0, m0);
        }
        if (B_K) {
          tma_load_2d(b, &bmap, full + st, k0, n0);
        } else {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load_2d(b + j * GW_BOX, &bmap, full + st, n0 + 64 * j, k0);
        }
      }
    }
    return;
  }

  // consumer wg: rows m0 + 64 wg .. + 63, the first or second half of the
  // stage's A.  A K-major operand's rows are 128-byte lines in 1024-byte
  // swizzle atoms of 8 (k16 step kk at +32 kk bytes); an MN-major one's k
  // rows likewise, its 64-column boxes GW_BOX apart (k16 step kk at
  // +2048 kk bytes).
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt % G::STAGES;
    mbar_wait(full + st, (kt / G::STAGES) & 1);
    const unsigned char* a = ring + st * G::STAGE + wg * (G::A_BYTES / 2);
    const unsigned char* b = ring + st * G::STAGE + G::A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < GW_BK / 16; ++kk)
      wgmma_ss_n<BN, A_MN, !B_K>(
          acc,
          A_MN ? gmma_desc128(a + 2048 * kk, GW_BOX, 1024)
               : gmma_desc128(a + 32 * kk, 16, 1024),
          B_K ? gmma_desc128(b + 32 * kk, 16, 1024)
              : gmma_desc128(b + 2048 * kk, GW_BOX, 1024),
          1);
    wg_commit();
    // the previous k-tile's products are done: free its stage
    wg_wait1();
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (kt - 1) % G::STAGES);
    }
  }
  wg_wait();
  fence_acc(acc);

  // The epilogue goes through shared memory, so that its global loads and
  // stores are 16 bytes a thread and whole rows a warp: both warpgroups'
  // products done, the ring (every stage landed and read) holds acc
  // (+ bias) in f32, [128][BN + 4]; accumulator value 4 j + 2 hh (+ 1) is
  // row 16 warp + g + 8 hh of the warpgroup's 64, column 8 j + 2 t (+ 1).
  asm volatile("bar.sync 1, %0;\n" ::"n"(GW_CONSUMERS * 128) : "memory");
  constexpr int LDS = BN + 4;
  constexpr bool BIAS = EPI == EPI_BIAS || EPI == EPI_GELU_MASK ||
                       EPI == EPI_RESID || EPI == EPI_BLEND;
  static_assert(GW_BM * LDS * 4 <= G::STAGES * G::STAGE, "staging");
  float* tile = reinterpret_cast<float*>(ring);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wg * 64 + warp * 16 + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t, col = n0 + c;
      float b0 = 0.f, b1 = 0.f;
      if (BIAS && col < p.N) {
        b0 = bf2f(p.bias[col]);
        b1 = bf2f(p.bias[col + 1]);
      }
      *reinterpret_cast<float2*>(tile + r * LDS + c) =
          make_float2(acc[4 * j + 2 * hh] + b0, acc[4 * j + 2 * hh + 1] + b1);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(GW_CONSUMERS * 128) : "memory");
  float mul = 1.f, d0 = 0.f;
  if (EPI == EPI_SCALE && p.d != nullptr) mul = p.d[1];
  if (EPI == EPI_BLEND) {
    d0 = p.d[0];
    mul = p.d[1];
  }
  float* out32 = p.out32 + (size_t)blockIdx.z * p.M * p.N;
  // eight columns a thread
  for (int i = tid; i < GW_BM * (BN / 8); i += GW_CONSUMERS * 128) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int row = m0 + r, col = n0 + c;
    if (row >= p.M || col >= p.N) continue;
    const float4 lo = *reinterpret_cast<const float4*>(tile + r * LDS + c);
    const float4 hi =
        *reinterpret_cast<const float4*>(tile + r * LDS + c + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    const size_t off = (size_t)row * p.N + col;
    if (EPI == EPI_F32 || EPI == EPI_F32_MASK) {
      *reinterpret_cast<float4*>(out32 + off) = lo;
      *reinterpret_cast<float4*>(out32 + off + 4) = hi;
      if (EPI == EPI_F32) continue;
      if (p.mask != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= bf2f(p.mask[col + e]);
      }
    } else if (EPI == EPI_SCALE) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] *= mul;
    } else if (EPI == EPI_GELU_MASK) {
      // the exact erf GELU, then the mask, in common.cuh's order
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = v[e] * (0.5f * (1.f + erff(v[e] * 0.70710678118654752f)));
      if (p.mask != nullptr) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= bf2f(p.mask[col + e]);
      }
    } else if (EPI == EPI_RESID || EPI == EPI_BLEND) {
      const uint4 rv = *reinterpret_cast<const uint4*>(p.resid + off);
      const bf16* re = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = bf2f(re[e]) + v[e];
      if (EPI == EPI_BLEND) {
        // the gating blend in common.cuh's order, one rounding after it
        const uint4 xv = *reinterpret_cast<const uint4*>(p.xin + off);
        const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = mul * v[e] + d0 * bf2f(xe[e]);
      }
    }
    const uint4 o = make_uint4(pack_f32(v[0], v[1]), pack_f32(v[2], v[3]),
                               pack_f32(v[4], v[5]), pack_f32(v[6], v[7]));
    *reinterpret_cast<uint4*>(p.out + off) = o;
  }
}

template <int EPI, int BN, bool A_MN, bool B_K>
static cudaError_t run_gemm_wg(const GemmArgs& p, cudaStream_t s) {
  CUtensorMap amap, bmap;
  cudaError_t err =
      A_MN ? matrix_map(amap, p.a, p.K, p.M, p.M, 64, GW_BK)
           : matrix_map(amap, p.a, p.M, p.K, p.K, GW_BK, GW_BM);
  if (err == cudaSuccess)
    err = B_K ? matrix_map(bmap, p.w, p.N, p.K, p.K, GW_BK, BN)
              : matrix_map(bmap, p.w, p.K, p.N, p.N, 64, GW_BK);
  if (err == cudaSuccess)
    err = smem_once<gemm_wg_kernel<EPI, BN, A_MN, B_K>>(GemmWg<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + GW_BM - 1) / GW_BM,
                  p.kchunk ? (p.K + p.kchunk - 1) / p.kchunk : 1);
  gemm_wg_kernel<EPI, BN, A_MN, B_K>
      <<<grid, GW_THREADS, GemmWg<BN>::SMEM, s>>>(amap, bmap, p);
  return cudaGetLastError();
}

// out = epilogue(op(a) . op(w)) on the caller's stream: p.a [M][K] (or
// [K][M] with A_MN), p.w [K][N] (or [N][K] with B_K), 16-byte aligned, K
// and N (and M with A_MN) multiples of 8; p.bias [N] (EPI_BIAS,
// EPI_GELU_MASK, EPI_RESID, EPI_BLEND), p.resid [M][N] (EPI_RESID,
// EPI_BLEND), p.xin [M][N] and p.d [2] (EPI_BLEND), p.mask [N] or null
// (EPI_GELU_MASK, EPI_F32_MASK), p.d [2] or null (EPI_SCALE).  Every
// epilogue of common.cuh's Epilogue.
template <int EPI, bool A_MN = false, bool B_K = false>
static cudaError_t launch_gemm_wg(const GemmArgs& p, cudaStream_t s) {
  static_assert(EPI == EPI_BIAS || EPI == EPI_GELU_MASK || EPI == EPI_RESID ||
                    EPI == EPI_BLEND || EPI == EPI_F32 ||
                    EPI == EPI_F32_MASK || EPI == EPI_SCALE,
                "gemm_wg epilogue");
  return p.N >= GW_WIDE_N ? run_gemm_wg<EPI, 256, A_MN, B_K>(p, s)
                          : run_gemm_wg<EPI, 128, A_MN, B_K>(p, s);
}

// The MLP activation backward of A4 and A6 (mlp.cu) on two products of
// one 128 x 128 output tile over the same K = dm:
//   h = m_in . W1 + b1 (p.a [M][K], p.w = W1 [K][N], MN-major) and
//   dam0 = do . W2^T (p.a2 = do [M][K], p.w2 = W2 [N][K], K-major),
// both accumulated in registers (64 + 64 f32 a consumer thread), staged in
// f32 in shared memory and handed to act_bwd_epilogue, so that neither
// h nor dam0 leaves the tile.  gemm_wg_kernel's ring, producer and
// consumers with four boxes a stage (A1, B1, A2, B2: 64 KB), three stages,
// one CTA an SM.  Any M; N and K multiples of 8.
constexpr int AB_BN = 128, AB_STAGES = 3;
constexpr int AB_BOX = GW_BM * GW_BK * 2;            // 16 KB: an A or a B
constexpr int AB_STAGE = 4 * AB_BOX;
constexpr size_t AB_SMEM = 1024 + (size_t)AB_STAGES * AB_STAGE +
                           2 * AB_STAGES * 8;

static __global__ void __launch_bounds__(GW_THREADS, 1)
    gemm_act_bwd_kernel(const __grid_constant__ CUtensorMap a1map,
                      const __grid_constant__ CUtensorMap b1map,
                      const __grid_constant__ CUtensorMap a2map,
                      const __grid_constant__ CUtensorMap b2map,
                      GemmArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_1k(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + AB_STAGES * AB_STAGE);
  uint64_t* empty = full + AB_STAGES;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * GW_BM, n0 = blockIdx.x * AB_BN;
  const int ktiles = (p.K + GW_BK - 1) / GW_BK;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < AB_STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, GW_CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == GW_CONSUMERS) {
    if (tid == GW_CONSUMERS * 128) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % AB_STAGES, k0 = kt * GW_BK;
        if (kt >= AB_STAGES) mbar_wait(empty + st, (kt / AB_STAGES - 1) & 1);
        unsigned char* a1 = ring + st * AB_STAGE;
        mbar_expect_tx(full + st, AB_STAGE);
        tma_load_2d(a1, &a1map, full + st, k0, m0);
        tma_load_2d(a1 + AB_BOX, &b1map, full + st, n0, k0);
        tma_load_2d(a1 + AB_BOX + GW_BOX, &b1map, full + st, n0 + 64, k0);
        tma_load_2d(a1 + 2 * AB_BOX, &a2map, full + st, k0, m0);
        tma_load_2d(a1 + 3 * AB_BOX, &b2map, full + st, k0, n0);
      }
    }
    return;
  }

  float acc_h[AB_BN / 2], acc_d[AB_BN / 2];
#pragma unroll
  for (int i = 0; i < AB_BN / 2; ++i) acc_h[i] = acc_d[i] = 0.f;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int st = kt % AB_STAGES;
    mbar_wait(full + st, (kt / AB_STAGES) & 1);
    const unsigned char* a1 = ring + st * AB_STAGE + wg * (AB_BOX / 2);
    const unsigned char* b1 = ring + st * AB_STAGE + AB_BOX;
    const unsigned char* a2 = a1 + 2 * AB_BOX;
    const unsigned char* b2 = b1 + 2 * AB_BOX;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < GW_BK / 16; ++kk) {
      wgmma_ss_n<AB_BN, false, true>(
          acc_h, gmma_desc128(a1 + 32 * kk, 16, 1024),
          gmma_desc128(b1 + 2048 * kk, GW_BOX, 1024), 1);
      wgmma_ss_n<AB_BN, false, false>(
          acc_d, gmma_desc128(a2 + 32 * kk, 16, 1024),
          gmma_desc128(b2 + 32 * kk, 16, 1024), 1);
    }
    wg_commit();
    wg_wait1();
    if (kt > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (kt - 1) % AB_STAGES);
    }
  }
  wg_wait();
  fence_acc(acc_h);
  fence_acc(acc_d);

  // both products done: the ring holds h + b1 and dam0 in f32, [128][LDS]
  // each, then the epilogue's sums
  asm volatile("bar.sync 1, %0;\n" ::"n"(GW_CONSUMERS * 128) : "memory");
  constexpr int LDS = AB_BN + 4;
  constexpr int GROUPS = GW_CONSUMERS * 128 / (AB_BN / 8);
  static_assert((2 * GW_BM * LDS + 2 * GROUPS * AB_BN + GW_CONSUMERS * 4) *
                        4 <= AB_STAGES * AB_STAGE,
                "gemm_act_bwd's staging");
  float* tile = reinterpret_cast<float*>(ring);
  float* dtile = tile + GW_BM * LDS;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = wg * 64 + warp * 16 + g + 8 * hh;
#pragma unroll
    for (int j = 0; j < AB_BN / 8; ++j) {
      const int c = 8 * j + 2 * t, col = n0 + c;
      float b0 = 0.f, bb1 = 0.f;
      if (col < p.N) {
        b0 = bf2f(p.bias[col]);
        bb1 = bf2f(p.bias[col + 1]);
      }
      *reinterpret_cast<float2*>(tile + r * LDS + c) = make_float2(
          acc_h[4 * j + 2 * hh] + b0, acc_h[4 * j + 2 * hh + 1] + bb1);
      *reinterpret_cast<float2*>(dtile + r * LDS + c) =
          make_float2(acc_d[4 * j + 2 * hh], acc_d[4 * j + 2 * hh + 1]);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(GW_CONSUMERS * 128) : "memory");
  act_bwd_epilogue<AB_BN>(tile, dtile, dtile + GW_BM * LDS, p, m0, n0, tid);
}

// The MLP activation backward (gemm_act_bwd_kernel) on the caller's stream:
// p.a = m_in and p.a2 = do [M][K], p.w = W1 [K][N], p.w2 = W2 [N][K],
// p.bias = b1 [N], p.mask [N] or null, p.d [2] or null; writes p.out = am
// and p.out2 = dh [M][N] (bf16), p.part (2 tiles_m N) and p.out32
// (tiles_m tiles_n), tiles of 128 x 128.
static cudaError_t launch_gemm_act_bwd(const GemmArgs& p, cudaStream_t s) {
  CUtensorMap a1map, b1map, a2map, b2map;
  cudaError_t err = matrix_map(a1map, p.a, p.M, p.K, p.K, GW_BK, GW_BM);
  if (err == cudaSuccess)
    err = matrix_map(b1map, p.w, p.K, p.N, p.N, 64, GW_BK);
  if (err == cudaSuccess)
    err = matrix_map(a2map, p.a2, p.M, p.K, p.K, GW_BK, GW_BM);
  if (err == cudaSuccess)
    err = matrix_map(b2map, p.w2, p.N, p.K, p.K, GW_BK, AB_BN);
  if (err == cudaSuccess) err = smem_once<gemm_act_bwd_kernel>(AB_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + AB_BN - 1) / AB_BN, (p.M + GW_BM - 1) / GW_BM);
  gemm_act_bwd_kernel<<<grid, GW_THREADS, AB_SMEM, s>>>(a1map, b1map, a2map,
                                                     b2map, p);
  return cudaGetLastError();
}

// w_grad = bf16(scale * sum over K of op(a) . w) split over K: `splits`
// CTAs along K per output tile, each writing its f32 partial into part
// [splits, M, N], then the partials added in index order, scaled (scale =
// d[1] where d is given, else 1) and rounded once (no float atomics: two
// launches give the same bits; one split: gemm_wg<EPI_SCALE> alone).
// p.a [K][M] (MN-major), p.w [K][N]; K is the B*N rows and may be ragged.
static cudaError_t weight_grad_wg(GemmArgs p, int splits, float* part,
                                  bf16* out, cudaStream_t s,
                                  const float* d = nullptr) {
  if (splits <= 1) {
    // one CTA along K: the scale and the rounding in the epilogue, the
    // bits of one partial summed from 0, scaled and rounded
    p.d = d;
    p.out = out;
    return launch_gemm_wg<EPI_SCALE, true, false>(p, s);
  }
  const int ktiles = (p.K + GW_BK - 1) / GW_BK;
  const int per = (ktiles + splits - 1) / splits;
  p.kchunk = (per > 0 ? per : 1) * GW_BK;
  p.out32 = part;
  cudaError_t err = launch_gemm_wg<EPI_F32, true, false>(p, s);
  if (err != cudaSuccess) return err;
  return launch_reduce(part, (p.K + p.kchunk - 1) / p.kchunk, p.M * p.N,
                       d, nullptr, out, s);
}

}  // namespace uvc
