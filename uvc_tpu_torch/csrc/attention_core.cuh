// What the streamed attention cores share: the head operands (Heads, one
// head-split operand at any strides), the copy widths that an operand
// allows (heads_vec, ops_vec), the pair store of the copy paths
// (store_pair) and the head-dim dispatch (with_head_dim).  The forward
// core (attention_core_fwd.cuh: A9's forward, and the attention step of
// K1 and A7's forward) and the backward core (attention_core_bwd.cuh:
// A8, A9's backward and the attention step of A2 and A7's backward)
// include it.  It holds no kernel.
//
// Head dim: each kernel is a template on the padded head dim DHP (16, 32,
// 48, 64 or 80) and takes any dh <= DHP.  The copies are as wide as every
// operand allows (heads_vec): 16 bytes where dh, the strides and the base
// are multiples of 8 elements, 4 bytes where they are even, and one
// element otherwise (an odd head dim).
#pragma once

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace uvc {

constexpr int CORE_THREADS = 128;

// One head-split operand: element (b, h, i, d) at
// p[b * sb + h * sh + i * sr + d].
template <typename T>
struct Heads {
  T* p;
  long long sb, sh, sr;
  __device__ __forceinline__ T* head(int b, int h) const {
    return p + (long long)b * sb + (long long)h * sh;
  }
};
typedef Heads<const bf16> InHeads;
typedef Heads<bf16> OutHeads;

// Elements per copy that an operand allows: 8 (16 bytes) where dh, its
// strides and its base are multiples of 8 elements, 2 where they are
// even, else 1.
template <typename T>
static int heads_vec(const Heads<T>& x, int dh) {
  auto fits = [&](int v) {
    return dh % v == 0 && x.sb % v == 0 && x.sh % v == 0 && x.sr % v == 0 &&
           reinterpret_cast<uintptr_t>(x.p) % (2 * v) == 0;
  };
  return fits(8) ? 8 : fits(2) ? 2 : 1;
}

template <typename... T>
static int ops_vec(int dh, const T&... ops) {
  return std::min({heads_vec(ops, dh)...});
}

// row[c], row[c + 1] = bf16(v0), bf16(v1) for the columns below dh; one
// 4-byte store when vec >= 2 (dh even, every row on a 4-byte boundary)
__device__ __forceinline__ void store_pair(bf16* row, int c, int dh, int vec,
                                           float v0, float v1) {
  if (vec >= 2) {
    if (c < dh) *reinterpret_cast<uint32_t*>(row + c) = pack_f32(v0, v1);
  } else {
    if (c < dh) row[c] = f2bf(v0);
    if (c + 1 < dh) row[c + 1] = f2bf(v1);
  }
}

template <typename K>
static cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DHP>
using HeadDim = std::integral_constant<int, DHP>;

// f(HeadDim<DHP>()) for the padded head dim DHP of dh (16, 32, 48, 64 or
// 80: the instantiations every entry point is built for), or
// cudaErrorInvalidValue for a head dim outside 1..80.
template <typename F>
static cudaError_t with_head_dim(int dh, F f) {
  if (dh <= 0) return cudaErrorInvalidValue;
  switch ((dh + 15) / 16) {
    case 1: return f(HeadDim<16>());
    case 2: return f(HeadDim<32>());
    case 3: return f(HeadDim<48>());
    case 4: return f(HeadDim<64>());
    case 5: return f(HeadDim<80>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace uvc
