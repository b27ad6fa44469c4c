// Integer epilogue shared by the Hopper conv kernels, the sigma probe and the
// glue kernel (glue.cu).
//
// The SiLU chain of one output element (reference semantics,
// quantize/primitives.requantize_np):
//   dom   = clip(rhu((r1 * acc) >> (s1 - 1)), +-qmax)
//   sigma = Lut.values[dom - lo]              (table read, shared memory)
//   out   = clip(rhu((sigma * r2 * acc) >> (s2 - 1)), +-qmax)
// with rhu(q) = (q >> 1) + (q & 1). CUDA has native int64, so the requant is
// the reference formula itself; `>>` on a negative signed integer is an
// arithmetic (floor) shift under nvcc, which the CPU tests pin for the plain
// version and chip_smoke.py checks against it on the card.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ayq {

// Largest table the kernels take: the 8-bit sigmoid LUT has 2*127+1 = 255
// entries. The wrappers refuse anything longer.
constexpr int kMaxLut = 256;

// Copies Lut.values into shared memory; every thread of the block calls it,
// and the caller synchronises before the first lookup.
__device__ __forceinline__ void load_table(int* s_tab, const int* __restrict__ tab,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_tab[i] = tab[i];
}

// The epilogue's sigmoid: a read of the exact table. The probe kernel runs
// this same function over the whole domain.
__device__ __forceinline__ int sigma_lookup(const int* s_tab, int dom, int lo) {
  return s_tab[dom - lo];
}

// The requant in the integer type T. T = long long holds for every operand
// the kernels take; T = int is the same formula and gives the same value
// wherever the caller has shown |m * x| < 2^31, since every later step is
// smaller (the glue kernel's wrapper checks that before it launches).
template <typename T>
__device__ __forceinline__ T requant_as(T x, T m, int shift, int qmax) {
  T q = (m * x) >> (shift - 1);
  q = (q >> 1) + (q & 1);
  return q < -qmax ? -qmax : (q > qmax ? qmax : q);
}

__device__ __forceinline__ long long requant(long long x, long long m, int shift,
                                             int qmax) {
  return requant_as<long long>(x, m, shift, qmax);
}

__device__ __forceinline__ int silu_epilogue(int acc, int r1, int s1, int r2, int s2,
                                             const int* s_tab, int lo, int qmax) {
  const int dom = static_cast<int>(requant(acc, r1, s1, qmax));
  const int sigma = sigma_lookup(s_tab, dom, lo);
  return static_cast<int>(requant(acc, static_cast<long long>(sigma) * r2, s2, qmax));
}

}  // namespace ayq
