// Implicit-GEMM integer convolution with the fused epilogue, shared by the
// 1x1 and 3x3 kernels (conv1x1.cu, conv3x3.cu).
//
// GEMM view: rows m = (b, oy, ox) of the NHWC output, columns n = output
// channel, depth k = (tap, c) tap-major, tap = dy*KS + dx. The patch matrix is
// never materialised: each k-group of four is read straight from the NHWC
// input, and taps that fall outside the image (pad 1) read 0.
//
// Inputs are int8, or int16 for the wide edges (|x| <= 3*qmax = 381, the
// chained-residual concats). int8 uses __dp4a (4 int8 x int8 MACs per
// instruction); int16 uses __dp2a_lo/__dp2a_hi (2 int16 x int8 MACs each),
// so a wide input costs two instructions per k-group and stays exact. The
// accumulator is int32: the quantizer bounds every partial sum below 2^31
// (quantize/transform.py _check_accumulator_bounds).
//
// Tiling: a 64x64 output tile per block of 256 threads, 4x4 outputs per
// thread, k-tiles of 32 staged in shared memory. What bounds it on an H100:
// the __dp4a issue rate of the CUDA cores (about 1/30 of the int8 tensor-core
// peak), not memory: every k-group loaded into shared memory is reused by 64
// rows or columns. Moving the inner product onto mma.sync/wgmma s8 is later
// work; this version is the simple, exact one.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace ayq {

constexpr int BM = 64;        // output rows per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // depth per shared-memory stage
constexpr int KG = BK / 4;    // k-groups of four per stage
constexpr int NT = 256;       // threads per block

template <typename T> struct AWord;
template <> struct AWord<int8_t> { using type = int; };    // 4 x int8
template <> struct AWord<int16_t> { using type = int2; };  // 4 x int16

__device__ __forceinline__ int pack4(int8_t v0, int8_t v1, int8_t v2, int8_t v3) {
  return static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(v0)) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(v1)) << 8) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(v2)) << 16) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(v3)) << 24));
}

__device__ __forceinline__ int2 pack4(int16_t v0, int16_t v1, int16_t v2, int16_t v3) {
  int2 r;
  r.x = static_cast<int>(static_cast<uint32_t>(static_cast<uint16_t>(v0)) |
                         (static_cast<uint32_t>(static_cast<uint16_t>(v1)) << 16));
  r.y = static_cast<int>(static_cast<uint32_t>(static_cast<uint16_t>(v2)) |
                         (static_cast<uint32_t>(static_cast<uint16_t>(v3)) << 16));
  return r;
}

__device__ __forceinline__ int zero_word(int) { return 0; }
__device__ __forceinline__ int2 zero_word(int2) { return make_int2(0, 0); }

__device__ __forceinline__ int dot4(int a, int b, int c) { return __dp4a(a, b, c); }
__device__ __forceinline__ int dot4(int2 a, int b, int c) {
  return __dp2a_hi(a.y, b, __dp2a_lo(a.x, b, c));
}

// One input element of the implicit patch matrix, or 0 outside the image or
// past the true depth K.
template <typename T, int KS>
__device__ __forceinline__ T load_elem(const T* __restrict__ xb, bool row_ok, int iy0,
                                       int ix0, int H, int W, int Cin, int K, int k) {
  if (!row_ok || k >= K) return T(0);
  const int tap = k / Cin;
  const int c = k - tap * Cin;
  const int iy = iy0 + tap / KS;
  const int ix = ix0 + tap % KS;
  if (iy < 0 || iy >= H || ix < 0 || ix >= W) return T(0);
  return xb[(static_cast<long long>(iy) * W + ix) * Cin + c];
}

// Four consecutive depth entries k..k+3 as one word. VEC (Cin % 4 == 0) keeps
// the four inside one tap and contiguous in memory, so they load as one
// aligned 4- or 8-byte word; otherwise (the Cin = 3 stem) they are gathered.
template <typename T, int KS, bool VEC>
__device__ __forceinline__ typename AWord<T>::type load_a(
    const T* __restrict__ xb, bool row_ok, int iy0, int ix0, int H, int W, int Cin,
    int K, int k) {
  using A = typename AWord<T>::type;
  if (VEC) {
    if (!row_ok || k >= K) return zero_word(A());
    const int tap = k / Cin;
    const int c = k - tap * Cin;
    const int iy = iy0 + tap / KS;
    const int ix = ix0 + tap % KS;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) return zero_word(A());
    return *reinterpret_cast<const A*>(xb + (static_cast<long long>(iy) * W + ix) * Cin + c);
  }
  return pack4(load_elem<T, KS>(xb, row_ok, iy0, ix0, H, W, Cin, K, k),
               load_elem<T, KS>(xb, row_ok, iy0, ix0, H, W, Cin, K, k + 1),
               load_elem<T, KS>(xb, row_ok, iy0, ix0, H, W, Cin, K, k + 2),
               load_elem<T, KS>(xb, row_ok, iy0, ix0, H, W, Cin, K, k + 3));
}

// x: NHWC (B,H,W,Cin) of T. wp: int32 words (Kp/4, Cout), Kp = K rounded up
// to BK with zero weights, word g of column n = int8 weights k = 4g..4g+3.
// out: NHWC (B,Ho,Wo,Cout) int8 (SILU) or int32 raw accumulators + bias.
template <typename T, int KS, bool VEC, bool SILU>
__global__ void __launch_bounds__(NT) conv_igemm(
    const T* __restrict__ x, const int* __restrict__ wp, const int* __restrict__ bias,
    const int* __restrict__ r1, const int* __restrict__ s1, const int* __restrict__ r2,
    const int* __restrict__ s2, const int* __restrict__ tab, int tab_lo, int tab_n,
    void* __restrict__ out, int H, int W, int Cin, int Ho, int Wo, int Cout, int stride,
    int pad, int K, long long M, int qmax) {
  using A = typename AWord<T>::type;
  __shared__ A As[KG][BM];
  __shared__ int Bs[KG][BN];
  __shared__ int s_tab[kMaxLut];
  const int tid = threadIdx.x;
  if (SILU) load_table(s_tab, tab, tab_n);

  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // The A row this thread stages is the same for every k-tile.
  const int a_row = tid % BM;
  const int a_kg = tid / BM;  // stages k-groups a_kg and a_kg + 4
  const long long m = m0 + a_row;
  const bool row_ok = m < M;
  int oy = 0, ox = 0;
  long long bimg = 0;
  if (row_ok) {
    ox = static_cast<int>(m % Wo);
    const long long t = m / Wo;
    oy = static_cast<int>(t % Ho);
    bimg = t / Ho;
  }
  const int iy0 = oy * stride - pad;
  const int ix0 = ox * stride - pad;
  const T* xb = x + bimg * H * W * Cin;

  const int b_col = tid % BN;
  const int b_kg = tid / BN;
  const bool col_ok = n0 + b_col < Cout;

  const int tx = tid % 16;
  const int ty = tid / 16;
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kg = a_kg + 4 * h;
      As[kg][a_row] = load_a<T, KS, VEC>(xb, row_ok, iy0, ix0, H, W, Cin, K, k0 + 4 * kg);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kg = b_kg + 4 * h;
      Bs[kg][b_col] =
          col_ok ? wp[static_cast<long long>(k0 / 4 + kg) * Cout + n0 + b_col] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kg = 0; kg < KG; ++kg) {
      A a[4];
      int b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kg][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kg][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= Cout) continue;
    const int bn = bias[n];
    int cr1 = 0, cs1 = 1, cr2 = 0, cs2 = 1;
    if (SILU) {
      cr1 = r1[n];
      cs1 = s1[n];
      cr2 = r2[n];
      cs2 = s2[n];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long mm = m0 + ty + 16 * i;
      if (mm >= M) continue;
      const int a = acc[i][j] + bn;
      const long long o = mm * Cout + n;
      if (SILU) {
        static_cast<int8_t*>(out)[o] =
            static_cast<int8_t>(silu_epilogue(a, cr1, cs1, cr2, cs2, s_tab, tab_lo, qmax));
      } else {
        static_cast<int*>(out)[o] = a;
      }
    }
  }
}

template <typename T, int KS, bool VEC, bool SILU>
int launch_one(const void* x, const int* wp, const int* bias, const int* r1,
               const int* s1, const int* r2, const int* s2, const int* tab, int tab_lo,
               int tab_n, void* out, int B, int H, int W, int Cin, int Cout, int stride,
               int pad, int qmax, cudaStream_t stream) {
  const int Ho = (H + 2 * pad - KS) / stride + 1;
  const int Wo = (W + 2 * pad - KS) / stride + 1;
  const long long M = static_cast<long long>(B) * Ho * Wo;
  const int K = KS * KS * Cin;
  dim3 grid(static_cast<unsigned>((M + BM - 1) / BM), (Cout + BN - 1) / BN);
  conv_igemm<T, KS, VEC, SILU><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), wp, bias, r1, s1, r2, s2, tab, tab_lo, tab_n, out, H, W,
      Cin, Ho, Wo, Cout, stride, pad, K, M, qmax);
  return static_cast<int>(cudaGetLastError());
}

// Picks the instantiation for (input type, silu, Cin % 4) and launches it.
template <int KS>
int launch_conv(const void* x, int x_is_i16, const int* wp, const int* bias,
                const int* r1, const int* s1, const int* r2, const int* s2,
                const int* tab, int tab_lo, int tab_n, void* out, int silu, int B, int H,
                int W, int Cin, int Cout, int stride, int pad, int qmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = Cin % 4 == 0;
#define AYQ_LAUNCH(T, V, S)                                                         \
  return launch_one<T, KS, V, S>(x, wp, bias, r1, s1, r2, s2, tab, tab_lo, tab_n, out, \
                                 B, H, W, Cin, Cout, stride, pad, qmax, st)
  if (x_is_i16) {
    if (silu) {
      if (vec) AYQ_LAUNCH(int16_t, true, true);
      AYQ_LAUNCH(int16_t, false, true);
    }
    if (vec) AYQ_LAUNCH(int16_t, true, false);
    AYQ_LAUNCH(int16_t, false, false);
  }
  if (silu) {
    if (vec) AYQ_LAUNCH(int8_t, true, true);
    AYQ_LAUNCH(int8_t, false, true);
  }
  if (vec) AYQ_LAUNCH(int8_t, true, false);
  AYQ_LAUNCH(int8_t, false, false);
#undef AYQ_LAUNCH
}

}  // namespace ayq
