// packed_conv: the banded int8 conv over lane-packed slabs, with the SiLU
// requant chain (int8 out) or the raw accumulator (int32 out).
//
// Replaces the TPU kernel alpha_yolo_quant_tpu/runtime/packed_conv.py
// _packed_call (_packed_kernel): one grid step per image, the whole slab in
// VMEM, T dense (rows, 128) @ (128, 128) MXU dots at constant row offsets.
//
// A slab is (B, R_ext, 128) int8: every row one 128-lane group of P pixels
// x 128/P channels, with zero pad rows and pad groups around the image (see
// runtime/packed_conv.py). Output row r of the conv region (0 <= r < m,
// m = h_out * (g + 2)) is
//     acc[r] = bias + sum_t X_{si_t}[base_t + r] @ W_t
// over the taps t; the output slab holds it at row head + r, head =
// FRONT_PAD + g + 2. The kernel writes every output row: rows outside
// [head, head + m) and the pad-group rows (r % (g+2) in {0, g+1}) as zeros,
// which the next layer reads as padding.
//
// One block computes a 64-row x 128-lane output tile of one image. For each
// tap it stages the 64 input rows (8 KiB, one contiguous run of the slab)
// and that tap's matrix W_t (16 KiB) in shared memory, then accumulates
// with __dp4a in int32. Streaming one W_t per tap keeps shared memory at
// 25 KiB whatever the tap count (the widest yolov8n conv has 18 taps, 288
// KiB of matrices). Accumulator bound: 18 * 128 * 127 * 127 < 2^31.
//
// Bound on an H100: the __dp4a issue rate of the CUDA cores, as in
// conv_igemm.cuh. Each staged row is reused by all 128 lanes and each W_t
// word by 64 rows, so memory is not the limit. Epilogue constants are per
// LANE (128,): lanes no channel uses carry r = 0, s = 1 and give 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kMaxSlabs = 8;
constexpr int kMaxTaps = 32;
constexpr int BMR = 64;        // output rows per block
constexpr int NT = 256;        // threads per block
constexpr int KW = 32;         // 128 lanes of depth = 32 words of 4 x int8
constexpr int A_STRIDE = 36;   // words per staged row: 16-byte aligned, and
                               // rows ty and ty + 1 fall on different banks

struct TapTable {
  const int8_t* x[kMaxSlabs];
  int rows[kMaxSlabs];         // R_ext of each slab
  int si[kMaxTaps];            // slab of each tap
  int w[kMaxTaps];             // matrix of each tap
  int base[kMaxTaps];          // row offset of each tap
  int n_taps;
};

// wp: int32 words (n_w, KW, 128): word [t][g][n] packs W_t[4g..4g+3][n].
template <bool SILU>
__global__ void __launch_bounds__(NT) packed_conv_kernel(
    const TapTable tt, const int* __restrict__ wp, const int* __restrict__ bias,
    const int* __restrict__ r1, const int* __restrict__ s1, const int* __restrict__ r2,
    const int* __restrict__ s2, const int* __restrict__ tab, int tab_lo, int tab_n,
    void* __restrict__ out, int m, int gp2, int head, int r_out_ext, int qmax) {
  __shared__ __align__(16) int As[BMR][A_STRIDE];
  __shared__ __align__(16) int Bs[KW][128];
  __shared__ int s_tab[ayq::kMaxLut];
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * BMR;   // first output row of the tile
  const int r0 = o0 - head;          // its row in the conv region
  if (SILU) ayq::load_table(s_tab, tab, tab_n);
  __syncthreads();

  const int tx = tid % 16;           // lanes tx + 16 j
  const int ty = tid / 16;           // rows ty + 16 i
  int acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;

  // block-uniform: tiles wholly in the head or tail rows only write zeros
  if (r0 + BMR > 0 && r0 < m) {
    for (int t = 0; t < tt.n_taps; ++t) {
      const int si = tt.si[t];
      const int8_t* xb = tt.x[si] + static_cast<long long>(b) * tt.rows[si] * 128;
      const int base = tt.base[t];
      for (int q = tid; q < BMR * 8; q += NT) {   // 16-byte chunks of the rows
        const int row = q / 8;
        const int chunk = q % 8;
        const int r = r0 + row;
        int4 v = make_int4(0, 0, 0, 0);
        if (r >= 0 && r < m)
          v = *reinterpret_cast<const int4*>(xb + static_cast<long long>(base + r) * 128 +
                                             chunk * 16);
        *reinterpret_cast<int4*>(&As[row][chunk * 4]) = v;
      }
      const int4* wt = reinterpret_cast<const int4*>(wp + static_cast<long long>(tt.w[t]) *
                                                              KW * 128);
      for (int q = tid; q < KW * 128 / 4; q += NT)
        reinterpret_cast<int4*>(&Bs[0][0])[q] = wt[q];
      __syncthreads();
#pragma unroll 4
      for (int kg = 0; kg < KW; ++kg) {
        int a[4];
        int w[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kg];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = Bs[kg][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = tx + 16 * j;
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
      const int o = o0 + ty + 16 * i;
      if (o >= r_out_ext) continue;
      const int r = o - head;
      bool valid = r >= 0 && r < m;
      if (valid) {
        const int u = r % gp2;
        valid = u != 0 && u != gp2 - 1;
      }
      const long long idx = (static_cast<long long>(b) * r_out_ext + o) * 128 + n;
      const int a = acc[i][j] + bn;
      if (SILU) {
        static_cast<int8_t*>(out)[idx] = static_cast<int8_t>(
            valid ? ayq::silu_epilogue(a, cr1, cs1, cr2, cs2, s_tab, tab_lo, qmax) : 0);
      } else {
        static_cast<int*>(out)[idx] = valid ? a : 0;
      }
    }
  }
}

}  // namespace

extern "C" int ayq_packed_conv(const void* const* xs, const int* x_rows, int n_x,
                               const int* tap_si, const int* tap_w, const int* tap_base,
                               int n_taps, const int* wp, const int* bias, const int* r1,
                               const int* s1, const int* r2, const int* s2, const int* tab,
                               int tab_lo, int tab_n, void* out, int silu, int B, int m,
                               int gp2, int head, int r_out_ext, int qmax, void* stream) {
  if (n_x < 1 || n_x > kMaxSlabs || n_taps < 1 || n_taps > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  TapTable tt = {};
  for (int i = 0; i < n_x; ++i) {
    tt.x[i] = static_cast<const int8_t*>(xs[i]);
    tt.rows[i] = x_rows[i];
  }
  for (int t = 0; t < n_taps; ++t) {
    tt.si[t] = tap_si[t];
    tt.w[t] = tap_w[t];
    tt.base[t] = tap_base[t];
  }
  tt.n_taps = n_taps;
  dim3 grid(static_cast<unsigned>((r_out_ext + BMR - 1) / BMR), static_cast<unsigned>(B));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (silu) {
    packed_conv_kernel<true><<<grid, NT, 0, st>>>(tt, wp, bias, r1, s1, r2, s2, tab, tab_lo,
                                                  tab_n, out, m, gp2, head, r_out_ext, qmax);
  } else {
    packed_conv_kernel<false><<<grid, NT, 0, st>>>(tt, wp, bias, r1, s1, r2, s2, tab, tab_lo,
                                                   tab_n, out, m, gp2, head, r_out_ext, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}
