// Implicit-GEMM integer convolution on Hopper's int8 tensor cores, with the
// fused epilogue, shared by the 1x1 and 3x3 kernels (conv1x1.cu, conv3x3.cu).
// Replaces alpha_yolo_quant_tpu/runtime/pallas_ops.py fused_conv1x1 (K1)
// and fused_conv3x3 (K2), which ran MXU s8 matmuls on im2col patches.
//
// GEMM view: rows m = (b, oy, ox) of the NHWC output, columns n = output
// channel, depth k = (tap, c) tap-major, tap = dy*KS + dx. The patch matrix is
// never materialised: each 16-byte chunk of A (16 channels of one tap of one
// output pixel) is copied straight from the NHWC input, and taps outside the
// image (pad 1) are zero-filled. The accumulator is int32: the quantizer
// bounds every sum below 2^31 (quantize/transform.py
// _check_accumulator_bounds), and s32 MMA accumulation without .satfinite
// wraps mod 2^32, so every partial step below is exact.
//
// What bounds each layer on an H100 (3.35 TB/s, 1,979 dense int8 TOP/s, a
// ridge near 590 operations per byte):
//   - 1x1 convs do 2*Cin operations per output element, 26-340 per byte:
//     bytes. The block's N is the layer's whole Cout (up to 256), so each
//     input tile crosses device memory once, and the epilogue stores 16
//     contiguous bytes per thread.
//   - the widest 3x3 convs (128->128 at 20 px, 256->80, the 80-px head
//     convs) do 576-1152 operations per byte: operations, which only the
//     tensor cores reach. The main loop is wgmma.m64nNk32.s32.s8.s8, two
//     warpgroups of 64 rows each, A and B read from shared memory.
//
// Design:
//   - Block: BM = 128 output rows x BN columns, BN the smallest of 16, 32, 64,
//     80, 128, 256 that holds Cout (every yolov8n Cout exactly); Cout > 256
//     takes several column blocks. Each k32 step issues n64/n32/n16 wgmmas
//     over the BN columns.
//   - A ring of STAGES shared-memory stages of BK = 64 bytes of depth,
//     filled by cp.async 16-byte copies (zero-fill for pad taps, the depth
//     tail and columns past Cout) while the tensor cores work on the stage
//     before. A and B sit as wgmma's no-swizzle K-major core matrices:
//     plane kc (16 bytes of depth) of 8-row groups, 128 bytes each.
//   - Cin % 16 != 0 (the Cin = 3 stem) gathers element by element through
//     registers into the same A tile.
//   - Wide int16 inputs (|x| up to 3*qmax on the chained-residual concats)
//     are split by bytes: x = 256*(x >> 8) + (x & 255), the high byte s8 and
//     the low byte u8. Pass 1 runs s8 x s8 over the high bytes, the
//     accumulator is shifted left by 8, pass 2 runs u8 x s8 over the low
//     bytes into the same accumulator: exact for every int16, two MMAs per
//     chunk. This loader goes through registers (__byte_perm picks the
//     bytes).
//   - Epilogue: the accumulators go through shared memory; the per-channel
//     constants and the sigmoid table are loaded once per block; each thread
//     takes 16 channels of one row and stores 16 contiguous bytes (int8 SiLU)
//     or 4 x 16 bytes (raw int32). The arithmetic is epilogue.cuh's, the
//     int64 reference requant.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "wgmma.cuh"

namespace ayq {

constexpr int BM = 128;      // output rows per block: two warpgroups of 64
constexpr int BK = 64;       // bytes of depth per pipeline stage
constexpr int KC = BK / 16;  // 16-byte chunks per row per stage
constexpr int CPT = KC / 2;  // A chunks a thread stages (two threads a row)
constexpr int STAGES = 4;    // depth of the shared-memory ring
constexpr int NT = 256;      // threads per block

// One k32 step over BN columns: n64 instructions, then an n32 and an n16 for
// the rest. b_addr is the step's B plane pair, b_lbo the distance between the
// two 16-byte planes. Accumulator a of this thread sits at column
// 8*(a/4) + 2*(lane%4) + a%2 and row lane/4 + 8*((a/2)%2) of its warp's 16.
template <int BN, bool U8A>
__device__ __forceinline__ void mma_k32(int* acc, uint64_t da, uint32_t b_addr, uint32_t b_lbo) {
#pragma unroll
  for (int c = 0; c + 64 <= BN; c += 64)
    Mma<64, U8A>::run(acc + c / 2, da, smem_desc(b_addr + c * 16, b_lbo, 128));
  constexpr int c32 = BN / 64 * 64;
  if constexpr (BN % 64 >= 32)
    Mma<32, U8A>::run(acc + c32 / 2, da, smem_desc(b_addr + c32 * 16, b_lbo, 128));
  if constexpr (BN % 32 == 16)
    Mma<16, U8A>::run(acc + (BN - 16) / 2, da, smem_desc(b_addr + (BN - 16) * 16, b_lbo, 128));
}

// ------------------------------------------------------------------ kernel

struct ConvArgs {
  const void* x;     // NHWC (B, H, W, Cin), int8 or int16
  const int8_t* w;   // (Cout, Kp) int8, K-major, zero past K
  const int* bias;   // (Cout,) int32, and the SiLU constants
  const int* r1;
  const int* s1;
  const int* r2;
  const int* s2;
  const int* tab;    // sigmoid Lut.values
  void* out;         // NHWC (B, Ho, Wo, Cout): int8 (SiLU) or int32
  long long M;       // B * Ho * Wo
  int tab_lo, tab_n, H, W, Cin, Ho, Wo, Cout, stride, pad, K, Kp, qmax;
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int BN>
struct Smem {
  static constexpr int A = BM * BK;                        // one stage of A
  static constexpr int STAGE = A + BN * BK;                // A and B
  static constexpr int CS = (BN + 31) / 32 * 32 + 8;        // tile row stride (words)
  static constexpr int MAIN = cmax(STAGES * STAGE, BM * CS * 4);
  static constexpr int BYTES = MAIN + (5 * BN + kMaxLut) * 4;
};

__device__ __forceinline__ uint32_t pack_bytes(const int* v) {
  return (static_cast<uint32_t>(v[0]) & 0xff) | ((static_cast<uint32_t>(v[1]) & 0xff) << 8) |
         ((static_cast<uint32_t>(v[2]) & 0xff) << 16) | (static_cast<uint32_t>(v[3]) << 24);
}

// Blocks per SM the register budget is sized for: the accumulators take
// BN/2 registers a thread.
constexpr int min_blocks(int bn) { return bn <= 64 ? 4 : bn <= 128 ? 2 : 1; }

template <int KS, int BN, bool WIDE, bool SILU>
__global__ void __launch_bounds__(NT, min_blocks(BN)) conv_wgmma(const ConvArgs p) {
  using T = typename std::conditional<WIDE, int16_t, int8_t>::type;
  using S = Smem<BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  int* s_const = reinterpret_cast<int*>(smem + S::MAIN);  // bias, r1, s1, r2, s2
  int* s_tab = s_const + 5 * BN;
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  for (int i = tid; i < BN; i += NT) {
    const int n = n0 + i;
    const bool ok = n < p.Cout;
    s_const[i] = ok ? p.bias[n] : 0;
    if (SILU) {
      s_const[BN + i] = ok ? p.r1[n] : 0;
      s_const[2 * BN + i] = ok ? p.s1[n] : 1;
      s_const[3 * BN + i] = ok ? p.r2[n] : 0;
      s_const[4 * BN + i] = ok ? p.s2[n] : 1;
    }
  }
  if (SILU) load_table(s_tab, p.tab, p.tab_n);

  // The A row this thread stages, and its chunks kc = lkc .. lkc + CPT - 1.
  const int lrow = tid >> 1;
  const int lkc = (tid & 1) * CPT;
  const long long m = m0 + lrow;
  const bool row_ok = m < p.M;
  int oy = 0, ox = 0;
  long long bimg = 0;
  if (row_ok) {
    ox = static_cast<int>(m % p.Wo);
    const long long t = m / p.Wo;
    oy = static_cast<int>(t % p.Ho);
    bimg = t / p.Ho;
  }
  const int iy0 = oy * p.stride - p.pad;
  const int ix0 = ox * p.stride - p.pad;
  const bool vec = p.Cin % 16 == 0;  // a chunk lies in one tap, 16-byte aligned
  // the row's first tap pixel (it may lie outside the image), and which
  // taps lie inside
  const T* row_px = static_cast<const T*>(p.x) +
                    ((bimg * p.H + iy0) * p.W + ix0) * static_cast<long long>(p.Cin);
  uint32_t tap_ok = 0;
  for (int t = 0; t < KS * KS; ++t) {
    const int iy = iy0 + t / KS, ix = ix0 + t % KS;
    tap_ok |= static_cast<uint32_t>(iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) << t;
  }
  const int nk = p.Kp / BK;
  const int total = WIDE ? 2 * nk : nk;  // wide: high-byte pass, then low-byte pass

  const uint32_t ring = smem_u32(smem);

  // Loader state, advanced one k-tile per load_stage call (the calls come
  // in order of v; the wide path starts again at depth 0 for its second
  // pass). A chunk j of this thread: depth ak, and on the vector path its
  // tap and channel (atap, ac) kept by adding BK, not by division.
  int ak[CPT], atap[CPT], ac[CPT];
  auto a_start = [&]() {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      ak[j] = (lkc + j) * 16;
      atap[j] = KS > 1 ? ak[j] / p.Cin : 0;
      ac[j] = ak[j] - atap[j] * p.Cin;
    }
  };
  auto a_next = [&]() {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      ak[j] += BK;
      if (ak[j] < p.K) {
        ac[j] += BK;
        while (ac[j] >= p.Cin) {
          ac[j] -= p.Cin;
          ++atap[j];
        }
      }
    }
  };
  // Offset of vector chunk j from row_px, or -1 for zeros (pad tap, past K).
  auto a_off = [&](int j) -> int {
    if (!row_ok || ak[j] >= p.K || !((tap_ok >> atap[j]) & 1)) return -1;
    return ((atap[j] / KS) * p.W + atap[j] % KS) * p.Cin + ac[j];
  };
  // B chunks of this thread: source offset in w at depth 0 (-1: a column
  // past Cout) and place in the stage.
  constexpr int BQ = (BN * KC + NT - 1) / NT;
  int b_src[BQ];
  uint32_t b_dst[BQ];
#pragma unroll
  for (int i = 0; i < BQ; ++i) {
    const int q = tid + i * NT;
    const int n = q / KC, kc = q % KC;
    b_src[i] = n0 + n < p.Cout ? (n0 + n) * p.Kp + kc * 16 : -1;
    b_dst[i] = S::A + kc * BN * 16 + n * 16;
  }

  // Fills ring slot v % STAGES with virtual k-tile v.
  auto load_stage = [&](int v) {
    const bool lo_pass = WIDE && v >= nk;
    const int kt = lo_pass ? v - nk : v;
    if (kt == 0)
      a_start();
    else
      a_next();
    const uint32_t sa = ring + (v % STAGES) * S::STAGE;
#pragma unroll
    for (int i = 0; i < BQ; ++i) {
      if (BN * KC % NT != 0 && tid + i * NT >= BN * KC) break;
      const bool ok = b_src[i] >= 0;
      cp_async16(sa + b_dst[i], ok ? p.w + b_src[i] + kt * BK : p.w, ok ? 16 : 0);
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kc = lkc + j;
      const uint32_t dst = sa + kc * BM * 16 + lrow * 16;
      if (!WIDE && vec) {
        const int off = a_off(j);
        cp_async16(dst, off < 0 ? p.x : static_cast<const void*>(row_px + off), off < 0 ? 0 : 16);
        continue;
      }
      const int k = ak[j];
      uint32_t wd[4];
      if (WIDE && vec) {
        const int off = a_off(j);
        uint4 a = make_uint4(0, 0, 0, 0), b = a;
        if (off >= 0) {
          const uint4* src = reinterpret_cast<const uint4*>(row_px + off);
          a = __ldg(src);
          b = __ldg(src + 1);
        }
        const uint32_t sel = lo_pass ? 0x6420 : 0x7531;  // low or high bytes
        wd[0] = __byte_perm(a.x, a.y, sel);
        wd[1] = __byte_perm(a.z, a.w, sel);
        wd[2] = __byte_perm(b.x, b.y, sel);
        wd[3] = __byte_perm(b.z, b.w, sel);
      } else if (!row_ok || k >= p.K) {
        wd[0] = wd[1] = wd[2] = wd[3] = 0;
      } else {
        // gathered: walk (tap, c) from k, one division per chunk; the
        // taps inside the image are the bits of tap_ok
        int tap = 0, c = k;
        if (KS > 1) {
          tap = k / p.Cin;
          c = k - tap * p.Cin;
        }
        int pix = (tap / KS) * p.W + tap % KS;  // tap's pixel offset from row_px
        int e[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const bool ok = k + i < p.K && ((tap_ok >> tap) & 1);
          const int x = ok ? static_cast<int>(row_px[pix * p.Cin + c]) : 0;
          e[i] = WIDE ? (lo_pass ? (x & 255) : (x >> 8)) : x;
          if (++c == p.Cin) {
            c = 0;
            ++tap;
            pix = (tap / KS) * p.W + tap % KS;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) wd[q] = pack_bytes(e + 4 * q);
      }
      st_shared16(dst, wd[0], wd[1], wd[2], wd[3]);
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  const int wg = tid / 128;

  // Tiles run PREFETCH ahead of the MMAs, and the MMAs of one tile stay in
  // flight across the next tile's barrier: the slot refilled at step `it`
  // held tile it - 2, whose MMAs every warpgroup has waited for.
  constexpr int PREFETCH = STAGES - 2;
  for (int v = 0; v < PREFETCH; ++v) {
    if (v < total) load_stage(v);
    cp_async_commit();
  }
  for (int it = 0; it < total; ++it) {
    cp_async_wait<PREFETCH - 1>();
    fence_async_smem();
    __syncthreads();  // tile `it` is in; the MMAs of it - 2 are done
    if (WIDE && it == nk) {
      // the high-byte pass is complete: acc = 256 * its sum (mod 2^32)
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = static_cast<int>(static_cast<uint32_t>(acc[i]) << 8);
    }
    const uint32_t sa = ring + (it % STAGES) * S::STAGE;
    const uint32_t sb = sa + S::A;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const uint64_t da = smem_desc(sa + 2 * j * BM * 16 + wg * 64 * 16, BM * 16, 128);
      const uint32_t b_addr = sb + 2 * j * BN * 16;
      if (WIDE && it >= nk)
        mma_k32<BN, true>(acc, da, b_addr, BN * 16);
      else
        mma_k32<BN, false>(acc, da, b_addr, BN * 16);
    }
    wgmma_commit();
    if (it + PREFETCH < total) load_stage(it + PREFETCH);
    cp_async_commit();
    wgmma_wait<1>();  // the MMAs of tile it - 1 are done
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the accumulator tile overwrites it

  int* tile = reinterpret_cast<int*>(smem);
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
#pragma unroll
  for (int a = 0; a < BN / 2; a += 2) {
    const int row = r0 + ((a >> 1) & 1) * 8;
    const int col = 8 * (a >> 2) + c0;
    *reinterpret_cast<int2*>(tile + row * S::CS + col) = make_int2(acc[a], acc[a + 1]);
  }
  __syncthreads();

  // 16 channels of one row per item; whole 16-byte stores when Cout % 16 == 0.
  constexpr int G = BN / 16;
  const bool vec_out = p.Cout % 16 == 0;
  for (int g = tid; g < BM * G; g += NT) {
    const int row = g / G;
    const int nl = (g % G) * 16;
    const long long mm = m0 + row;
    const int n = n0 + nl;
    if (mm >= p.M || n >= p.Cout) continue;
    // per-channel constants of the item's 16 channels, four at a time
    auto cq = [&](int which, int q) {
      return *reinterpret_cast<const int4*>(s_const + which * BN + nl + 4 * q);
    };
    int v[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 t = *reinterpret_cast<const int4*>(tile + row * S::CS + nl + 4 * q);
      const int4 b = cq(0, q);
      v[4 * q] = t.x + b.x;
      v[4 * q + 1] = t.y + b.y;
      v[4 * q + 2] = t.z + b.z;
      v[4 * q + 3] = t.w + b.w;
    }
    const long long o = mm * p.Cout + n;
    if (SILU) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 r1 = cq(1, q), s1 = cq(2, q), r2 = cq(3, q), s2 = cq(4, q);
        int* w = v + 4 * q;
        w[0] = silu_epilogue(w[0], r1.x, s1.x, r2.x, s2.x, s_tab, p.tab_lo, p.qmax);
        w[1] = silu_epilogue(w[1], r1.y, s1.y, r2.y, s2.y, s_tab, p.tab_lo, p.qmax);
        w[2] = silu_epilogue(w[2], r1.z, s1.z, r2.z, s2.z, s_tab, p.tab_lo, p.qmax);
        w[3] = silu_epilogue(w[3], r1.w, s1.w, r2.w, s2.w, s_tab, p.tab_lo, p.qmax);
      }
      int8_t* dst = static_cast<int8_t*>(p.out) + o;
      if (vec_out) {
        *reinterpret_cast<uint4*>(dst) =
            make_uint4(pack_bytes(v), pack_bytes(v + 4), pack_bytes(v + 8), pack_bytes(v + 12));
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (n + i < p.Cout) dst[i] = static_cast<int8_t>(v[i]);
      }
    } else {
      int* dst = static_cast<int*>(p.out) + o;
      if (vec_out) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          reinterpret_cast<int4*>(dst)[q] =
              make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (n + i < p.Cout) dst[i] = v[i];
      }
    }
  }
}

template <int KS, int BN, bool WIDE, bool SILU>
int launch_tile(const ConvArgs& p, cudaStream_t stream) {
  // above 48 KB of shared memory only by this opt-in, set per launch
  const int bytes = Smem<BN>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(conv_wgmma<KS, BN, WIDE, SILU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>((p.M + BM - 1) / BM), (p.Cout + BN - 1) / BN);
  conv_wgmma<KS, BN, WIDE, SILU><<<grid, NT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int KS, bool WIDE, bool SILU>
int launch_bn(const ConvArgs& p, cudaStream_t st) {
  if (p.Cout <= 16) return launch_tile<KS, 16, WIDE, SILU>(p, st);
  if (p.Cout <= 32) return launch_tile<KS, 32, WIDE, SILU>(p, st);
  if (p.Cout <= 64) return launch_tile<KS, 64, WIDE, SILU>(p, st);
  if (p.Cout <= 80) return launch_tile<KS, 80, WIDE, SILU>(p, st);
  if (p.Cout <= 128) return launch_tile<KS, 128, WIDE, SILU>(p, st);
  return launch_tile<KS, 256, WIDE, SILU>(p, st);
}

// Picks the instantiation for (input type, silu, Cout) and launches it.
// wp: (Cout, Kp) int8 from fused_ops.pack_weights, Kp = K rounded up to BK.
template <int KS>
int launch_conv(const void* x, int x_is_i16, const void* wp, const int* bias, const int* r1,
                const int* s1, const int* r2, const int* s2, const int* tab, int tab_lo,
                int tab_n, void* out, int silu, int B, int H, int W, int Cin, int Cout,
                int stride, int pad, int qmax, void* stream) {
  ConvArgs p;
  p.x = x;
  p.w = static_cast<const int8_t*>(wp);
  p.bias = bias;
  p.r1 = r1;
  p.s1 = s1;
  p.r2 = r2;
  p.s2 = s2;
  p.tab = tab;
  p.out = out;
  p.tab_lo = tab_lo;
  p.tab_n = tab_n;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Ho = (H + 2 * pad - KS) / stride + 1;
  p.Wo = (W + 2 * pad - KS) / stride + 1;
  p.Cout = Cout;
  p.stride = stride;
  p.pad = pad;
  p.K = KS * KS * Cin;
  p.Kp = (p.K + BK - 1) / BK * BK;
  p.qmax = qmax;
  p.M = static_cast<long long>(B) * p.Ho * p.Wo;
  if (p.M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_i16) return silu ? launch_bn<KS, true, true>(p, st) : launch_bn<KS, true, false>(p, st);
  return silu ? launch_bn<KS, false, true>(p, st) : launch_bn<KS, false, false>(p, st);
}

}  // namespace ayq
