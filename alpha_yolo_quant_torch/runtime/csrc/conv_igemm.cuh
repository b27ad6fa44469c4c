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
// wraps mod 2^32, so every partial step below is exact in any order.
//
// What bounds each kind of layer on an H100 (3.35 TB/s, 1,979 dense int8
// TOP/s, a ridge near 590 operations per byte):
//   - 1x1 convs and the narrow early 3x3 convs: bytes (26-340 operations a
//     byte), and with little depth, the epilogue (two int64 requants and a
//     table read an element). A column tile that covers Cout reads each input
//     row from device memory once, and the epilogue of one tile runs while the
//     other warpgroup's MMAs and the producer's loads go on.
//   - the deep 3x3 convs (96-576 channels): operations. The main loop keeps
//     the tensor cores fed from a ring of stages that the producer fills ahead.
//   - wide int16 inputs (|x| up to 3*qmax on the chained-residual concats):
//     the producer's loads through registers, two passes over the depth.
//   - the Cin = 3 stem: the producer's element gather.
//
// Design: one persistent block per SM: a producer warpgroup and two consumer
// warpgroups.
//   - Tiles: BM = 64 output rows x BN columns, BN = 16*ceil(Cout/nt/16) for
//     nt = ceil(Cout/256) column tiles (fused_ops.tile_n picks it on the host:
//     48, 96, 144 and 192 fit yolov8m's widths). The block walks the tiles
//     blockIdx.x, blockIdx.x + gridDim.x, ... with n innermost, so the blocks
//     at work share their rows of A in L2.
//   - Producer warpgroup (setmaxnreg down to 88-152 registers): fills a
//     ring of up to 8 shared-memory stages of BK = 128 bytes of depth, each
//     with a full and an empty mbarrier. Weights (B, (Cout, Kp) K-major) come
//     by TMA with the 128-byte swizzle, from a tensor map encoded once per conv
//     when the plan is built (weight_map); columns past Cout and depth past Kp
//     read as zeros. A comes by one of three loaders, chosen per launch:
//       vector  int8 input, Cin % 16 == 0: 16-byte cp.async, zero-filled for
//               pad taps and the depth tail; each thread's arrival on the full
//               barrier is made by the hardware once its copies have landed
//               (cp.async.mbarrier.arrive), so the producer runs a whole ring
//               ahead of the MMAs;
//       wide    int16 input, Cin % 16 == 0: 32-byte loads through registers,
//               split by bytes: x = 256*(x >> 8) + (x & 255), the high byte
//               s8 in a first pass over the depth, the low byte u8 in a second;
//       gather  Cin % 16 != 0 (the Cin = 3 stem): element by element, only the
//               chunks the stage's MMAs read.
//     The wide and gather loaders stall on their loads, so groups of the
//     warpgroup take the stages in turn: two (wide) or four (gather) stages'
//     loads in flight.
//     A is stored in the same swizzle as B (row r's chunk c at c ^ (r % 8)).
//   - Two consumer warpgroups (setmaxnreg up to 176-208), ping-pong: each
//     takes every other tile and runs wgmma.m64nBNk32 over its stages, one MMA
//     group in flight, freeing a stage when its MMAs are done. The last stage
//     issues only the k32 steps the depth K needs. The main loops take turns
//     (a ring of mbarriers), so one warpgroup's epilogue runs under the other's
//     MMAs, and no warpgroup waits on a stage more than one lap of the ring
//     ahead. The main loop has no block-wide barrier.
//   - Epilogue (epilogue.cuh's int64 requant, unchanged): the per-channel
//     constants of every column and the sigmoid table are loaded once per
//     block. SiLU: each thread requantizes all its accumulators in registers
//     first (no shared-memory store between the table reads), then writes the
//     int8 results to its warpgroup's staging rows, which go out as 16-byte
//     stores; raw int32 (the plain head convs) is stored straight from the
//     registers, 32 contiguous bytes a quad.
#pragma once

#include <cstdint>
#include <cstring>

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include "epilogue.cuh"
#include "wgmma.cuh"

namespace ayq {

constexpr int BM = 64;           // output rows per tile: one m64 wgmma
constexpr int BK = 128;          // bytes of depth per stage: one swizzle row
constexpr int WG = 128;          // threads per warpgroup
constexpr int MAX_NP = 1088;     // per-channel constants a block holds
constexpr int SMEM_MAX = 232448; // shared memory a block may use
constexpr int BAR_BYTES = 256;   // mbarriers: full[8], empty[8], turn[NC]
constexpr int NC = 2;            // consumer warpgroups
constexpr int NT = (NC + 1) * WG; // and the producer's
// Registers of a producer and of a consumer thread: P + 2 C <= 504, what a
// 384-thread block's threads start with (168 each). With 120 or more the
// wide loader keeps 8 rows in flight, else 4.
__host__ __device__ constexpr int producer_regs(int bn) {
  return bn <= 128 ? 152 : bn <= 192 ? 120 : 88;
}
__host__ __device__ constexpr int consumer_regs(int bn) {
  return bn <= 128 ? 176 : bn <= 192 ? 192 : 208;
}

struct ConvArgs {
  CUtensorMap wmap;  // packed weights (Cout, Kp): boxes of BK bytes x BN rows
  const void* x;     // NHWC (B, H, W, Cin), int8 or int16
  const int* bias;   // (Cout,) int32, and the SiLU constants
  const int* r1;
  const int* s1;
  const int* r2;
  const int* s2;
  const int* tab;    // sigmoid Lut.values
  void* out;         // NHWC (B, Ho, Wo, Cout): int8 (SiLU) or int32
  long long M;       // B * Ho * Wo
  int tab_lo, tab_n, H, W, Cin, Ho, Wo, Cout, stride, pad, K, qmax;
  int wide;          // int16 input: two passes over the depth
  int gather;        // Cin % 16 != 0: the element loader
  int np;            // constants held: the column tiles' width, nt * BN
};

// Shared memory of one block: the ring, the consumer warpgroups' epilogue
// staging rows (SiLU), the mbarriers, the sigmoid table and the constants.
template <int BN, bool SILU>
struct Plan {
  static constexpr int A = BM * BK;
  static constexpr int B = BN * BK;
  static constexpr int STAGE = A + B;  // a multiple of 1024: swizzle atoms stay aligned
  static constexpr int ES = SILU ? (BN + 127) / 128 * 128 + 16 : 0;  // staging row stride
  static constexpr int EPI = NC * BM * ES;
  static constexpr int FIT =
      (SMEM_MAX - 1024 - EPI - BAR_BYTES - kMaxLut * 4 - 5 * MAX_NP * 4) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int RING = STAGES * STAGE;
  static_assert(STAGES >= 4, "ring too shallow");
  static int bytes(int np) {
    return 1024 + RING + EPI + BAR_BYTES + kMaxLut * 4 + 5 * np * 4;
  }
};

__device__ __forceinline__ uint32_t pack_bytes(const int* v) {
  return (static_cast<uint32_t>(v[0]) & 0xff) | ((static_cast<uint32_t>(v[1]) & 0xff) << 8) |
         ((static_cast<uint32_t>(v[2]) & 0xff) << 16) | (static_cast<uint32_t>(v[3]) << 24);
}

// Byte offset of 16-byte chunk c in row r of a 128-byte-swizzled tile row.
__device__ __forceinline__ uint32_t sw_chunk(int c, int r) {
  return static_cast<uint32_t>((c ^ (r & 7)) * 16);
}

// Output pixel (b, oy, ox) of GEMM row m.
struct Pos {
  long long b;
  int oy, ox;
};

__device__ __forceinline__ Pos locate(const ConvArgs& p, long long m) {
  Pos q;
  if (m < 0x7fffffffLL) {
    const unsigned mm = static_cast<unsigned>(m), t = mm / static_cast<unsigned>(p.Wo);
    const unsigned b = t / static_cast<unsigned>(p.Ho);
    q.ox = static_cast<int>(mm - t * p.Wo);
    q.oy = static_cast<int>(t - b * p.Ho);
    q.b = b;
  } else {
    const long long t = m / p.Wo;
    q.ox = static_cast<int>(m - t * p.Wo);
    q.b = t / p.Ho;
    q.oy = static_cast<int>(t - q.b * p.Ho);
  }
  return q;
}

__device__ __forceinline__ void advance(const ConvArgs& p, Pos& q, int rows) {
  q.ox += rows;
  while (q.ox >= p.Wo) {
    q.ox -= p.Wo;
    if (++q.oy == p.Ho) {
      q.oy = 0;
      ++q.b;
    }
  }
}

// Element offset of the row's first tap pixel (it may lie outside the
// image), and which taps lie inside (none for a row past M).
template <int KS>
__device__ __forceinline__ void origin(const ConvArgs& p, const Pos& q, bool valid,
                                       long long& px, uint32_t& ok) {
  const int iy0 = q.oy * p.stride - p.pad, ix0 = q.ox * p.stride - p.pad;
  px = ((q.b * p.H + iy0) * p.W + ix0) * static_cast<long long>(p.Cin);
  ok = 0;
  if (!valid) return;
#pragma unroll
  for (int t = 0; t < KS * KS; ++t) {
    const int iy = iy0 + t / KS, ix = ix0 + t % KS;
    ok |= static_cast<uint32_t>(iy >= 0 && iy < p.H && ix >= 0 && ix < p.W) << t;
  }
}

template <int KS, int BN, bool SILU>
__global__ void __launch_bounds__(NT, 1) conv_wgmma_ws(const __grid_constant__ ConvArgs p) {
  using P = Plan<BN, SILU>;
  constexpr int S = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  uint8_t* epi = smem + P::RING;
  const uint32_t bars = ring + P::RING + P::EPI;
  int* s_tab = reinterpret_cast<int*>(epi + P::EPI + BAR_BYTES);
  int* s_const = s_tab + kMaxLut;  // bias, r1, s1, r2, s2: np each
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };
  auto turn = [&](int w) { return bars + 8u * (2 * S + w); };

  const int tid = threadIdx.x;
  for (int i = tid; i < p.np; i += NT) {
    const bool ok = i < p.Cout;
    s_const[i] = ok ? p.bias[i] : 0;
    if (SILU) {
      s_const[p.np + i] = ok ? p.r1[i] : 0;
      s_const[2 * p.np + i] = ok ? p.s1[i] : 1;
      s_const[3 * p.np + i] = ok ? p.r2[i] : 0;
      s_const[4 * p.np + i] = ok ? p.s2[i] : 1;
    }
  }
  if (SILU) load_table(s_tab, p.tab, p.tab_n);
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), WG + 1);  // the producer's threads, and the TMA's bytes
      mbar_init(empty(s), 4);      // the consuming warpgroup's warps
    }
    for (int w = 0; w < NC; ++w) mbar_init(turn(w), 4);
    mbar_fence_init();
  }
  __syncthreads();

  const int ntn = (p.Cout + BN - 1) / BN;
  const long long tiles = (p.M + BM - 1) / BM * ntn;
  const int nkt = (p.K + BK - 1) / BK;     // stages of one pass over the depth
  const int nst = p.wide ? 2 * nkt : nkt;  // wide: high-byte pass, low-byte pass
  const int wg = tid / WG;

  if (wg == 0) {
    // ------------------------------------------------------------ producer
    // vector: all 128 threads fill every stage, chunk c of rows rr + 16 j.
    // The register loaders take the stages in turn, so that several stages'
    // loads are in flight: wide, the two halves of the warpgroup (the half's
    // thread gt: chunk wc of rows wr + 8 j); gather, the four warps.
    regs_dec<producer_regs(BN)>();
    const int c = tid & 7, rr = tid >> 3;
    const int half = tid >> 6, gt = tid & 63;
    const int wc = gt & 7, wr = gt >> 3;
    long long v = 0;  // stages issued
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long m0 = t / ntn * BM;
      const int n0 = static_cast<int>(t % ntn) * BN;
      constexpr int NR = 8;  // rows a thread fills: 4 (vector) or 8 (wide)
      long long px[NR];
      uint32_t tok[NR];
      if (!p.gather) {
        const int nr = p.wide ? 8 : 4, r0 = p.wide ? wr : rr, dr = p.wide ? 8 : 16;
        Pos q = locate(p, m0 + r0);
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          if (j < nr) {
            origin<KS>(p, q, m0 + r0 + dr * j < p.M, px[j], tok[j]);
            if (j + 1 < nr) advance(p, q, dr);
          }
        }
      }
      int k = 0, tap = 0, ch = 0;
      for (int kt = 0; kt < nst; ++kt, ++v) {
        const bool lo = p.wide && kt >= nkt;
        const int kk = lo ? kt - nkt : kt;
        const int slot = static_cast<int>(v % S);
        mbar_wait(empty(slot), static_cast<uint32_t>((v / S) & 1) ^ 1);
        const uint32_t sa = ring + slot * P::STAGE;
        if (tid == 0) {
          mbar_arrive_tx(full(slot), P::B);
          tma_load_2d(sa + P::A, &p.wmap, full(slot), kk * BK, n0);
        }
        if (!p.wide && !p.gather) {
          // this thread's chunk: depth kk*BK + 16c, its tap and channel kept
          // by adding BK, not by division
          if (kk == 0) {
            k = c * 16;
            tap = KS > 1 ? k / p.Cin : 0;
            ch = k - tap * p.Cin;
          } else {
            k += BK;
            ch += BK;
            if (KS > 1)
              while (ch >= p.Cin) {
                ch -= p.Cin;
                ++tap;
              }
          }
          const long long toff =
              KS > 1 ? static_cast<long long>((tap / KS) * p.W + tap % KS) * p.Cin + ch : ch;
          const int8_t* x = static_cast<const int8_t*>(p.x);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = k < p.K && ((tok[j] >> tap) & 1);
            cp_async16(sa + (rr + 16 * j) * BK + sw_chunk(c, rr),
                       ok ? x + px[j] + toff : p.x, ok ? 16 : 0);
          }
          cp_async_arrive(full(slot));
          continue;
        }
        if (p.gather ? (v & 3) != (tid >> 5) : (v & 1) != half) {
          mbar_arrive(full(slot));  // another group's stage: only the arrival
          continue;
        }
        if (!p.gather) {
          // wide: chunk wc of the half's rows, depth kk*BK + 16 wc (int16)
          const int kq = kk * BK + wc * 16;
          const int qtap = KS > 1 ? kq / p.Cin : 0, qch = kq - qtap * p.Cin;
          const long long toff =
              KS > 1 ? static_cast<long long>((qtap / KS) * p.W + qtap % KS) * p.Cin + qch : qch;
          const int16_t* x = static_cast<const int16_t*>(p.x);
          const uint32_t sel = lo ? 0x6420 : 0x7531;  // low or high bytes
          constexpr int WB = producer_regs(BN) >= 120 ? 8 : 4;  // rows in flight
#pragma unroll
          for (int j0 = 0; j0 < 8; j0 += WB) {
            uint4 a[WB], b[WB];
#pragma unroll
            for (int j = 0; j < WB; ++j) {
              a[j] = b[j] = make_uint4(0, 0, 0, 0);
              if (kq < p.K && ((tok[j0 + j] >> qtap) & 1)) {
                const uint4* src = reinterpret_cast<const uint4*>(x + px[j0 + j] + toff);
                a[j] = __ldg(src);
                b[j] = __ldg(src + 1);
              }
            }
#pragma unroll
            for (int j = 0; j < WB; ++j)
              st_shared16(sa + (wr + 8 * (j0 + j)) * BK + sw_chunk(wc, wr),
                          __byte_perm(a[j].x, a[j].y, sel), __byte_perm(a[j].z, a[j].w, sel),
                          __byte_perm(b[j].x, b[j].y, sel), __byte_perm(b[j].z, b[j].w, sel));
          }
        } else {
          // gather: rows lane and lane + 32 in turn, only the chunks this
          // stage's k32 steps read
          const int rem = p.K - kk * BK;
          const int nch = rem >= BK ? BK / 16 : 2 * ((rem + 31) / 32);
          // element at off, or 0 where !ok: the load is always issued (at
          // the tensor's first element where !ok), so none waits on a branch
          auto fetch = [&](bool ok, long long off) {
            int val;
            if (p.wide) {
              val = static_cast<const int16_t*>(p.x)[ok ? off : 0];
              val = lo ? (val & 255) : (val >> 8);
            } else {
              val = static_cast<const int8_t*>(p.x)[ok ? off : 0];
            }
            return ok ? val : 0;
          };
#pragma unroll 1
          for (int row = tid & 31; row < BM; row += 32) {
            const long long m = m0 + row;
            long long gx;
            uint32_t gok;
            origin<KS>(p, locate(p, m), m < p.M, gx, gok);
#pragma unroll 1
            for (int cc = 0; cc < nch; cc += 2) {
              const int kq = kk * BK + cc * 16;
              int e[32];
              if (KS == 3 && p.Cin == 3) {
                // the stem: element i = 3t + c of a row's 27 is channel c of
                // tap t, at an offset known from i, so the loads are independent
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                  const int t = i / 3;
                  e[i] = i < 27 ? fetch((gok >> t) & 1, gx + ((t / 3) * p.W + t % 3) * 3 + i % 3)
                                : 0;
                }
              } else {
                int gtap = KS > 1 ? kq / p.Cin : 0, gch = kq - gtap * p.Cin;
#pragma unroll
                for (int i = 0; i < 32; ++i) {
                  e[i] = fetch(kq + i < p.K && ((gok >> gtap) & 1),
                               gx + static_cast<long long>((gtap / KS) * p.W + gtap % KS) * p.Cin +
                                   gch);
                  if (++gch == p.Cin) {
                    gch = 0;
                    ++gtap;
                  }
                }
              }
#pragma unroll
              for (int h = 0; h < 2; ++h)
                st_shared16(sa + row * BK + sw_chunk(cc + h, row), pack_bytes(e + 16 * h),
                            pack_bytes(e + 16 * h + 4), pack_bytes(e + 16 * h + 8),
                            pack_bytes(e + 16 * h + 12));
            }
          }
        }
        fence_async_smem();
        mbar_arrive(full(slot));
      }
    }
    cp_async_wait<0>();
    return;
  }

  // -------------------------------------------------------------- consumers
  regs_inc<consumer_regs(BN)>();
  const int w = wg - 1;
  const int wt = tid - wg * WG;
  const int lane = tid & 31;
  const int row0 = (wt >> 5) * 16 + (lane >> 2);
  uint8_t* ebuf = epi + w * BM * P::ES;
  int acc[BN / 2];
  int own = 0;  // this warpgroup's tiles so far
  for (long long t = blockIdx.x + static_cast<long long>(w) * gridDim.x; t < tiles;
       t += static_cast<long long>(NC) * gridDim.x, ++own) {
    const long long li = static_cast<long long>(NC) * own + w;  // place in the block's order
    const long long m0 = t / ntn * BM;
    const int n0 = static_cast<int>(t % ntn) * BN;
    // the main loop of the tile before (another warpgroup's) has passed its waits
    if (w > 0 || own > 0) mbar_wait(turn(w), static_cast<uint32_t>((own - (w == 0)) & 1));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int kt = 0; kt < nst; ++kt) {
      const long long v = li * nst + kt;
      const int slot = static_cast<int>(v % S);
      mbar_wait(full(slot), static_cast<uint32_t>((v / S) & 1));
      fence_async_smem();  // the stage's cp.async writes, before the MMAs read them
      const bool lo = p.wide && kt >= nkt;
      const int kk = lo ? kt - nkt : kt;
      if (p.wide && kt == nkt) {
        // the high-byte pass is complete: acc = 256 * its sum (mod 2^32)
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i)
          acc[i] = static_cast<int>(static_cast<uint32_t>(acc[i]) << 8);
      }
      const int rem = p.K - kk * BK;
      const int steps = rem >= BK ? BK / 32 : (rem + 31) / 32;
      const uint32_t sa = ring + slot * P::STAGE, sb = sa + P::A;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        if (j < steps) {
          const uint64_t da = smem_desc_sw128(sa + 32 * j), db = smem_desc_sw128(sb + 32 * j);
          if (lo)
            Mma<BN, true>::run(acc, da, db);
          else
            Mma<BN, false>::run(acc, da, db);
        }
      }
      wgmma_commit();
      if (kt == nst - 1 && lane == 0) mbar_arrive(turn((w + 1) % NC));
      wgmma_wait<1>();  // the MMAs of the stage before are done: free it
      if (kt > 0 && lane == 0) mbar_arrive(empty(static_cast<int>((v - 1) % S)));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
    if (lane == 0) mbar_arrive(empty(static_cast<int>(((li + 1) * nst - 1) % S)));

    // epilogue: accumulator 4j + 2h + e sits at column 8j + 2*(lane%4) + e
    // and row row0 + 8h; the constants of a column pair are read once. Every
    // value is computed before the first store, so no table read waits
    // behind a store it might alias.
    if (SILU) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
        const int2 b = *reinterpret_cast<const int2*>(s_const + n);
        const int2 r1 = *reinterpret_cast<const int2*>(s_const + p.np + n);
        const int2 s1 = *reinterpret_cast<const int2*>(s_const + 2 * p.np + n);
        const int2 r2 = *reinterpret_cast<const int2*>(s_const + 3 * p.np + n);
        const int2 s2 = *reinterpret_cast<const int2*>(s_const + 4 * p.np + n);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = 4 * j + 2 * h;
          const int v0 =
              silu_epilogue(acc[a] + b.x, r1.x, s1.x, r2.x, s2.x, s_tab, p.tab_lo, p.qmax);
          const int v1 =
              silu_epilogue(acc[a + 1] + b.y, r1.y, s1.y, r2.y, s2.y, s_tab, p.tab_lo, p.qmax);
          acc[a] = (v0 & 255) | ((v1 & 255) << 8);  // the pair's two output bytes
        }
      }
      bar_sync(1 + w, WG);  // the last tile's rows have left the staging rows
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint16_t*>(ebuf + (row0 + 8 * h) * P::ES + 8 * j + 2 * (lane & 3)) =
              static_cast<uint16_t>(acc[4 * j + 2 * h]);
      bar_sync(1 + w, WG);
      constexpr int G = BN / 16;
      const bool vec_out = p.Cout % 16 == 0;
      for (int g = wt; g < BM * G; g += WG) {
        const int row = g / G, nl = (g - row * G) * 16;
        const long long m = m0 + row;
        const int n = n0 + nl;
        if (m >= p.M || n >= p.Cout) continue;
        const uint4 val = *reinterpret_cast<const uint4*>(ebuf + row * P::ES + nl);
        int8_t* dst = static_cast<int8_t*>(p.out) + m * p.Cout + n;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) = val;
        } else {
          const int8_t* src = reinterpret_cast<const int8_t*>(&val);
          for (int i = 0; i < 16 && n + i < p.Cout; ++i) dst[i] = src[i];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int2 b = *reinterpret_cast<const int2*>(s_const + n0 + 8 * j + 2 * (lane & 3));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * j + 2 * h] += b.x;
          acc[4 * j + 2 * h + 1] += b.y;
        }
      }
      const bool pair = (p.Cout & 1) == 0;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int a = 4 * j + 2 * h;
          const long long m = m0 + row0 + 8 * h;
          if (m >= p.M || n >= p.Cout) continue;
          int* dst = static_cast<int*>(p.out) + m * p.Cout + n;
          if (pair) {
            *reinterpret_cast<int2*>(dst) = make_int2(acc[a], acc[a + 1]);
          } else {
            dst[0] = acc[a];
            if (n + 1 < p.Cout) dst[1] = acc[a + 1];
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------- host

inline int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cache[dev]) return cache[dev];
  int n = 1;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cache[dev] = n;
  return n > 0 ? n : 1;
}

// The weights' tensor map: (Cout, Kp) int8, K-major, boxes of BK bytes x bn
// rows in the 128-byte swizzle. cuTensorMapEncodeTiled is looked up in the
// loaded libcuda at run time, so nothing links against it. 0 on success.
inline int weight_map(const void* wp, int cout, int kp, int bn, void* out) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return -1;
    encode = reinterpret_cast<Encode>(dlsym(lib, "cuTensorMapEncodeTiled"));
    if (encode == nullptr) return -2;
  }
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(cout)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(bn)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wp), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  std::memcpy(out, &map, sizeof(map));
  return 0;
}

template <int KS, int BN, bool SILU>
int launch_tile(const ConvArgs& p, cudaStream_t stream) {
  // above 48 KB of shared memory only by this opt-in, set per launch
  const int bytes = Plan<BN, SILU>::bytes(p.np);
  cudaError_t e = cudaFuncSetAttribute(conv_wgmma_ws<KS, BN, SILU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (p.M + BM - 1) / BM * ((p.Cout + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  conv_wgmma_ws<KS, BN, SILU><<<grid, NT, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int KS, bool SILU>
int launch_bn(const ConvArgs& p, int bn, cudaStream_t st) {
  switch (bn) {
#define AYQ_BN(n) \
  case n:         \
    return launch_tile<KS, n, SILU>(p, st);
    AYQ_BN(16) AYQ_BN(32) AYQ_BN(48) AYQ_BN(64) AYQ_BN(80) AYQ_BN(96) AYQ_BN(112) AYQ_BN(128)
    AYQ_BN(144) AYQ_BN(160) AYQ_BN(176) AYQ_BN(192) AYQ_BN(208) AYQ_BN(224) AYQ_BN(240)
    AYQ_BN(256)
#undef AYQ_BN
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the conv on tiles of bn columns (fused_ops.tile_n) with the
// weights' tensor map wmap (weight_map, the same bn). wp: (Cout, Kp) int8
// from fused_ops.pack_weights.
template <int KS>
int launch_conv(const void* x, int x_is_i16, const void* wp, const void* wmap, int bn,
                const int* bias, const int* r1, const int* s1, const int* r2, const int* s2,
                const int* tab, int tab_lo, int tab_n, void* out, int silu, int B, int H, int W,
                int Cin, int Cout, int stride, int pad, int qmax, void* stream) {
  ConvArgs p;
  std::memcpy(&p.wmap, wmap, sizeof(p.wmap));
  p.x = x;
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
  p.qmax = qmax;
  p.wide = x_is_i16 != 0;
  p.gather = Cin % 16 != 0;
  p.M = static_cast<long long>(B) * p.Ho * p.Wo;
  if (bn <= 0 || bn % 16 != 0 || bn > 256) return static_cast<int>(cudaErrorInvalidValue);
  p.np = (Cout + bn - 1) / bn * bn;
  if (p.np > MAX_NP) return static_cast<int>(cudaErrorInvalidValue);
  if (p.M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return silu ? launch_bn<KS, true>(p, bn, st) : launch_bn<KS, false>(p, bn, st);
}

}  // namespace ayq
