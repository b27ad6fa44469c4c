// packed_conv: the banded int8 conv over lane-packed slabs on Hopper's int8
// tensor cores, with the SiLU requant chain (int8 out) or the raw
// accumulator (int32 out).
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
// which the next layer reads as padding. Accumulator bound: at most
// kMaxTaps = 32 taps of depth 128, 32 * 128 * 127 * 127 < 2^31.
//
// What bounds it on an H100: the tap matrices are banded, so most of each
// dense product is zeros (72% of the 32-deep x 16-lane blocks over the
// yolov8n-640 slab plan). What is left is a few int8 operations per byte of
// slab, below the card's ridge, and the int64 SiLU chain of every live
// output: the slab traffic, its latency and the epilogue, not the tensor
// cores.
//
// Design:
//   - One block computes a 128-row x 128-lane output tile of one image as
//     two warpgroups of 64 rows, with wgmma.m64n16k32.s32.s8.s8 from shared
//     memory, operands in wgmma's no-swizzle K-major core matrices (16-byte
//     depth planes of 8-row groups).
//   - A is resident: the taps on one slab differ only in their row base, so
//     the block loads each slab's rows once, from the least base to the
//     greatest plus 128 (a "region"), and points each tap's descriptor at
//     its own first row (any row: a core matrix is 8 consecutive rows of 16
//     bytes). Region rows outside the slab are zero-filled; rows that only
//     feed outputs outside [0, m) are loaded as they are, and those outputs
//     are written as zeros.
//   - Block masks, computed once on the host (packed_conv.block_masks):
//     bit 8*kc + nc of a tap's mask is set iff W_t[32kc:+32, 16nc:+16] has a
//     nonzero. Only those blocks are kept, in global memory and in shared
//     memory (packed_conv.kept_block_weights, 512 bytes each), and the
//     kernel issues one MMA per set bit, each n16 piece into its own
//     accumulator fragment; k32 rows of a region that no tap uses are not
//     loaded. Skipping a block of zeros is exact. The mask is uniform over
//     the block, so the branches do not diverge.
//   - Tap groups: the host splits the taps into groups whose regions and
//     kept blocks fit GROUP_BYTES (packed_conv.launch_plan). The block loads
//     a whole group with 16-byte cp.async (zero-fill covers region rows
//     outside the slab), waits once, and runs the group's MMAs back to
//     back: it waits for device memory once per group, not once per tap.
//     Two blocks share an SM, so one block's epilogue overlaps the other's
//     loads.
//   - Dead pieces: an n16 piece whose lanes are zero columns of every tap
//     matrix and have zero bias accumulates 0, and both epilogues map 0 to
//     0 (requant(0) = 0). Such pieces (clear bits of `live`, from
//     packed_conv.live_pieces) get no MMA and no epilogue: the kernel
//     writes zeros.
//   - Epilogue: the accumulators go through shared memory (over the
//     regions); the per-lane constants and the sigmoid table are staged
//     once per block; each thread takes 16 lanes of one row and stores 16
//     bytes (int8) or 64 (int32). Epilogue constants are per LANE (128,):
//     lanes no channel uses carry r = 0, s = 1. The arithmetic is
//     epilogue.cuh's int64 reference requant. Tiles wholly in the head or
//     tail rows only write zeros.
#include <cstdint>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "wgmma.cuh"

namespace {

using namespace ayq;

constexpr int kMaxSlabs = 8;
constexpr int kMaxTaps = 32;
constexpr int LANES = 128;                 // a slab row: one tap's depth, the output's width
constexpr int PIECES = LANES / 16;         // n16 pieces of the 128 lanes
constexpr int BLOCK_BYTES = 512;           // one kept k32 x n16 block of a tap matrix
constexpr int BM = 128;                    // output rows per block: two warpgroups of 64
constexpr int NT = 256;                    // threads per block
constexpr int CS = LANES + 8;              // accumulator tile row stride (words)
constexpr int TILE_BYTES = BM * CS * 4;
constexpr int CONST_BYTES = (5 * LANES + kMaxLut) * 4;

// The launch plan (packed_conv.launch_plan): regions, taps, copies of kept
// blocks, and tap groups; every smem offset is in bytes from the block's
// shared memory.
struct Plan {
  const int8_t* x[kMaxSlabs];
  int rows[kMaxSlabs];             // R_ext of each slab
  int reg_slab[kMaxTaps];          // region: its slab,
  int reg_lo[kMaxTaps];            //   its first row relative to the tile's r0,
  int reg_rows[kMaxTaps];          //   its rows (a plane is reg_rows * 16 bytes),
  int reg_smem[kMaxTaps];          //   its place,
  int reg_kmask[kMaxTaps];         //   and the k32 rows its taps use (bit kc)
  int tap_a[kMaxTaps];             // tap: A's plane 0 at its first row,
  int tap_lbo[kMaxTaps];           //   the distance between A's planes,
  int tap_b[kMaxTaps];             //   its matrix's first kept block,
  uint32_t tap_mask[kMaxTaps];     //   and the matrix's kept blocks (bit 8*kc + nc)
  int cp_src[kMaxTaps];            // copy: first kept block in global memory,
  int cp_n[kMaxTaps];              //   blocks,
  int cp_dst[kMaxTaps];            //   place
  int grp_tap[kMaxTaps];           // group g: taps, regions and copies up to
  int grp_reg[kMaxTaps];           //   (excluding) these indices
  int grp_cp[kMaxTaps];
  int n_groups;
};

__device__ __forceinline__ uint32_t pack4(const int* v) {
  return (static_cast<uint32_t>(v[0]) & 0xff) | ((static_cast<uint32_t>(v[1]) & 0xff) << 8) |
         ((static_cast<uint32_t>(v[2]) & 0xff) << 16) | (static_cast<uint32_t>(v[3]) << 24);
}

// wb: int8 (n_blocks, 2, 16, 16): [i][p][n][j] = W[32 kc + 16 p + j][16 nc + n]
// for the i-th kept block (kc, nc), every matrix's blocks in bit order.
template <bool SILU>
__global__ void __launch_bounds__(NT, 2) packed_conv_kernel(
    const Plan pl, const int8_t* __restrict__ wb, const int* __restrict__ bias,
    const int* __restrict__ r1, const int* __restrict__ s1, const int* __restrict__ r2,
    const int* __restrict__ s2, const int* __restrict__ tab, int tab_lo, int tab_n,
    void* __restrict__ out, int m, int gp2, int head, int r_out_ext, uint32_t live,
    int main_bytes, int qmax) {
  extern __shared__ __align__(128) uint8_t smem[];
  int* s_const = reinterpret_cast<int*>(smem + main_bytes);  // bias, r1, s1, r2, s2
  int* s_tab = s_const + 5 * LANES;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int o0 = blockIdx.x * BM;   // first output row of the tile
  const int r0 = o0 - head;         // its row in the conv region
  // block-uniform: a tile wholly in the head or tail rows, or a conv with no
  // live piece, only writes zeros
  const bool active = r0 + BM > 0 && r0 < m && live != 0;

  if (active) {
    for (int i = tid; i < LANES; i += NT) {
      s_const[i] = bias[i];
      if (SILU) {
        s_const[LANES + i] = r1[i];
        s_const[2 * LANES + i] = s1[i];
        s_const[3 * LANES + i] = r2[i];
        s_const[4 * LANES + i] = s2[i];
      }
    }
    if (SILU) load_table(s_tab, tab, tab_n);

    const uint32_t base = smem_u32(smem);
    const int wg = tid >> 7;
    int acc[PIECES * 8];
#pragma unroll
    for (int i = 0; i < PIECES * 8; ++i) acc[i] = 0;

    int t0 = 0, reg0 = 0, cp0 = 0;
    for (int g = 0; g < pl.n_groups; ++g) {
      if (g > 0) __syncthreads();  // every warpgroup is done with group g - 1
      // A regions: thread pairs take a row, four depth planes each
      for (int reg = reg0; reg < pl.grp_reg[g]; ++reg) {
        const int si = pl.reg_slab[reg];
        const int rows = pl.reg_rows[reg];
        const int kmask = pl.reg_kmask[reg];
        const int first = r0 + pl.reg_lo[reg];  // slab row of the region's row 0
        const int8_t* x = pl.x[si] + static_cast<long long>(b) * pl.rows[si] * LANES;
        const uint32_t dst = base + pl.reg_smem[reg];
        for (int u = tid; u < 2 * rows; u += NT) {
          const int row = u >> 1;
          const int idx = first + row;
          const bool ok = idx >= 0 && idx < pl.rows[si];
          const int8_t* src = ok ? x + static_cast<long long>(idx) * LANES : x;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kc = (u & 1) * 4 + j;
            if ((kmask >> (kc >> 1)) & 1)
              cp_async16(dst + kc * rows * 16 + row * 16, src + kc * 16, ok ? 16 : 0);
          }
        }
      }
      // kept blocks of the group's matrices, 16 bytes a thread at a time
      for (int c = cp0; c < pl.grp_cp[g]; ++c) {
        const int8_t* src = wb + static_cast<long long>(pl.cp_src[c]) * BLOCK_BYTES;
        const uint32_t dst = base + pl.cp_dst[c];
        for (int q = tid; q < pl.cp_n[c] * (BLOCK_BYTES / 16); q += NT)
          cp_async16(dst + q * 16, src + q * 16, 16);
      }
      cp_async_commit();
      cp_async_wait<0>();
      fence_async_smem();
      __syncthreads();  // the group is in

#pragma unroll
      for (int i = 0; i < PIECES * 8; ++i) fence_reg(acc[i]);
      wgmma_fence();
      for (int t = t0; t < pl.grp_tap[g]; ++t) {
        const uint32_t mask = pl.tap_mask[t];
        const uint32_t lbo = pl.tap_lbo[t];
        const uint32_t a = base + pl.tap_a[t] + wg * 64 * 16;
        const uint32_t bt = base + pl.tap_b[t];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da = smem_desc(a + 2 * kk * lbo, lbo, 128);
#pragma unroll
          for (int nc = 0; nc < PIECES; ++nc) {
            const int bit = 8 * kk + nc;
            if ((mask >> bit) & 1) {
              const uint32_t blk = __popc(mask & ((1u << bit) - 1));  // its place among the kept
              Mma<16, false>::run(acc + 8 * nc, da,
                                  smem_desc(bt + blk * BLOCK_BYTES, BLOCK_BYTES / 2, 128));
            }
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < PIECES * 8; ++i) fence_reg(acc[i]);
      t0 = pl.grp_tap[g];
      reg0 = pl.grp_reg[g];
      cp0 = pl.grp_cp[g];
    }
    __syncthreads();  // the regions are free: the accumulator tile overwrites them

    // accumulator a of this thread: piece a / 8, lane 8*(a/4) + 2*(lane%4) +
    // a%2, row lane/4 + 8*((a/2)%2) of its warp's 16
    int* tile = reinterpret_cast<int*>(smem);
    const int lane = tid & 31;
    const int tr = (tid >> 5) * 16 + (lane >> 2);
    const int c0 = 2 * (lane & 3);
#pragma unroll
    for (int a = 0; a < PIECES * 8; a += 2) {
      if (!((live >> (a >> 3)) & 1)) continue;
      const int row = tr + ((a >> 1) & 1) * 8;
      const int col = 8 * (a >> 2) + c0;
      *reinterpret_cast<int2*>(tile + row * CS + col) = make_int2(acc[a], acc[a + 1]);
    }
  }
  __syncthreads();

  // 16 lanes of one row per item: coalesced 128-byte (int8) or 512-byte
  // (int32) output rows
  for (int g = tid; g < BM * PIECES; g += NT) {
    const int row = g / PIECES;
    const int nc = g % PIECES;
    const int o = o0 + row;
    if (o >= r_out_ext) break;
    const int r = o - head;
    bool valid = active && r >= 0 && r < m && ((live >> nc) & 1);
    if (valid) {
      const int u = r % gp2;
      valid = u != 0 && u != gp2 - 1;
    }
    const long long idx = (static_cast<long long>(b) * r_out_ext + o) * LANES + nc * 16;
    if (!valid) {
      if (SILU) {
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + idx) = make_uint4(0, 0, 0, 0);
      } else {
        int4* dst = reinterpret_cast<int4*>(static_cast<int*>(out) + idx);
#pragma unroll
        for (int q = 0; q < 4; ++q) dst[q] = make_int4(0, 0, 0, 0);
      }
      continue;
    }
    const int* trow = reinterpret_cast<const int*>(smem) + row * CS + nc * 16;
    auto cq = [&](int which, int q) {
      return *reinterpret_cast<const int4*>(s_const + which * LANES + nc * 16 + 4 * q);
    };
    int v[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 t = *reinterpret_cast<const int4*>(trow + 4 * q);
      const int4 bq = cq(0, q);
      v[4 * q] = t.x + bq.x;
      v[4 * q + 1] = t.y + bq.y;
      v[4 * q + 2] = t.z + bq.z;
      v[4 * q + 3] = t.w + bq.w;
    }
    if (SILU) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 a1 = cq(1, q), b1 = cq(2, q), a2 = cq(3, q), b2 = cq(4, q);
        int* w = v + 4 * q;
        w[0] = silu_epilogue(w[0], a1.x, b1.x, a2.x, b2.x, s_tab, tab_lo, qmax);
        w[1] = silu_epilogue(w[1], a1.y, b1.y, a2.y, b2.y, s_tab, tab_lo, qmax);
        w[2] = silu_epilogue(w[2], a1.z, b1.z, a2.z, b2.z, s_tab, tab_lo, qmax);
        w[3] = silu_epilogue(w[3], a1.w, b1.w, a2.w, b2.w, s_tab, tab_lo, qmax);
      }
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + idx) =
          make_uint4(pack4(v), pack4(v + 4), pack4(v + 8), pack4(v + 12));
    } else {
      int4* dst = reinterpret_cast<int4*>(static_cast<int*>(out) + idx);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        dst[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
}

template <bool SILU>
int launch(const Plan& pl, const int8_t* wb, const int* bias, const int* r1, const int* s1,
           const int* r2, const int* s2, const int* tab, int tab_lo, int tab_n, void* out,
           int B, int m, int gp2, int head, int r_out_ext, uint32_t live, int group_bytes,
           int qmax, cudaStream_t st) {
  const int main_bytes = group_bytes > TILE_BYTES ? group_bytes : TILE_BYTES;
  const int bytes = main_bytes + CONST_BYTES;
  // above 48 KB of shared memory only by this opt-in
  cudaError_t e = cudaFuncSetAttribute(packed_conv_kernel<SILU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(static_cast<unsigned>((r_out_ext + BM - 1) / BM), static_cast<unsigned>(B));
  packed_conv_kernel<SILU><<<grid, NT, bytes, st>>>(pl, wb, bias, r1, s1, r2, s2, tab, tab_lo,
                                                    tab_n, out, m, gp2, head, r_out_ext, live,
                                                    main_bytes, qmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// regions: (n_regions, 5) slab, lo, rows, smem, kmask; taps: (n_taps, 4)
// a, lbo, b, mask; copies: (n_copies, 3) src, n, dst; groups: (n_groups, 3)
// the tap, region and copy index each group ends at (packed_conv.launch_plan).
extern "C" int ayq_packed_conv(const void* const* xs, const int* x_rows, int n_x,
                               const int* regions, int n_regions, const int* taps, int n_taps,
                               const int* copies, int n_copies, const int* groups, int n_groups,
                               int group_bytes, const void* wb, const int* bias, const int* r1,
                               const int* s1, const int* r2, const int* s2, const int* tab,
                               int tab_lo, int tab_n, void* out, int silu, int B, int m, int gp2,
                               int head, int r_out_ext, unsigned live, int qmax, void* stream) {
  if (n_x < 1 || n_x > kMaxSlabs || n_taps < 1 || n_taps > kMaxTaps || n_regions > kMaxTaps ||
      n_copies > kMaxTaps || n_groups < 1 || n_groups > kMaxTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl = {};
  for (int i = 0; i < n_x; ++i) {
    pl.x[i] = static_cast<const int8_t*>(xs[i]);
    pl.rows[i] = x_rows[i];
  }
  for (int i = 0; i < n_regions; ++i) {
    const int* v = regions + 5 * i;
    pl.reg_slab[i] = v[0];
    pl.reg_lo[i] = v[1];
    pl.reg_rows[i] = v[2];
    pl.reg_smem[i] = v[3];
    pl.reg_kmask[i] = v[4];
  }
  for (int i = 0; i < n_taps; ++i) {
    const int* v = taps + 4 * i;
    pl.tap_a[i] = v[0];
    pl.tap_lbo[i] = v[1];
    pl.tap_b[i] = v[2];
    pl.tap_mask[i] = static_cast<uint32_t>(v[3]);
  }
  for (int i = 0; i < n_copies; ++i) {
    const int* v = copies + 3 * i;
    pl.cp_src[i] = v[0];
    pl.cp_n[i] = v[1];
    pl.cp_dst[i] = v[2];
  }
  for (int i = 0; i < n_groups; ++i) {
    const int* v = groups + 3 * i;
    pl.grp_tap[i] = v[0];
    pl.grp_reg[i] = v[1];
    pl.grp_cp[i] = v[2];
  }
  pl.n_groups = n_groups;
  const int8_t* w = static_cast<const int8_t*>(wb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (silu)
    return launch<true>(pl, w, bias, r1, s1, r2, s2, tab, tab_lo, tab_n, out, B, m, gp2, head,
                        r_out_ext, live, group_bytes, qmax, st);
  return launch<false>(pl, w, bias, r1, s1, r2, s2, tab, tab_lo, tab_n, out, B, m, gp2, head,
                       r_out_ext, live, group_bytes, qmax, st);
}
