// attn: the integer attention of YOLO11's PSABlock, every image and head of
// one AttentionNode in one launch, on int8 tensor cores (mma.sync
// m16n8k32).
//
// Replaces no TPU kernel: the JAX package has no YOLO11. The contract is
// runtime/golden.py attention_np; the plain version is
// fused_ops.attention_plain, and this kernel equals it bit for bit. Per
// image b and head h, over the N pixels of the map, with q, k (key_dim 32)
// and v (head_dim 64) the head's channels of the int8 NHWC qkv edge:
//   L   = q^T k                                 exact int32
//   Lq  = requant(L, lr, ls, 127)               8 bits
//   e   = exp_tab[Lq - rowmax(Lq) + 255]        in [0, 127]
//   S   = sum_m e,  A = sum_m e * v             exact int32
//   out = requant(floor(A / S), or, os, qmax)   int8, channel h * 64 + d
// and the v channels are written out as they are (vout, the pe conv's
// input), in the same channel order.
//
// Bound on an H100: neither bytes nor tensor ops. At B = 128 and N = 400
// (yolo11m at 640 px) the inputs and outputs are about 39 MB (12 us at
// 3.35 TB/s) and the two products 2 * N^2 * (32 + 64) ops an image and
// head (16 us at the int8 peak); the requant, the row max and the table
// read of every logit run twice on the integer units.
//
// Design: one block of 8 warps an (image, head). The head's q, k and v go
// to shared memory once: q and k as rows of 32 bytes a pixel (the MMAs' A
// and B fragments are 4-byte reads of them), v transposed to 64 rows of
// pixels. A warp takes 16 query rows at a time. Pass 1 runs the logits
// 8 columns an MMA and keeps the row max of their requant. Pass 2 runs them
// again, 32 columns at a time, turns them into e in registers and feeds e
// straight to the second MMA as its A fragment: the logits' accumulator
// layout gives a thread the columns 2t, 2t+1 of each 8-column tile, and the
// A fragment wants 4 consecutive depth indices, so the depth of each chunk
// of 32 pixels is permuted (perm32) and v's pixels are stored in that order.
// The sums are exact in any order, so the permutation changes nothing. Rows
// and columns past N are zero in shared memory, masked out of the max and
// given e = 0.
#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int kKd = 32;               // key_dim: the logits' depth, one k32 MMA
constexpr int kHd = 64;               // head_dim: 8 tiles of 8 output columns
constexpr int kPer = 2 * kKd + kHd;   // a head's qkv channels
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kExpN = 256;            // the exponent table over [-255, 0]

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ int byte_of(const int4& v, int e) {
  const int w = e < 4 ? v.x : (e < 8 ? v.y : (e < 12 ? v.z : v.w));
  return static_cast<int>(static_cast<int8_t>(w >> (8 * (e & 3))));
}

// The second product's depth order inside a chunk of 32 pixels: pixel
// 8t + 2j + b (tile t, thread j of its quad, column b) sits at depth
// 16 * (t / 2) + 4j + 2 * (t % 2) + b, where the A fragment of thread j
// holds it.
__device__ __forceinline__ int perm32(int m) {
  const int t = (m >> 3) & 3, j = (m >> 1) & 3, b = m & 1;
  return (m & ~31) | ((t >> 1) << 4) | (j << 2) | ((t & 1) << 1) | b;
}

__device__ __forceinline__ int floor_div(int a, int s) {   // s > 0
  const int q = a / s;
  return (a % s != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ void logits(int (&d)[4], const unsigned (&a)[4],
                                       const int8_t* s_k, int m0, int g, int t4) {
  d[0] = d[1] = d[2] = d[3] = 0;
  const int8_t* kr = s_k + (m0 + g) * kKd + 4 * t4;
  mma_s8(d, a, ld32(kr), ld32(kr + 16));
}

__global__ void __launch_bounds__(kThreads) attn_kernel(
    const int8_t* __restrict__ qkv, int8_t* __restrict__ out, int8_t* __restrict__ vout,
    const int* __restrict__ exp_tab, int N, int heads, int lr, int ls, int orr, int os,
    int qmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n16 = (N + 15) & ~15, n32 = (N + 31) & ~31;
  int* s_tab = reinterpret_cast<int*>(smem);
  int8_t* s_q = reinterpret_cast<int8_t*>(smem + kExpN * 4);   // [n16][32]
  int8_t* s_k = s_q + n16 * kKd;                                 // [n32][32]
  int8_t* s_v = s_k + n32 * kKd;                                 // [64][n32], perm32
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const long long C = static_cast<long long>(heads) * kPer;
  const long long Cv = static_cast<long long>(heads) * kHd;

  for (int i = threadIdx.x; i < kExpN; i += kThreads) s_tab[i] = exp_tab[i];
  for (int p = threadIdx.x; p < n32; p += kThreads) {
    int4 part[8];
    if (p < N) {
      const int4* src = reinterpret_cast<const int4*>(
          qkv + (static_cast<long long>(b) * N + p) * C + h * kPer);
#pragma unroll
      for (int k = 0; k < 8; ++k) part[k] = __ldg(src + k);
      int4* vo = reinterpret_cast<int4*>(vout + (static_cast<long long>(b) * N + p) * Cv +
                                         h * kHd);
#pragma unroll
      for (int k = 0; k < 4; ++k) vo[k] = part[4 + k];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) part[k] = make_int4(0, 0, 0, 0);
    }
    if (p < n16) {
      reinterpret_cast<int4*>(s_q + p * kKd)[0] = part[0];
      reinterpret_cast<int4*>(s_q + p * kKd)[1] = part[1];
    }
    reinterpret_cast<int4*>(s_k + p * kKd)[0] = part[2];
    reinterpret_cast<int4*>(s_k + p * kKd)[1] = part[3];
    const int pp = perm32(p);
#pragma unroll
    for (int d = 0; d < kHd; ++d)
      s_v[d * n32 + pp] = static_cast<int8_t>(byte_of(part[4 + (d >> 4)], d & 15));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  for (int r0 = 16 * warp; r0 < N; r0 += 16 * kWarps) {
    unsigned a[4];
    a[0] = ld32(s_q + (r0 + g) * kKd + 4 * t4);
    a[1] = ld32(s_q + (r0 + g + 8) * kKd + 4 * t4);
    a[2] = ld32(s_q + (r0 + g) * kKd + 16 + 4 * t4);
    a[3] = ld32(s_q + (r0 + g + 8) * kKd + 16 + 4 * t4);

    // pass 1: the row max of the requantized logits (|Lq| <= 127)
    int mx0 = -128, mx1 = -128;
    for (int m0 = 0; m0 < N; m0 += 8) {
      int d[4];
      logits(d, a, s_k, m0, g, t4);
      const int m = m0 + 2 * t4;
      if (m < N) {
        mx0 = max(mx0, ayq::requant_as<int>(d[0], lr, ls, 127));
        mx1 = max(mx1, ayq::requant_as<int>(d[2], lr, ls, 127));
      }
      if (m + 1 < N) {
        mx0 = max(mx0, ayq::requant_as<int>(d[1], lr, ls, 127));
        mx1 = max(mx1, ayq::requant_as<int>(d[3], lr, ls, 127));
      }
    }
    mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));

    // pass 2: e, its row sums and e * v^T, 32 pixels at a time
    int acc[8][4];
#pragma unroll
    for (int jd = 0; jd < 8; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0;
    int sum0 = 0, sum1 = 0;
    for (int c0 = 0; c0 < N; c0 += 32) {
      unsigned e8[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int d[4];
        logits(d, a, s_k, c0 + 8 * j, g, t4);
        const int m = c0 + 8 * j + 2 * t4;
        const int e0 = m < N ? s_tab[ayq::requant_as<int>(d[0], lr, ls, 127) - mx0 + 255] : 0;
        const int e1 = m + 1 < N ? s_tab[ayq::requant_as<int>(d[1], lr, ls, 127) - mx0 + 255] : 0;
        const int e2 = m < N ? s_tab[ayq::requant_as<int>(d[2], lr, ls, 127) - mx1 + 255] : 0;
        const int e3 = m + 1 < N ? s_tab[ayq::requant_as<int>(d[3], lr, ls, 127) - mx1 + 255] : 0;
        sum0 += e0 + e1;
        sum1 += e2 + e3;
        // tile j's two columns are bytes 2 (j % 2) and 2 (j % 2) + 1 of the
        // A register of its rows: 0 and 1 (depth 0-15) for j < 2, else 2 and 3
        const int sh = 16 * (j & 1);
        e8[(j >> 1) * 2] |= static_cast<unsigned>(e0 | (e1 << 8)) << sh;
        e8[(j >> 1) * 2 + 1] |= static_cast<unsigned>(e2 | (e3 << 8)) << sh;
      }
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        const int8_t* vr = s_v + (8 * jd + g) * n32 + c0 + 4 * t4;
        mma_s8(acc[jd], e8, ld32(vr), ld32(vr + 16));
      }
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = r0 + g + 8 * half;
      if (row >= N) continue;
      const int s = half ? sum1 : sum0;   // >= 127: the row's max gives exp(0)
      int8_t* o = out + (static_cast<long long>(b) * N + row) * Cv + h * kHd + 2 * t4;
#pragma unroll
      for (int jd = 0; jd < 8; ++jd) {
        const int y0 = ayq::requant_as<int>(floor_div(acc[jd][2 * half], s), orr, os, qmax);
        const int y1 = ayq::requant_as<int>(floor_div(acc[jd][2 * half + 1], s), orr, os, qmax);
        *reinterpret_cast<unsigned short*>(o + 8 * jd) =
            static_cast<unsigned short>((y0 & 0xff) | ((y1 & 0xff) << 8));
      }
    }
  }
}

}  // namespace

extern "C" int ayq_attention(const int8_t* qkv, int8_t* out, int8_t* vout, const int* exp_tab,
                             int B, int N, int heads, int lr, int ls, int orr, int os, int qmax,
                             void* stream) {
  if (B == 0 || N == 0 || heads == 0) return 0;
  const int n16 = (N + 15) & ~15, n32 = (N + 31) & ~31;
  const int smem = kExpN * 4 + n16 * kKd + n32 * kKd + kHd * n32;
  cudaError_t err =
      cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_kernel<<<B * heads, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      qkv, out, vout, exp_tab, N, heads, lr, ls, orr, os, qmax);
  return static_cast<int>(cudaGetLastError());
}
