// dwconv: a depthwise 3x3 conv, stride 1, pad 1, over int8 NHWC, with the
// conv kernels' epilogue: the SiLU chain of epilogue.cuh, or the plain
// requant where the wrapper hands it the table of ones (fused_ops.dwconv3x3,
// quantize/luts.unit_lut), each into int8.
//
// Replaces no TPU kernel: the JAX package has no YOLO11 and no grouped conv.
// YOLO11 has seven: two in each Detect cls branch (DWConv(x, x, 3) and
// DWConv(c3, c3, 3)) and the attention's pe. The plain version is
// fused_ops.dwconv3x3_plain (an exact float64 grouped conv, then the int64
// epilogue), and this kernel equals it bit for bit:
//   acc[c] = bias[c] + sum_{dy,dx} x[y+dy, x+dx, c] * w[(dy+1)*3 + dx+1, c]
//   out[c] = silu_epilogue(acc[c], r1[c], s1[c], r2[c], s2[c], table)
// with the pad taps left out of the sum (zeros).
//
// Bound on an H100: bytes. An output element takes 9 multiply-adds and two
// requants against 2 bytes of device memory (one in, one out: the 3x3
// window's other reads hit L1 and L2), while the dense conv kernels have
// Cin * 9 multiply-adds an element. At B = 128 yolo11m's seven move about
// 1.26 GB, 0.38 ms at 3.35 TB/s.
//
// Design: one thread an output pixel and 16 channels: nine 16-byte loads of
// the window's taps (neighbouring threads read neighbouring channels, so a
// warp's loads are whole 512-byte rows), nine 16-byte loads of the (9, C)
// tap-major weights, 16 int32 sums in registers, the per-channel constants
// as 16-byte loads, and one 16-byte store. A grid-stride loop over (B, H, W,
// C / 16).
#include <cstdint>

#include "epilogue.cuh"

namespace {

constexpr int kDwThreads = 256;
constexpr int kDwVec = 16;   // channels a thread: one 16-byte load

__device__ __forceinline__ int byte_of(const int4& v, int e) {
  const int w = e < 4 ? v.x : (e < 8 ? v.y : (e < 12 ? v.z : v.w));
  return static_cast<int>(static_cast<int8_t>(w >> (8 * (e & 3))));
}

__device__ __forceinline__ void load16(int (&d)[kDwVec], const int* __restrict__ p) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 v = __ldg(q + k);
    d[4 * k] = v.x;
    d[4 * k + 1] = v.y;
    d[4 * k + 2] = v.z;
    d[4 * k + 3] = v.w;
  }
}

__global__ void __launch_bounds__(kDwThreads) dwconv3x3_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const int* __restrict__ bias, const int* __restrict__ r1, const int* __restrict__ s1,
    const int* __restrict__ r2, const int* __restrict__ s2, const int* __restrict__ tab,
    int tab_lo, int tab_n, int8_t* __restrict__ out, int B, int H, int W, int C, int qmax) {
  __shared__ int s_tab[ayq::kMaxLut];
  ayq::load_table(s_tab, tab, tab_n);
  __syncthreads();
  const int groups = C / kDwVec;
  const long long total = static_cast<long long>(B) * H * W * groups;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    const int c0 = static_cast<int>(i % groups) * kDwVec;
    const long long pix = i / groups;
    const int px = static_cast<int>(pix % W);
    const long long row = pix / W;   // b * H + y
    const int py = static_cast<int>(row % H);
    int acc[kDwVec];
    load16(acc, bias + c0);
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      if (py + dy < 0 || py + dy >= H) continue;
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (px + dx < 0 || px + dx >= W) continue;
        const int4 xv = __ldg(reinterpret_cast<const int4*>(
            x + ((row + dy) * W + px + dx) * C + c0));
        const int4 wv = __ldg(reinterpret_cast<const int4*>(
            w + static_cast<long long>((dy + 1) * 3 + dx + 1) * C + c0));
#pragma unroll
        for (int e = 0; e < kDwVec; ++e) acc[e] += byte_of(xv, e) * byte_of(wv, e);
      }
    }
    int m1[kDwVec], h1[kDwVec], m2[kDwVec], h2[kDwVec];
    load16(m1, r1 + c0);
    load16(h1, s1 + c0);
    load16(m2, r2 + c0);
    load16(h2, s2 + c0);
    int packed[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < kDwVec; ++e) {
      const int y = ayq::silu_epilogue(acc[e], m1[e], h1[e], m2[e], h2[e], s_tab, tab_lo, qmax);
      packed[e >> 2] |= (y & 0xff) << (8 * (e & 3));
    }
    *reinterpret_cast<int4*>(out + pix * C + c0) =
        make_int4(packed[0], packed[1], packed[2], packed[3]);
  }
}

}  // namespace

extern "C" int ayq_dwconv3x3(const int8_t* x, const int8_t* w, const int* bias, const int* r1,
                             const int* s1, const int* r2, const int* s2, const int* tab,
                             int tab_lo, int tab_n, int8_t* out, int B, int H, int W, int C,
                             int qmax, void* stream) {
  const long long total = static_cast<long long>(B) * H * W * (C / kDwVec);
  if (total == 0) return 0;
  const long long want = (total + kDwThreads - 1) / kDwThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  dwconv3x3_kernel<<<blocks, kDwThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, r1, s1, r2, s2, tab, tab_lo, tab_n, out, B, H, W, C, qmax);
  return static_cast<int>(cudaGetLastError());
}
