// postconv: the epilogue of a conv whose accumulator arrives as two float32
// nibble-split partial convs, acc = 16*hi + lo + bias, then either the SiLU
// requant chain -> int8 or the raw int32 sum.
//
// Replaces the TPU kernels alpha_yolo_quant_tpu/runtime/pallas_ops.py
// fused_postconv_silu (_postconv_silu_kernel) and fused_postconv_plain
// (_postconv_plain_kernel): (32, 1024) VMEM tiles over the (B*C, H*W) view,
// per-row constants. Here one grid-stride elementwise pass over any layout:
// the channel of element i is (i / inner) % C, with inner the product of the
// dims after the channel axis (H*W for NCHW, 1 for NHWC). The SiLU chain is
// ayq::silu_epilogue (epilogue.cuh), the same exact int64 requant and table
// read as the conv kernels.
//
// Bound: bytes. Per element it reads 8 bytes (two float32) and writes 1
// (SiLU) or 4 (plain), against a few dozen integer operations, far below
// the card's compute line. Loads are coalesced 4-byte words; the per-channel
// constants come from L1.
#include "epilogue.cuh"

namespace {

template <bool SILU>
__global__ void __launch_bounds__(256) postconv_kernel(
    const float* __restrict__ hi, const float* __restrict__ lo,
    const int* __restrict__ bias, const int* __restrict__ r1, const int* __restrict__ s1,
    const int* __restrict__ r2, const int* __restrict__ s2, const int* __restrict__ tab,
    int tab_lo, int tab_n, void* __restrict__ out, long long n, int C, long long inner,
    int qmax) {
  __shared__ int s_tab[ayq::kMaxLut];
  if (SILU) {
    ayq::load_table(s_tab, tab, tab_n);
    __syncthreads();
  }
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int c = static_cast<int>((i / inner) % C);
    // the partials are integers below 2^24: the float -> int conversion is exact
    const int acc = static_cast<int>(hi[i]) * 16 + static_cast<int>(lo[i]) + bias[c];
    if (SILU) {
      static_cast<int8_t*>(out)[i] = static_cast<int8_t>(
          ayq::silu_epilogue(acc, r1[c], s1[c], r2[c], s2[c], s_tab, tab_lo, qmax));
    } else {
      static_cast<int*>(out)[i] = acc;
    }
  }
}

}  // namespace

extern "C" int ayq_postconv(const float* hi, const float* lo, const int* bias, const int* r1,
                            const int* s1, const int* r2, const int* s2, const int* tab,
                            int tab_lo, int tab_n, void* out, int silu, long long n, int C,
                            long long inner, int qmax, void* stream) {
  if (n == 0) return 0;
  const long long want = (n + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(want < 16384 ? want : 16384);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (silu) {
    postconv_kernel<true><<<blocks, 256, 0, st>>>(hi, lo, bias, r1, s1, r2, s2, tab, tab_lo,
                                                  tab_n, out, n, C, inner, qmax);
  } else {
    postconv_kernel<false><<<blocks, 256, 0, st>>>(hi, lo, bias, r1, s1, r2, s2, tab, tab_lo,
                                                   tab_n, out, n, C, inner, qmax);
  }
  return static_cast<int>(cudaGetLastError());
}
