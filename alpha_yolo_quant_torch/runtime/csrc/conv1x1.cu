// conv1x1: int8 (or wide int16) x int8 -> int32 1x1 convolution over NHWC rows
// with the SiLU requant chain, or the raw accumulator, fused.
//
// Replaces the TPU kernel alpha_yolo_quant_tpu/runtime/pallas_ops.py
// fused_conv1x1 (_conv1x1_silu_kernel and _conv1x1_plain_kernel): an MXU
// s8 matmul on 512-row tiles with the epilogue in VMEM. Here the GEMM is the
// wgmma tile of conv_igemm.cuh with KS = 1 (no taps, no padding). Unlike the
// TPU engine, wide inputs (int16 storage) run on the kernel too.
//
// Bound on an H100: bytes. A 1x1 conv does 2*Cin operations per output
// element, 26-340 per byte moved on yolov8n, below the card's int8 ridge
// (about 590). So the block covers the whole Cout (each input row crosses
// device memory once), the input streams through a cp.async ring, and the
// epilogue stores 16 contiguous bytes per thread.
#include "conv_igemm.cuh"

extern "C" int ayq_conv1x1(const void* x, int x_is_i16, const void* wp, const int* bias,
                           const int* r1, const int* s1, const int* r2, const int* s2,
                           const int* tab, int tab_lo, int tab_n, void* out, int silu,
                           int B, int H, int W, int Cin, int Cout, int qmax,
                           void* stream) {
  return ayq::launch_conv<1>(x, x_is_i16, wp, bias, r1, s1, r2, s2, tab, tab_lo, tab_n,
                             out, silu, B, H, W, Cin, Cout, 1, 0, qmax, stream);
}
