// conv3x3: 3x3 pad-1 convolution at stride 1 or 2 as an implicit GEMM, with the
// same two epilogues as conv1x1.
//
// Replaces the TPU kernel alpha_yolo_quant_tpu/runtime/pallas_ops.py
// fused_conv3x3, which built im2col patches with
// lax.conv_general_dilated_patches (9x the input bytes through HBM) and fed
// them to the fused 1x1 kernel. Here the patch matrix is never materialised:
// conv_igemm.cuh copies each tap's 16 channels from the NHWC input with
// cp.async and zero-fills taps outside the image. Depth is tap-major
// (k = (dy*3 + dx)*Cin + c), up to 9*256 on yolov8n; the Cin = 3 stem takes
// the gathered loader.
//
// Bound on an H100: operations for the widest layers. 128->128 at 20 px,
// 256->80 and the four 80-px head convs do 576-1152 operations per byte,
// above the card's int8 ridge (about 590), so the main loop runs on the int8
// tensor cores (wgmma, two warpgroups, 128 x Cout output tile per block),
// fed from a 4-stage shared-memory ring so loads overlap the MMAs. The
// narrow early layers (16-32 channels at 160-320 px) are bound by bytes,
// and the whole-Cout block reads their input once.
#include "conv_igemm.cuh"

extern "C" int ayq_conv3x3(const void* x, int x_is_i16, const void* wp, const int* bias,
                           const int* r1, const int* s1, const int* r2, const int* s2,
                           const int* tab, int tab_lo, int tab_n, void* out, int silu,
                           int B, int H, int W, int Cin, int Cout, int stride, int qmax,
                           void* stream) {
  return ayq::launch_conv<3>(x, x_is_i16, wp, bias, r1, s1, r2, s2, tab, tab_lo, tab_n,
                             out, silu, B, H, W, Cin, Cout, stride, 1, qmax, stream);
}
