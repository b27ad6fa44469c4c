// sigma_probe: evaluates the conv epilogue's own sigmoid lookup
// (epilogue.cuh sigma_lookup, from a shared-memory copy of the table) over
// every index of the LUT domain.
//
// Replaces the TPU kernel alpha_yolo_quant_tpu/runtime/pallas_ops.py
// pallas_sigma_corrections (_sigma_probe_kernel), which checked Mosaic's
// in-kernel arithmetic sigmoid against the exact table and returned fixups.
// The Hopper epilogue reads the table itself, so on the card the fixups must
// come back empty; the probe proves that the device path (table load,
// indexing, lo offset) returns Lut.values entry for entry. One block; the
// work is 255 loads and is bound by the launch.
#include "epilogue.cuh"

namespace {

__global__ void sigma_probe_kernel(const int* __restrict__ tab, int lo, int n,
                                   int* __restrict__ out) {
  __shared__ int s_tab[ayq::kMaxLut];
  ayq::load_table(s_tab, tab, n);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    out[i] = ayq::sigma_lookup(s_tab, lo + i, lo);
}

}  // namespace

extern "C" int ayq_sigma_probe(const int* tab, int lo, int n, int* out, void* stream) {
  sigma_probe_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(tab, lo, n, out);
  return static_cast<int>(cudaGetLastError());
}
