// PTX helpers of the Hopper int8 tensor-core kernels (conv_igemm.cuh,
// packed_conv.cu): 16-byte cp.async copies, the async-proxy and wgmma
// fences, the no-swizzle shared-memory descriptor, and
// wgmma.mma_async.m64nNk32.s32.{s8,u8}.s8 for N = 16, 32, 64.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ayq {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 writes 16 zeros.
// Through L1 (.ca): neighbouring output rows read overlapping taps, and
// every block of an SM reads the same weights.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(a), "r"(b),
               "r"(c), "r"(d)
               : "memory");
}
// This thread's shared-memory writes, visible to the async proxy wgmma reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the async MMA.
__device__ __forceinline__ void fence_reg(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// wgmma shared-memory descriptor, no swizzle: core matrices of 8 rows x 16
// bytes (128 contiguous bytes); lbo = bytes between core matrices along K,
// sbo = bytes between 8-row groups along M or N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

#define AYQ_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define AYQ_R8(i) AYQ_R4(i), AYQ_R4(i + 4)
#define AYQ_SETP(n) "{\n.reg .pred p;\nsetp.ne.b32 p, %" #n ", 0;\n"

// D(64 x N, s32) += A(64 x 32, s8 or u8) * B(32 x N, s8), both from shared
// memory; d holds this thread's N/2 accumulators.
template <int N, bool U8A>
struct Mma;

#define AYQ_MMA16(AT)                                                             \
  asm volatile(AYQ_SETP(10) "wgmma.mma_async.sync.aligned.m64n16k32.s32." AT      \
                            ".s8 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n" \
               : AYQ_R8(0)                                                        \
               : "l"(da), "l"(db), "r"(1))
#define AYQ_MMA32(AT)                                                              \
  asm volatile(AYQ_SETP(18) "wgmma.mma_async.sync.aligned.m64n32k32.s32." AT       \
                            ".s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, " \
                            "%12, %13, %14, %15}, %16, %17, p;\n}\n"                \
               : AYQ_R8(0), AYQ_R8(8)                                              \
               : "l"(da), "l"(db), "r"(1))
#define AYQ_MMA64(AT)                                                                 \
  asm volatile(AYQ_SETP(34) "wgmma.mma_async.sync.aligned.m64n64k32.s32." AT          \
                            ".s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "    \
                            "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "    \
                            "%23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, " \
                            "p;\n}\n"                                                  \
               : AYQ_R8(0), AYQ_R8(8), AYQ_R8(16), AYQ_R8(24)                          \
               : "l"(da), "l"(db), "r"(1))

template <> struct Mma<16, false> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) { AYQ_MMA16("s8"); }
};
template <> struct Mma<16, true> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) { AYQ_MMA16("u8"); }
};
template <> struct Mma<32, false> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) { AYQ_MMA32("s8"); }
};
template <> struct Mma<32, true> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) { AYQ_MMA32("u8"); }
};
template <> struct Mma<64, false> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) { AYQ_MMA64("s8"); }
};
template <> struct Mma<64, true> {
  static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) { AYQ_MMA64("u8"); }
};

#undef AYQ_MMA16
#undef AYQ_MMA32
#undef AYQ_MMA64
#undef AYQ_SETP
#undef AYQ_R8
#undef AYQ_R4

}  // namespace ayq
