// PTX helpers of the Hopper int8 tensor-core kernels (conv_igemm.cuh,
// packed_conv.cu): 16-byte cp.async copies, the async-proxy and wgmma
// fences, the shared-memory descriptors (no swizzle, and the 128-byte swizzle
// that TMA writes), mbarriers, TMA tile loads, setmaxnreg, and
// wgmma.mma_async.m64nNk32.s32.{s8,u8}.s8 for every N = 16, 32, ..., 256.
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
// An arrival on the mbarrier once every cp.async this thread has issued so
// far has landed; .noinc: the barrier's count includes this arrival.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
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

// K-major operand in the 128-byte swizzle: row r (an M or N index) holds 128
// bytes of depth at r*128, its 16-byte chunk c stored at chunk c ^ (r % 8);
// 8-row groups 1024 bytes apart, the tile 1024-byte aligned. A k32 step j
// starts 32*j bytes into the rows (the hardware applies the swizzle to the
// address it forms, so the step needs no base offset).
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Makes the initialised barriers visible to the other threads and to TMA.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival, and `bytes` more to come from TMA before the phase completes.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the completion of the barrier's phase of this parity. A phase
// that never completes is a fault of the kernel: trap (the launch fails with
// an error) instead of hanging the card. The margin: a failed try_wait
// suspends the thread for about 7,790 cycles before it returns, so 2^22
// polls take 16.4 s on an H100 at 700 W, with 1 thread or 132 blocks of 384
// polling. A wait lies within its kernel's run, and the longest conv kernel
// of the benchmark cells (yolov8m's stem at B=128) takes 2.9 ms: over 5,000
// times less.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try(bar, parity);)
    if (++n == (1u << 22)) __trap();
}

// TMA: the box of a 2-D tensor map at (c0, c1) (innermost first) into shared
// memory, its bytes reported to the barrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Named barrier over `n` threads (id 0 is __syncthreads).
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Register budget of the calling warpgroup (all 128 threads, one value).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ------------------------------------------------------------------ wgmma

#define AYQ_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define AYQ_R8(i) AYQ_R4(i), AYQ_R4(i + 4)
// AYQ_LH: the operand list "%0, ..., %(H-1)" of H accumulators; AYQ_DH:
// their "+r" constraints, d[0] .. d[H-1]. H = N/2, a multiple of 8.
#define AYQ_L8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define AYQ_D8 AYQ_R8(0)
#define AYQ_L16 AYQ_L8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define AYQ_D16 AYQ_D8, AYQ_R8(8)
#define AYQ_L24 AYQ_L16 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define AYQ_D24 AYQ_D16, AYQ_R8(16)
#define AYQ_L32 AYQ_L24 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define AYQ_D32 AYQ_D24, AYQ_R8(24)
#define AYQ_L40 AYQ_L32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define AYQ_D40 AYQ_D32, AYQ_R8(32)
#define AYQ_L48 AYQ_L40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define AYQ_D48 AYQ_D40, AYQ_R8(40)
#define AYQ_L56 AYQ_L48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define AYQ_D56 AYQ_D48, AYQ_R8(48)
#define AYQ_L64 AYQ_L56 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define AYQ_D64 AYQ_D56, AYQ_R8(56)
#define AYQ_L72 AYQ_L64 ", %64, %65, %66, %67, %68, %69, %70, %71"
#define AYQ_D72 AYQ_D64, AYQ_R8(64)
#define AYQ_L80 AYQ_L72 ", %72, %73, %74, %75, %76, %77, %78, %79"
#define AYQ_D80 AYQ_D72, AYQ_R8(72)
#define AYQ_L88 AYQ_L80 ", %80, %81, %82, %83, %84, %85, %86, %87"
#define AYQ_D88 AYQ_D80, AYQ_R8(80)
#define AYQ_L96 AYQ_L88 ", %88, %89, %90, %91, %92, %93, %94, %95"
#define AYQ_D96 AYQ_D88, AYQ_R8(88)
#define AYQ_L104 AYQ_L96 ", %96, %97, %98, %99, %100, %101, %102, %103"
#define AYQ_D104 AYQ_D96, AYQ_R8(96)
#define AYQ_L112 AYQ_L104 ", %104, %105, %106, %107, %108, %109, %110, %111"
#define AYQ_D112 AYQ_D104, AYQ_R8(104)
#define AYQ_L120 AYQ_L112 ", %112, %113, %114, %115, %116, %117, %118, %119"
#define AYQ_D120 AYQ_D112, AYQ_R8(112)
#define AYQ_L128 AYQ_L120 ", %120, %121, %122, %123, %124, %125, %126, %127"
#define AYQ_D128 AYQ_D120, AYQ_R8(120)
#define AYQ_WGMMA(N, AT, REGS, DA, DB, P)                                                \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\nwgmma.mma_async.sync.aligned.m64n" #N \
  "k32.s32." AT ".s8 {" REGS "}, %" DA ", %" DB ", p;\n}\n"

// D(64 x N, s32) += A(64 x 32, s8 or u8) * B(32 x N, s8), both from shared
// memory; d holds this thread's N/2 accumulators: accumulator a sits at
// column 8*(a/4) + 2*(lane%4) + a%2 and row lane/4 + 8*((a/2)%2) of its
// warp's 16 rows.
template <int N, bool U8A>
struct Mma;

// N columns, H = N/2 accumulators, then the operand numbers of the two
// descriptors and of the scale-d flag: H, H + 1 and H + 2.
#define AYQ_MMA(N, H, DA, DB, P)                                                          \
  template <bool U8A>                                                                     \
  struct Mma<N, U8A> {                                                                    \
    static __device__ __forceinline__ void run(int* d, uint64_t da, uint64_t db) {        \
      if constexpr (U8A)                                                                  \
        asm volatile(AYQ_WGMMA(N, "u8", AYQ_L##H, DA, DB, P)                              \
                     : AYQ_D##H                                                           \
                     : "l"(da), "l"(db), "r"(1));                                         \
      else                                                                                \
        asm volatile(AYQ_WGMMA(N, "s8", AYQ_L##H, DA, DB, P)                              \
                     : AYQ_D##H                                                           \
                     : "l"(da), "l"(db), "r"(1));                                         \
    }                                                                                     \
  }

AYQ_MMA(16, 8, "8", "9", "10");
AYQ_MMA(32, 16, "16", "17", "18");
AYQ_MMA(48, 24, "24", "25", "26");
AYQ_MMA(64, 32, "32", "33", "34");
AYQ_MMA(80, 40, "40", "41", "42");
AYQ_MMA(96, 48, "48", "49", "50");
AYQ_MMA(112, 56, "56", "57", "58");
AYQ_MMA(128, 64, "64", "65", "66");
AYQ_MMA(144, 72, "72", "73", "74");
AYQ_MMA(160, 80, "80", "81", "82");
AYQ_MMA(176, 88, "88", "89", "90");
AYQ_MMA(192, 96, "96", "97", "98");
AYQ_MMA(208, 104, "104", "105", "106");
AYQ_MMA(224, 112, "112", "113", "114");
AYQ_MMA(240, 120, "120", "121", "122");
AYQ_MMA(256, 128, "128", "129", "130");

#undef AYQ_MMA
#undef AYQ_WGMMA
#undef AYQ_L8
#undef AYQ_D8
#undef AYQ_L16
#undef AYQ_D16
#undef AYQ_L24
#undef AYQ_D24
#undef AYQ_L32
#undef AYQ_D32
#undef AYQ_L40
#undef AYQ_D40
#undef AYQ_L48
#undef AYQ_D48
#undef AYQ_L56
#undef AYQ_D56
#undef AYQ_L64
#undef AYQ_D64
#undef AYQ_L72
#undef AYQ_D72
#undef AYQ_L80
#undef AYQ_D80
#undef AYQ_L88
#undef AYQ_D88
#undef AYQ_L96
#undef AYQ_D96
#undef AYQ_L104
#undef AYQ_D104
#undef AYQ_L112
#undef AYQ_D112
#undef AYQ_L120
#undef AYQ_D120
#undef AYQ_L128
#undef AYQ_D128
#undef AYQ_R8
#undef AYQ_R4

}  // namespace ayq
