// glue: one residual add or one concat of the forward's graph as one launch
// that reads each int8/int16 NHWC source once, requantizes in registers and
// writes the int8/int16 output once.
//
// Replaces no TPU kernel: the JAX package leaves these nodes to XLA, which
// fuses their elementwise chains itself (alpha_yolo_quant_tpu/runtime/
// interpreter.py). The port ran them as chains of torch elementwise ops,
// about 11 passes over int32 tensors in device memory per add and 7 per
// requantized concat source. The plain version is runtime/fused_ops.py
// residual_add_plain and concat_plain, and this kernel equals it bit for bit:
//   add:    out = narrow(clip(requant(src, r, s, qmax) + base, +-bound))
//   concat: out[..., off_i : off_i + C_i] = narrow(req_i ? requant(src_i) : src_i)
// with requant epilogue.cuh's formula, the clip only where the model bounds
// the node, and narrow the two's-complement truncation to the output's int8
// or int16, as torch's .to() does.
//
// Bound on an H100: bytes, but not by far. An element moves 2-5 bytes (int8
// or int16 sources, base and output) against a dozen integer operations, and
// the card's 32-bit integer units do about that many in the time 3.35 TB/s
// moves those bytes. So the requant runs in 32 bits (requant_as<int>: the
// wrapper shows |r * x| < 2^31 first, and the value is then the int64
// formula's; with the requant in int64 the kernel measured 4.6-10.1% slower
// on every add and concat node of yolov8n, yolov8m and yolov8m-p6), loads
// and stores move 16 bytes a thread, and no intermediate touches device
// memory.
//
// Design: the wrapper cuts the node into parts, one per source: an add is one
// part, a concat one per source. A part is `rows` (B*H*W) rows of `cols` (its
// channels) contiguous source elements whose output rows lie `out_stride`
// elements (the output's channels) apart. All parts share one grid: a block
// belongs to the part whose `first_block` range holds it. Each thread moves
// kGlueUnroll units, all loads first; a unit is 16 elements where the part's
// width, output stride and pointers allow 16-byte accesses, else one element.
#include <climits>

#include "epilogue.cuh"

namespace ayq {

constexpr int kGlueParts = 8;     // a node's sources: yolov8x's widest C2f has 2 + 6
constexpr int kGlueThreads = 256;
constexpr int kGlueUnroll = 2;    // units a thread moves (4: 98 registers, 6-9% slower)
constexpr int kGlueVec = 16;      // elements a vector unit moves
constexpr int kGlueMeta = 7;      // ints a part takes in the C entry's meta

struct GluePart {
  const void* src;
  const void* base;       // the add's other operand, laid out as src; null in a concat
  void* out;              // the part's first output element
  long long rows;
  long long first_block;  // the part's first block in the grid
  int cols, out_stride, src16, base16, req, r, s, vec;
};

struct GlueArgs {
  GluePart part[kGlueParts];
  int n_parts, out16, qmax, clip, bound;
};

// 16 values of T: one 16-byte word for int8, two for int16
template <typename T>
struct Raw16 {
  int4 w[sizeof(T)];
};

__device__ __forceinline__ int word_of(const int4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

template <typename T>
__device__ __forceinline__ Raw16<T> load16(const void* p, long long unit) {
  const int4* q = reinterpret_cast<const int4*>(static_cast<const T*>(p) + unit * kGlueVec);
  Raw16<T> r;
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T)); ++k) r.w[k] = q[k];
  return r;
}

// value e of the 16, sign-extended
template <typename T>
__device__ __forceinline__ int lane(const Raw16<T>& r, int e) {
  constexpr int per_word = 4 / sizeof(T);
  const int wi = e / per_word;
  const int bits = (e % per_word) * 8 * static_cast<int>(sizeof(T));
  return static_cast<int>(static_cast<T>(word_of(r.w[wi / 4], wi % 4) >> bits));
}

// the 16 values, each truncated to T, at element `elem` of p
template <typename T>
__device__ __forceinline__ void store16(void* p, long long elem, const int* v) {
  constexpr int per_word = 4 / sizeof(T);
  constexpr unsigned mask = sizeof(T) == 1 ? 0xffu : 0xffffu;
  int words[4 * sizeof(T)];
#pragma unroll
  for (int k = 0; k < 4 * static_cast<int>(sizeof(T)); ++k) {
    unsigned w = 0;
#pragma unroll
    for (int j = 0; j < per_word; ++j)
      w |= (static_cast<unsigned>(v[k * per_word + j]) & mask) << (j * 8 * sizeof(T));
    words[k] = static_cast<int>(w);
  }
  int4* q = reinterpret_cast<int4*>(static_cast<T*>(p) + elem);
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(T)); ++k)
    q[k] = make_int4(words[4 * k], words[4 * k + 1], words[4 * k + 2], words[4 * k + 3]);
}

template <bool BASE>
__device__ __forceinline__ int combine(int x, int b, const GluePart& pt, const GlueArgs& a) {
  int v = pt.req ? requant_as<int>(x, pt.r, pt.s, a.qmax) : x;
  if constexpr (BASE) {
    v += b;
    if (a.clip) v = v < -a.bound ? -a.bound : (v > a.bound ? a.bound : v);
  }
  return v;
}

// this thread's units of one part, the first at `first`
template <typename TS, typename TB, typename TO, bool BASE>
__device__ __forceinline__ void run_part(const GluePart& pt, const GlueArgs& a,
                                         long long first) {
  if (pt.vec) {
    const int chunks = pt.cols / kGlueVec;
    const long long units = pt.rows * chunks;
    Raw16<TS> xs[kGlueUnroll];
    Raw16<TB> bs[kGlueUnroll];
#pragma unroll
    for (int j = 0; j < kGlueUnroll; ++j) {
      const long long u = first + j * kGlueThreads;
      if (u < units) {
        xs[j] = load16<TS>(pt.src, u);
        if constexpr (BASE) bs[j] = load16<TB>(pt.base, u);
      }
    }
#pragma unroll
    for (int j = 0; j < kGlueUnroll; ++j) {
      const long long u = first + j * kGlueThreads;
      if (u < units) {
        const long long row = u / chunks;
        const long long elem = row * pt.out_stride + (u - row * chunks) * kGlueVec;
        int v[kGlueVec];
#pragma unroll
        for (int e = 0; e < kGlueVec; ++e) {
          int b = 0;
          if constexpr (BASE) b = lane(bs[j], e);
          v[e] = combine<BASE>(lane(xs[j], e), b, pt, a);
        }
        store16<TO>(pt.out, elem, v);
      }
    }
  } else {
    const long long n = pt.rows * pt.cols;
#pragma unroll
    for (int j = 0; j < kGlueUnroll; ++j) {
      const long long e = first + j * kGlueThreads;
      if (e < n) {
        const long long row = e / pt.cols;
        int b = 0;
        if constexpr (BASE) b = static_cast<const TB*>(pt.base)[e];
        const int v = combine<BASE>(static_cast<const TS*>(pt.src)[e], b, pt, a);
        static_cast<TO*>(pt.out)[row * pt.out_stride + (e - row * pt.cols)] =
            static_cast<TO>(v);
      }
    }
  }
}

template <typename TS, typename TO>
__device__ __forceinline__ void run_base(const GluePart& pt, const GlueArgs& a,
                                         long long first) {
  if (pt.base == nullptr)
    run_part<TS, int8_t, TO, false>(pt, a, first);
  else if (pt.base16)
    run_part<TS, int16_t, TO, true>(pt, a, first);
  else
    run_part<TS, int8_t, TO, true>(pt, a, first);
}

template <typename TS>
__device__ __forceinline__ void run_out(const GluePart& pt, const GlueArgs& a, long long first) {
  if (a.out16)
    run_base<TS, int16_t>(pt, a, first);
  else
    run_base<TS, int8_t>(pt, a, first);
}

__global__ void __launch_bounds__(kGlueThreads)
    requant_combine_kernel(const __grid_constant__ GlueArgs a) {
  const long long b = blockIdx.x;
  int i = 0;
  while (i + 1 < a.n_parts && b >= a.part[i + 1].first_block) ++i;
  const GluePart& pt = a.part[i];
  const long long first = (b - pt.first_block) * (kGlueThreads * kGlueUnroll) + threadIdx.x;
  if (pt.src16)
    run_out<int16_t>(pt, a, first);
  else
    run_out<int8_t>(pt, a, first);
}

__host__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace ayq

// ptrs: (src, base or null, out) per part; rows: per part; meta: per part
// (cols, out_stride, src16, base16, req, r, s). The output is int16 if out16
// else int8; clip bounds the sum of an add to +-bound.
extern "C" int ayq_requant_combine(int n_parts, void* const* ptrs, const long long* rows,
                                   const int* meta, int out16, int qmax, int clip, int bound,
                                   void* stream) {
  using namespace ayq;
  if (n_parts < 1 || n_parts > kGlueParts) return static_cast<int>(cudaErrorInvalidValue);
  GlueArgs a = {};
  a.n_parts = n_parts;
  a.out16 = out16;
  a.qmax = qmax;
  a.clip = clip;
  a.bound = bound;
  long long blocks = 0;
  for (int i = 0; i < n_parts; ++i) {
    GluePart& pt = a.part[i];
    const int* m = meta + kGlueMeta * i;
    pt.src = ptrs[3 * i];
    pt.base = ptrs[3 * i + 1];
    pt.out = ptrs[3 * i + 2];
    pt.rows = rows[i];
    pt.cols = m[0];
    pt.out_stride = m[1];
    pt.src16 = m[2];
    pt.base16 = m[3];
    pt.req = m[4];
    pt.r = m[5];
    pt.s = m[6];
    if (pt.rows < 0 || pt.cols < 1 || pt.out_stride < pt.cols)
      return static_cast<int>(cudaErrorInvalidValue);
    pt.vec = pt.cols % kGlueVec == 0 && pt.out_stride % kGlueVec == 0 && aligned16(pt.src) &&
             aligned16(pt.out) && (pt.base == nullptr || aligned16(pt.base));
    const long long units = pt.rows * (pt.vec ? pt.cols / kGlueVec : pt.cols);
    pt.first_block = blocks;
    blocks += (units + kGlueThreads * kGlueUnroll - 1) / (kGlueThreads * kGlueUnroll);
  }
  if (blocks == 0) return 0;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  requant_combine_kernel<<<static_cast<unsigned>(blocks), kGlueThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
