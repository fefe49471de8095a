// What the gradient-codec kernels share: the launch shape, the wire
// formats and the lattice snap.  Included by quantize.cu (nearest
// rounding) and stochastic.cu (stochastic rounding); each .cu is its own
// translation unit, so everything here has internal linkage.
//
// Bit-identity with the plain codec (ops/quantize.py, and the XLA codec of
// the JAX package): x / s is IEEE division (never build with
// --use_fast_math), then * levels, then the rounding, then the clip to
// +-levels written with compares so that a NaN stays NaN (fminf/fmaxf
// would turn it into a level and hide a diverged gradient), then
// __float2half_rn, exact for integers <= 2048.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;

int64_t grid_for(int64_t work_items) {
  int64_t blocks = (work_items + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return blocks < kMaxBlocks ? blocks : kMaxBlocks;
}

__device__ __forceinline__ float clip_levels(float v, float levels) {
  v = v > levels ? levels : v;
  v = v < -levels ? -levels : v;
  return v;
}

// Nearest: rintf rounds half to even, as jnp.round and torch.round.
__device__ __forceinline__ float snap(float x, float s, float levels) {
  return clip_levels(rintf((x / s) * levels), levels);
}

// Stochastic: floor(x / s * levels + u), u in [0, 1).  Each operation is
// rounded on its own (the _rn intrinsics are never contracted into an
// FMA), as the plain version's separate tensor operations are.
__device__ __forceinline__ float snap_sr(float x, float s, float levels, float u) {
  return clip_levels(floorf(__fadd_rn(__fmul_rn(__fdiv_rn(x, s), levels), u)), levels);
}

// Wire formats: the storage type and the two exact conversions.  The fp16
// wire is stored as its raw 16 bits so that every type here is trivial.
struct WireI8 {
  using T = int8_t;
  __device__ static T from_float(float v) { return static_cast<T>(static_cast<int>(v)); }
  __device__ static float to_float(T q) { return static_cast<float>(q); }
};

struct WireI16 {
  using T = int16_t;
  __device__ static T from_float(float v) { return static_cast<T>(static_cast<int>(v)); }
  __device__ static float to_float(T q) { return static_cast<float>(q); }
};

struct WireF16 {
  using T = unsigned short;
  __device__ static T from_float(float v) { return __half_as_ushort(__float2half_rn(v)); }
  __device__ static float to_float(T q) { return __half2float(__ushort_as_half(q)); }
};

// Elements per 16-byte wire vector.
template <typename W>
__host__ __device__ constexpr int vec_elems() { return 16 / static_cast<int>(sizeof(typename W::T)); }

// Fake-quantize's dequantize: round through the fp16 wire as
// decode(encode(x)) does (the identity for integers <= 2048), then one
// multiply by step = scale / levels, computed once in fp32.
__device__ __forceinline__ float dequant(float v, float step, bool half_wire) {
  if (half_wire) v = __half2float(__float2half_rn(v));
  return v * step;
}

// Fake-quantize's two scalars, from the raw max-abs s that ddlpc_absmax
// wrote, by the plain codec's own IEEE operations: the zero-guarded
// divisor (safe_divisor: s > 0 ? s : 1, so a zero or NaN max divides by 1)
// and step = s * rn(1 / levels) (times_reciprocal: XLA compiles the JAX
// codec's division by the constant levels into that multiply).  Every
// thread derives them itself, so nothing is enqueued between the max-abs
// pass and the kernel.
struct FqScalars {
  float safe, step;
};

__device__ __forceinline__ FqScalars fq_scalars(const float* amax, float levels) {
  const float s = *amax;
  return {s > 0.0f ? s : 1.0f, __fmul_rn(s, __frcp_rn(levels))};
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// A per-device value looked up on the first launch on that device and
// kept, so a launch costs one cudaGetDevice and no other runtime query.
// 0 means not looked up yet (static storage starts zeroed).
constexpr int kMaxDevices = 64;
struct PerDevice {
  std::atomic<int> value[kMaxDevices];

  template <typename Lookup>
  int get(Lookup lookup) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return lookup(dev);
    int v = value[dev].load(std::memory_order_relaxed);
    if (v == 0) {
      v = lookup(dev);
      value[dev].store(v, std::memory_order_relaxed);
    }
    return v;
  }
};

int sm_count() {
  static PerDevice cache;
  return cache.get([](int dev) {
    int count = 0;
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  });
}

// A grid of kThreads-thread blocks for work_items threads' work, cut to
// as many blocks of `kernel` as the card holds at once; the blocks then
// stride over the buffer.  `cache` is the caller's, one for each kernel.
template <typename Kernel>
unsigned resident_grid(PerDevice& cache, Kernel kernel, int64_t work_items) {
  const int64_t resident = cache.get([kernel](int) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    return sm_count() * (per_sm > 0 ? per_sm : 1);
  });
  const int64_t blocks = (work_items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks < resident ? blocks : resident);
}

}  // namespace
