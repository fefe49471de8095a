// The codec's max-abs pass for Hopper (sm_90a), written by hand.
//
// ddlpc_absmax writes max |x| over a flat fp32 buffer into a 1-element
// fp32 device tensor.  In the JAX package this is XLA's global_absmax
// (ddlpc_tpu/ops/quantize.py:119), an XLA reduction outside the Pallas
// calls; here it is the first of the fake-quantize wrapper's two launches
// (the fake-quantize kernels read its result by pointer and derive the
// zero-guarded scale and the step themselves) and the encode's shared
// scale in parallel/grad_sync.py.  It replaces x.abs().amax(), which wrote
// a full-size temporary and read it back.
//
// What bounds it on an H100: bytes.  It reads 4n bytes once and does one
// AND and one integer max an element: at the flagship's 8,372,422
// elements 33.5 MB, 10 us at 3.35 TB/s.  Design for that bound: a
// persistent grid of kBlocksPerSm blocks on each SM, each thread keeping
// four independent 16-byte float4 loads in flight per iteration; a scalar
// head up to the first 16-byte boundary (a slice such as x[1:] is only
// 4-byte aligned) and a scalar tail; no temporary in device memory, no
// host sync.
//
// Exactness.  The max is taken over the uint32 bits of |x| (the sign bit
// cleared), not with fmaxf: for non-negative floats integer order is float
// order, subnormals included; -0.0 becomes +0; every NaN sorts above +inf,
// so a NaN anywhere gives a NaN result as torch.amax does (fmaxf would
// drop it and hide a diverged step).  So the result equals x.abs().amax()
// bit for bit except in a NaN's payload.  n = 0 gives +0.
//
// Across blocks: per-block partials and the last block finishes them.
// Each block's thread 0 stores its partial, __threadfence()s, and takes a
// ticket from a counter with atomicAdd; the block that draws the last
// ticket reduces the partials, writes the result and resets the counter to
// 0 for the next launch, so no memset is ever needed.  The partials and
// the counter live in a scratch buffer the caller keeps (zeroed once, then
// left at zero by every launch).  One scratch buffer must serve one
// stream only: two launches in flight at once would share its counter.
// The Python wrapper keys its scratch by device and stream.
//
// The entry point returns cudaGetLastError().

#include "codec.cuh"

namespace {

constexpr int kBlocksPerSm = 4;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned max4(unsigned m, float4 f) {
  m = max(m, abs_bits(f.x));
  m = max(m, abs_bits(f.y));
  m = max(m, abs_bits(f.z));
  return max(m, abs_bits(f.w));
}

// Max over the block; the result is valid in every thread of warp 0.
__device__ __forceinline__ unsigned block_max(unsigned m, unsigned* warp_max) {
  m = __reduce_max_sync(0xffffffffu, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  m = 0;
  if (warp == 0) {
    if (lane < kWarps) m = warp_max[lane];
    m = __reduce_max_sync(0xffffffffu, m);
  }
  return m;
}

// x[0:head] is scalar (head < 4 brings x + head to a 16-byte boundary),
// x[head:head + 4 * n_vec] moves as float4s, and the rest is scalar.
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ x, int64_t n, int64_t head,
              float* __restrict__ out, unsigned* partials, unsigned* counter) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  unsigned m = 0;
  if (tid < head) m = abs_bits(x[tid]);
  const float4* body = reinterpret_cast<const float4*>(x + head);
  const int64_t n_vec = (n - head) / 4;
  int64_t v = tid;
  for (; v + 3 * stride < n_vec; v += 4 * stride) {
    const float4 a = body[v], b = body[v + stride];
    const float4 c = body[v + 2 * stride], d = body[v + 3 * stride];
    m = max4(max4(m, a), b);
    m = max4(max4(m, c), d);
  }
  for (; v < n_vec; v += stride) m = max4(m, body[v]);
  for (int64_t e = head + 4 * n_vec + tid; e < n; e += stride) m = max(m, abs_bits(x[e]));

  __shared__ unsigned warp_max[kWarps];
  __shared__ bool last;
  m = block_max(m, warp_max);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = m;
    __threadfence();  // the partial is visible before the ticket is taken
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  m = 0;
  const volatile unsigned* done = partials;  // past L1: other blocks wrote them
  for (unsigned i = threadIdx.x; i < gridDim.x; i += blockDim.x) m = max(m, done[i]);
  __syncthreads();  // warp_max is reused
  m = block_max(m, warp_max);
  if (threadIdx.x == 0) {
    *out = __uint_as_float(m);
    *counter = 0;
  }
}

}  // namespace

extern "C" {

// scratch: scratch_words uint32 words, zero before the first launch; the
// grid is cut to scratch_words - 1 blocks (the last word is the counter).
int ddlpc_absmax(const void* x, int64_t n, void* out, void* scratch,
                 int64_t scratch_words, void* stream) {
  if (scratch_words < 2) return static_cast<int>(cudaErrorInvalidValue);
  // x points to floats, so it is 4-byte aligned: 0 to 3 floats reach 16.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  int64_t head = static_cast<int64_t>(((16 - (addr & 15)) & 15) / 4);
  if (head > n) head = n;
  int64_t blocks = ((n - head) / 4 + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks > scratch_words - 1) blocks = scratch_words - 1;
  if (blocks < 1) blocks = 1;
  unsigned* words = static_cast<unsigned*>(scratch);
  absmax_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), n, head, static_cast<float*>(out), words,
      words + (scratch_words - 1));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
