// Gradient-codec kernels for Hopper (sm_90a), written by hand.
//
// They replace the three nearest-rounding Pallas TPU kernels of
// ddlpc_tpu/ops/pallas_quantize.py:
//   ddlpc_encode_{i8,i16,f16}  <- _encode_kernel  (pallas_call in _encode_leaf)
//   ddlpc_decode_{i8,i16,f16}  <- _decode_kernel  (pallas_call in decode_from_wire_pallas)
//   ddlpc_fake_quantize        <- _fq_kernel      (pallas_call in _fq_leaf)
//
// What bounds them on an H100 (3.35 TB/s HBM): bytes.  Each element costs
// one IEEE divide, one multiply, a rint and two compares, far below the
// card's ~295 operations per byte.  At the flagship U-Net's 8,372,422
// gradient elements a step moves about 50 MB (encode: fp32 in, fp16 out),
// 50 MB (decode: fp16 in, fp32 out) and 67 MB (fake-quantize: fp32 in and
// out): roughly 15, 15 and 20 microseconds at 3.35 TB/s.
//
// Design for that bound.  The TPU kernels run one pallas_call per gradient
// leaf over a [rows, 1024] VMEM tiling; here each kernel is ONE grid-stride
// pass over the whole gradient tree as a single flat contiguous buffer, so
// a sync launches each kernel once.  Every thread moves 16 bytes per load
// and per store (float4 in; 8 halfs, 8 int16s or 16 int8s out), the ragged
// tail is handled by a masked scalar loop, and the scalars (scale, inv,
// and fake-quantize's raw max-abs from ddlpc_absmax, absmax.cu) are read
// through pointers to 1-element device tensors, so the host never waits on
// the device.  Fake-quantize is two launches, the max-abs pass and this
// kernel, with nothing enqueued between them (fq_scalars, codec.cuh).
//
// Bit-identity with the plain codec: see codec.cuh.  Fake-quantize
// dequantizes as lattice * step with step = scale / levels in fp32, which
// is decode(encode(x)) exactly; the Pallas kernel's lattice / levels *
// scale agrees with that only to 1 ulp.
//
// Each entry point returns cudaGetLastError() so the Python wrapper can
// raise on a launch that was refused.

#include "codec.cuh"

namespace {

template <typename W>
__global__ void encode_kernel(const float* __restrict__ x,
                              typename W::T* __restrict__ q,
                              int64_t n, const float* __restrict__ scale,
                              float levels) {
  constexpr int V = vec_elems<W>();
  const float s = *scale;
  const int64_t n_vec = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t v = i; v < n_vec; v += stride) {
    const float4* src = reinterpret_cast<const float4*>(x + v * V);
    union {
      uint4 raw;
      typename W::T w[V];
    } out;
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      float4 f = src[k];
      out.w[4 * k + 0] = W::from_float(snap(f.x, s, levels));
      out.w[4 * k + 1] = W::from_float(snap(f.y, s, levels));
      out.w[4 * k + 2] = W::from_float(snap(f.z, s, levels));
      out.w[4 * k + 3] = W::from_float(snap(f.w, s, levels));
    }
    reinterpret_cast<uint4*>(q)[v] = out.raw;
  }
  for (int64_t e = n_vec * V + i; e < n; e += stride) {
    q[e] = W::from_float(snap(x[e], s, levels));
  }
}

template <typename W>
__global__ void decode_kernel(const typename W::T* __restrict__ q,
                              float* __restrict__ out,
                              int64_t n, const float* __restrict__ inv_ptr) {
  constexpr int V = vec_elems<W>();
  const float inv = *inv_ptr;
  const int64_t n_vec = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t v = i; v < n_vec; v += stride) {
    union {
      uint4 raw;
      typename W::T w[V];
    } in;
    in.raw = reinterpret_cast<const uint4*>(q)[v];
    float4* dst = reinterpret_cast<float4*>(out + v * V);
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      float4 f;
      f.x = W::to_float(in.w[4 * k + 0]) * inv;
      f.y = W::to_float(in.w[4 * k + 1]) * inv;
      f.z = W::to_float(in.w[4 * k + 2]) * inv;
      f.w = W::to_float(in.w[4 * k + 3]) * inv;
      dst[k] = f;
    }
  }
  for (int64_t e = n_vec * V + i; e < n; e += stride) {
    out[e] = W::to_float(q[e]) * inv;
  }
}

// x and out may alias (in-place): each thread reads its elements before it
// writes them, and no two threads touch the same element.
__device__ __forceinline__ float fq_one(float x, float s, float step,
                                        float levels, bool half_wire) {
  return dequant(snap(x, s, levels), step, half_wire);
}

// kVec: x and out are 16-byte aligned and move as float4s; otherwise (a
// slice such as x[1:]) every element takes the scalar loop.
template <bool kVec>
__global__ void fake_quantize_kernel(const float* x, float* out, int64_t n,
                                     const float* __restrict__ amax,
                                     float levels, int half_wire) {
  const FqScalars c = fq_scalars(amax, levels);
  const float s = c.safe, step = c.step;
  const bool hw = half_wire != 0;
  const int64_t n_vec = kVec ? n / 4 : 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t v = i; v < n_vec; v += stride) {
    float4 f = reinterpret_cast<const float4*>(x)[v];
    f.x = fq_one(f.x, s, step, levels, hw);
    f.y = fq_one(f.y, s, step, levels, hw);
    f.z = fq_one(f.z, s, step, levels, hw);
    f.w = fq_one(f.w, s, step, levels, hw);
    reinterpret_cast<float4*>(out)[v] = f;
  }
  for (int64_t e = n_vec * 4 + i; e < n; e += stride) {
    out[e] = fq_one(x[e], s, step, levels, hw);
  }
}

template <typename W>
int launch_encode(const void* x, void* q, int64_t n, const void* scale,
                  float levels, void* stream) {
  const int64_t blocks = grid_for(n / vec_elems<W>() + 1);
  encode_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<typename W::T*>(q), n,
      static_cast<const float*>(scale), levels);
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_decode(const void* q, void* out, int64_t n, const void* inv,
                  void* stream) {
  const int64_t blocks = grid_for(n / vec_elems<W>() + 1);
  decode_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const typename W::T*>(q), static_cast<float*>(out), n,
      static_cast<const float*>(inv));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ddlpc_encode_i8(const void* x, void* q, int64_t n, const void* scale,
                    float levels, void* stream) {
  return launch_encode<WireI8>(x, q, n, scale, levels, stream);
}

int ddlpc_encode_i16(const void* x, void* q, int64_t n, const void* scale,
                     float levels, void* stream) {
  return launch_encode<WireI16>(x, q, n, scale, levels, stream);
}

int ddlpc_encode_f16(const void* x, void* q, int64_t n, const void* scale,
                     float levels, void* stream) {
  return launch_encode<WireF16>(x, q, n, scale, levels, stream);
}

int ddlpc_decode_i8(const void* q, void* out, int64_t n, const void* inv,
                    void* stream) {
  return launch_decode<WireI8>(q, out, n, inv, stream);
}

int ddlpc_decode_i16(const void* q, void* out, int64_t n, const void* inv,
                     void* stream) {
  return launch_decode<WireI16>(q, out, n, inv, stream);
}

int ddlpc_decode_f16(const void* q, void* out, int64_t n, const void* inv,
                     void* stream) {
  return launch_decode<WireF16>(q, out, n, inv, stream);
}

int ddlpc_fake_quantize(const void* x, void* out, int64_t n, const void* amax,
                        float levels, int half_wire, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto of = static_cast<float*>(out);
  auto af = static_cast<const float*>(amax);
  if (aligned16(x) && aligned16(out)) {
    const unsigned blocks = static_cast<unsigned>(grid_for(n / 4 + 1));
    fake_quantize_kernel<true><<<blocks, kThreads, 0, st>>>(xf, of, n, af, levels, half_wire);
  } else {
    const unsigned blocks = static_cast<unsigned>(grid_for(n));
    fake_quantize_kernel<false><<<blocks, kThreads, 0, st>>>(xf, of, n, af, levels, half_wire);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
