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
// 50 MB (decode: 2n bytes of fp16 or int16 in, 4n of fp32 out; 5n bytes,
// 41.9 MB, from the int8 wire) and 67 MB (fake-quantize: fp32 in and out):
// roughly 15, 15 (12.5 from int8) and 20 microseconds at 3.35 TB/s.
//
// Design for that bound.  The TPU kernels run one pallas_call per gradient
// leaf over a [rows, 1024] VMEM tiling; here each kernel is ONE grid-stride
// pass over the whole gradient tree as a single flat contiguous buffer, so
// a sync launches each kernel once.  Encode and fake-quantize move 16 bytes
// a thread per load and per store (float4 in; 8 halfs, 8 int16s or 16 int8s
// out), the ragged tail is handled by a masked scalar loop, and the scalars
// (scale, inv, and fake-quantize's raw max-abs from ddlpc_absmax,
// absmax.cu) are read through pointers to 1-element device tensors, so the
// host never waits on the device.  Fake-quantize is two launches, the
// max-abs pass and this kernel, with nothing enqueued between them
// (fq_scalars, codec.cuh).
//
// Decode writes 4 bytes for every 1 or 2 it reads, so its stores carry the
// traffic.  A lane that loads 16 wire bytes and stores their 4 or 2
// float4s itself spreads one warp store instruction over 2 KB (int8) or
// 1 KB, 64 B or 32 B apart, so each instruction touches four or two times
// the sectors it fills; that layout ran the int8 wire at 36 % of its bound,
// below the fp16 wire.  Here each warp keeps the 16-byte loads (one 512 B
// load instruction a tile), passes its tiles through a shared-memory stage,
// and lane t stores float4 t of each 512 B span of the output, so every
// store instruction writes one contiguous 512 B span.  Each warp takes
// decode_tiles<W>() tiles a pass (2 of int8, 4 of int16 or fp16: 4 KB of
// output either way, the fastest of 1, 2, 4 and 8 on an H100, PERF.md),
// all loads issued before the first store, and a resident grid strides
// over the buffer, so the card keeps enough loads in flight.  (A lane that
// loads one 4-element word, 4 or 8 bytes, also stores contiguously and
// needs no stage; it was 2-6 % slower on an H100, PERF.md.)  The stores
// are plain write-back stores, never evict-first or streaming: in the sync
// the decoded mean is read again at once, by ddlpc_absmax and then by the in-place
// fake-quantize (parallel/grad_sync.py), and its 33.5 MB fit in the 50 MB
// L2, so a hint that kept it out of L2 would slow the step while the
// kernel alone looked faster.  A q or out that is not 16-byte aligned (a
// slice such as q[1:]) takes the scalar template.
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

// Decode moves four wire elements as one word: 4 bytes of int8, 8 of int16
// or fp16.
template <int Bytes> struct GroupWord;
template <> struct GroupWord<4> { using type = uint32_t; };
template <> struct GroupWord<8> { using type = uint2; };
template <typename W>
using Group = typename GroupWord<4 * sizeof(typename W::T)>::type;

template <typename W>
__device__ __forceinline__ float4 decode4(Group<W> g, float inv) {
  union {
    Group<W> raw;
    typename W::T w[4];
  } in;
  in.raw = g;
  return make_float4(W::to_float(in.w[0]) * inv, W::to_float(in.w[1]) * inv,
                     W::to_float(in.w[2]) * inv, W::to_float(in.w[3]) * inv);
}

// Wire tiles a warp decodes per pass, every load issued before the first
// store: a pass writes 4 KB of output on every wire.
template <typename W>
__host__ __device__ constexpr int decode_tiles() { return vec_elems<W>() == 16 ? 2 : 4; }

// kVec: q and out are 16-byte aligned.  A warp's tile is 512 B of wire,
// one 16-byte load a lane, so one load instruction reads it whole.  The
// warp loads kTiles tiles, writes them to its shared-memory stage,
// and then lane t reads 4-element group k * 32 + t of a tile, so each
// float4 store instruction writes one contiguous 512 B span.  Each warp
// strides over the buffer by the whole grid's tiles; the elements past the
// last whole tile are scalar.  Otherwise (a slice such as q[1:] or out[1:])
// every element is scalar.
template <typename W, bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const typename W::T* __restrict__ q, float* __restrict__ out,
              int64_t n, const float* __restrict__ inv_ptr) {
  constexpr int V = vec_elems<W>();  // wire elements a lane loads
  constexpr int64_t kTile = 32 * V;  // wire elements in a warp's tile
  constexpr int kTiles = decode_tiles<W>();
  __shared__ uint4 stage[kThreads / 32][kTiles][32];
  const float inv = *inv_ptr;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n_tiles = kVec ? n / kTile : 0;
  if (kVec) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const uint4* src = reinterpret_cast<const uint4*>(q);
    for (int64_t tile = (tid >> 5) * kTiles; tile < n_tiles;
         tile += (stride >> 5) * kTiles) {
      uint4 v[kTiles] = {};
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        if (tile + t < n_tiles) v[t] = src[(tile + t) * 32 + lane];
      }
#pragma unroll
      for (int t = 0; t < kTiles; ++t) stage[warp][t][lane] = v[t];
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        if (tile + t >= n_tiles) break;
        const Group<W>* g = reinterpret_cast<const Group<W>*>(stage[warp][t]);
        float4* dst = reinterpret_cast<float4*>(out + (tile + t) * kTile);
#pragma unroll
        for (int k = 0; k < V / 4; ++k) dst[k * 32 + lane] = decode4<W>(g[k * 32 + lane], inv);
      }
      __syncwarp();  // the stage is written again on the next pass
    }
  }
  for (int64_t e = n_tiles * kTile + tid; e < n; e += stride) {
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
  auto st = static_cast<cudaStream_t>(stream);
  auto qw = static_cast<const typename W::T*>(q);
  auto of = static_cast<float*>(out);
  auto in = static_cast<const float*>(inv);
  static PerDevice vec_grid, scalar_grid;
  if (aligned16(q) && aligned16(out)) {
    const unsigned blocks = resident_grid(vec_grid, decode_kernel<W, true>,
                                          n / vec_elems<W>() / decode_tiles<W>());
    decode_kernel<W, true><<<blocks, kThreads, 0, st>>>(qw, of, n, in);
  } else {
    const unsigned blocks = resident_grid(scalar_grid, decode_kernel<W, false>, n);
    decode_kernel<W, false><<<blocks, kThreads, 0, st>>>(qw, of, n, in);
  }
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
