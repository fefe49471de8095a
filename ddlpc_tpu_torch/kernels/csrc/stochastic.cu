// Stochastic-rounding gradient-codec kernels for Hopper (sm_90a), written
// by hand.
//
// They replace the stochastic Pallas TPU kernels of
// ddlpc_tpu/ops/pallas_quantize.py:
//   ddlpc_encode_sr_{i8,i16,f16}     <- _encode_kernel, stochastic branch (:151-157)
//   ddlpc_fake_quantize_sr           <- _fq_kernel, stochastic branch (:53-64)
//   ddlpc_encode_noise_{i8,i16,f16}  <- _encode_kernel_hostnoise (:163)
//   ddlpc_fake_quantize_noise        <- _fq_kernel_hostnoise (:71)
// Each snaps floor(x / s * levels + u) with u in [0, 1), clipped to
// +-levels.  The _sr kernels draw u in registers; the _noise kernels read
// it from a buffer the caller hands in.
//
// The TPU kernels seed the core's hardware PRNG per grid block.  Hopper
// has no such generator, so the _sr kernels compute Philox4x32-10
// (Random123's constants; no curand) from a key and a counter: element e
// of the stream takes word e % 4 of philox(counter = e / 4, key), mapped
// to u = (bits >> 8) * 2^-24 as the TPU kernel maps its bits.  One thread
// computes one counter and snaps the four elements it covers, so a
// float4's four lanes cost exactly one Philox call.  The kernels take an
// element offset into the stream: x[o:] drawn at offset o equals the
// slice of x's own draw, so a later ZeRO shard can round its chunk exactly
// as the whole buffer would.  ops/philox.py is the plain version, bit for
// bit.
//
// What bounds them on an H100.  Bytes: encode_sr to the int8 wire moves 5
// bytes per element (41.9 MB at the flagship's 8,372,422 elements, 12.5 us
// at 3.35 TB/s); fake-quantize moves 8 (20 us); the _noise kernels read 4
// more per element for u.  Operations: a Philox call is 10 rounds of two
// 32-bit mul.hi, two mul.lo, four xors and two adds, about 25 integer
// operations per element, plus ~10 for the snap (IEEE divide, multiply,
// add, floor, two compares, conversions).  That is near the line where
// integer throughput, not memory, bounds the _sr kernels.  Design for it:
// one grid-stride pass over the flat buffer, 16-byte float4 loads of x
// (and of u), the generator in registers so the stream never touches
// memory, the scalars read through device pointers so the host never
// waits (the fake-quantize kernels read the raw max-abs that ddlpc_absmax
// wrote and derive the divisor and step themselves, codec.cuh).  When the
// offset is not a multiple of 4, or a pointer is not 16-byte aligned, the
// same kernel runs with scalar loads (kVec = false).
//
// encode_sr, on the int8 stochastic main path, is laid out for hiding the
// load latency behind the generator.  Its main loop issues 39
// instructions an element (312 for 8 elements in the SASS of the sm_90a
// build, 38 of them IMAD.HI or IMAD.WIDE; chip_smoke.py counts them
// with cuobjdump -sass): over 8,372,422 elements at 4 warp instructions a
// clock on 132 SMs at 1.98 GHz that is 9.8 us, below its 12.5 us of bytes,
// so bytes still bound it, but not by much.  One counter a thread (the
// earlier layout) left each thread a single 16-byte load whose latency the
// Philox rounds and four IEEE divides could not overlap, and made 2.09 M
// threads each pay the scale's load, the key set-up and an exit for four
// elements.  Now each lane takes kSrTiles counters a pass, 32 counters
// apart (so a warp load reads 512 contiguous bytes and a warp store on the
// int8 wire writes 128), issues all kSrTiles loads of x, computes the
// kSrTiles Philox blocks while they are in flight, then snaps and stores;
// a resident grid strides over the buffer.
//
// Bit-identity with the plain versions (ops/quantize.py): see codec.cuh;
// the add of u is __fadd_rn, never contracted into an FMA.  Each entry
// point returns cudaGetLastError().

#include "codec.cuh"

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint64_t counter, uint32_t k0, uint32_t k1) {
  uint32_t c0 = static_cast<uint32_t>(counter);
  uint32_t c1 = static_cast<uint32_t>(counter >> 32);
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

// The top 24 bits as a float in [0, 1): exact (a 24-bit integer times a
// power of two).
__device__ __forceinline__ float u24(uint32_t bits) {
  return __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;
}

template <int Bytes> struct RawBytes;
template <> struct RawBytes<4> { using type = uint32_t; };
template <> struct RawBytes<8> { using type = uint2; };

// Four lattice values stored to the wire as one 4- or 8-byte store.
template <typename W>
__device__ __forceinline__ void store4(typename W::T* q, float a, float b, float c, float d) {
  using Raw = typename RawBytes<4 * sizeof(typename W::T)>::type;
  union {
    Raw raw;
    typename W::T w[4];
  } out;
  out.w[0] = W::from_float(a);
  out.w[1] = W::from_float(b);
  out.w[2] = W::from_float(c);
  out.w[3] = W::from_float(d);
  *reinterpret_cast<Raw*>(q) = out.raw;
}

// Counters covering stream elements [offset, offset + n).
__host__ __device__ __forceinline__ int64_t first_counter(int64_t offset) { return offset / 4; }
__host__ __device__ __forceinline__ int64_t counter_count(int64_t n, int64_t offset) {
  return n > 0 ? (offset + n - 1) / 4 - offset / 4 + 1 : 0;
}

// Counters a lane takes per pass of encode_sr_kernel's main loop: 2 ran
// faster than 1, 4 or 8 on every wire on an H100 (PERF.md; 4 needs 64
// registers and 8 120, which cut the warps resident).
constexpr int kSrTiles = 2;

template <typename W>
__device__ __forceinline__ void encode_sr4(typename W::T* q, float4 f, uint4 r, float s,
                                           float levels) {
  store4<W>(q, snap_sr(f.x, s, levels, u24(r.x)), snap_sr(f.y, s, levels, u24(r.y)),
            snap_sr(f.z, s, levels, u24(r.z)), snap_sr(f.w, s, levels, u24(r.w)));
}

// Counter j of the launch is stream counter c0 + j.  A warp's tile is 32
// consecutive counters, one a lane; each warp takes kSrTiles consecutive
// tiles per pass and strides over the buffer by the whole grid's.
// kVec: offset % 4 == 0 and every pointer 16-byte aligned, so counter j
// covers x[4j .. 4j + 3] and loads as one float4: a warp load instruction
// reads one contiguous 512 B span, and a store one contiguous 128 B (int8)
// or 256 B span.  The main loop takes the passes whose counters are all
// whole: it issues its kSrTiles float4 loads, then computes the kSrTiles
// Philox blocks (which need no load) while they are in flight, then snaps
// and stores.  The rest (the ragged end, and every counter when !kVec, for
// a slice at any offset) takes the same layout one counter at a time.
template <typename W, bool kVec>
__global__ void __launch_bounds__(kThreads)
encode_sr_kernel(const float* __restrict__ x, typename W::T* __restrict__ q, int64_t n,
                 const float* __restrict__ scale, float levels, uint32_t k0, uint32_t k1,
                 int64_t offset) {
  const float s = *scale;
  const int64_t c0 = first_counter(offset);
  const int64_t n_ctr = counter_count(n, offset);
  const int64_t n_whole = kVec ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  constexpr int64_t kSpan = 32 * kSrTiles;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t step = (static_cast<int64_t>(gridDim.x) * blockDim.x >> 5) * kSpan;
  int64_t j = (tid >> 5) * kSpan + (threadIdx.x & 31);
  for (; j + 32 * (kSrTiles - 1) < n_whole; j += step) {
    float4 f[kSrTiles];
    uint4 r[kSrTiles];
#pragma unroll
    for (int t = 0; t < kSrTiles; ++t) f[t] = x4[j + 32 * t];
#pragma unroll
    for (int t = 0; t < kSrTiles; ++t) {
      r[t] = philox4x32_10(static_cast<uint64_t>(c0 + j + 32 * t), k0, k1);
    }
#pragma unroll
    for (int t = 0; t < kSrTiles; ++t) encode_sr4<W>(q + 4 * (j + 32 * t), f[t], r[t], s, levels);
  }
  for (; j < n_ctr; j += step) {
#pragma unroll
    for (int t = 0; t < kSrTiles; ++t) {
      const int64_t jt = j + 32 * t;
      if (jt >= n_ctr) break;
      const uint4 r = philox4x32_10(static_cast<uint64_t>(c0 + jt), k0, k1);
      if (jt < n_whole) {
        encode_sr4<W>(q + 4 * jt, x4[jt], r, s, levels);
        continue;
      }
      const float u[4] = {u24(r.x), u24(r.y), u24(r.z), u24(r.w)};
      const int64_t i0 = 4 * (c0 + jt) - offset;  // x index of the counter's word 0
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t e = i0 + k;
        if (e >= 0 && e < n) q[e] = W::from_float(snap_sr(x[e], s, levels, u[k]));
      }
    }
  }
}

// x and out may alias (in place): each thread reads its elements before it
// writes them, and no two threads touch the same element.
template <bool kVec>
__global__ void fake_quantize_sr_kernel(const float* x, float* out, int64_t n,
                                        const float* __restrict__ amax,
                                        float levels, int half_wire,
                                        uint32_t k0, uint32_t k1, int64_t offset) {
  const FqScalars c = fq_scalars(amax, levels);
  const float s = c.safe, step = c.step;
  const bool hw = half_wire != 0;
  const int64_t c0 = first_counter(offset);
  const int64_t n_ctr = counter_count(n, offset);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n_ctr; j += stride) {
    const uint4 r = philox4x32_10(static_cast<uint64_t>(c0 + j), k0, k1);
    const float u[4] = {u24(r.x), u24(r.y), u24(r.z), u24(r.w)};
    const int64_t i0 = 4 * (c0 + j) - offset;
    if (kVec && i0 + 4 <= n) {
      float4 f = reinterpret_cast<const float4*>(x)[j];
      f.x = dequant(snap_sr(f.x, s, levels, u[0]), step, hw);
      f.y = dequant(snap_sr(f.y, s, levels, u[1]), step, hw);
      f.z = dequant(snap_sr(f.z, s, levels, u[2]), step, hw);
      f.w = dequant(snap_sr(f.w, s, levels, u[3]), step, hw);
      reinterpret_cast<float4*>(out)[j] = f;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t e = i0 + k;
        if (e >= 0 && e < n) out[e] = dequant(snap_sr(x[e], s, levels, u[k]), step, hw);
      }
    }
  }
}

// The _noise kernels: slice 1's vector layout (V elements a thread, one
// 16-byte store), with u read beside x.
template <typename W>
__global__ void encode_noise_kernel(const float* __restrict__ x,
                                    const float* __restrict__ u,
                                    typename W::T* __restrict__ q, int64_t n,
                                    const float* __restrict__ scale, float levels) {
  constexpr int V = vec_elems<W>();
  const float s = *scale;
  const int64_t n_vec = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t v = i; v < n_vec; v += stride) {
    const float4* src = reinterpret_cast<const float4*>(x + v * V);
    const float4* noise = reinterpret_cast<const float4*>(u + v * V);
    union {
      uint4 raw;
      typename W::T w[V];
    } out;
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 f = src[k];
      const float4 g = noise[k];
      out.w[4 * k + 0] = W::from_float(snap_sr(f.x, s, levels, g.x));
      out.w[4 * k + 1] = W::from_float(snap_sr(f.y, s, levels, g.y));
      out.w[4 * k + 2] = W::from_float(snap_sr(f.z, s, levels, g.z));
      out.w[4 * k + 3] = W::from_float(snap_sr(f.w, s, levels, g.w));
    }
    reinterpret_cast<uint4*>(q)[v] = out.raw;
  }
  for (int64_t e = n_vec * V + i; e < n; e += stride) {
    q[e] = W::from_float(snap_sr(x[e], s, levels, u[e]));
  }
}

__global__ void fake_quantize_noise_kernel(const float* x, const float* __restrict__ u,
                                           float* out, int64_t n,
                                           const float* __restrict__ amax,
                                           float levels, int half_wire) {
  const FqScalars c = fq_scalars(amax, levels);
  const float s = c.safe, step = c.step;
  const bool hw = half_wire != 0;
  const int64_t n_vec = n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t v = i; v < n_vec; v += stride) {
    float4 f = reinterpret_cast<const float4*>(x)[v];
    const float4 g = reinterpret_cast<const float4*>(u)[v];
    f.x = dequant(snap_sr(f.x, s, levels, g.x), step, hw);
    f.y = dequant(snap_sr(f.y, s, levels, g.y), step, hw);
    f.z = dequant(snap_sr(f.z, s, levels, g.z), step, hw);
    f.w = dequant(snap_sr(f.w, s, levels, g.w), step, hw);
    reinterpret_cast<float4*>(out)[v] = f;
  }
  for (int64_t e = n_vec * 4 + i; e < n; e += stride) {
    out[e] = dequant(snap_sr(x[e], s, levels, u[e]), step, hw);
  }
}

template <typename W>
int launch_encode_sr(const void* x, void* q, int64_t n, const void* scale,
                     float levels, uint32_t k0, uint32_t k1, int64_t offset,
                     void* stream) {
  const int64_t work = counter_count(n, offset) / kSrTiles;
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto qw = static_cast<typename W::T*>(q);
  auto sf = static_cast<const float*>(scale);
  static PerDevice vec_grid, scalar_grid;
  if (offset % 4 == 0 && aligned16(x) && aligned16(q)) {
    const unsigned blocks = resident_grid(vec_grid, encode_sr_kernel<W, true>, work);
    encode_sr_kernel<W, true><<<blocks, kThreads, 0, st>>>(xf, qw, n, sf, levels, k0, k1, offset);
  } else {
    const unsigned blocks = resident_grid(scalar_grid, encode_sr_kernel<W, false>, work);
    encode_sr_kernel<W, false><<<blocks, kThreads, 0, st>>>(xf, qw, n, sf, levels, k0, k1, offset);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename W>
int launch_encode_noise(const void* x, const void* u, void* q, int64_t n,
                        const void* scale, float levels, void* stream) {
  const int64_t blocks = grid_for(n / vec_elems<W>() + 1);
  encode_noise_kernel<W><<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<typename W::T*>(q), n, static_cast<const float*>(scale), levels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ddlpc_encode_sr_i8(const void* x, void* q, int64_t n, const void* scale, float levels,
                       uint32_t k0, uint32_t k1, int64_t offset, void* stream) {
  return launch_encode_sr<WireI8>(x, q, n, scale, levels, k0, k1, offset, stream);
}

int ddlpc_encode_sr_i16(const void* x, void* q, int64_t n, const void* scale, float levels,
                        uint32_t k0, uint32_t k1, int64_t offset, void* stream) {
  return launch_encode_sr<WireI16>(x, q, n, scale, levels, k0, k1, offset, stream);
}

int ddlpc_encode_sr_f16(const void* x, void* q, int64_t n, const void* scale, float levels,
                        uint32_t k0, uint32_t k1, int64_t offset, void* stream) {
  return launch_encode_sr<WireF16>(x, q, n, scale, levels, k0, k1, offset, stream);
}

int ddlpc_fake_quantize_sr(const void* x, void* out, int64_t n, const void* amax,
                           float levels, int half_wire, uint32_t k0, uint32_t k1,
                           int64_t offset, void* stream) {
  const unsigned blocks = static_cast<unsigned>(grid_for(counter_count(n, offset)));
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto of = static_cast<float*>(out);
  auto af = static_cast<const float*>(amax);
  if (offset % 4 == 0 && aligned16(x) && aligned16(out)) {
    fake_quantize_sr_kernel<true><<<blocks, kThreads, 0, st>>>(
        xf, of, n, af, levels, half_wire, k0, k1, offset);
  } else {
    fake_quantize_sr_kernel<false><<<blocks, kThreads, 0, st>>>(
        xf, of, n, af, levels, half_wire, k0, k1, offset);
  }
  return static_cast<int>(cudaGetLastError());
}

int ddlpc_encode_noise_i8(const void* x, const void* u, void* q, int64_t n,
                          const void* scale, float levels, void* stream) {
  return launch_encode_noise<WireI8>(x, u, q, n, scale, levels, stream);
}

int ddlpc_encode_noise_i16(const void* x, const void* u, void* q, int64_t n,
                           const void* scale, float levels, void* stream) {
  return launch_encode_noise<WireI16>(x, u, q, n, scale, levels, stream);
}

int ddlpc_encode_noise_f16(const void* x, const void* u, void* q, int64_t n,
                           const void* scale, float levels, void* stream) {
  return launch_encode_noise<WireF16>(x, u, q, n, scale, levels, stream);
}

int ddlpc_fake_quantize_noise(const void* x, const void* u, void* out, int64_t n,
                              const void* amax, float levels, int half_wire,
                              void* stream) {
  const int64_t blocks = grid_for(n / 4 + 1);
  fake_quantize_noise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(u),
      static_cast<float*>(out), n, static_cast<const float*>(amax), levels, half_wire);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
