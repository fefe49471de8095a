// Block-parallel deflate with the DWZ1 frame layout — the port's copy of
// csrc/wire.cc.
//
// The payload is split into fixed blocks, each a zlib-wrapped deflate
// stream (compress2, as Python's zlib.compress writes it), compressed and
// inflated across a thread pool.  Frame layout (little-endian), the same
// as the Python path of ddlpc_tpu_torch/utils/wire.py:
//   magic   4B   "DWZ1"
//   nblk    u32  number of blocks
//   per block: raw_len u32, comp_len u32, comp bytes
//
// Build: g++ -O3 -std=c++17 -fPIC -shared wire.cc -o libdwz.so -lz -lpthread

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[4] = {'D', 'W', 'Z', '1'};

inline void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = (v >> 24) & 0xff;
}

inline uint32_t get_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

// zlib wrapper producing a zlib-wrapped deflate stream, matching Python's
// zlib.compress output so the two implementations interoperate.
bool deflate_block(const uint8_t* in, size_t n, int level,
                   std::vector<uint8_t>* out) {
  uLongf bound = compressBound(static_cast<uLong>(n));
  out->resize(bound);
  int rc = compress2(out->data(), &bound, in, static_cast<uLong>(n), level);
  if (rc != Z_OK) return false;
  out->resize(bound);
  return true;
}

bool inflate_block(const uint8_t* in, size_t n, size_t raw_len,
                   uint8_t* out) {
  uLongf dest_len = static_cast<uLongf>(raw_len);
  int rc = uncompress(out, &dest_len, in, static_cast<uLong>(n));
  return rc == Z_OK && dest_len == raw_len;
}

// Run fn(i) for i in [0, count) over up to max_threads workers.
template <typename Fn>
void parallel_for(size_t count, unsigned max_threads, Fn fn) {
  unsigned hw = std::thread::hardware_concurrency();
  unsigned workers =
      std::min<size_t>(count, std::min<unsigned>(max_threads, hw ? hw : 1));
  if (workers <= 1) {
    for (size_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<size_t> next{0};
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (unsigned w = 0; w < workers; ++w) {
    pool.emplace_back([&] {
      for (size_t i = next.fetch_add(1); i < count; i = next.fetch_add(1)) {
        fn(i);
      }
    });
  }
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Returns a malloc'd frame in *out (caller frees with dwz_free) and its
// length in *out_len.  Returns 0 on success, negative on error.
int dwz_compress(const uint8_t* data, size_t len, int level,
                 size_t block_size, int max_threads, uint8_t** out,
                 size_t* out_len) {
  if (!data && len) return -1;
  if (block_size == 0) block_size = 1 << 20;
  // Frame fields are u32: refuse inputs that would truncate silently.
  if (block_size > UINT32_MAX) return -2;
  size_t nblk = len ? (len + block_size - 1) / block_size : 0;
  if (nblk > UINT32_MAX) return -2;
  if (compressBound(static_cast<uLong>(block_size)) > UINT32_MAX) return -2;
  std::vector<std::vector<uint8_t>> comp(nblk);
  std::atomic<bool> ok{true};
  parallel_for(nblk, max_threads > 0 ? max_threads : 1, [&](size_t i) {
    size_t off = i * block_size;
    size_t n = std::min(block_size, len - off);
    if (!deflate_block(data + off, n, level, &comp[i])) ok = false;
  });
  if (!ok) return -3;
  size_t total = 8;
  for (auto& c : comp) total += 8 + c.size();
  uint8_t* buf = static_cast<uint8_t*>(malloc(total));
  if (!buf) return -4;
  std::memcpy(buf, kMagic, 4);
  put_u32(buf + 4, static_cast<uint32_t>(nblk));
  size_t off = 8;
  for (size_t i = 0; i < nblk; ++i) {
    size_t raw = std::min(block_size, len - i * block_size);
    put_u32(buf + off, static_cast<uint32_t>(raw));
    put_u32(buf + off + 4, static_cast<uint32_t>(comp[i].size()));
    off += 8;
    std::memcpy(buf + off, comp[i].data(), comp[i].size());
    off += comp[i].size();
  }
  *out = buf;
  *out_len = total;
  return 0;
}

// Inverse of dwz_compress.  Error codes: -1 bad args, -5 bad magic,
// -6 truncated frame, -7 trailing garbage, -3 block inflate failure.
int dwz_decompress(const uint8_t* data, size_t len, int max_threads,
                   uint8_t** out, size_t* out_len) {
  // Error ordering matches the Python fallback: too short for the magic is
  // truncation, wrong magic beats a short header, then truncation checks.
  if (!data) return -1;
  if (len < 4) return -6;
  if (std::memcmp(data, kMagic, 4) != 0) return -5;
  if (len < 8) return -6;
  uint32_t nblk = get_u32(data + 4);
  // Bound nblk by what the frame could possibly hold (8 header bytes per
  // block) BEFORE sizing anything from it: an 8-byte corrupt frame must
  // not drive a multi-GB allocation.
  if (static_cast<size_t>(nblk) > (len - 8) / 8) return -6;
  std::vector<size_t> comp_off(nblk), comp_len(nblk), raw_off(nblk),
      raw_len(nblk);
  size_t off = 8, total_raw = 0;
  // Deflate cannot expand beyond ~1032:1; headers claiming more are forged.
  // Checked per block BEFORE sizing the output, so a ~1 KB corrupt frame
  // cannot drive a multi-GB allocation.
  constexpr size_t kMaxInflateRatio = 1040;
  for (uint32_t i = 0; i < nblk; ++i) {
    if (off + 8 > len) return -6;
    raw_len[i] = get_u32(data + off);
    comp_len[i] = get_u32(data + off + 4);
    off += 8;
    if (off + comp_len[i] > len) return -6;
    if (raw_len[i] > comp_len[i] * kMaxInflateRatio + 1024) return -3;
    comp_off[i] = off;
    off += comp_len[i];
    raw_off[i] = total_raw;
    total_raw += raw_len[i];
  }
  if (off != len) return -7;
  uint8_t* buf = static_cast<uint8_t*>(malloc(total_raw ? total_raw : 1));
  if (!buf) return -4;
  std::atomic<bool> ok{true};
  parallel_for(nblk, max_threads > 0 ? max_threads : 1, [&](size_t i) {
    if (!inflate_block(data + comp_off[i], comp_len[i], raw_len[i],
                       buf + raw_off[i])) {
      ok = false;
    }
  });
  if (!ok) {
    free(buf);
    return -3;
  }
  *out = buf;
  *out_len = total_raw;
  return 0;
}

void dwz_free(uint8_t* p) { free(p); }

}  // extern "C"
