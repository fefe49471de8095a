// Fused gather(+cast)+pack of tile batches for the host input path — the
// port's copy of csrc/batch.cc.
//
// For each output tile it reads the source tile named by the index array
// and writes it, already cast when `compact` is set (fp32 -> bf16 round to
// nearest even, int32 -> int8 after the [-1, 127] range check), at its
// final offset in a caller-owned [A*B, H, W, C] destination: the loader's
// pinned ring slot (ddlpc_tpu_torch/data/loader.py).  Tiles fan out over a
// thread pool; ctypes releases the GIL around the call.  Plain C ABI,
// caller-owned memory, negative error codes (ddlpc_tpu_torch/utils/native.py
// translates them).
//
// Build: g++ -O3 -std=c++17 -fPIC -shared batch.cc -o libdwbatch.so -lpthread
// Self-test: g++ -DDWB_TEST_MAIN batch.cc -o batch_check -lpthread, run with
// --stress under the sanitizers (ddlpc_tpu_torch/analysis/check.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(i) for i in [0, count) over up to max_threads workers — the same
// atomic-counter pool as wire.cc (small index space, coarse work items).
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

// fp32 → bf16, round-to-nearest-even with quiet-NaN preservation (the
// semantics of a bfloat16 cast in numpy's ml_dtypes and in PyTorch).
// Branchless (select, not branch) so the per-pixel cast loop vectorizes:
// with the NaN test as a branch gcc keeps the loop scalar and the compact
// path runs compute-bound instead of bandwidth-bound.
inline uint16_t f32_to_bf16(uint32_t bits) {
  uint16_t rne =
      static_cast<uint16_t>((bits + 0x7fffu + ((bits >> 16) & 1u)) >> 16);
  uint16_t nan = static_cast<uint16_t>((bits >> 16) | 0x0040u);
  return (bits & 0x7fffffffu) > 0x7f800000u ? nan : rne;
}

inline void atomic_min_i32(std::atomic<int32_t>* a, int32_t v) {
  int32_t cur = a->load(std::memory_order_relaxed);
  while (v < cur &&
         !a->compare_exchange_weak(cur, v, std::memory_order_relaxed)) {
  }
}

inline void atomic_max_i32(std::atomic<int32_t>* a, int32_t v) {
  int32_t cur = a->load(std::memory_order_relaxed);
  while (v > cur &&
         !a->compare_exchange_weak(cur, v, std::memory_order_relaxed)) {
  }
}

}  // namespace

extern "C" {

// Fused gather(+cast)+pack of tile pairs into caller-owned buffers.
//
//   images    [n_src, img_elems]  float32, contiguous
//   labels    [n_src, lab_elems]  int32, contiguous
//   indices   [n_out]             int64 tile ids into the source arrays
//   img_out   [n_out, img_elems]  float32 (compact=0) or bfloat16 (compact=1)
//   lab_out   [n_out, lab_elems]  int32 (compact=0) or int8 (compact=1)
//   lab_range int32[2]            observed {min, max} over gathered labels
//                                 (compact=1 only; valid on 0 and -3)
//
// Returns 0 on success, -1 bad args, -2 index out of [0, n_src),
// -3 compact labels outside [-1, 127] (int8 with the -1 void sentinel).
int dwb_gather_pack(const float* images, const int32_t* labels,
                    const int64_t* indices, size_t n_out, size_t n_src,
                    size_t img_elems, size_t lab_elems, int compact,
                    void* img_out, void* lab_out, int32_t* lab_range,
                    int max_threads) {
  if (!images || !labels || !indices || !img_out || !lab_out) return -1;
  if (compact && !lab_range) return -1;
  for (size_t i = 0; i < n_out; ++i) {
    if (indices[i] < 0 || static_cast<size_t>(indices[i]) >= n_src) return -2;
  }
  std::atomic<int32_t> lab_min{INT32_MAX}, lab_max{INT32_MIN};
  parallel_for(n_out, max_threads > 0 ? max_threads : 1, [&](size_t i) {
    const size_t src = static_cast<size_t>(indices[i]);
    const float* img_src = images + src * img_elems;
    const int32_t* lab_src = labels + src * lab_elems;
    if (compact) {
      uint16_t* dst = static_cast<uint16_t*>(img_out) + i * img_elems;
      const uint32_t* bits = reinterpret_cast<const uint32_t*>(img_src);
      for (size_t k = 0; k < img_elems; ++k) dst[k] = f32_to_bf16(bits[k]);
      int8_t* ldst = static_cast<int8_t*>(lab_out) + i * lab_elems;
      int32_t lo = INT32_MAX, hi = INT32_MIN;
      for (size_t k = 0; k < lab_elems; ++k) {
        int32_t v = lab_src[k];
        lo = v < lo ? v : lo;
        hi = v > hi ? v : hi;
        ldst[k] = static_cast<int8_t>(v);
      }
      if (lab_elems) {
        atomic_min_i32(&lab_min, lo);
        atomic_max_i32(&lab_max, hi);
      }
    } else {
      std::memcpy(static_cast<float*>(img_out) + i * img_elems, img_src,
                  img_elems * sizeof(float));
      std::memcpy(static_cast<int32_t*>(lab_out) + i * lab_elems, lab_src,
                  lab_elems * sizeof(int32_t));
    }
  });
  if (compact) {
    lab_range[0] = lab_min.load();
    lab_range[1] = lab_max.load();
    if (n_out && lab_elems && (lab_range[0] < -1 || lab_range[1] > 127)) {
      return -3;
    }
  }
  return 0;
}

}  // extern "C"

#ifdef DWB_TEST_MAIN
// Self-test (the port's copy of csrc/batch.cc's): exercises both paths and
// the error codes without Python in the loop.  `--stress` adds a
// multithreaded gather/pack stress (big enough to fan out over the thread
// pool, checked element-wise) — the workload the sanitizer arms of
// `python -m ddlpc_tpu_torch.analysis.check --sanitize` run under ASan,
// UBSan and TSan to prove the pool, the atomic min/max reduction, and the
// branchless cast loop are data-race- and UB-free.
#include <cmath>
#include <cstdio>
#include <cstring>

static int fail(const char* what) {
  std::fprintf(stderr, "batch_check FAILED: %s\n", what);
  return 1;
}

static int stress() {
  // Many small tiles over many threads: maximize hand-off/interleaving
  // (the TSan-relevant shape) while still checking every output byte.
  const size_t n_src = 257, ie = 513, le = 129, n_out = 1024;
  std::vector<float> imgs(n_src * ie);
  std::vector<int32_t> labs(n_src * le);
  for (size_t i = 0; i < imgs.size(); ++i) {
    imgs[i] = 0.37f * static_cast<float>(i % 1999) - 3.7f;
  }
  for (size_t i = 0; i < labs.size(); ++i) {
    labs[i] = static_cast<int32_t>(i % 129) - 1;  // full [-1, 127] range
  }
  std::vector<int64_t> idx(n_out);
  for (size_t i = 0; i < n_out; ++i) {
    idx[i] = static_cast<int64_t>((i * 131) % n_src);
  }
  for (int round = 0; round < 4; ++round) {
    // fp32 path
    std::vector<float> io(n_out * ie);
    std::vector<int32_t> lo(n_out * le);
    if (dwb_gather_pack(imgs.data(), labs.data(), idx.data(), n_out, n_src,
                        ie, le, 0, io.data(), lo.data(), nullptr, 8) != 0) {
      return fail("stress fp32 rc");
    }
    for (size_t i = 0; i < n_out; ++i) {
      if (std::memcmp(&io[i * ie], &imgs[idx[i] * ie], ie * sizeof(float)) ||
          std::memcmp(&lo[i * le], &labs[idx[i] * le],
                      le * sizeof(int32_t))) {
        return fail("stress fp32 content");
      }
    }
    // compact path: every element re-derived on the host side
    std::vector<uint16_t> ib(n_out * ie);
    std::vector<int8_t> lb(n_out * le);
    int32_t range[2] = {0, 0};
    if (dwb_gather_pack(imgs.data(), labs.data(), idx.data(), n_out, n_src,
                        ie, le, 1, ib.data(), lb.data(), range, 8) != 0) {
      return fail("stress compact rc");
    }
    for (size_t i = 0; i < n_out; ++i) {
      const uint32_t* bits =
          reinterpret_cast<const uint32_t*>(&imgs[idx[i] * ie]);
      for (size_t k = 0; k < ie; ++k) {
        if (ib[i * ie + k] != f32_to_bf16(bits[k])) {
          return fail("stress bf16 cast");
        }
      }
      for (size_t k = 0; k < le; ++k) {
        if (lb[i * le + k] !=
            static_cast<int8_t>(labs[idx[i] * le + k])) {
          return fail("stress int8 cast");
        }
      }
    }
    if (range[0] != -1 || range[1] != 127) return fail("stress range");
  }
  std::printf("batch_check stress OK\n");
  return 0;
}

int main(int argc, char** argv) {
  if (argc > 1 && std::strcmp(argv[1], "--stress") == 0) {
    if (int rc = stress()) return rc;
  }
  const size_t n_src = 5, ie = 7, le = 3;
  std::vector<float> imgs(n_src * ie);
  std::vector<int32_t> labs(n_src * le);
  for (size_t i = 0; i < imgs.size(); ++i) imgs[i] = 0.1f * i - 1.5f;
  for (size_t i = 0; i < labs.size(); ++i) labs[i] = (i % 129) - 1;
  std::vector<int64_t> idx = {4, 0, 0, 2};  // repeats = wrap-fill tails
  // fp32 path: exact copy at packed offsets.
  std::vector<float> io(idx.size() * ie);
  std::vector<int32_t> lo(idx.size() * le);
  if (dwb_gather_pack(imgs.data(), labs.data(), idx.data(), idx.size(),
                      n_src, ie, le, 0, io.data(), lo.data(), nullptr,
                      4) != 0) {
    return fail("fp32 rc");
  }
  for (size_t i = 0; i < idx.size(); ++i) {
    if (std::memcmp(&io[i * ie], &imgs[idx[i] * ie], ie * sizeof(float)) ||
        std::memcmp(&lo[i * le], &labs[idx[i] * le], le * sizeof(int32_t))) {
      return fail("fp32 gather content");
    }
  }
  // compact path: bf16 RNE + int8, plus the range report.
  std::vector<uint16_t> ib(idx.size() * ie);
  std::vector<int8_t> lb(idx.size() * le);
  int32_t range[2] = {0, 0};
  if (dwb_gather_pack(imgs.data(), labs.data(), idx.data(), idx.size(),
                      n_src, ie, le, 1, ib.data(), lb.data(), range,
                      4) != 0) {
    return fail("compact rc");
  }
  if (ib[0] != f32_to_bf16(*reinterpret_cast<uint32_t*>(&imgs[4 * ie]))) {
    return fail("bf16 cast");
  }
  if (range[0] < -1 || range[1] > 127) return fail("range report");
  // Error codes: bad index, out-of-range label.
  std::vector<int64_t> bad_idx = {99};
  if (dwb_gather_pack(imgs.data(), labs.data(), bad_idx.data(), 1, n_src,
                      ie, le, 0, io.data(), lo.data(), nullptr, 1) != -2) {
    return fail("index bound rc");
  }
  std::vector<int32_t> wide(le, 200);
  std::vector<int64_t> one = {0};
  if (dwb_gather_pack(imgs.data(), wide.data(), one.data(), 1, 1, ie, le, 1,
                      ib.data(), lb.data(), range, 1) != -3) {
    return fail("label range rc");
  }
  std::printf("batch_check OK\n");
  return 0;
}
#endif  // DWB_TEST_MAIN
