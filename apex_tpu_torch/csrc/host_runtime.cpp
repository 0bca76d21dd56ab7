// host_runtime — native host-side runtime helpers for apex_tpu_torch
// (a copy of apex_tpu/csrc/host_runtime.cpp: the same functions and
// the same arithmetic, so both packages give the same bits).
//
// The host bookkeeping that runs every step or epoch:
//
//   * flat_layout       — aligned offset table for packing a tree of
//                         tensors into one flat buffer, with padding
//   * chunk_plan        — multi_tensor_apply-style chunking of a flat
//                         buffer into (tensor, chunk) work items
//   * shuffle_indices   — deterministic Fisher-Yates epoch shuffle
//                         (xorshift128+)
//   * gather_rows_f32   — multi-threaded batch gather: dataset rows ->
//     gather_rows_i32     contiguous batch buffer (host data loader)
//
// Built at first use by apex_tpu_torch/csrc/__init__.py with the host's
// `g++ -O3 -shared -fPIC -std=c++17 -pthread` (no CUDA, no torch
// headers) and bound with ctypes.  There is no fallback: a library that
// does not build raises.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Aligned flat-buffer layout.  sizes[n] in elements; align in elements
// (e.g. 128 for TPU lanes).  Writes offsets[n] and returns the padded
// total element count.
int64_t flat_layout(const int64_t* sizes, int64_t n, int64_t align,
                    int64_t* offsets) {
  int64_t off = 0;
  for (int64_t i = 0; i < n; ++i) {
    offsets[i] = off;
    int64_t sz = sizes[i];
    if (align > 1) sz = ((sz + align - 1) / align) * align;
    off += sz;
  }
  return off;
}

// multi_tensor_apply chunking: splits each tensor into chunk_size
// pieces.  Writes (tensor_idx, chunk_offset_in_tensor, chunk_len)
// triples into out[3 * max_items]; returns the number of items or -1
// if max_items is too small.  ≡ csrc/multi_tensor_apply.cuh:41-60.
int64_t chunk_plan(const int64_t* sizes, int64_t n, int64_t chunk_size,
                   int64_t* out, int64_t max_items) {
  int64_t item = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t remaining = sizes[i];
    int64_t off = 0;
    while (remaining > 0) {
      if (item >= max_items) return -1;
      int64_t len = remaining < chunk_size ? remaining : chunk_size;
      out[3 * item + 0] = i;
      out[3 * item + 1] = off;
      out[3 * item + 2] = len;
      off += len;
      remaining -= len;
      ++item;
    }
  }
  return item;
}

// xorshift128+ deterministic PRNG (stable across platforms/versions,
// unlike np.random.RandomState which the reference's sampler pins to
// torch.randperm semantics anyway).
static inline uint64_t xorshift128p(uint64_t* s) {
  uint64_t x = s[0];
  uint64_t const y = s[1];
  s[0] = y;
  x ^= x << 23;
  s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
  return s[1] + y;
}

// Fisher-Yates shuffle of [0, n) with the given seed.
void shuffle_indices(int64_t n, uint64_t seed, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t s[2] = {seed ^ 0x9E3779B97F4A7C15ULL,
                   (seed << 1) | 0x243F6A8885A308D3ULL};
  // warm up
  for (int k = 0; k < 8; ++k) (void)xorshift128p(s);
  for (int64_t i = n - 1; i > 0; --i) {
    int64_t j = (int64_t)(xorshift128p(s) % (uint64_t)(i + 1));
    std::swap(out[i], out[j]);
  }
}

// Multi-threaded gather: batch[b, :] = dataset[indices[b], :].
// dataset: (num_rows, row_len) f32 row-major.
void gather_rows_f32(const float* dataset, int64_t row_len,
                     const int64_t* indices, int64_t batch,
                     float* out, int64_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> threads;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= batch) break;
      std::memcpy(out + b * row_len, dataset + indices[b] * row_len,
                  sizeof(float) * (size_t)row_len);
    }
  };
  for (int64_t t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// int32 variant for token datasets.
void gather_rows_i32(const int32_t* dataset, int64_t row_len,
                     const int64_t* indices, int64_t batch,
                     int32_t* out, int64_t num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> threads;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= batch) break;
      std::memcpy(out + b * row_len, dataset + indices[b] * row_len,
                  sizeof(int32_t) * (size_t)row_len);
    }
  };
  for (int64_t t = 0; t < num_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
