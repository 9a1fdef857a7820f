// Host-side batch assembly for the streaming input pipeline.
//
// The device side of streaming training is one step kernel per batch
// (step_kernels.cu); this is the HOST side for data sets too large for device
// memory: a deterministic shuffle and a multithreaded row gather that
// assembles contiguous batches from a (possibly memory-mapped) array at memcpy
// speed, overlapped with the device work by the double buffer in
// data_stream.py.
//
// Determinism contract: df_shuffle(seed, n) is a Fisher-Yates permutation
// driven by splitmix64, mirrored bit for bit by the numpy fallback in
// native/__init__.py and by the JAX package's loader, so every path produces
// identical epochs.
//
// Build: the host C++ compiler, -O3 -shared -fPIC -pthread (_build.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// splitmix64 (public-domain algorithm, Sebastiano Vigna): a tiny 64-bit
// generator that is trivial to mirror in Python.
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// Plain modulo of the 64-bit draw: the bias is below 2^-40 for bounds below
// 2^24, and the Python fallback mirrors the same arithmetic.
inline uint64_t bounded(uint64_t& state, uint64_t bound) {
  return splitmix64(state) % bound;
}

template <typename T>
void gather_rows(const T* src, const int64_t* idx, int64_t n_idx,
                 int64_t row_len, T* out, int n_threads) {
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * row_len, src + idx[i] * row_len,
                  sizeof(T) * static_cast<size_t>(row_len));
    }
  };
  if (n_threads <= 1 || n_idx < 4 * n_threads) {
    worker(0, n_idx);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_idx + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(lo + chunk, n_idx);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Fisher-Yates permutation of [0, n) into out, driven by splitmix64(seed).
void df_shuffle(uint64_t seed, int64_t n, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t state = seed;
  for (int64_t i = n - 1; i > 0; --i) {
    uint64_t j = bounded(state, static_cast<uint64_t>(i) + 1);
    int64_t tmp = out[i];
    out[i] = out[j];
    out[j] = tmp;
  }
}

// Threaded row gather: out[i, :] = src[idx[i], :].
void df_gather_f32(const float* src, const int64_t* idx, int64_t n_idx,
                   int64_t row_len, float* out, int n_threads) {
  gather_rows(src, idx, n_idx, row_len, out, n_threads);
}

void df_gather_f64(const double* src, const int64_t* idx, int64_t n_idx,
                   int64_t row_len, double* out, int n_threads) {
  gather_rows(src, idx, n_idx, row_len, out, n_threads);
}

int df_version() { return 1; }

}  // extern "C"
