// pointprep: host-side point-cloud preparation for the data pipelines of
// sst_tpu_torch (the two entry points that data/pipelines.py calls, the same
// code as the JAX package's sst_tpu/data/native/pointprep.cc, so both
// packages give the same samples).
//
// C ABI for ctypes. Both functions are thread-safe and work on buffers the
// caller owns.
//
// Build: data/native/__init__.py (g++ -O3 -march=native -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>

extern "C" {

// In-place filter of points [n, c] to the xy/z range; returns the new count.
int64_t pp_range_filter(float* pts, int64_t n, int64_t c, const float* pcr) {
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * c;
    if (p[0] >= pcr[0] && p[0] < pcr[3] && p[1] >= pcr[1] && p[1] < pcr[4] &&
        p[2] >= pcr[2] && p[2] < pcr[5]) {
      if (w != i) memcpy(pts + w * c, p, sizeof(float) * (size_t)c);
      ++w;
    }
  }
  return w;
}

// Subsample and shuffle points [n, c] into out [cap, c] by a partial
// Fisher-Yates over [0, n) driven by mt19937_64(seed): a uniform random
// subset without replacement if n > cap, else every point (shuffled) and zero
// padding. Returns the number of points kept.
int64_t pp_shuffle_pad(const float* pts, int64_t n, int64_t c, float* out,
                       int64_t cap, uint64_t seed) {
  std::mt19937_64 rng(seed);
  const int64_t keep = n < cap ? n : cap;
  int64_t* idx = new int64_t[(size_t)n];
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  for (int64_t i = 0; i < keep; ++i) {
    const int64_t j = i + (int64_t)(rng() % (uint64_t)(n - i));
    std::swap(idx[i], idx[j]);
    memcpy(out + i * c, pts + idx[i] * c, sizeof(float) * (size_t)c);
  }
  delete[] idx;
  if (keep < cap)
    memset(out + keep * c, 0, sizeof(float) * (size_t)((cap - keep) * c));
  return keep;
}

}  // extern "C"
