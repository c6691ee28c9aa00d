// Native fast Walsh-Hadamard transform for the CPU oracle path.
//
// Role (SURVEY.md §2 #8): the reference lineage's only native component is a
// C FWHT extension (pyfht-style).  The device path uses XLA matmul mode
// contractions instead (sparc_ldpc_tpu/ops/fwht.py); this C++ library serves the NumPy
// oracle, making the CPU throughput baseline (BASELINE.md 10x target) an
// honest, optimized one rather than a strawman.
//
// Exposed via ctypes (no pybind11 in this environment): plain C ABI,
// in-place, natural (Sylvester) ordering H_N = H_2 ⊗ ... ⊗ H_2, matching
// sparc_ldpc_tpu.oracle.fwht.fwht_np and the JAX mode-contraction transform.
//
// Build: make -C native   ->  native/libsparcfwht.so (the oracle also builds
// it at first use).  Single-threaded: the oracle transforms one vector per
// call.

#include <cstdint>
#include <cstddef>

namespace {

template <typename T>
void fwht_one(T* x, int64_t n) {
  // Iterative radix-2 butterflies, cache-blocked over the stride-h loop.
  for (int64_t h = 1; h < n; h <<= 1) {
    for (int64_t i = 0; i < n; i += h << 1) {
      T* a = x + i;
      T* b = x + i + h;
      for (int64_t j = 0; j < h; ++j) {
        T u = a[j];
        T v = b[j];
        a[j] = u + v;
        b[j] = u - v;
      }
    }
  }
}

}  // namespace

extern "C" {

// In-place FWHT over `batch` contiguous vectors of length `n` (n = 2^k).
void fwht_f64(double* x, int64_t batch, int64_t n) {
  for (int64_t b = 0; b < batch; ++b) fwht_one(x + b * n, n);
}

void fwht_f32(float* x, int64_t batch, int64_t n) {
  for (int64_t b = 0; b < batch; ++b) fwht_one(x + b * n, n);
}

}  // extern "C"
