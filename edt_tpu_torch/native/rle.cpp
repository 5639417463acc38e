/* Host-side run-length kit (C++) of edt_tpu_torch, a copy of
 * edt_tpu/native/rle.cpp (the port imports nothing of the JAX package).
 *
 * Role-equivalent to the reference library's C++ RLE helpers
 * (edt_voxel_graph.hpp:238-310): serial O(N) bookkeeping that belongs on
 * the host CPU, not the card. Independent implementation with a flat C
 * ABI consumed via ctypes:
 *
 *   edt_run_starts_<T>:  boundary scan -> indices where a new run starts
 *   edt_fill_runs:       write a value under [start, end) intervals
 *   edt_copy_runs:       copy src->dst under [start, end) intervals
 *
 * Interval validation mirrors the reference's throwing checks
 * (edt_voxel_graph.hpp:277-283) but reports via return code (ctypes
 * cannot catch C++ exceptions).
 *
 * Built with g++ at first use by edt_tpu_torch/native/build.py.
 */

#include <cstdint>
#include <cstring>

namespace {

template <typename T>
int64_t run_starts(const T* labels, int64_t n, int64_t* starts) {
  if (n == 0) return 0;
  int64_t count = 0;
  starts[count++] = 0;
  T cur = labels[0];
  for (int64_t i = 1; i < n; i++) {
    if (labels[i] != cur) {  // typed compare: -0.0 == 0.0 merges, like numpy
      cur = labels[i];
      starts[count++] = i;
    }
  }
  return count;
}

inline bool runs_valid(int64_t nvox, const int64_t* starts,
                       const int64_t* ends, int64_t nruns) {
  for (int64_t r = 0; r < nruns; r++) {
    if (starts[r] < 0 || ends[r] > nvox || starts[r] >= ends[r]) return false;
  }
  return true;
}

}  // namespace

extern "C" {

#define DEFINE_RUN_STARTS(SUFFIX, T)                                    \
  int64_t edt_run_starts_##SUFFIX(const T* labels, int64_t n,           \
                                  int64_t* starts) {                    \
    return run_starts<T>(labels, n, starts);                            \
  }

DEFINE_RUN_STARTS(u8, uint8_t)
DEFINE_RUN_STARTS(u16, uint16_t)
DEFINE_RUN_STARTS(u32, uint32_t)
DEFINE_RUN_STARTS(u64, uint64_t)
DEFINE_RUN_STARTS(f32, float)
DEFINE_RUN_STARTS(f64, double)

#undef DEFINE_RUN_STARTS

/* Fill img[start:end) with the `itemsize`-byte pattern `value`.
 * Returns 0 on success, -1 on an invalid run. */
int edt_fill_runs(void* img, int64_t nvox, int64_t itemsize,
                  const void* value, const int64_t* starts,
                  const int64_t* ends, int64_t nruns) {
  if (!runs_valid(nvox, starts, ends, nruns)) return -1;
  char* base = static_cast<char*>(img);
  for (int64_t r = 0; r < nruns; r++) {
    char* p = base + starts[r] * itemsize;
    const int64_t len = ends[r] - starts[r];
    if (itemsize == 1) {
      std::memset(p, *static_cast<const uint8_t*>(value), len);
    } else {
      for (int64_t i = 0; i < len; i++) {
        std::memcpy(p + i * itemsize, value, itemsize);
      }
    }
  }
  return 0;
}

/* Copy src[start:end) into dst[start:end) for each run (dtype-agnostic). */
int edt_copy_runs(const void* src, void* dst, int64_t nvox, int64_t itemsize,
                  const int64_t* starts, const int64_t* ends, int64_t nruns) {
  if (!runs_valid(nvox, starts, ends, nruns)) return -1;
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  for (int64_t r = 0; r < nruns; r++) {
    std::memcpy(d + starts[r] * itemsize, s + starts[r] * itemsize,
                (ends[r] - starts[r]) * itemsize);
  }
  return 0;
}

}  // extern "C"
