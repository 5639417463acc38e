// Segment bounds and wall counts: one scan of each row of labels for its
// same-label runs, for Hopper (sm_90a).
//
// Replaces no kernel of edt_tpu/ops/pallas_kernels.py: the JAX package
// leaves these scans to XLA (edt_tpu/ops/core.py:segment_bounds and
// edt_tpu/models/soft.py:_wall_counts, a compare, two concatenations and
// a cummax / reversed cummin each). In the port the same formulation took
// about nine full-volume PyTorch kernels a scan, 10-23x its byte bound.
//
// For each voxel i of a row of n labels, with a boundary at j when
// j == 0 or label[j] != label[j - 1] (the label type's own !=, so for
// floats -0.0 == 0.0 and NaN != NaN):
//
//   start(i) = the last boundary j <= i,
//   end(i)   = the first boundary j > i, or n,
//
// and one of two epilogues writes
//   (a) start and end as int32 (ops/core.py:segment_bounds' contract), or
//   (b) the wall count min(i - start + 1, end - i) as int16 (n <= 16000) or
//       int32, in models/soft.py:_wall_counts' exact integer semantics: a
//       side where the run touches the row's edge is open unless
//       black_border, and a voxel open on both sides gets the sentinel
//       (30000 or 2^30). Every real count is at most n, every open side
//       above n, so min() of the two and "above n -> sentinel" are the
//       plain code's values.
//
// Bound: bytes. Each label is read once and each output written once:
// 12 B a voxel for int32 labels and int32 bounds, 9 B for bool labels,
// 6 B for int32 labels and int16 counts. The design keeps both scans out
// of device memory by working on boundary BITS: 32 compares make a 32-bit
// word, and start / end of any voxel are a count of leading or trailing
// zeros in its word, or the carry from the words before / after it.
//
// Two layouts, chosen by the wrapper from the scanned axis' stride:
//
// - Contiguous rows (stride 1): a warp per row. Per segment of 512
//   voxels, step k loads voxels 32k + lane (a coalesced 32-wide load of
//   consecutive labels, all 16 steps' loads in flight together), the
//   left neighbour comes from the previous lane (__shfl_up_sync) and the
//   compare's __ballot_sync is word k, kept by lane k. A max-scan over the
//   lanes' last boundaries (with the carry of the earlier segments) gives
//   each word's start-before; a min-scan from the right of their first
//   boundaries gives its end-after. Each step k then forms start / end of
//   voxel 32k + lane from word k and its two carries (three shuffles) and
//   stores coalesced. A segment of 512 (not 1024, a word a lane) keeps the
//   registers low enough for the warps a row needs in flight: on the
//   cells' 512-voxel rows it halved the wall counts' time, at the same
//   time for the bounds (which move 8 B a voxel out).
// - A strided axis (stride inner > 1, the volume's own layout): a thread
//   per (outer, inner) column, walking the axis with stride inner, so
//   neighbouring threads read and write neighbouring addresses. Per
//   segment of 1024 voxels, each word's 32 labels are loaded together and
//   folded into a word kept in shared memory ([word][thread],
//   conflict-free); a backward sweep over the words leaves each word's
//   end-after beside it, and a forward sweep carries start and writes
//   every voxel. The launch bound caps the registers for 7 blocks an SM,
//   as many as the shared memory holds (25 % faster than uncapped).
//
// Rows longer than one segment carry start forward; the end of a run that
// leaves a segment is found by reading ahead to the first boundary past
// it, once for all the segments it covers (the position is kept), so a
// label is read at most twice whatever the runs.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowWords = 16;      // a row segment: 16 words of 32 voxels
constexpr int kColWords = 32;      // a column segment: 32 words
constexpr int kRowThreads = 256;   // 8 warps a block, a warp a row
constexpr int kColThreads = 128;   // a thread a column
constexpr int kColBlocks = 7;      // resident blocks an SM: 32 KB smem each
constexpr int kMaxBlocks = 1 << 20;

// Label kinds (ops/bounds.py's _KINDS). Integers go by width: their bits
// are their values. Floats compare as their own type.
enum Kind { kU8, kU16, kU32, kU64, kF16, kBF16, kF32, kF64 };

template <int K> struct Label;
template <> struct Label<kU8> {
  using S = uint8_t;
  __device__ static bool neq(S a, S b) { return a != b; }
};
template <> struct Label<kU16> {
  using S = uint16_t;
  __device__ static bool neq(S a, S b) { return a != b; }
};
template <> struct Label<kU32> {
  using S = uint32_t;
  __device__ static bool neq(S a, S b) { return a != b; }
};
template <> struct Label<kU64> {
  using S = unsigned long long;
  __device__ static bool neq(S a, S b) { return a != b; }
};
template <> struct Label<kF16> {
  using S = uint16_t;
  __device__ static bool neq(S a, S b) {
    return __half2float(__ushort_as_half(a)) != __half2float(__ushort_as_half(b));
  }
};
template <> struct Label<kBF16> {
  using S = uint16_t;
  __device__ static bool neq(S a, S b) {
    return __bfloat162float(__ushort_as_bfloat16(a)) !=
           __bfloat162float(__ushort_as_bfloat16(b));
  }
};
template <> struct Label<kF32> {
  using S = uint32_t;
  __device__ static bool neq(S a, S b) {
    return __uint_as_float(a) != __uint_as_float(b);
  }
};
template <> struct Label<kF64> {
  using S = unsigned long long;
  __device__ static bool neq(S a, S b) {
    return __longlong_as_double((long long)a) != __longlong_as_double((long long)b);
  }
};

// Shuffles of a label's bits, 8 B ones whole.
__device__ __forceinline__ unsigned shfl_up(unsigned v) {
  return __shfl_up_sync(kFull, v, 1);
}
__device__ __forceinline__ unsigned long long shfl_up(unsigned long long v) {
  return __shfl_up_sync(kFull, v, 1);
}
__device__ __forceinline__ unsigned shfl(unsigned v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ unsigned long long shfl(unsigned long long v, int src) {
  return __shfl_sync(kFull, v, src);
}
template <typename S>
using Wide = typename std::conditional<sizeof(S) == 8, unsigned long long, unsigned>::type;

// Epilogue (a): start and end, int32.
struct Bounds {
  int* start;
  int* end;
  __device__ void store(long long at, int i, int s, int e, int n) const {
    start[at] = s;
    end[at] = e;
  }
};

// Epilogue (b): the wall count, OutT int16 or int32.
template <typename OutT>
struct Walls {
  OutT* out;
  int sent;
  bool edge;  // black_border: the row's ends are walls
  __device__ void store(long long at, int i, int s, int e, int n) const {
    const int li = (s > 0 || edge) ? i - s + 1 : INT_MAX;
    const int ri = (e < n || edge) ? e - i : INT_MAX;
    const int w = min(li, ri);
    out[at] = (OutT)(w > n ? sent : w);
  }
};

// The first boundary at or after q (q >= 1) of the row x (stride 1), or n:
// the warp reads 32 voxels a step until one differs from its left
// neighbour.
template <int K>
__device__ int first_boundary_warp(const typename Label<K>::S* x, int q, int n, int lane) {
  for (; q < n; q += 32) {
    const int p = q + lane;
    const bool b = p < n && Label<K>::neq(x[p], x[p - 1]);
    const unsigned m = __ballot_sync(kFull, b);
    if (m) return q + __ffs(m) - 1;
  }
  return n;
}

template <int K, class Epi>
__global__ void __launch_bounds__(kRowThreads)
segment_rows_kernel(const typename Label<K>::S* __restrict__ labels, Epi epi,
                    long long rows, int n) {
  using S = typename Label<K>::S;
  using W = Wide<S>;
  const int lane = threadIdx.x & 31;
  const unsigned le = kFull >> (31 - lane);  // bits 0..lane
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < rows; r += warps) {
    const S* x = labels + r * n;
    const long long at = r * n;
    int carry = 0;    // the last boundary before the segment
    int ahead = -1;   // the first boundary at or past the segment's end
    W last = 0;       // the label before the segment
    for (int base = 0; base < n; base += 32 * kRowWords) {
      const int steps = min(kRowWords, (n - base + 31) >> 5);
      W v[kRowWords];
#pragma unroll
      for (int k = 0; k < kRowWords; ++k) {
        const int p = base + 32 * k + lane;
        v[k] = (k < steps && p < n) ? (W)x[p] : (W)0;
      }
      unsigned word = 0;  // lane k keeps word k
#pragma unroll
      for (int k = 0; k < kRowWords; ++k) {
        if (k < steps) {
          const int p = base + 32 * k + lane;
          const W up = shfl_up(v[k]);
          const W left = lane == 0 ? last : up;
          const bool b = p < n && (p == 0 || Label<K>::neq((S)v[k], (S)left));
          const unsigned m = __ballot_sync(kFull, b);
          if (lane == k) word = m;
          last = shfl(v[k], 31);
        }
      }
      const int wbase = base + 32 * lane;
      // start-before: the last boundary in the words before mine, or carry
      int incl = word ? wbase + 31 - __clz(word) : -1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl = max(incl, t);
      }
      int before = __shfl_up_sync(kFull, incl, 1);
      before = max(lane == 0 ? -1 : before, carry);
      carry = max(carry, __shfl_sync(kFull, incl, 31));
      // end-after: the first boundary in the words after mine, or ahead
      int incr = word ? wbase + __ffs(word) - 1 : INT_MAX;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_down_sync(kFull, incr, o);
        if (lane + o < 32) incr = min(incr, t);
      }
      int after = __shfl_down_sync(kFull, incr, 1);
      if (lane == 31) after = INT_MAX;
      const int seg_end = base + 32 * kRowWords;
      if (seg_end >= n) {
        ahead = n;
      } else if (ahead < seg_end) {
        ahead = first_boundary_warp<K>(x, seg_end, n, lane);
      }
      after = min(after, ahead);
#pragma unroll
      for (int k = 0; k < kRowWords; ++k) {
        if (k < steps) {
          const unsigned w = __shfl_sync(kFull, word, k);
          const int s0 = __shfl_sync(kFull, before, k);
          const int e0 = __shfl_sync(kFull, after, k);
          const int p = base + 32 * k + lane;
          if (p < n) {
            const unsigned lo = w & le, hi = w & ~le;
            const int s = lo ? base + 32 * k + 31 - __clz(lo) : s0;
            const int e = hi ? base + 32 * k + __ffs(hi) - 1 : e0;
            epi.store(at + p, p, s, e, n);
          }
        }
      }
    }
  }
}

template <int K, class Epi>
__global__ void __launch_bounds__(kColThreads, kColBlocks)
segment_columns_kernel(const typename Label<K>::S* __restrict__ labels,
                       Epi epi, long long outer, int n, long long inner) {
  using S = typename Label<K>::S;
  __shared__ unsigned words[kColWords][kColThreads];
  __shared__ int after[kColWords][kColThreads];
  const int t = threadIdx.x;
  const long long cols = outer * inner;
  for (long long col = (long long)blockIdx.x * blockDim.x + t; col < cols;
       col += (long long)gridDim.x * blockDim.x) {
    const long long o = col / inner;
    const long long at0 = o * n * inner + (col - o * inner);
    const S* x = labels + at0;
    int carry = 0;
    int ahead = -1;
    S last = 0;
    for (int base = 0; base < n; base += 32 * kColWords) {
      const int steps = min(kColWords, (n - base + 31) >> 5);
      for (int k = 0; k < steps; ++k) {
        const int p0 = base + 32 * k;
        S v[32];
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          if (p0 + b < n) v[b] = x[(long long)(p0 + b) * inner];
        }
        unsigned w = 0;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const int p = p0 + b;
          if (p < n) {
            const bool bd = p == 0 || Label<K>::neq(v[b], b ? v[b - 1] : last);
            w |= (unsigned)bd << b;
          }
        }
        if (p0 + 31 < n) last = v[31];  // the next word's left neighbour
        words[k][t] = w;
      }
      const int seg_end = base + 32 * kColWords;
      if (seg_end >= n) {
        ahead = n;
      } else if (ahead < seg_end) {
        int q = seg_end;
        while (q < n && !Label<K>::neq(x[(long long)q * inner],
                                       x[(long long)(q - 1) * inner]))
          ++q;
        ahead = q;
      }
      int next = ahead;
      for (int k = steps - 1; k >= 0; --k) {
        after[k][t] = next;
        const unsigned w = words[k][t];
        if (w) next = base + 32 * k + __ffs(w) - 1;
      }
      for (int k = 0; k < steps; ++k) {
        const unsigned w = words[k][t];
        const int e0 = after[k][t];
        const int p0 = base + 32 * k;
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const int p = p0 + b;
          if (p < n) {
            if ((w >> b) & 1u) carry = p;
            const unsigned hi = b == 31 ? 0u : w >> (b + 1);
            const int e = hi ? p + __ffs(hi) : e0;
            epi.store(at0 + (long long)p * inner, p, carry, e, n);
          }
        }
      }
    }
  }
}

unsigned blocks(long long work, int per_block) {
  const long long b = (work + per_block - 1) / per_block;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

template <int K, class Epi>
cudaError_t launch(const void* labels, Epi epi, long long outer, int n,
                   long long inner, cudaStream_t stream) {
  using S = typename Label<K>::S;
  const S* x = static_cast<const S*>(labels);
  if (inner == 1) {
    segment_rows_kernel<K, Epi><<<blocks(outer, kRowThreads / 32), kRowThreads, 0,
                                  stream>>>(x, epi, outer, n);
  } else if constexpr (std::is_same<Epi, Bounds>::value) {
    return cudaErrorInvalidValue;  // the bounds are always along rows
  } else {
    segment_columns_kernel<K, Epi><<<blocks(outer * inner, kColThreads), kColThreads,
                                     0, stream>>>(x, epi, outer, n, inner);
  }
  return cudaGetLastError();
}

template <class Epi>
cudaError_t dispatch(int kind, const void* labels, Epi epi, long long outer,
                     int n, long long inner, cudaStream_t st) {
  switch (kind) {
    case kU8: return launch<kU8>(labels, epi, outer, n, inner, st);
    case kU16: return launch<kU16>(labels, epi, outer, n, inner, st);
    case kU32: return launch<kU32>(labels, epi, outer, n, inner, st);
    case kU64: return launch<kU64>(labels, epi, outer, n, inner, st);
    case kF16: return launch<kF16>(labels, epi, outer, n, inner, st);
    case kBF16: return launch<kBF16>(labels, epi, outer, n, inner, st);
    case kF32: return launch<kF32>(labels, epi, outer, n, inner, st);
    case kF64: return launch<kF64>(labels, epi, outer, n, inner, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// labels: (rows, n) of the label kind, C-contiguous; start, end: (rows, n)
// int32. Returns a cudaError_t.
int edt_segment_bounds(const void* labels, void* start, void* end,
                       long long rows, int n, int kind, void* stream) {
  const Bounds epi{static_cast<int*>(start), static_cast<int*>(end)};
  return (int)dispatch(kind, labels, epi, rows, n, 1, (cudaStream_t)stream);
}

// labels: (outer, n, inner) of the label kind, C-contiguous, scanned along
// n; out: the same shape, int16 (out_bytes 2) or int32 (out_bytes 4) wall
// counts with sentinel sent. Returns a cudaError_t.
int edt_wall_counts(const void* labels, void* out, long long outer, int n,
                    long long inner, int kind, int out_bytes, int sent,
                    int black_border, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool edge = black_border != 0;
  if (out_bytes == 2) {
    const Walls<int16_t> epi{static_cast<int16_t*>(out), sent, edge};
    return (int)dispatch(kind, labels, epi, outer, n, inner, st);
  }
  if (out_bytes == 4) {
    const Walls<int32_t> epi{static_cast<int32_t*>(out), sent, edge};
    return (int)dispatch(kind, labels, epi, outer, n, inner, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
