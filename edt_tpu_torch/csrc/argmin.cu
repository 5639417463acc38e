// K2: min-plus with its leftmost argmin, walls optional, for Hopper (sm_90a).
// The forward of the differentiable EDT at temperature 0.
//
// Replaces edt_tpu/ops/pallas_kernels.py:_minplus_argmin_rowsweep_kernel and
// _minplus_argmin_kernel (and their _wall_tile). For each row r of f (R, n):
//
//   d[r, i]    = min_j f[r, j] + w2 (i - j)^2
//   argj[r, i] = the smallest j reaching that minimum (like jnp.argmin;
//                0 where every candidate is INF)
//
// then, walled, the wall is min'd in: a wall strictly below d wins (ties go
// to the candidate). Walls are f32 squared distances (INF = open), or int16 /
// int32 COUNTS c (>= 30000 / 2^30 = open) whose square is formed here as
// (w2 * c) * c, the order of edt_tpu/models/soft.py:_walls_from_counts. The
// arg comes out as the absolute int32 index (~i on a wall win), or as the
// offset argj - i in int16 / int32 (the dtype's min on a wall win): the
// residual the backward (K3, K4) reads.
//
// Design. One block per row, about eight targets a thread (32 to 256
// threads), so that short rows leave many blocks on an SM; the row's f is
// staged in dynamic shared memory (4 B a voxel: the axis ceiling is the
// opt-in shared memory over 4). A block reduction gives the row's floor
// minf and bound = max_i min(f_i, wall_i) (max_i f_i unwalled), and from
// them the radius r exactly as _radius_gap/_radius_from_gap form it: every
// winner and every tie lies within w2 k^2 <= bound - minf. The walls are
// read in the reduction and again, one per target, in the search (an L1/L2
// hit); they take no shared memory.
//
// Each thread takes targets i = tid, tid + blockDim, ... and searches
// outward, k = 0, 1, ..., min(r, max(i, n - 1 - i)), with
// q_k = __fmul_rn(w2, __fmul_rn(k, k)) formed once a step for both
// candidates j = i - k and j = i + k inside the row. It stops before step
// k when __fadd_rn(minf, q_k) > min(best, wall_i): rounding is monotone and
// f_j >= minf, so every candidate left rounds to a cost strictly above
// best (cannot win or tie) or strictly above the wall (loses to it
// either way). The inequality is strict because ties go to the candidate.
// The leftmost j keeps a tie: visiting outward, the left candidate
// (smaller than every j seen) takes over on c <= best, the right one
// (larger than every j seen) only on c < best. j = i comes first; an INF
// cost from the left may take over an INF best, so a best still INF at
// the end (every cost INF) is given arg 0. The values and args are those
// of the ascending scan over [i - r, i + r] with a strict <, bit for bit.
// A target takes about sqrt((min(d_i, wall_i) - minf) / w2) steps instead
// of r: unwalled rows of barrier heights, whose r is the whole row, stop
// just past the nearest zero.
//
// Long rows (past the shared-memory ceiling, any n; the wrapper may also
// ask for this mode on a shorter row) take the same kernel's second
// instantiation: a block of 256 threads for each kLongChunk targets of a
// row, grid (rows, chunks). Every block reduces its whole row's floor and
// bound from device memory, then searches its own chunk with f read from
// device memory (the row stays in L2: a 65536-voxel row is 256 KiB); the
// values and args are the short-row mode's, bit for bit. A warp's slowest
// target then pays an L2 latency at every step. Rows past I16_MAX_AXIS
// carry int32 offsets and counts (the wrapper's link_dtype).
//
// Exactness: every cost is __fadd_rn(f_j, __fmul_rn(w2, __fmul_rn(k, k)))
// with k a float, two roundings as in the reference (built with -fmad=false
// as well); the radius uses IEEE division and sqrt; a count is compared with
// its sentinel as an integer.
//
// Bound on the card: HBM bytes. On the multi-label path f (4 B) and int16
// counts (2 B) are read once, d (4 B) and int16 offsets (2 B) written once:
// 12 B a voxel. The search's instructions hold the kernel above it: about
// twenty a step of two candidates, and a warp runs until its slowest
// target stops.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kLongChunk = 8192;  // long rows: targets a block searches
constexpr int kSent16 = 30000;
constexpr int kSent32 = 1 << 30;

enum WallKind { kNoWalls = 0, kWallF32 = 1, kWallI16 = 2, kWallI32 = 3 };
enum ArgKind { kAbsI32 = 0, kOffI16 = 1, kOffI32 = 2 };

template <int kWall>
__device__ __forceinline__ float load_wall(const void* walls, size_t k,
                                           float w2) {
  if (kWall == kWallF32) return __ldg(static_cast<const float*>(walls) + k);
  int c, sent;
  if (kWall == kWallI16) {
    c = __ldg(static_cast<const int16_t*>(walls) + k);
    sent = kSent16;
  } else {
    c = __ldg(static_cast<const int32_t*>(walls) + k);
    sent = kSent32;
  }
  if (c >= sent) return INFINITY;
  const float cf = (float)c;
  return __fmul_rn(__fmul_rn(w2, cf), cf);
}

template <int kWall, int kArg, bool kLong>
__global__ void __launch_bounds__(kMaxThreads)
minplus_argmin_kernel(const float* __restrict__ f,
                      const void* __restrict__ walls,
                      float* __restrict__ out, void* __restrict__ arg, int n,
                      float w2) {
  constexpr bool kWalled = kWall != kNoWalls;
  extern __shared__ float smem[];
  __shared__ float s_minf[kMaxThreads / 32];
  __shared__ float s_bound[kMaxThreads / 32];
  __shared__ float s_row_minf;
  __shared__ int s_radius;

  const size_t base = (size_t)blockIdx.x * (size_t)n;
  // the row: staged in shared memory, or read from device memory (L2) on
  // long rows
  const float* s_f = kLong ? f + base : smem;

  // --- stage f, reduce the row's floor and bound ---
  float minf = INFINITY;
  float bound = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float fi = f[base + i];
    if constexpr (!kLong) smem[i] = fi;
    minf = fminf(minf, fi);
    float b = fi;
    if (kWalled) b = fminf(fi, load_wall<kWall>(walls, base + i, w2));
    bound = fmaxf(bound, b);
  }
  for (int off = 16; off > 0; off >>= 1) {
    minf = fminf(minf, __shfl_xor_sync(0xffffffffu, minf, off));
    bound = fmaxf(bound, __shfl_xor_sync(0xffffffffu, bound, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_minf[warp] = minf;
    s_bound[warp] = bound;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      minf = fminf(minf, s_minf[k]);
      bound = fmaxf(bound, s_bound[k]);
    }
    // _radius_gap: all-INF rows need no candidates beyond j == i; a row
    // with an infinite bound over finite candidates may search in full
    float gap = __fsub_rn(bound, minf);
    if (isfinite(gap)) {
      gap = fmaxf(gap, 0.0f);
    } else {
      gap = (minf == INFINITY) ? 0.0f : INFINITY;
    }
    // _radius_from_gap: ulp-guarded floor, clamped to n before the cast
    float r = __fadd_rn(__fmul_rn(__fsqrt_rn(__fdiv_rn(gap, w2)), 1.00001f), 0.01f);
    r = fminf(r, (float)n);
    s_radius = (int)r;
    s_row_minf = minf;
  }
  __syncthreads();
  const int radius = s_radius;
  minf = s_row_minf;

  // --- each target's outward search, stopped exactly, then the wall; a
  // long row's block takes its own chunk of targets ---
  const int lo = kLong ? (int)blockIdx.y * kLongChunk : 0;
  const int hi = kLong ? min(n, lo + kLongChunk) : n;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const float wi = kWalled ? load_wall<kWall>(walls, base + i, w2) : INFINITY;
    const int kmax = min(radius, max(i, n - 1 - i));
    // j = i first; a best still INF at the end gets arg 0
    float best = __fadd_rn(s_f[i], __fmul_rn(w2, 0.0f));
    int bj = i;
    float lim = fminf(best, wi);
    float kf = 0.0f;
    for (int k = 1; k <= kmax; ++k) {
      kf = __fadd_rn(kf, 1.0f);
      const float q = __fmul_rn(w2, __fmul_rn(kf, kf));
      if (__fadd_rn(minf, q) > lim) break;  // nothing further wins or ties
      if (k <= i) {  // the smallest j yet: takes a tie
        const float c = __fadd_rn(s_f[i - k], q);
        if (c <= best) {
          best = c;
          bj = i - k;
        }
      }
      if (i + k < n) {  // the largest j yet: must beat
        const float c = __fadd_rn(s_f[i + k], q);
        if (c < best) {
          best = c;
          bj = i + k;
        }
      }
      lim = fminf(best, wi);
    }
    if (best == INFINITY) bj = 0;  // every cost INF: arg 0, as jnp.argmin
    bool wall_win = false;
    if (kWalled && wi < best) {  // ties stay with the candidate
      best = wi;
      wall_win = true;
    }
    out[base + i] = best;
    if (kArg == kAbsI32) {
      static_cast<int32_t*>(arg)[base + i] = wall_win ? ~i : bj;
    } else if (kArg == kOffI16) {
      static_cast<int16_t*>(arg)[base + i] =
          wall_win ? (int16_t)INT16_MIN : (int16_t)(bj - i);
    } else {
      static_cast<int32_t*>(arg)[base + i] = wall_win ? INT32_MIN : bj - i;
    }
  }
}

template <int kWall, int kArg>
cudaError_t launch(const float* f, const void* walls, float* out, void* arg,
                   long long rows, int n, float w2, bool long_rows,
                   cudaStream_t stream) {
  if (long_rows) {  // a block a chunk of a row, f read from device memory
    const dim3 grid((unsigned)rows, (unsigned)((n + kLongChunk - 1) / kLongChunk));
    minplus_argmin_kernel<kWall, kArg, true><<<grid, kMaxThreads, 0, stream>>>(
        f, walls, out, arg, n, w2);
    return cudaGetLastError();
  }
  // about eight targets a thread: a short row's block stays small, so
  // more rows share an SM and the reduction's barriers hold fewer warps
  int threads = ((n + 8 * 32 - 1) / (8 * 32)) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      minplus_argmin_kernel<kWall, kArg, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  minplus_argmin_kernel<kWall, kArg, false><<<(unsigned)rows, threads, smem,
                                               stream>>>(f, walls, out, arg, n,
                                                         w2);
  return cudaGetLastError();
}

template <int kWall>
cudaError_t dispatch_arg(int arg_kind, const float* f, const void* walls,
                         float* out, void* arg, long long rows, int n,
                         float w2, bool long_rows, cudaStream_t stream) {
  switch (arg_kind) {
    case kAbsI32:
      return launch<kWall, kAbsI32>(f, walls, out, arg, rows, n, w2, long_rows, stream);
    case kOffI16:
      return launch<kWall, kOffI16>(f, walls, out, arg, rows, n, w2, long_rows, stream);
    case kOffI32:
      return launch<kWall, kOffI32>(f, walls, out, arg, rows, n, w2, long_rows, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// f, out: (rows, n) f32; walls: (rows, n) of wall_kind (0 none: may be
// null, 1 f32, 2 int16 counts, 3 int32 counts); arg: (rows, n) of arg_kind
// (0 absolute int32, 1 int16 offsets, 2 int32 offsets). All C-contiguous.
// long_rows: the mode for rows past the shared-memory ceiling (any n; also
// taken on request). Returns a cudaError_t.
int edt_minplus_argmin(const void* f, const void* walls, void* out, void* arg,
                       long long rows, int n, float w2, int wall_kind,
                       int arg_kind, int long_rows, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* ff = (const float*)f;
  float* oo = (float*)out;
  const bool lr = long_rows != 0;
  switch (wall_kind) {
    case kNoWalls:
      return (int)dispatch_arg<kNoWalls>(arg_kind, ff, walls, oo, arg, rows, n, w2, lr, st);
    case kWallF32:
      return (int)dispatch_arg<kWallF32>(arg_kind, ff, walls, oo, arg, rows, n, w2, lr, st);
    case kWallI16:
      return (int)dispatch_arg<kWallI16>(arg_kind, ff, walls, oo, arg, rows, n, w2, lr, st);
    case kWallI32:
      return (int)dispatch_arg<kWallI32>(arg_kind, ff, walls, oo, arg, rows, n, w2, lr, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
