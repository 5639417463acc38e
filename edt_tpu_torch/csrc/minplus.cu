// K1: the min-plus (Felzenszwalb–Huttenlocher parabolic) pass of the EDT
// with its wall parabolas fused, for Hopper (sm_90a).
//
// Replaces edt_tpu/ops/pallas_kernels.py:_minplus_kernel and
// _minplus_rowsweep_kernel (and the split mode's _minplus_fixup_kernel,
// whose values are K1's own). For each row r of f (R, n):
//
//   d[r, i] = min_j f[r, j] + w2 (i - j)^2
//
// then, masked (multi-label): min with the segment wall parabolas
// w2 (i - ss + 1)^2 and w2 (se - i)^2, the outer ones INF at an open row
// end unless black_border; binary: min with the whole-row border
// parabolas when black_border. Background needs no zeroing: it carries
// f == 0, and the candidate j == i pins it to 0.
//
// Design (first version: right and simple). One block per row. The row's f
// is staged in dynamic shared memory; a block reduction gives the row's
// floor minf and bound = max_i min(f_i, wall_i), and from them the
// pruning radius exactly as _radius_gap/_radius_from_gap form it. Each
// thread takes targets i = tid, tid + blockDim, ... and scans
// j in [i - r, i + r] ∩ [0, n), clipped in the masked case to i's own
// segment [ss_i, se_i): candidates outside it never beat the walls. A
// per-row radius is looser than the TPU's per-tile one, so it prunes only
// candidates that cannot win, and the values are unchanged.
//
// Exactness: every cost is __fadd_rn(f_j, __fmul_rn(w2, __fmul_rn(k, k)))
// with k a float, two roundings as in the reference (built with
// -fmad=false as well), and the radius uses IEEE division and sqrt.
//
// Bound on the card: HBM bytes. f, ss and se are read once and d written
// once: 16 B a voxel (4 for binary's f plus 4 for d: 8 B). The work is
// about (2 r + 1) candidates a voxel, a few flops each, far under the
// bytes at the radii of real volumes. This version does nothing yet to
// reach that bound: one row per block leaves loads uncoalesced across
// rows and threads idle in short rows, and thread loops diverge.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float sq_wall(float w2, int k) {
  const float kf = (float)k;
  return __fmul_rn(w2, __fmul_rn(kf, kf));
}

template <bool kMasked>
__global__ void __launch_bounds__(kMaxThreads)
minplus_walls_kernel(const float* __restrict__ f,
                     const int32_t* __restrict__ ss,
                     const int32_t* __restrict__ se,
                     float* __restrict__ out, int n, float w2,
                     bool black_border) {
  extern __shared__ float s_f[];
  __shared__ float s_minf[kMaxThreads / 32];
  __shared__ float s_bound[kMaxThreads / 32];
  __shared__ int s_radius;

  const size_t base = (size_t)blockIdx.x * (size_t)n;
  const float* fr = f + base;
  const int32_t* ssr = kMasked ? ss + base : nullptr;
  const int32_t* ser = kMasked ? se + base : nullptr;
  float* outr = out + base;

  // --- stage f, reduce the row's floor and bound ---
  float minf = INFINITY;
  float bound = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float fi = fr[i];
    s_f[i] = fi;
    minf = fminf(minf, fi);
    float b = fi;
    if (kMasked) {
      const int s = ssr[i], e = ser[i];
      const float lw = (black_border || s > 0) ? sq_wall(w2, i - s + 1) : INFINITY;
      const float rw = (black_border || e < n) ? sq_wall(w2, e - i) : INFINITY;
      b = fminf(fi, fminf(lw, rw));
    } else if (black_border) {
      b = fminf(fi, fminf(sq_wall(w2, i + 1), sq_wall(w2, n - i)));
    }
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
    // with an infinite bound over finite candidates scans in full
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
  }
  __syncthreads();
  const int radius = s_radius;

  // --- pruned min-plus over each target's window, then the walls ---
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int lo = max(0, i - radius);
    int hi = min(n, i + radius + 1);
    int s = 0, e = n;
    if (kMasked) {
      s = ssr[i];
      e = ser[i];
      lo = max(lo, s);
      hi = min(hi, e);
    }
    float acc = INFINITY;
    for (int j = lo; j < hi; ++j) {
      acc = fminf(acc, __fadd_rn(s_f[j], sq_wall(w2, i - j)));
    }
    if (kMasked) {
      const float lw = (black_border || s > 0) ? sq_wall(w2, i - s + 1) : INFINITY;
      const float rw = (black_border || e < n) ? sq_wall(w2, e - i) : INFINITY;
      acc = fminf(acc, fminf(lw, rw));
    } else if (black_border) {
      acc = fminf(acc, __fmul_rn(w2, fminf(__fmul_rn((float)(i + 1), (float)(i + 1)),
                                           __fmul_rn((float)(n - i), (float)(n - i)))));
    }
    outr[i] = acc;
  }
}

template <bool kMasked>
cudaError_t launch(const float* f, const int32_t* ss, const int32_t* se,
                   float* out, long long rows, int n, float w2,
                   bool black_border, cudaStream_t stream) {
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      minplus_walls_kernel<kMasked>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  minplus_walls_kernel<kMasked><<<(unsigned)rows, threads, smem, stream>>>(
      f, ss, se, out, n, w2, black_border);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f, out: (rows, n) f32, C-contiguous. ss, se: (rows, n) int32 segment
// bounds when masked, else ignored (may be null). Returns a cudaError_t.
int edt_minplus_walls(const void* f, const void* ss, const void* se,
                      void* out, long long rows, int n, float w2, int masked,
                      int black_border, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (masked) {
    return (int)launch<true>((const float*)f, (const int32_t*)ss,
                             (const int32_t*)se, (float*)out, rows, n, w2,
                             black_border != 0, st);
  }
  return (int)launch<false>((const float*)f, nullptr, nullptr, (float*)out,
                            rows, n, w2, black_border != 0, st);
}

}  // extern "C"
