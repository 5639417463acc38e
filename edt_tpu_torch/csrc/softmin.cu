// K5 and K6: the softmin-plus pass of the differentiable EDT at temperature
// t > 0 and its backward, for Hopper (sm_90a).
//
// K5, the softmin. Replaces edt_tpu/ops/pallas_kernels.py:softmin_pallas
// (_softmin_rowsweep_kernel and _softmin_kernel). For each row r of f (R, n):
//
//   d[r, i] = -t log sum_j exp(-(f[r, j] + w2 (i - j)^2) / t)
//
// computed the TPU's way: the hard min dmin_i = min_j cost_ij first, then
// s_i = sum_j exp((dmin_i - cost_ij) / t) and d_i = dmin_i - t log(s_i),
// keeping dmin_i where s_i == 0 (all-INF rows stay INF). Terms with
// cost_ij - dmin_i > SOFT_CUT t (SOFT_CUT = 30) are dropped: s_i >= 1, so
// each is below exp(-30) of it, under f32 resolution.
//
// K6, the softmin gradient. Replaces edt_tpu/ops/pallas_kernels.py:
// softmin_grad_pallas (_softmin_grad_rowsweep_kernel, _softmin_grad_kernel,
// _softmin_grad_tiled_body). With p_ij = exp((d_i - cost_ij) / t) / Z_i,
// Z_i = sum_j exp((d_i - cost_ij) / t), the softmax weights of K5's
// output d:
//
//   df[r, j] = sum_i g[r, i] p_ij        e[r, i] = sum_j p_ij (i - j)^2
//
// (sum_i g_i e_i is the gradient w.r.t. w2). Z_i is 1 in exact arithmetic,
// and the TPU kernel takes it as 1. Here it is summed: d carries its f32
// round-off, and exp((d_i - cost) / t) turns that into a relative error of
// ulp(d_i) / t in every weight of target i, 0.16 % at d = 4096, t = 0.3.
// Dividing by Z_i cancels it, so the weights depend on d only through the
// cut: the same weights whatever computed d, K5 or the plain logsumexp.
//
// Design (first version: right and simple). One block per row, 256 threads
// at most; each thread owns the positions tid, tid + blockDim, ...
//
// - K5 stages f in dynamic shared memory (4 B a voxel) and reduces the
//   row's floor minf. Each target scans outward from k = 0 for the hard
//   min and stops at the first k with w2 k^2 > dmin_i - minf (no farther
//   candidate can go below dmin_i: cost >= minf + w2 k^2). It then sums the
//   exps outward while w2 k^2 <= dmin_i + 30 t - minf: a per-target radius,
//   the TPU's per-tile radius (_softmin_kernel's gap_s) taken one target at
//   a time. Every term it leaves out has cost - dmin > 30 t, so the result
//   is the TPU's to f32 round-off.
// - K6 stages f, d and g (12 B a voxel) and reduces minf and maxd = max_i
//   d_i. First, as a target i, a thread gathers Z_i and e_i over the
//   sources j with w2 k^2 <= d_i + 30 t - minf, and replaces g_i in shared
//   memory by g_i / Z_i. After a barrier, as a source j, it gathers df_j
//   over the targets i with w2 k^2 <= maxd + 30 t - f_j. Both are gathers,
//   with no atomics: the result is the same from run to run. Every term
//   left out has a weight below exp(-30). The weight's exponent is formed
//   as (d_i - (f_j + w2 k^2)) / t, the rounding order of the plain
//   version.
//
// The axis ceilings are the opt-in shared memory over 4 (K5) and over 12
// (K6). Costs round twice, __fadd_rn(f, __fmul_rn(w2, __fmul_rn(k, k))), as
// in K1 and K2 (built with -fmad=false as well); exps and logs are the
// accurate expf and logf.
//
// Bound on the card: K5 reads f and writes d (8 B a voxel), K6 reads f, d
// and g and writes df and e (20 B a voxel). The work is one exp a term
// inside the cut (plus, for K5, the hard-min candidates), so the
// special-function units bind where the radii are long and the bytes where
// they are short. This version does nothing yet to reach either bound: one
// row per block leaves loads uncoalesced across rows, threads of a warp wait
// for the longest radius among them, and K6 pays two exps a pair.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr float kSoftCut = 30.0f;

// Block-wide min of lo and max of hi, returned to every thread. Also a
// barrier: shared memory written before the call is visible after it.
__device__ __forceinline__ void block_min_max(float& lo, float& hi) {
  __shared__ float s_lo[kMaxThreads / 32];
  __shared__ float s_hi[kMaxThreads / 32];
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = s_lo[0];
  hi = s_hi[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
    lo = fminf(lo, s_lo[k]);
    hi = fmaxf(hi, s_hi[k]);
  }
}

__device__ __forceinline__ float quad(float w2, int k) {
  const float kf = (float)k;
  return __fmul_rn(w2, __fmul_rn(kf, kf));
}

__global__ void __launch_bounds__(kMaxThreads)
softmin_kernel(const float* __restrict__ f, float* __restrict__ out, int n,
               float w2, float t) {
  extern __shared__ float s_f[];
  const size_t base = (size_t)blockIdx.x * (size_t)n;

  float minf = INFINITY;
  float unused = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float fi = f[base + i];
    s_f[i] = fi;
    minf = fminf(minf, fi);
  }
  block_min_max(minf, unused);

  if (minf == INFINITY) {  // all-INF row: every cost is INF, d stays INF
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + i] = INFINITY;
    return;
  }
  const float invt = __fdiv_rn(1.0f, t);
  const float cut = __fmul_rn(kSoftCut, t);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int kmax = max(i, n - 1 - i);
    // phase A: the hard min, outward until no candidate can go below it
    float dmin = s_f[i];
    for (int k = 1; k <= kmax; ++k) {
      const float q = quad(w2, k);
      if (q > __fsub_rn(dmin, minf)) break;
      if (i - k >= 0) dmin = fminf(dmin, __fadd_rn(s_f[i - k], q));
      if (i + k < n) dmin = fminf(dmin, __fadd_rn(s_f[i + k], q));
    }
    // phase B: the shifted exps inside the cut
    const float gap = __fsub_rn(__fadd_rn(dmin, cut), minf);
    float s = expf(__fmul_rn(__fsub_rn(dmin, s_f[i]), invt));
    for (int k = 1; k <= kmax; ++k) {
      const float q = quad(w2, k);
      if (q > gap) break;
      if (i - k >= 0)
        s = __fadd_rn(s, expf(__fmul_rn(
                             __fsub_rn(dmin, __fadd_rn(s_f[i - k], q)), invt)));
      if (i + k < n)
        s = __fadd_rn(s, expf(__fmul_rn(
                             __fsub_rn(dmin, __fadd_rn(s_f[i + k], q)), invt)));
    }
    out[base + i] = s > 0.0f ? __fsub_rn(dmin, __fmul_rn(t, logf(s))) : dmin;
  }
}

// The weight p of a target at d and a candidate at cost c.
__device__ __forceinline__ float weight(float d, float c, float t) {
  return expf(__fdiv_rn(__fsub_rn(d, c), t));
}

__global__ void __launch_bounds__(kMaxThreads)
softmin_grad_kernel(const float* __restrict__ f, const float* __restrict__ d,
                    const float* __restrict__ g, float* __restrict__ df,
                    float* __restrict__ e, int n, float w2, float t) {
  extern __shared__ float smem[];
  float* s_f = smem;
  float* s_d = smem + n;
  float* s_g = smem + 2 * n;
  const size_t base = (size_t)blockIdx.x * (size_t)n;

  float minf = INFINITY;
  float maxd = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float fi = f[base + i];
    const float di = d[base + i];
    s_f[i] = fi;
    s_d[i] = di;
    s_g[i] = g[base + i];
    minf = fminf(minf, fi);
    maxd = fmaxf(maxd, di);
  }
  block_min_max(minf, maxd);

  const float cut = __fmul_rn(kSoftCut, t);
  // Z_i and e_i: x is the target i. A NaN gap (an all-INF row) takes no
  // term, and then g_i / Z_i reads as 0.
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int kmax = max(x, n - 1 - x);
    const float di = s_d[x];
    const float gap_i = __fsub_rn(__fadd_rn(di, cut), minf);
    float z = 0.0f;
    float acc_e = 0.0f;
    for (int k = 0; k <= kmax; ++k) {
      const float q = quad(w2, k);
      if (!(q <= gap_i)) break;
      const float kk = (float)k * (float)k;
      if (x - k >= 0) {
        const float p = weight(di, __fadd_rn(s_f[x - k], q), t);
        z += p;
        acc_e += p * kk;
      }
      if (k > 0 && x + k < n) {
        const float p = weight(di, __fadd_rn(s_f[x + k], q), t);
        z += p;
        acc_e += p * kk;
      }
    }
    e[base + x] = z > 0.0f ? acc_e / z : 0.0f;
    s_g[x] = z > 0.0f ? s_g[x] / z : 0.0f;  // only this thread reads s_g[x] here
  }
  __syncthreads();

  // df: x is the source j. -INF (f_j INF) or NaN takes no term.
  const float top = __fadd_rn(maxd, cut);
  for (int x = threadIdx.x; x < n; x += blockDim.x) {
    const int kmax = max(x, n - 1 - x);
    const float fj = s_f[x];
    const float gap_j = __fsub_rn(top, fj);
    float acc = 0.0f;
    for (int k = 0; k <= kmax; ++k) {
      const float q = quad(w2, k);
      if (!(q <= gap_j)) break;
      const float c = __fadd_rn(fj, q);
      if (x - k >= 0) acc += s_g[x - k] * weight(s_d[x - k], c, t);
      if (k > 0 && x + k < n) acc += s_g[x + k] * weight(s_d[x + k], c, t);
    }
    df[base + x] = acc;
  }
}

int threads_for(int n) {
  const int threads = ((n + 31) / 32) * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

}  // namespace

extern "C" {

// f, out: (rows, n) f32, C-contiguous. Returns a cudaError_t.
int edt_softmin(const void* f, void* out, long long rows, int n, float w2,
                float t, void* stream) {
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      softmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  softmin_kernel<<<(unsigned)rows, threads_for(n), smem,
                   (cudaStream_t)stream>>>((const float*)f, (float*)out, n,
                                           w2, t);
  return (int)cudaGetLastError();
}

// f, d, g, df, e: (rows, n) f32, C-contiguous. Returns a cudaError_t.
int edt_softmin_grad(const void* f, const void* d, const void* g, void* df,
                     void* e, long long rows, int n, float w2, float t,
                     void* stream) {
  const size_t smem = 3 * (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      softmin_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  softmin_grad_kernel<<<(unsigned)rows, threads_for(n), smem,
                        (cudaStream_t)stream>>>(
      (const float*)f, (const float*)d, (const float*)g, (float*)df,
      (float*)e, n, w2, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
