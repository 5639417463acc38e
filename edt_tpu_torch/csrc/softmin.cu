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
// Design.
//
// - K5 (first version: right and simple). One block per row, 256 threads
//   at most; each thread owns the positions tid, tid + blockDim, ... It
//   stages f in dynamic shared memory (4 B a voxel) and reduces the row's
//   floor minf. Each target scans outward from k = 0 for the hard min and
//   stops at the first k with w2 k^2 > dmin_i - minf (no farther candidate
//   can go below dmin_i: cost >= minf + w2 k^2). It then sums the exps
//   outward while w2 k^2 <= dmin_i + 30 t - minf: a per-target radius, the
//   TPU's per-tile radius (_softmin_kernel's gap_s) taken one target at a
//   time. Every term it leaves out has cost - dmin > 30 t, so the result is
//   the TPU's to f32 round-off. Exps and logs are the accurate expf and
//   logf.
// - K6. One warp a row, four rows a block. The warp stages the row's f in
//   shared memory beside a df accumulator of the row (8 B a voxel: the axis
//   ceiling is the opt-in shared memory over 8), reduces minf with shuffles,
//   and takes the targets 32 at a time, lane l the target i = i0 + l, its
//   d_i and g_i in registers (the next 32 loaded ahead). Each target has
//   its own window, the k with w2 k^2 <= d_i + 30 t - minf, and in it the
//   pairs with x = d_i - cost_ij >= -30 t: the pairs that carry a weight
//   above exp(-30); the row's largest d plays no part. First the lane walks
//   the window and sums Z_i and e_i over those pairs, keeping the weights
//   of its first kHeld = 4 steps in registers and noting the last step kin
//   that holds a pair. Then, Z_i complete, it scatters (g_i / Z_i) p_ij
//   into the accumulator at every j of the same pairs, one k at a time for
//   the warp up to the largest kin of its lanes: the j = i + k of all 32
//   lanes (distinct), then the j = i - k (distinct), with __syncwarp
//   between, so every df_j sums its terms in one fixed order, with no
//   atomics, and df is the same from launch to launch. The held weights
//   are scattered as they are; a pair further out is formed again, the
//   same way, and tested against the cut again, so the weights summed
//   into Z_i are the ones scattered. A weight takes no division:
//   ex2.approx of x * log2(e) / t, the factor formed once; Z_i takes one
//   reciprocal a target.
//
// The axis ceilings are the opt-in shared memory over 4 (K5) and over 8
// (K6). Costs round twice, __fadd_rn(f, __fmul_rn(w2, __fmul_rn(k, k))), as
// in K1 and K2 (built with -fmad=false as well).
//
// Bound on the card: K5 reads f and writes d (8 B a voxel), K6 reads f, d
// and g and writes df and e (20 B a voxel). The work is one exp a term
// inside the cut (plus, for K5, the hard-min candidates), so the
// special-function units bind where the cut holds many terms and the bytes
// where it holds few. K5 does nothing yet to reach either bound: one row per
// block leaves loads uncoalesced across rows, and threads of a warp wait for
// the longest radius among them. K6 pays one exp a pair inside the cut
// within its first kHeld steps and two further out (Z_i, then df), and its
// first pass walks the whole window: a candidate between minf and the cut
// costs a load and a compare. Long windows over few pairs (an untrained
// DistanceFieldNet's first pass: 36 candidates for one pair a voxel) are
// what is left of its time.

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

constexpr int kGradRows = 4;  // K6: rows a block, one warp each
constexpr int kHeld = 4;  // K6: steps whose weights a lane keeps for the scatter
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The weight of target i's pair at cost fj + q, or 0 outside the cut
// (x = d_i - cost < -30 t); a weight is summed into z and acc_e.
__device__ __forceinline__ float take(float di, float fj, float q, float kk,
                                      float ncut, float scale, float& z,
                                      float& acc_e) {
  const float x = __fsub_rn(di, __fadd_rn(fj, q));
  if (!(x >= ncut)) return 0.0f;
  const float p = ex2(__fmul_rn(x, scale));
  z = __fadd_rn(z, p);
  acc_e = __fmaf_rn(p, kk, acc_e);
  return p;
}

__global__ void __launch_bounds__(32 * kGradRows)
softmin_grad_kernel(const float* __restrict__ f, const float* __restrict__ d,
                    const float* __restrict__ g, float* __restrict__ df,
                    float* __restrict__ e, long long rows, int n, float w2,
                    float t) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: no block-wide barrier follows
  const size_t base = (size_t)row * (size_t)n;
  float* s_f = smem + (size_t)(threadIdx.x >> 5) * 2 * n;
  float* s_df = s_f + n;

  float minf = INFINITY;
  for (int j = lane; j < n; j += 32) {
    const float fj = f[base + j];
    s_f[j] = fj;
    s_df[j] = 0.0f;
    minf = fminf(minf, fj);
  }
  for (int off = 16; off > 0; off >>= 1)
    minf = fminf(minf, __shfl_xor_sync(0xffffffffu, minf, off));
  __syncwarp();

  const float cut = __fmul_rn(kSoftCut, t);
  const float ncut = -cut;
  const float scale = __fdiv_rn(kLog2e, t);  // exponents in base 2
  float d_next = lane < n ? d[base + lane] : 0.0f;
  float g_next = lane < n ? g[base + lane] : 0.0f;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    const float di = d_next, gi = g_next;
    if (i + 32 < n) {
      d_next = d[base + i + 32];
      g_next = g[base + i + 32];
    }
    // the target's window: w2 k^2 <= d_i + 30 t - minf. A NaN gap (an
    // all-INF row) takes no step, and then Z_i = 0 gives e_i = g_i / Z_i = 0.
    const float gap = __fsub_rn(__fadd_rn(di, cut), minf);
    const int kcap = i < n ? max(i, n - 1 - i) : -1;

    // Z_i and e_i over the pairs of the window inside the cut; the weights
    // of the first kHeld steps stay in registers, and kin is the last step
    // with a pair inside the cut
    float z = 0.0f, acc_e = 0.0f, kf = 0.0f;
    float held_r[kHeld], held_l[kHeld];  // (i, i + k), (i, i - k); 0: outside
    int steps = 0, kin = -1;
    bool go = true;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const float kk = __fmul_rn(kf, kf);
      const float q = __fmul_rn(w2, kk);
      go = go && k <= kcap && q <= gap;
      // the centre (k = 0) counts as the right side
      held_l[k] = go && k > 0 && k <= i
                      ? take(di, s_f[i - k], q, kk, ncut, scale, z, acc_e) : 0.0f;
      held_r[k] = go && k == 0 ? take(di, s_f[i], q, kk, ncut, scale, z, acc_e)
                  : go && i + k < n
                      ? take(di, s_f[i + k], q, kk, ncut, scale, z, acc_e) : 0.0f;
      if (held_l[k] > 0.0f || held_r[k] > 0.0f) kin = k;
      if (go) steps = k + 1;
      kf = __fadd_rn(kf, 1.0f);
    }
    for (; go && steps <= kcap; ++steps) {
      const float kk = __fmul_rn(kf, kf);
      const float q = __fmul_rn(w2, kk);
      if (!(q <= gap)) break;
      if (steps <= i && take(di, s_f[i - steps], q, kk, ncut, scale, z, acc_e) > 0.0f)
        kin = steps;
      if (i + steps < n && take(di, s_f[i + steps], q, kk, ncut, scale, z, acc_e) > 0.0f)
        kin = steps;
      kf = __fadd_rn(kf, 1.0f);
    }
    float gz = 0.0f;
    if (z > 0.0f) {
      const float rz = __frcp_rn(z);
      gz = __fmul_rn(gi, rz);
      acc_e = __fmul_rn(acc_e, rz);
    }
    if (i < n) e[base + i] = acc_e;

    // df: the same pairs scattered up to the warp's last step inside the
    // cut, in ascending k, the j = i + k of the 32 lanes (distinct), then
    // their j = i - k (distinct); held weights first, then recomputed
    const int warp_steps = __reduce_max_sync(0xffffffffu, kin + 1);
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (k >= warp_steps) break;
      if (held_r[k] > 0.0f) s_df[i + k] = __fmaf_rn(gz, held_r[k], s_df[i + k]);
      __syncwarp();
      if (held_l[k] > 0.0f) s_df[i - k] = __fmaf_rn(gz, held_l[k], s_df[i - k]);
      __syncwarp();
    }
    kf = (float)kHeld;
    for (int k = kHeld; k < warp_steps; ++k) {
      const float q = __fmul_rn(w2, __fmul_rn(kf, kf));
      const bool on = k <= kin;
      if (on && i + k < n) {
        const float x = __fsub_rn(di, __fadd_rn(s_f[i + k], q));
        if (x >= ncut) s_df[i + k] = __fmaf_rn(gz, ex2(__fmul_rn(x, scale)), s_df[i + k]);
      }
      __syncwarp();
      if (on && k <= i) {
        const float x = __fsub_rn(di, __fadd_rn(s_f[i - k], q));
        if (x >= ncut) s_df[i - k] = __fmaf_rn(gz, ex2(__fmul_rn(x, scale)), s_df[i - k]);
      }
      __syncwarp();
      kf = __fadd_rn(kf, 1.0f);
    }
  }
  __syncwarp();
  for (int j = lane; j < n; j += 32) df[base + j] = s_df[j];
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
  // up to kGradRows rows a block, as many as the opt-in shared memory holds
  const size_t row_bytes = 2 * (size_t)n * sizeof(float);
  int per_block = (int)(232448 / row_bytes);
  if (per_block > kGradRows) per_block = kGradRows;
  if (per_block < 1) per_block = 1;
  const size_t smem = (size_t)per_block * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      softmin_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + per_block - 1) / per_block;
  softmin_grad_kernel<<<(unsigned)blocks, 32 * per_block, smem,
                        (cudaStream_t)stream>>>(
      (const float*)f, (const float*)d, (const float*)g, (float*)df,
      (float*)e, rows, n, w2, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
