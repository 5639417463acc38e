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
// - K5. Each target takes one walk outward over its row, from m = f_i and
//   s = 1, steps k = 1, 2, ... on both sides, stopped exactly under the
//   row's floor minf once (minf + w2 k^2) - m > 30 t: no farther candidate
//   can lower m or come inside the cut, since m >= dmin. The sum s holds
//   the weights against the running min m: a candidate below m rescales s
//   by exp((c - m) / t) and adds its 1 (one exp each time m falls), one
//   inside the running cut, (f_j + w2 k^2) - m <= 30 t rounded as K6's
//   test, adds its weight, and the window's other candidates cost a load,
//   an add and a min, no exp. Every pair the function needs is inside the
//   running cut when the walk meets it. A weight is ex2.approx of
//   x log2(e) / t, the factor formed once; d_i = m - t ln2 lg2.approx(s).
//   The steps come in pairs, one stop test a pair, w2 k^2 from a table;
//   a pair with at most one candidate inside the cut takes it without a
//   branch (softmin_target). Two walks, the hard min first and then the
//   exps against it, were slower on the DistanceFieldNet step's passes
//   (PERF.md): each walks the same window. Rows up to kWarpMaxN = 2048
//   belong to one warp each, kWarpRows = 4 rows a block: the warp stages
//   its row between two pads of INF (n + 2 each side, so no step tests the
//   row's ends) beside its table (16 B a voxel in all), reduces minf with
//   shuffles, and takes the targets 32 at a time, lane l the target
//   i0 + l, so a warp's targets are neighbours with radii alike. Longer
//   rows belong to a block each, f alone in shared memory (4 B a voxel:
//   the axis ceiling), one step at a time with the ends tested. The sums
//   run in a fixed order with no atomics: the same bits from launch to
//   launch.
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
// The axis ceilings are the opt-in shared memory over 4 (K5, on rows a
// block holds) and over 8 (K6). Past them each kernel has a long-row mode
// (a second instantiation, below) that reads the row from device memory. Costs round twice,
// __fadd_rn(f, __fmul_rn(w2, __fmul_rn(k, k))), as in K1 and K2 (built
// with -fmad=false as well).
//
// Bound on the card: K5 reads f and writes d (8 B a voxel), K6 reads f, d
// and g and writes df and e (20 B a voxel). The work the function needs is
// one exp a pair inside the cut, so the special-function units bind where
// the cut holds many pairs and the bytes where it holds few. What holds K5
// is neither: its walk. Each target visits the candidates of its window,
// w2 k^2 <= m + 30 t - minf, a load, an add and a min each, and a warp runs
// as many steps as its slowest target; an untrained DistanceFieldNet's
// first pass holds about 36 candidates a window for one pair a voxel
// inside the cut. K6 pays one exp a pair inside the cut within its first
// kHeld steps and two further out (Z_i, then df), and its first pass walks
// the same long windows.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kWarpRows = 4;  // K5: rows a block on rows a warp holds
constexpr int kWarpMaxN = 2048;  // K5: the longest row a warp holds
constexpr int kLongChunk = 8192;  // K5, long rows: targets a block walks
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

__device__ __forceinline__ float quad(float w2, float kf) {
  return __fmul_rn(w2, __fmul_rn(kf, kf));
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLn2 = 0.6931471805599453f;

// One candidate at cost c of target i's walk. The sum s holds the weights
// exp((m - cost) / t) against the running min m: a candidate below m
// rescales s to its own cost and adds its 1, one inside the running cut
// (x = m - c >= -30 t, the same rounded test as K6's) adds its weight, any
// other adds nothing. Every candidate inside the final cut is inside the
// running one (m >= dmin), and a term taken against an m that later falls
// is rescaled with it.
__device__ __forceinline__ void soft_take(float c, float ncut, float scale,
                                          float& m, float& s) {
  const float x = __fsub_rn(m, c);
  if (x > 0.0f) {
    s = __fadd_rn(__fmul_rn(s, ex2(__fmul_rn(-x, scale))), 1.0f);
    m = c;
  } else if (x >= ncut) {
    s = __fadd_rn(s, ex2(__fmul_rn(x, scale)));
  }
}

// d = m - t log s; m where s == 0 (an all-INF window keeps INF).
__device__ __forceinline__ float soft_finish(float m, float s, float t) {
  return s > 0.0f ? __fsub_rn(m, __fmul_rn(__fmul_rn(t, kLn2), lg2(s))) : m;
}

// d of target i from its row p[0, n) (p[-k], p[k] readable, INF outside
// the row, for k <= kmax + 1) and the table q[k] = w2 k^2: one walk
// outward from m = f_i, s = 1, in pairs of steps (k, k + 1), until
// (minf + w2 k^2) - m > 30 t before a pair (exact: m >= dmin, and no
// farther candidate costs less than minf + w2 k^2). A pair whose second
// least cost lies outside the cut of min(m, its least) takes at most its
// least one, without a branch: one exp, weighted by whether it lowers m,
// lies inside the cut, or neither. A pair with two or more inside the cut
// takes its four one at a time (branch-free there too was slower where
// the cut holds several pairs a voxel). So a lane whose pair holds one
// candidate inside the cut, the common case on long windows, makes no
// other lane wait for its exps. The second step of a pair may lie past
// the stop or the row: its candidates are real, or INF, and change
// nothing they should not.
__device__ __forceinline__ float softmin_target(const float* p,
                                                const float* q, int kmax,
                                                float minf, float t,
                                                float ncut, float scale) {
  float m = p[0];
  float s = 1.0f;
  for (int k = 1; k <= kmax; k += 2) {
    const float q1 = q[k], q2 = q[k + 1];
    if (__fsub_rn(__fadd_rn(minf, q1), m) > -ncut) break;
    const float c1 = __fadd_rn(p[-k], q1), c2 = __fadd_rn(p[k], q1);
    const float c3 = __fadd_rn(p[-k - 1], q2), c4 = __fadd_rn(p[k + 1], q2);
    const float a = fminf(c1, c2), b = fminf(c3, c4);
    const float lo = fminf(a, b);
    const float lo2 = fminf(fmaxf(a, b), fminf(fmaxf(c1, c2), fmaxf(c3, c4)));
    const float mn = fminf(m, lo);
    if (__fsub_rn(mn, lo2) >= ncut) {
      soft_take(c1, ncut, scale, m, s);
      soft_take(c2, ncut, scale, m, s);
      soft_take(c3, ncut, scale, m, s);
      soft_take(c4, ncut, scale, m, s);
    } else {
      const float x = __fsub_rn(m, lo);
      const float e = ex2(__fmul_rn(fminf(x, -x), scale));
      s = x > 0.0f ? __fadd_rn(__fmul_rn(s, e), 1.0f)
                   : (x >= ncut ? __fadd_rn(s, e) : s);
      m = mn;
    }
  }
  return soft_finish(m, s, t);
}

// K5 on rows a warp holds (n <= kWarpMaxN): one warp a row, kWarpRows rows a
// block. The warp stages its row between two pads of INF (pad = n + 2 on
// each side) beside its table of w2 k^2 (16 B a voxel in all), reduces
// minf with shuffles, and takes the targets 32 at a time, lane l the
// target i0 + l.
__global__ void __launch_bounds__(32 * kWarpRows)
softmin_warp_kernel(const float* __restrict__ f, float* __restrict__ out,
                    long long rows, int n, float w2, float t) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: no block-wide barrier follows
  const int pad = n + 2;
  // each warp its own table q[k] = w2 k^2, k <= n, and its padded row
  float* s_q = smem + (size_t)(threadIdx.x >> 5) * (n + 2 + n + 2 * pad);
  float* s_f = s_q + n + 2 + pad;
  const size_t base = (size_t)row * (size_t)n;
  for (int k = lane; k < n + 2; k += 32) s_q[k] = quad(w2, (float)k);

  float minf = INFINITY;
  for (int j = lane; j < n; j += 32) {
    const float fj = f[base + j];
    s_f[j] = fj;
    minf = fminf(minf, fj);
  }
  for (int j = lane; j < pad; j += 32) {
    s_f[-1 - j] = INFINITY;
    s_f[n + j] = INFINITY;
  }
  for (int off = 16; off > 0; off >>= 1)
    minf = fminf(minf, __shfl_xor_sync(0xffffffffu, minf, off));
  __syncwarp();

  const float ncut = -__fmul_rn(kSoftCut, t);
  const float scale = __fdiv_rn(kLog2e, t);  // exponents in base 2
  for (int i = lane; i < n; i += 32) {
    out[base + i] = minf == INFINITY  // all-INF row: d stays INF
        ? INFINITY
        : softmin_target(s_f + i, s_q, max(i, n - 1 - i), minf, t, ncut,
                         scale);
  }
}

// K5 on longer rows: one block a row, f in shared memory (4 B a voxel: the
// axis ceiling), the same walks with the row's ends tested. Past the
// ceiling (any n; the wrapper may also ask for this mode on a shorter row),
// the second instantiation: a block for each kLongChunk targets of a row,
// grid (rows, chunks), each reducing its whole row's floor and walking its
// own chunk's targets over f in device memory (the row stays in L2).
template <bool kLong>
__global__ void __launch_bounds__(kMaxThreads)
softmin_block_kernel(const float* __restrict__ f, float* __restrict__ out,
                     int n, float w2, float t) {
  extern __shared__ float smem[];
  const size_t base = (size_t)blockIdx.x * (size_t)n;
  const float* s_f = kLong ? f + base : smem;
  const int lo = kLong ? (int)blockIdx.y * kLongChunk : 0;
  const int hi = kLong ? min(n, lo + kLongChunk) : n;

  float minf = INFINITY;
  float unused = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float fi = f[base + i];
    if constexpr (!kLong) smem[i] = fi;
    minf = fminf(minf, fi);
  }
  block_min_max(minf, unused);

  if (minf == INFINITY) {  // all-INF row: every cost is INF, d stays INF
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) out[base + i] = INFINITY;
    return;
  }
  const float ncut = -__fmul_rn(kSoftCut, t);
  const float scale = __fdiv_rn(kLog2e, t);
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int kmax = max(i, n - 1 - i);
    float m = s_f[i];
    float s = 1.0f;
    float kf = 1.0f;
    for (int k = 1; k <= kmax; ++k) {
      const float q = quad(w2, kf);
      if (__fsub_rn(__fadd_rn(minf, q), m) > -ncut) break;
      if (i - k >= 0) soft_take(__fadd_rn(s_f[i - k], q), ncut, scale, m, s);
      if (i + k < n) soft_take(__fadd_rn(s_f[i + k], q), ncut, scale, m, s);
      kf = __fadd_rn(kf, 1.0f);
    }
    out[base + i] = soft_finish(m, s, t);
  }
}

constexpr int kGradRows = 4;  // K6: rows a block, one warp each
constexpr int kHeld = 4;  // K6: steps whose weights a lane keeps for the scatter

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

// K6's second instantiation (kLong) takes rows past its ceiling (any n; the
// wrapper may also ask for it on a shorter row): f read from device memory
// (L2), df accumulated in the output row itself, which only this warp
// touches, zeroed first; __syncwarp orders the scatter's steps as in shared
// memory. The same sums in the same order: the same bits.
template <bool kLong>
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
  float* s_row = smem + (size_t)(threadIdx.x >> 5) * 2 * n;
  const float* s_f = kLong ? f + base : s_row;
  float* s_df = kLong ? df + base : s_row + n;

  float minf = INFINITY;
  for (int j = lane; j < n; j += 32) {
    const float fj = f[base + j];
    if constexpr (!kLong) s_row[j] = fj;
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
  if constexpr (!kLong)
    for (int j = lane; j < n; j += 32) df[base + j] = s_df[j];
}

int threads_for(int n) {
  const int threads = ((n + 31) / 32) * 32;
  return threads > kMaxThreads ? kMaxThreads : threads;
}

}  // namespace

extern "C" {

// f, out: (rows, n) f32, C-contiguous. long_rows: the mode for rows past
// the shared-memory ceiling (any n; also taken on request). Returns a
// cudaError_t.
int edt_softmin(const void* f, void* out, long long rows, int n, float w2,
                float t, int long_rows, void* stream) {
  if (long_rows) {
    const dim3 grid((unsigned)rows, (unsigned)((n + kLongChunk - 1) / kLongChunk));
    softmin_block_kernel<true><<<grid, kMaxThreads, 0, (cudaStream_t)stream>>>(
        (const float*)f, (float*)out, n, w2, t);
    return (int)cudaGetLastError();
  }
  if (n <= kWarpMaxN) {  // a warp a row, its row between two pads of INF
    const long long per_block = rows < kWarpRows ? rows : kWarpRows;
    const size_t smem = (size_t)per_block * (4 * (size_t)n + 6) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        softmin_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (rows + kWarpRows - 1) / kWarpRows;
    softmin_warp_kernel<<<(unsigned)blocks, 32 * kWarpRows, smem,
                          (cudaStream_t)stream>>>((const float*)f,
                                                  (float*)out, rows, n, w2, t);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      softmin_block_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  softmin_block_kernel<false><<<(unsigned)rows, threads_for(n), smem,
                                (cudaStream_t)stream>>>((const float*)f,
                                                        (float*)out, n, w2, t);
  return (int)cudaGetLastError();
}

// f, d, g, df, e: (rows, n) f32, C-contiguous. long_rows: the mode for
// rows past the shared-memory ceiling (any n; also taken on request).
// Returns a cudaError_t.
int edt_softmin_grad(const void* f, const void* d, const void* g, void* df,
                     void* e, long long rows, int n, float w2, float t,
                     int long_rows, void* stream) {
  if (long_rows) {  // kGradRows rows a block, nothing in shared memory
    const long long blocks = (rows + kGradRows - 1) / kGradRows;
    softmin_grad_kernel<true><<<(unsigned)blocks, 32 * kGradRows, 0,
                                (cudaStream_t)stream>>>(
        (const float*)f, (const float*)d, (const float*)g, (float*)df,
        (float*)e, rows, n, w2, t);
    return (int)cudaGetLastError();
  }
  // up to kGradRows rows a block, as many as the opt-in shared memory holds
  const size_t row_bytes = 2 * (size_t)n * sizeof(float);
  int per_block = (int)(232448 / row_bytes);
  if (per_block > kGradRows) per_block = kGradRows;
  if (per_block < 1) per_block = 1;
  const size_t smem = (size_t)per_block * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      softmin_grad_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + per_block - 1) / per_block;
  softmin_grad_kernel<false><<<(unsigned)blocks, 32 * per_block, smem,
                        (cudaStream_t)stream>>>(
      (const float*)f, (const float*)d, (const float*)g, (float*)df,
      (float*)e, rows, n, w2, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
