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
// (below): K5 a second instantiation that reads the row from device
// memory, K6 a row-split mode that spreads a row over a warp for each 256
// targets. Costs round twice,
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

// K6's second instantiation (kLong), the one-warp mode, takes the rows
// that the row-split mode below marks (only): f read from device memory
// (L2), df accumulated in the output row itself, which only this warp
// touches, zeroed first; __syncwarp orders the scatter's steps as in shared
// memory. The same sums in the same order: the same bits as the
// shared-memory mode.
template <bool kLong>
__global__ void __launch_bounds__(32 * kGradRows)
softmin_grad_kernel(const float* __restrict__ f, const float* __restrict__ d,
                    const float* __restrict__ g, float* __restrict__ df,
                    float* __restrict__ e, long long rows, int n, float w2,
                    float t, const int* __restrict__ only) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: no block-wide barrier follows
  if (kLong && !only[row]) return;
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

// K6's row-split mode, for rows past its ceiling (any n; the wrapper may
// also ask for it on a shorter row). Four launches:
//
// 1. row_min_kernel: the minimum of each kMinChunk voxels of f, a block
//    each; it also clears the row's mark.
// 2. softmin_grad_split_kernel: a warp for each tile of kTile6 targets of a
//    row, kSplitRows6 tiles a block. The warp reduces the row's minf from
//    the partials (the window rule w2 k^2 <= d_i + 30 t - minf needs the
//    row's, not the tile's), bounds the tile's windows by its largest
//    gap, and stages f over the tile and a halo of that reach, up to
//    kHalo6 a side, in shared memory beside a df accumulator over the same
//    span; f past the halo is read from device memory (L2). Then the
//    shared-memory mode's arithmetic on its own targets, 32 at a time: Z_i
//    and e_i over each window (e_i written out), then (g_i / Z_i) p_ij
//    scattered into the accumulator in ascending k, the j = i + k of the
//    32 lanes, then their j = i - k, with __syncwarp between. A warp whose
//    pairs reach past kHalo6 marks its row and stops. The tile's own
//    targets' df goes to the output; the halo on each side, as far as its
//    farthest pair (at most kHalo6 = kTile6, so only into the neighbouring
//    tiles), goes to a scratch buffer, with its width.
// 3. softmin_grad_combine_kernel: each tile adds to its df the halos of its
//    two neighbours that reach into it, the left one's, then the right
//    one's: a fixed order, no atomics, the same bits from launch to launch.
// 4. The one-warp mode on the marked rows (softmin_grad_kernel<true>); its
//    warps on other rows read the mark and return.
//
// e_i's sums are the shared-memory mode's; df_j sums its terms in another
// order (tile by tile, then the halos), so it matches that mode to f32
// round-off, not bit for bit.
constexpr int kSplitRows6 = 4;  // tiles a block, one warp each
constexpr int kTile6 = 256;  // targets a tile
constexpr int kHalo6 = 256;  // halo a side, at most kTile6
constexpr int kSpan6 = kTile6 + 2 * kHalo6;  // a warp's f and df spans
constexpr int kMinChunk = 1024;  // voxels a partial minimum
constexpr int kCombineRows = 8;  // tiles a combine block, one warp each

__global__ void __launch_bounds__(kMaxThreads)
row_min_kernel(const float* __restrict__ f, float* __restrict__ minp,
               int* __restrict__ marks, int n, int parts) {
  const long long row = blockIdx.x / parts;
  const int p = (int)(blockIdx.x % parts);
  const size_t base = (size_t)row * (size_t)n;
  const int hi = min(n, (p + 1) * kMinChunk);
  float lo = INFINITY, unused = -INFINITY;
  for (int i = p * kMinChunk + threadIdx.x; i < hi; i += blockDim.x)
    lo = fminf(lo, f[base + i]);
  block_min_max(lo, unused);
  if (threadIdx.x == 0) {
    minp[blockIdx.x] = lo;
    if (p == 0) marks[row] = 0;
  }
}

__global__ void __launch_bounds__(32 * kSplitRows6)
softmin_grad_split_kernel(const float* __restrict__ f,
                          const float* __restrict__ d,
                          const float* __restrict__ g, float* __restrict__ df,
                          float* __restrict__ e, int* __restrict__ marks,
                          int* __restrict__ halo_w, const float* __restrict__ minp,
                          float* __restrict__ halos, long long rows, int n,
                          int tiles, int parts, float w2, float t) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kSplitRows6 + (threadIdx.x >> 5);
  const long long row = w / tiles;
  if (row >= rows) return;  // a whole warp: no block-wide barrier follows
  const int a = (int)(w % tiles) * kTile6;
  const int b = min(n, a + kTile6);
  const size_t base = (size_t)row * (size_t)n;
  float* s_f = smem + (size_t)(threadIdx.x >> 5) * 2 * kSpan6;
  float* s_df = s_f + kSpan6;
  const int off = a - kHalo6;  // the spans' index of voxel j: j - off

  float minf = INFINITY;
  for (int p = lane; p < parts; p += 32) minf = fminf(minf, minp[row * parts + p]);
  for (int o = 16; o > 0; o >>= 1)
    minf = fminf(minf, __shfl_xor_sync(0xffffffffu, minf, o));
  const float cut = __fmul_rn(kSoftCut, t);
  const float ncut = -cut;
  const float scale = __fdiv_rn(kLog2e, t);  // exponents in base 2

  // the tile's reach: past every window's last step (NaN gaps take none)
  float gmax = -INFINITY;
  for (int i = a + lane; i < b; i += 32)
    gmax = fmaxf(gmax, __fsub_rn(__fadd_rn(d[base + i], cut), minf));
  for (int o = 16; o > 0; o >>= 1)
    gmax = fmaxf(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
  const float ratio = __fdiv_rn(gmax, w2);
  const int reach = !(ratio >= 0.0f) ? 0
                    : ratio >= __fmul_rn((float)n, (float)n) ? n
                    : (int)sqrtf(ratio) + 2;
  const int hw = min(reach, kHalo6);
  const int lo = max(0, a - hw), hi = min(n, b + hw);
  for (int j = lo + lane; j < hi; j += 32) s_f[j - off] = f[base + j];
  for (int j = a - hw + lane; j < b + hw; j += 32) s_df[j - off] = 0.0f;
  __syncwarp();
  // f_j: staged, or past the halo from device memory
  auto f_at = [&](int j) {
    return (j >= lo && j < hi) ? s_f[j - off] : __ldg(f + base + j);
  };

  int far = -1;  // the lane's farthest step with a pair inside the cut
  float d_next = a + lane < b ? d[base + a + lane] : 0.0f;
  float g_next = a + lane < b ? g[base + a + lane] : 0.0f;
  for (int i0 = a; i0 < b; i0 += 32) {
    const int i = i0 + lane;
    const float di = d_next, gi = g_next;
    if (i + 32 < b) {
      d_next = d[base + i + 32];
      g_next = g[base + i + 32];
    }
    const float gap = __fsub_rn(__fadd_rn(di, cut), minf);
    const int kcap = i < b ? max(i, n - 1 - i) : -1;

    float z = 0.0f, acc_e = 0.0f, kf = 0.0f;
    float held_r[kHeld], held_l[kHeld];  // (i, i + k), (i, i - k); 0: outside
    int steps = 0, kin = -1;
    bool go = true;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      const float kk = __fmul_rn(kf, kf);
      const float q = __fmul_rn(w2, kk);
      go = go && k <= kcap && q <= gap;
      held_l[k] = go && k > 0 && k <= i
                      ? take(di, f_at(i - k), q, kk, ncut, scale, z, acc_e) : 0.0f;
      held_r[k] = go && k == 0 ? take(di, f_at(i), q, kk, ncut, scale, z, acc_e)
                  : go && i + k < n
                      ? take(di, f_at(i + k), q, kk, ncut, scale, z, acc_e) : 0.0f;
      if (held_l[k] > 0.0f || held_r[k] > 0.0f) kin = k;
      if (go) steps = k + 1;
      kf = __fadd_rn(kf, 1.0f);
    }
    for (; go && steps <= kcap; ++steps) {
      const float kk = __fmul_rn(kf, kf);
      const float q = __fmul_rn(w2, kk);
      if (!(q <= gap)) break;
      if (steps <= i && take(di, f_at(i - steps), q, kk, ncut, scale, z, acc_e) > 0.0f)
        kin = steps;
      if (i + steps < n && take(di, f_at(i + steps), q, kk, ncut, scale, z, acc_e) > 0.0f)
        kin = steps;
      kf = __fadd_rn(kf, 1.0f);
    }
    float gz = 0.0f;
    if (z > 0.0f) {
      const float rz = __frcp_rn(z);
      gz = __fmul_rn(gi, rz);
      acc_e = __fmul_rn(acc_e, rz);
    }
    if (i < b) e[base + i] = acc_e;

    const int warp_steps = __reduce_max_sync(0xffffffffu, kin + 1);
    if (warp_steps - 1 > hw) {  // a pair past the halo: the one-warp mode
      if (lane == 0) marks[row] = 1;
      return;
    }
    far = max(far, kin);
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (k >= warp_steps) break;
      if (held_r[k] > 0.0f) s_df[i + k - off] = __fmaf_rn(gz, held_r[k], s_df[i + k - off]);
      __syncwarp();
      if (held_l[k] > 0.0f) s_df[i - k - off] = __fmaf_rn(gz, held_l[k], s_df[i - k - off]);
      __syncwarp();
    }
    kf = (float)kHeld;
    for (int k = kHeld; k < warp_steps; ++k) {
      const float q = __fmul_rn(w2, __fmul_rn(kf, kf));
      const bool on = k <= kin;
      if (on && i + k < n) {
        const float x = __fsub_rn(di, __fadd_rn(s_f[i + k - off], q));
        if (x >= ncut)
          s_df[i + k - off] = __fmaf_rn(gz, ex2(__fmul_rn(x, scale)), s_df[i + k - off]);
      }
      __syncwarp();
      if (on && k <= i) {
        const float x = __fsub_rn(di, __fadd_rn(s_f[i - k - off], q));
        if (x >= ncut)
          s_df[i - k - off] = __fmaf_rn(gz, ex2(__fmul_rn(x, scale)), s_df[i - k - off]);
      }
      __syncwarp();
      kf = __fadd_rn(kf, 1.0f);
    }
  }
  __syncwarp();
  // the tile's own df out; each halo, as far as the farthest pair, to the
  // scratch (left: the span's first kHalo6 places, right: the next kHalo6)
  const int h = max(0, __reduce_max_sync(0xffffffffu, far));
  for (int j = a + lane; j < b; j += 32) df[base + j] = s_df[j - off];
  float* halo = halos + (size_t)w * 2 * kHalo6;
  for (int m = lane; m < h; m += 32) {
    if (a - 1 - m >= 0) halo[kHalo6 - 1 - m] = s_df[kHalo6 - 1 - m];
    if (b + m < n) halo[kHalo6 + m] = s_df[b + m - off];
  }
  if (lane == 0) halo_w[w] = h;
}

__global__ void __launch_bounds__(32 * kCombineRows)
softmin_grad_combine_kernel(float* __restrict__ df, const int* __restrict__ marks,
                            const int* __restrict__ halo_w,
                            const float* __restrict__ halos, long long rows,
                            int n, int tiles) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kCombineRows + (threadIdx.x >> 5);
  const long long row = w / tiles;
  if (row >= rows || marks[row]) return;
  const int tile = (int)(w % tiles);
  const int a = tile * kTile6;
  const int b = min(n, a + kTile6);
  float* out = df + (size_t)row * (size_t)n;
  // the left tile's right halo reaches [a, a + hl), the right tile's left
  // halo [b - hr, b)
  const int hl = tile > 0 ? min(halo_w[w - 1], b - a) : 0;
  const int hr = tile + 1 < tiles ? min(halo_w[w + 1], b - a) : 0;
  const float* left = hl ? halos + (size_t)(w - 1) * 2 * kHalo6 + kHalo6 : nullptr;
  const float* right = hr ? halos + (size_t)(w + 1) * 2 * kHalo6 : nullptr;
  for (int j = a + lane; j < a + hl; j += 32) {
    float v = __fadd_rn(out[j], left[j - a]);
    if (j >= b - hr) v = __fadd_rn(v, right[kHalo6 - (b - j)]);
    out[j] = v;
  }
  for (int j = max(a + hl, b - hr) + lane; j < b; j += 32)
    out[j] = __fadd_rn(out[j], right[kHalo6 - (b - j)]);
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

// Words (4 B) of the row-split mode's scratch for rows of n.
long long edt_softmin_grad_work_words(long long rows, int n) {
  const long long tiles = (n + kTile6 - 1) / kTile6;
  const long long parts = (n + kMinChunk - 1) / kMinChunk;
  return rows * (tiles + parts + tiles * 2 * kHalo6);
}

// f, d, g, df, e: (rows, n) f32, C-contiguous. marks: null for the
// shared-memory mode; else (rows,) int32, which select the long-row mode
// (any n: the row-split mode, then the one-warp mode on the rows it marks)
// and come back 1 where a row took the one-warp mode, with work
// edt_softmin_grad_work_words(rows, n) words of scratch. Returns a
// cudaError_t.
int edt_softmin_grad(const void* f, const void* d, const void* g, void* df,
                     void* e, long long rows, int n, float w2, float t,
                     void* marks_, void* work, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (marks_) {
    const int tiles = (n + kTile6 - 1) / kTile6;
    const int parts = (n + kMinChunk - 1) / kMinChunk;
    int* marks = (int*)marks_;
    int* halo_w = (int*)work;
    float* minp = (float*)(halo_w + rows * tiles);
    float* halos = minp + rows * parts;
    row_min_kernel<<<(unsigned)(rows * parts), kMaxThreads, 0, st>>>(
        (const float*)f, minp, marks, n, parts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)kSplitRows6 * 2 * kSpan6 * sizeof(float);
    softmin_grad_split_kernel<<<(unsigned)((rows * tiles + kSplitRows6 - 1) / kSplitRows6),
                                32 * kSplitRows6, smem, st>>>(
        (const float*)f, (const float*)d, (const float*)g, (float*)df,
        (float*)e, marks, halo_w, minp, halos, rows, n, tiles, parts, w2, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    softmin_grad_combine_kernel<<<(unsigned)((rows * tiles + kCombineRows - 1) / kCombineRows),
                                  32 * kCombineRows, 0, st>>>(
        (float*)df, marks, halo_w, halos, rows, n, tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    softmin_grad_kernel<true><<<(unsigned)((rows + kGradRows - 1) / kGradRows),
                                32 * kGradRows, 0, st>>>(
        (const float*)f, (const float*)d, (const float*)g, (float*)df,
        (float*)e, rows, n, w2, t, marks);
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
  softmin_grad_kernel<false><<<(unsigned)blocks, 32 * per_block, smem, st>>>(
      (const float*)f, (const float*)d, (const float*)g, (float*)df,
      (float*)e, rows, n, w2, t, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
