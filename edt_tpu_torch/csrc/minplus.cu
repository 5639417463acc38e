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
// Design. A row belongs to a group of G threads, G a multiple of 32 chosen
// by the host so that each thread holds at most kRegTargets = 16 targets
// (G = 32 for rows up to 512: one warp a row, two rows a block; up to 256
// threads for rows up to 4096). On binary rows, and on masked rows past
// kSegAxis, thread t of the group owns the targets i = t, t + G, ...; on
// masked rows up to kSegAxis (the kSeg instantiation) warp w of the group
// owns a span of C = ceil(n / 32 / (G / 32)) contiguous 32-voxel chunks
// from chunk w C, lane l the voxels span0 + l, span0 + 32 + l, .... Either
// way every global access is coalesced, and a thread issues the loads of
// eight of its targets before it uses any of them. The row's f is staged
// in dynamic shared memory (4 B a voxel: the axis ceiling is the opt-in
// shared memory over 4). ss and se are read once, in the staging loop, and
// kept as the target's reach into its segment, kl = i - ss and kr = se - 1
// - i, packed in one register (16 bits each); its wall is formed from them
// (binary rows are one segment, ss = 0, se = n). Targets beyond the
// sixteenth of a thread (rows longer than 4096) park the packed reach in
// their own slot of d, which the thread overwrites with the result. A
// group reduces the row's floor minf and bound = max_i min(f_i, wall_i) with
// warp shuffles and, for groups of several warps, one exchange through
// shared memory in which every thread reads all of its row's parts: no
// thread finishes the reduction alone. Every thread then forms the row
// radius r exactly as _radius_gap and _radius_from_gap do: it caps every
// search, so no row scans more than the first version did, and an all-INF
// row keeps radius 0.
//
// The floor of a target's stops is its segment's min f on masked rows up
// to kSegAxis = (232448 - 256) / 8 = 29024 voxels, and the row's min f on
// binary rows (one segment) and on longer masked rows. In a row holding
// label 0 anywhere the row's floor is 0, and each target walks about
// sqrt(min(f_i, wall_i) / w2) steps; under its segment's floor, none where
// the segment's heights are flat. kSeg finds the floors while it stages:
// in each chunk of its span, in order, a warp reduces each segment's lanes
// with one redux.sync and carries the running min of a segment that began
// in an earlier chunk (a shuffle of lane 31's value), keeping each voxel's
// running min in s_lb beside f (8 B a voxel in all, hence kSegAxis). A
// piece of a segment inside the span has its min at its last voxel. Before
// the group's barrier each warp publishes its first and last pieces' mins
// and whether its first voxel's segment began before the span and covers
// it; after it, each warp chains those across the spans its first and
// last segments reach into, once a warp. No atomics and no second
// barrier: min ignores order, so the floor, and with it d, is the same
// bits on every launch. Masked rows from 29025 to 58048 (f and the running
// minima would not fit) keep the row's floor in the other instantiation,
// and so do binary rows; each instantiation carries only its own mode's
// code (code a row never runs costs it through registers and the
// instruction cache).
//
// Each target searches outward inside its segment, k = 0, 1, ...,
// min(r, max(kl, kr)), with q_k = __fmul_rn(w2, __fmul_rn(k, k)) formed
// once a step for both candidates j = i - k (k <= kl) and j = i + k
// (k <= kr), and stops before step k once __fadd_rn(lb, q_k) >
// min(best, wall_i), lb the floor (the segment's min f, or the row's):
// rounding is monotone and f_j >= lb, so every candidate left costs more
// than what the target already holds. min ignores order, so no tie rule
// is needed, and the value is the first version's scan over the same
// window, bit for bit. A target takes about sqrt((min(f_i, wall_i) - lb) /
// w2) steps instead of r: none where its segment's heights are flat.
//
// Long rows (past the shared-memory ceiling, any n; the wrapper may also
// ask for this mode on a shorter row) take the same kernel's second
// instantiation: a block of 256 threads for each kLongChunk targets of a
// row, grid (rows, chunks). Every block reads its whole row from device
// memory for the floor minf and the bound (the row stays in L2: a
// 65536-voxel row is 256 KiB), then searches its own chunk's targets with
// the row's floor, f read from device memory, the reach read again from ss
// and se in full ints (no 16-bit packing, so no limit on n). The values
// are those of the short-row mode's parked targets, bit for bit. (Folding
// each segment's min into shared slots in the same whole-row loop was
// measured slower on the long rows' cells and is not done.)
//
// Exactness: every cost is __fadd_rn(f_j, __fmul_rn(w2, __fmul_rn(k, k)))
// with k a float, two roundings as in the reference (built with -fmad=false
// as well), and the radius uses IEEE division and sqrt.
//
// Bound on the card: HBM bytes. f, ss and se are read once and d written
// once: 16 B a voxel (binary: 8 B). A search step costs about twenty
// instructions for two candidates, and a warp runs until the slowest of its
// 32 adjacent targets stops. Where segments hold flat heights (the 512^3
// bench volume and bench.py's volume at 768^3 under the segment floor)
// the searches take almost no step; what remains over the bound is each
// target's fixed work (its reach and wall, its segment's min, the search's
// set-up) and the latency of its loads, in a share not measured.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kRegTargets = 16;  // targets a thread keeps in registers
constexpr int kLongChunk = 8192;  // long rows: targets a block searches
// masked rows up to this length keep their pieces' floors beside f: an
// H100 block's opt-in shared memory, less the static bytes, over 8 B a voxel
constexpr int kSegAxis = (232448 - 256) / 8;

__device__ __forceinline__ float sq_wall(float w2, int k) {
  const float kf = (float)k;
  return __fmul_rn(w2, __fmul_rn(kf, kf));
}

// The wall of target i from its reach kl = i - ss, kr = se - 1 - i: the
// segment walls w2 (kl + 1)^2 and w2 (kr + 1)^2, an open row end INF
// unless black_border. Binary rows (ss = 0, se = n) get the border
// parabolas with black_border, INF without.
__device__ __forceinline__ float wall_of(int i, int kl, int kr, int n,
                                         float w2, bool black_border) {
  const float lw = (black_border || kl < i) ? sq_wall(w2, kl + 1) : INFINITY;
  const float rw = (black_border || kr < n - 1 - i) ? sq_wall(w2, kr + 1)
                                                    : INFINITY;
  return fminf(lw, rw);
}

// min(wall, min_j f_j + w2 (i - j)^2 over i - kl <= j <= i + kr) by the
// outward search, stopped exactly; lb <= every f_j of that window. row is
// the row's f in shared memory, or in device memory on long rows.
__device__ __forceinline__ float search_span(const float* row, int i, int kl,
                                             int kr, int n, int radius,
                                             float lb, float w2,
                                             bool black_border) {
  const int kmax = min(radius, max(kl, kr));
  float best = fminf(__fadd_rn(row[i], __fmul_rn(w2, 0.0f)),
                     wall_of(i, kl, kr, n, w2, black_border));
  float kf = 0.0f;
  for (int k = 1; k <= kmax; ++k) {
    kf = __fadd_rn(kf, 1.0f);
    const float q = __fmul_rn(w2, __fmul_rn(kf, kf));
    if (__fadd_rn(lb, q) > best) break;  // nothing further goes below best
    if (k <= kl) best = fminf(best, __fadd_rn(row[i - k], q));
    if (k <= kr) best = fminf(best, __fadd_rn(row[i + k], q));
  }
  return best;
}

// search_span with the reach packed as kl | kr << 16.
__device__ __forceinline__ float search(const float* s_f, int i, int packed,
                                        int n, int radius, float lb,
                                        float w2, bool black_border) {
  return search_span(s_f, i, packed & 0xffff, (unsigned)packed >> 16, n,
                     radius, lb, w2, black_border);
}

// f as an unsigned key of the same order, and back.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(x);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// One 32-voxel chunk of a warp's span (segment floors): target i, with
// height fi (INF past the row) and reach p, takes the min of f over its
// segment's lanes in the chunk, [lane - kl, lane + kr], with one
// redux.sync, and the carry of the chunks before when its segment began
// there; s_lb[i] becomes that running min and carry lane 31's.
__device__ __forceinline__ void chunk_min(float* s_lb, int i, float fi, int p,
                                          int n, int lane, float& carry) {
  const int kl = p & 0xffff, kr = (unsigned)p >> 16;
  const int lo = max(0, lane - kl), hi = min(31, lane + kr);
  const unsigned piece = (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
  float v = from_key(__reduce_min_sync(piece, order_key(fi)));
  if (kl > lane) v = fminf(v, carry);  // the segment began before
  if (i < n) s_lb[i] = v;
  carry = __shfl_sync(0xffffffffu, v, 31);
}

// Target i's reach into its segment [s, e): kl = i - s, kr = e - 1 - i.
__device__ __forceinline__ int reach(int i, int s, int e) {
  return (int)((unsigned)(i - s) | ((unsigned)(e - 1 - i) << 16));
}

template <bool kMasked, bool kLong, bool kSeg>
__global__ void __launch_bounds__(kMaxThreads)
minplus_walls_kernel(const float* __restrict__ f,
                     const int32_t* __restrict__ ss,
                     const int32_t* __restrict__ se,
                     float* __restrict__ out, long long rows, int n,
                     int group, float w2, bool black_border) {
  extern __shared__ float smem[];
  __shared__ float s_minf[kMaxThreads / 32];
  __shared__ float s_bound[kMaxThreads / 32];
  // kSeg: each warp's first and last piece's min in its span, and whether
  // its first voxel's segment began before the span (1) and covers it (2)
  __shared__ float s_head[kMaxThreads / 32];
  __shared__ float s_tail[kMaxThreads / 32];
  __shared__ int s_link[kMaxThreads / 32];

  const int g = threadIdx.x / group;  // the row within the block
  const int t = threadIdx.x - g * group;  // the thread within the row
  const long long row = kLong ? (long long)blockIdx.x
                              : (long long)blockIdx.x * (blockDim.x / group) + g;
  const bool valid = row < rows;
  const size_t base = (size_t)(valid ? row : 0) * (size_t)n;
  float* s_f = smem + (size_t)g * n * (kSeg ? 2 : 1);
  float* s_lb = s_f + n;  // kSeg: the running min of each piece
  int* parked = reinterpret_cast<int*>(out) + base;
  // kSeg: warp w owns the span of C chunks of 32 voxels from chunk w C,
  // lane l the voxels span0 + 32 m + l; otherwise thread t owns t + m G
  const int lane = threadIdx.x & 31;
  const int C = kSeg ? ((n + 31) / 32 + group / 32 - 1) / (group / 32) : 1;
  const int span0 = kSeg ? 32 * (t >> 5) * C : 0;
  const int span_last = min(n, span0 + 32 * C) - 1;
  auto target = [&](int m) { return kSeg ? span0 + 32 * m + lane : t + m * group; };
  auto owns = [&](int m) { return (!kSeg || m < C) && target(m) < n; };
  auto in_row = [&](int m) { return m < C && span0 + 32 * m < n; };  // kSeg chunk m

  // --- stage f, read ss/se once into the reach, reduce floor and bound;
  // the loads of each half of a thread's targets go out before any is used;
  // kSeg folds each chunk into its pieces' running mins as it goes.
  // Long rows stage nothing: each block reads its whole row for the floor
  // and bound, and searches f in device memory (L2) for its own chunk.
  float minf = INFINITY;
  float bound = -INFINITY;
  float carry = INFINITY;
  int packed[kRegTargets];
  constexpr int kHalf = kRegTargets / 2;
  if constexpr (kLong) {
    for (int i = t; valid && i < n; i += group) {
      const float fi = __ldg(f + base + i);
      const int s = kMasked ? __ldg(ss + base + i) : 0;
      const int e = kMasked ? __ldg(se + base + i) : n;
      minf = fminf(minf, fi);
      bound = fmaxf(bound, fminf(fi, wall_of(i, i - s, e - 1 - i, n, w2,
                                             black_border)));
    }
  } else {
#pragma unroll
    for (int h = 0; h < kRegTargets; h += kHalf) {
      float fh[kHalf];
      int sh[kHalf], eh[kHalf];
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        const int i = target(h + q);
        if (valid && owns(h + q)) {
          fh[q] = __ldg(f + base + i);
          sh[q] = kMasked ? __ldg(ss + base + i) : 0;
          eh[q] = kMasked ? __ldg(se + base + i) : n;
        }
      }
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        const int i = target(h + q);
        packed[h + q] = 0;
        if (valid && owns(h + q)) {
          s_f[i] = fh[q];
          minf = fminf(minf, fh[q]);
          packed[h + q] = reach(i, sh[q], eh[q]);
          bound = fmaxf(bound, fminf(fh[q], wall_of(i, i - sh[q], eh[q] - 1 - i,
                                                    n, w2, black_border)));
        }
        if constexpr (kSeg) {
          if (valid && in_row(h + q))
            chunk_min(s_lb, i, owns(h + q) ? fh[q] : INFINITY, packed[h + q],
                      n, lane, carry);
        }
      }
    }
    // targets beyond the kRegTargets-th of a thread: the reach waits in
    // d's own slot
    auto park = [&](int i) {
      const float fi = f[base + i];
      s_f[i] = fi;
      minf = fminf(minf, fi);
      const int p = reach(i, kMasked ? ss[base + i] : 0, kMasked ? se[base + i] : n);
      parked[i] = p;
      bound = fmaxf(bound, fminf(fi, wall_of(i, p & 0xffff, (unsigned)p >> 16,
                                             n, w2, black_border)));
      return p;
    };
    if constexpr (kSeg) {
      for (int m = kRegTargets; valid && in_row(m); ++m) {
        const int i = target(m);
        const int p = i < n ? park(i) : 0;
        chunk_min(s_lb, i, i < n ? s_f[i] : INFINITY, p, n, lane, carry);
      }
      if (valid && group > 32) {  // the span's first and last pieces
        __syncwarp();
        if (lane == 0) {
          const int w = threadIdx.x >> 5, e1 = span0 + ((unsigned)packed[0] >> 16);
          const bool live = span0 < n;
          s_head[w] = live ? s_lb[min(e1, span_last)] : INFINITY;
          s_tail[w] = live ? s_lb[span_last] : INFINITY;
          s_link[w] = live ? ((packed[0] & 0xffff) > 0) | (e1 >= span_last) << 1 : 0;
        }
      }
    } else {
      for (int i = t + kRegTargets * group; valid && i < n; i += group) park(i);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    minf = fminf(minf, __shfl_xor_sync(0xffffffffu, minf, off));
    bound = fmaxf(bound, __shfl_xor_sync(0xffffffffu, bound, off));
  }
  if (group > 32) {  // every thread reads all parts of its row's warps
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      s_minf[warp] = minf;
      s_bound[warp] = bound;
    }
    __syncthreads();
    const int first = g * (group >> 5);
    for (int k = first; k < first + (group >> 5); ++k) {
      minf = fminf(minf, s_minf[k]);
      bound = fmaxf(bound, s_bound[k]);
    }
  } else {
    __syncwarp();
  }
  if (!valid) return;

  // _radius_gap: all-INF rows need no candidates beyond j == i; a row with
  // an infinite bound over finite candidates may search in full
  float gap = __fsub_rn(bound, minf);
  if (isfinite(gap)) {
    gap = fmaxf(gap, 0.0f);
  } else {
    gap = (minf == INFINITY) ? 0.0f : INFINITY;
  }
  // _radius_from_gap: ulp-guarded floor, clamped to n before the cast
  float rf = __fadd_rn(__fmul_rn(__fsqrt_rn(__fdiv_rn(gap, w2)), 1.00001f), 0.01f);
  rf = fminf(rf, (float)n);
  const int radius = (int)rf;

  // --- each target's outward search in its segment, stopped exactly ---
  // kSeg: the floor of a target is its piece's min in the warp's span,
  // s_lb at the piece's last voxel, unless the piece is the span's first
  // or last and its segment goes on into the spans before or after: then
  // head_lb or tail_lb, which take in the pieces of those spans.
  float head_lb = INFINITY, tail_lb = INFINITY;
  if constexpr (kSeg) {
    if (group > 32) {
      const int first = g * (group >> 5), w = first + (t >> 5),
                end = first + (group >> 5);
      float left = INFINITY, right = INFINITY;
      for (int v = w; v > first && (s_link[v] & 1); --v) {
        left = fminf(left, s_tail[v - 1]);
        if (!(s_link[v - 1] & 2)) break;  // its span holds another piece
      }
      for (int v = w + 1; v < end && (s_link[v] & 1); ++v) {
        right = fminf(right, s_head[v]);
        if (!(s_link[v] & 2)) break;
      }
      const bool whole = s_link[w] & 2;
      head_lb = fminf(fminf(s_head[w], left), whole ? right : INFINITY);
      tail_lb = fminf(fminf(s_tail[w], right), whole ? left : INFINITY);
    }
  }
  auto floor_of = [&](int i, int p) {
    if constexpr (!kSeg) return minf;
    const int e1 = i + ((unsigned)p >> 16);
    if (i - (p & 0xffff) < span0) return head_lb;
    return e1 > span_last ? tail_lb : s_lb[e1];
  };
  if constexpr (kLong) {
    const int lo = (int)blockIdx.y * kLongChunk;
    const int hi = min(n, lo + kLongChunk);
    for (int i = lo + t; i < hi; i += group) {
      const int s = kMasked ? __ldg(ss + base + i) : 0;
      const int e = kMasked ? __ldg(se + base + i) : n;
      out[base + i] = search_span(f + base, i, i - s, e - 1 - i, n, radius,
                                  minf, w2, black_border);
    }
  } else {
#pragma unroll
    for (int m = 0; m < kRegTargets; ++m) {
      const int i = target(m);
      if (owns(m))
        out[base + i] = search(s_f, i, packed[m], n, radius,
                               floor_of(i, packed[m]), w2, black_border);
    }
    auto search_parked = [&](int i) {
      const int p = parked[i];
      out[base + i] = search(s_f, i, p, n, radius, floor_of(i, p), w2,
                             black_border);
    };
    if constexpr (kSeg) {
      for (int m = kRegTargets; m < C; ++m)
        if (target(m) < n) search_parked(target(m));
    } else {
      for (int i = t + kRegTargets * group; i < n; i += group) search_parked(i);
    }
  }
}

// The shared-memory modes, rows of one warp two a block: kSeg (masked rows
// up to kSegAxis, f and the pieces' running mins, 8 B a voxel), the others
// f alone.
template <bool kMasked, bool kSeg>
cudaError_t launch_short(const float* f, const int32_t* ss, const int32_t* se,
                         float* out, long long rows, int n, float w2,
                         bool black_border, cudaStream_t stream) {
  // G threads a row, at most kRegTargets targets each up to 4096; short
  // rows share a block of 64 threads (small blocks measured fastest)
  int group = ((n + 32 * kRegTargets - 1) / (32 * kRegTargets)) * 32;
  if (group > kMaxThreads) group = kMaxThreads;
  const int per_block = group >= 64 ? 1 : 64 / group;
  const size_t smem = (size_t)per_block * (kSeg ? 2 : 1) * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      minplus_walls_kernel<kMasked, false, kSeg>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + per_block - 1) / per_block;
  minplus_walls_kernel<kMasked, false, kSeg><<<(unsigned)blocks,
                                               per_block * group, smem,
                                               stream>>>(
      f, ss, se, out, rows, n, group, w2, black_border);
  return cudaGetLastError();
}

template <bool kMasked>
cudaError_t launch(const float* f, const int32_t* ss, const int32_t* se,
                   float* out, long long rows, int n, float w2,
                   bool black_border, bool long_rows, cudaStream_t stream) {
  if (long_rows) {  // a block a chunk of a row, f read from device memory
    const dim3 grid((unsigned)rows, (unsigned)((n + kLongChunk - 1) / kLongChunk));
    minplus_walls_kernel<kMasked, true, false><<<grid, kMaxThreads, 0, stream>>>(
        f, ss, se, out, rows, n, kMaxThreads, w2, black_border);
    return cudaGetLastError();
  }
  if constexpr (kMasked) {
    if (n <= kSegAxis)
      return launch_short<true, true>(f, ss, se, out, rows, n, w2,
                                      black_border, stream);
  }
  return launch_short<kMasked, false>(f, ss, se, out, rows, n, w2,
                                      black_border, stream);
}

}  // namespace

extern "C" {

// f, out: (rows, n) f32, C-contiguous. ss, se: (rows, n) int32 segment
// bounds when masked, else ignored (may be null). long_rows: the mode for
// rows past the shared-memory ceiling (any n; also taken on request).
// Returns a cudaError_t.
int edt_minplus_walls(const void* f, const void* ss, const void* se,
                      void* out, long long rows, int n, float w2, int masked,
                      int black_border, int long_rows, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (masked) {
    return (int)launch<true>((const float*)f, (const int32_t*)ss,
                             (const int32_t*)se, (float*)out, rows, n, w2,
                             black_border != 0, long_rows != 0, st);
  }
  return (int)launch<false>((const float*)f, nullptr, nullptr, (float*)out,
                            rows, n, w2, black_border != 0, long_rows != 0, st);
}

}  // extern "C"
