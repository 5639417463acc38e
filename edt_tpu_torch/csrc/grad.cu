// K3 and K4: the backward kernels of the differentiable EDT at temperature
// 0, for Hopper (sm_90a).
//
// K3, the argmin scatter. Replaces edt_tpu/ops/pallas_kernels.py:
// _minplus_grad_rowsweep_kernel and _minplus_grad_kernel. For each row r:
//
//   df[r, j] = sum_i g[r, i] [i + o[r, i] == j]
//
// with o the link offsets of K2 (int16 / int32, off_sent = inert), or
// o = argj - i from absolute int32 indices (negative = inert). A link that
// leaves the row credits nothing.
//
// Design: a scatter by source into shared memory, deterministic. The TPU
// kernel gathers by target because a scatter-add serialises there; here
// one warp takes a row, up to eight rows a block, and keeps an
// accumulator acc[0, n) for its row in shared memory (4 B a voxel: the
// axis ceiling is the opt-in shared memory over 4, one warp a block at the
// longest rows). The warp walks the row in 32-voxel chunks, ascending,
// with coalesced loads of g and the links, four chunks in flight. Each
// lane forms its target t = i + o, inert when the link is inert or leaves
// the row. The live lanes of a chunk that share a target form a group.
// When the live targets ascend with the lane, a group is a run of equal
// targets, found with a ballot and one shuffle. K2's links ascend but where
// rounding breaks it: in exact arithmetic the leftmost argmin of
// f_j + w2 (i - j)^2 never moves left as i grows. Other chunks group with
// __match_any_sync on t (inert lanes take keys of their own and join no
// group), which costs about as much as the rest of the sweep and so is the
// fallback only. The group's lowest lane reads acc[t], adds its own g,
// then the group's other g one lane after another in ascending lane order
// through shuffles, and writes acc[t] back. Distinct groups hold distinct
// targets, so no two lanes touch one word; after the sweep the warp writes
// acc out, coalesced. Every target thus sums its sources onto 0.0 in
// ascending i, the order of the first version's gather: the same values
// bit for bit, the same from run to run, with no atomics. Each voxel is
// read and written once, and the cost no longer depends on the longest
// link in the row. A chunk whose 32 lanes share one target serialises 31
// shuffle steps in one lane, still O(1) a voxel.
//
// Long rows (past the shared-memory ceiling, any n; the wrapper may also
// ask for this mode on a shorter row) take the row-split mode, which
// spreads one row over many warps. The row is cut into tiles of
// kSplitTile sources (halved, down to 256, while the rows give fewer than
// 32 warps an SM), one warp a tile, kSplitWarps tiles a block, so
// (8, 65536) has 2048 warps in flight. A warp folds four 32-source chunks
// while the next four load. Where the live targets of a row
// ascend, as K2's do, a target's sources form one run of consecutive live
// sources, and the warp sums each run in registers, in ascending i onto
// 0.0 (its leader lane takes the run's cotangents one shuffle a step), and
// writes it once. A run that crosses a tile's end is summed whole by the
// tile that holds its first live source, reading on past its end; the
// tiles it reaches skip it (each tile learns the target of the nearest
// live source before it by reading back). The targets no source reaches
// are zeroed by the run after them (the last run of a row zeroes those
// after it; a row with no live source, its last tile). Every target is
// thus written once, by one warp, with the shared-memory mode's sum in its
// order: the same bits, no atomics. Each tile checks that its live targets ascend, from the
// nearest live source before it to the first live one after the run it
// owns, which covers every pair of neighbouring live sources of the row; a
// tile that finds a descent marks its row and stops. A second launch runs
// the marked rows alone in the one-warp mode: the kernel's second
// instantiation, whose accumulator is the output row in device memory,
// zeroed by the warp first and touched by no other warp, __syncwarp
// ordering each chunk's writes before the next chunk's reads, the
// shared-memory mode's order again. Its other warps read their row's mark
// and return. Bound: 12 B a voxel (g, int32 links, df).
//
// K4, the binary-pass scan. Replaces edt_tpu/ops/pallas_kernels.py:
// _binary_grad_scan_kernel. Offsets o mark zero sites with the dtype max and
// wall wins with off_sent (inert: g and o read as 0). With o0 = 0 at zero
// sites and o elsewhere, and z the zero sites:
//
//   df[j] = g[j] [o0[j] == 0] + z[j] (segprefix(g [o0 > 0])[j - 1]
//                                     + segsuffix(g [o0 < 0])[j + 1])
//
// where the segmented sums reset at zero sites (edt_tpu/models/soft.py:
// _binary_grad_from_links). Computed literally, for any input.
//
// Design: one warp a row, eight rows a block. On rows up to 32 kScanRegMax
// = 1024 voxels the warp holds its row in registers: lane l owns the V
// contiguous voxels [l V, l V + V), V the least power of two with 32 V >= n
// (16 at n = 512). It loads them at once, 16 B a load where the row's
// pitch and the pointers allow (n a multiple of 4 for g, of 8 for int16
// offsets; smaller loads otherwise, one voxel at a time at the row's
// ragged end), every load issued before any is used. Each lane sums its
// own forward values g [o0 > 0] after its last zero site and its backward
// values g [o0 < 0] before its first; one shuffle scan of the 32 lane sums
// with their zero-site flags in each direction, the segmented operator of
// the sweeps below, gives each lane its carry; the lane then walks its
// voxels in order, forward and backward, each zero site taking the
// running sum, and df is stored once from registers. Each voxel is read
// and written once. Longer rows take two sweeps over 32-voxel chunks: a
// left-to-right one runs a warp-shuffle segmented scan on each chunk with
// the carry of the chunks before it and writes the self term plus the
// prefix term; a right-to-left one does the same for the suffix term and
// adds it at the zero sites. No shared memory, so no axis ceiling.
//
// Bound on the card: HBM bytes. g (4 B) and int16 offsets (2 B) read once,
// df (4 B) written once: 10 B a voxel for either kernel. K4's sweeps, on
// rows past the register cap, read g and the offsets twice and df again
// at zero sites.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kGradWarps = 8;  // rows a block, at most
constexpr int kGradUnroll = 4;  // chunks in flight
constexpr int kSplitWarps = 8;  // row-split mode: tiles a block, a warp each
constexpr int kSplitTile = 1024;  // row-split mode: sources a tile, at most
constexpr int kSplitTileMin = 256;  // and at least
constexpr long long kSplitFill = 32 * 132;  // warps: 32 on each of 132 SMs
constexpr int kMaxSmem = 232448;  // an H100 block's opt-in shared memory
constexpr int kScanWarps = 8;
constexpr int kScanRegMax = 32;  // K4: voxels a lane holds in registers
constexpr unsigned kFull = 0xffffffffu;

enum LinkKind { kAbsI32 = 0, kOffI16 = 1, kOffI32 = 2 };

// The target of source i, or -1 when its link is inert or leaves the row.
template <int kLink>
__device__ __forceinline__ int load_target(const void* links, size_t k, int i,
                                           int n, int off_sent, int has_sent) {
  if (kLink == kAbsI32) {
    const int a = __ldg(static_cast<const int32_t*>(links) + k);
    return (a >= 0 && a < n) ? a : -1;  // negative: inert
  }
  const int o = (kLink == kOffI16)
                    ? (int)__ldg(static_cast<const int16_t*>(links) + k)
                    : __ldg(static_cast<const int32_t*>(links) + k);
  if (has_sent && o == off_sent) return -1;
  return (o >= -i && o < n - i) ? i + o : -1;  // no overflow: |i|, |n| small
}

// One chunk of a warp's sweep: each lane holds source i's target t (-1
// inert) and cotangent gi; every group of live lanes sharing a target adds
// its cotangents into acc[t] through its lowest lane, in ascending lane
// order.
__device__ __forceinline__ void scatter_chunk(float* acc, int t, float gi,
                                              int lane) {
  const bool live = t >= 0;
  // the nearest live lane below this one (itself if none) and its target
  const unsigned below = __ballot_sync(kFull, live) & ((1u << lane) - 1u);
  const int p = below ? 31 - __clz(below) : lane;
  const int tp = __shfl_sync(kFull, t, p);
  bool leader;
  if (__all_sync(kFull, !live || p == lane || tp <= t)) {
    // live targets ascend with the lane, as K2's do: a group is a run
    leader = live && (p == lane || tp != t);
  } else {
    const unsigned m = __match_any_sync(kFull, live ? t : -1 - lane);
    leader = live && (m & ((1u << lane) - 1u)) == 0u;
  }
  // the lanes of groups of two or more that are not their group's leader
  const unsigned rest = __ballot_sync(kFull, live && !leader);
  float a = 0.0f;
  if (leader) a = acc[t] + gi;
  for (unsigned r = rest; r; r &= r - 1u) {  // warp-uniform, ascending
    const int s = __ffs(r) - 1;
    const float v = __shfl_sync(kFull, gi, s);
    const int ts = __shfl_sync(kFull, t, s);
    if (leader && ts == t) a += v;
  }
  if (leader) acc[t] = a;
  __syncwarp();
}

// only: on long rows, the row-split mode's marks; rows it did not mark are
// done and left alone.
template <int kLink, bool kLong>
__global__ void __launch_bounds__(kGradWarps * 32)
minplus_grad_kernel(const float* __restrict__ g, const void* __restrict__ links,
                    float* __restrict__ out, long long rows, int n,
                    int off_sent, int has_sent, const int* __restrict__ only) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // whole warps only: the shuffles stay full
  if (kLong && !only[row]) return;
  const size_t base = (size_t)row * (size_t)n;
  // the accumulator: in shared memory, or on long rows the output row
  // itself, which only this warp touches
  float* acc = kLong ? out + base : smem + (size_t)warp * n;

  for (int j = lane; j < n; j += 32) acc[j] = 0.0f;
  __syncwarp();

  // --- the sweep: ascending chunks, kGradUnroll loaded ahead ---
  for (int c0 = 0; c0 < n; c0 += 32 * kGradUnroll) {
    int t[kGradUnroll];
    float gv[kGradUnroll];
#pragma unroll
    for (int u = 0; u < kGradUnroll; ++u) {
      const int i = c0 + 32 * u + lane;
      t[u] = -1;
      gv[u] = 0.0f;
      if (i < n) {
        t[u] = load_target<kLink>(links, base + i, i, n, off_sent, has_sent);
        gv[u] = g[base + i];
      }
    }
#pragma unroll
    for (int u = 0; u < kGradUnroll; ++u) {
      if (c0 + 32 * u < n) scatter_chunk(acc, t[u], gv[u], lane);
    }
  }

  // --- write the row out, coalesced ---
  if constexpr (!kLong)
    for (int j = lane; j < n; j += 32) out[base + j] = acc[j];
}

// Zeroes df[z0, z1), the whole warp.
__device__ __forceinline__ void zero_range(float* df, int z0, int z1, int lane) {
  for (int j = z0 + lane; j < z1; j += 32) df[j] = 0.0f;
}

// The row-split mode's fold of one chunk whose live lanes lm are not none,
// into the warp's open run: its target tc (-1: none), its sum sc so far and
// whether this tile owns it. Checks that the live targets ascend from tc;
// sums each run of equal targets in ascending lane order, the first onto
// sc where it continues the open run, any other onto 0.0 (the
// shared-memory mode's acc[t] + g, acc[t] = 0.0); writes each run that
// ends in or before the chunk, where this tile owns it; and leaves the
// chunk's last run open. A run's lanes are the live lanes from its leader
// up to the next leader: the leader takes their cotangents one shuffle a
// step, as many steps as the chunk's longest run. The targets from the one
// before the chunk's first new run up to its last run's hold no other
// warp's sums: the warp zeroes them all, then writes the runs it closes
// over them, so each target no source reaches is zeroed by the run after
// it. Returns false where the targets descend.
__device__ __forceinline__ bool fold_chunk(float* df, int t, float gi, int lane,
                                           unsigned lm, int& tc, float& sc,
                                           bool& own) {
  const bool live = t >= 0;
  const unsigned below = lm & ((1u << lane) - 1u);
  const int tp = __shfl_sync(kFull, t, below ? 31 - __clz(below) : lane);
  const int prev = below ? tp : tc;  // the target of the live source before
  if (__any_sync(kFull, live && t < prev)) return false;
  const bool leader = live && (below == 0u || tp != t);
  const bool cont = leader && below == 0u && t == tc;  // continues the open run
  // the run's other lanes: live, after the leader, before the next leader
  const unsigned lead = __ballot_sync(kFull, leader);
  const unsigned later = ~((2u << lane) - 1u);  // lanes above this one
  const unsigned next = lead & later;
  unsigned mine = leader ? lm & later & (next ? (next & -next) - 1u : kFull) : 0u;
  const int steps = __reduce_max_sync(kFull, __popc(mine));
  float s = 0.0f;
  if (leader) s = (cont ? sc : 0.0f) + gi;
  for (int k = 0; k < steps; ++k) {  // ascending lanes within each run
    const float v = __shfl_sync(kFull, gi, mine ? __ffs(mine) - 1 : lane);
    if (mine) {
      s += v;
      mine &= mine - 1u;
    }
  }
  const int first = __ffs(lm) - 1;
  const int q = 31 - __clz(lead);  // the last run's leader
  const int tl = __shfl_sync(kFull, t, q);
  // a new run: every run but a first one that continues the open run
  const unsigned opened = lead & ~(__shfl_sync(kFull, cont, first) ? 1u << first : 0u);
  if (opened) {
    zero_range(df, __shfl_sync(kFull, prev, __ffs(opened) - 1) + 1, tl, lane);
    __syncwarp();
  }
  // the open run ends before this chunk where its first live lane opens one
  if (own && lane == first && !cont) df[tc] = sc;
  if (leader && lane != q && (own || !cont)) df[t] = s;
  sc = __shfl_sync(kFull, s, q);
  own = (q == first && tl == tc) ? own : true;
  tc = tl;
  return true;
}

// The target of the nearest live source before a (-1: none).
template <int kLink>
__device__ __noinline__ int target_before(const void* links, size_t base,
                                         int a, int n, int off_sent,
                                         int has_sent, int lane) {
  for (int c1 = a; c1 > 0; c1 -= 32) {
    const int i = c1 - 32 + lane;
    const int t = i >= 0 ? load_target<kLink>(links, base + i, i, n, off_sent,
                                              has_sent)
                         : -1;
    const unsigned lm = __ballot_sync(kFull, t >= 0);
    if (lm) return __shfl_sync(kFull, t, 31 - __clz(lm));
  }
  return -1;
}

template <int kLink>
__global__ void __launch_bounds__(kSplitWarps * 32)
minplus_grad_split_kernel(const float* __restrict__ g,
                          const void* __restrict__ links,
                          float* __restrict__ out, int* __restrict__ marks,
                          long long rows, int n, int tile, int tiles,
                          int off_sent, int has_sent) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  const long long row = w / tiles;
  if (row >= rows) return;  // whole warps only: the shuffles stay full
  const int a = (int)(w % tiles) * tile;
  const int b = min(n, a + tile);
  const size_t base = (size_t)row * (size_t)n;
  float* df = out + base;

  // the chunk of sources [c, c + 32): each lane's target (-1 inert or past
  // the tile) and cotangent
  auto load = [&](int c, int& t, float& v) {
    const int i = c + lane;
    t = -1;
    v = 0.0f;
    if (i < b) {
      t = load_target<kLink>(links, base + i, i, n, off_sent, has_sent);
      v = g[base + i];
    }
  };
  int tc = -1;  // the open run's target
  float sc = 0.0f;
  bool own = false;
  bool met = false;  // a live source of the tile met: tc starts known
  bool ok = true;
  auto fold = [&](int t, float v) {
    const unsigned lm = __ballot_sync(kFull, t >= 0);
    if (!lm || !ok) return;
    if (!met) {  // the run open before the tile, which the tile does not own
      met = true;
      tc = target_before<kLink>(links, base, a, n, off_sent, has_sent, lane);
    }
    ok = fold_chunk(df, t, v, lane, lm, tc, sc, own);
  };
  // four chunks folded while the next four load
  int t0, t1, t2, t3;
  float v0, v1, v2, v3;
  load(a, t0, v0);
  load(a + 32, t1, v1);
  load(a + 64, t2, v2);
  load(a + 96, t3, v3);
  for (int c0 = a; c0 < b; c0 += 128) {
    int u0, u1, u2, u3;
    float x0, x1, x2, x3;
    load(c0 + 128, u0, x0);
    load(c0 + 160, u1, x1);
    load(c0 + 192, u2, x2);
    load(c0 + 224, u3, x3);
    fold(t0, v0);
    fold(t1, v1);
    fold(t2, v2);
    fold(t3, v3);
    if (!ok) {
      if (lane == 0) marks[row] = 1;
      return;
    }
    t0 = u0, t1 = u1, t2 = u2, t3 = u3;
    v0 = x0, v1 = x1, v2 = x2, v3 = x3;
  }
  if (!met && b == n &&
      target_before<kLink>(links, base, a, n, off_sent, has_sent, lane) < 0) {
    zero_range(df, 0, n, lane);  // no live source in the row
    return;
  }
  if (!own) return;
  // the open run is this tile's: sum it on past the tile's end, up to the
  // first live source with another target, which must be larger; the last
  // run of the row zeroes the targets after it
  int end = n;
  for (int c0 = b; c0 < n; c0 += 32) {
    const int i = c0 + lane;
    int t = -1;
    float gi = 0.0f;
    if (i < n) {
      t = load_target<kLink>(links, base + i, i, n, off_sent, has_sent);
      gi = g[base + i];
    }
    const unsigned other = __ballot_sync(kFull, t >= 0 && t != tc);
    const unsigned same = __ballot_sync(kFull, t == tc) &
                          (other ? (1u << (__ffs(other) - 1)) - 1u : kFull);
    for (unsigned r = same; r; r &= r - 1u)  // warp-uniform, ascending
      sc += __shfl_sync(kFull, gi, __ffs(r) - 1);
    if (other) {
      if (__shfl_sync(kFull, t, __ffs(other) - 1) < tc) {
        if (lane == 0) marks[row] = 1;
        return;
      }
      end = tc + 1;
      break;
    }
  }
  if (lane == 0) df[tc] = sc;
  zero_range(df, tc + 1, end, lane);
}

template <int kLink>
__device__ __forceinline__ void load_scan(const float* g, const void* offsets,
                                          size_t k, int off_sent, int has_sent,
                                          float& gm, int& o) {
  o = (kLink == kOffI16) ? (int)static_cast<const int16_t*>(offsets)[k]
                         : (int)static_cast<const int32_t*>(offsets)[k];
  gm = g[k];
  if (has_sent && o == off_sent) {  // wall win: inert
    gm = 0.0f;
    o = 0;
  }
}

template <int kLink>
__global__ void __launch_bounds__(kScanWarps * 32)
binary_grad_scan_kernel(const float* __restrict__ g,
                        const void* __restrict__ offsets,
                        float* __restrict__ out, long long rows, int n,
                        int off_sent, int has_sent) {
  const long long row = (long long)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const int omax = (kLink == kOffI16) ? INT16_MAX : INT32_MAX;
  const size_t base = (size_t)row * (size_t)n;

  // --- left to right: self term + segprefix(g [o0 > 0])[j - 1] ---
  float carry = 0.0f;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int j = c0 + lane;
    const bool valid = j < n;
    float gm = 0.0f;
    int o = 0;
    if (valid) load_scan<kLink>(g, offsets, base + j, off_sent, has_sent, gm, o);
    const bool z = valid && o == omax;
    const int o0 = z ? 0 : o;
    float v = (o0 > 0) ? gm : 0.0f;
    bool fl = z;
    for (int s = 1; s < 32; s <<= 1) {
      const float vs = __shfl_up_sync(kFull, v, s);
      const int fs = __shfl_up_sync(kFull, (int)fl, s);
      if (lane >= s) {
        if (!fl) v = vs + v;
        fl = fl || fs;
      }
    }
    if (!fl) v = carry + v;  // no zero site at or before j in this chunk
    float prev = __shfl_up_sync(kFull, v, 1);
    if (lane == 0) prev = carry;
    if (valid) out[base + j] = (o0 == 0 ? gm : 0.0f) + (z ? prev : 0.0f);
    carry = __shfl_sync(kFull, v, 31);
  }

  // --- right to left: add segsuffix(g [o0 < 0])[j + 1] at zero sites ---
  carry = 0.0f;
  for (int c0 = ((n - 1) / 32) * 32; c0 >= 0; c0 -= 32) {
    const int j = c0 + lane;
    const bool valid = j < n;
    float gm = 0.0f;
    int o = 0;
    if (valid) load_scan<kLink>(g, offsets, base + j, off_sent, has_sent, gm, o);
    const bool z = valid && o == omax;
    const int o0 = z ? 0 : o;
    float v = (o0 < 0) ? gm : 0.0f;
    bool fl = z;
    for (int s = 1; s < 32; s <<= 1) {
      const float vs = __shfl_down_sync(kFull, v, s);
      const int fs = __shfl_down_sync(kFull, (int)fl, s);
      if (lane + s < 32) {
        if (!fl) v = v + vs;
        fl = fl || fs;
      }
    }
    if (!fl) v = v + carry;  // no zero site at or after j in this chunk
    float next = __shfl_down_sync(kFull, v, 1);
    if (lane == 31) next = carry;
    if (z) out[base + j] += next;
    carry = __shfl_sync(kFull, v, 0);
  }
}

// K4 on rows a warp holds in registers (n <= 32 * kScanRegMax): lane l owns
// the V contiguous voxels [l V, l V + V). Loads of W elements (16 B where
// the row allows it, else smaller, else one at a time), all issued before
// any is used.
template <typename T, int W>
__device__ __forceinline__ void load_run(const T* p, int j, int n, bool vec,
                                         T* dst) {
  constexpr int kBytes = W * (int)sizeof(T);
  if (vec && j + W <= n) {
    if constexpr (kBytes == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + j));
      memcpy(dst, &v, 16);
      return;
    } else if constexpr (kBytes == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p + j));
      memcpy(dst, &v, 8);
      return;
    } else if constexpr (kBytes == 4) {
      const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p + j));
      memcpy(dst, &v, 4);
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < W; ++u) dst[u] = j + u < n ? __ldg(p + j + u) : T(0);
}

template <int W>
__device__ __forceinline__ void store_run(float* p, int j, int n, bool vec,
                                          const float* src) {
  if (vec && j + W <= n) {
    if constexpr (W == 4) {
      *reinterpret_cast<float4*>(p + j) = make_float4(src[0], src[1], src[2], src[3]);
      return;
    } else if constexpr (W == 2) {
      *reinterpret_cast<float2*>(p + j) = make_float2(src[0], src[1]);
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < W; ++u)
    if (j + u < n) p[j + u] = src[u];
}

// The segmented sums of a warp's lanes, each lane one (flag, sum) with the
// sum after its last zero site (forward) or before its first (backward):
// the exclusive scan, every lane the carry into it from the lanes before it
// in that direction, reset at zero sites.
template <bool kForward>
__device__ __forceinline__ float lane_carry(float v, bool fl, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float vs = kForward ? __shfl_up_sync(kFull, v, s)
                              : __shfl_down_sync(kFull, v, s);
    const bool fs = kForward ? __shfl_up_sync(kFull, (int)fl, s)
                             : __shfl_down_sync(kFull, (int)fl, s);
    if (kForward ? lane >= s : lane + s < 32) {
      if (!fl) v = kForward ? vs + v : v + vs;
      fl = fl || fs;
    }
  }
  const float c = kForward ? __shfl_up_sync(kFull, v, 1)
                           : __shfl_down_sync(kFull, v, 1);
  return (kForward ? lane == 0 : lane == 31) ? 0.0f : c;
}

template <int kLink, int V>
__global__ void __launch_bounds__(kScanWarps * 32)
binary_grad_scan_reg_kernel(const float* __restrict__ g,
                            const void* __restrict__ offsets,
                            float* __restrict__ out, long long rows, int n,
                            int off_sent, int has_sent, int vec_g, int vec_o) {
  using OffT = typename std::conditional<kLink == kOffI16, int16_t, int32_t>::type;
  constexpr int kWg = V < 4 ? V : 4;  // f32 elements a load (16 B at most)
  constexpr int kWo = V < 16 / (int)sizeof(OffT) ? V : 16 / (int)sizeof(OffT);
  const long long row = (long long)blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps only: the shuffles stay full
  const int lane = threadIdx.x & 31;
  const int omax = (kLink == kOffI16) ? INT16_MAX : INT32_MAX;
  const size_t base = (size_t)row * (size_t)n;
  const int j0 = lane * V;

  float gm[V];
  OffT ov[V];
#pragma unroll
  for (int e = 0; e < V; e += kWo)
    load_run<OffT, kWo>(static_cast<const OffT*>(offsets) + base, j0 + e, n,
                        vec_o, ov + e);
#pragma unroll
  for (int e = 0; e < V; e += kWg)
    load_run<float, kWg>(g + base, j0 + e, n, vec_g, gm + e);

  // decode: the zero sites z; the forward values g [o0 > 0] and the
  // backward values g [o0 < 0] as bit masks over gm; the self term
  // g [o0 == 0], df's first part. Past the row and at wall wins
  // (off_sent) g and o read as 0.
  unsigned zm = 0u, pm = 0u, nm = 0u;
  float df[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    int o = (int)ov[e];
    if (has_sent && o == off_sent) {
      gm[e] = 0.0f;
      o = 0;
    }
    const bool z = j0 + e < n && o == omax;
    const int o0 = z ? 0 : o;
    zm |= (unsigned)z << e;
    pm |= (unsigned)(o0 > 0) << e;
    nm |= (unsigned)(o0 < 0) << e;
    df[e] = o0 == 0 ? gm[e] : 0.0f;
  }

  // each direction: the lane's own sum, the carry from the lanes before
  // it, then its voxels in order, a zero site taking the running sum
  float fwd = 0.0f, bwd = 0.0f;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    fwd = (zm >> e & 1u) ? 0.0f : fwd + ((pm >> e & 1u) ? gm[e] : 0.0f);
    const int r = V - 1 - e;
    bwd = (zm >> r & 1u) ? 0.0f : bwd + ((nm >> r & 1u) ? gm[r] : 0.0f);
  }
  float run = lane_carry<true>(fwd, zm != 0u, lane);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (zm >> e & 1u) {
      df[e] = df[e] + run;
      run = 0.0f;
    } else if (pm >> e & 1u) {
      run = run + gm[e];
    }
  }
  run = lane_carry<false>(bwd, zm != 0u, lane);
#pragma unroll
  for (int r = V - 1; r >= 0; --r) {
    if (zm >> r & 1u) {
      df[r] = df[r] + run;
      run = 0.0f;
    } else if (nm >> r & 1u) {
      run = run + gm[r];
    }
  }
#pragma unroll
  for (int e = 0; e < V; e += kWg) store_run<kWg>(out + base, j0 + e, n, vec_g, df + e);
}

template <int kLink>
cudaError_t launch_grad(const float* g, const void* links, float* out,
                        long long rows, int n, int off_sent, int has_sent,
                        int* marks, cudaStream_t stream) {
  if (marks) {  // long rows: the row-split mode, then its marked rows
    cudaError_t err = cudaMemsetAsync(marks, 0, (size_t)rows * sizeof(int), stream);
    if (err != cudaSuccess) return err;
    // tiles of kSplitTile sources, halved down to kSplitTileMin while the
    // rows give fewer than kSplitFill warps
    int tile = kSplitTile;
    while (tile > kSplitTileMin && rows * ((n + tile - 1) / tile) < kSplitFill)
      tile /= 2;
    const int tiles = (n + tile - 1) / tile;
    const long long blocks = (rows * tiles + kSplitWarps - 1) / kSplitWarps;
    minplus_grad_split_kernel<kLink><<<(unsigned)blocks, kSplitWarps * 32, 0,
                                       stream>>>(g, links, out, marks, rows, n,
                                                 tile, tiles, off_sent, has_sent);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    minplus_grad_kernel<kLink, true><<<(unsigned)((rows + kGradWarps - 1) / kGradWarps),
                                       kGradWarps * 32, 0, stream>>>(
        g, links, out, rows, n, off_sent, has_sent, marks);
    return cudaGetLastError();
  }
  // as many rows a block as their accumulators fit, up to kGradWarps
  long long warps = (kMaxSmem - 256) / ((long long)n * (long long)sizeof(float));
  if (warps > kGradWarps) warps = kGradWarps;
  if (warps > rows) warps = rows;
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      minplus_grad_kernel<kLink, false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + warps - 1) / warps;
  minplus_grad_kernel<kLink, false><<<(unsigned)blocks, (unsigned)warps * 32,
                                      smem, stream>>>(g, links, out, rows, n,
                                                      off_sent, has_sent, nullptr);
  return cudaGetLastError();
}

template <int kLink, int V>
cudaError_t launch_scan_reg(const float* g, const void* offsets, float* out,
                            long long rows, int n, int off_sent, int has_sent,
                            cudaStream_t stream) {
  // vector loads where every lane's run starts on their boundary: the row
  // pitch and the pointers aligned to the load width
  constexpr int kOff = kLink == kOffI16 ? 2 : 4;
  constexpr int kWg = V < 4 ? V : 4;
  constexpr int kWo = V < 16 / kOff ? V : 16 / kOff;
  const int vec_g = n % kWg == 0 && (uintptr_t)g % (4 * kWg) == 0 &&
                    (uintptr_t)out % (4 * kWg) == 0;
  const int vec_o = n % kWo == 0 && (uintptr_t)offsets % (kOff * kWo) == 0;
  const long long blocks = (rows + kScanWarps - 1) / kScanWarps;
  binary_grad_scan_reg_kernel<kLink, V><<<(unsigned)blocks, kScanWarps * 32, 0,
                                          stream>>>(
      g, offsets, out, rows, n, off_sent, has_sent, vec_g, vec_o);
  return cudaGetLastError();
}

template <int kLink>
cudaError_t launch_scan(const float* g, const void* offsets, float* out,
                        long long rows, int n, int off_sent, int has_sent,
                        cudaStream_t stream) {
  // rows a warp holds in registers: V voxels a lane, the least power of two
  // with 32 V >= n; longer rows: the two sweeps
  if (n <= 32)
    return launch_scan_reg<kLink, 1>(g, offsets, out, rows, n, off_sent, has_sent, stream);
  if (n <= 64)
    return launch_scan_reg<kLink, 2>(g, offsets, out, rows, n, off_sent, has_sent, stream);
  if (n <= 128)
    return launch_scan_reg<kLink, 4>(g, offsets, out, rows, n, off_sent, has_sent, stream);
  if (n <= 256)
    return launch_scan_reg<kLink, 8>(g, offsets, out, rows, n, off_sent, has_sent, stream);
  if (n <= 512)
    return launch_scan_reg<kLink, 16>(g, offsets, out, rows, n, off_sent, has_sent, stream);
  if (n <= 32 * kScanRegMax)
    return launch_scan_reg<kLink, kScanRegMax>(g, offsets, out, rows, n, off_sent,
                                               has_sent, stream);
  const long long blocks = (rows + kScanWarps - 1) / kScanWarps;
  binary_grad_scan_kernel<kLink><<<(unsigned)blocks, kScanWarps * 32, 0, stream>>>(
      g, offsets, out, rows, n, off_sent, has_sent);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3. g, out: (rows, n) f32; links: (rows, n) of link_kind (0 absolute
// int32, 1 int16 offsets, 2 int32 offsets). off_sent marks inert offsets
// when has_sent. All C-contiguous. marks: null for the shared-memory mode;
// else (rows,) int32 scratch, which selects the long-row mode (any n: the
// row-split mode, then the one-warp mode on the rows it marks, which it
// leaves at 1). Returns a cudaError_t.
int edt_minplus_grad(const void* g, const void* links, void* out,
                     long long rows, int n, int link_kind, int off_sent,
                     int has_sent, void* marks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  float* oo = (float*)out;
  int* mk = (int*)marks;
  switch (link_kind) {
    case kAbsI32:
      return (int)launch_grad<kAbsI32>(gg, links, oo, rows, n, off_sent, has_sent, mk, st);
    case kOffI16:
      return (int)launch_grad<kOffI16>(gg, links, oo, rows, n, off_sent, has_sent, mk, st);
    case kOffI32:
      return (int)launch_grad<kOffI32>(gg, links, oo, rows, n, off_sent, has_sent, mk, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K4. g, out: (rows, n) f32; offsets: (rows, n) int16 (link_kind 1) or
// int32 (2), zero sites at the dtype max, wall wins at off_sent when
// has_sent. All C-contiguous. Returns a cudaError_t.
int edt_binary_grad_scan(const void* g, const void* offsets, void* out,
                         long long rows, int n, int link_kind, int off_sent,
                         int has_sent, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  float* oo = (float*)out;
  switch (link_kind) {
    case kOffI16:
      return (int)launch_scan<kOffI16>(gg, offsets, oo, rows, n, off_sent, has_sent, st);
    case kOffI32:
      return (int)launch_scan<kOffI32>(gg, offsets, oo, rows, n, off_sent, has_sent, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
