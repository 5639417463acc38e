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
// Design: one warp per row, eight rows a block. A left-to-right sweep over
// 32-voxel chunks runs a warp-shuffle segmented scan on each chunk with the
// carry of the chunks before it and writes the self term plus the prefix
// term; a right-to-left sweep does the same for the suffix term and adds it
// at the zero sites. No shared memory, so no axis ceiling.
//
// Bound on the card: HBM bytes. g (4 B) and int16 offsets (2 B) read once,
// df (4 B) written once: 10 B a voxel for either kernel. K4 does nothing
// yet to reach it: it reads g and the offsets twice (one sweep each way)
// and df again at zero sites.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGradWarps = 8;  // rows a block, at most
constexpr int kGradUnroll = 4;  // chunks in flight
constexpr int kMaxSmem = 232448;  // an H100 block's opt-in shared memory
constexpr int kScanWarps = 8;
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

template <int kLink>
__global__ void __launch_bounds__(kGradWarps * 32)
minplus_grad_kernel(const float* __restrict__ g, const void* __restrict__ links,
                    float* __restrict__ out, long long rows, int n,
                    int off_sent, int has_sent) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= rows) return;  // whole warps only: the shuffles stay full
  float* acc = smem + (size_t)warp * n;
  const size_t base = (size_t)row * (size_t)n;

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
  for (int j = lane; j < n; j += 32) out[base + j] = acc[j];
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

template <int kLink>
cudaError_t launch_grad(const float* g, const void* links, float* out,
                        long long rows, int n, int off_sent, int has_sent,
                        cudaStream_t stream) {
  // as many rows a block as their accumulators fit, up to kGradWarps
  long long warps = (kMaxSmem - 256) / ((long long)n * (long long)sizeof(float));
  if (warps > kGradWarps) warps = kGradWarps;
  if (warps > rows) warps = rows;
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)warps * (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      minplus_grad_kernel<kLink>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + warps - 1) / warps;
  minplus_grad_kernel<kLink><<<(unsigned)blocks, (unsigned)warps * 32, smem,
                               stream>>>(g, links, out, rows, n, off_sent,
                                         has_sent);
  return cudaGetLastError();
}

template <int kLink>
cudaError_t launch_scan(const float* g, const void* offsets, float* out,
                        long long rows, int n, int off_sent, int has_sent,
                        cudaStream_t stream) {
  const long long blocks = (rows + kScanWarps - 1) / kScanWarps;
  binary_grad_scan_kernel<kLink><<<(unsigned)blocks, kScanWarps * 32, 0, stream>>>(
      g, offsets, out, rows, n, off_sent, has_sent);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3. g, out: (rows, n) f32; links: (rows, n) of link_kind (0 absolute
// int32, 1 int16 offsets, 2 int32 offsets). off_sent marks inert offsets
// when has_sent. All C-contiguous. Returns a cudaError_t.
int edt_minplus_grad(const void* g, const void* links, void* out,
                     long long rows, int n, int link_kind, int off_sent,
                     int has_sent, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float* gg = (const float*)g;
  float* oo = (float*)out;
  switch (link_kind) {
    case kAbsI32:
      return (int)launch_grad<kAbsI32>(gg, links, oo, rows, n, off_sent, has_sent, st);
    case kOffI16:
      return (int)launch_grad<kOffI16>(gg, links, oo, rows, n, off_sent, has_sent, st);
    case kOffI32:
      return (int)launch_grad<kOffI32>(gg, links, oo, rows, n, off_sent, has_sent, st);
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
