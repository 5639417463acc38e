// K3 and K4: the backward kernels of the differentiable EDT at temperature
// 0, for Hopper (sm_90a).
//
// K3, the argmin gather. Replaces edt_tpu/ops/pallas_kernels.py:
// _minplus_grad_rowsweep_kernel and _minplus_grad_kernel. For each row r:
//
//   df[r, j] = sum_i g[r, i] [i + o[r, i] == j]
//
// with o the link offsets of K2 (int16 / int32, off_sent = inert), or
// o = argj - i from absolute int32 indices (negative = inert). A link that
// leaves the row credits nothing.
//
// Design (first version: right and simple). One block per row; g and the
// links, widened to int32 with inert ones marked, are staged in dynamic
// shared memory (8 B a voxel: the axis ceiling is the opt-in shared memory
// over 8). A block reduction gives the row's signed range [lo, hi] of live
// links. Each thread takes targets j and sums g[i] over i = j - hi .. j - lo
// ascending where o[i] == j - i. A gather, as on the TPU: no atomics, so the
// result is the same from run to run.
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
// df (4 B) written once: 10 B a voxel for either kernel. This version does
// nothing yet to reach it: K3 is one row per block like K2, and K4 reads g
// and the offsets twice (one sweep each way) and df again at zero sites.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kScanWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInert = INT_MIN;  // never equals j - i, which is in (-n, n)

enum LinkKind { kAbsI32 = 0, kOffI16 = 1, kOffI32 = 2 };

template <int kLink>
__global__ void __launch_bounds__(kMaxThreads)
minplus_grad_kernel(const float* __restrict__ g, const void* __restrict__ links,
                    float* __restrict__ out, int n, int off_sent,
                    int has_sent) {
  extern __shared__ float smem[];
  float* s_g = smem;
  int* s_o = reinterpret_cast<int*>(smem + n);
  __shared__ int s_lo[kMaxThreads / 32];
  __shared__ int s_hi[kMaxThreads / 32];
  __shared__ int s_range[2];

  const size_t base = (size_t)blockIdx.x * (size_t)n;

  // --- stage g and the live links, reduce their signed range ---
  int lo = 0, hi = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int o;
    bool live;
    if (kLink == kAbsI32) {
      const int a = static_cast<const int32_t*>(links)[base + i];
      live = a >= 0;
      o = a - i;
    } else {
      o = (kLink == kOffI16) ? (int)static_cast<const int16_t*>(links)[base + i]
                             : (int)static_cast<const int32_t*>(links)[base + i];
      live = !(has_sent && o == off_sent);
    }
    s_g[i] = g[base + i];
    s_o[i] = live ? o : kInert;
    if (live) {
      lo = min(lo, o);
      hi = max(hi, o);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k) {
      lo = min(lo, s_lo[k]);
      hi = max(hi, s_hi[k]);
    }
    // links beyond (-n, n) never land in the row
    s_range[0] = max(lo, -n);
    s_range[1] = min(hi, n);
  }
  __syncthreads();
  lo = s_range[0];
  hi = s_range[1];

  // --- gather: each target sums its sources, ascending i ---
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int i_lo = max(0, j - hi);
    const int i_hi = min(n - 1, j - lo);
    float acc = 0.0f;
    for (int i = i_lo; i <= i_hi; ++i) {
      if (s_o[i] == j - i) acc += s_g[i];
    }
    out[base + j] = acc;
  }
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
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)n * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      minplus_grad_kernel<kLink>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  minplus_grad_kernel<kLink><<<(unsigned)rows, threads, smem, stream>>>(
      g, links, out, n, off_sent, has_sent);
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
