// One whole tree level: the built nodes' histograms, the sibling derivation,
// the gain scan under the feature mask, the first-max argmax with the
// pass-left fix, and the re-route of every sample.
//
// Replaces the TPU kernel repro/kernels/level_build.py::level_build_pallas
// (_level_kernel), one Pallas program whose grid runs the phases in order
// and keeps the level in VMEM. Hopper's blocks run in no order and share no
// scratch, so the level is a fixed chain of kernels (phase A two or three,
// B and C one each) that level_build_launch enqueues on the caller's
// stream, with no host synchronisation and no torch op between them:
//
//  A the built rows' histograms, row r = node active[r], written into the
//    level histogram at row active[r]: level_common::hist_enqueue, the
//    staged histogram's own code and plan (kernels/hist_plan.py), so the
//    rows carry its bits;
//  B (level_decide_kernel) one block per (32-feature slice, node): each warp
//    takes a feature row, in derive mode writes the sibling row
//    parent[p] - hist[active[p]] (p = n >> 1; the built row is already in
//    place), scans it with level_common::warp_scan_gain (the split-gain
//    kernel's code) when the feature is in the mask, and keeps its (max
//    gain, smallest flat index f*B+b among the maxima); the block reduces
//    its warps and writes one partial per (node, slice). The gain surface
//    is never stored: that is the fusion;
//  C (level_route_kernel) every block reduces the partials of every node
//    by (max, then smallest index), which is exact in any order and so is
//    torch.argmax's first maximum, applies the pass-left fix (feature 0,
//    threshold B-1 unless the best gain is finite and > 0) into a shared
//    table (block 0 also writes feat / thr / best_gain), then routes one
//    sample per thread: new = 2*node + (bins[s, feat[node]] > thr[node]),
//    and -1 -> -2.
//
// So a fused level gives the staged chain's bits exactly: the histogram
// kernel, parent - built, the split-gain kernel, the masked first-max
// argmax and the partition.
//
// Bound: bytes. The level reads the node ids, the bin rows and grad/hess
// of samples on built nodes, the parent cache, one bin per sample, and
// writes the level histogram, the split vectors and the new node ids; the
// scan is about a dozen flops per cell. Phase A spreads a level of one row
// over the card as the staged histogram does (csrc/histogram.cu).
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "level_common.cuh"

namespace {

constexpr int kDecideWarps = 8;      // phase B: warps per block
constexpr int kSliceFeatures = 32;   // phase B: features per block
constexpr int kRouteThreads = 256;   // phase C: samples per block
constexpr int kMaxNodes = 4096;      // phase C: the split table lives in shared memory

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// (g, i) beats (best, best_i): a larger gain, or the same gain at a smaller
// flat index. Associative and commutative, so any reduction order gives the
// first maximum.
__device__ __forceinline__ void take_better(float g, int i, float& best, int& best_i) {
  if (g > best || (g == best && i < best_i)) {
    best = g;
    best_i = i;
  }
}

__global__ void __launch_bounds__(32 * kDecideWarps)
level_decide_kernel(float* __restrict__ hist, const float* __restrict__ parent,
                    const int* __restrict__ active, const int* __restrict__ mask,
                    int n_feat, int n_bins, int n_nodes, int derive, float lam, float min_h,
                    float* __restrict__ part_gain, int* __restrict__ part_idx) {
  __shared__ float s_gain[kDecideWarps];
  __shared__ int s_idx[kDecideWarps];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nd = blockIdx.y;
  const size_t fb = (size_t)n_feat * n_bins;

  float* row_g = hist + (size_t)nd * fb;
  float* row_h = hist + ((size_t)n_nodes + nd) * fb;
  const float* par_g = nullptr;
  const float* par_h = nullptr;
  const float* blt_g = row_g;
  const float* blt_h = row_h;
  bool sibling = false;
  if (derive) {
    const int p = nd >> 1;
    const int built = active[p];
    sibling = nd != built;
    blt_g = hist + (size_t)built * fb;
    blt_h = hist + ((size_t)n_nodes + built) * fb;
    par_g = parent + (size_t)p * fb;
    par_h = parent + ((size_t)(n_nodes >> 1) + p) * fb;
  }

  float best = neg_inf();
  int best_i = INT_MAX;
  const int f_end = min(n_feat, (int)(blockIdx.x + 1) * kSliceFeatures);
  for (int f = blockIdx.x * kSliceFeatures + warp; f < f_end; f += kDecideWarps) {
    const size_t off = (size_t)f * n_bins;
    // Node nd's row: the built row in place, or the sibling parent - built,
    // written into the level histogram as it is read.
    auto load = [&](int, int b, float& gv, float& hv) {
      if (sibling) {
        gv = par_g[off + b] - blt_g[off + b];
        hv = par_h[off + b] - blt_h[off + b];
        row_g[off + b] = gv;
        row_h[off + b] = hv;
      } else {
        gv = blt_g[off + b];
        hv = blt_h[off + b];
      }
    };
    if (mask[f] != 0) {  // warp-uniform
      level_common::warp_scan_gain(n_bins, lam, min_h, load, [&](int, int b, float v) {
        take_better(v, f * n_bins + b, best, best_i);
      });
    } else if (sibling) {  // a masked feature's sibling row is only written
      for (int b = lane; b < n_bins; b += 32) {
        float gv, hv;
        load(0, b, gv, hv);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float g = __shfl_down_sync(full, best, o);
    const int i = __shfl_down_sync(full, best_i, o);
    take_better(g, i, best, best_i);
  }
  if (lane == 0) {
    s_gain[warp] = best;
    s_idx[warp] = best_i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kDecideWarps; ++w) take_better(s_gain[w], s_idx[w], best, best_i);
    const size_t at = (size_t)nd * gridDim.x + blockIdx.x;
    part_gain[at] = best;
    part_idx[at] = best_i;
  }
}

__global__ void __launch_bounds__(kRouteThreads)
level_route_kernel(const int* __restrict__ bins, const int* __restrict__ node,
                   const float* __restrict__ part_gain, const int* __restrict__ part_idx,
                   int slices, int n, int n_feat, int n_bins, int n_nodes,
                   int* __restrict__ feat_out, int* __restrict__ thr_out,
                   float* __restrict__ best_out, int* __restrict__ new_node) {
  extern __shared__ int table[];  // feat[n_nodes], then thr[n_nodes]
  for (int nd = threadIdx.x; nd < n_nodes; nd += blockDim.x) {
    float best = neg_inf();
    int idx = INT_MAX;
    for (int s = 0; s < slices; ++s) {
      const size_t at = (size_t)nd * slices + s;
      take_better(part_gain[at], part_idx[at], best, idx);
    }
    const bool ok = best > 0.f && best < -neg_inf();  // finite and > 0
    const int f = ok ? idx / n_bins : 0;
    const int t = ok ? idx % n_bins : n_bins - 1;
    table[nd] = f;
    table[n_nodes + nd] = t;
    if (blockIdx.x == 0) {
      feat_out[nd] = f;
      thr_out[nd] = t;
      best_out[nd] = best;
    }
  }
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int nd = node[s];
  int out = 2 * nd;
  if (nd >= 0) {
    const int c = min(nd, n_nodes - 1);
    out += bins[(size_t)s * n_feat + table[c]] > table[n_nodes + c];
  }
  new_node[s] = out;
}

}  // namespace

// hist (2, n_nodes, F, B), part (2 * n_nodes * ceil(F/32) words of scratch),
// work (N + 2 n_sub ints of scratch for phase A; feat_tile, warps and
// min_per_column its plan),
// feat / thr / best (n_nodes,), new_node (N,). In derive mode (derive != 0)
// n_sub = n_nodes / 2, active[p] is the built child of parent p and parent
// is the (2, n_sub, F, B) cache; otherwise active enumerates 0 .. n_nodes-1
// and parent is not read.
extern "C" int level_build_launch(const void* bins, const void* node, const void* grad,
                                  const void* hess, const void* active, const void* parent,
                                  const void* mask, void* hist, void* part, long long part_len,
                                  void* work, void* feat, void* thr, void* best,
                                  void* new_node, int n, int n_feat, int n_bins, int n_nodes,
                                  int n_sub, int derive, int feat_tile, int warps,
                                  int min_per_column, float lam,
                                  float min_h, void* stream) {
  const int slices = (n_feat + kSliceFeatures - 1) / kSliceFeatures;
  if (n_bins < 1 || n_bins > 32 * level_common::kMaxPer || n_nodes < 1 ||
      n_nodes > kMaxNodes || n_sub < 1 || (derive && 2 * n_sub != n_nodes) ||
      (!derive && n_sub != n_nodes) || slices < 1 || part_len < 2LL * n_nodes * slices)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;

  int code = level_common::hist_enqueue(
      (const int*)bins, (const int*)node, (const float*)grad, (const float*)hess,
      (const int*)active, (float*)hist, (int*)work, n, n_feat, n_bins, n_sub, n_nodes, true,
      feat_tile, warps, min_per_column, st);
  if (code != 0) return code;
  cudaError_t err;

  float* part_gain = (float*)part;
  int* part_idx = (int*)part + (size_t)n_nodes * slices;
  level_decide_kernel<<<dim3(slices, n_nodes), 32 * kDecideWarps, 0, st>>>(
      (float*)hist, (const float*)parent, (const int*)active, (const int*)mask, n_feat,
      n_bins, n_nodes, derive, lam, min_h, part_gain, part_idx);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int grid_c = std::max(1, (n + kRouteThreads - 1) / kRouteThreads);
  level_route_kernel<<<grid_c, kRouteThreads, 2 * n_nodes * (int)sizeof(int), st>>>(
      (const int*)bins, (const int*)node, part_gain, part_idx, slices, n, n_feat, n_bins,
      n_nodes, (int*)feat, (int*)thr, (float*)best, (int*)new_node);
  return (int)cudaGetLastError();
}
