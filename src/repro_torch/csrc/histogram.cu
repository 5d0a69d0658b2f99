// Gradient/hessian histograms of one tree level, for a full level or for a
// subset of its nodes.
//
// Replaces the TPU kernel repro/kernels/histogram.py::histogram_pallas
// (_hist_kernel), which builds the histogram as a one-hot MXU matmul. On
// Hopper it is a gather-accumulate instead: no one-hot matrix exists.
//
// out[gh][r][f][b] = sum of grad (gh = 0) or hess (gh = 1) over the samples
// s with node[s] == row_nodes[r] and bins[s][f] == b. Samples on node -1,
// or on a node no row names, add nothing.
//
// Bound: bytes. The (N, F) bin matrix is read once per row tile and the
// (2, R, F, B) output written once; the adds are few per byte.
//
// Design:
//  * a block owns 32 features (one per lane) x up to 4 node rows (one per
//    warp; fewer when 256 bins would overflow shared memory);
//    each warp accumulates its row into a private shared-memory tile, so
//    no two threads ever add into one cell: no atomics, anywhere;
//  * each warp walks the samples in ascending order (32 node ids at a
//    time, one ballot; the hits in lane order), so every cell's adds run
//    in one fixed order and two launches give identical bits;
//  * hits are taken 8 at a time: their bin/grad/hess loads all start
//    before the adds, to hide the global-memory latency;
//  * the tile is [gh][bin][32 lanes] with the lane index XOR-swizzled by
//    the bin, so the accumulate (lanes differ in bin) and the write-out
//    (lanes walk consecutive bins of one feature, stored coalesced) both
//    spread over the 32 banks.
// A warp whose node holds few samples still walks all N node ids; sorting
// rows by node would cut that and is left for a later change.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kFeatTile = 32;  // features per block, one per lane
constexpr int kMaxRowTile = 4;  // node rows per block, one per warp
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr int kBatch = 8;      // hits whose loads start together

__device__ __forceinline__ int swz(int b, int lane) { return b * kFeatTile + (lane ^ (b & 31)); }

__global__ void __launch_bounds__(kFeatTile * kMaxRowTile)
hist_kernel(const int* __restrict__ bins, const int* __restrict__ node,
            const float* __restrict__ grad, const float* __restrict__ hess,
            const int* __restrict__ row_nodes, float* __restrict__ out,
            int n, int n_feat, int n_bins, int rows) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.y * (blockDim.x >> 5) + warp;
  if (r >= rows) return;  // warp-uniform; the block never synchronizes
  const int f0 = blockIdx.x * kFeatTile;
  const int f = f0 + lane;
  const bool f_ok = f < n_feat;
  float* acc_g = smem + (size_t)warp * 2 * n_bins * kFeatTile;
  float* acc_h = acc_g + n_bins * kFeatTile;
  for (int i = lane; i < 2 * n_bins * kFeatTile; i += 32) acc_g[i] = 0.f;
  __syncwarp();

  const int target = row_nodes[r];
  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + lane;
    unsigned mask = __ballot_sync(0xffffffffu, s < n && node[s] == target);
    while (mask) {
      int b[kBatch];
      float g[kBatch], h[kBatch];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        b[u] = -1;
        g[u] = 0.f;
        h[u] = 0.f;
        if (mask) {
          const int ss = s0 + __ffs(mask) - 1;
          mask &= mask - 1;
          b[u] = f_ok ? bins[(size_t)ss * n_feat + f] : -1;
          g[u] = grad[ss];
          h[u] = hess[ss];
          cnt = u + 1;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < cnt && (unsigned)b[u] < (unsigned)n_bins) {
          acc_g[swz(b[u], lane)] += g[u];
          acc_h[swz(b[u], lane)] += h[u];
        }
      }
    }
  }
  __syncwarp();

  // The (f0 .. f0+31, every bin) block of one output row is contiguous.
  const int nf = n_feat - f0 < kFeatTile ? n_feat - f0 : kFeatTile;
  for (int gh = 0; gh < 2; ++gh) {
    float* dst = out + ((size_t)(gh * rows + r) * n_feat + f0) * n_bins;
    const float* src = gh ? acc_h : acc_g;
    for (int i = lane; i < nf * n_bins; i += 32) {
      const int fl = i / n_bins;
      dst[i] = src[swz(i - fl * n_bins, fl)];
    }
  }
}

}  // namespace

extern "C" int histogram_launch(const void* bins, const void* node, const void* grad,
                                const void* hess, const void* row_nodes, void* out,
                                int n, int n_feat, int n_bins, int rows, void* stream) {
  const int row_bytes = 2 * n_bins * kFeatTile * (int)sizeof(float);
  const int row_tile = std::min(kMaxRowTile, kSmemLimit / row_bytes);
  if (row_tile < 1) return (int)cudaErrorInvalidValue;
  const int smem = row_tile * row_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_feat + kFeatTile - 1) / kFeatTile, (rows + row_tile - 1) / row_tile);
  hist_kernel<<<grid, kFeatTile * row_tile, smem, (cudaStream_t)stream>>>(
      (const int*)bins, (const int*)node, (const float*)grad, (const float*)hess,
      (const int*)row_nodes, (float*)out, n, n_feat, n_bins, rows);
  return (int)cudaGetLastError();
}
