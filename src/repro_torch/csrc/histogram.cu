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
// Design: a block owns 32 features (one per lane) x up to 4 node rows (one
// per warp; fewer when 256 bins would overflow shared memory). Each warp
// builds its row with level_common::warp_hist_row, which says how the adds
// stay in one fixed order without atomics. A warp whose node holds few
// samples still walks all N node ids; sorting rows by node would cut that
// and is left for a later change.
#include <cuda_runtime.h>

#include <algorithm>

#include "level_common.cuh"

namespace {

using level_common::kFeatTile;
constexpr int kMaxRowTile = 4;  // node rows per block, one per warp
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use

__global__ void __launch_bounds__(kFeatTile * kMaxRowTile)
hist_kernel(const int* __restrict__ bins, const int* __restrict__ node,
            const float* __restrict__ grad, const float* __restrict__ hess,
            const int* __restrict__ row_nodes, float* __restrict__ out,
            int n, int n_feat, int n_bins, int rows) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.y * (blockDim.x >> 5) + warp;
  if (r >= rows) return;  // warp-uniform; the block never synchronizes
  const int f0 = blockIdx.x * kFeatTile;
  float* acc_g = smem + (size_t)warp * 2 * n_bins * kFeatTile;
  level_common::warp_hist_row(bins, node, grad, hess, row_nodes[r], n, n_feat, n_bins, f0,
                              acc_g, acc_g + n_bins * kFeatTile, out, r, rows);
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
