// Gradient/hessian histograms of one tree level, for a full level or for a
// subset of its nodes.
//
// Replaces the TPU kernel repro/kernels/histogram.py::histogram_pallas
// (_hist_kernel), which builds the histogram as a one-hot MXU matmul. On
// Hopper it is a gather-accumulate instead: no one-hot matrix exists.
//
// out[gh][r][f][b] = sum of grad (gh = 0) or hess (gh = 1) over the samples
// s with node[s] == row_nodes[r] (node r where row_nodes is null) and
// bins[s][f] == b. Samples on node -1, or on a node no row names, add
// nothing.
//
// Bound: bytes. The bin rows of the samples on the rows' nodes are read
// once and the (2, R, F, B) output written once; the adds are few per byte.
// At realsim width a full level reads 24 MB of bins and writes 768 KB per
// row; a deep subset level reads little and writes 98 MB, mostly zeros.
//
// Design (level_common::hist_launch: the fused level's list and histogram
// code, as a chain of plain launches): a stable counting pass lists each
// row's samples once, with their (grad, hess) beside them, so a block walks
// only its own row's samples; then one block an item, an item being one
// (feature tile, row, block of the row's samples); a warp's lanes are 8,
// 16 or 32 features x 4, 2 or 1 sample slots, and every lane column sums
// one chunk of the row's samples. Where the feature tiles and rows alone
// give the card too few blocks (a narrow F, a level of one row), a row's
// chunks are cut over several blocks, and the block that takes a (row,
// tile)'s last ticket adds their merged tiles in block order. The chunks
// are merged in shared memory in column order: no float atomics, and two
// launches give the same bits. The tile width, the warps a block and the
// blocks a row come from kernels/hist_plan.py.
#include <cuda_runtime.h>

#include "level_common.cuh"

namespace level_common {
namespace {

constexpr int kListThreads = 1024;

__global__ void __launch_bounds__(kListThreads) count_kernel(const LevelArgs a) {
  __shared__ int s32[32];
  count_row(a, blockIdx.x, a.work + work_of(a, false).cnt, s32);
}

__global__ void __launch_bounds__(kListThreads) place_kernel(const LevelArgs a) {
  __shared__ int s32[32];
  const Work w = work_of(a, false);
  if (a.splits > 1) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < (long long)a.rows * tiles_of(a); i += (long long)gridDim.x * blockDim.x)
      a.work[w.tickets + i] = 0;
  }
  place_row(a, blockIdx.x, w, s32);
}

// One block an item.
__global__ void __launch_bounds__(32 * kMaxWarps) tile_kernel(const LevelArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tiles = tiles_of(a);
  const long long rt = blockIdx.x / a.splits;
  build_tile<false>(a, (int)(rt % tiles), (int)(rt / tiles), (int)(blockIdx.x % a.splits),
                    tiles, work_of(a, false), smem, nullptr, nullptr);
}

// Enqueue the chain on st: the counts (levels of more than one row), the
// list, the items. Returns a cudaError_t.
int hist_launch(const LevelArgs& a, cudaStream_t st) {
  int code = check_args(a);
  if (code) return code;
  const int smem = a.warps * 2 * a.n_bins * 32 * 4;
  static int granted[kMaxDevices] = {};
  cudaError_t err = ensure_smem((const void*)tile_kernel, smem, granted);
  if (err != cudaSuccess) return (int)err;
  if (a.rows > 1) count_kernel<<<a.rows, kListThreads, 0, st>>>(a);
  place_kernel<<<a.rows, kListThreads, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_kernel<<<a.rows * tiles_of(a) * a.splits, 32 * a.warps, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace level_common

// out (2, rows, F, B); row_nodes (rows,) node ids, or null for node r at row
// r; work work_len ints of scratch (level_common::work_layout); feat_tile,
// warps, splits and min_per_column the plan of kernels/hist_plan.py.
extern "C" int histogram_launch(const void* bins, const void* node, const void* grad,
                                const void* hess, const void* row_nodes, void* out,
                                void* work, long long work_len, int n, int n_feat, int n_bins,
                                int rows, int feat_tile, int warps, int splits,
                                int min_per_column, void* stream) {
  const int tile_log2 = feat_tile == 32 ? 5 : feat_tile == 16 ? 4 : feat_tile == 8 ? 3 : -1;
  if (tile_log2 < 0 || n_feat < 1 || rows < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int tiles = (n_feat + feat_tile - 1) / feat_tile;
  if (work_len < level_common::work_layout(n, rows, tiles, splits, feat_tile, n_bins, 0,
                                           false).total)
    return (int)cudaErrorInvalidValue;
  level_common::LevelArgs a = {};
  a.bins = (const int*)bins;
  a.node = (const int*)node;
  a.grad = (const float*)grad;
  a.hess = (const float*)hess;
  a.active = (const int*)row_nodes;
  a.out = (float*)out;
  a.work = (int*)work;
  a.n = n;
  a.n_feat = n_feat;
  a.n_bins = n_bins;
  a.rows = rows;
  a.out_rows = rows;
  a.warps = warps;
  a.tile_log2 = tile_log2;
  a.splits = splits;
  a.min_per_column = min_per_column;
  return level_common::hist_launch(a, (cudaStream_t)stream);
}
