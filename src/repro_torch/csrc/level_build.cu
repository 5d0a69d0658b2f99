// One whole tree level: the built nodes' histograms, the sibling derivation,
// the gain scan under the feature mask, the first-max argmax with the
// pass-left fix, and the re-route of every sample.
//
// Replaces the TPU kernel repro/kernels/level_build.py::level_build_pallas
// (_level_kernel), one Pallas program whose grid runs the phases in order
// and keeps the level in VMEM. Hopper's blocks run in no order and share no
// scratch, so the level is one cooperative launch of a persistent grid,
// level_common::level_kernel, whose blocks meet at grid barriers:
//
//  0 the row-sorted sample list of the built rows (one barrier after the
//    counts where the level has more than one row, one after the list);
//  A+B every (built row, feature tile, block of the row's samples) item
//    sums its chunks in shared memory (build_tile: the staged histogram's
//    own code, plan and merge order, kernels/hist_plan.py), and the block
//    that merges the row's tile keeps it in shared memory and decides on
//    it at once (decide_tile): in derive mode it reads parent row r's tile,
//    forms the sibling parent - built, writes both rows to the level
//    histogram (the next level's parent cache), scans both nodes' masked
//    features with level_common::warp_scan_gain_rows (scan_rows, the
//    split-gain kernel's code) and writes one (max gain, smallest flat index f*B+b) partial per
//    (node, tile). The built rows never go back through global memory to be
//    scanned, as the TPU program kept them in VMEM; the gain surface is
//    never stored;
//  C after the last barrier every block reduces the partials, applies the
//    pass-left fix into a shared table (block 0 writes feat / thr /
//    best_gain) and routes one sample per thread.
//
// So a fused level gives the staged chain's bits exactly: the histogram
// kernel, parent - built, the split-gain kernel, the masked first-max
// argmax and the partition. The grid holds as many blocks as the card runs
// at once (at most one per item); a grid the card cannot hold is refused at
// launch, and the C entry point returns the error.
//
// Bound: bytes. The level reads the node ids, the bin rows and grad/hess
// of samples on built nodes, the parent cache, one bin per sample, and
// writes the level histogram, the split vectors and the new node ids; the
// scan is about a dozen flops per cell.
#include <cuda_runtime.h>

#include <climits>

#include "level_common.cuh"

namespace level_common {
namespace {

// One launch: phase 0 (the row-sorted list: the counts, where the level has
// more than one row, then the placement), phase 1 (every (row, feature tile,
// block) item: build_tile, and decide_tile in the block that holds the
// merged row) and the route phase; a grid barrier after each phase. A block
// has kMaxWarps warps whatever the plan's warps (the lane columns, so the
// bits): the others join the list, the decide step and the route. The grid
// is persistent: block i takes items i, i + grid, ... of each phase, so the
// items, and the bits, do not depend on the grid's size.
__global__ void __launch_bounds__(32 * kMaxWarps, 2) level_kernel(const LevelArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s32[32];
  __shared__ int s_mask[32];
  cg::grid_group grid = cg::this_grid();
  const int tiles = tiles_of(a);
  const Work w = work_of(a, true);

  if (a.splits > 1) {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < (long long)a.rows * tiles; i += (long long)gridDim.x * blockDim.x)
      a.work[w.tickets + i] = 0;
  }
  if (a.rows > 1) {
    for (int r = blockIdx.x; r < a.rows; r += gridDim.x) count_row(a, r, a.work + w.cnt, s32);
    grid.sync();
  }
  for (int r = blockIdx.x; r < a.rows; r += gridDim.x) place_row(a, r, w, s32);
  grid.sync();

  float* M = smem + (size_t)a.warps * 2 * a.n_bins * 32;
  const long long items = (long long)a.rows * tiles * a.splits;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int k = (int)(it % a.splits);
    const long long rt = it / a.splits;
    const int t = (int)(rt % tiles), r = (int)(rt / tiles);
    if (build_tile<true>(a, t, r, k, tiles, w, smem, M, s_mask))
      decide_tile(a, t, r, tiles, w, M, smem, s_mask);
    __syncthreads();  // the shared tiles are the next item's
  }
  grid.sync();
  route(a, tiles, w, reinterpret_cast<int*>(smem));
}

// Launch the fused level on st: a cooperative grid as many blocks as the
// items of its largest phase, at most as many as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at most grid_cap where
// grid_cap > 0. A grid the card cannot hold at once is refused by the
// launch, never split. Returns a cudaError_t.
int level_launch(const LevelArgs& a, int grid_cap, cudaStream_t st) {
  int code = check_args(a);
  if (code) return code;
  if (a.n_bins > 32 * kMaxPer || a.n_nodes < 1 || a.n_nodes > kMaxNodes ||
      (a.derive && (2 * a.rows != a.n_nodes || !a.parent)) ||
      (!a.derive && a.rows != a.n_nodes) || !a.mask || !a.active || grid_cap < 0)
    return (int)cudaErrorInvalidValue;
  // The plan's warps' tiles and the merged tile M (the route's split table
  // reuses them).
  long long smem = (long long)a.warps * 2 * a.n_bins * 32 * 4 +
                   2LL * (1 << a.tile_log2) * a.n_bins * 4;
  if (8LL * a.n_nodes > smem) smem = 8LL * a.n_nodes;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)level_kernel;
  const int threads = 32 * kMaxWarps;
  static int granted[kMaxDevices] = {};
  cudaError_t err = ensure_smem(kernel, (int)smem, granted);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                           (size_t)smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long want = (long long)a.rows * tiles_of(a) * a.splits;
  const long long route_blocks = (a.n + threads - 1) / threads;
  if (route_blocks > want) want = route_blocks;
  long long grid = want < (long long)per_sm * sms ? want : (long long)per_sm * sms;
  if (grid_cap > 0 && grid > grid_cap) grid = grid_cap;
  if (grid < 1) grid = 1;
  LevelArgs args = a;
  void* params[] = {&args};
  return (int)cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid), dim3(threads), params,
                                          (size_t)smem, st);
}

}  // namespace
}  // namespace level_common

// hist (2, n_nodes, F, B); work work_len ints of scratch
// (level_common::work_layout); feat / thr / best (n_nodes,), new_node (N,).
// In derive mode (derive != 0) n_sub = n_nodes / 2, active[p] is the built
// child of parent p and parent is the (2, n_sub, F, B) cache; otherwise
// active enumerates 0 .. n_nodes-1 and parent is not read. feat_tile,
// warps, splits and min_per_column are the plan of kernels/hist_plan.py;
// grid_cap > 0 caps the persistent grid (the bits do not depend on it).
extern "C" int level_build_launch(const void* bins, const void* node, const void* grad,
                                  const void* hess, const void* active, const void* parent,
                                  const void* mask, void* hist, void* work,
                                  long long work_len, void* feat, void* thr, void* best,
                                  void* new_node, int n, int n_feat, int n_bins, int n_nodes,
                                  int n_sub, int derive, int feat_tile, int warps, int splits,
                                  int min_per_column, int grid_cap, float lam, float min_h,
                                  void* stream) {
  const int tile_log2 = feat_tile == 32 ? 5 : feat_tile == 16 ? 4 : feat_tile == 8 ? 3 : -1;
  if (tile_log2 < 0 || n_sub < 1 || (derive && 2 * n_sub != n_nodes) ||
      (!derive && n_sub != n_nodes) || n_feat < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n_feat + feat_tile - 1) / feat_tile;
  if (work_len < level_common::work_layout(n, n_sub, tiles, splits, feat_tile, n_bins,
                                           n_nodes, true).total)
    return (int)cudaErrorInvalidValue;
  level_common::LevelArgs a = {};
  a.bins = (const int*)bins;
  a.node = (const int*)node;
  a.grad = (const float*)grad;
  a.hess = (const float*)hess;
  a.active = (const int*)active;
  a.parent = derive ? (const float*)parent : nullptr;
  a.mask = (const int*)mask;
  a.out = (float*)hist;
  a.work = (int*)work;
  a.feat = (int*)feat;
  a.thr = (int*)thr;
  a.best = (float*)best;
  a.new_node = (int*)new_node;
  a.n = n;
  a.n_feat = n_feat;
  a.n_bins = n_bins;
  a.rows = n_sub;
  a.out_rows = n_nodes;
  a.n_nodes = n_nodes;
  a.derive = derive != 0;
  a.warps = warps;
  a.tile_log2 = tile_log2;
  a.splits = splits;
  a.min_per_column = min_per_column;
  a.lam = lam;
  a.min_h = min_h;
  return level_common::level_launch(a, grid_cap, (cudaStream_t)stream);
}
