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
// Design (level_common::hist_enqueue, shared with the fused level): a
// stable counting pass lists each row's samples once, so a block walks only
// its own row's samples (the earlier design scanned all N node ids for every
// row). A block takes one (feature tile, row); a warp's lanes are 8, 16 or
// 32 features x 4, 2 or 1 sample slots, and every lane column sums one
// chunk of the row's samples, so a level of one row still spreads over the
// card (the earlier design ran 47 warps at level 0: now 188 blocks of 7
// warps). A row uses as many chunks as its count warrants, the loads run
// two batches ahead of the adds, and the chunks are merged in shared memory
// in column order: no float atomics, no partials in global memory, and two
// launches give the same bits. The tile width and the warps a block come
// from kernels/hist_plan.py.
#include <cuda_runtime.h>

#include "level_common.cuh"

// out (2, rows, F, B); row_nodes (rows,) node ids, or null for node r at row
// r; work n + 2 rows ints of scratch; feat_tile, warps and min_per_column
// the plan of kernels/hist_plan.py.
extern "C" int histogram_launch(const void* bins, const void* node, const void* grad,
                                const void* hess, const void* row_nodes, void* out,
                                void* work, int n, int n_feat, int n_bins, int rows,
                                int feat_tile, int warps, int min_per_column,
                                void* stream) {
  return level_common::hist_enqueue(
      (const int*)bins, (const int*)node, (const float*)grad, (const float*)hess,
      (const int*)row_nodes, (float*)out, (int*)work, n, n_feat, n_bins, rows, rows, false,
      feat_tile, warps, min_per_column, (cudaStream_t)stream);
}
