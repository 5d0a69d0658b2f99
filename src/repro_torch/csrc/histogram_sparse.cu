// Stored-entry gradient/hessian histograms from the feature-major sparse
// (ELL) store, for a full level or for a subset of its nodes.
//
// Replaces the TPU kernel repro/kernels/histogram_sparse.py::
// histogram_sparse_pallas (_sparse_hist_kernel), a batched one-hot MXU
// contraction over (F, C) entry tiles. On Hopper it is a gather-accumulate.
//
// out[gh][r][f][b] = sum of grad (gh = 0) or hess (gh = 1) over the stored
// entries c of feature f whose sample s = feat_rows[f][c] lies on node
// active[r] and whose code feat_codes[f][c] is b. ELL pads (s = -1),
// samples on node -1 and samples on a node no row names add nothing. The
// zero-bin complement (node total - stored row sum) is not this kernel's
// job: kernels/ops.py adds it after any reduce.
//
// Bound: bytes. It reads the (F, C) store and the node/grad/hess of the
// stored entries' samples, and writes the whole (2, R, F, B) output, zeros
// included. At realsim width (about 67 stored entries a feature) the
// output write is nearly all of it at every level past the root.
//
// Design: one block per (feature, tile of rows). The block holds its (rows,
// B) grad and hess tile in shared memory (at R = 128, B = 64: 64 KB) and an
// inverse map node -> row. It walks the feature's entries in ascending c,
// 256 at a time: each thread stages one entry (its cell r*B + code, grad,
// hess) in shared memory, then every thread walks the staged entries in
// order and adds those whose cell it owns (cell % 256 == thread). So each
// cell is added by one thread in one fixed order: no atomics, and two
// launches give the same bits. The block then writes its whole tile.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;       // a power of two: cell ownership is cell & (kThreads-1)
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr int kMaxNodes = 16384;    // the node -> row map lives in shared memory

__global__ void __launch_bounds__(kThreads)
sparse_hist_kernel(const int* __restrict__ feat_rows, const int* __restrict__ feat_codes,
                   const int* __restrict__ node, const float* __restrict__ grad,
                   const float* __restrict__ hess, const int* __restrict__ active,
                   float* __restrict__ out, int n_feat, int n_entries, int n_bins,
                   int n_nodes, int rows, int row_tile) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int f = blockIdx.x;
  const int r0 = blockIdx.y * row_tile;
  const int nr = min(row_tile, rows - r0);
  const int cells = nr * n_bins;
  float* tile_g = smem;
  float* tile_h = tile_g + (size_t)row_tile * n_bins;
  int* inv = (int*)(tile_h + (size_t)row_tile * n_bins);
  int* s_cell = inv + n_nodes;
  float* s_g = (float*)(s_cell + kThreads);
  float* s_h = s_g + kThreads;

  for (int i = tid; i < cells; i += kThreads) {
    tile_g[i] = 0.f;
    tile_h[i] = 0.f;
  }
  for (int i = tid; i < n_nodes; i += kThreads) inv[i] = -1;
  __syncthreads();
  for (int r = tid; r < nr; r += kThreads) inv[active[r0 + r]] = r;
  __syncthreads();

  const int* rows_f = feat_rows + (size_t)f * n_entries;
  const int* codes_f = feat_codes + (size_t)f * n_entries;
  for (int c0 = 0; c0 < n_entries; c0 += kThreads) {
    const int c = c0 + tid;
    int cell = -1;
    float g = 0.f, h = 0.f;
    if (c < n_entries) {
      const int s = rows_f[c];
      const int nd = s >= 0 ? node[s] : -1;
      const int r = (nd >= 0 && nd < n_nodes) ? inv[nd] : -1;
      const int code = codes_f[c];
      if (r >= 0 && (unsigned)code < (unsigned)n_bins) {
        cell = r * n_bins + code;
        g = grad[s];
        h = hess[s];
      }
    }
    s_cell[tid] = cell;
    s_g[tid] = g;
    s_h[tid] = h;
    __syncthreads();
    const int m = min(kThreads, n_entries - c0);
    for (int j = 0; j < m; ++j) {
      const int cl = s_cell[j];
      if (cl >= 0 && (cl & (kThreads - 1)) == tid) {
        tile_g[cl] += s_g[j];
        tile_h[cl] += s_h[j];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < cells; i += kThreads) {
    const int r = i / n_bins;
    const int b = i - r * n_bins;
    out[((size_t)(r0 + r) * n_feat + f) * n_bins + b] = tile_g[i];
    out[((size_t)(rows + r0 + r) * n_feat + f) * n_bins + b] = tile_h[i];
  }
}

}  // namespace

// out (2, rows, F, B); active (rows,) node ids in [0, n_nodes).
extern "C" int histogram_sparse_launch(const void* feat_rows, const void* feat_codes,
                                       const void* node, const void* grad, const void* hess,
                                       const void* active, void* out, int n_feat,
                                       int n_entries, int n_bins, int n_nodes, int rows,
                                       void* stream) {
  if (n_bins < 1 || n_nodes < 1 || n_nodes > kMaxNodes || rows < 1 || n_feat < 1)
    return (int)cudaErrorInvalidValue;
  const int fixed = (n_nodes + 3 * kThreads) * 4;
  const int row_tile = std::min(rows, (kSmemLimit - fixed) / (8 * n_bins));
  if (row_tile < 1) return (int)cudaErrorInvalidValue;
  const int smem = 8 * n_bins * row_tile + fixed;
  cudaError_t err = cudaFuncSetAttribute(
      sparse_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_feat, (rows + row_tile - 1) / row_tile);
  sparse_hist_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)feat_rows, (const int*)feat_codes, (const int*)node, (const float*)grad,
      (const float*)hess, (const int*)active, (float*)out, n_feat, n_entries, n_bins,
      n_nodes, rows, row_tile);
  return (int)cudaGetLastError();
}
