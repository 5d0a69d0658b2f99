// Batched forest traversal: the masked forest sum of the serving predict.
//
// Replaces the TPU kernel repro/kernels/forest_traversal.py::
// forest_traverse_pallas (_traverse_kernel), f32 layout, one output.
//
// out[s] = sum over slots t < n_trees, in slot order, of
//   leaf[t][walk(s, t)], walk = depth steps of node = 2*node + 1 +
//   (bins[s][feature[t][node]] > threshold[t][node]) from node 0.
// Slots >= *n_trees (read on the device: no host sync) add nothing.
//
// Bound: bytes at serving sizes. Every bin, tree array and output is moved
// once; the walk is depth compares per (sample, tree), and the per-step
// bin gathers hit the sample's row in L1/L2.
//
// Design: a block owns 16 samples (x) and walks the forest 16 trees (y) at
// a time; each thread takes one (sample, tree) pair. The TPU transposes the
// tree arrays so its gathers are lane-friendly (forest_traversal.py:150);
// here the tree block (about 6 KB a tree at depth 9) is staged in shared
// memory and the walk reads it from there. The TPU sums across tree blocks
// in grid order; GPU blocks run in no order, so the sum stays inside the
// block: each pass writes its 16x16 leaf values to shared memory and one
// thread per sample adds them in slot order into a register. The result
// is therefore the tree-by-tree sequential sum, bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kSamples = 16;  // samples per block (threadIdx.x)
constexpr int kTrees = 16;    // trees per pass (threadIdx.y)
constexpr int kMaxDepth = 10;  // 16 trees of depth 10 take 193 KB of shared memory

__global__ void traverse_kernel(const int* __restrict__ bins, const int* __restrict__ feature,
                                const int* __restrict__ threshold,
                                const float* __restrict__ leaf, const int* __restrict__ n_trees,
                                float* __restrict__ out, int n, int n_feat, int slots,
                                int depth) {
  extern __shared__ int smem_i[];
  const int n_int = (1 << depth) - 1;
  const int n_leaf = 1 << depth;
  int* s_feat = smem_i;
  int* s_thr = s_feat + kTrees * n_int;
  float* s_leaf = reinterpret_cast<float*>(s_thr + kTrees * n_int);
  float* s_val = s_leaf + kTrees * n_leaf;

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSamples + tx;
  const int nthreads = kSamples * kTrees;
  const int s = blockIdx.x * kSamples + tx;
  const int live = min(max(*n_trees, 0), slots);
  const int* row = bins + (size_t)min(s, n - 1) * n_feat;

  float acc = 0.f;
  for (int t0 = 0; t0 < live; t0 += kTrees) {
    const int nt = min(kTrees, slots - t0);
    __syncthreads();  // the previous pass is done with the staged trees
    for (int i = tid; i < nt * n_int; i += nthreads) {
      s_feat[i] = feature[(size_t)t0 * n_int + i];
      s_thr[i] = threshold[(size_t)t0 * n_int + i];
    }
    for (int i = tid; i < nt * n_leaf; i += nthreads) s_leaf[i] = leaf[(size_t)t0 * n_leaf + i];
    __syncthreads();

    float v = 0.f;
    if (s < n && t0 + ty < live) {
      const int* f = s_feat + ty * n_int;
      const int* th = s_thr + ty * n_int;
      int node = 0;
      for (int d = 0; d < depth; ++d) node = 2 * node + 1 + (row[f[node]] > th[node]);
      v = s_leaf[ty * n_leaf + node - n_int];
    }
    s_val[ty * kSamples + tx] = v;
    __syncthreads();
    if (ty == 0) {
      for (int k = 0; k < kTrees; ++k) acc = acc + s_val[k * kSamples + tx];
    }
  }
  if (ty == 0 && s < n) out[s] = acc;
}

}  // namespace

extern "C" int forest_traverse_launch(const void* bins, const void* feature,
                                      const void* threshold, const void* leaf,
                                      const void* n_trees, void* out, int n, int n_feat,
                                      int slots, int depth, void* stream) {
  if (depth < 0 || depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  const int n_int = (1 << depth) - 1;
  const int smem = (int)sizeof(float) * kTrees * (2 * n_int + (n_int + 1) + kSamples);
  cudaError_t err = cudaFuncSetAttribute(
      traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kSamples, kTrees);
  const int grid = (n + kSamples - 1) / kSamples;
  traverse_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)bins, (const int*)feature, (const int*)threshold, (const float*)leaf,
      (const int*)n_trees, (float*)out, n, n_feat, slots, depth);
  return (int)cudaGetLastError();
}
