// Batched forest traversal: the masked forest sum of the serving predict.
//
// Replaces the TPU kernel repro/kernels/forest_traversal.py::
// forest_traverse_pallas (_traverse_kernel), in all its forms: the f32
// layout, the quantized layouts of Forest.quantize (int8 thresholds and
// int8 leaves times a per-tree scale; int16 thresholds and fp16 leaves)
// and K > 1 outputs.
//
// out[s][t % K] += leaf[t][walk(s, t)] over slots t < n_trees, in slot
//   order; walk = depth steps of node = 2*node + 1 +
//   (bins[s][feature[t][node]] > threshold[t][node]) from node 0.
// Slots >= *n_trees (read on the device: no host sync) add nothing.
//
// Bound: bytes at serving sizes. Every bin, tree array and output is moved
// once; the walk is depth compares per (sample, tree), and the per-step
// bin gathers hit the sample's row in L1/L2. A quantized forest moves
// fewer tree bytes (int8: a quarter of the thresholds and leaves).
//
// Design: a block owns 16 samples (x) and walks the forest 16 trees (y) at
// a time; each thread takes one (sample, tree) pair. The TPU transposes the
// tree arrays so its gathers are lane-friendly (forest_traversal.py:150);
// here the tree block is staged in shared memory as it arrives (int32
// features; thresholds and leaves in their packed types; the per-tree f32
// scale of int8 leaves) and the walk widens at use: a threshold to int
// before the compare, an int8 leaf to (float)q * scale, an fp16 leaf by
// __half2float. The TPU sums across tree blocks in grid order; GPU blocks
// run in no order, so the sum stays inside the block: each pass writes its
// 16x16 leaf values to shared memory and one thread per sample adds them
// in slot order, into a register (K = 1) or, for K outputs, into a
// (16 samples x K) shared tile whose row that thread owns (a register
// array indexed by the slot's column would spill to local memory). Built
// with --fmad=false, the int8 product rounds once and the add once, so the
// result is the plain version's (dequantize, then sum tree by tree) bit for
// bit. The f32 one-output form runs its own kernel, the same design without
// the packed types and the tile (traverse_f32_kernel).
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kSamples = 16;    // samples per block (threadIdx.x)
constexpr int kTrees = 16;      // trees per pass (threadIdx.y)
constexpr int kMaxDepth = 10;   // 16 f32 trees of depth 10 take 193 KB of shared memory
constexpr int kMaxOutputs = 64; // the (16 x K) accumulator tile: at most 4 KB

// Shared-memory layout of one pass, in bytes; each array starts on a
// 16-byte boundary, so every packed type stays aligned. The host
// sizes the allocation and the kernel finds its arrays with this one
// function.
struct Layout {
  int feat, thr, leaf, scale, val, acc, total;
};

__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }

__host__ __device__ inline Layout layout(int depth, int thr_bytes, int leaf_bytes, int n_out) {
  const int n_int = (1 << depth) - 1, n_leaf = 1 << depth;
  Layout l;
  l.feat = 0;
  l.thr = align16(l.feat + 4 * kTrees * n_int);
  l.leaf = align16(l.thr + thr_bytes * kTrees * n_int);
  l.scale = align16(l.leaf + leaf_bytes * kTrees * n_leaf);
  l.val = align16(l.scale + 4 * kTrees);
  l.acc = align16(l.val + 4 * kTrees * kSamples);
  l.total = align16(l.acc + (n_out > 1 ? 4 * kSamples * n_out : 0));
  return l;
}

// A staged leaf widened to f32 (the scale is read for int8 leaves only).
__device__ __forceinline__ float widen_leaf(const float* s_leaf, int i, const float*, int) {
  return s_leaf[i];
}
__device__ __forceinline__ float widen_leaf(const int8_t* s_leaf, int i, const float* s_scale,
                                            int tree) {
  return (float)s_leaf[i] * s_scale[tree];
}
__device__ __forceinline__ float widen_leaf(const __half* s_leaf, int i, const float*, int) {
  return __half2float(s_leaf[i]);
}

// The f32 layout with one output keeps its own kernel, the one this file
// held before the other forms were added: on an H100 (700 W) the template
// below, instantiated for it, ran 10-12% slower with the same registers and
// nearly the same instructions (ptxas scheduled the staging loads less
// well), so the template serves the other forms only.
__global__ void traverse_f32_kernel(const int* __restrict__ bins,
                                    const int* __restrict__ feature,
                                    const int* __restrict__ threshold,
                                    const float* __restrict__ leaf,
                                    const int* __restrict__ n_trees, float* __restrict__ out,
                                    int n, int n_feat, int slots, int depth) {
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

// The other forms. kMulti: K > 1 outputs (the shared accumulator tile) or
// one (a register).
template <typename Thr, typename Leaf, bool kMulti>
__global__ void traverse_kernel(const int* __restrict__ bins, const int* __restrict__ feature,
                                const Thr* __restrict__ threshold,
                                const Leaf* __restrict__ leaf,
                                const float* __restrict__ scale,  // (slots,) or null
                                const int* __restrict__ n_trees, float* __restrict__ out,
                                int n, int n_feat, int slots, int depth, int n_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_int = (1 << depth) - 1;
  const int n_leaf = 1 << depth;
  const Layout l = layout(depth, sizeof(Thr), sizeof(Leaf), n_out);
  int* s_feat = reinterpret_cast<int*>(smem + l.feat);
  Thr* s_thr = reinterpret_cast<Thr*>(smem + l.thr);
  Leaf* s_leaf = reinterpret_cast<Leaf*>(smem + l.leaf);
  float* s_scale = reinterpret_cast<float*>(smem + l.scale);
  float* s_val = reinterpret_cast<float*>(smem + l.val);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSamples + tx;
  const int nthreads = kSamples * kTrees;
  const int s = blockIdx.x * kSamples + tx;
  const int live = min(max(*n_trees, 0), slots);
  const int* row = bins + (size_t)min(s, n - 1) * n_feat;
  constexpr bool kScaled = sizeof(Leaf) == 1;  // int8 leaves carry a per-tree scale
  // Thread (tx, 0) owns row tx of the accumulator tile, so only it touches
  // that row and no barrier is needed around it.
  float* acc_row = reinterpret_cast<float*>(smem + l.acc) + tx * n_out;
  if (kMulti && ty == 0) {
    for (int k = 0; k < n_out; ++k) acc_row[k] = 0.f;
  }

  float acc = 0.f;
  for (int t0 = 0; t0 < live; t0 += kTrees) {
    const int nt = min(kTrees, slots - t0);
    __syncthreads();  // the previous pass is done with the staged trees
    for (int i = tid; i < nt * n_int; i += nthreads) {
      s_feat[i] = feature[(size_t)t0 * n_int + i];
      s_thr[i] = threshold[(size_t)t0 * n_int + i];
    }
    for (int i = tid; i < nt * n_leaf; i += nthreads) s_leaf[i] = leaf[(size_t)t0 * n_leaf + i];
    if (kScaled && tid < nt) s_scale[tid] = scale[t0 + tid];
    __syncthreads();

    float v = 0.f;
    if (s < n && t0 + ty < live) {
      const int* f = s_feat + ty * n_int;
      const Thr* th = s_thr + ty * n_int;
      int node = 0;
      for (int d = 0; d < depth; ++d) node = 2 * node + 1 + (row[f[node]] > (int)th[node]);
      v = widen_leaf(s_leaf, ty * n_leaf + node - n_int, s_scale, ty);
    }
    s_val[ty * kSamples + tx] = v;
    __syncthreads();
    if (ty == 0) {
      if (!kMulti) {
        for (int k = 0; k < kTrees; ++k) acc = acc + s_val[k * kSamples + tx];
      } else {
        int col = t0 % n_out;  // slot t0 + k adds into column (t0 + k) % K
        for (int k = 0; k < kTrees; ++k) {
          acc_row[col] = acc_row[col] + s_val[k * kSamples + tx];
          col = col + 1 == n_out ? 0 : col + 1;
        }
      }
    }
  }
  if (ty == 0 && s < n) {
    if (!kMulti) {
      out[s] = acc;
    } else {
      for (int k = 0; k < n_out; ++k) out[(size_t)s * n_out + k] = acc_row[k];
    }
  }
}

template <typename Thr, typename Leaf, bool kMulti>
int launch_form(const void* bins, const void* feature, const void* threshold,
                const void* leaf, const void* scale, const void* n_trees, void* out, int n,
                int n_feat, int slots, int depth, int n_out, cudaStream_t stream) {
  const int smem = layout(depth, sizeof(Thr), sizeof(Leaf), n_out).total;
  cudaError_t err = cudaFuncSetAttribute(
      traverse_kernel<Thr, Leaf, kMulti>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kSamples, kTrees);
  const int grid = (n + kSamples - 1) / kSamples;
  traverse_kernel<Thr, Leaf, kMulti><<<grid, block, smem, stream>>>(
      (const int*)bins, (const int*)feature, (const Thr*)threshold, (const Leaf*)leaf,
      (const float*)scale, (const int*)n_trees, (float*)out, n, n_feat, slots, depth, n_out);
  return (int)cudaGetLastError();
}

int launch_f32(const void* bins, const void* feature, const void* threshold,
               const void* leaf, const void* n_trees, void* out, int n, int n_feat,
               int slots, int depth, cudaStream_t stream) {
  const int n_int = (1 << depth) - 1;
  const int smem = (int)sizeof(float) * kTrees * (2 * n_int + (n_int + 1) + kSamples);
  cudaError_t err = cudaFuncSetAttribute(
      traverse_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 block(kSamples, kTrees);
  const int grid = (n + kSamples - 1) / kSamples;
  traverse_f32_kernel<<<grid, block, smem, stream>>>(
      (const int*)bins, (const int*)feature, (const int*)threshold, (const float*)leaf,
      (const int*)n_trees, (float*)out, n, n_feat, slots, depth);
  return (int)cudaGetLastError();
}

template <typename Thr, typename Leaf>
int launch(const void* bins, const void* feature, const void* threshold, const void* leaf,
           const void* scale, const void* n_trees, void* out, int n, int n_feat, int slots,
           int depth, int n_out, cudaStream_t stream) {
  if (n_out > 1)
    return launch_form<Thr, Leaf, true>(bins, feature, threshold, leaf, scale, n_trees, out,
                                        n, n_feat, slots, depth, n_out, stream);
  if constexpr (std::is_same<Thr, int>::value && std::is_same<Leaf, float>::value)
    return launch_f32(bins, feature, threshold, leaf, n_trees, out, n, n_feat, slots, depth,
                      stream);
  else
    return launch_form<Thr, Leaf, false>(bins, feature, threshold, leaf, scale, n_trees, out,
                                         n, n_feat, slots, depth, n_out, stream);
}

}  // namespace

// layout: 0 f32 (int32 thresholds, f32 leaves), 1 int8 (int8 thresholds,
// int8 leaves; ``scale`` holds the per-tree f32 scales), 2 fp16 (int16
// thresholds, fp16 leaves). ``out`` is (n,) for n_out = 1, else (n, n_out)
// row-major.
extern "C" int forest_traverse_launch(const void* bins, const void* feature,
                                      const void* threshold, const void* leaf,
                                      const void* scale, const void* n_trees, void* out,
                                      int n, int n_feat, int slots, int depth, int n_out,
                                      int layout, void* stream) {
  if (depth < 0 || depth > kMaxDepth || n_out < 1 || n_out > kMaxOutputs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (layout) {
    case 0:
      return launch<int, float>(bins, feature, threshold, leaf, nullptr, n_trees, out, n,
                                n_feat, slots, depth, n_out, st);
    case 1:
      if (scale == nullptr) return (int)cudaErrorInvalidValue;
      return launch<int8_t, int8_t>(bins, feature, threshold, leaf, scale, n_trees, out, n,
                                    n_feat, slots, depth, n_out, st);
    case 2:
      return launch<int16_t, __half>(bins, feature, threshold, leaf, nullptr, n_trees, out, n,
                                     n_feat, slots, depth, n_out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
