// Batched forest traversal: the masked forest sum of the serving predict.
//
// Replaces the TPU kernel repro/kernels/forest_traversal.py::
// forest_traverse_pallas (_traverse_kernel), in all its forms: the f32
// layout, the quantized layouts of Forest.quantize (int8 thresholds and
// int8 leaves times a per-tree scale; int16 thresholds and fp16 leaves)
// and K > 1 outputs, one template for all six.
//
// out[s][t % K] += leaf[t][walk(s, t)] over slots t < n_trees, in slot
//   order; walk = depth steps of node = 2*node + 1 +
//   (bins[s][feature[t][node]] > threshold[t][node]) from node 0.
// Slots >= *n_trees (read on the device: no host sync) add nothing.
//
// Bound: bytes (each bin cell a walk reads, each live tree and the output
// once). What bounds this design on an H100 is what it moves from L2 to
// the SMs and the walk's dependent shared-memory loads: every sample tile
// reads the whole forest (at realsim's 4000 x 400, depth 9: 32 tiles x 2.4
// MB), every tree group restages its tile's rows, and a step is two loads
// in a chain (node word, then bin). PERF.md has the cut-out measurements.
//
// Design (three kernels a slab of rows; launch plan from
// kernels/traversal_plan.py, checked again here):
//  1. narrow_kernel: the slab's int32 bins become u8 rows of an odd number
//     of words (32 samples that read one feature hit 32 banks), a warp a
//     row. A cell outside [0, 254] becomes the sentinel 255 and flags its
//     row: a walk then reads that cell from the int32 row and compares it
//     with the exact threshold, so no bin value ever wraps. A warp whose
//     rows hold no sentinel walks without the check.
//  2. walk_staged: a block owns `samples` rows (a lane each) and a group of
//     consecutive slots. The rows' u8 bins come into shared memory once by
//     cp.async; the group's trees come `chunk` at a time, each node packed
//     into one word (feature << 8 | threshold + 1 clamped to [0, 255]: for
//     a staged bin b, b >= that byte is b > threshold), the next one or two
//     chunks' loads in flight in registers while the block walks this one.
//     So both dependent loads of a step hit shared memory, and a tree is
//     read from L2 once a sample tile, not once every 16 samples (the
//     previous kernel staged every tree for each 16 samples: 600 MB at
//     realsim).
//     The tree axis is split over blocks until the grid fills one wave of
//     the card (a 256-row serving wave is a single sample tile). walk_global
//     is the same walk with rows and trees read through L1, for rows too
//     wide for 32 of them to fit in shared memory.
//     So that the per-sample sum stays one sequential chain across the
//     split, each walk writes its leaf, widened to f32 as the plain version
//     widens it ((float)q * scale[t] rounded once, fp16 exactly), to a
//     (slots, rows) scratch that stays in L2.
//  3. sum_kernel: each (sample, column) chain adds its leaves in slot
//     order, slot t into column t % K, acc = acc + v from acc = 0: the
//     plain version's sum tree by tree. Built with --fmad=false, nothing
//     fuses, so every output is the plain version's bit for bit. A dead
//     slot adds +0 there, which changes no sum that starts at +0, so the
//     chain stops at n_trees. No atomics, no order that depends on
//     scheduling: the same inputs give the same bits on every launch.
// The f32 one-output form runs the template like the others (the previous
// design kept a kernel of its own for it, 10-12% faster than its template).
// No tensor-core products here: the walk is integer compares and gathers.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxDepth = 10;
constexpr int kMaxOutputs = 64;
// Nodes and leaves a thread stages a chunk, with one chunk's loads in flight
// (two blocks an SM: 64 registers a thread) or two (one block an SM).
__host__ __device__ constexpr int stage_of(int ahead) { return ahead == 2 ? 8 : 6; }
constexpr int kSentinel = 255;      // a staged cell whose bin is in the int32 row
constexpr int kMaxThreads = 512;    // the walk kernels' launch bound
constexpr int kSmemLimit = 232448;  // shared bytes a block may use (H100)
constexpr int kMaxTiles = 65535;    // grid.y
constexpr int kMaxSlab = 1 << 22;   // rows a slab, so rows x K chains stay an int
constexpr int kScratchAlign = 256;
constexpr int kNarrowThreads = 64;  // two rows a block: short rows still spread over the SMs
constexpr int kSumBatch = 32;       // a chain's leaves a cp.async batch
constexpr int kSumRing = 12;        // batches in flight (48 KB of shared memory)
constexpr int kSumWarps = 4;        // warps a sum block: one adds, all copy

// Rows [0, rows) of `bins` (F int32 a row) as u8 words, row_words a row, for
// rows [0, rows_pad): cells past F and rows past `rows` are 0. A warp a
// row; flags[r] says whether row r holds a sentinel (a bin outside [0, 254]).
__global__ void __launch_bounds__(kNarrowThreads)
narrow_kernel(const int* __restrict__ bins, uint32_t* __restrict__ out, int* __restrict__ flags,
              int rows, int rows_pad, int n_feat, int row_words) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const bool vec = n_feat % 4 == 0 && (reinterpret_cast<uintptr_t>(bins) & 15) == 0;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < rows_pad; r += gridDim.x * warps) {
    bool hit = false;
#pragma unroll 4
    for (int w = lane; w < row_words; w += 32) {
      const int c0 = 4 * w;
      uint32_t word = 0;
      if (r < rows) {
        const int* src = bins + (size_t)r * n_feat + c0;
        int b[4];
        if (vec && c0 + 4 <= n_feat) {
          const int4 q = __ldg(reinterpret_cast<const int4*>(src));
          b[0] = q.x, b[1] = q.y, b[2] = q.z, b[3] = q.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = c0 + j < n_feat ? __ldg(src + j) : 0;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool fits = (unsigned)b[j] < (unsigned)kSentinel;
          hit |= !fits;
          word |= (uint32_t)(fits ? b[j] : kSentinel) << (8 * j);
        }
      }
      out[(size_t)r * row_words + w] = word;
    }
    hit = __any_sync(0xffffffffu, hit);
    if (lane == 0) flags[r] = hit;
  }
}

// A leaf widened to f32 as the plain version dequantizes it: an int8 leaf
// times its tree's scale (one rounding), an fp16 leaf exactly.
__device__ __forceinline__ float widen(float v, const float*, int) { return v; }
__device__ __forceinline__ float widen(int8_t q, const float* scale, int t) {
  return (float)q * __ldg(scale + t);
}
__device__ __forceinline__ float widen(__half v, const float*, int) { return __half2float(v); }

// A staged node: feature << 8 | t1, t1 = threshold + 1 clamped to [0, 255].
// Against a staged bin b in [0, 254], b >= t1 is b > threshold.
__device__ __forceinline__ uint32_t pack_node(int f, int th) {
  return ((uint32_t)f << 8) | (uint32_t)(th < 0 ? 0 : th >= 255 ? 255 : th + 1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Shared bytes of a staged walk block: the rows, then `chunk` trees' packed
// nodes, then their leaves (each part 16-byte aligned).
__host__ __device__ inline int align16(int b) { return (b + 15) & ~15; }
__host__ __device__ inline int staged_smem(int samples, int row_bytes, int chunk, int depth,
                                           int leaf_bytes) {
  return align16(samples * row_bytes) + align16(chunk * ((1 << depth) - 1) * 4) +
         chunk * (1 << depth) * leaf_bytes;
}

// A chunk of trees on its way to shared memory: the kStage nodes and
// leaves this thread stages, loaded while the block walks the chunk before.
template <typename Thr, typename Leaf, int kStage>
struct Prefetch {
  int f[kStage], th[kStage];
  Leaf l[kStage];

  __device__ __forceinline__ void load(const int* feature, const Thr* threshold,
                                       const Leaf* leaf, int tc, int cn, int n_int, int n_leaf,
                                       int tid, int nthreads) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = tid + j * nthreads;
      if (i < cn * n_int) {
        f[j] = __ldg(feature + (size_t)tc * n_int + i);
        th[j] = (int)threshold[(size_t)tc * n_int + i];
      }
      if (i < cn * n_leaf) l[j] = leaf[(size_t)tc * n_leaf + i];
    }
  }

  __device__ __forceinline__ void store(uint32_t* s_node, Leaf* s_leaf, int cn, int n_int,
                                        int n_leaf, int tid, int nthreads) const {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      const int i = tid + j * nthreads;
      if (i < cn * n_int) s_node[i] = pack_node(f[j], th[j]);
      if (i < cn * n_leaf) s_leaf[i] = l[j];
    }
  }
};

// The leaf a thread's walk of staged tree c reaches, down `depth` levels.
// kCheck: some row of the warp holds a sentinel, so a sentinel cell is
// compared as the int32 bin against the exact threshold.
template <bool kCheck, typename Thr>
__device__ __forceinline__ int walk_tree(const uint32_t* s_node, const uint8_t* srow,
                                         const int* bins, const Thr* threshold, int c, int n_int,
                                         int depth, int tc, int s, int rows, int n_feat) {
  int node = 0;
  for (int d = 0; d < depth; ++d) {
    const uint32_t w = s_node[c * n_int + node];
    const int b = srow[w >> 8];
    bool right = b >= (int)(w & 0xff);
    if (kCheck && b == kSentinel)
      right = __ldg(bins + (size_t)min(s, rows - 1) * n_feat + (w >> 8)) >
              (int)threshold[(size_t)(tc + c) * n_int + node];
    node = 2 * node + 1 + right;
  }
  return node;
}

// Block (group g, tile y) with staged rows: samples [y * samples, +samples)
// of the slab x slots [g * group, +group) below n_trees, `chunk` trees of
// the group staged at a time (chunk x 2^depth <= stage_of(kAhead) x threads); the
// loads of the kAhead chunks after this one are in flight while the block
// walks it (kAhead 2 holds twice the registers: one block an SM). Writes
// vals[t][s] (ld = rows) as f32.
template <typename Thr, typename Leaf, int kAhead>
__global__ void __launch_bounds__(kMaxThreads, 3 - kAhead)
walk_staged(const int* __restrict__ bins, const uint8_t* __restrict__ narrow,
            const int* __restrict__ flags, const int* __restrict__ feature,
            const Thr* __restrict__ threshold, const Leaf* __restrict__ leaf,
            const float* __restrict__ scale, const int* __restrict__ n_trees,
            float* __restrict__ vals, int rows, int n_feat, int row_bytes, int slots, int depth,
            int samples, int group, int chunk) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int live = min(max(*n_trees, 0), slots);
  const int t_begin = blockIdx.x * group;
  const int t_end = min(t_begin + group, live);
  if (t_begin >= t_end) return;  // the whole block, before any barrier
  const int n_int = (1 << depth) - 1, n_leaf = 1 << depth;
  uint8_t* s_rows = smem;
  uint32_t* s_node = reinterpret_cast<uint32_t*>(smem + align16(samples * row_bytes));
  Leaf* s_leaf = reinterpret_cast<Leaf*>(reinterpret_cast<uint8_t*>(s_node) +
                                         align16(chunk * n_int * 4));
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tile0 = blockIdx.y * samples;
  Prefetch<Thr, Leaf, stage_of(kAhead)> pf[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    const int tc = t_begin + a * chunk;
    if (tc < t_end)
      pf[a].load(feature, threshold, leaf, tc, min(chunk, t_end - tc), n_int, n_leaf, tid,
                 nthreads);
  }
  {  // the tile's u8 rows, 16 bytes a copy, none through registers
    const uint8_t* src = narrow + (size_t)tile0 * row_bytes;
    const int n16 = samples * row_bytes / 16;
    for (int i = tid; i < n16; i += nthreads) cp_async16(s_rows + 16 * i, src + 16 * i);
    cp_async_commit();
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int sample_warps = samples >> 5;
  const int lanes = nthreads / samples;  // tree lanes
  const int local = (warp % sample_warps) * 32 + lane;
  const int s = tile0 + local;
  const uint8_t* srow = s_rows + local * row_bytes;
  // Rows without a sentinel (every bin in [0, 254]), the whole warp's:
  // its walks skip the int32 cells and exact thresholds.
  const bool exact = !__any_sync(0xffffffffu, flags[tile0 + local] != 0);
  for (int tc0 = t_begin; tc0 < t_end; tc0 += kAhead * chunk) {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {  // pf[a] holds chunk tc0 + a * chunk
      const int tc = tc0 + a * chunk;
      if (tc >= t_end) break;  // the whole block
      const int cn = min(chunk, t_end - tc);
      __syncthreads();  // the previous chunk's walks are done with its trees
      pf[a].store(s_node, s_leaf, cn, n_int, n_leaf, tid, nthreads);
      const int next = tc + kAhead * chunk;
      if (next < t_end)
        pf[a].load(feature, threshold, leaf, next, min(chunk, t_end - next), n_int, n_leaf, tid,
                   nthreads);
      cp_async_wait<0>();
      __syncthreads();
      // A warp walks chunk trees lane_t, lane_t + lanes, ...: one walk a
      // thread at a time (two or four interleaved were slower).
      for (int c = warp / sample_warps; c < cn; c += lanes) {
        const int node =
            exact ? walk_tree<false>(s_node, srow, bins, threshold, c, n_int, depth, tc, s, rows,
                                     n_feat)
                  : walk_tree<true>(s_node, srow, bins, threshold, c, n_int, depth, tc, s, rows,
                                    n_feat);
        if (s < rows)
          vals[(size_t)(tc + c) * rows + s] =
              widen(s_leaf[c * n_leaf + node - n_int], scale, tc + c);
      }
    }
  }
}

// The same walk with the int32 rows and the trees read from device memory
// (through L1): for rows too wide for 32 of them to fit in shared memory.
template <typename Thr, typename Leaf>
__global__ void __launch_bounds__(kMaxThreads, 2)
walk_global(const int* __restrict__ bins, const int* __restrict__ feature,
            const Thr* __restrict__ threshold, const Leaf* __restrict__ leaf,
            const float* __restrict__ scale, const int* __restrict__ n_trees,
            float* __restrict__ vals, int rows, int n_feat, int slots, int depth, int samples,
            int group) {
  const int live = min(max(*n_trees, 0), slots);
  const int t_begin = blockIdx.x * group;
  const int t_end = min(t_begin + group, live);
  if (t_begin >= t_end) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sample_warps = samples >> 5;
  const int lanes = blockDim.x / samples;
  const int s = blockIdx.y * samples + (warp % sample_warps) * 32 + lane;
  const int* grow = bins + (size_t)min(s, rows - 1) * n_feat;
  const int n_int = (1 << depth) - 1, n_leaf = 1 << depth;
  for (int t = t_begin + warp / sample_warps; t < t_end; t += lanes) {
    int node = 0;
    for (int d = 0; d < depth; ++d) {
      const size_t g = (size_t)t * n_int + node;
      node = 2 * node + 1 + (__ldg(grow + __ldg(feature + g)) > (int)threshold[g]);
    }
    if (s < rows)
      vals[(size_t)t * rows + s] = widen(leaf[(size_t)t * n_leaf + node - n_int], scale, t);
  }
}

// Block (tile x, column c): lane l of warp 0 owns sample 32 x + l, whose
// chain is slots c, c + K, ... below n_trees. The chain's leaves come into
// shared memory kSumBatch at a time by cp.async (each warp copies every
// kSumWarps-th leaf from a running pointer), kSumRing batches in flight,
// and warp 0 adds them in slot order from acc = 0.
__global__ void __launch_bounds__(32 * kSumWarps)
sum_kernel(const float* __restrict__ vals, const int* __restrict__ n_trees,
           float* __restrict__ out, int rows, int slots, int n_out) {
  __shared__ float buf[kSumRing][kSumBatch][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = blockIdx.y;
  const int s = blockIdx.x * 32 + lane;
  const int live = min(max(*n_trees, 0), slots);
  const int m = live > c ? (live - c + n_out - 1) / n_out : 0;  // the chain's length
  const int batches = (m + kSumBatch - 1) / kSumBatch;
  const size_t stride = (size_t)kSumWarps * n_out * rows;
  // This warp's next leaf: chain element warp, then warp + kSumWarps, ...
  const float* src = vals + (size_t)(c + warp * n_out) * rows + min(s, rows - 1);
  auto fetch = [&](int b) {  // one commit group a batch (empty past the chain), in order
    if (b < batches) {
      const int cnt = min(kSumBatch, m - b * kSumBatch);
      float* dst = &buf[b % kSumRing][0][lane];
      for (int i = warp; i < cnt; i += kSumWarps, src += stride) cp_async4(dst + 32 * i, src);
    }
    cp_async_commit();
  };
  for (int b = 0; b < kSumRing - 1; ++b) fetch(b);
  float acc = 0.f;
  for (int b = 0; b < batches; ++b) {
    __syncthreads();  // batch b - 1 is added: its buffer may be refilled
    fetch(b + kSumRing - 1);
    cp_async_wait<kSumRing - 1>();  // this warp's copies of batch b have landed
    __syncthreads();                // and every warp's
    if (warp == 0) {
      const float* x = &buf[b % kSumRing][0][lane];
      const int cnt = min(kSumBatch, m - b * kSumBatch);
      if (cnt == kSumBatch) {
        float y[kSumBatch];
#pragma unroll
        for (int i = 0; i < kSumBatch; ++i) y[i] = x[32 * i];
#pragma unroll
        for (int i = 0; i < kSumBatch; ++i) acc = acc + y[i];
      } else {
        for (int i = 0; i < cnt; ++i) acc = acc + x[32 * i];
      }
    }
  }
  cp_async_wait<0>();
  if (warp == 0 && s < rows) out[(size_t)s * n_out + c] = acc;
}

struct Args {
  const int* bins;
  const int* feature;
  const void* threshold;
  const void* leaf;
  const float* scale;
  const int* n_trees;
  float* out;
  uint8_t* scratch;
  int n, n_feat, slots, depth, n_out, samples, threads, group, chunk, ahead, slab, row_bytes;
};

long long align_up(long long b) { return (b + kScratchAlign - 1) / kScratchAlign * kScratchAlign; }

template <typename Thr, typename Leaf>
int launch(const Args& a, cudaStream_t st) {
  const bool staged = a.row_bytes > 0;
  const int smem =
      staged ? staged_smem(a.samples, a.row_bytes, a.chunk, a.depth, (int)sizeof(Leaf)) : 0;
  void (*kernel)(const int*, const uint8_t*, const int*, const int*, const Thr*, const Leaf*,
                 const float*, const int*, float*, int, int, int, int, int, int, int, int) =
      a.ahead == 2 ? walk_staged<Thr, Leaf, 2> : walk_staged<Thr, Leaf, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  // Scratch: the narrowed rows and their sentinel flags (staged only), then
  // the (slots, slab) leaves.
  uint8_t* narrow = a.scratch;
  int* flags = reinterpret_cast<int*>(a.scratch + align_up((long long)a.slab * a.row_bytes));
  float* vals = reinterpret_cast<float*>(
      a.scratch + (staged ? align_up((long long)a.slab * a.row_bytes) +
                                align_up(4LL * a.slab) : 0));
  const int groups = (a.slots + a.group - 1) / a.group;
  for (int r0 = 0; r0 < a.n; r0 += a.slab) {
    const int rows = std::min(a.slab, a.n - r0);
    const int tiles = (rows + a.samples - 1) / a.samples;
    const int* bins = a.bins + (size_t)r0 * a.n_feat;
    if (groups > 0 && staged) {
      const int row_warps = kNarrowThreads / 32;
      const int blocks = std::min((tiles * a.samples + row_warps - 1) / row_warps, 32768);
      narrow_kernel<<<blocks, kNarrowThreads, 0, st>>>(
          bins, reinterpret_cast<uint32_t*>(narrow), flags, rows, tiles * a.samples, a.n_feat,
          a.row_bytes / 4);
      kernel<<<dim3(groups, tiles), a.threads, smem, st>>>(
          bins, narrow, flags, a.feature, (const Thr*)a.threshold, (const Leaf*)a.leaf, a.scale,
          a.n_trees, vals, rows, a.n_feat, a.row_bytes, a.slots, a.depth, a.samples, a.group,
          a.chunk);
    } else if (groups > 0) {
      walk_global<Thr, Leaf><<<dim3(groups, tiles), a.threads, 0, st>>>(
          bins, a.feature, (const Thr*)a.threshold, (const Leaf*)a.leaf, a.scale, a.n_trees,
          vals, rows, a.n_feat, a.slots, a.depth, a.samples, a.group);
    }
    sum_kernel<<<dim3((rows + 31) / 32, a.n_out), 32 * kSumWarps, 0, st>>>(
        vals, a.n_trees, a.out + (size_t)r0 * a.n_out, rows, a.slots, a.n_out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// kernels/traversal_plan.py::check, again.
bool plan_ok(const Args& a, int leaf_bytes, long long scratch_bytes) {
  if (a.samples < 32 || a.samples % 32 || a.threads % a.samples || a.threads <= 0 ||
      a.threads > kMaxThreads || a.group < 1 || a.chunk < 1 || a.ahead < 1 || a.ahead > 2 ||
      a.slab < a.samples ||
      a.slab % a.samples || a.slab / a.samples > kMaxTiles || a.slab > kMaxSlab)
    return false;
  if (a.row_bytes != 0 &&
      (a.row_bytes < a.n_feat || a.row_bytes % 4 ||
       (a.chunk << a.depth) > stage_of(a.ahead) * a.threads ||
       staged_smem(a.samples, a.row_bytes, a.chunk, a.depth, leaf_bytes) > kSmemLimit))
    return false;
  const long long need =
      (a.row_bytes ? align_up((long long)a.slab * a.row_bytes) + align_up(4LL * a.slab) : 0) +
      4LL * a.slots * a.slab;
  return scratch_bytes >= need;
}

}  // namespace

// layout: 0 f32 (int32 thresholds, f32 leaves), 1 int8 (int8 thresholds,
// int8 leaves; ``scale`` holds the per-tree f32 scales), 2 fp16 (int16
// thresholds, fp16 leaves). ``out`` is (n,) for n_out = 1, else (n, n_out)
// row-major. The plan (samples, threads, group, slab, row_bytes; row_bytes 0
// reads the int32 rows from device memory) and ``scratch`` (scratch_bytes)
// come from kernels/traversal_plan.py.
extern "C" int forest_traverse_launch(const void* bins, const void* feature,
                                      const void* threshold, const void* leaf,
                                      const void* scale, const void* n_trees, void* out,
                                      void* scratch, int n, int n_feat, int slots, int depth,
                                      int n_out, int layout, int samples, int threads, int group,
                                      int chunk, int ahead, int slab, int row_bytes,
                                      long long scratch_bytes,
                                      void* stream) {
  if (depth < 0 || depth > kMaxDepth || n_out < 1 || n_out > kMaxOutputs || n < 1 ||
      n_feat < 1 || slots < 0 || layout < 0 || layout > 2 || (layout == 1 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{(const int*)bins, (const int*)feature, threshold, leaf, (const float*)scale,
               (const int*)n_trees, (float*)out, (uint8_t*)scratch, n, n_feat, slots, depth,
               n_out, samples, threads, group, chunk, ahead, slab, row_bytes};
  const int leaf_bytes = layout == 0 ? 4 : layout == 1 ? 1 : 2;
  if (!plan_ok(a, leaf_bytes, scratch_bytes)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (layout) {
    case 0:
      return launch<int, float>(a, st);
    case 1:
      return launch<int8_t, int8_t>(a, st);
    default:
      return launch<int16_t, __half>(a, st);
  }
}
