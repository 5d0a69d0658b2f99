// Stored-entry gradient/hessian histograms from the feature-major sparse
// (ELL) store, for a full level or for a subset of its nodes.
//
// Replaces the TPU kernel repro/kernels/histogram_sparse.py::
// histogram_sparse_pallas (_sparse_hist_kernel), a batched one-hot MXU
// contraction over (F, C) entry tiles. On Hopper it is a gather-accumulate.
//
// out[gh][r][f][b] = sum of grad (gh = 0) or hess (gh = 1) over the stored
// entries c of feature f whose sample s = feat_rows[f][c] lies on node
// active[r] (node r where active is null) and whose code feat_codes[f][c]
// is b. ELL pads (s = -1), samples on node -1, samples on a node no row
// names and codes outside [0, B) add nothing. The zero-bin complement (node
// total - stored row sum) is not this kernel's job: kernels/ops.py adds it
// after any reduce.
//
// Bound: bytes. It reads the (F, C) store and the node/grad/hess of the
// stored entries' samples, and writes the whole (2, R, F, B) output, zeros
// included. At realsim width (about 67 stored entries a feature) the
// output write is nearly all of it at every level past the root.
//
// Design: a block is 4 warps, one feature each, over a tile of rows (512
// cells a warp, so twelve blocks fit an SM and their writes keep the store
// stream busy); each warp owns its feature's (tile rows, B) grad and hess
// tile in shared memory and nothing else adds into it. The warp loads its
// feature's entries 128 at a time, every load before any add: the sample
// ids and codes, then the samples' nodes, and the grad and hess of the
// entries that land in the tile (at a full level, beside the nodes). It
// adds them 32 at a time in ascending c: the lanes that hit the same cell
// find each other with __match_any_sync, the group's lowest lane sums its
// peers' values in lane order and adds the sum once into the tile. So
// every cell's adds run in one fixed order, without atomics, and two
// launches give the same bits; no thread scans entries it does not own
// (the earlier design had all 256 threads of a block scan every staged
// entry behind a barrier pair). The tile then goes out whole in 16-byte
// streaming (evict-first) stores: at a deep level the output is twice the
// L2 and would only push other data out. The node -> row map lives in
// shared memory only for a subset (a full level reads the row off the
// node id).
#include <cuda_runtime.h>

#include <algorithm>

#include "level_common.cuh"

namespace {

constexpr int kWarps = 4;           // features per block, one per warp
constexpr int kTileCells = 512;     // (row, bin) cells of a warp's tile, at most
constexpr int kGroups = 4;          // groups of 32 entries loaded before their adds
constexpr int kMaxNodes = 16384;    // the node -> row map lives in shared memory

// The sample ids and codes of entries e0 + 32 k + lane, k < kGroups (-1
// past the store).
__device__ __forceinline__ void load_entries(const int* __restrict__ rows_f,
                                             const int* __restrict__ codes_f, int n_entries,
                                             int e0, int lane, int (&s)[kGroups],
                                             int (&code)[kGroups]) {
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int c = e0 + 32 * k + lane;
    s[k] = c < n_entries ? rows_f[c] : -1;
    code[k] = c < n_entries ? codes_f[c] : -1;
  }
}

// kSubset: rows name nodes through active (else row r is node r).
template <bool kSubset>
__global__ void __launch_bounds__(32 * kWarps)
sparse_hist_kernel(const int* __restrict__ feat_rows, const int* __restrict__ feat_codes,
                   const int* __restrict__ node, const float* __restrict__ grad,
                   const float* __restrict__ hess, const int* __restrict__ active,
                   float* __restrict__ out, int n_feat, int n_entries, int n_bins,
                   int n_nodes, int rows, int row_tile, int map_words) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f = blockIdx.x * kWarps + warp;
  const int r0 = blockIdx.y * row_tile;
  const int nr = min(row_tile, rows - r0);
  const int tile = row_tile * n_bins;
  int* inv = (int*)smem;  // map_words ints: node -> row of this block's rows, or -1
  float* tile_g = smem + map_words + (size_t)warp * (2 * tile + 64);
  float* tile_h = tile_g + tile;
  float* stage_g = tile_h + tile;  // the values of the warp's 32 entries
  float* stage_h = stage_g + 32;

  // The first entries' sample ids and codes are in flight while the tiles
  // are zeroed and the node map is built.
  const int* rows_f = feat_rows + (size_t)min(f, n_feat - 1) * n_entries;
  const int* codes_f = feat_codes + (size_t)min(f, n_feat - 1) * n_entries;
  int s[kGroups], code[kGroups];
  load_entries(rows_f, codes_f, n_entries, 0, lane, s, code);
  if ((tile & 3) == 0) {  // the warp's grad and hess tiles start at zero
    float4* z = reinterpret_cast<float4*>(tile_g);
    for (int i = lane; i < tile / 2; i += 32) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < 2 * tile; i += 32) tile_g[i] = 0.f;
  }
  if (kSubset) {
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) inv[i] = -1;
    __syncthreads();
    for (int r = threadIdx.x; r < nr; r += blockDim.x) inv[active[r0 + r]] = r;
    __syncthreads();
  }
  if (f >= n_feat) return;  // warp-uniform, after the block's last barrier
  __syncwarp();

  for (int e0 = 0; e0 < n_entries; e0 += 32 * kGroups) {
    // kGroups groups of 32 entries, every load issued before any add.
    if (e0 > 0) load_entries(rows_f, codes_f, n_entries, e0, lane, s, code);
    int cell[kGroups];
    float g[kGroups], h[kGroups];
    // A full level loads every sample's grad and hess beside its node (two
    // round trips); a subset, where most entries miss the tile's rows, only
    // those of the entries that hit (a third round trip, far fewer gathers).
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      int nd = -1;
      g[k] = 0.f;
      h[k] = 0.f;
      if (s[k] >= 0) {
        nd = node[s[k]];
        if (!kSubset) {
          g[k] = grad[s[k]];
          h[k] = hess[s[k]];
        }
      }
      int r = -1;
      if (nd >= 0 && nd < n_nodes) r = kSubset ? inv[nd] : nd - r0;
      const bool hit = r >= 0 && r < nr && (unsigned)code[k] < (unsigned)n_bins;
      cell[k] = hit ? r * n_bins + code[k] : -1;
      if (kSubset && hit) {
        g[k] = grad[s[k]];
        h[k] = hess[s[k]];
      }
      if (!hit) {
        g[k] = 0.f;
        h[k] = 0.f;
      }
    }
    const int groups = min(kGroups, (n_entries - e0 + 31) / 32);  // warp-uniform
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {  // the groups in ascending entry order
      if (k >= groups) break;
      stage_g[lane] = g[k];
      stage_h[lane] = h[k];
      const unsigned peers = __match_any_sync(0xffffffffu, cell[k]);
      __syncwarp();
      if (cell[k] >= 0 && lane == __ffs(peers) - 1) {
        float sg = g[k], sh = h[k];
        for (unsigned rest = peers & (peers - 1); rest; rest &= rest - 1) {
          const int j = __ffs(rest) - 1;
          sg += stage_g[j];
          sh += stage_h[j];
        }
        tile_g[cell[k]] += sg;
        tile_h[cell[k]] += sh;
      }
      __syncwarp();
    }
  }

  const size_t row_stride = (size_t)n_feat * n_bins;  // floats between rows of out
  for (int gh = 0; gh < 2; ++gh) {
    const float* src = gh ? tile_h : tile_g;
    float* dst = out + ((size_t)(gh * rows + r0) * n_feat + f) * n_bins;
    if ((n_bins & 3) == 0) {
      const int q_row = n_bins / 4;
      for (int q = lane; q < nr * q_row; q += 32) {
        const int r = q / q_row;
        __stcs(reinterpret_cast<float4*>(dst + r * row_stride) + (q - r * q_row),
               reinterpret_cast<const float4*>(src)[q]);
      }
    } else {
      for (int i = lane; i < nr * n_bins; i += 32) {
        const int r = i / n_bins;
        dst[r * row_stride + (i - r * n_bins)] = src[i];
      }
    }
  }
}

}  // namespace

// out (2, rows, F, B); active (rows,) node ids in [0, n_nodes), or null for
// node r at row r (then rows == n_nodes).
extern "C" int histogram_sparse_launch(const void* feat_rows, const void* feat_codes,
                                       const void* node, const void* grad, const void* hess,
                                       const void* active, void* out, int n_feat,
                                       int n_entries, int n_bins, int n_nodes, int rows,
                                       void* stream) {
  if (n_bins < 1 || n_nodes < 1 || n_nodes > kMaxNodes || rows < 1 || n_feat < 1 ||
      n_entries < 0 || (!active && rows != n_nodes))
    return (int)cudaErrorInvalidValue;
  const int row_tile = std::min(rows, n_bins >= kTileCells ? 1 : kTileCells / n_bins);
  const int map_words = active ? (n_nodes + 3) & ~3 : 0;  // keeps the tiles 16-byte aligned
  const long long smem =
      4LL * (map_words + (long long)kWarps * (2LL * row_tile * n_bins + 64));
  if (smem > level_common::kSmemLimit || (rows + row_tile - 1) / row_tile > 65535)
    return (int)cudaErrorInvalidValue;
  // One instantiation for a full level, one for a subset; each raises its
  // own shared-memory cap.
  static int granted[2][level_common::kMaxDevices] = {};
  const void* kernel = active ? (const void*)sparse_hist_kernel<true>
                              : (const void*)sparse_hist_kernel<false>;
  cudaError_t err = level_common::ensure_smem(kernel, (int)smem, granted[active != nullptr]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_feat + kWarps - 1) / kWarps, (rows + row_tile - 1) / row_tile);
  const int block = 32 * kWarps;
  cudaStream_t st = (cudaStream_t)stream;
  if (active)
    sparse_hist_kernel<true><<<grid, block, (int)smem, st>>>(
        (const int*)feat_rows, (const int*)feat_codes, (const int*)node, (const float*)grad,
        (const float*)hess, (const int*)active, (float*)out, n_feat, n_entries, n_bins,
        n_nodes, rows, row_tile, map_words);
  else
    sparse_hist_kernel<false><<<grid, block, (int)smem, st>>>(
        (const int*)feat_rows, (const int*)feat_codes, (const int*)node, (const float*)grad,
        (const float*)hess, nullptr, (float*)out, n_feat, n_entries, n_bins, n_nodes, rows,
        row_tile, map_words);
  return (int)cudaGetLastError();
}
