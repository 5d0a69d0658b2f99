// Device code shared by the staged kernels (histogram.cu, split_scan.cu) and
// the fused level (level_build.cu).
//
// The fused level must give the staged chain's bits exactly. Floating-point
// sums depend on their order, so the order lives here once: the histogram of
// a level's rows (hist_enqueue: the row-sorted sample list, the accumulation
// and the merge of its chunks) and one (node, feature) row's scan and gain
// (warp_scan_gain). Each .cu file includes this header; every file is
// compiled with --fmad=false, so no multiply is contracted into an add.
#pragma once

#include <cuda_runtime.h>

namespace level_common {

constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr int kMaxWarps = 8;        // histogram warps a block
constexpr int kBatch = 8;           // samples a lane loads before it adds them
constexpr int kListThreads = 1024;  // threads of the row-list kernels
constexpr int kMaxPer = 8;          // bins per lane in the scan: B <= 256
constexpr int kMaxDevices = 64;

namespace {

// Raise a kernel's dynamic shared-memory cap only when a launch needs more
// than every earlier one on this device: one cudaFuncSetAttribute per
// (kernel, larger byte count), not one per launch. granted: the kernel's
// own kMaxDevices ints, zero at first.
inline cudaError_t ensure_smem(const void* kernel, int bytes, int* granted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

__device__ __forceinline__ int swz(int b, int lane) {
  return b * 32 + (lane ^ (b & 31));
}

// The sum of v over the block, in every thread (s32: 32 shared ints).
__device__ __forceinline__ int block_sum(int v, int* s32) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) s32[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) v += s32[w];
  return v;
}

// The sum of v over the threads before this one; *total the block's sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s32, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();
  if (lane == 31) s32[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    before += w < warp ? s32[w] : 0;
    all += s32[w];
  }
  *total = all;
  return before + x - v;
}

// The row-sorted sample list, pass 1 (levels of more than one row): cnt[r]
// = the samples on row r's node, active[r] (r where active is null).
__global__ void __launch_bounds__(kListThreads)
row_count_kernel(const int* __restrict__ node, const int* __restrict__ active, int n,
                 int* __restrict__ cnt) {
  __shared__ int s32[32];
  const int target = active ? active[blockIdx.x] : (int)blockIdx.x;
  int c = 0;
  for (int s = threadIdx.x; s < n; s += kListThreads) c += node[s] == target;
  c = block_sum(c, s32);
  if (threadIdx.x == 0) cnt[blockIdx.x] = c;
}

// Pass 2: block r writes row r's samples, in ascending order, from off[r] =
// the counts of rows 0 .. r-1 on (one row: off 0, and it writes cnt[0]).
// Thread t takes the t-th contiguous segment of the samples, so the block's
// prefix sum in thread order keeps the samples' order. Integer sums: exact
// in any order.
__global__ void __launch_bounds__(kListThreads)
row_place_kernel(const int* __restrict__ node, const int* __restrict__ active, int n,
                 int rows, int* __restrict__ cnt, int* __restrict__ off,
                 int* __restrict__ order) {
  __shared__ int s32[32];
  const int r = blockIdx.x;
  const int target = active ? active[r] : r;
  int base = 0;
  if (rows > 1) {
    for (int i = threadIdx.x; i < r; i += kListThreads) base += cnt[i];
    base = block_sum(base, s32);
  }
  const int per = (n + kListThreads - 1) / kListThreads;
  const int s0 = min(n, (int)threadIdx.x * per), s1 = min(n, s0 + per);
  int c = 0;
  for (int s = s0; s < s1; ++s) c += node[s] == target;
  int total;
  int at = base + block_exclusive_scan(c, s32, &total);
  for (int s = s0; s < s1; ++s)
    if (node[s] == target) order[at++] = s;
  if (threadIdx.x == 0) {
    off[r] = base;
    if (rows == 1) cnt[0] = total;
  }
}

// The kBatch list positions i .. i+kBatch-1 of a lane's chunk [c0, c1): their
// sample ids, -1 past the chunk.
__device__ __forceinline__ void chunk_ids(const int* __restrict__ list, int c0, int c1, int i,
                                          int (&s)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) s[u] = c0 + i + u < c1 ? list[c0 + i + u] : -1;
}

// The bin of feature f (-1 where f is past F) and the grad and hess of each
// sample of s.
__device__ __forceinline__ void gather(const int* __restrict__ bins,
                                       const float* __restrict__ grad,
                                       const float* __restrict__ hess, int n_feat, int f,
                                       bool f_ok, const int (&s)[kBatch], int (&b)[kBatch],
                                       float (&g)[kBatch], float (&h)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    b[u] = -1;
    g[u] = 0.f;
    h[u] = 0.f;
    if (s[u] >= 0) {
      if (f_ok) b[u] = bins[(size_t)s[u] * n_feat + f];
      g[u] = grad[s[u]];
      h[u] = hess[s[u]];
    }
  }
}

// One (feature tile, row) of the histogram: the grad (gh = 0) and hess
// (gh = 1) sums of row r per (feature, bin), written to row out_row_of[r]
// (r where out_row_of is null) of out, a (2, out_rows, F, B) array.
//
//  * a warp's lanes are 2^tile_log2 features x 32 >> tile_log2 sample slots;
//    every lane owns one column of its warp's shared tile ([bin][32 lanes]
//    of (grad, hess) pairs: one load and one store an add), so no two
//    threads add into one cell and no atomics are needed;
//  * a row of count samples uses min(columns, ceil(count / min_per_column))
//    of the block's columns (at least one) and cuts its part of the sample
//    list into that many chunks of equal length, the last ones shorter;
//    column c = warp * slots + slot sums chunk c in ascending sample order.
//    The loads run ahead of the adds: the ids of batch i + 2 and the bins of
//    batch i + 1 are in flight while batch i is added;
//  * the block then merges each (feature, bin) over the used columns in
//    column order (((c0 + c1) + c2) ...), and writes the tile's contiguous
//    block of the output row, 16 bytes a streaming store where B is a
//    multiple of 4;
//  * the lane index is XOR-swizzled by the bin, so the adds (lanes differ
//    in bin) and the merge (lanes walk consecutive bins) spread over the
//    banks.
// The chunks depend on (N, F, B, R) through the plan and on the row count:
// two launches, and the staged and fused levels, give the same bits.
__global__ void __launch_bounds__(32 * kMaxWarps)
hist_kernel(const int* __restrict__ bins, const float* __restrict__ grad,
            const float* __restrict__ hess, const int* __restrict__ order,
            const int* __restrict__ cnt, const int* __restrict__ off,
            const int* __restrict__ out_row_of, float* __restrict__ out, int n_feat,
            int n_bins, int out_rows, int tile_log2, int min_per_column) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = 1 << tile_log2, slot_log2 = 5 - tile_log2;
  const int cells = n_bins * 32;  // one warp's tile: (grad, hess) pairs
  const int r = blockIdx.y;
  const int f0 = blockIdx.x * tile;
  const int f = f0 + (lane & (tile - 1));
  const bool f_ok = f < n_feat;
  const int count = cnt[r];
  const int columns = min((int)(blockDim.x >> 5) << slot_log2,
                          max(1, (count + min_per_column - 1) / min_per_column));
  const int used_warps = (columns + (1 << slot_log2) - 1) >> slot_log2;
  {
    float4* z = reinterpret_cast<float4*>(smem);  // cells is a multiple of 32
    for (int i = threadIdx.x; i < used_warps * 2 * cells / 4; i += blockDim.x)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  if (warp < used_warps) {  // warp-uniform
    float2* acc = reinterpret_cast<float2*>(smem) + (size_t)warp * cells;
    const int* list = order + off[r];
    const int size = (count + columns - 1) / columns;
    const int c0 = min(count, ((warp << slot_log2) + (lane >> tile_log2)) * size);
    const int c1 = min(count, c0 + size);
    int s[kBatch], b[kBatch], bn[kBatch];
    float g[kBatch], h[kBatch], gn[kBatch], hn[kBatch];
    chunk_ids(list, c0, c1, 0, s);
    gather(bins, grad, hess, n_feat, f, f_ok, s, b, g, h);
    chunk_ids(list, c0, c1, kBatch, s);
    for (int i = 0; i < size; i += kBatch) {  // the same trip count in every lane
      gather(bins, grad, hess, n_feat, f, f_ok, s, bn, gn, hn);  // batch i + 1
      chunk_ids(list, c0, c1, i + 2 * kBatch, s);                // batch i + 2
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if ((unsigned)b[u] < (unsigned)n_bins) {
          float2 v = acc[swz(b[u], lane)];  // grad and hess side by side: one
          v.x += g[u];                       // load and one store an add
          v.y += h[u];
          acc[swz(b[u], lane)] = v;
        }
        b[u] = bn[u];
        g[u] = gn[u];
        h[u] = hn[u];
      }
    }
  }
  __syncthreads();

  const int nf = min(tile, n_feat - f0);
  const int orow = out_row_of ? out_row_of[r] : r;
  const float2* src = reinterpret_cast<const float2*>(smem);
  auto merged = [&](int fl, int b) {
    float2 v = src[swz(b, fl)];
    for (int c = 1; c < columns; ++c) {
      const float2 w = src[(size_t)(c >> slot_log2) * cells +
                           swz(b, ((c & ((1 << slot_log2) - 1)) << tile_log2) + fl)];
      v.x += w.x;
      v.y += w.y;
    }
    return v;
  };
  float* dst_g = out + ((size_t)orow * n_feat + f0) * n_bins;
  float* dst_h = dst_g + (size_t)out_rows * n_feat * n_bins;
  if ((n_bins & 3) == 0) {
    for (int q = threadIdx.x; q < nf * n_bins / 4; q += blockDim.x) {
      const int fl = 4 * q / n_bins, b = 4 * q - fl * n_bins;
      const float2 m0 = merged(fl, b), m1 = merged(fl, b + 1), m2 = merged(fl, b + 2),
                   m3 = merged(fl, b + 3);
      // Streaming (evict-first) stores: a deep level's output is twice the L2.
      __stcs(reinterpret_cast<float4*>(dst_g) + q, make_float4(m0.x, m1.x, m2.x, m3.x));
      __stcs(reinterpret_cast<float4*>(dst_h) + q, make_float4(m0.y, m1.y, m2.y, m3.y));
    }
  } else {
    for (int i = threadIdx.x; i < nf * n_bins; i += blockDim.x) {
      const int fl = i / n_bins;
      const float2 m = merged(fl, i - fl * n_bins);
      dst_g[i] = m.x;
      dst_h[i] = m.y;
    }
  }
}

// Enqueue a level's histogram on st: rows r = 0 .. rows-1 sum node active[r]
// (r where active is null) into row r of out (2, out_rows, F, B), or into
// row active[r] where by_node is set (the fused level's histogram is indexed
// by node). The plan (feat_tile, warps, min_per_column) comes from
// kernels/hist_plan.py. work holds n + 2 * rows ints: the sample list, then
// each row's count and offset. Returns a cudaError_t.
inline int hist_enqueue(const int* bins, const int* node, const float* grad,
                        const float* hess, const int* active, float* out, int* work, int n,
                        int n_feat, int n_bins, int rows, int out_rows, bool by_node,
                        int feat_tile, int warps, int min_per_column, cudaStream_t st) {
  const int tile_log2 = feat_tile == 32 ? 5 : feat_tile == 16 ? 4 : feat_tile == 8 ? 3 : -1;
  const long long smem = (long long)warps * 2 * n_bins * 32 * (long long)sizeof(float);
  if (tile_log2 < 0 || warps < 1 || warps > kMaxWarps || n_bins < 1 || smem > kSmemLimit ||
      rows < 1 || rows > 65535 || out_rows < rows || n < 0 || n_feat < 1 ||
      (by_node && !active) || min_per_column < 1)
    return (int)cudaErrorInvalidValue;
  static int granted[kMaxDevices] = {};
  cudaError_t err = ensure_smem((const void*)hist_kernel, (int)smem, granted);
  if (err != cudaSuccess) return (int)err;
  int* order = work;
  int* cnt = work + n;
  int* off = cnt + rows;
  if (rows > 1) row_count_kernel<<<rows, kListThreads, 0, st>>>(node, active, n, cnt);
  row_place_kernel<<<rows, kListThreads, 0, st>>>(node, active, n, rows, cnt, off, order);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid((n_feat + feat_tile - 1) / feat_tile, rows);
  hist_kernel<<<grid, 32 * warps, (int)smem, st>>>(bins, grad, hess, order, cnt, off,
                                                   by_node ? active : nullptr, out, n_feat,
                                                   n_bins, out_rows, tile_log2,
                                                   min_per_column);
  return (int)cudaGetLastError();
}

}  // namespace

// One warp scans one (node, feature) row of B bins and computes the gain of
// every split point. Lane l owns bins l*per .. l*per+per-1 (per =
// ceil(B/32)): load(k, b, g, h) fetches bin b (the lane's k-th) into g and
// h, and store(k, b, gain) takes its gain (-inf where invalid). The
// lane-blocked partial sums, the shuffle scan over the 32 lane totals, and
// the totals taken as the left sums of bin B-1 (as the reference takes
// gl[..., -1]) fix the order of every add:
//   gain = GL*GL/(HL+lam) + GR*GR/(HR+lam) - GT*GT/(HT+lam),
// -inf where HL < min_h, HR < min_h, or b = B-1.
template <class Load, class Store>
__device__ __forceinline__ void warp_scan_gain(int n_bins, float lam, float min_h,
                                               Load load, Store store) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int per = (n_bins + 31) / 32;
  const int b0 = lane * per;

  float gl[kMaxPer], hl[kMaxPer];
  float sg = 0.f, sh = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int b = b0 + k;
    if (k < per && b < n_bins) {
      float g, h;
      load(k, b, g, h);
      sg += g;
      sh += h;
    }
    gl[k] = sg;
    hl[k] = sh;
  }
  // Inclusive scan of the lane totals, then each lane's exclusive offset.
  float ig = sg, ih = sh;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float tg = __shfl_up_sync(full, ig, o);
    const float th = __shfl_up_sync(full, ih, o);
    if (lane >= o) {
      ig = tg + ig;
      ih = th + ih;
    }
  }
  float eg = __shfl_up_sync(full, ig, 1);
  float eh = __shfl_up_sync(full, ih, 1);
  if (lane == 0) {
    eg = 0.f;
    eh = 0.f;
  }
  const int k_last = (n_bins - 1) % per;
  float lg = 0.f, lh = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    gl[k] = eg + gl[k];
    hl[k] = eh + hl[k];
    if (k == k_last) {
      lg = gl[k];
      lh = hl[k];
    }
  }
  const float gt = __shfl_sync(full, lg, (n_bins - 1) / per);
  const float ht = __shfl_sync(full, lh, (n_bins - 1) / per);
  const float parent = gt * gt / (ht + lam);

#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int b = b0 + k;
    if (k < per && b < n_bins) {
      const float gr = gt - gl[k];
      const float hr = ht - hl[k];
      const float v = gl[k] * gl[k] / (hl[k] + lam) + gr * gr / (hr + lam) - parent;
      const bool ok = hl[k] >= min_h && hr >= min_h && b < n_bins - 1;
      store(k, b, ok ? v : -__int_as_float(0x7f800000));
    }
  }
}

}  // namespace level_common
