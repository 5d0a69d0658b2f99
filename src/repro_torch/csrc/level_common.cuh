// Device code shared by the staged kernels (histogram.cu, split_scan.cu) and
// the fused level (level_build.cu).
//
// The fused level must give the staged chain's bits exactly. Floating-point
// sums depend on their order, so the order lives here once: the histogram of
// a level's rows (level_kernel's phases 0 and 1: the row-sorted sample list,
// the accumulation of its chunks and the merge of the chunks, first inside a
// block, then across a row's blocks) and one (node, feature) row's scan and
// gain (scan_rows, with div_rn's divisions). Each .cu file includes this header; every file is
// compiled with --fmad=false, so no multiply is contracted into an add.
//
// The fused level (level_build.cu) is one launch of level_kernel, a
// cooperative persistent grid whose blocks meet at grid barriers between
// its phases: the row list, the histogram with the decide step on top, the
// route. The staged histogram (histogram.cu, hist_launch) runs the same
// list and histogram code as a chain of plain launches.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace level_common {

namespace cg = cooperative_groups;

constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use
constexpr int kMaxWarps = 8;        // warps a block
constexpr int kBatch = 8;           // samples a lane loads before it adds them
constexpr int kMaxPer = 8;          // bins per lane in the scan: B <= 256
constexpr int kMaxDevices = 64;
constexpr int kMaxSplits = 64;      // blocks a (feature tile, row) is cut into
constexpr int kMaxNodes = 4096;     // the fused level's split table lives in shared memory

// n / d with IEEE division's bits. Where n is 0 and d a nonzero number the
// quotient is 0 with the sign of n x d, taken without dividing 0: the
// division's range check (FCHK) sends a zero dividend down its slow path,
// and a sparse row's left or right sums are 0 over most of its bins. The
// dividend is then +-1, set by its bits in an asm statement (through a
// select the compiler sees that the quotient is dropped and divides n all
// the same).
__device__ __forceinline__ float div_rn(float n, float d) {
  const bool zero = n == 0.f && d == d && d != 0.f;
  unsigned bits = __float_as_uint(n);
  asm("or.b32 %0, %0, %1;" : "+r"(bits) : "r"(zero ? 0x3f800000u : 0u));
  const float q = __uint_as_float(bits) / d;
  return zero ? __int_as_float((__float_as_int(n) ^ __float_as_int(d)) & 0x80000000) : q;
}

// One warp scans R (node, feature) rows of B bins at once and computes the
// gain of every split point of each; the rows' operations interleave but
// never mix, so each row gets the bits a scan of it alone gets, whatever R.
// Lane l owns bins l*per .. l*per+per-1 (per = PER = ceil(B/32), so the
// lane's arrays hold only its own bins): load(q, k, b, g, h) fetches
// bin b (the lane's k-th) of row q into g and h, and store(q, k, b, gain)
// takes its gain (-inf where invalid). The lane-blocked partial sums, the
// shuffle scan over the 32 lane totals, and the totals taken as the left
// sums of bin B-1 (as the reference takes gl[..., -1]) fix the order of
// every add:
//   gain = GL*GL/(HL+lam) + GR*GR/(HR+lam) - GT*GT/(HT+lam),
// -inf where HL < min_h, HR < min_h, or b = B-1.
template <int R, int PER, class Load, class Store>
__device__ __forceinline__ void scan_rows(int n_bins, float lam, float min_h, Load load,
                                          Store store) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  constexpr int per = PER;  // ceil(B / 32)
  const int b0 = lane * per;

  float gl[R][PER], hl[R][PER];
  float sg[R], sh[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    sg[q] = 0.f;
    sh[q] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = b0 + k;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (b < n_bins) {
        float g, h;
        load(q, k, b, g, h);
        sg[q] += g;
        sh[q] += h;
      }
      gl[q][k] = sg[q];
      hl[q][k] = sh[q];
    }
  }
  // Inclusive scan of the lane totals, then each lane's exclusive offset.
  float ig[R], ih[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    ig[q] = sg[q];
    ih[q] = sh[q];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float tg = __shfl_up_sync(full, ig[q], o);
      const float th = __shfl_up_sync(full, ih[q], o);
      if (lane >= o) {
        ig[q] = tg + ig[q];
        ih[q] = th + ih[q];
      }
    }
  }
  const int k_last = (n_bins - 1) % per;
  float gt[R], ht[R], parent[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    float eg = __shfl_up_sync(full, ig[q], 1);
    float eh = __shfl_up_sync(full, ih[q], 1);
    if (lane == 0) {
      eg = 0.f;
      eh = 0.f;
    }
    float lg = 0.f, lh = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      gl[q][k] = eg + gl[q][k];
      hl[q][k] = eh + hl[q][k];
      if (k == k_last) {
        lg = gl[q][k];
        lh = hl[q][k];
      }
    }
    gt[q] = __shfl_sync(full, lg, (n_bins - 1) / per);
    ht[q] = __shfl_sync(full, lh, (n_bins - 1) / per);
    parent[q] = div_rn(gt[q] * gt[q], ht[q] + lam);
  }

#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int b = b0 + k;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (b < n_bins) {
        const float gr = gt[q] - gl[q][k];
        const float hr = ht[q] - hl[q][k];
        const float v = div_rn(gl[q][k] * gl[q][k], hl[q][k] + lam) + div_rn(gr * gr, hr + lam) -
                        parent[q];
        const bool ok = hl[q][k] >= min_h && hr >= min_h && b < n_bins - 1;
        store(q, k, b, ok ? v : -__int_as_float(0x7f800000));
      }
    }
  }
}

// scan_rows at per = ceil(B / 32), for per <= P.
template <int R, int P, class Load, class Store>
__device__ __forceinline__ void scan_per(int per, int n_bins, float lam, float min_h, Load load,
                                         Store store) {
  if constexpr (P > 1) {
    if (per < P) return scan_per<R, P - 1>(per, n_bins, lam, min_h, load, store);
  }
  scan_rows<R, P>(n_bins, lam, min_h, load, store);
}

// R rows at once, B <= 32 * MAXPER (only those instances are built, so a
// kernel's registers follow what it runs).
template <int R, int MAXPER = kMaxPer, class Load, class Store>
__device__ __forceinline__ void warp_scan_gain_rows(int n_bins, float lam, float min_h,
                                                    Load load, Store store) {
  scan_per<R, MAXPER>((n_bins + 31) / 32, n_bins, lam, min_h, load, store);
}

// The arguments of one level_kernel launch.
struct LevelArgs {
  const int* bins;      // (N, F)
  const int* node;      // (N,) node of each sample, -1 inactive
  const float* grad;    // (N,)
  const float* hess;    // (N,)
  const int* active;    // (rows,) row r sums node active[r]; null: node r
  const float* parent;  // fused, derive: the (2, rows, F, B) parent cache
  const int* mask;      // fused: (F,) 1 = the feature may split
  float* out;           // (2, out_rows, F, B): the fused level's row active[r] holds row r
  int* work;            // scratch, laid out by work_layout
  int* feat;            // fused: (n_nodes,) outputs
  int* thr;
  float* best;
  int* new_node;        // fused: (N,)
  int n, n_feat, n_bins, rows, out_rows, n_nodes;
  int derive;           // fused: node active[r] ^ 1 is parent row r - the built row
  int warps;            // the plan's warps: a block's lane columns are theirs
  int tile_log2;        // features a warp covers: 8, 16 or 32
  int splits;           // blocks a (feature tile, row) is cut into
  int min_per_column;   // samples a chunk holds before another is cut
  float lam, min_h;
};

// The scratch of one launch, in ints from the start of work: the row-sorted
// sample list (each row's part starting at a multiple of 8 positions, so
// N + 8 R positions) and, beside it, each listed sample's (grad, hess);
// each row's count and offset; a ticket a (row, tile) where a row is cut
// over blocks; each (node, tile)'s best gain and its flat index (fused);
// and each block's merged tile of a cut row (2 x tile x B floats). Every
// region starts 16-byte aligned. kernels/hist_plan.py::work_ints repeats
// it.
struct Work {
  long long order, gh, cnt, off, tickets, part_gain, part_idx, partials, total;
};

__host__ __device__ inline long long align4(long long v) { return (v + 3) / 4 * 4; }

__host__ __device__ inline Work work_layout(int n, int rows, int tiles, int splits, int tile,
                                            int n_bins, int n_nodes, bool fused) {
  const long long list = align4((long long)n + 8LL * rows);
  Work w;
  w.order = 0;
  w.gh = list;
  w.cnt = w.gh + 2 * list;
  w.off = w.cnt + rows;
  w.tickets = w.off + rows;
  w.part_gain = w.tickets + (splits > 1 ? (long long)rows * tiles : 0);
  w.part_idx = w.part_gain + (fused ? (long long)n_nodes * tiles : 0);
  w.partials = align4(w.part_idx + (fused ? (long long)n_nodes * tiles : 0));
  w.total = w.partials + (splits > 1 ? (long long)rows * tiles * splits * 2 * tile * n_bins : 0);
  return w;
}

__host__ __device__ inline int tiles_of(const LevelArgs& a) {
  return (a.n_feat + (1 << a.tile_log2) - 1) >> a.tile_log2;
}

__host__ __device__ inline Work work_of(const LevelArgs& a, bool fused) {
  return work_layout(a.n, a.rows, tiles_of(a), a.splits, 1 << a.tile_log2, a.n_bins, a.n_nodes,
                     fused);
}

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

__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

// (g, i) beats (best, best_i): a larger gain, or the same gain at a smaller
// flat index. Associative and commutative, so any reduction order gives the
// first maximum.
__device__ __forceinline__ void take_better(float g, int i, float& best, int& best_i) {
  if (g > best || (g == best && i < best_i)) {
    best = g;
    best_i = i;
  }
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

// The row-sorted sample list, pass 1 (levels of more than one row): cnt[r]
// = the samples on row r's node. Node ids 16 bytes a load where aligned.
__device__ __forceinline__ void count_row(const LevelArgs& a, int r, int* cnt, int* s32) {
  const int target = a.active ? __ldg(a.active + r) : r;
  const int n4 = ((size_t)a.node & 15) == 0 ? a.n >> 2 : 0;
  int c = 0;
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(a.node) + q);
    c += (v.x == target) + (v.y == target) + (v.z == target) + (v.w == target);
  }
  for (int s = 4 * n4 + threadIdx.x; s < a.n; s += blockDim.x) c += __ldg(a.node + s) == target;
  c = block_sum(c, s32);
  if (threadIdx.x == 0) cnt[r] = c;
}

// Pass 2: row r's samples, in ascending order, and each one's (grad, hess)
// beside it, from off[r] = the counts of rows 0 .. r-1, each rounded up to
// a multiple of 8, on (one row: off 0, and it writes cnt[0]). Warp v takes
// the v-th contiguous run of 32-sample tiles: it counts its hits by ballots
// (kList tiles' node ids loaded at once, coalesced), the block adds the
// warps' counts in warp order, and the warp walks its run again, each hit
// placed by its ballot rank, so the stores are coalesced and the order is
// the samples'. Integer sums: exact in any order.
constexpr int kList = 16;
__device__ __forceinline__ void place_row(const LevelArgs& a, int r, const Work& w, int* s32) {
  const unsigned full = 0xffffffffu;
  int* cnt = a.work + w.cnt;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int target = a.active ? __ldg(a.active + r) : r;
  int base = 0;
  if (a.rows > 1) {
    for (int i = threadIdx.x; i < r; i += blockDim.x) base += (__ldcg(cnt + i) + 7) & ~7;
    base = block_sum(base, s32);
  }
  const int tiles32 = (a.n + 31) / 32;
  const int run = (tiles32 + warps - 1) / warps;
  const int t0 = min(tiles32, warp * run), t1 = min(tiles32, t0 + run);
  int c = 0;
  for (int t = t0; t < t1; t += kList) {
    bool hit[kList];
#pragma unroll
    for (int u = 0; u < kList; ++u) {
      const int s = (t + u) * 32 + lane;
      hit[u] = t + u < t1 && s < a.n && __ldg(a.node + s) == target;
    }
#pragma unroll
    for (int u = 0; u < kList; ++u) c += __popc(__ballot_sync(full, hit[u]));
  }
  __syncthreads();  // s32 is free
  if (lane == 0) s32[warp] = c;
  __syncthreads();
  int at = base, total = 0;
  for (int v = 0; v < warps; ++v) {
    at += v < warp ? s32[v] : 0;
    total += s32[v];
  }
  int* order = a.work + w.order;
  float2* gh = reinterpret_cast<float2*>(a.work + w.gh);
  for (int t = t0; t < t1; t += kList) {
    bool hit[kList];
    float g[kList], h[kList];
#pragma unroll
    for (int u = 0; u < kList; ++u) {  // every load of the kList tiles in flight at once
      const int s = (t + u) * 32 + lane;
      const bool in = t + u < t1 && s < a.n;
      hit[u] = in && __ldg(a.node + s) == target;
      g[u] = in ? __ldg(a.grad + s) : 0.f;
      h[u] = in ? __ldg(a.hess + s) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kList; ++u) {
      const unsigned m = __ballot_sync(full, hit[u]);
      if (hit[u]) {
        const int pos = at + __popc(m & ((1u << lane) - 1));
        order[pos] = (t + u) * 32 + lane;
        gh[pos] = make_float2(g[u], h[u]);
      }
      at += __popc(m);
    }
  }
  if (threadIdx.x == 0) {
    a.work[w.off + r] = base;
    if (a.rows == 1) cnt[0] = total;
  }
}

// A lane's batch: list positions p .. p + kBatch - 1 of its chunk (p and
// the row's start are multiples of 8, so two 16-byte loads of ids and four
// of (grad, hess)); positions at or past c1 are no sample (id -1, g = h =
// 0).
__device__ __forceinline__ void load_batch(const int* __restrict__ list,
                                           const float2* __restrict__ ghl, int p, int c1,
                                           int (&s)[kBatch], float (&g)[kBatch],
                                           float (&h)[kBatch]) {
  if (p < c1) {
    const int4 i0 = __ldcg(reinterpret_cast<const int4*>(list + p));
    const int4 i1 = __ldcg(reinterpret_cast<const int4*>(list + p + 4));
    const int ids[kBatch] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
#pragma unroll
    for (int q = 0; q < kBatch / 2; ++q) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(ghl + p + 2 * q));
      g[2 * q] = v.x;
      h[2 * q] = v.y;
      g[2 * q + 1] = v.z;
      h[2 * q + 1] = v.w;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool in = p + u < c1;
      s[u] = in ? ids[u] : -1;
      g[u] = in ? g[u] : 0.f;
      h[u] = in ? h[u] : 0.f;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      s[u] = -1;
      g[u] = 0.f;
      h[u] = 0.f;
    }
  }
}

// The bin of feature f of each sample of s (-1 for no sample, or where f is
// past F).
__device__ __forceinline__ void load_bins(const int* __restrict__ bins, int n_feat, int f,
                                          bool f_ok, const int (&s)[kBatch], int (&b)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    b[u] = s[u] >= 0 && f_ok ? __ldg(bins + (size_t)s[u] * n_feat + f) : -1;
}

// Phase 1, one item: the grad (gh = 0) and hess (gh = 1) sums of row r over
// feature tile t, k-th of the row's `splits` blocks. In the block that
// merges the row's tile (it returns true; false in the row's other blocks)
// the tile goes to the output row and, kFused, stays in M (shared: grad
// [fl][b], then hess) for decide_tile.
//
//  * a warp's lanes are `tile` features x 32 / tile sample slots; every
//    lane owns one column of its warp's shared tile ([bin][32 lanes] of
//    (grad, hess) pairs: one load and one store an add), so no two threads
//    add into one cell and no atomics are needed;
//  * a row of count samples is cut into chunks = min(splits x columns,
//    ceil(count / min_per_column)) chunks (at least one) of ceil(count /
//    chunks) samples rounded up to a multiple of 8, the last ones shorter
//    or empty; block k sums chunks k x columns .. (k + 1) x columns - 1,
//    column c = warp * slots + slot of it one chunk in ascending sample
//    order. A lane loads 8 list positions at a time (ids and (grad, hess)
//    side by side, 16 bytes a load), then their bins; the ids of batch
//    i + 2 and the bins of batch i + 1 are in flight while batch i is added;
//  * each block merges each (feature, bin) over its used columns in column
//    order (((c0 + c1) + c2) ...); where a row takes more than one block,
//    each block writes its merged tile to the partials, takes a ticket,
//    and the block that takes the last ticket adds the row's partials in
//    block order, whichever block that is. Tickets are integer atomics;
//    no float is ever added atomically;
//  * the lane index is XOR-swizzled by the bin, so the adds (lanes differ
//    in bin) and the merge (lanes walk consecutive bins) spread over the
//    banks.
// The chunks depend on (N, F, B, R) through the plan and on the row count
// alone, never on the grid: two launches, the staged and fused levels, and
// any grid size give the same bits.
template <bool kFused>
__device__ bool build_tile(const LevelArgs& a, int t, int r, int k, int tiles, const Work& w,
                           float* smem, float* M, int* s_mask) {
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile_log2 = a.tile_log2, tile = 1 << tile_log2, slot_log2 = 5 - tile_log2;
  const int n_bins = a.n_bins;
  const int cells = n_bins * 32;  // one warp's tile: (grad, hess) pairs
  const int columns = a.warps << slot_log2;  // the block may have more warps than the plan
  const int count = __ldcg(a.work + w.cnt + r);
  const int chunks = min(a.splits * columns,
                         max(1, (count + a.min_per_column - 1) / a.min_per_column));
  const int size = ((count + chunks - 1) / chunks + kBatch - 1) & ~(kBatch - 1);
  const int used_blocks = (chunks + columns - 1) / columns;
  if (k >= used_blocks) return false;  // block-uniform
  const int mine = min(columns, chunks - k * columns);
  const int used_warps = (mine + (1 << slot_log2) - 1) >> slot_log2;
  const int f0 = t * tile;
  const int nf = min(tile, a.n_feat - f0);
  if (kFused && (int)threadIdx.x < nf) s_mask[threadIdx.x] = __ldg(a.mask + f0 + threadIdx.x);
  {
    float4* z = reinterpret_cast<float4*>(smem);  // cells is a multiple of 32
    for (int i = threadIdx.x; i < used_warps * 2 * cells / 4; i += blockDim.x)
      z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  if (warp < used_warps) {  // warp-uniform
    const int f = f0 + (lane & (tile - 1));
    const bool f_ok = f < a.n_feat;
    float2* acc = reinterpret_cast<float2*>(smem) + (size_t)warp * cells;
    const int base = __ldcg(a.work + w.off + r);
    const int* list = a.work + w.order + base;
    const float2* ghl = reinterpret_cast<const float2*>(a.work + w.gh) + base;
    const long long j = (long long)k * columns + (warp << slot_log2) + (lane >> tile_log2);
    const int c0 = (int)min((long long)count, j * size);
    const int c1 = min(count, c0 + size);
    int s[kBatch], b[kBatch], bn[kBatch];
    float g[kBatch], h[kBatch], gn[kBatch], hn[kBatch];
    load_batch(list, ghl, c0, c1, s, g, h);
    load_bins(a.bins, a.n_feat, f, f_ok, s, b);
    load_batch(list, ghl, c0 + kBatch, c1, s, gn, hn);
    for (int i = 0; i < size; i += kBatch) {  // the same trip count in every lane
      load_bins(a.bins, a.n_feat, f, f_ok, s, bn);  // batch i + 1
      float g2[kBatch], h2[kBatch];
      load_batch(list, ghl, c0 + i + 2 * kBatch, c1, s, g2, h2);  // batch i + 2
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
        gn[u] = g2[u];
        hn[u] = h2[u];
      }
    }
  }
  __syncthreads();

  // This block's columns, merged in column order.
  const float2* src = reinterpret_cast<const float2*>(smem);
  auto merged = [&](int fl, int b) {
    float2 v = src[swz(b, fl)];
    for (int c = 1; c < mine; ++c) {
      const float2 u = src[(size_t)(c >> slot_log2) * cells +
                           swz(b, ((c & ((1 << slot_log2) - 1)) << tile_log2) + fl)];
      v.x += u.x;
      v.y += u.y;
    }
    return v;
  };
  const int tb = tile * n_bins;  // floats of one half (grad or hess) of a tile
  const int orow = kFused ? __ldg(a.active + r) : r;  // the fused histogram is by node
  float* dst_g = a.out + ((size_t)orow * a.n_feat + f0) * n_bins;
  float* dst_h = dst_g + (size_t)a.out_rows * a.n_feat * n_bins;
  // The row's tile, cells 4q .. 4q + 3 (fl * B + b) where B is a multiple
  // of 4, else cell i: to M where kFused, else to the output row (the
  // tile's contiguous block of it).
  auto emit4 = [&](int q, float4 vg, float4 vh) {
    if (kFused) {
      reinterpret_cast<float4*>(M)[q] = vg;
      reinterpret_cast<float4*>(M + tb)[q] = vh;
    } else {  // evict-first: a deep level's output is twice the L2
      __stcs(reinterpret_cast<float4*>(dst_g) + q, vg);
      __stcs(reinterpret_cast<float4*>(dst_h) + q, vh);
    }
  };
  auto emit1 = [&](int i, float vg, float vh) {
    if (kFused) {
      M[i] = vg;
      M[tb + i] = vh;
    } else {
      dst_g[i] = vg;
      dst_h[i] = vh;
    }
  };
  const bool vec = (n_bins & 3) == 0;
  float* part = reinterpret_cast<float*>(a.work + w.partials) +
                ((size_t)r * tiles + t) * a.splits * 2 * tb;  // the row's block 0
  const bool split = used_blocks > 1;
  float* mine_p = part + (size_t)k * 2 * tb;
  if (vec) {
    for (int q = threadIdx.x; q < nf * n_bins / 4; q += blockDim.x) {
      const int fl = 4 * q / n_bins, b = 4 * q - fl * n_bins;
      const float2 m0 = merged(fl, b), m1 = merged(fl, b + 1), m2 = merged(fl, b + 2),
                   m3 = merged(fl, b + 3);
      const float4 vg = make_float4(m0.x, m1.x, m2.x, m3.x);
      const float4 vh = make_float4(m0.y, m1.y, m2.y, m3.y);
      if (split) {
        __stcg(reinterpret_cast<float4*>(mine_p) + q, vg);
        __stcg(reinterpret_cast<float4*>(mine_p + tb) + q, vh);
      } else {
        emit4(q, vg, vh);
      }
    }
  } else {
    for (int i = threadIdx.x; i < nf * n_bins; i += blockDim.x) {
      const int fl = i / n_bins;
      const float2 m = merged(fl, i - fl * n_bins);
      if (split) {
        __stcg(mine_p + i, m.x);
        __stcg(mine_p + tb + i, m.y);
      } else {
        emit1(i, m.x, m.y);
      }
    }
  }
  if (split) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      s_last = atomicAdd(a.work + w.tickets + (size_t)r * tiles + t, 1) == used_blocks - 1;
    __syncthreads();
    if (!s_last) return false;  // block-uniform
    __threadfence();
    // The last block in: the row's partials added in block order.
    if (vec) {
      const float4* p4 = reinterpret_cast<const float4*>(part);
      const int q4 = 2 * tb / 4;  // float4s of one block's partial
      for (int q = threadIdx.x; q < nf * n_bins / 4; q += blockDim.x) {
        float4 vg = __ldcg(p4 + q), vh = __ldcg(p4 + tb / 4 + q);
        for (int o = 1; o < used_blocks; ++o) {
          const float4 ug = __ldcg(p4 + (size_t)o * q4 + q);
          const float4 uh = __ldcg(p4 + (size_t)o * q4 + tb / 4 + q);
          vg = make_float4(vg.x + ug.x, vg.y + ug.y, vg.z + ug.z, vg.w + ug.w);
          vh = make_float4(vh.x + uh.x, vh.y + uh.y, vh.z + uh.z, vh.w + uh.w);
        }
        emit4(q, vg, vh);
      }
    } else {
      for (int i = threadIdx.x; i < nf * n_bins; i += blockDim.x) {
        float vg = __ldcg(part + i), vh = __ldcg(part + tb + i);
        for (int o = 1; o < used_blocks; ++o) {
          vg += __ldcg(part + (size_t)o * 2 * tb + i);
          vh += __ldcg(part + (size_t)o * 2 * tb + tb + i);
        }
        emit1(i, vg, vh);
      }
    }
  }
  if (kFused) {
    __syncthreads();
    // The built row's tile from M to the level histogram, 16 bytes a store
    // where B is a multiple of 4.
    if ((n_bins & 3) == 0) {
      for (int q = threadIdx.x; q < nf * n_bins / 4; q += blockDim.x) {
        reinterpret_cast<float4*>(dst_g)[q] = reinterpret_cast<const float4*>(M)[q];
        reinterpret_cast<float4*>(dst_h)[q] = reinterpret_cast<const float4*>(M + tb)[q];
      }
    } else {
      for (int i = threadIdx.x; i < nf * n_bins; i += blockDim.x) {
        dst_g[i] = M[i];
        dst_h[i] = M[tb + i];
      }
    }
  }
  return true;
}

// The decide step's scans: kRows rows a warp scan (a feature's built and
// sibling rows in derive mode at kRows = 2, else kRows features' rows); a
// row whose feature is masked is scanned for nothing, and a feature past
// the tile reads zeros. (best0, idx0) take the built node's maxima, (best1,
// idx1) the sibling's. Two rows a scan measured faster than four or eight
// (tools/level_build_variants.py rows4, rows8).
template <int kRows, int kMaxPerLane>
__device__ __forceinline__ void scan_tile(const LevelArgs& a, const float* M, const float* S,
                                          const int* s_mask, int f0, int nf, float& best0,
                                          int& idx0, float& best1, int& idx1) {
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int n_bins = a.n_bins, tb = (1 << a.tile_log2) * n_bins;
  const int per_scan = a.derive ? kRows / 2 : kRows;  // features a scan
  for (int i = warp; i * per_scan < nf; i += warps) {
    const int fl0 = i * per_scan;
    bool any = false;
    for (int j = 0; j < per_scan; ++j) any |= fl0 + j < nf && s_mask[fl0 + j] != 0;
    if (!any) continue;  // warp-uniform
    // Row q: feature fl0 + q % per_scan, the sibling's where q >= per_scan.
    warp_scan_gain_rows<kRows, kMaxPerLane>(
        n_bins, a.lam, a.min_h,
        [&](int q, int, int b, float& gv, float& hv) {
          const int fl = fl0 + q % per_scan;
          const float* row = q >= per_scan ? S : M;
          const bool in = fl < nf;
          gv = in ? row[fl * n_bins + b] : 0.f;
          hv = in ? row[tb + fl * n_bins + b] : 0.f;
        },
        [&](int q, int, int b, float v) {
          const int fl = fl0 + q % per_scan;
          if (fl < nf && s_mask[fl] != 0) {
            if (q >= per_scan)
              take_better(v, (f0 + fl) * n_bins + b, best1, idx1);
            else
              take_better(v, (f0 + fl) * n_bins + b, best0, idx0);
          }
        });
  }
}

// The fused level's decide step, in the block that holds row r's merged
// tile t in M: node nb = active[r] is the built node. In derive mode its
// sibling nb ^ 1 is parent row r - the built row: the block forms the
// sibling's tile in shared memory (S, over the accumulation tiles, which
// are free by now) and writes it to the level histogram, all threads at
// once, 16 bytes a load where B is a multiple of 4. Then each warp takes
// (node, feature) rows of the tile, several a scan (scan_tile), and scans
// each whose feature is in the mask (s_mask) with the split-gain kernel's
// code, from shared memory, keeping (the max gain, the smallest flat index
// f * B + b among the maxima); the block reduces its warps and writes one
// partial per (node, tile). The gain surface is never stored.
__device__ void decide_tile(const LevelArgs& a, int t, int r, int tiles, const Work& w,
                            const float* M, float* S, const int* s_mask) {
  __shared__ float s_gain[2][kMaxWarps];
  __shared__ int s_idx[2][kMaxWarps];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int tile = 1 << a.tile_log2, n_bins = a.n_bins, tb = tile * n_bins;
  const int f0 = t * tile;
  const int nf = min(tile, a.n_feat - f0);
  const int nb = __ldg(a.active + r);
  const int nodes = a.derive ? 2 : 1;
  if (a.derive) {
    const float* pg = a.parent + ((size_t)r * a.n_feat + f0) * n_bins;
    const float* ph = a.parent + ((size_t)(a.rows + r) * a.n_feat + f0) * n_bins;
    float* sg = a.out + ((size_t)(nb ^ 1) * a.n_feat + f0) * n_bins;
    float* sh = a.out + ((size_t)(a.out_rows + (nb ^ 1)) * a.n_feat + f0) * n_bins;
    if ((n_bins & 3) == 0) {
      for (int q = threadIdx.x; q < nf * n_bins / 4; q += blockDim.x) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(pg) + q);
        const float4 ph4 = __ldg(reinterpret_cast<const float4*>(ph) + q);
        const float4 m = reinterpret_cast<const float4*>(M)[q];
        const float4 mh = reinterpret_cast<const float4*>(M + tb)[q];
        const float4 vg = make_float4(p.x - m.x, p.y - m.y, p.z - m.z, p.w - m.w);
        const float4 vh = make_float4(ph4.x - mh.x, ph4.y - mh.y, ph4.z - mh.z, ph4.w - mh.w);
        reinterpret_cast<float4*>(S)[q] = vg;
        reinterpret_cast<float4*>(S + tb)[q] = vh;
        reinterpret_cast<float4*>(sg)[q] = vg;
        reinterpret_cast<float4*>(sh)[q] = vh;
      }
    } else {
      for (int i = threadIdx.x; i < nf * n_bins; i += blockDim.x) {
        S[i] = __ldg(pg + i) - M[i];
        S[tb + i] = __ldg(ph + i) - M[tb + i];
        sg[i] = S[i];
        sh[i] = S[tb + i];
      }
    }
    __syncthreads();
  }
  float best0 = neg_inf(), best1 = neg_inf();
  int idx0 = INT_MAX, idx1 = INT_MAX;
  scan_tile<2, kMaxPer>(a, M, S, s_mask, f0, nf, best0, idx0, best1, idx1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float g0 = __shfl_down_sync(full, best0, o);
    const int i0 = __shfl_down_sync(full, idx0, o);
    const float g1 = __shfl_down_sync(full, best1, o);
    const int i1 = __shfl_down_sync(full, idx1, o);
    take_better(g0, i0, best0, idx0);
    take_better(g1, i1, best1, idx1);
  }
  if (lane == 0) {
    s_gain[0][warp] = best0;
    s_idx[0][warp] = idx0;
    s_gain[1][warp] = best1;
    s_idx[1][warp] = idx1;
  }
  __syncthreads();
  if ((int)threadIdx.x < nodes) {
    const int which = threadIdx.x;
    float best = s_gain[which][0];
    int idx = s_idx[which][0];
    for (int v = 1; v < warps; ++v) take_better(s_gain[which][v], s_idx[which][v], best, idx);
    const size_t at = (size_t)(which ? nb ^ 1 : nb) * tiles + t;
    reinterpret_cast<float*>(a.work + w.part_gain)[at] = best;
    a.work[w.part_idx + at] = idx;
  }
}

// The fused level's route phase: the block reduces every node's partials
// (a warp a node) by (max, then smallest index), which is exact in any
// order and so is
// torch.argmax's first maximum, applies the pass-left fix (feature 0,
// threshold B-1 unless the best gain is finite and > 0) into a shared table
// (block 0 also writes feat / thr / best), then routes one sample per
// thread: new = 2*node + (bins[s, feat[node]] > thr[node]), and -1 -> -2.
__device__ void route(const LevelArgs& a, int tiles, const Work& w, int* table) {
  if (blockIdx.x > 0 && (long long)blockIdx.x * blockDim.x >= a.n) return;
  const float* part_gain = reinterpret_cast<const float*>(a.work + w.part_gain);
  const int* part_idx = a.work + w.part_idx;
  const int lane = threadIdx.x & 31;
  for (int nd = threadIdx.x >> 5; nd < a.n_nodes; nd += blockDim.x >> 5) {  // a warp a node
    float best = neg_inf();
    int idx = INT_MAX;
    for (int t = lane; t < tiles; t += 32)
      take_better(__ldcg(part_gain + (size_t)nd * tiles + t),
                  __ldcg(part_idx + (size_t)nd * tiles + t), best, idx);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float g = __shfl_xor_sync(0xffffffffu, best, o);
      const int i = __shfl_xor_sync(0xffffffffu, idx, o);
      take_better(g, i, best, idx);
    }
    const bool ok = best > 0.f && best < -neg_inf();  // finite and > 0
    const int f = ok ? idx / a.n_bins : 0;
    const int th = ok ? idx % a.n_bins : a.n_bins - 1;
    if (lane == 0) {
      table[nd] = f;
      table[a.n_nodes + nd] = th;
      if (blockIdx.x == 0) {
        a.feat[nd] = f;
        a.thr[nd] = th;
        a.best[nd] = best;
      }
    }
  }
  __syncthreads();
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < a.n;
       s += (long long)gridDim.x * blockDim.x) {
    const int nd = a.node[s];
    int o = 2 * nd;
    if (nd >= 0) {
      const int c = min(nd, a.n_nodes - 1);
      o += a.bins[(size_t)s * a.n_feat + table[c]] > table[a.n_nodes + c];
    }
    a.new_node[s] = o;
  }
}

// The arguments the fused level and the staged histogram both take,
// checked. Returns a cudaError_t.
inline int check_args(const LevelArgs& a) {
  if (a.tile_log2 < 3 || a.tile_log2 > 5 || a.warps < 1 || a.warps > kMaxWarps ||
      a.n_bins < 1 || a.rows < 1 || a.out_rows < a.rows || a.n < 0 || a.n_feat < 1 ||
      a.min_per_column < 1 || a.splits < 1 ||
      a.splits > kMaxSplits || (long long)a.rows * tiles_of(a) * a.splits > INT_MAX ||
      (long long)a.warps * 2 * a.n_bins * 32 * 4 > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

}  // namespace level_common
