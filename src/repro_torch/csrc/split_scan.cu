// Split-gain surface: prefix sums over the bins of every (node, feature) row
// and the regularized gain of every split point; in its decision form also
// each node's first maximum of the surface over the features in a mask.
//
// Replaces the TPU kernel repro/kernels/split_scan.py::split_gain_pallas
// (_split_kernel), and, in the decision form, the masked argmax the staged
// level ran after it (repro/trees/learner.py:192-197).
//
// hist is (2, L, F, B) f32 (grad, hess); gain is (L, F, B) f32 with
//   GL = cumsum(g), HL = cumsum(h), GT/HT the row totals (GL/HL at b = B-1),
//   gain = GL*GL/(HL+lam) + GR*GR/(HR+lam) - GT*GT/(HT+lam),
// and -inf where HL < min_h, HR < min_h, or b = B-1 (no split after the
// last bin): the rules of split_scan.py:41-44. With a mask ((F,) int32, 1 =
// the feature may split), node n's best (f32) and idx (int64) are the first
// maximum of its row of the surface flattened to F*B cells, masked-out
// features counted as -inf: torch.argmax's and jnp.argmax's pick, so a node
// whose cells are all -inf gets idx 0 and -inf.
//
// Bound: bytes. Every histogram cell is read once and every gain cell
// written once; about a dozen flops per cell.
//
// Design:
//  * a warp scans kRows (node, feature) rows at once (level_common::
//    scan_rows, the fused level's own code, so the surface has its bits);
//    lane l owns bins l*PER .. l*PER+PER-1 (PER = ceil(B/32), one instance
//    a PER, so each kernel's registers are what its B needs) and loads and
//    stores them as one float2 or float4 where B is a multiple of PER: a
//    warp instruction moves 256 bytes of g, h or gain;
//  * the grid is what the card holds at once (the occupancy query); block
//    k takes a contiguous run of row groups and its warps take every
//    kWarps-th of them. Past the loads, the scan is bound by its latency
//    (a copy of the same loads and stores takes 0.105 ms at L = 256, B 64,
//    F 1500, against a 0.088 bytes bound; the scan adds 0.02, the decision
//    0.02 more), so warps an SM count more than loads in flight a warp:
//    the next group's loads issued before a scan (more registers, fewer
//    warps), a cp.async ring of three groups a warp in shared memory, and
//    four rows a scan all measured slower (tools/split_gain_variants.py);
//  * the decision: each lane keeps the first maximum of its unmasked
//    cells (it sees them in ascending flat index, so one compare a cell);
//    when the warp's node changes it folds its lanes' maxima as keys, key =
//    (the gain's order-preserving bits, inverted flat index), so the largest key
//    is the largest gain at the smallest index (NaN above all, as
//    torch.argmax takes it), by shuffles; a block's warps meet in a shared
//    table (its rows span few nodes), and each block adds its nodes by a
//    64-bit integer atomicMax. Max is associative and the keys are
//    integers: exact in any order, no float atomic. The last block in (an
//    integer ticket) decodes every node's key (the key holds the gain's
//    bits) and zeroes the keys and the ticket for the next launch, so a
//    level takes one launch and no memset;
//  * the gains' divisions: level_common::div_rn, IEEE division that skips
//    the division's slow path where the dividend is 0 (most cells of a
//    sparse row), bit for bit the same quotient.
#include <cuda_runtime.h>

#include "level_common.cuh"

namespace {

using level_common::kMaxDevices;
using level_common::kMaxPer;
constexpr int kWarps = 8;   // warps a block
constexpr int kRows = 2;    // rows a warp scans at once
constexpr int kSlots = 32;  // nodes of a block's shared merge table
constexpr unsigned kFull = 0xffffffffu;

struct SplitArgs {
  const float* hist;         // (2, rows, B)
  float* gain;               // (rows, B)
  const int* mask;           // (F,); decision form only
  unsigned long long* keys;  // (n_nodes,) then the ticket; zero on entry and exit
  float* best;               // (n_nodes,)
  long long* idx;            // (n_nodes,)
  int rows, n_feat, n_bins, n_nodes, vec;
  float lam, min_h;
};

constexpr int kMaxFlat = 1 << 30;  // F x B: a flat index fits the key's 30 bits

// The order-preserving key of gain v at flat index i < kMaxFlat: larger gain
// first, then the smaller index; -0 ranks as +0 and every NaN above +inf,
// as torch.argmax ranks them. The high word holds v's bits made unsigned
// in order, the low word (kMaxFlat - 1 - i) x 2 and, in bit 0, whether v
// is -0: the key gives v back bit for bit (a NaN as one NaN). 0 is no
// cell.
__device__ __forceinline__ unsigned long long key_of(float v, int i) {
  unsigned u = __float_as_uint(v == 0.f ? 0.f : v);
  u = v != v ? kFull : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const unsigned lo = ((unsigned)(kMaxFlat - 1 - i) << 1) | (__float_as_uint(v) == 0x80000000u);
  return ((unsigned long long)u << 32) | lo;
}

// The gain and flat index of key k (not 0); a NaN comes back as kFull's bits.
__device__ __forceinline__ void key_value(unsigned long long k, float& v, int& i) {
  const unsigned hi = (unsigned)(k >> 32), lo = (unsigned)k;
  i = kMaxFlat - 1 - (int)(lo >> 1);
  const unsigned u = hi == kFull ? kFull : (hi & 0x80000000u) ? hi & 0x7fffffffu : ~hi;
  v = (lo & 1u) ? -0.f : __uint_as_float(u);
}

__device__ __forceinline__ unsigned long long key_max(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// A lane's PER bins of one row from p (g or h): one 8- or 16-byte load
// each where vec (B a multiple of PER, 16-byte aligned rows), else one
// float a bin; bins past B read 0.
template <int PER>
__device__ __forceinline__ void load_bins(const float* __restrict__ p, int b0, int n_bins,
                                          bool vec, float (&v)[PER]) {
  if (vec && (PER == 2 || PER % 4 == 0)) {
    if (b0 < n_bins) {
      if constexpr (PER == 2) {
        const float2 t = __ldcs(reinterpret_cast<const float2*>(p + b0));
        v[0] = t.x;
        v[1] = t.y;
      } else if constexpr (PER % 4 == 0) {
#pragma unroll
        for (int j = 0; j < PER / 4; ++j) {
          const float4 t = __ldcs(reinterpret_cast<const float4*>(p + b0) + j);
          v[4 * j] = t.x;
          v[4 * j + 1] = t.y;
          v[4 * j + 2] = t.z;
          v[4 * j + 3] = t.w;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < PER; ++k) v[k] = 0.f;
    }
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k) v[k] = b0 + k < n_bins ? __ldcs(p + b0 + k) : 0.f;
  }
}

// A lane's PER gains of one row to p, as load_bins reads them.
template <int PER>
__device__ __forceinline__ void store_bins(float* __restrict__ p, int b0, int n_bins, bool vec,
                                           const float (&v)[PER]) {
  if (vec && (PER == 2 || PER % 4 == 0)) {
    if (b0 < n_bins) {
      if constexpr (PER == 2) {
        reinterpret_cast<float2*>(p + b0)[0] = make_float2(v[0], v[1]);
      } else if constexpr (PER % 4 == 0) {
#pragma unroll
        for (int j = 0; j < PER / 4; ++j)
          reinterpret_cast<float4*>(p + b0)[j] =
              make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < PER; ++k)
      if (b0 + k < n_bins) p[b0 + k] = v[k];
  }
}

// Rows grp*kRows .. grp*kRows + kRows-1 of g and h (rows past the last
// read 0).
template <int PER>
__device__ __forceinline__ void load_group(const SplitArgs& a, int grp, int b0,
                                           float (&g)[kRows][PER], float (&h)[kRows][PER]) {
  const size_t plane = (size_t)a.rows * a.n_bins;
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int row = grp * kRows + q;
    const int in = row < a.rows ? a.n_bins : 0;
    const float* gp = a.hist + (size_t)row * a.n_bins;
    load_bins<PER>(gp, b0, in, a.vec, g[q]);
    load_bins<PER>(gp + plane, b0, in, a.vec, h[q]);
  }
}

template <int PER, bool kDecide>
__global__ void __launch_bounds__(32 * kWarps) split_kernel(const SplitArgs a) {
  __shared__ unsigned long long s_keys[kSlots];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = lane * PER;
  const int groups = (a.rows + kRows - 1) / kRows;
  const int per_block = (groups + gridDim.x - 1) / gridDim.x;
  const int g_begin = min(groups, (int)blockIdx.x * per_block);
  const int g_end = min(groups, g_begin + per_block);
  const int node0 = g_begin * kRows / a.n_feat;  // the block's first node
  if (kDecide) {
    if (threadIdx.x < kSlots) s_keys[threadIdx.x] = 0;
    __syncthreads();
  }
  // The lane's first maximum of node cur so far: its unmasked cells come
  // in ascending flat index (rows, then bins, ascending), so a strictly
  // larger gain replaces it; a NaN replaces any number and is kept, as
  // torch.argmax takes it. acc_i < 0: no cell yet.
  float acc = level_common::neg_inf();
  int acc_i = -1, cur = -1;
  auto better = [](float v, float than) { return v > than || (v != v && than == than); };
  // The warp's first maximum of node cur, as a key, to the block's table
  // (or, past its slots, straight to the node's key). Warp-uniform.
  auto flush = [&]() {
    unsigned long long k = acc_i >= 0 ? key_of(acc, acc_i) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) k = key_max(k, __shfl_xor_sync(kFull, k, o));
    if (lane == 0 && k) {
      if (cur - node0 < kSlots)
        atomicMax(s_keys + (cur - node0), k);
      else
        atomicMax(a.keys + cur, k);
    }
  };

  int grp = g_begin + warp;
  // The node and feature of the group's first row, carried from group to
  // group (kWarps x kRows rows on) without a division.
  int node_r = grp * kRows / a.n_feat, feat_r = grp * kRows - node_r * a.n_feat;
  for (; grp < g_end; grp += kWarps) {  // warp-uniform
    float g[kRows][PER], h[kRows][PER];
    load_group<PER>(a, grp, b0, g, h);
    int node[kRows], feat[kRows], bi[kRows];
    bool on[kRows];
    float best[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      int f = feat_r + q, nd = node_r;
      while (f >= a.n_feat) {
        f -= a.n_feat;
        ++nd;
      }
      node[q] = nd;
      feat[q] = f;
      on[q] = kDecide && grp * kRows + q < a.rows && __ldg(a.mask + f) != 0;
      best[q] = level_common::neg_inf();
      bi[q] = -1;
    }
    float out[kRows][PER];
    level_common::scan_rows<kRows, PER>(
        a.n_bins, a.lam, a.min_h,
        [&](int q, int k, int, float& gv, float& hv) {
          gv = g[q][k];
          hv = h[q][k];
        },
        [&](int q, int k, int b, float v) {
          out[q][k] = v;
          if (kDecide && on[q] && better(v, best[q])) {
            best[q] = v;
            bi[q] = feat[q] * a.n_bins + b;
          }
        });
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int row = grp * kRows + q;
      if (row < a.rows) store_bins<PER>(a.gain + (size_t)row * a.n_bins, b0, a.n_bins, a.vec,
                                        out[q]);
    }
    if (kDecide) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        if (grp * kRows + q >= a.rows) break;
        if (node[q] != cur) {
          if (cur >= 0) flush();
          cur = node[q];
          acc = level_common::neg_inf();
          acc_i = -1;
        }
        if (bi[q] >= 0 && (acc_i < 0 || better(best[q], acc))) {
          acc = best[q];
          acc_i = bi[q];
        }
      }
    }
    feat_r += kWarps * kRows;
    while (feat_r >= a.n_feat) {
      feat_r -= a.n_feat;
      ++node_r;
    }
  }
  if (!kDecide) return;
  if (cur >= 0) flush();
  __syncthreads();
  if (threadIdx.x < kSlots && s_keys[threadIdx.x] && node0 + (int)threadIdx.x < a.n_nodes)
    atomicMax(a.keys + node0 + threadIdx.x, s_keys[threadIdx.x]);
  // The last block in decodes every node's key. One thread a block fences
  // and takes the ticket, after the barrier that orders the block's
  // atomics before it (as a cooperative grid's barrier does).
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last =
        atomicAdd(a.keys + a.n_nodes, 1ull) == (unsigned long long)gridDim.x - 1;
    if (last) __threadfence();
    s_last = last;
  }
  __syncthreads();
  if (!s_last) return;
  for (int n = threadIdx.x; n < a.n_nodes; n += blockDim.x) {
    const unsigned long long k = __ldcg(a.keys + n);
    a.keys[n] = 0;  // zero again for the next launch
    float best = level_common::neg_inf();
    int i = 0;
    if (k != 0) key_value(k, best, i);
    if (best == level_common::neg_inf()) i = 0;  // every unmasked cell -inf: argmax's 0
    if (best != best) best = __ldcg(a.gain + (size_t)n * a.n_feat * a.n_bins + i);  // its bits
    a.best[n] = best;
    a.idx[n] = i;
  }
  if (threadIdx.x == 0) a.keys[a.n_nodes] = 0;  // the ticket
}

template <int PER, bool kDecide>
cudaError_t launch(const SplitArgs& a, cudaStream_t st) {
  const void* kernel = (const void*)split_kernel<PER, kDecide>;
  // The blocks the card holds at once, asked once a device.
  static int held[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (held[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * kWarps, 0)) !=
        cudaSuccess)
      return err;
    held[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const long long groups = (a.rows + kRows - 1) / kRows;
  long long grid = (groups + kWarps - 1) / kWarps;
  if (grid > held[dev]) grid = held[dev];
  if (grid < 1) grid = 1;
  split_kernel<PER, kDecide><<<(unsigned)grid, 32 * kWarps, 0, st>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_per(int per, const SplitArgs& a, cudaStream_t st) {
  if constexpr (P > 1) {
    if (per < P) return launch_per<P - 1>(per, a, st);
  }
  return a.mask ? launch<P, true>(a, st) : launch<P, false>(a, st);
}

}  // namespace

// hist (2, rows, B) and gain (rows, B), rows = n_nodes x F. mask null: the
// surface alone. Otherwise mask (F,) int32, best (n_nodes,) f32, idx
// (n_nodes,) int64 and work: n_nodes + 1 64-bit words of scratch (each
// node's key, then the ticket), zero on entry and left zero by the last
// block, so launches that share it run one after another (one stream).
extern "C" int split_gain_launch(const void* hist, void* gain, const void* mask, void* work,
                                 void* best, void* idx, int n_nodes, int n_feat, int n_bins,
                                 float lam, float min_h, void* stream) {
  if (n_bins < 1 || n_bins > 32 * kMaxPer || n_nodes < 1 || n_feat < 1 ||
      (long long)n_nodes * n_feat * n_bins > 0x7fffffffLL ||
      (long long)n_feat * n_bins > kMaxFlat ||
      (mask && (!work || !best || !idx)))
    return (int)cudaErrorInvalidValue;
  const int per = (n_bins + 31) / 32;
  SplitArgs a = {};
  a.hist = (const float*)hist;
  a.gain = (float*)gain;
  a.mask = (const int*)mask;
  a.keys = (unsigned long long*)work;
  a.best = (float*)best;
  a.idx = (long long*)idx;
  a.rows = n_nodes * n_feat;
  a.n_feat = n_feat;
  a.n_bins = n_bins;
  a.n_nodes = n_nodes;
  const size_t align = per == 2 ? 8 : 16;  // the float2 or float4 of PER 2, 4, 8
  a.vec = n_bins % per == 0 && (size_t)hist % align == 0 && (size_t)gain % align == 0;
  a.lam = lam;
  a.min_h = min_h;
  return (int)launch_per<kMaxPer>(per, a, (cudaStream_t)stream);
}
