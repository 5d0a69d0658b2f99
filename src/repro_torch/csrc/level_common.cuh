// Device code shared by the staged kernels (histogram.cu, split_scan.cu) and
// the fused level (level_build.cu).
//
// The fused level must give the staged chain's bits exactly. Floating-point
// sums depend on their order, so the order lives here once: one node row's
// histogram accumulation (warp_hist_row) and one (node, feature) row's scan
// and gain (warp_scan_gain). Each .cu file includes this header; every file
// is compiled with --fmad=false, so no multiply is contracted into an add.
#pragma once

#include <cuda_runtime.h>

namespace level_common {

constexpr int kFeatTile = 32;  // features per histogram warp, one per lane
constexpr int kBatch = 8;      // hits whose loads start together
constexpr int kMaxPer = 8;     // bins per lane in the scan: B <= 256

__device__ __forceinline__ int swz(int b, int lane) {
  return b * kFeatTile + (lane ^ (b & 31));
}

// One warp builds one node row of the histogram for features f0 .. f0+31
// (one per lane): the grad and hess sums, per (feature, bin), over the
// samples s with node[s] == target, written to row out_row of out, a
// (2, out_rows, F, B) array.
//
//  * acc_g / acc_h are the warp's private shared tiles, [bin][32 lanes],
//    n_bins * 32 floats each; no other thread adds into them, so no atomics
//    are needed;
//  * the warp walks the samples in ascending order (32 node ids at a time,
//    one ballot; the hits in lane order), so every cell's adds run in one
//    fixed order and two launches give identical bits;
//  * hits are taken kBatch at a time: their loads all start before the adds;
//  * the lane index is XOR-swizzled by the bin, so the accumulate (lanes
//    differ in bin) and the write-out (lanes walk consecutive bins of one
//    feature) both spread over the 32 banks.
__device__ __forceinline__ void warp_hist_row(
    const int* __restrict__ bins, const int* __restrict__ node,
    const float* __restrict__ grad, const float* __restrict__ hess, int target, int n,
    int n_feat, int n_bins, int f0, float* acc_g, float* acc_h, float* __restrict__ out,
    int out_row, int out_rows) {
  const int lane = threadIdx.x & 31;
  const int f = f0 + lane;
  const bool f_ok = f < n_feat;
  for (int i = lane; i < n_bins * kFeatTile; i += 32) {
    acc_g[i] = 0.f;
    acc_h[i] = 0.f;
  }
  __syncwarp();

  for (int s0 = 0; s0 < n; s0 += 32) {
    const int s = s0 + lane;
    unsigned mask = __ballot_sync(0xffffffffu, s < n && node[s] == target);
    while (mask) {
      int b[kBatch];
      float g[kBatch], h[kBatch];
      int cnt = 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        b[u] = -1;
        g[u] = 0.f;
        h[u] = 0.f;
        if (mask) {
          const int ss = s0 + __ffs(mask) - 1;
          mask &= mask - 1;
          b[u] = f_ok ? bins[(size_t)ss * n_feat + f] : -1;
          g[u] = grad[ss];
          h[u] = hess[ss];
          cnt = u + 1;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u < cnt && (unsigned)b[u] < (unsigned)n_bins) {
          acc_g[swz(b[u], lane)] += g[u];
          acc_h[swz(b[u], lane)] += h[u];
        }
      }
    }
  }
  __syncwarp();

  // The (f0 .. f0+31, every bin) block of one output row is contiguous.
  const int nf = n_feat - f0 < kFeatTile ? n_feat - f0 : kFeatTile;
  for (int gh = 0; gh < 2; ++gh) {
    float* dst = out + ((size_t)(gh * out_rows + out_row) * n_feat + f0) * n_bins;
    const float* src = gh ? acc_h : acc_g;
    for (int i = lane; i < nf * n_bins; i += 32) {
      const int fl = i / n_bins;
      dst[i] = src[swz(i - fl * n_bins, fl)];
    }
  }
}

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
