// Split-gain surface: prefix sums over the bins of every (node, feature) row
// and the regularized gain of every split point.
//
// Replaces the TPU kernel repro/kernels/split_scan.py::split_gain_pallas
// (_split_kernel).
//
// hist is (2, L, F, B) f32 (grad, hess); gain is (L, F, B) f32 with
//   GL = cumsum(g), HL = cumsum(h), GT/HT the row totals (GL/HL at b = B-1),
//   gain = GL*GL/(HL+lam) + GR*GR/(HR+lam) - GT*GT/(HT+lam),
// and -inf where HL < min_h, HR < min_h, or b = B-1 (no split after the
// last bin): the rules of split_scan.py:41-44.
//
// Bound: bytes. Every histogram cell is read once and every gain cell
// written once; about a dozen flops per cell.
//
// Design: one warp per (node, feature) row, so the scan never crosses a
// block. Lane l owns ceil(B/32) consecutive bins: it scans them in
// registers, a shuffle scan over the 32 lane totals gives each lane its
// offset, and the totals are the left sums of bin B-1, broadcast from the
// lane that holds it (as the reference takes gl[..., -1]).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPer = 8;  // bins per lane: B <= 256
constexpr int kWarps = 8;   // rows per block

__global__ void __launch_bounds__(32 * kWarps)
split_gain_kernel(const float* __restrict__ hist, float* __restrict__ gain, int rows,
                  int n_bins, float lam, float min_h) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const int per = (n_bins + 31) / 32;
  const int b0 = lane * per;
  const float* g = hist + (size_t)row * n_bins;
  const float* h = hist + ((size_t)rows + row) * n_bins;

  float gl[kMaxPer], hl[kMaxPer];
  float sg = 0.f, sh = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int b = b0 + k;
    if (k < per && b < n_bins) {
      sg += g[b];
      sh += h[b];
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

  float* out = gain + (size_t)row * n_bins;
#pragma unroll
  for (int k = 0; k < kMaxPer; ++k) {
    const int b = b0 + k;
    if (k < per && b < n_bins) {
      const float gr = gt - gl[k];
      const float hr = ht - hl[k];
      const float v = gl[k] * gl[k] / (hl[k] + lam) + gr * gr / (hr + lam) - parent;
      const bool ok = hl[k] >= min_h && hr >= min_h && b < n_bins - 1;
      out[b] = ok ? v : -__int_as_float(0x7f800000);
    }
  }
}

}  // namespace

extern "C" int split_gain_launch(const void* hist, void* gain, int rows, int n_bins,
                                 float lam, float min_h, void* stream) {
  if (n_bins < 1 || n_bins > 32 * kMaxPer) return (int)cudaErrorInvalidValue;
  const int grid = (rows + kWarps - 1) / kWarps;
  split_gain_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      (const float*)hist, (float*)gain, rows, n_bins, lam, min_h);
  return (int)cudaGetLastError();
}
