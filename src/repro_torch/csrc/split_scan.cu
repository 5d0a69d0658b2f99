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
// block; lane l owns ceil(B/32) consecutive bins. The scan and the gain are
// level_common::warp_scan_gain, the fused level's own code, so the two give
// the same bits.
#include <cuda_runtime.h>

#include "level_common.cuh"

namespace {

using level_common::kMaxPer;
constexpr int kWarps = 8;  // rows per block

__global__ void __launch_bounds__(32 * kWarps)
split_gain_kernel(const float* __restrict__ hist, float* __restrict__ gain, int rows,
                  int n_bins, float lam, float min_h) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const float* g = hist + (size_t)row * n_bins;
  const float* h = hist + ((size_t)rows + row) * n_bins;
  float* out = gain + (size_t)row * n_bins;
  level_common::warp_scan_gain(
      n_bins, lam, min_h,
      [&](int, int b, float& gv, float& hv) {
        gv = g[b];
        hv = h[b];
      },
      [&](int, int b, float v) { out[b] = v; });
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
