// Device code shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu): the mma.sync / ldmatrix fragment
// helpers, the shared-tile load and the warp reductions.
//
// mma.m16n8k16 fragments, with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major): a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8,
//     the same cols), a[2] = (row g, cols 8+2t, 9+2t), a[3] = (row g+8, ...);
//   B (16 x 8, "col"): b0 = (rows 2t, 2t+1, col g), b1 = (rows 8+2t, ...);
//   C (16 x 8, f32): c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (row
//     g+8, the same cols).
// So the C fragments of two adjacent n-tiles, packed to bf16, are the A
// fragment of the 16 columns they cover: a product's result feeds the next
// product without leaving registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_common {

constexpr int kThreads = 128;  // four warps a block
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows r0 .. r0+15, columns c0 .. c0+15 of a row-major
// shared tile with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&r)[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(r, tile + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + (lane >> 4) * 8);
}

// The B fragments of two n-tiles (rows n0 .. n0+7 and n0+8 .. n0+15 of the
// tile) over the k columns c0 .. c0+15, for a product with the tile's
// transpose (x . tile^T): {r[0], r[1]} is n-tile n0, {r[2], r[3]} n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b_t(uint32_t (&r)[4], const bf16* tile, int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(r, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + c0 + ((lane >> 3) & 1) * 8);
}

// The B fragments of two n-tiles (columns c0 .. c0+7 and c0+8 .. c0+15)
// over the k rows k0 .. k0+15, for a product with the tile itself
// (x . tile): {r[0], r[1]} is n-tile c0, {r[2], r[3]} c0 + 8.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile, int k0, int c0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4_trans(r, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
                           (lane >> 4) * 8);
}

// rows [r0, r0 + ROWS) of a (rows, D) bf16 matrix with row stride ss into
// shared memory with row stride LD; rows at or past `limit` become zeros.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long ss, int r0,
                                          int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// The f32 twin of load_tile, element by element.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long ss,
                                              int r0, int limit) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * LD + c] = r0 + r < limit ? src[(r0 + r) * ss + c] : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

}  // namespace flash_common
