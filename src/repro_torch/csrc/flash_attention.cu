// Attention forward with an online softmax (flash attention), causal or
// full, with grouped-query heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel). It computes what _flash_kernel
// computes, for one (q head, 64-row q tile) per block:
//   s   = (q . k^T) * (1 / sqrt(d)) in f32; -1e30 where the key is at or
//         past seq_k or, if causal, where q_pos < k_pos (both from 0:
//         the mask is top-left aligned, also when Sq != Sk);
//   m   = running row max, l = running normalizer, both f32;
//   p   = exp(s - m), 0 where masked, cast to v's dtype before p . v;
//   acc = acc * exp(m_prev - m) + p . v in f32;
//   out = acc / max(l, 1e-30) in q's dtype, lse = m + ln(max(l, 1e-30)).
// The exponentials are exp2 of (x * log2 e); lse stays a natural log. The
// kv head of q head h is h / group. A -1e30 (not -inf) mask keeps a row
// whose first tile is fully masked from poisoning m.
//
// Layout: q is read as (B, H, Sq, d) and k, v as (B, KV, Sk, d) through
// the strides the wrapper passes (the last dimension contiguous), so the
// model's (B, S, H, d) tensors are read in place with no transpose copy;
// out is written through its strides the same way; lse is (B*H, Sq).
// Rows at or past Sq are never stored; key rows at or past seq_k are
// loaded as zeros and masked, so they add exactly 0.
//
// Bound: at the serving path's prefill (B = 4, S = 2048, H = 32, KV = 8,
// d = 64, bf16, causal) it moves q, k, v, out and lse, about 85 MB (25 us
// at 3.35 TB/s), and does 4 * B * H * S^2 * d / 2 = 68.7 GFLOP in the
// tensor cores (69 us at 989 TFLOP/s): bound by operations. The design
// keeps the two products on the tensor cores and never writes a score to
// device memory:
//   * bf16: four warps, each owning 16 q rows whose A fragments stay in
//     registers; 64-key tiles of K and V staged in shared memory (rows
//     padded by 8 so ldmatrix is free of bank conflicts); q . k^T and
//     p . v through mma.sync.m16n8k16 with bf16 inputs and f32
//     accumulators; the score accumulators are re-packed in registers as
//     the A operand of p . v. Tiles wholly above the diagonal are skipped,
//     as the TPU kernel skips them; q tiles run heaviest first.
//   * f32 (the reduced test configs): the same tiling with scalar f32
//     products (TF32 would not be the f32 function): a lane per key of a
//     32-key tile for q . k^T, a lane per output column for p . v.
// wgmma, TMA and a pipeline of tiles are later work. There are no atomics:
// two launches give the same bits.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash_common;

constexpr int kBQ = 64;  // q rows a block, 16 a warp

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int heads, group, sq, seq_k, causal;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
};

__device__ __forceinline__ bool key_valid(const Args& a, int row, int key) {
  return key < a.seq_k && (!a.causal || row >= key);
}

// Key tiles a q tile starting at q0 needs: keys below seq_k and, if causal,
// below the tile's last row + 1.
__device__ __forceinline__ int key_end(const Args& a, int q0) {
  return a.causal ? min(a.seq_k, q0 + kBQ) : a.seq_k;
}

// ------------------------------------------------------------------ bf16

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_bf16(Args a) {
  constexpr int kBK = 64;     // keys a tile
  constexpr int kLD = D + 8;  // padded shared row: 16-byte aligned, conflict-free ldmatrix
  __shared__ __align__(16) bf16 ks[kBK * kLD];
  __shared__ __align__(16) bf16 vs[kBK * kLD];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads, kvh = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  // The q tile goes through ks once; each warp keeps its A fragments.
  load_tile<D, kLD, kBQ>(ks, qp, a.q_ss, q0, a.sq);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], ks + (16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8) * kLD + 16 * kk +
                            (lane >> 4) * 8);
  __syncthreads();

  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  const int kend = key_end(a, q0);

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    load_tile<D, kLD, kBK>(ks, kp, a.k_ss, k0, a.seq_k);
    load_tile<D, kLD, kBK>(vs, vp, a.v_ss, k0, a.seq_k);
    __syncthreads();

    // s = q . k^T: n-tile j holds keys k0 + 8j .. 8j + 7.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + (16 * jp + (lane & 7) + (lane >> 4) * 8) * kLD + 16 * kk +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // Online softmax. Element e of n-tile j is (row0 + 8 * (e >> 1),
    // key k0 + 8j + 2t + (e & 1)); a row's four owners are one quad.
    const bool full = k0 + kBK <= a.seq_k && (!a.causal || k0 + kBK - 1 <= q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * a.scale;
        if (!full && !key_valid(a, row0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1)))
          x = kMasked;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
    }
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f((s[j][e] - mx[e >> 1]) * kLog2e);
        if (!full && !key_valid(a, row0 + 8 * (e >> 1), k0 + 8 * j + 2 * t + (e & 1))) p = 0.f;
        s[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(kFull, rs[r], 1);
      rs[r] += __shfl_xor_sync(kFull, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[j][0] *= alpha[0];
      oacc[j][1] *= alpha[0];
      oacc[j][2] *= alpha[1];
      oacc[j][3] *= alpha[1];
    }

    // acc += p (bf16) . v: the C fragments of n-tiles 2kk, 2kk + 1 are the
    // A fragment of keys 16kk .. 16kk + 15.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vs + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLD +
                                  16 * jp + (lane >> 4) * 8);
        mma_bf16(oacc[2 * jp], pa, vb[0], vb[1]);
        mma_bf16(oacc[2 * jp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.sq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    bf16* op = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + 2 * t) =
          __floats2bfloat162_rn(oacc[j][2 * r] / lr, oacc[j][2 * r + 1] / lr);
    if (t == 0) a.lse[(long long)bh * a.sq + row] = m[r] + logf(lr);
  }
}

// ------------------------------------------------------------------- f32

constexpr int kBKf = 32;  // keys a tile: one a lane

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kBQ * D + kBKf * (D + 1) + kBKf * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(Args a) {
  constexpr int kNI = (D + 31) / 32;  // output columns a lane
  extern __shared__ float sm[];
  float* qs = sm;                  // [kBQ][D]
  float* ks = qs + kBQ * D;        // [kBKf][D + 1]: a lane reads its own key's row
  float* vs = ks + kBKf * (D + 1);  // [kBKf][D]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads, kvh = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[i] = q0 + r < a.sq ? qp[(q0 + r) * a.q_ss + c] : 0.f;
  }
  float acc[16][kNI], m[16], l[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kNI; ++i) acc[r][i] = 0.f;
  }
  const int kend = key_end(a, q0);

  for (int k0 = 0; k0 < kend; k0 += kBKf) {
    __syncthreads();  // the q tile is staged; the previous tile is consumed
    for (int i = threadIdx.x; i < kBKf * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < a.seq_k;
      ks[r * (D + 1) + c] = in ? kp[(k0 + r) * a.k_ss + c] : 0.f;
      vs[i] = in ? vp[(k0 + r) * a.v_ss + c] : 0.f;
    }
    __syncthreads();

    const int key = k0 + lane;
    const float* kr = ks + lane * (D + 1);
    float p[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + 16 * warp + r;
      const float* qr = qs + (16 * warp + r) * D;
      float x = 0.f;
      for (int d = 0; d < D; ++d) x += qr[d] * kr[d];
      x *= a.scale;
      const bool ok = key_valid(a, row, key);
      if (!ok) x = kMasked;
      const float mx = fmaxf(m[r], warp_max(x));
      const float alpha = exp2f((m[r] - mx) * kLog2e);
      p[r] = ok ? exp2f((x - mx) * kLog2e) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = mx;
#pragma unroll
      for (int i = 0; i < kNI; ++i) acc[r][i] *= alpha;
    }
    for (int j = 0; j < kBKf; ++j) {
      float vj[kNI];
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < D ? vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float pj = __shfl_sync(kFull, p[r], j);
#pragma unroll
        for (int i = 0; i < kNI; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + 16 * warp + r;
    if (row >= a.sq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_ss;
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int d = lane + 32 * i;
      if (d < D) op[d] = acc[r][i] / lr;
    }
    if (lane == 0) a.lse[(long long)bh * a.sq + row] = m[r] + logf(lr);
  }
}

template <int D>
int launch_d(const Args& a, int is_bf16, dim3 grid, cudaStream_t stream) {
  if (is_bf16) {
    flash_fwd_bf16<D><<<grid, kThreads, 0, stream>>>(a);
  } else {
    constexpr size_t smem = f32_smem_bytes<D>();
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: element strides (batch, head, sequence) of (B, H, Sq, d),
// (B, KV, Sk, d), (B, KV, Sk, d) and (B, H, Sq, d) views whose last
// dimension is contiguous; lse: (B * H, Sq) f32. is_bf16: 1 for bf16
// tensors, 0 for f32. Returns a cudaError_t.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse, int is_bf16, int d,
    int batch, int heads, int kv_heads, int sq, int sk, int seq_k, int causal,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 || sq < 1 ||
      seq_k < 1 || seq_k > sk || (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{q,    k,    v,    o,    lse,  heads, heads / kv_heads, sq,   seq_k, causal,
         q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,  v_sb,  v_sh,  v_ss,  o_sb,  o_sh,  o_ss,
         (float)(1.0 / sqrt((double)d))};
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_d<32>(a, is_bf16, grid, st);
    case 64: return launch_d<64>(a, is_bf16, grid, st);
    case 80: return launch_d<80>(a, is_bf16, grid, st);
    case 128: return launch_d<128>(a, is_bf16, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
