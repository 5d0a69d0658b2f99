// Attention backward (flash attention), causal or full, with grouped-query
// heads: dq, dk and dv from q, k, v, out, lse and the output gradient do.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_bwd_pallas: _flash_bwd_dq_kernel (dq) and
// _flash_bwd_dkv_kernel (dk, dv), and the row sums delta its wrapper takes
// outside the pallas_call. Nothing quadratic is stored; both kernels
// recompute P from (q, k, lse):
//   delta = rowsum(do * out) in f32                (kernel flash_bwd_delta);
//   s  = (q . k^T) * scale, scale = 1 / sqrt(d), f32;
//   p  = exp(s - lse), 0 where the key is at or past seq_k, the query at
//        or past Sq or, if causal, q_pos < k_pos (top-left aligned, as in
//        the forward);
//   dp = do . v^T;  ds = p * (dp - delta);
//   dq = scale * ds . k                            (kernel flash_bwd_dq);
//   dk = scale * ds^T . q, dv = p^T . do, summed over the kv head's group
//        of q heads                                (kernel flash_bwd_dkv).
// As on the TPU, the work is split in two kernels so that every output tile
// has one writer: there are no atomics, and two launches give the same
// bits. The price is that s and dp are computed in both kernels (7
// products instead of 5). Roundings stand where the TPU kernels put them:
// p is cast to do's dtype before p^T . do, ds to k's dtype before ds . k
// and to q's dtype before ds^T . q; every accumulator is f32.
//
// Layout: q, out, do, dq are read or written as (B, H, Sq, d) and k, v,
// dk, dv as (B, KV, Sk, d) through the strides the wrapper passes (last
// dimension contiguous), so the model's (B, S, H, d) tensors are used in
// place; lse and delta are (B*H, Sq) f32.
//
// Bound: at the training shape (B = 4, S = 2048, H = 32, KV = 8, d = 64,
// bf16, causal) the function moves about 168 MB (50 us at 3.35 TB/s) and
// does five products over the 8.6 G causal (query, key) pairs of all heads,
// 171.8 GFLOP in the tensor cores (174 us at 989 TFLOP/s): bound by
// operations. The design keeps every product on the tensor cores and no
// score in device memory:
//   * delta: a warp a row.
//   * dq (bf16): a block per (q head, 64-row q tile), four warps of 16 rows;
//     it walks the 64-key tiles up to the diagonal in order. q and do are
//     staged once in shared memory, K and V a tile at a time (rows padded
//     by 8 for conflict-free ldmatrix). s = q . k^T and dp = do . v^T are
//     mma.sync.m16n8k16 (bf16 in, f32 out); ds stays in registers and is
//     re-packed as the A operand of ds . k. f32 registers a thread: dq d/2,
//     s and dp 32 each.
//   * dk/dv (bf16): a block per (kv head, 64-key tile), four warps of 16
//     keys; it walks the group's q heads and, for each, the q tiles from
//     the diagonal on (the TPU's inner order g * nq + iq). s^T = k . q^T and
//     dp^T = v . do^T put the warp's keys in the rows, so p^T and ds^T are
//     A operands straight from registers. The dk and dv accumulators take
//     d f32 registers a thread, so at d = 128 the q tile is 32 rows (s^T and
//     dp^T 16 registers each) and 64 below.
//   * f32 (the reduced test configs): the same split with scalar f32
//     products (TF32 would not be the f32 function): a lane per key (dq) or
//     per query (dk/dv) for the scores, a lane per output column for the
//     accumulations.
// wgmma, TMA and a pipeline of tiles are later work.
#include <math.h>

#include "flash_common.cuh"

namespace {

using namespace flash_common;

constexpr int kBQ = 64;   // dq: q rows a block, 16 a warp
constexpr int kBK = 64;   // bf16 dq: keys a tile; bf16 dk/dv: keys a block, 16 a warp
constexpr int kBKf = 32;  // f32 dq: keys a tile (a lane each); f32 dk/dv: keys a block
constexpr int kBQf = 32;  // f32 dk/dv: q rows a tile, a lane each

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int heads, kv_heads, group, sq, sk, seq_k, causal;
  // element strides (batch, head, sequence) of q, k, v, out, do, dq, dk, dv
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  float scale;
};

// The (query, key) pair is kept by the mask.
__device__ __forceinline__ bool keep(const BwdArgs& a, int row, int key) {
  return key < a.seq_k && row < a.sq && (!a.causal || row >= key);
}

// The keys a q tile starting at q0 (bq rows) sees: below seq_k and, if
// causal, below the tile's last row + 1.
__device__ __forceinline__ int key_end(const BwdArgs& a, int q0, int bq) {
  return a.causal ? min(a.seq_k, q0 + bq) : a.seq_k;
}

// The first q tile (of bq rows) that sees key k0: the diagonal's under the
// causal mask.
__device__ __forceinline__ int first_q_tile(const BwdArgs& a, int k0, int bq) {
  return a.causal ? k0 / bq : 0;
}

// ----------------------------------------------------------------- delta

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// delta[bh, row] = sum_d do * out in f32: a warp a row, lanes over d, then
// a butterfly sum (a fixed order).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(BwdArgs a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (kThreads / 32) + warp, bh = blockIdx.y;
  if (row >= a.sq) return;
  const int b = bh / a.heads, h = bh % a.heads;
  const T* op = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_ss;
  const T* gp = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh + row * a.do_ss;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += to_f32(gp[c]) * to_f32(op[c]);
  acc = warp_sum(acc);
  if (lane == 0) a.delta[(long long)bh * a.sq + row] = acc;
}

// ------------------------------------------------------------------ bf16

template <int D>
constexpr size_t dq_bf16_smem() {
  return sizeof(bf16) * (2 * kBQ + 2 * kBK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(BwdArgs a) {
  constexpr int kLD = D + 8;  // padded shared row: 16-byte aligned, conflict-free ldmatrix
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [kBQ][kLD]
  bf16* gs = qs + kBQ * kLD;                 // do, [kBQ][kLD]
  bf16* ks = gs + kBQ * kLD;                 // [kBK][kLD]
  bf16* vs = ks + kBK * kLD;                 // [kBK][kLD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group, column pair
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads, kvh = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest causal tiles first
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<D, kLD, kBQ>(qs, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh, a.q_ss,
                         q0, a.sq);
  load_tile<D, kLD, kBQ>(gs, static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh,
                         a.do_ss, q0, a.sq);
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long i = (long long)bh * a.sq + row;
    lse[r] = row < a.sq ? a.lse[i] : 0.f;
    delta[r] = row < a.sq ? a.delta[i] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int kend = key_end(a, q0, kBQ);

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the q tile is staged; the previous K/V tile is consumed
    load_tile<D, kLD, kBK>(ks, kp, a.k_ss, k0, a.seq_k);
    load_tile<D, kLD, kBK>(vs, vp, a.v_ss, k0, a.seq_k);
    __syncthreads();

    // s = q . k^T and dp = do . v^T; n-tile j holds keys k0 + 8j .. 8j + 7.
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], ga[4];
      load_a<kLD>(qa, qs, 16 * warp, 16 * kk);
      load_a<kLD>(ga, gs, 16 * warp, 16 * kk);
#pragma unroll
      for (int jp = 0; jp < kBK / 16; ++jp) {
        uint32_t kb[4], vb[4];
        load_b_t<kLD>(kb, ks, 16 * jp, 16 * kk);
        load_b_t<kLD>(vb, vs, 16 * jp, 16 * kk);
        mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
        mma_bf16(dp[2 * jp], ga, vb[0], vb[1]);
        mma_bf16(dp[2 * jp + 1], ga, vb[2], vb[3]);
      }
    }

    // ds = p * (dp - delta); element e of n-tile j is (row0 + 8 (e >> 1),
    // key k0 + 8j + 2t + (e & 1)). Rows at or past Sq are never stored.
    const bool full = k0 + kBK <= a.seq_k && (!a.causal || k0 + kBK - 1 <= q0);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f((s[j][e] * a.scale - lse[e >> 1]) * kLog2e);
        const int row = row0 + 8 * (e >> 1), key = k0 + 8 * j + 2 * t + (e & 1);
        if (!full && !(key < a.seq_k && (!a.causal || row >= key))) p = 0.f;
        s[j][e] = p * (dp[j][e] - delta[e >> 1]);
      }
    }

    // acc += ds (bf16) . k: the C fragments of n-tiles 2kk, 2kk + 1 are the
    // A fragment of keys 16kk .. 16kk + 15.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jp = 0; jp < D / 16; ++jp) {
        uint32_t kb[4];
        load_b<kLD>(kb, ks, 16 * kk, 16 * jp);
        mma_bf16(acc[2 * jp], da, kb[0], kb[1]);
        mma_bf16(acc[2 * jp + 1], da, kb[2], kb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.sq) continue;
    bf16* op = static_cast<bf16*>(a.dq) + b * a.dq_sb + h * a.dq_sh + row * a.dq_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * r] * a.scale, acc[j][2 * r + 1] * a.scale);
  }
}

// q rows a tile of the bf16 dk/dv kernel: the dk and dv accumulators take d
// f32 registers a thread, s^T and dp^T BQ / 2 together.
template <int D>
__host__ __device__ constexpr int dkv_bq() {
  return D > 80 ? 32 : 64;
}

template <int D>
constexpr size_t dkv_bf16_smem() {
  return sizeof(bf16) * (2 * kBK + 2 * dkv_bq<D>()) * (D + 8) + sizeof(float) * 2 * dkv_bq<D>();
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(BwdArgs a) {
  constexpr int BQ = dkv_bq<D>();
  constexpr int kLD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [kBK][kLD]
  bf16* vs = ks + kBK * kLD;                 // [kBK][kLD]
  bf16* qs = vs + kBK * kLD;                 // [BQ][kLD]
  bf16* gs = qs + BQ * kLD;                  // do, [BQ][kLD]
  float* lse_s = reinterpret_cast<float*>(gs + BQ * kLD);  // [BQ]
  float* delta_s = lse_s + BQ;                             // [BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.y;
  const int b = bkv / a.kv_heads, kvh = bkv % a.kv_heads;
  const int k0 = blockIdx.x * kBK;  // heaviest causal tiles first
  load_tile<D, kLD, kBK>(ks, static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                         a.k_ss, k0, a.seq_k);
  load_tile<D, kLD, kBK>(vs, static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh,
                         a.v_ss, k0, a.seq_k);
  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0 and key0 + 8

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int nq = (a.sq + BQ - 1) / BQ;
  const int iq_first = k0 < a.seq_k ? first_q_tile(a, k0, BQ) : nq;

  for (int gi = 0; gi < a.group; ++gi) {
    const int h = kvh * a.group + gi;
    const long long bh = (long long)b * a.heads + h;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* gp = static_cast<const bf16*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int iq = iq_first; iq < nq; ++iq) {
      const int q0 = iq * BQ;
      __syncthreads();  // K/V are staged; the previous q tile is consumed
      load_tile<D, kLD, BQ>(qs, qp, a.q_ss, q0, a.sq);
      load_tile<D, kLD, BQ>(gs, gp, a.do_ss, q0, a.sq);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        const bool in = q0 + i < a.sq;
        lse_s[i] = in ? a.lse[bh * a.sq + q0 + i] : 0.f;
        delta_s[i] = in ? a.delta[bh * a.sq + q0 + i] : 0.f;
      }
      __syncthreads();

      // s^T = k . q^T and dp^T = v . do^T: this warp's 16 keys in the rows,
      // n-tile j holds queries q0 + 8j .. 8j + 7.
      float s[BQ / 8][4], dp[BQ / 8][4];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<kLD>(ka, ks, 16 * warp, 16 * kk);
        load_a<kLD>(va, vs, 16 * warp, 16 * kk);
#pragma unroll
        for (int jp = 0; jp < BQ / 16; ++jp) {
          uint32_t qb[4], gb[4];
          load_b_t<kLD>(qb, qs, 16 * jp, 16 * kk);
          load_b_t<kLD>(gb, gs, 16 * jp, 16 * kk);
          mma_bf16(s[2 * jp], ka, qb[0], qb[1]);
          mma_bf16(s[2 * jp + 1], ka, qb[2], qb[3]);
          mma_bf16(dp[2 * jp], va, gb[0], gb[1]);
          mma_bf16(dp[2 * jp + 1], va, gb[2], gb[3]);
        }
      }

      // p^T, then ds^T = p^T * (dp^T - delta); element e of n-tile j is
      // (key0 + 8 (e >> 1), query q0 + 8j + 2t + (e & 1)).
      const bool full = k0 + kBK <= a.seq_k && q0 + BQ <= a.sq &&
                        (!a.causal || q0 >= k0 + kBK - 1);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * j + 2 * t + (e & 1);
          float p = exp2f((s[j][e] * a.scale - lse_s[qi]) * kLog2e);
          if (!full && !keep(a, q0 + qi, key0 + 8 * (e >> 1))) p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - delta_s[qi]);
        }
      }

      // dv += p^T (bf16) . do and dk += ds^T (bf16) . q: the C fragments of
      // n-tiles 2kk, 2kk + 1 are the A fragment of queries 16kk .. 16kk + 15.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                                pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
        for (int jp = 0; jp < D / 16; ++jp) {
          uint32_t gb[4], qb[4];
          load_b<kLD>(gb, gs, 16 * kk, 16 * jp);
          load_b<kLD>(qb, qs, 16 * kk, 16 * jp);
          mma_bf16(dv[2 * jp], pa, gb[0], gb[1]);
          mma_bf16(dv[2 * jp + 1], pa, gb[2], gb[3]);
          mma_bf16(dk[2 * jp], da, qb[0], qb[1]);
          mma_bf16(dk[2 * jp + 1], da, qb[2], qb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= a.sk) continue;
    bf16* kp = static_cast<bf16*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh + key * a.dk_ss;
    bf16* vp = static_cast<bf16*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh + key * a.dv_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(kp + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dk[j][2 * r] * a.scale, dk[j][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(vp + 8 * j + 2 * t) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------- f32

template <int D>
constexpr size_t dq_f32_smem() {
  return sizeof(float) * (2 * kBQ * D + 2 * kBKf * (D + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(BwdArgs a) {
  constexpr int kNI = (D + 31) / 32;  // output columns a lane
  extern __shared__ float smf[];
  float* qs = smf;                   // [kBQ][D]
  float* gs = qs + kBQ * D;          // do, [kBQ][D]
  float* ks = gs + kBQ * D;          // [kBKf][D + 1]: a lane reads its own key's row
  float* vs = ks + kBKf * (D + 1);   // [kBKf][D + 1]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads, kvh = h / a.group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile_f32<D, D, kBQ>(qs, static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh,
                           a.q_ss, q0, a.sq);
  load_tile_f32<D, D, kBQ>(gs, static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh,
                           a.do_ss, q0, a.sq);
  float lse[16], delta[16], acc[16][kNI];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + 16 * warp + r;
    const long long i = (long long)bh * a.sq + row;
    lse[r] = row < a.sq ? a.lse[i] : 0.f;
    delta[r] = row < a.sq ? a.delta[i] : 0.f;
#pragma unroll
    for (int c = 0; c < kNI; ++c) acc[r][c] = 0.f;
  }
  const int kend = key_end(a, q0, kBQ);

  for (int k0 = 0; k0 < kend; k0 += kBKf) {
    __syncthreads();
    load_tile_f32<D, D + 1, kBKf>(ks, kp, a.k_ss, k0, a.seq_k);
    load_tile_f32<D, D + 1, kBKf>(vs, vp, a.v_ss, k0, a.seq_k);
    __syncthreads();

    const int key = k0 + lane;
    const float* kr = ks + lane * (D + 1);
    const float* vr = vs + lane * (D + 1);
    float ds[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = q0 + 16 * warp + r;
      const float* qr = qs + (16 * warp + r) * D;
      const float* gr = gs + (16 * warp + r) * D;
      float x = 0.f, y = 0.f;
      for (int c = 0; c < D; ++c) {
        x += qr[c] * kr[c];
        y += gr[c] * vr[c];
      }
      float p = exp2f((x * a.scale - lse[r]) * kLog2e);
      if (!(key < a.seq_k && (!a.causal || row >= key))) p = 0.f;
      ds[r] = p * (y - delta[r]);
    }
    for (int j = 0; j < kBKf; ++j) {
      float kj[kNI];
#pragma unroll
      for (int c = 0; c < kNI; ++c) {
        const int col = lane + 32 * c;
        kj[c] = col < D ? ks[j * (D + 1) + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
        for (int c = 0; c < kNI; ++c) acc[r][c] += dsj * kj[c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + 16 * warp + r;
    if (row >= a.sq) continue;
    float* op = static_cast<float*>(a.dq) + b * a.dq_sb + h * a.dq_sh + row * a.dq_ss;
#pragma unroll
    for (int c = 0; c < kNI; ++c) {
      const int col = lane + 32 * c;
      if (col < D) op[col] = acc[r][c] * a.scale;
    }
  }
}

template <int D>
constexpr size_t dkv_f32_smem() {
  return sizeof(float) * (2 * kBKf * D + 2 * kBQf * (D + 1) + 2 * kBQf);
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32(BwdArgs a) {
  constexpr int kNI = (D + 31) / 32;
  constexpr int kKW = kBKf / 4;  // keys a warp
  extern __shared__ float smf[];
  float* ks = smf;                       // [kBKf][D]
  float* vs = ks + kBKf * D;             // [kBKf][D]
  float* qs = vs + kBKf * D;             // [kBQf][D + 1]: a lane reads its own query's row
  float* gs = qs + kBQf * (D + 1);       // do, [kBQf][D + 1]
  float* lse_s = gs + kBQf * (D + 1);    // [kBQf]
  float* delta_s = lse_s + kBQf;         // [kBQf]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bkv = blockIdx.y;
  const int b = bkv / a.kv_heads, kvh = bkv % a.kv_heads;
  const int k0 = blockIdx.x * kBKf;
  load_tile_f32<D, D, kBKf>(ks, static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh,
                            a.k_ss, k0, a.seq_k);
  load_tile_f32<D, D, kBKf>(vs, static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh,
                            a.v_ss, k0, a.seq_k);
  float dk[kKW][kNI], dv[kKW][kNI];
#pragma unroll
  for (int r = 0; r < kKW; ++r)
#pragma unroll
    for (int c = 0; c < kNI; ++c) dk[r][c] = dv[r][c] = 0.f;
  const int nq = (a.sq + kBQf - 1) / kBQf;
  const int iq_first = k0 < a.seq_k ? first_q_tile(a, k0, kBQf) : nq;

  for (int gi = 0; gi < a.group; ++gi) {
    const int h = kvh * a.group + gi;
    const long long bh = (long long)b * a.heads + h;
    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
    const float* gp = static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int iq = iq_first; iq < nq; ++iq) {
      const int q0 = iq * kBQf;
      __syncthreads();
      load_tile_f32<D, D + 1, kBQf>(qs, qp, a.q_ss, q0, a.sq);
      load_tile_f32<D, D + 1, kBQf>(gs, gp, a.do_ss, q0, a.sq);
      for (int i = threadIdx.x; i < kBQf; i += kThreads) {
        const bool in = q0 + i < a.sq;
        lse_s[i] = in ? a.lse[bh * a.sq + q0 + i] : 0.f;
        delta_s[i] = in ? a.delta[bh * a.sq + q0 + i] : 0.f;
      }
      __syncthreads();

      const int row = q0 + lane;
      const float* qr = qs + lane * (D + 1);
      const float* gr = gs + lane * (D + 1);
      float p[kKW], ds[kKW];
#pragma unroll
      for (int r = 0; r < kKW; ++r) {
        const int key = k0 + kKW * warp + r;
        const float* kr = ks + (kKW * warp + r) * D;
        const float* vr = vs + (kKW * warp + r) * D;
        float x = 0.f, y = 0.f;
        for (int c = 0; c < D; ++c) {
          x += qr[c] * kr[c];
          y += gr[c] * vr[c];
        }
        float pr = exp2f((x * a.scale - lse_s[lane]) * kLog2e);
        if (!keep(a, row, key)) pr = 0.f;
        p[r] = pr;
        ds[r] = pr * (y - delta_s[lane]);
      }
      for (int j = 0; j < kBQf; ++j) {
        float qj[kNI], gj[kNI];
#pragma unroll
        for (int c = 0; c < kNI; ++c) {
          const int col = lane + 32 * c;
          qj[c] = col < D ? qs[j * (D + 1) + col] : 0.f;
          gj[c] = col < D ? gs[j * (D + 1) + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kKW; ++r) {
          const float pj = __shfl_sync(kFull, p[r], j);
          const float dsj = __shfl_sync(kFull, ds[r], j);
#pragma unroll
          for (int c = 0; c < kNI; ++c) {
            dv[r][c] += pj * gj[c];
            dk[r][c] += dsj * qj[c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kKW; ++r) {
    const int key = k0 + kKW * warp + r;
    if (key >= a.sk) continue;
    float* kp = static_cast<float*>(a.dk) + b * a.dk_sb + kvh * a.dk_sh + key * a.dk_ss;
    float* vp = static_cast<float*>(a.dv) + b * a.dv_sb + kvh * a.dv_sh + key * a.dv_ss;
#pragma unroll
    for (int c = 0; c < kNI; ++c) {
      const int col = lane + 32 * c;
      if (col < D) {
        kp[col] = dk[r][c] * a.scale;
        vp[col] = dv[r][c];
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <typename K>
int launch(K kernel, dim3 grid, size_t smem, const BwdArgs& a, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(int which, const BwdArgs& a, int batch, int is_bf16, cudaStream_t st) {
  const unsigned bh = batch * a.heads, bkv = batch * a.kv_heads;
  if (which == 0) {
    const dim3 grid((a.sq + kThreads / 32 - 1) / (kThreads / 32), bh);
    return is_bf16 ? launch(flash_bwd_delta<bf16, D>, grid, 0, a, st)
                   : launch(flash_bwd_delta<float, D>, grid, 0, a, st);
  }
  if (which == 1) {
    const dim3 grid((a.sq + kBQ - 1) / kBQ, bh);
    return is_bf16 ? launch(flash_bwd_dq_bf16<D>, grid, dq_bf16_smem<D>(), a, st)
                   : launch(flash_bwd_dq_f32<D>, grid, dq_f32_smem<D>(), a, st);
  }
  if (is_bf16) return launch(flash_bwd_dkv_bf16<D>, dim3((a.sk + kBK - 1) / kBK, bkv),
                             dkv_bf16_smem<D>(), a, st);
  return launch(flash_bwd_dkv_f32<D>, dim3((a.sk + kBKf - 1) / kBKf, bkv), dkv_f32_smem<D>(),
                a, st);
}

}  // namespace

// One of the backward's three kernels: which = 0 delta (writes delta), 1 dq
// (reads delta), 2 dk/dv (reads delta); run 0 before 1 and 2 on one stream.
// strides: 24 element strides, (batch, head, sequence) of q, k, v, out, do,
// dq, dk, dv in that order, each a (B, heads, S, d) view whose last
// dimension is contiguous; lse and delta: (B * H, Sq) f32. is_bf16: 1 for
// bf16 tensors, 0 for f32. Returns a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    int which, const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int is_bf16, int d, int batch,
    int heads, int kv_heads, int sq, int sk, int seq_k, int causal, const long long* strides,
    void* stream) {
  if (which < 0 || which > 2 || batch < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || sq < 1 || sk < 1 || seq_k < 1 || seq_k > sk ||
      (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  BwdArgs a{q,     k,     v,     o,     dout,  lse,   delta, dq,    dk,    dv,
            heads, kv_heads, heads / kv_heads, sq, sk, seq_k, causal,
            s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],  s[7],  s[8],  s[9],  s[10], s[11],
            s[12], s[13], s[14], s[15], s[16], s[17], s[18], s[19], s[20], s[21], s[22], s[23],
            (float)(1.0 / sqrt((double)d))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_d<32>(which, a, batch, is_bf16, st);
    case 64: return launch_d<64>(which, a, batch, is_bf16, st);
    case 80: return launch_d<80>(which, a, batch, is_bf16, st);
    case 128: return launch_d<128>(which, a, batch, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
