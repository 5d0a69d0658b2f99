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
// place; lse is (B*H, Sq) f32, delta (B*H, ld) f32 (ld >= Sq, zeros past
// Sq).
//
// Bound: at the training shape (B = 4, S = 2048, H = 32, KV = 8, d = 64,
// bf16, causal) the function moves about 168 MB (50 us at 3.35 TB/s) and
// does five products over the 268.6 M causal (query, key) pairs of all
// heads, 171.8 GFLOP in the tensor cores (174 us at 989 TFLOP/s): bound by
// operations. The split costs seven products: three in dq (104 us) and
// four in dk/dv (139 us); each kernel also recomputes p, one ex2 a pair
// (69 us at the special-function units' 3.87 T/s), which can run under
// the products. Three routes, by (dtype, d), as the forward's
// (kernels/flash_plan.py picks), each a kernel of its own:
//   * "wgmma", bf16 at d 64 and 128 (flash_bwd_dq_wgmma,
//     flash_bwd_dkv_wgmma): persistent grids of one block a
//     multiprocessor, work tiles heaviest first in a snake over the blocks,
//     three warpgroups a block. The producer (one thread; its
//     warpgroup's registers handed to the others by setmaxnreg) loads by
//     TMA over 4-D tensor maps of the strided views into a ring of three
//     stages with full/empty mbarriers; two consumer warpgroups of 64 rows
//     each run every product on wgmma, taking turns to issue them
//     (ping-pong: one's exponentials run under the other's products), and
//     store their outputs by TMA.
//     - dq: a work tile is one q head's 128-row q tile; q and do are
//       loaded once, K and V tiles (128 keys at d 64, 64 at d 128) stream
//       through the ring. s = q . k^T and dp = do . v^T (wgmma, both
//       operands K-major); ds = p (dp - delta) in registers, rounded to
//       bf16; dq += ds . K (wgmma, ds from registers, K read MN-major).
//       Key tile j + 1's s and dp are issued before tile j's ds . K, and
//       j + 1's ds runs under it.
//     - dk/dv: a work tile is one kv head's 128-key tile; K and V are
//       loaded once, the group's q and do tiles (128 rows at d 64, 64 at d
//       128) stream through the ring (each head's from the diagonal on),
//       each with its slices
//       of lse2 = lse log2 e and delta, copied by bulk copy from rows
//       padded to a multiple of 128 (the delta kernel writes both), which
//       the tensor maps could not take at Sq % 4 != 0. s^T = K . q^T and
//       dp^T = V . do^T put the warpgroup's keys in the rows, so p^T and
//       ds^T are A operands from registers: dv += p^T . do and dk += ds^T
//       . q read do and q MN-major.
//     p = ex2(fma(s, scale log2 e, -lse2)) (explicit FMAs: the library's
//     --fmad=false stays for the GBDT kernels), four instructions a score
//     with ds; the issue slots, not the tensor cores, set the pace, so the
//     mask is a second form of the loop, taken only on tiles that cross
//     the diagonal, Sq or seq_k (a compare a score against limits set once
//     a tile). Every product is issued outside any branch (ptxas
//     serializes a wgmma under one), so a warpgroup also computes the few
//     tiles its mask empties.
//   * "mma_sync", bf16 at d 32 and 80 (flash_bwd_dq_bf16,
//     flash_bwd_dkv_bf16):
//     - dq: a block per (q head, 64-row q tile), four warps of 16 rows;
//       it walks the 64-key tiles up to the diagonal in order. q and do
//       are staged once in shared memory, K and V a tile at a time (rows
//       padded by 8 for conflict-free ldmatrix). s = q . k^T and dp = do .
//       v^T are mma.sync.m16n8k16 (bf16 in, f32 out); ds stays in
//       registers and is re-packed as the A operand of ds . k.
//     - dk/dv: a block per (kv head, 64-key tile), four warps of 16 keys;
//       it walks the group's q heads and, for each, the q tiles from the
//       diagonal on (the TPU's inner order g * nq + iq). s^T = k . q^T and
//       dp^T = v . do^T put the warp's keys in the rows, so p^T and ds^T
//       are A operands straight from registers, over q tiles of 64 rows.
//   * "scalar", f32 (the reduced test configs): the same split with scalar
//     f32 products (TF32 would not be the f32 function): a lane per key
//     (dq) or per query (dk/dv) for the scores, a lane per output column
//     for the accumulations.
//   * delta: 16-byte loads, a row over 4 to 32 lanes, for every route.
#include <math.h>

#include <algorithm>

#include "flash_common.cuh"

namespace {

using namespace flash_common;

constexpr int kBQ = 64;   // dq: q rows a block, 16 a warp; bf16 dk/dv: q rows a tile
constexpr int kBK = 64;   // bf16 dq: keys a tile; bf16 dk/dv: keys a block, 16 a warp
constexpr int kBKf = 32;  // f32 dq: keys a tile (a lane each); f32 dk/dv: keys a block
constexpr int kBQf = 32;  // f32 dk/dv: q rows a tile, a lane each

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  float* lse2;  // lse log2 e beside delta (the wgmma route), or null
  void *dq, *dk, *dv;
  int heads, kv_heads, group, sq, sk, seq_k, causal;
  int ld;  // row length of delta and lse2
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

// The dot product of 16 bytes of x and y, in f32.
__device__ __forceinline__ float dot16(const float* x, const float* y) {
  const float4 u = *reinterpret_cast<const float4*>(x), w = *reinterpret_cast<const float4*>(y);
  return u.x * w.x + u.y * w.y + u.z * w.z + u.w * w.w;
}
__device__ __forceinline__ float dot16(const bf16* x, const bf16* y) {
  const uint4 u = *reinterpret_cast<const uint4*>(x), w = *reinterpret_cast<const uint4*>(y);
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(&w);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]), g = __bfloat1622float2(q[i]);
    acc += f.x * g.x;
    acc += f.y * g.y;
  }
  return acc;
}

// Lanes a row of the delta kernel: one 16-byte chunk of do and out each,
// rounded up to a power of two (a shuffle group).
template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  constexpr int chunks = D * (int)sizeof(T) / 16;
  return chunks <= 4 ? 4 : chunks <= 8 ? 8 : chunks <= 16 ? 16 : 32;
}

// delta[bh, row] = sum_d do * out in f32: delta_lanes lanes a row, each
// over one 16-byte chunk, then a butterfly sum over the row's lanes (a
// fixed order); rows Sq .. ld - 1 get 0. Where lse2 is given, lse2[bh,
// row] = lse log2 e beside it (0 past Sq).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(BwdArgs a) {
  constexpr int kVec = 16 / sizeof(T), kLanes = delta_lanes<T, D>();
  const int lane = threadIdx.x % kLanes;
  const int row = blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes, bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  float acc = 0.f;
  if (row < a.sq && lane < D / kVec) {
    const T* op = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh + row * a.o_ss;
    const T* gp = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh + row * a.do_ss;
    acc = dot16(gp + lane * kVec, op + lane * kVec);
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (row < a.ld && lane == 0) {
    const long long i = (long long)bh * a.ld + row;
    a.delta[i] = acc;
    if (a.lse2 != nullptr)
      a.lse2[i] = row < a.sq ? a.lse[(long long)bh * a.sq + row] * kLog2e : 0.f;
  }
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
    lse[r] = row < a.sq ? a.lse[(long long)bh * a.sq + row] : 0.f;
    delta[r] = row < a.sq ? a.delta[(long long)bh * a.ld + row] : 0.f;
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

template <int D>
constexpr size_t dkv_bf16_smem() {
  return sizeof(bf16) * (2 * kBK + 2 * kBQ) * (D + 8) + sizeof(float) * 2 * kBQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_bf16(BwdArgs a) {
  constexpr int BQ = kBQ;  // q rows a tile
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
        delta_s[i] = in ? a.delta[bh * a.ld + q0 + i] : 0.f;
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
    lse[r] = row < a.sq ? a.lse[(long long)bh * a.sq + row] : 0.f;
    delta[r] = row < a.sq ? a.delta[(long long)bh * a.ld + row] : 0.f;
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
        delta_s[i] = in ? a.delta[bh * a.ld + q0 + i] : 0.f;
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

// ----------------------------------------------------------------- wgmma

constexpr int kThreadsW = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kBoxCols = 64;     // a TMA box row: 64 bf16 = 128 bytes, one swizzle row
constexpr int kOutRows = 64;     // each consumer warpgroup stores its own 64 rows
constexpr int kLdRows = 128;     // lse2 and delta rows: a multiple of this (flash_plan.LD_ROWS)
constexpr int kMaxDevices = 64;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536

// The tiling of each instance (kernels/flash_plan.py::BWD_TILING holds the
// same): q rows a tile, keys a tile, ring stages. dq issues key tile j +
// 1's products before tile j's ds . K, so it holds two stages at once and
// three keep one load in flight; dk/dv has no room for that overlap (its
// s^T, dp^T, dk and dv fill the registers at BQ 128, d 64 and at BQ 64, d
// 128). Each was the fastest of the tilings timed at the training shape
// (tools/flash_bwd_variants.py, PERF.md).
template <int D>
struct DqTiling {
  static constexpr int kBQ = 128, kBK = D == 64 ? 128 : 64, kStages = 3;
};
template <int D>
struct DkvTiling {
  static constexpr int kBQ = D == 64 ? 128 : 64, kBK = 128, kStages = D == 64 ? 2 : 3;
};

// Shared memory of the dq kernel, in bytes from a 1024-aligned base: the q,
// do and dq tiles, the ring's K and V tiles, then the mbarriers (full_q,
// empty_q, full[S], empty[S]). kernels/flash_plan.py::bwd_smem_bytes
// computes the same total.
template <int D>
struct DqLayout {
  using T = DqTiling<D>;
  static constexpr int kQBytes = T::kBQ * D * 2, kKVBytes = T::kBK * D * 2;
  static constexpr int kQ = 0, kDo = kQBytes, kO = 2 * kQBytes, kK = 3 * kQBytes;
  static constexpr int kV = kK + T::kStages * kKVBytes, kBar = kV + T::kStages * kKVBytes;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * T::kStages) + 1024;
};

// Shared memory of the dk/dv kernel: the K, V, dk and dv tiles, the ring's
// q and do tiles, its lse2 and delta slices ([stage][2][BQ] f32), then the
// mbarriers (full_kv, empty_kv, full[S], empty[S]).
template <int D>
struct DkvLayout {
  using T = DkvTiling<D>;
  static constexpr int kKBytes = T::kBK * D * 2, kQBytes = T::kBQ * D * 2;
  static constexpr int kK = 0, kV = kKBytes, kDk = 2 * kKBytes, kDv = 3 * kKBytes;
  static constexpr int kQ = 4 * kKBytes, kDo = kQ + T::kStages * kQBytes;
  static constexpr int kRows = kDo + T::kStages * kQBytes;
  static constexpr int kBar = kRows + T::kStages * 2 * T::kBQ * 4;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * T::kStages) + 1024;
};

struct WArgs {
  const float* lse2;   // (B * H, ld): lse log2 e
  const float* delta;  // (B * H, ld)
  int heads, kv_heads, group, sq, sk, seq_k, causal, ld;
  int units;     // (batch, head) pairs: B H (dq) or B KV (dk/dv)
  int n_tiles;   // q tiles (dq) or key tiles (dk/dv) a unit
  int n_qtiles;  // q tiles of the dk/dv kernel's BQ rows
  float c;       // log2 e / sqrt(d): s c is the scaled score in base 2
  float scale;   // 1 / sqrt(d)
};

// The n-th work tile of this block, or -1 past the last. Work tiles are
// numbered heaviest first; blocks take them in a snake (block i takes
// tiles i, 2G - 1 - i, 2G + i, ...), so the heavy and light tiles even out.
__device__ __forceinline__ int block_tile(int n, int total) {
  const int g = gridDim.x, i = blockIdx.x;
  const int w = n * g + ((n & 1) ? g - 1 - i : i);
  return w < total ? w : -1;
}

__device__ __forceinline__ uint32_t parity(int r, int stages) {
  return (uint32_t)((r / stages) & 1);
}

// One arrival a consumer warp on an empty barrier.
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Give x a new, undefined value without an instruction: a product that
// overwrites x (scale-d 0) then does not keep its last value alive.
template <int N>
__device__ __forceinline__ void reg_undef(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(x[i]));
}

// The two consumer warpgroups take turns to issue their products
// (ping-pong), so one's exponentials run under the other's products: named
// barrier 3 + cw is warpgroup cw's turn, which the other warpgroup's pass
// opens. Warpgroup 0's first turn is open; every pass is matched, the last
// of warpgroup 1 by finish().
struct Turns {
  int cw;
  bool started = false;
  __device__ __forceinline__ void turn() {
    if (cw == 1 || started) named_barrier(3 + cw, 256);
    started = true;
  }
  __device__ __forceinline__ void pass() { named_barrier_arrive(4 - cw, 256); }
  __device__ __forceinline__ void finish() {
    if (cw == 0 && started) named_barrier(3, 256);
  }
};

// acc (64 x N) = A . B^T over D columns: A the warpgroup's 64 rows of a
// tile of AR rows, B a tile of N rows, both K-major (column chunk c of a
// tile starts c * rows * 128 bytes in; step kk moves 32 bytes along its
// 128-byte rows).
template <int D, int N, int AR>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint64_t ad, uint64_t bd) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<N>(acc, ad + ((c * AR * 128 + off) >> 4), bd + ((c * N * 128 + off) >> 4), kk > 0);
  }
}

// acc (64 x D) += A . B over K rows: A from registers (bf16 A fragments of
// 16 columns each), B a tile read MN-major; step kk is 16 rows (2048
// bytes) further into it.
template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[D / 2], const uint32_t (&a)[K / 16][4],
                                         uint64_t bd) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) wgmma_rs<D>(acc, a[kk], bd + ((kk * 16 * 128) >> 4));
}

// x (f32, the wgmma accumulator layout) as bf16 A fragments: the
// accumulators of n-tiles 2kk and 2kk + 1 are the A fragment of columns
// 16kk .. 16kk + 15.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&p)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// Stage the warpgroup's 64 rows of acc x mul (bf16) into its rows of an out
// tile (swizzled as TMA writes: unit u of row r at u ^ (r % 8), 64-column
// chunks of `rows` rows), then store them by TMA at (row0, head, batch).
// The previous store of the tile has read it before any thread writes.
template <int D>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, uint8_t* tile, int rows,
                                           const float (&acc)[D / 2], float mul, int cw,
                                           int row0, int head, int batch, int bar) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const bool elected = (threadIdx.x & 127) == 0;
  if (elected) tma_store_wait_read();
  named_barrier(bar, 128);
  const int rw = 16 * warp + g;  // row within the warpgroup's 64; rw % 8 == g
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    uint8_t* chunk = tile + (j / 8) * rows * 128 + cw * 64 * 128;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(chunk + (rw + 8 * i) * 128 + (((j % 8) ^ g) << 4) + 4 * t4) =
          pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
  fence_async_shared();
  named_barrier(bar, 128);
  if (elected) {
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_store_4d(map, tile + c * rows * 128 + cw * 64 * 128, c * kBoxCols, row0, head, batch);
    tma_store_commit();
  }
}

// ------------------------------------------------------------ wgmma: dq

// Work tile w of the dq kernel: one q head's 128-row q tile, heaviest
// first (every (batch, head) of the last q tile, then of the one before).
struct DqTile {
  int q0, b, h, bh, n_tiles;  // n_tiles: key tiles the q tile needs (at least one)
};

template <int D>
__device__ __forceinline__ DqTile dq_tile(const WArgs& a, int w) {
  using T = DqTiling<D>;
  DqTile t;
  t.bh = w % a.units;
  t.q0 = (a.n_tiles - 1 - w / a.units) * T::kBQ;
  t.b = t.bh / a.heads;
  t.h = t.bh % a.heads;
  const int kend = a.causal ? min(a.seq_k, t.q0 + T::kBQ) : a.seq_k;
  t.n_tiles = (kend + T::kBK - 1) / T::kBK;
  return t;
}

// The producer: one thread loads each work tile's q and do tiles once the
// consumers have released the last ones, then its K and V tiles into the
// ring, each after the consumers have released the stage. r counts the
// block's K/V tiles over its work tiles: stage r % S, round r / S.
template <int D>
__device__ __forceinline__ void dq_producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                            const CUtensorMap* tv, const CUtensorMap* tdo,
                                            const WArgs& a, uint8_t* sm, uint64_t* bars) {
  using T = DqTiling<D>;
  using L = DqLayout<D>;
  constexpr int S = T::kStages;
  uint64_t *full_q = bars, *empty_q = bars + 1, *full = bars + 2, *empty = bars + 2 + S;
  int r = 0;
  for (int n = 0;; ++n) {
    const int w = block_tile(n, a.n_tiles * a.units);
    if (w < 0) break;
    const DqTile t = dq_tile<D>(a, w);
    const int kvh = t.h / a.group;
    mbar_wait(empty_q, (n & 1) ^ 1);
    mbar_expect_tx(full_q, 2 * L::kQBytes);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c) {
      tma_load_4d(sm + L::kQ + c * T::kBQ * 128, tq, full_q, c * kBoxCols, t.q0, t.h, t.b);
      tma_load_4d(sm + L::kDo + c * T::kBQ * 128, tdo, full_q, c * kBoxCols, t.q0, t.h, t.b);
    }
    for (int j = 0; j < t.n_tiles; ++j, ++r) {
      const int st = r % S;
      mbar_wait(empty + st, parity(r, S) ^ 1);
      mbar_expect_tx(full + st, 2 * L::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c) {
        tma_load_4d(sm + L::kK + st * L::kKVBytes + c * T::kBK * 128, tk, full + st,
                    c * kBoxCols, j * T::kBK, kvh, t.b);
        tma_load_4d(sm + L::kV + st * L::kKVBytes + c * T::kBK * 128, tv, full + st,
                    c * kBoxCols, j * T::kBK, kvh, t.b);
      }
    }
  }
}

// ds = p (dp - delta) of one key tile, in place of s: element i of s and dp
// (the accumulator layout) is row row0 + 8 ((i >> 1) & 1), key k0 + 8 (i >>
// 2) + 2t + (i & 1); nl = -lse2 and dl = delta of those two rows. With
// MASK, p = 0 where the key's offset 8 (i >> 2) + (i & 1) from k0 + 2t
// passes the row's last kept one, last[r]; without, nothing is masked.
// The two forms keep the mask's compares out of the tiles that need none.
template <int BK, bool MASK>
__device__ __forceinline__ void dq_terms(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                         const float (&nl)[2], const float (&dl)[2],
                                         const WArgs& a, const int (&last)[2]) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    float p = ex2(__fmaf_rn(s[i], a.c, nl[r]));
    if constexpr (MASK) p = 8 * (i >> 2) + (i & 1) > last[r] ? 0.f : p;
    s[i] = p * (dp[i] - dl[r]);
  }
}

// One consumer warpgroup (cw = 0 or 1): rows q0 + 64 cw .. + 63 of each of
// the block's work tiles.
template <int D>
__device__ __forceinline__ void dq_consumer(const CUtensorMap* tdq, const WArgs& a, uint8_t* sm,
                                            uint64_t* bars, int cw) {
  using T = DqTiling<D>;
  using L = DqLayout<D>;
  constexpr int S = T::kStages, BK = T::kBK;
  uint64_t *full_q = bars, *empty_q = bars + 1, *full = bars + 2, *empty = bars + 2 + S;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  // The warpgroup's 64 rows start 64 * 128 bytes into each column chunk.
  const uint64_t qd = wgmma_desc(sm + L::kQ + cw * 64 * 128, 16, 1024);
  const uint64_t dod = wgmma_desc(sm + L::kDo + cw * 64 * 128, 16, 1024);
  auto kdesc = [&](int r) { return wgmma_desc(sm + L::kK + (r % S) * L::kKVBytes, 16, 1024); };
  auto vdesc = [&](int r) { return wgmma_desc(sm + L::kV + (r % S) * L::kKVBytes, 16, 1024); };
  // K read MN-major (keys are the k dimension of ds . K).
  auto ktdesc = [&](int r) {
    return wgmma_desc(sm + L::kK + (r % S) * L::kKVBytes, BK * 128, 1024);
  };

  float s[BK / 2], dp[BK / 2], acc[D / 2];
  uint32_t ds[BK / 16][4];
  Turns turns{cw};
  int r = 0;  // K/V tiles consumed so far
  for (int n = 0;; ++n) {
    const int w = block_tile(n, a.n_tiles * a.units);
    if (w < 0) break;
    const DqTile wt = dq_tile<D>(a, w);
    const int wr0 = wt.q0 + 64 * cw;             // the warpgroup's first row
    const int row0 = wr0 + 16 * warp + g;        // this thread's rows: row0, row0 + 8
    float nl[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long idx = (long long)wt.bh * a.ld + row0 + 8 * i;  // row0 + 8 < ld
      nl[i] = -a.lse2[idx];
      dl[i] = a.delta[idx];
    }
    zero(acc);
    // A key tile is masked where it crosses seq_k or the diagonal of the
    // warpgroup's rows (its products are issued all the same: a wgmma
    // under a branch is serialized by ptxas).
    auto masked = [&](int j) {
      return (j + 1) * BK > a.seq_k || (a.causal && (j + 1) * BK - 1 > wr0);
    };
    auto products = [&](int j) {  // s and dp of key tile j (ring tile r + j)
      mbar_wait(full + (r + j) % S, parity(r + j, S));
      reg_undef(s);  // the products overwrite s and dp
      reg_undef(dp);
      wgmma_fence();
      issue_ss<D, BK, T::kBQ>(s, qd, kdesc(r + j));
      issue_ss<D, BK, T::kBQ>(dp, dod, vdesc(r + j));
      wgmma_commit();
    };
    auto terms = [&](int j) {
      reg_fence(s);
      reg_fence(dp);
      if (masked(j)) {
        // A row keeps keys up to min(seq_k - 1, row if causal): offsets from
        // the thread's first key of the tile.
        const int kb = j * BK + 2 * t4;
        int last[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          last[i] = (a.causal ? min(a.seq_k - 1, row0 + 8 * i) : a.seq_k - 1) - kb;
        dq_terms<BK, true>(s, dp, nl, dl, a, last);
      } else {
        const int none[2] = {0, 0};
        dq_terms<BK, false>(s, dp, nl, dl, a, none);
      }
    };

    auto accumulate = [&](int j) {  // acc += ds . K of key tile j
      reg_fence(acc);
      reg_fence(ds);
      wgmma_fence();
      issue_rs<D, BK>(acc, ds, ktdesc(r + j));
      wgmma_commit();
    };
    auto retire = [&](int j) {  // after wgmma_wait: tile j's ring stage is free
      reg_fence(acc);
      reg_fence(ds);
      release(empty + (r + j) % S);
    };

    // Key tile j's products and tile j - 1's ds . K go to the tensor cores,
    // then tile j's ds is computed while they run.
    mbar_wait(full_q, n & 1);
    turns.turn();
    products(0);
    turns.pass();
    wgmma_wait<0>();
    terms(0);
    pack_a<BK>(ds, s);
    for (int j = 1; j < wt.n_tiles; ++j) {
      turns.turn();
      products(j);
      accumulate(j - 1);
      turns.pass();
      wgmma_wait<1>();
      terms(j);
      wgmma_wait<0>();
      retire(j - 1);
      pack_a<BK>(ds, s);
    }
    turns.turn();
    accumulate(wt.n_tiles - 1);
    turns.pass();
    wgmma_wait<0>();
    retire(wt.n_tiles - 1);
    // Every product reading q and do is done: the producer may load the next.
    release(empty_q);
    r += wt.n_tiles;
    store_rows<D>(tdq, sm + L::kO, T::kBQ, acc, a.scale, cw, wr0, wt.h, wt.b, 1 + cw);
  }
  turns.finish();
  if ((threadIdx.x & 127) == 0) tma_store_wait_all();
}

template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tdq, WArgs a) {
  using L = DqLayout<D>;
  constexpr int S = DqTiling<D>::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);      // full_q: the producer's expect_tx
    mbar_init(bars + 1, 8);  // empty_q: one arrival a consumer warp
    for (int i = 0; i < S; ++i) {
      mbar_init(bars + 2 + i, 1);
      mbar_init(bars + 2 + S + i, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      dq_producer<D>(&tq, &tk, &tv, &tdo, a, sm, bars);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dq_consumer<D>(&tdq, a, sm, bars, threadIdx.x / 128 - 1);
  }
}

// ---------------------------------------------------------- wgmma: dk/dv

// Work tile w of the dk/dv kernel: one kv head's 128-key tile, heaviest
// first (every (batch, kv head) of the first key tile, then of the next).
// Its steps walk the group's q heads and, for each, the q tiles of BQ rows
// from the diagonal on: step i is head i / per_head, q tile iq0 + i %
// per_head. A tile past seq_k or Sq has no step (zero gradients).
struct DkvTile {
  int k0, b, kvh, iq0, per_head, n_steps;
};

template <int D>
__device__ __forceinline__ DkvTile dkv_tile(const WArgs& a, int w) {
  using T = DkvTiling<D>;
  DkvTile t;
  const int unit = w % a.units;
  t.k0 = (w / a.units) * T::kBK;
  t.b = unit / a.kv_heads;
  t.kvh = unit % a.kv_heads;
  t.iq0 = a.causal ? t.k0 / T::kBQ : 0;
  t.per_head = t.k0 < a.seq_k && t.iq0 < a.n_qtiles ? a.n_qtiles - t.iq0 : 0;
  t.n_steps = t.per_head * a.group;
  return t;
}

// The producer: each work tile's K and V once the consumers have released
// the last ones, then each step's q and do tiles with their lse2 and delta
// slices into the ring. nk counts the block's K/V loads, r its steps.
template <int D>
__device__ __forceinline__ void dkv_producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const CUtensorMap* tdo,
                                             const WArgs& a, uint8_t* sm, uint64_t* bars) {
  using T = DkvTiling<D>;
  using L = DkvLayout<D>;
  constexpr int S = T::kStages, BQ = T::kBQ;
  uint64_t *full_kv = bars, *empty_kv = bars + 1, *full = bars + 2, *empty = bars + 2 + S;
  int r = 0, nk = 0;
  for (int n = 0;; ++n) {
    const int w = block_tile(n, a.n_tiles * a.units);
    if (w < 0) break;
    const DkvTile t = dkv_tile<D>(a, w);
    if (t.n_steps == 0) continue;
    mbar_wait(empty_kv, (nk & 1) ^ 1);
    mbar_expect_tx(full_kv, 2 * L::kKBytes);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c) {
      tma_load_4d(sm + L::kK + c * T::kBK * 128, tk, full_kv, c * kBoxCols, t.k0, t.kvh, t.b);
      tma_load_4d(sm + L::kV + c * T::kBK * 128, tv, full_kv, c * kBoxCols, t.k0, t.kvh, t.b);
    }
    ++nk;
    for (int i = 0; i < t.n_steps; ++i, ++r) {
      const int h = t.kvh * a.group + i / t.per_head, q0 = (t.iq0 + i % t.per_head) * BQ;
      const int st = r % S;
      float* rows = reinterpret_cast<float*>(sm + L::kRows) + st * 2 * BQ;
      const long long off = ((long long)t.b * a.heads + h) * a.ld + q0;
      mbar_wait(empty + st, parity(r, S) ^ 1);
      mbar_expect_tx(full + st, 2 * L::kQBytes + 2 * BQ * 4);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c) {
        tma_load_4d(sm + L::kQ + st * L::kQBytes + c * BQ * 128, tq, full + st, c * kBoxCols,
                    q0, h, t.b);
        tma_load_4d(sm + L::kDo + st * L::kQBytes + c * BQ * 128, tdo, full + st,
                    c * kBoxCols, q0, h, t.b);
      }
      bulk_load(rows, a.lse2 + off, BQ * 4, full + st);
      bulk_load(rows + BQ, a.delta + off, BQ * 4, full + st);
    }
  }
}

// p^T (in place of s) and ds^T = p^T (dp^T - delta) (in place of dp) of one
// q tile: element i is key key0 + 8 ((i >> 1) & 1), query q0 + qi with qi =
// 8 (i >> 2) + 2t + (i & 1); lse2 and delta of query qi are rows[qi] and
// rows[BQ + qi]. With MASK, p = 0 unless the query's offset 8 (i >> 2) +
// (i & 1) from q0 + 2t lies in [lo[r], hi[r]), the kept queries of key r.
template <int BQ, bool MASK>
__device__ __forceinline__ void dkv_terms(float (&s)[BQ / 2], float (&dp)[BQ / 2],
                                          const float* rows, const WArgs& a, int t,
                                          const int (&lo)[2], const int (&hi)[2]) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j + 2 * t);
    const float2 dl = *reinterpret_cast<const float2*>(rows + BQ + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e, r = e >> 1, c = 8 * j + (e & 1);
      float p = ex2(__fmaf_rn(s[i], a.c, (e & 1) ? -l2.y : -l2.x));
      if constexpr (MASK) p = c >= lo[r] && c < hi[r] ? p : 0.f;
      s[i] = p;
      dp[i] = p * (dp[i] - ((e & 1) ? dl.y : dl.x));
    }
  }
}

// One consumer warpgroup (cw = 0 or 1): keys k0 + 64 cw .. + 63 of each of
// the block's work tiles.
template <int D>
__device__ __forceinline__ void dkv_consumer(const CUtensorMap* tdk, const CUtensorMap* tdv,
                                             const WArgs& a, uint8_t* sm, uint64_t* bars,
                                             int cw) {
  using T = DkvTiling<D>;
  using L = DkvLayout<D>;
  constexpr int S = T::kStages, BQ = T::kBQ;
  uint64_t *full_kv = bars, *empty_kv = bars + 1, *full = bars + 2, *empty = bars + 2 + S;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const uint64_t kd = wgmma_desc(sm + L::kK + cw * 64 * 128, 16, 1024);
  const uint64_t vd = wgmma_desc(sm + L::kV + cw * 64 * 128, 16, 1024);
  auto qdesc = [&](int r) { return wgmma_desc(sm + L::kQ + (r % S) * L::kQBytes, 16, 1024); };
  auto dodesc = [&](int r) {
    return wgmma_desc(sm + L::kDo + (r % S) * L::kQBytes, 16, 1024);
  };
  // q and do read MN-major (queries are the k dimension of ds^T . q, p^T . do).
  auto qtdesc = [&](int r) {
    return wgmma_desc(sm + L::kQ + (r % S) * L::kQBytes, BQ * 128, 1024);
  };
  auto dotdesc = [&](int r) {
    return wgmma_desc(sm + L::kDo + (r % S) * L::kQBytes, BQ * 128, 1024);
  };
  auto rows = [&](int r) {
    return reinterpret_cast<const float*>(sm + L::kRows) + (r % S) * 2 * BQ;
  };

  float s[BQ / 2], dp[BQ / 2], dk[D / 2], dv[D / 2];
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];
  Turns turns{cw};
  int r = 0, nk = 0;  // steps and K/V loads consumed so far
  for (int n = 0;; ++n) {
    const int w = block_tile(n, a.n_tiles * a.units);
    if (w < 0) break;
    const DkvTile wt = dkv_tile<D>(a, w);
    const int kw0 = wt.k0 + 64 * cw;       // the warpgroup's first key
    const int key0 = kw0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
    zero(dk);
    zero(dv);
    if (wt.n_steps > 0) {
      auto q0_of = [&](int i) { return (wt.iq0 + i % wt.per_head) * BQ; };
      // A q tile is masked where it crosses seq_k, Sq or the diagonal of
      // the warpgroup's keys (its products are issued all the same: a
      // wgmma under a branch is serialized by ptxas).
      auto masked = [&](int i) {
        const int q0 = q0_of(i);
        return kw0 + 64 > a.seq_k || q0 + BQ > a.sq || (a.causal && q0 < kw0 + 63);
      };
      auto products = [&](int i) {  // s^T and dp^T of step i (ring tile r + i)
        mbar_wait(full + (r + i) % S, parity(r + i, S));
        reg_undef(s);  // the products overwrite s^T and dp^T
        reg_undef(dp);
        wgmma_fence();
        issue_ss<D, BQ, T::kBK>(s, kd, qdesc(r + i));
        issue_ss<D, BQ, T::kBK>(dp, vd, dodesc(r + i));
        wgmma_commit();
      };
      auto terms = [&](int i) {
        reg_fence(s);
        reg_fence(dp);
        if (masked(i)) {
          // Key r keeps the queries in [key if causal, Sq), none past seq_k:
          // offsets from the thread's first query of the tile.
          const int qb = q0_of(i) + 2 * t4;
          int lo[2], hi[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + 8 * e;
            lo[e] = (a.causal ? key : 0) - qb;
            hi[e] = (key < a.seq_k ? a.sq : 0) - qb;
          }
          dkv_terms<BQ, true>(s, dp, rows(r + i), a, t4, lo, hi);
        } else {
          const int none[2] = {0, 0};
          dkv_terms<BQ, false>(s, dp, rows(r + i), a, t4, none, none);
        }
      };
      auto pack = [&] {
        pack_a<BQ>(pa, s);
        pack_a<BQ>(da, dp);
      };

      auto accumulate = [&](int i) {  // dv += p^T . do and dk += ds^T . q of step i
        reg_fence(dk);
        reg_fence(dv);
        reg_fence(pa);
        reg_fence(da);
        wgmma_fence();
        issue_rs<D, BQ>(dv, pa, dotdesc(r + i));
        issue_rs<D, BQ>(dk, da, qtdesc(r + i));
        wgmma_commit();
      };
      auto retire = [&](int i) {  // after wgmma_wait: step i's ring stage is free
        reg_fence(dk);
        reg_fence(dv);
        reg_fence(pa);
        reg_fence(da);
        release(empty + (r + i) % S);
      };

      // Each step's products, then its accumulations; the two warpgroups
      // take turns, so one's p^T and ds^T are computed under the other's
      // products.
      mbar_wait(full_kv, nk & 1);
      for (int i = 0; i < wt.n_steps; ++i) {
        turns.turn();
        products(i);
        turns.pass();
        wgmma_wait<0>();
        terms(i);
        pack();
        turns.turn();
        accumulate(i);
        turns.pass();
        wgmma_wait<0>();
        retire(i);
      }
      release(empty_kv);
      ++nk;
      r += wt.n_steps;
    }
    store_rows<D>(tdk, sm + L::kDk, T::kBK, dk, a.scale, cw, kw0, wt.kvh, wt.b, 1 + cw);
    store_rows<D>(tdv, sm + L::kDv, T::kBK, dv, 1.f, cw, kw0, wt.kvh, wt.b, 1 + cw);
  }
  turns.finish();
  if ((threadIdx.x & 127) == 0) tma_store_wait_all();
}

template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tdk,
                        const __grid_constant__ CUtensorMap tdv, WArgs a) {
  using L = DkvLayout<D>;
  constexpr int S = DkvTiling<D>::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L::kBar);
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);      // full_kv: the producer's expect_tx
    mbar_init(bars + 1, 8);  // empty_kv: one arrival a consumer warp
    for (int i = 0; i < S; ++i) {
      mbar_init(bars + 2 + i, 1);
      mbar_init(bars + 2 + S + i, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      prefetch_map(&tdo);
      dkv_producer<D>(&tq, &tk, &tv, &tdo, a, sm, bars);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    dkv_consumer<D>(&tdk, &tdv, a, sm, bars, threadIdx.x / 128 - 1);
  }
}

// The plan's head (kernels/flash_plan.py::BWD_PLAN_HEAD): bq, bk, stages,
// smem bytes, blocks, ld; then 9 integers a map: dims (4, innermost
// first), byte strides (3), box (2).
constexpr int kPlanHead = 6, kPlanMap = 9;

// Encode the plan's n maps over `bases` after checking each against the
// expected dims and box rows; byte strides must be positive multiples of 16.
inline int encode_maps(CUtensorMap* maps, int n, const long long* plan, const void* const* bases,
                       const long long (*dims)[4], const long long* box_rows) {
  for (int i = 0; i < n; ++i) {
    const long long* m = plan + kPlanHead + i * kPlanMap;
    const long long *md = m, *strides = m + 4, *box = m + 7;
    for (int j = 0; j < 4; ++j)
      if (md[j] != dims[i][j]) return (int)cudaErrorInvalidValue;
    if (box[0] != kBoxCols || box[1] != box_rows[i]) return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if (strides[j] <= 0 || strides[j] % 16) return (int)cudaErrorInvalidValue;
    const int err = encode_map_4d(&maps[i], bases[i], md, strides, box);
    if (err) return err;
  }
  return 0;
}

// Raise an instance's shared-memory cap once a device, then launch it.
template <typename K, typename... Args>
int launch_persistent(K kern, int bytes, int blocks, int dev, bool* granted,
                      cudaStream_t stream, Args... args) {
  if (!granted[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = true;
  }
  kern<<<blocks, kThreadsW, bytes, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_wgmma(int which, const void* const* bases, WArgs a, int batch,
                     const long long* plan, int dev, cudaStream_t stream) {
  static bool granted_dq[kMaxDevices] = {}, granted_dkv[kMaxDevices] = {};
  const long long d = D, heads = a.heads, kvh = a.kv_heads;
  const long long bq = plan[0], bk = plan[1], stages = plan[2], smem = plan[3];
  const long long blocks = plan[4], ld = plan[5];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      ld != (a.sq + kLdRows - 1) / kLdRows * kLdRows)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[6];
  if (which == 1) {
    using T = DqTiling<D>;
    a.units = batch * a.heads;
    a.n_tiles = (a.sq + T::kBQ - 1) / T::kBQ;
    const long long work = (long long)a.n_tiles * a.units;
    if (bq != T::kBQ || bk != T::kBK || stages != T::kStages || smem != DqLayout<D>::kBytes ||
        work > 0x7fffffffLL || blocks != std::min<long long>(sms, work))
      return (int)cudaErrorInvalidValue;
    const long long dims[5][4] = {{d, a.sq, heads, batch}, {d, a.seq_k, kvh, batch},
                                  {d, a.seq_k, kvh, batch}, {d, a.sq, heads, batch},
                                  {d, a.sq, heads, batch}};
    const long long box_rows[5] = {bq, bk, bk, bq, kOutRows};
    const int err = encode_maps(maps, 5, plan, bases, dims, box_rows);
    if (err) return err;
    return launch_persistent(flash_bwd_dq_wgmma<D>, DqLayout<D>::kBytes, (int)blocks, dev,
                             granted_dq, stream, maps[0], maps[1], maps[2], maps[3], maps[4],
                             a);
  }
  using T = DkvTiling<D>;
  a.units = batch * a.kv_heads;
  a.n_tiles = (a.sk + T::kBK - 1) / T::kBK;
  a.n_qtiles = (a.sq + T::kBQ - 1) / T::kBQ;
  const long long work = (long long)a.n_tiles * a.units;
  if (bq != T::kBQ || bk != T::kBK || stages != T::kStages || smem != DkvLayout<D>::kBytes ||
      work > 0x7fffffffLL || blocks != std::min<long long>(sms, work))
    return (int)cudaErrorInvalidValue;
  const long long dims[6][4] = {{d, a.sq, heads, batch}, {d, a.seq_k, kvh, batch},
                                {d, a.seq_k, kvh, batch}, {d, a.sq, heads, batch},
                                {d, a.sk, kvh, batch},    {d, a.sk, kvh, batch}};
  const long long box_rows[6] = {bq, bk, bk, bq, kOutRows, kOutRows};
  const int err = encode_maps(maps, 6, plan, bases, dims, box_rows);
  if (err) return err;
  return launch_persistent(flash_bwd_dkv_wgmma<D>, DkvLayout<D>::kBytes, (int)blocks, dev,
                           granted_dkv, stream, maps[0], maps[1], maps[2], maps[3], maps[4],
                           maps[5], a);
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
    if (is_bf16) {
      constexpr int rows = kThreads / delta_lanes<bf16, D>();
      return launch(flash_bwd_delta<bf16, D>, dim3((a.ld + rows - 1) / rows, bh), 0, a, st);
    }
    constexpr int rows = kThreads / delta_lanes<float, D>();
    return launch(flash_bwd_delta<float, D>, dim3((a.ld + rows - 1) / rows, bh), 0, a, st);
  }
  if (is_bf16) {
    if constexpr (D == 32 || D == 80) {
      if (which == 1)
        return launch(flash_bwd_dq_bf16<D>, dim3((a.sq + kBQ - 1) / kBQ, bh), dq_bf16_smem<D>(),
                      a, st);
      return launch(flash_bwd_dkv_bf16<D>, dim3((a.sk + kBK - 1) / kBK, bkv),
                    dkv_bf16_smem<D>(), a, st);
    } else {
      return (int)cudaErrorInvalidValue;  // bf16 at d 64 and 128: the wgmma route
    }
  }
  if (which == 1)
    return launch(flash_bwd_dq_f32<D>, dim3((a.sq + kBQ - 1) / kBQ, bh), dq_f32_smem<D>(), a,
                  st);
  return launch(flash_bwd_dkv_f32<D>, dim3((a.sk + kBKf - 1) / kBKf, bkv), dkv_f32_smem<D>(),
                a, st);
}

}  // namespace

// One of the backward's three kernels: which = 0 delta (writes delta, and
// lse2 where it is not null), 1 dq (reads delta), 2 dk/dv (reads delta);
// run 0 before 1 and 2 on one stream. The dq and dk/dv kernels of the
// wgmma route (bf16 at d 64 and 128) are flash_attention_bwd_wgmma_launch's.
// strides: 24 element strides, (batch, head, sequence) of q, k, v, out, do,
// dq, dk, dv in that order, each a (B, heads, S, d) view whose last
// dimension is contiguous; lse: (B * H, Sq) f32; delta and lse2: (B * H,
// ld) f32, ld >= Sq. is_bf16: 1 for bf16 tensors, 0 for f32. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_launch(
    int which, const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, float* lse2, void* dq, void* dk, void* dv, int is_bf16,
    int d, int batch, int heads, int kv_heads, int sq, int sk, int seq_k, int causal, int ld,
    const long long* strides, void* stream) {
  if (which < 0 || which > 2 || batch < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || sq < 1 || sk < 1 || seq_k < 1 || seq_k > sk || ld < sq ||
      (long long)batch * heads > 65535 ||
      (which > 0 && is_bf16 && (d == 64 || d == 128)))  // the wgmma route's
    return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  BwdArgs a{q,     k,     v,     o,     dout,  lse,   delta, lse2,  dq,    dk,    dv,
            heads, kv_heads, heads / kv_heads, sq, sk, seq_k, causal, ld,
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

// The dq (which = 1) or dk/dv (which = 2) kernel of the "wgmma" route: bf16
// q, k, v, do, dq, dk, dv as for flash_attention_bwd_launch, lse2 and delta
// (B * H, ld) f32 from its delta kernel (run first, on the same stream),
// launched by the plan (kernels/flash_plan.py::BwdKernelPlan.fields),
// which is checked against the shapes: the instance's tiling and shared
// bytes; one block a streaming multiprocessor while the work tiles last;
// ld = Sq rounded up to a multiple of 128; q and do maps of dims (d, sq,
// heads, batch), k and v maps of dims (d, seq_k, kv_heads, batch) (keys
// past seq_k load as zeros), dq of (d, sq, heads, batch), dk and dv of
// (d, sk, kv_heads, batch); byte strides positive multiples of 16; boxes
// 64 columns by bq (q, do), bk (k, v) or 64 (outputs) rows. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd_wgmma_launch(
    int which, const void* q, const void* k, const void* v, const void* dout,
    const float* lse2, const float* delta, void* dq, void* dk, void* dv, int d, int batch,
    int heads, int kv_heads, int sq, int sk, int seq_k, int causal, const long long* plan,
    void* stream) {
  if ((which != 1 && which != 2) || batch < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || sq < 1 || sk < 1 || seq_k < 1 || seq_k > sk ||
      (d != 64 && d != 128) || lse2 == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  const WArgs a{lse2,  delta, heads, kv_heads, heads / kv_heads, sq, sk, seq_k, causal,
                (int)plan[5], 0, 0, 0, (float)(kLog2e / sqrt((double)d)),
                (float)(1.0 / sqrt((double)d))};
  const void* bases_dq[5] = {q, k, v, dout, dq};
  const void* bases_dkv[6] = {q, k, v, dout, dk, dv};
  const void* const* bases = which == 1 ? bases_dq : bases_dkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_bwd_wgmma<64>(which, bases, a, batch, plan, dev, st);
  return launch_bwd_wgmma<128>(which, bases, a, batch, plan, dev, st);
}
