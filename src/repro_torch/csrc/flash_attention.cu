// Attention forward with an online softmax (flash attention), causal or
// full, with grouped-query heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (_flash_kernel). It computes what _flash_kernel
// computes, for one (q head, q tile) per block:
//   s   = (q . k^T) * (1 / sqrt(d)) in f32; -1e30 where the key is at or
//         past seq_k or, if causal, where q_pos < k_pos (both from 0:
//         the mask is top-left aligned, also when Sq != Sk);
//   m   = running row max, l = running normalizer, both f32;
//   p   = exp(s - m), 0 where masked, cast to v's dtype before p . v;
//   acc = acc * exp(m_prev - m) + p . v in f32;
//   out = acc / max(l, 1e-30) in q's dtype, lse = m + ln(max(l, 1e-30)).
// The exponentials are exp2 of (x * log2 e); lse stays a natural log. The
// kv head of q head h is h / group.
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
// tensor cores (69 us at 989 TFLOP/s): bound by operations. The softmax
// needs one exp2 per kept (query, key) pair, 268.6 M at the prefill: 69 us
// at the special-function units' 3.9 T/s, as long as the products. So the
// products run on wgmma, the tiles arrive by TMA ahead of use, and the
// softmax of one key tile runs while the tensor cores do the next tile's
// q . k^T and the last tile's p . v. Three routes, by (dtype, d), each a
// kernel of its own (the wrapper's plan, kernels/flash_plan.py, picks):
//   * "wgmma", bf16 at d 64 and 128 (flash_fwd_wgmma): work tiles of one
//     q head's 128-row q tile, heaviest first; a persistent grid of one
//     block a multiprocessor, each looping over its work tiles, three
//     warpgroups a block. The producer (one thread, its warpgroup's
//     registers handed to the others by setmaxnreg) loads each q tile
//     once and K, V tiles of 128 keys into a ring of 2 stages by TMA over
//     4-D tensor maps of the strided views, each stage with full/empty
//     mbarriers; the next work tile's loads overlap this one's last p . v
//     and epilogue. Two consumer warpgroups own 64 q rows each: s = q .
//     k^T by wgmma m64n128k16 (both operands K-major in
//     shared memory), the softmax in registers with explicit FMAs
//     (ex2(fma(s, scale log2 e, -m scale log2 e)), l = fma(l, alpha,
//     rowsum)), then acc += p . v by wgmma m64nDk16 with p (bf16) from
//     registers and V read MN-major. Tile j + 1's q . k^T and tile j's
//     p . v are issued before tile j + 1's softmax, which runs under them;
//     at d 128 the two warpgroups also take turns to issue (ping-pong,
//     named barriers), so one's softmax runs under the other's products.
//     The epilogue stages out (bf16) in an out tile and stores it by TMA
//     through out's strides (rows past Sq are clipped). That tiling was the
//     fastest of those timed at the prefill shape (PERF.md).
//   * "mma_sync", bf16 at d 32 and 80 (flash_fwd_bf16; 80 columns do not
//     fill 128-byte swizzle rows evenly): four warps, each owning 16 q rows
//     whose A fragments stay in registers; 64-key tiles of K and V staged
//     in shared memory (rows padded by 8 so ldmatrix is free of bank
//     conflicts); both products through mma.sync.m16n8k16.
//   * "scalar", f32 (the reduced test configs): the same tiling with
//     scalar f32 products (TF32 would not be the f32 function): a lane per
//     key of a 32-key tile for q . k^T, a lane per output column for p . v.
// Tiles wholly above the diagonal are skipped, as the TPU kernel skips
// them; q tiles run heaviest first. There are no atomics and no split over
// keys: two launches give the same bits.
#include <math.h>

#include <algorithm>

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
    if constexpr (D == 32 || D == 80) {
      flash_fwd_bf16<D><<<grid, kThreads, 0, stream>>>(a);
    } else {
      return (int)cudaErrorInvalidValue;  // bf16 at d 64 and 128: the wgmma route
    }
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

// ----------------------------------------------------------------- wgmma

constexpr int kBQw = 128;        // q rows a block: 64 a consumer warpgroup
constexpr int kBKw = 128;        // keys a K/V tile
constexpr int kStagesW = 2;      // K/V tiles in flight
constexpr int kMaxDevices = 64;
constexpr int kThreadsW = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kBoxCols = 64;     // a TMA box row: 64 bf16 = 128 bytes, one swizzle row
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // 128 x 24 + 256 x 240 <= 65,536

// The block's shared memory, in bytes from a 1024-aligned base: the q tile,
// the ring's K tiles and V tiles, the out tile (staged for its TMA store),
// then the mbarriers (full_q, empty_q, full_k[S], full_v[S], empty_k[S],
// empty_v[S]); 1024 bytes of slack align the base.
// kernels/flash_plan.py::smem_bytes computes the same total.
template <int D>
struct WLayout {
  static constexpr int kQBytes = kBQw * D * 2, kKVBytes = kBKw * D * 2;
  static constexpr int kK = kQBytes, kV = kK + kStagesW * kKVBytes;
  static constexpr int kO = kV + kStagesW * kKVBytes, kBar = kO + kQBytes;
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStagesW) + 1024;
};

struct WArgs {
  float* lse;
  int heads, group, sq, seq_k, causal, bh, n_qtiles;
  float c;  // log2 e / sqrt(d): s c is the scaled score in base 2
};

// Work tile w (one q head's 128-row q tile), heaviest first: every (batch,
// head) of the last q tile, then of the one before. A block takes tiles
// blockIdx.x, + gridDim.x, ... (one tile a block when the grid covers them).
struct WorkTile {
  int q0, b, h, bh, n_tiles;  // n_tiles: key tiles the q tile needs (at least one)
};

__device__ __forceinline__ WorkTile work_tile(const WArgs& a, int w) {
  WorkTile t;
  t.bh = w % a.bh;
  t.q0 = (a.n_qtiles - 1 - w / a.bh) * kBQw;
  t.b = t.bh / a.heads;
  t.h = t.bh % a.heads;
  const int kend = a.causal ? min(a.seq_k, t.q0 + kBQw) : a.seq_k;
  t.n_tiles = (kend + kBKw - 1) / kBKw;
  return t;
}

// The block's mbarriers: the q tile's full/empty pair, then each ring
// stage's K and V full/empty pairs. A stage is used by key tiles r, r + S,
// ... of the block's running count r over its work tiles: round r / S,
// whose parity its waits take (a fresh barrier passes parity 1).
struct Ring {
  uint64_t* bars;
  __device__ uint64_t* full_q() const { return bars; }
  __device__ uint64_t* empty_q() const { return bars + 1; }
  __device__ uint64_t* full_k(int r) const { return bars + 2 + r % kStagesW; }
  __device__ uint64_t* full_v(int r) const { return bars + 2 + kStagesW + r % kStagesW; }
  __device__ uint64_t* empty_k(int r) const { return bars + 2 + 2 * kStagesW + r % kStagesW; }
  __device__ uint64_t* empty_v(int r) const { return bars + 2 + 3 * kStagesW + r % kStagesW; }
  static __device__ uint32_t parity(int r) { return (uint32_t)((r / kStagesW) & 1); }
};

// The producer: one thread loads each work tile's q tile once the
// consumers have released the last one, then its K and V tiles into the
// ring, each after the consumers have released the stage.
template <int D>
__device__ __forceinline__ void wgmma_producer(const CUtensorMap* tq, const CUtensorMap* tk,
                                               const CUtensorMap* tv, const WArgs& a,
                                               uint8_t* sm, Ring ring) {
  using L = WLayout<D>;
  int r = 0;  // key tiles loaded so far
  for (int w = blockIdx.x, n = 0; w < a.n_qtiles * a.bh; w += gridDim.x, ++n) {
    const WorkTile t = work_tile(a, w);
    const int kvh = t.h / a.group;
    mbar_wait(ring.empty_q(), (n & 1) ^ 1);
    mbar_expect_tx(ring.full_q(), L::kQBytes);
#pragma unroll
    for (int c = 0; c < D / kBoxCols; ++c)
      tma_load_4d(sm + c * kBQw * 128, tq, ring.full_q(), c * kBoxCols, t.q0, t.h, t.b);
    for (int j = 0; j < t.n_tiles; ++j, ++r) {
      uint8_t* ks = sm + L::kK + (r % kStagesW) * L::kKVBytes;
      uint8_t* vs = sm + L::kV + (r % kStagesW) * L::kKVBytes;
      mbar_wait(ring.empty_k(r), ring.parity(r) ^ 1);
      mbar_expect_tx(ring.full_k(r), L::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c)
        tma_load_4d(ks + c * kBKw * 128, tk, ring.full_k(r), c * kBoxCols, j * kBKw, kvh, t.b);
      mbar_wait(ring.empty_v(r), ring.parity(r) ^ 1);
      mbar_expect_tx(ring.full_v(r), L::kKVBytes);
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c)
        tma_load_4d(vs + c * kBKw * 128, tv, ring.full_v(r), c * kBoxCols, j * kBKw, kvh, t.b);
    }
  }
}

// s = q . k^T for the warpgroup's 64 rows and one key tile: D / 16 steps of
// k16. Column chunk c of a tile starts c * rows * 128 bytes in; step kk
// moves 32 bytes along its 128-byte rows.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kBKw / 2], uint64_t qd, uint64_t kd) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss<kBKw>(s, qd + ((c * kBQw * 128 + off) >> 4), kd + ((c * kBKw * 128 + off) >> 4),
                 kk > 0);
  }
}

// acc += p . v over one key tile: 8 steps of k16, each 16 key rows
// (2048 bytes) further into the V tile.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[kBKw / 16][4],
                                         uint64_t vd) {
#pragma unroll
  for (int kk = 0; kk < kBKw / 16; ++kk) wgmma_rs<D>(o, p[kk], vd + ((kk * 16 * 128) >> 4));
}

// The online softmax of one key tile, in place: s (raw scores, the wgmma
// accumulator layout: element 4j + e is row `row0 + 8 (e >> 1)`, key k0 +
// 8j + 2t + (e & 1)) becomes p = 2^(s c - mc) (0 where masked), where mc
// is the new running max of s c; l (this thread's share of each row's
// sum) and mc are updated and alpha = 2^(mc_old - mc) returned.
__device__ __forceinline__ void softmax_tile(float (&s)[kBKw / 2], float (&mc)[2], float (&l)[2],
                                             float (&alpha)[2], const WArgs& a, bool masked,
                                             int row0, int k0, int t) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < kBKw / 2; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1), key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (key >= a.seq_k || (a.causal && key > row)) s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kBKw / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
    const float m_new = fmaxf(mc[r], mx[r] * a.c);
    // A row with nothing kept yet subtracts 0: p and alpha are then 0, not NaN.
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(mc[r] - m_safe);
    mc[r] = m_new;
    neg[r] = -m_safe;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kBKw / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(__fmaf_rn(s[i], a.c, neg[r]));
    rs[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = __fmaf_rn(l[r], alpha[r], rs[r]);
}

// p (f32, accumulator layout) as bf16 A fragments: the accumulators of
// n-tiles 2kk and 2kk + 1 are the A fragment of keys 16kk .. 16kk + 15.
__device__ __forceinline__ void pack_p(uint32_t (&p)[kBKw / 16][4], const float (&s)[kBKw / 2]) {
#pragma unroll
  for (int kk = 0; kk < kBKw / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

// One consumer warpgroup (cw = 0 or 1): rows q0 + 64 cw .. + 63 of each of
// the block's work tiles.
template <int D, bool PP>
__device__ __forceinline__ void wgmma_consumer(const CUtensorMap* to, const WArgs& a,
                                               uint8_t* sm, Ring ring, int cw) {
  using L = WLayout<D>;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const bool elected = (threadIdx.x & 127) == 0;
  // The warpgroup's 64 rows start 64 * 128 bytes into each column chunk.
  const uint64_t qd = wgmma_desc(sm + cw * 64 * 128, 16, 1024);
  auto kdesc = [&](int r) {
    return wgmma_desc(sm + L::kK + (r % kStagesW) * L::kKVBytes, 16, 1024);
  };
  auto vdesc = [&](int r) {
    return wgmma_desc(sm + L::kV + (r % kStagesW) * L::kKVBytes, kBKw * 128, 1024);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // The two warpgroups take turns to issue their products (named barriers
  // 3 and 4), so one's softmax runs under the other's products.
  auto turn = [&] {
    if constexpr (PP) named_barrier(3 + cw, 256);
  };
  auto pass = [&](bool last) {
    if constexpr (PP) {
      if (!(last && cw == 1)) named_barrier_arrive(4 - cw, 256);
    }
  };
  if constexpr (PP) {
    if (cw == 1) named_barrier_arrive(3, 256);  // warpgroup 0 goes first
  }

  float s[kBKw / 2], o[D / 2];
  uint32_t p[kBKw / 16][4];
#pragma unroll
  for (int i = 0; i < kBKw / 2; ++i) s[i] = 0.f;
  int r = 0;  // key tiles consumed so far
  const int n_work = a.n_qtiles * a.bh;
  for (int w = blockIdx.x, n = 0; w < n_work; w += gridDim.x, ++n) {
    const WorkTile wt = work_tile(a, w);
    const bool last_work = w + (int)gridDim.x >= n_work;
    const int row0 = wt.q0 + 64 * cw + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const int wg_row = wt.q0 + 64 * cw;
    // A tile needs the mask where it crosses seq_k or, causal, the diagonal
    // of the warpgroup's rows.
    auto masked = [&](int j) {
      const int k0 = j * kBKw;
      return k0 + kBKw > a.seq_k || (a.causal && k0 + kBKw - 1 > wg_row);
    };
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float mc[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    mbar_wait(ring.full_q(), n & 1);
    // Key tile 0: s = q . k^T, then its softmax.
    mbar_wait(ring.full_k(r), ring.parity(r));
    reg_fence(s);
    turn();
    wgmma_fence();
    issue_qk<D>(s, qd, kdesc(r));
    wgmma_commit();
    pass(false);
    wgmma_wait<0>();
    reg_fence(s);
    release(ring.empty_k(r));
    softmax_tile(s, mc, l, alpha, a, masked(0), row0, 0, t4);
    pack_p(p, s);

    for (int j = 1; j < wt.n_tiles; ++j) {
      // Key tile j's q . k^T and tile j - 1's p . v go to the tensor
      // cores, then tile j's softmax runs while they work.
      const int rj = r + j;
      mbar_wait(ring.full_k(rj), ring.parity(rj));
      reg_fence(s);
      reg_fence(o);
      turn();
      wgmma_fence();
      issue_qk<D>(s, qd, kdesc(rj));
      wgmma_commit();
      mbar_wait(ring.full_v(rj - 1), ring.parity(rj - 1));
      issue_pv<D>(o, p, vdesc(rj - 1));
      wgmma_commit();
      pass(false);
      wgmma_wait<1>();
      reg_fence(s);
      release(ring.empty_k(rj));
      softmax_tile(s, mc, l, alpha, a, masked(j), row0, j * kBKw, t4);
      wgmma_wait<0>();
      reg_fence(o);
      reg_fence(p);
      release(ring.empty_v(rj - 1));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(p, s);
    }
    // Every q . k^T of the work tile is done: the producer may load the next q tile.
    release(ring.empty_q());
    // The last key tile's p . v.
    const int rl = r + wt.n_tiles - 1;
    mbar_wait(ring.full_v(rl), ring.parity(rl));
    reg_fence(o);
    turn();
    wgmma_fence();
    issue_pv<D>(o, p, vdesc(rl));
    wgmma_commit();
    pass(last_work);
    wgmma_wait<0>();
    reg_fence(o);
    release(ring.empty_v(rl));
    r += wt.n_tiles;

    // Epilogue: the row sums over the quad, out = acc / max(l, 1e-30) as
    // bf16 into the warpgroup's rows of the out tile (the q tile's
    // swizzled layout) once its last store has read them, then one TMA
    // store a column chunk; lse = mc ln 2 + ln(max(l, 1e-30)).
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      l[i] = fmaxf(l[i], 1e-30f);
      inv[i] = 1.f / l[i];
    }
    if (elected) tma_store_wait_read();
    named_barrier(1 + cw, 128);
    const int rw = 16 * warp + g;  // row within the warpgroup's 64; rw % 8 == g
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint8_t* chunk = sm + L::kO + (j / 8) * kBQw * 128 + cw * 64 * 128;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rw + 8 * i;
        *reinterpret_cast<uint32_t*>(chunk + row * 128 + (((j % 8) ^ g) << 4) + 4 * t4) =
            pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
      }
    }
    fence_async_shared();
    named_barrier(1 + cw, 128);
    if (elected) {
#pragma unroll
      for (int c = 0; c < D / kBoxCols; ++c)
        tma_store_4d(to, sm + L::kO + c * kBQw * 128 + cw * 64 * 128, c * kBoxCols, wg_row,
                     wt.h, wt.b);
      tma_store_commit();
    }
    if (t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 8 * i;
        if (row < a.sq) a.lse[(long long)wt.bh * a.sq + row] = mc[i] * kLn2 + logf(l[i]);
      }
    }
  }
  if (elected) tma_store_wait_all();
}

template <int D>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                    WArgs a) {
  using L = WLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const Ring ring{reinterpret_cast<uint64_t*>(sm + L::kBar)};
  if (threadIdx.x == 0) {
    mbar_init(ring.full_q(), 1);   // the producer's expect_tx
    mbar_init(ring.empty_q(), 8);  // one arrival a consumer warp
    for (int s = 0; s < kStagesW; ++s) {
      mbar_init(ring.full_k(s), 1);
      mbar_init(ring.full_v(s), 1);
      mbar_init(ring.empty_k(s), 8);
      mbar_init(ring.empty_v(s), 8);
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
      wgmma_producer<D>(&tq, &tk, &tv, a, sm, ring);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // Ping-pong at d 128 only: faster there, slower at d 64 (PERF.md).
    wgmma_consumer<D, D == 128>(&to, a, sm, ring, threadIdx.x / 128 - 1);
  }
}

// The plan's fields (kernels/flash_plan.py::PLAN_FIELDS), in order: bq, bk,
// smem bytes, blocks, then for each of q, k, v, out: dims (4, innermost
// first), byte strides (3), box (2).
constexpr int kPlanHead = 4, kPlanMap = 9;

template <int D>
int launch_wgmma(const CUtensorMap* maps, const WArgs& a, long long smem, int blocks, int dev,
                 cudaStream_t stream) {
  using L = WLayout<D>;
  if (smem != L::kBytes || dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_wgmma<D>;
  // Its shared bytes are fixed: raise its cap once a device, not a launch.
  static bool granted[kMaxDevices] = {};
  if (!granted[dev]) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    granted[dev] = true;
  }
  kern<<<blocks, kThreadsW, L::kBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], a);
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

// The "wgmma" route: bf16 q, k, v, o of the same views as above, launched
// by the plan (kernels/flash_plan.py::PLAN_FIELDS), which is checked
// against the shapes: bq and bk 128; the instance's shared bytes; one
// block a streaming multiprocessor while the (q tile, batch, head) tiles
// last; q and out maps of dims (d, sq, heads, batch), k and v maps of dims
// (d, seq_k, kv_heads, batch) (keys past seq_k load as zeros); byte
// strides positive multiples of 16; boxes 64 columns by bq (q), bk (k, v)
// or 64 (out) rows. Returns a cudaError_t.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* o, float* lse, int d, int batch, int heads,
                                            int kv_heads, int sq, int seq_k, int causal,
                                            const long long* plan, void* stream) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads != 0 || sq < 1 ||
      seq_k < 1 || (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  const long long bq = plan[0], bk = plan[1], smem = plan[2], blocks = plan[3];
  const long long n_qtiles = (sq + kBQw - 1) / kBQw, bh = (long long)batch * heads;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return (int)cudaErrorInvalidValue;
  if (bq != kBQw || bk != kBKw || n_qtiles * bh > 0x7fffffffLL ||
      blocks != std::min<long long>(sms, n_qtiles * bh))
    return (int)cudaErrorInvalidValue;
  const void* bases[4] = {q, k, v, o};
  const long long rows[4] = {sq, seq_k, seq_k, sq}, hs[4] = {heads, kv_heads, kv_heads, heads};
  const long long box_rows[4] = {bq, bk, bk, 64};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const long long* m = plan + kPlanHead + i * kPlanMap;
    const long long *dims = m, *strides = m + 4, *box = m + 7;
    if (dims[0] != d || dims[1] != rows[i] || dims[2] != hs[i] || dims[3] != batch ||
        box[0] != kBoxCols || box[1] != box_rows[i])
      return (int)cudaErrorInvalidValue;
    for (int j = 0; j < 3; ++j)
      if (strides[j] <= 0 || strides[j] % 16) return (int)cudaErrorInvalidValue;
    const int err = encode_map_4d(&maps[i], bases[i], dims, strides, box);
    if (err) return err;
  }
  const WArgs a{lse,   heads,         heads / kv_heads, sq, seq_k, causal, (int)bh,
                (int)n_qtiles, (float)(kLog2e / sqrt((double)d))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch_wgmma<64>(maps, a, smem, (int)blocks, dev, st);
  return launch_wgmma<128>(maps, a, smem, (int)blocks, dev, st);
}
