// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of the
// causal or full, grouped-query attention that flash_attention.cu computes,
// by the standard recompute: P is rebuilt tile by tile from the scores and
// the forward's per-row log-sum-exp, never stored whole.
//
// Replaces: src/repro/kernels/flash_attention/ops.py `_bwd`, which has no
// Pallas kernel there: it is `jax.vjp` of the XLA `attention_ref`; with a
// window, `jax.vjp` of `local_attention` (src/repro/models/attention.py:
// 162), which XLA differentiates. Its
// equations, with s = scale q.k and P = exp(s - lse) on the live (query,
// key) pairs and exactly 0 on the masked ones:
//   D  = rowsum(dO o O)          dV = P^T dO          dP = dO V^T
//   dS = P o (dP - D)            dQ = scale dS K      dK = scale dS^T Q
//
// What bounds it on this card: operations. Five products of the forward's
// size (S, dP, dV, dK, dQ): a causal (1, 32, 4096, 128) call is ~344 GFLOP
// against ~170 MB of inputs and outputs, so the floor is the tensor-core
// rate (989 TFLOP/s bf16).
//
// Three kernels a call (four with a head split, below), on one stream,
// with no atomics: D = rowsum(dO o O)
// (`fa_bwd_dot`, one warp per row, into a float32 (B, Hq, S) scratch), a
// dK/dV kernel (one block per key tile, kv head and batch, walking every
// query head of its group and, for each, the query tiles from the causal
// limit on: S^T and dP^T of the pair, P^T and dS^T, dV += P^T dO and
// dK += dS^T Q, dK and dV in registers), then a dQ kernel (one block per
// query tile, q head and batch, walking the key tiles up to the causal
// limit: S and dP again, dS, dQ += dS K). S and dP are computed twice:
// seven products of the forward's size instead of five (a 0.49 ms floor
// at qwen3-4b's shape), the price of summing every gradient in float32 in
// one fixed order, so that two calls are bit-equal.
//
// bfloat16 (`fa_bwd_dkdv_wgmma` or, at hd 256, `fa_bwd_dkdv_hd256`, and
// `fa_bwd_dq_wgmma`): both kernels have the
// forward's warp-specialised shape (flash_attention.cu, helpers in
// hopper.cuh). What held the earlier `mma.sync` design at ~9x its bound:
// products issued a warp at a time (no wgmma), tiles staged by 16-byte
// loads from every thread (no overlap of loads and products), and a dK/dV
// kernel at 255 registers with a spill. Here each block is 384 threads:
// warpgroup 0 is a TMA producer that gives most of its registers to the
// consumers (setmaxnreg 24 / 240; the launcher refuses a kernel that ptxas
// gave fewer than the 168 registers a thread this needs, since the
// consumers' raise would wait forever), and warpgroups 1 and 2 each own 64
// rows of the block's 128 and run wgmma (bf16 in, fp32 accumulate).
//   dK/dV: the block's K and V tiles (128 keys) arrive once by TMA; then
//   the producer streams 64-query tiles of Q and dO by TMA, with their
//   rows' log-sum-exp and D (ordinary loads: the (B, Hq, S) rows are
//   16-byte aligned only when S is a multiple of 4), through a 3-stage
//   ring guarded by mbarriers (full: bytes landed and rows stored; empty:
//   both consumers done). A consumer computes S^T = K Q^T and dP^T =
//   V dO^T (both operands from shared memory, the two products in flight
//   together), P^T and dS^T in registers, and dV += P^T dO and dK +=
//   dS^T Q with P^T and dS^T as register A operands (the accumulator
//   layout is the A layout) and dO, Q read MN-major from the same tiles.
//   dQ: the producer loads the block's 128 rows of Q and dO once and
//   streams 128-key tiles of K and V through a 2-stage ring; a consumer
//   computes S = Q K^T and dP = dO V^T, dS in registers and dQ += dS K
//   (K MN-major); dQ is scaled and rounded to bf16 once, at the end.
// P and dS are rounded to bf16 before the products that take them, as the
// forward rounds P before P.V; the plain version keeps them in float32
// (chip_smoke.py states the tolerance). Key (dK/dV) and query (dQ) tiles
// are issued longest-first under a causal mask; a consumer whose 64 rows
// lie wholly in the causal future of a tile (or past kv_len) skips its
// products, which would add exact zeros. TMA reads q, k, v and dO through
// their (batch, head, row) strides and zero-fills rows past S and T, which
// the kernels mask; every mbarrier wait traps after ~2^34 cycles, so a
// pipeline fault fails the launch instead of hanging the card.
//
// The sliding window (the hybrid family's local attention: query position
// p sees keys k with p - window < k <= p): the dK/dV kernel walks the
// query tiles from the causal limit to the last one whose first query
// still sees the block's last key, the dQ kernel the key tiles from the
// one holding its first query's first key; both mask k <= p - window as
// the forward does, and skip a consumer's products where every pair is
// dead. Head dim 256 (recurrentgemma) has a dK/dV kernel of its own
// (`fa_bwd_dkdv_hd256`): a block takes 64 keys, since 64 keys x 256
// columns of dK and dV a consumer would take 256 registers a thread and
// 128-key K/V tiles with a Q/dO ring 320 KB of shared memory; one
// consumer computes S^T and P^T, the other dP^T and dS^T, they hand P^T
// and dS^T to each other through shared memory, and each owns 128 columns
// of dK and dV (the earlier design had both compute S^T and dP^T: two of
// seven products done twice). The dQ kernel takes 48-key tiles through a
// two-stage ring there. One KV head at batch 1 leaves 64 dK/dV blocks for
// 132 SMs: the wrapper then splits each KV head's query heads into parts
// (`dkdv_split`), each block writing float32 sums of its part, which
// `fa_bwd_kv_sum` adds in part order (four kernels a call, still no
// atomics).
//
// float32 (`fa_bwd_dkdv`, `fa_bwd_dq`): 256-thread blocks of 64 rows on
// the CUDA cores (32 rows at hd 256, whose four 64-row tiles would not
// fit in shared memory), S and dP as 4x4 (2x2) micro-tiles from shared
// memory, P and dS through shared memory, exact to the float32 equations
// up to summation order. Masking is the forward's: keys at or past
// kv_len, when causal keys after q_offset + row, and with a window keys
// at or before q_offset + row - window are dead, and their P is set to
// exactly 0. Tiles wholly outside the causal range are skipped. Inputs and
// outputs are read and written through their (batch, head, row) strides,
// so the model's (B, S, H, hd) layout needs no copy.
#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

// The float32 tiles: BT rows (queries or keys) a tile, each thread a
// micro-tile of R x R of a BT x BT product (16 x 16 threads), shared rows
// of pitch P floats (no bank conflicts). hd 256 takes 32-row tiles: four
// 64-row tiles of 256 columns would need 266 KB of shared memory.
template <int HD>
struct Simt {
  static constexpr int R = HD == 256 ? 2 : 4;
  static constexpr int BT = 16 * R, P = BT + 1, TILE = HD * P;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// ------------------------------------------------------------ D = dO . O

template <typename T>
__global__ void fa_bwd_dot(const T* __restrict__ o, const T* __restrict__ dO,
                           float* __restrict__ D, int Hq, int S, int hd,
                           long long rows, Strides os, Strides dos) {
  const long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const int i = (int)(r % S);
  const int h = (int)((r / S) % Hq);
  const int b = (int)(r / ((long long)S * Hq));
  const T* orow = o + b * os.b + h * os.h + i * os.s;
  const T* drow = dO + b * dos.b + h * dos.h + i * dos.s;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(ld(orow + d), ld(drow + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[r] = acc;
}

// --------------------------------------------- shared helpers of the tiles

// Load a (BT x HD) row tile into shared memory transposed, X[d][row] with a
// row pitch of P floats; rows at or past `n` read as 0.
template <int HD>
__device__ __forceinline__ void load_t(float* X, const float* base,
                                       long long rs, int r0, int n) {
  using T = Simt<HD>;
  for (int i = threadIdx.x; i < T::BT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    X[d * T::P + r] = r0 + r < n ? base[(long long)(r0 + r) * rs + d] : 0.0f;
  }
}

// s[a][c] = sum_d A[d][ty + 16a] B[d][tx + 16c]: an R x R micro-tile of a
// BT x BT product of two transposed tiles, summed in d order.
template <int HD>
__device__ __forceinline__ void tile_dot(float (&s)[Simt<HD>::R][Simt<HD>::R],
                                         const float* A, const float* Bm,
                                         int ty, int tx) {
  using T = Simt<HD>;
  constexpr int R = T::R;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float x[R], y[R];
#pragma unroll
    for (int a = 0; a < R; ++a) x[a] = A[d * T::P + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < R; ++c) y[c] = Bm[d * T::P + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) s[a][c] = fmaf(x[a], y[c], s[a][c]);
  }
}

// P and dS of one (query tile q0, key tile k0) pair at the thread's
// micro-tile (rows ty + 16a, keys tx + 16c), from the raw scores s and
// dP = dO V^T; dead pairs (past S or kv_len, in the causal future, or at
// or before p - window) get P = dS = 0.
template <int R>
__device__ __forceinline__ void p_and_ds(float (&s)[R][R], float (&dp)[R][R],
                                         const float* lse_s, const float* D_s,
                                         int q0, int k0, int S, int kv_len,
                                         int q_offset, int causal, int window,
                                         float scale, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = ty + 16 * a;
    const long long qpos = (long long)q_offset + q0 + r;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int kpos = k0 + tx + 16 * c;
      bool live = q0 + r < S && kpos < kv_len;
      if (causal) live = live && (long long)kpos <= qpos;
      if (window > 0) live = live && (long long)kpos > qpos - window;
      const float p = live ? expf(s[a][c] * scale - lse_s[r]) : 0.0f;
      s[a][c] = p;
      dp[a][c] = p * (dp[a][c] - D_s[r]);
    }
  }
}

template <int HD>
struct SmemDKV {  // in floats: Q, dO, K, V tiles, P, dS, lse and D rows
  using T = Simt<HD>;
  static constexpr size_t bytes =
      sizeof(float) * (4 * T::TILE + 2 * T::BT * T::P + 2 * T::BT);
};

template <int HD>
struct SmemDQ {   // Q, dO, K, V tiles, dS, lse and D rows
  using T = Simt<HD>;
  static constexpr size_t bytes =
      sizeof(float) * (4 * T::TILE + T::BT * T::P + 2 * T::BT);
};

// The query tiles of `bt` rows that see key tile [k0, k0 + kn): from the
// first whose last query is not before k0 (causal) to the last whose
// first query is not past k0 + kn - 1 + window - 1 (a window); [qt0, qt1).
__device__ __forceinline__ void query_tiles(int k0, int kn, int S,
                                            int q_offset, int causal,
                                            int window, int bt, int& qt0,
                                            int& qt1) {
  qt0 = 0;
  qt1 = (S + bt - 1) / bt;
  if (causal) {
    const long long first = (long long)k0 - q_offset;
    qt0 = first <= 0 ? 0 : (int)((first < S ? first : S) / bt);
  }
  if (window > 0) {
    const long long last = (long long)k0 + kn - 2 + window - q_offset;
    const long long lim = last < 0 ? 0 : last / bt + 1;
    if (lim < qt1) qt1 = (int)lim;
  }
}

// The key tiles of `bt` keys that a query tile [q0, q0 + qn) sees: from
// the one holding its first query's first key (a window) to the one
// holding its last query's last key (causal), at most those below
// kv_len; [kt0, kt1).
__device__ __forceinline__ void key_tiles(int q0, int qn, int kv_len,
                                          int q_offset, int causal,
                                          int window, int bt, int& kt0,
                                          int& kt1) {
  kt0 = 0;
  kt1 = (kv_len + bt - 1) / bt;
  if (causal) {
    const long long last = (long long)q_offset + q0 + qn - 1;
    const long long lim = last < 0 ? 0 : last / bt + 1;
    if (lim < kt1) kt1 = (int)lim;
  }
  if (window > 0) {
    const long long first = (long long)q_offset + q0 - window + 1;
    if (first > 0) kt0 = (int)(first / bt);
  }
}

// ------------------------------------------------------------------ dK, dV

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ D,
            float* __restrict__ dk, float* __restrict__ dv, int G, int S,
            int Tk, int kv_len, int q_offset, int causal, int window,
            float scale, Strides qs, Strides ks, Strides vs, Strides dos,
            Strides dks, Strides dvs) {
  using T = Simt<HD>;
  constexpr int OJ = HD / 16, R = T::R, BT = T::BT, P = T::P;
  extern __shared__ float smem[];
  float* Qs = smem;                       // Qs[d][row]
  float* Os = Qs + T::TILE;               // dOs[d][row]
  float* Ks = Os + T::TILE;               // Ks[d][key]
  float* Vs = Ks + T::TILE;               // Vs[d][key]
  float* Ps = Vs + T::TILE;               // Ps[row][key]
  float* dSs = Ps + BT * P;               // dSs[row][key]
  float* lse_s = dSs + BT * P;
  float* D_s = lse_s + BT;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y * G;

  load_t<HD>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, Tk);
  load_t<HD>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, Tk);

  float acc_k[R][OJ], acc_v[R][OJ];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < OJ; ++c) acc_k[a][c] = acc_v[a][c] = 0.0f;

  // the query tiles that see a key of this tile
  int qt0, qt1;
  query_tiles(k0, BT, S, q_offset, causal, window, BT, qt0, qt1);
  const bool dead = k0 >= kv_len;

  for (int g = 0; g < G && !dead; ++g) {
    const int h = hk * G + g;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* ob = dO + b * dos.b + h * dos.h;
    const float* lrow = lse + ((long long)b * Hq + h) * S;
    const float* drow = D + ((long long)b * Hq + h) * S;
    for (int qt = qt0; qt < qt1; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                  // the previous tile is consumed
      load_t<HD>(Qs, qb, qs.s, q0, S);
      load_t<HD>(Os, ob, dos.s, q0, S);
      if (tid < BT) {
        lse_s[tid] = q0 + tid < S ? lrow[q0 + tid] : 0.0f;
        D_s[tid] = q0 + tid < S ? drow[q0 + tid] : 0.0f;
      }
      __syncthreads();

      float s[R][R], dp[R][R];
      tile_dot<HD>(s, Qs, Ks, ty, tx);
      tile_dot<HD>(dp, Os, Vs, ty, tx);
      p_and_ds<R>(s, dp, lse_s, D_s, q0, k0, S, kv_len, q_offset, causal,
                  window, scale, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          Ps[(ty + 16 * a) * P + tx + 16 * c] = s[a][c];
          dSs[(ty + 16 * a) * P + tx + 16 * c] = dp[a][c];
        }
      __syncthreads();

      // dV[key][d] += sum_r P[r][key] dO[r][d]; dK likewise with dS and Q
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float p[R], ds[R], o[OJ], x[OJ];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          p[a] = Ps[r * P + ty + 16 * a];
          ds[a] = dSs[r * P + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < OJ; ++c) {
          o[c] = Os[(tx + 16 * c) * P + r];
          x[c] = Qs[(tx + 16 * c) * P + r];
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int c = 0; c < OJ; ++c) {
            acc_v[a][c] = fmaf(p[a], o[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(ds[a], x[c], acc_k[a][c]);
          }
      }
    }
  }

  float* kb = dk + b * dks.b + hk * dks.h;
  float* vb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < OJ; ++c) {
      kb[(long long)key * dks.s + tx + 16 * c] = acc_k[a][c] * scale;
      vb[(long long)key * dvs.s + tx + 16 * c] = acc_v[a][c];
    }
  }
}

// ---------------------------------------------------------------------- dQ

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ D,
          float* __restrict__ dq, int G, int S, int Tk, int kv_len,
          int q_offset, int causal, int window, float scale, Strides qs,
          Strides ks, Strides vs, Strides dos, Strides dqs) {
  using T = Simt<HD>;
  constexpr int OJ = HD / 16, R = T::R, BT = T::BT, P = T::P;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + T::TILE;
  float* Ks = Os + T::TILE;
  float* Vs = Ks + T::TILE;
  float* dSs = Vs + T::TILE;              // dSs[row][key]
  float* lse_s = dSs + BT * P;
  float* D_s = lse_s + BT;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, Hq = gridDim.y;
  const int hk = h / G;

  load_t<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_t<HD>(Os, dO + b * dos.b + h * dos.h, dos.s, q0, S);
  if (tid < BT) {
    const long long row = ((long long)b * Hq + h) * S + q0 + tid;
    lse_s[tid] = q0 + tid < S ? lse[row] : 0.0f;
    D_s[tid] = q0 + tid < S ? D[row] : 0.0f;
  }

  float acc[R][OJ];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < OJ; ++c) acc[a][c] = 0.0f;

  // the key tiles that this query tile sees
  int kt0, kt1;
  key_tiles(q0, BT, kv_len, q_offset, causal, window, BT, kt0, kt1);
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                    // the previous tile is consumed
    load_t<HD>(Ks, kb, ks.s, k0, Tk);
    load_t<HD>(Vs, vb, vs.s, k0, Tk);
    __syncthreads();

    float s[R][R], dp[R][R];
    tile_dot<HD>(s, Qs, Ks, ty, tx);
    tile_dot<HD>(dp, Os, Vs, ty, tx);
    p_and_ds<R>(s, dp, lse_s, D_s, q0, k0, S, kv_len, q_offset, causal,
                window, scale, ty, tx);
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c)
        dSs[(ty + 16 * a) * P + tx + 16 * c] = dp[a][c];
    __syncthreads();

    // dQ[r][d] += sum_j dS[r][j] K[j][d]
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float ds[R], x[OJ];
#pragma unroll
      for (int a = 0; a < R; ++a) ds[a] = dSs[(ty + 16 * a) * P + j];
#pragma unroll
      for (int c = 0; c < OJ; ++c) x[c] = Ks[(tx + 16 * c) * P + j];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < OJ; ++c) acc[a][c] = fmaf(ds[a], x[c], acc[a][c]);
    }
  }

  float* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < OJ; ++c)
      qb[(long long)row * dqs.s + tx + 16 * c] = acc[a][c] * scale;
  }
}

// ====================================== bfloat16 on the tensor cores

namespace tc {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBlock = 384;          // producer + two consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;   // 168 on average
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------- dK, dV: 128 keys a block (64 at hd 256)

constexpr int QM = 64;               // queries per tile of the ring

// hd <= 128: 128 keys a block, 64 a consumer, each consumer all hd
// columns of its keys' dK and dV (2 x 64 registers a thread at hd 128),
// with a 3-stage Q/dO ring. hd 256 has a kernel of its own
// (fa_bwd_dkdv_hd256, below).
template <int HD>
struct DkvCfg : Atom<HD> {
  static_assert(HD <= 128, "hd 256 runs fa_bwd_dkdv_hd256");
  static constexpr int KN = 128;                 // keys a block
  static constexpr int STAGES = 3;               // the Q/dO ring
  static constexpr int KV_BYTES = KN * HD * 2;   // K or V, [NA][KN][AC]
  static constexpr int QT_BYTES = QM * HD * 2;   // Q or dO, [NA][QM][AC]
  static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGES * QT_BYTES +
                              2 * STAGES * QM * 4 + 1024 + 64;
};

// One block per (KN-key tile, kv head, batch). The producer loads the
// block's K and V tiles once, then, for each query head of the group and
// each query tile from the causal limit on (to the window's end under a
// window), Q and dO (TMA) and the rows' log2-scaled log-sum-exp and D
// (ordinary loads by warp 0's lanes: the float32 (B, Hq, S) rows are
// 16-byte aligned only when S is a multiple of 4) into a ring of STAGES
// stages. Each consumer warpgroup owns 64 keys: S^T = K Q^T and dP^T =
// V dO^T (SS wgmma), P^T and dS^T in registers, dV += P^T dO and dK +=
// dS^T Q (RS wgmma, dO and Q MN-major). WIN: a sliding window (window >
// 0); the kernels without one compile none of its tests.
// The dK/dV producer (warp 0 of warpgroup 0): K and V of the block's KN
// keys once, then Q and dO of each of the n_it (query head, query tile)
// pairs, with their rows' log2-scaled lse and D, into a ring of STAGES
// stages behind full/empty mbarriers. h0: the block's first query head.
template <int HD, int KN, int STAGES>
__device__ __forceinline__ void dkdv_produce(
    const CUtensorMap* tk, const CUtensorMap* tv, const CUtensorMap* tq,
    const CUtensorMap* tdo, const float* __restrict__ lse,
    const float* __restrict__ D, uint8_t* sK, uint8_t* sV, uint8_t* sQ,
    uint8_t* sO, float* sL, float* sD, uint64_t* kv_full, uint64_t* full,
    uint64_t* empty, int n_it, int nqt, int qt0, int k0, int hk, int b,
    int h0, int Hq, int S) {
  constexpr int KV_BYTES = KN * HD * 2, QT_BYTES = QM * HD * 2;
  const int lane = threadIdx.x % 32;
  if (lane == 0 && n_it > 0) {
    bar_expect_tx(kv_full, 2 * KV_BYTES);
    tma_tile<HD>(sK, tk, KN, k0, hk, b, kv_full);
    tma_tile<HD>(sV, tv, KN, k0, hk, b, kv_full);
  }
  for (int j = 0; j < n_it; ++j) {
    const int s = j % STAGES;
    if (j >= STAGES) bar_wait(empty + s, (j / STAGES - 1) & 1);
    const int gi = j / nqt, q0 = (qt0 + j - gi * nqt) * QM;
    const int h = h0 + gi;
    const long long row = ((long long)b * Hq + h) * S + q0;
#pragma unroll
    for (int r = lane; r < QM; r += 32) {
      const bool in = q0 + r < S;
      sL[s * QM + r] = in ? lse[row + r] * kLog2e : 0.0f;
      sD[s * QM + r] = in ? D[row + r] : 0.0f;
    }
    if (lane == 0) {
      bar_expect_tx(full + s, 2 * QT_BYTES);
      tma_tile<HD>(sQ + s * QT_BYTES, tq, QM, q0, h, b, full + s);
      tma_tile<HD>(sO + s * QT_BYTES, tdo, QM, q0, h, b, full + s);
    } else {
      bar_arrive(full + s);
    }
  }
}

// 2^x for P: at hd 256 the bare special-function instruction (ex2.approx
// with denormal results flushed to 0), as the forward takes it there;
// exp2f (the same instruction with a fixup of arguments below -126) at the
// other head dims, which keep their bits.
template <bool APPROX>
__device__ __forceinline__ float exp2_p(float x) {
  if constexpr (APPROX) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
  } else {
    return exp2f(x);
  }
}

// P^T = exp(s scale - lse) of a consumer's 64 keys (the thread's rows
// key_lo and key_lo + 8) and a query tile (from q0), in place of the
// scores S^T in the accumulator layout; exactly 0 on dead pairs when
// `masked` (some pair of the tile is dead).
template <bool WIN, bool APPROX>
__device__ __forceinline__ void p_tile(float (&st)[QM / 2], const float* lrow,
                                       bool masked, int key_lo, int cq,
                                       int q0, int S, int kv_len,
                                       int q_offset, int causal, int window,
                                       float scale_log2) {
#pragma unroll
  for (int i = 0; i < QM / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * i + cq + e;
      const float l2 = lrow[col];
      float p_lo = exp2_p<APPROX>(st[4 * i + e] * scale_log2 - l2);
      float p_hi = exp2_p<APPROX>(st[4 * i + 2 + e] * scale_log2 - l2);
      if (masked) {
        const long long qpos = (long long)q_offset + q0 + col;
        const bool q_in = q0 + col < S;
        if (!q_in || key_lo >= kv_len || (causal && key_lo > qpos) ||
            (WIN && key_lo <= qpos - window))
          p_lo = 0.0f;
        if (!q_in || key_lo + 8 >= kv_len || (causal && key_lo + 8 > qpos) ||
            (WIN && key_lo + 8 <= qpos - window))
          p_hi = 0.0f;
      }
      st[4 * i + e] = p_lo;
      st[4 * i + 2 + e] = p_hi;
    }
  }
}

template <int HD, bool WIN>
__global__ void __launch_bounds__(kBlock, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, Strides dks,
                  Strides dvs, int B, int Hkv, int G, int S, int T, int kv_len,
                  int q_offset, int causal, int window, float scale,
                  float scale_log2) {
  using C = DkvCfg<HD>;
  constexpr int KN = C::KN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = smem;
  uint8_t* sV = sK + C::KV_BYTES;
  uint8_t* sQ = sV + C::KV_BYTES;                   // [stage]
  uint8_t* sO = sQ + C::STAGES * C::QT_BYTES;       // [stage]
  float* sL = reinterpret_cast<float*>(sO + C::STAGES * C::QT_BYTES);
  float* sD = sL + C::STAGES * QM;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sD + C::STAGES * QM);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::STAGES;

  // block order: key tile slowest, so the first wave holds every head's
  // first key tiles, the longest under a causal mask
  const int hb = blockIdx.x % (Hkv * B);
  const int hk = hb % Hkv, b = hb / Hkv;
  const int k0 = blockIdx.x / (Hkv * B) * KN;
  const int Hq = Hkv * G;
  int qt0, qt1;                      // the query tiles that see the keys
  query_tiles(k0, KN, S, q_offset, causal, WIN ? window : 0, QM, qt0, qt1);
  const int nqt = k0 < kv_len && qt1 > qt0 ? qt1 - qt0 : 0;
  const int n_it = G * nqt;          // every query head of the group

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      bar_init(full + s, 32);                      // warp 0's lanes
      bar_init(empty + s, 8);                      // the consumers' warps
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kProducerRegs));
    if (threadIdx.x < 32)
      dkdv_produce<HD, KN, C::STAGES>(
          &tk, &tv, &tq, &tdo, lse, D, sK, sV, sQ, sO, sL, sD, kv_full, full,
          empty, n_it, nqt, qt0, k0, hk, b, hk * G, Hq, S);
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     kConsumerRegs));
    const int w = wg - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int kw0 = k0 + 64 * w;                     // keys kw0 .. kw0 + 63
    const int key_lo = kw0 + 16 * warp + lane / 4;   // and key_lo + 8
    const int cq = 2 * (lane % 4);
    const uint32_t k_addr = smem_u32(sK) + (kw0 - k0) * C::ATOM_B;
    const uint32_t v_addr = smem_u32(sV) + (kw0 - k0) * C::ATOM_B;

    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    if (n_it > 0) bar_wait(kv_full, 0);
    for (int j = 0; j < n_it; ++j) {
      const int s = j % C::STAGES, ph = (j / C::STAGES) & 1;
      const int q0 = (qt0 + j - j / nqt * nqt) * QM;
      bar_wait(full + s, ph);
      // keys all padded, all after every query of the tile, or all at or
      // before every query's window: P^T = 0
      const bool idle = kw0 >= kv_len ||
                        (causal && (long long)kw0 >
                                       (long long)q_offset + q0 + QM - 1) ||
                        (WIN && (long long)kw0 + 63 <=
                                    (long long)q_offset + q0 - window);
      if (!idle) {
        const uint32_t q_addr = smem_u32(sQ + s * C::QT_BYTES);
        const uint32_t o_addr = smem_u32(sO + s * C::QT_BYTES);
        const float* lrow = sL + s * QM;
        const float* drow = sD + s * QM;

        // S^T = K Q^T and dP^T = V dO^T over hd, two groups in flight
        float st[QM / 2], dpt[QM / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(st, desc_kmajor<HD>(k_addr, KN, kk),
                   desc_kmajor<HD>(q_addr, QM, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(dpt, desc_kmajor<HD>(v_addr, KN, kk),
                   desc_kmajor<HD>(o_addr, QM, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // P^T = exp(s scale - lse) on live pairs, exactly 0 elsewhere
        const bool masked = q0 + QM > S || kw0 + 64 > kv_len ||
                            (causal && (long long)kw0 + 63 >
                                           (long long)q_offset + q0) ||
                            (WIN &&
                             (long long)kw0 <=
                                 (long long)q_offset + q0 + QM - 1 - window);
        p_tile<WIN, false>(st, lrow, masked, key_lo, cq, q0, S, kv_len,
                           q_offset, causal, window, scale_log2);

        // dV += P^T dO (P^T rounded to bf16)
        uint32_t fa[QM / 16][4];
        to_a_frags(fa, st);
        fence_regs(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QM / 16; ++kk)
          wgmma_rs(dv_acc, fa[kk], desc_mnmajor<HD>(o_addr, QM, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dpt);
        fence_regs(dv_acc);

        // dS^T = P^T o (dP^T - D), then dK += dS^T Q (dS^T rounded)
#pragma unroll
        for (int i = 0; i < QM / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = drow[8 * i + cq + e];
            dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - d);
            dpt[4 * i + 2 + e] = st[4 * i + 2 + e] * (dpt[4 * i + 2 + e] - d);
          }
        }
        to_a_frags(fa, dpt);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QM / 16; ++kk)
          wgmma_rs(dk_acc, fa[kk], desc_mnmajor<HD>(q_addr, QM, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dk_acc);
      }
      if (lane == 0) bar_arrive(empty + s);
    }

    bf16* kb = dk + b * dks.b + hk * dks.h;
    bf16* vb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_lo + 8 * half;
      if (key >= T) continue;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int c = 8 * i + cq, a = 4 * i + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(kb + (long long)key * dks.s + c) =
            __floats2bfloat162_rn(dk_acc[a] * scale, dk_acc[a + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vb + (long long)key * dvs.s + c) =
            __floats2bfloat162_rn(dv_acc[a], dv_acc[a + 1]);
      }
    }
  }
}

// ------------------------------------ dK, dV at hd 256: 64 keys a block

// 64 keys x 256 columns of dK and dV a consumer would take 256 registers
// a thread, and two 128-key K/V tiles with a Q/dO ring 320 KB of shared
// memory; so a block takes 64 keys, and each of its two consumers owns 128
// of the 256 columns of dK and dV. The score products are not computed
// twice: consumer 0 computes S^T = K Q^T and P^T, consumer 1 dP^T = V dO^T
// and dS^T = P^T o (dP^T - D), and each hands its result to the other
// through shared memory. Both products' accumulators have one layout, so
// thread t of one consumer holds the very elements that thread t of the
// other needs: P^T goes over in float32 (dS^T is formed from it, as
// before), dS^T as its bf16 A fragments, each thread its own column of
// the exchange buffers (no bank conflicts, no swizzle, no async proxy:
// both sides read and write them with ordinary instructions). Two named
// barriers of both consumers a tile (P^T written; dS^T written) order the
// handoffs, and since every thread meets both each tile, one buffer of
// each suffices: consumer 0 writes the next P^T only after the dS^T
// barrier, which consumer 1 meets after reading this P^T; consumer 1
// writes the next dS^T only after the next P^T barrier, which consumer 0
// meets after reading this dS^T. Each consumer then runs dV += P^T dO and
// dK += dS^T Q over its 128 columns, both from registers (RS), the dV
// product issued before the dS^T barrier. Four products of a 64 x 64 tile
// over hd 256 a tile where the earlier design ran six, the values entering
// each product unchanged. P's exponentials are ex2.approx, as the forward's
// at hd 256 (exp2f added 0.06 ms to this kernel's 0.54 on an H100).
// What sets the pace (variants of this source timed in one call on an
// H100 at recurrentgemma-9b's training shape, 0.54 ms then): the two score
// products, whose operands both come from shared memory (4 KB a k16 step
// for a 64 x 64 x 16 product, about what the tensor cores take in the same
// time, and both consumers issue them): they and the softmax and the
// handoffs alone took 0.45 ms, the dV and dK products 0.09 more; loading
// the Q/dO ring alone took 0.24 ms and overlaps the rest (without the
// loads the kernel took no less, nor with each tile's copies issued
// before its rows' loads); the handoffs' barriers cost 0.07.
struct DkvHd256 : Atom<256> {
  static constexpr int HD = 256;
  static constexpr int KN = 64;                  // keys a block
  static constexpr int DC = HD / 2;              // dK/dV columns a consumer
  static constexpr int STAGES = 2;               // the Q/dO ring
  static constexpr int KV_BYTES = KN * HD * 2;   // K or V, [NA][KN][AC]
  static constexpr int QT_BYTES = QM * HD * 2;   // Q or dO, [NA][QM][AC]
  static constexpr int XP_BYTES = 128 * (QM / 2) * 4;    // P^T, float32
  static constexpr int XS_BYTES = 128 * (QM / 16) * 16;  // dS^T fragments
  static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGES * QT_BYTES +
                              2 * STAGES * QM * 4 + XP_BYTES + XS_BYTES +
                              1024 + 64;
};
constexpr int kBarP = 1, kBarS = 2;  // named barriers: P^T, dS^T written

// One block per (64-key tile, kv head, batch), or with `split` > 1 (too
// few key tiles to fill the card: recurrentgemma's one KV head at batch
// 1) per (64-key tile, 1 / split of the KV head's query heads, kv head,
// batch), writing unscaled float32 sums to `part` (split, B, Hkv, T, hd)
// for dK, then for dV, which `fa_bwd_kv_sum` adds in part order. The
// producer and the ring are fa_bwd_dkdv_wgmma's, with two stages.
template <bool WIN>
__global__ void __launch_bounds__(kBlock, 1)
fa_bwd_dkdv_hd256(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, Strides dks,
                  Strides dvs, int B, int Hkv, int G, int S, int T, int kv_len,
                  int q_offset, int causal, int window, float scale,
                  float scale_log2, int split, float* __restrict__ part) {
  using C = DkvHd256;
  constexpr int HD = C::HD, KN = C::KN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = smem;
  uint8_t* sV = sK + C::KV_BYTES;
  uint8_t* sQ = sV + C::KV_BYTES;                   // [stage]
  uint8_t* sO = sQ + C::STAGES * C::QT_BYTES;       // [stage]
  float* sL = reinterpret_cast<float*>(sO + C::STAGES * C::QT_BYTES);
  float* sD = sL + C::STAGES * QM;
  float4* xp = reinterpret_cast<float4*>(sD + C::STAGES * QM);  // [8][128]
  uint4* xs = reinterpret_cast<uint4*>(sD + C::STAGES * QM +
                                       C::XP_BYTES / 4);        // [4][128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(xs) + C::XS_BYTES);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::STAGES;

  // block order: key tile slowest, then the split's part
  const int hb = blockIdx.x % (Hkv * B);
  const int hk = hb % Hkv, b = hb / Hkv;
  const int rest = blockIdx.x / (Hkv * B);
  const int sp = rest % split, k0 = rest / split * KN;
  const int Hq = Hkv * G, Gs = G / split;
  int qt0, qt1;                      // the query tiles that see the keys
  query_tiles(k0, KN, S, q_offset, causal, WIN ? window : 0, QM, qt0, qt1);
  const int nqt = k0 < kv_len && qt1 > qt0 ? qt1 - qt0 : 0;
  const int n_it = Gs * nqt;         // heads sp Gs .. sp Gs + Gs - 1

  if (threadIdx.x == 0) {
    bar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      bar_init(full + s, 32);                      // warp 0's lanes
      bar_init(empty + s, 8);                      // the consumers' warps
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kProducerRegs));
    if (threadIdx.x < 32)
      dkdv_produce<HD, KN, C::STAGES>(
          &tk, &tv, &tq, &tdo, lse, D, sK, sV, sQ, sO, sL, sD, kv_full, full,
          empty, n_it, nqt, qt0, k0, hk, b, hk * G + sp * Gs, Hq, S);
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     kConsumerRegs));
    const int w = wg - 1;            // 0: S^T and P^T; 1: dP^T and dS^T
    const int t = threadIdx.x % 128, warp = t / 32;
    const int col0 = C::DC * w;      // dK/dV columns col0 .. col0 + 127
    const int key_lo = k0 + 16 * warp + lane / 4;   // and key_lo + 8
    const int cq = 2 * (lane % 4);
    // this consumer's score product: K Q^T or V dO^T
    const uint32_t a_addr = smem_u32(w == 0 ? sK : sV);
    // the consumer's columns of a Q/dO tile: atoms col0 / AC on
    const uint32_t col_b = (col0 / C::AC) * QM * C::ATOM_B;

    float dk_acc[C::DC / 2], dv_acc[C::DC / 2];
#pragma unroll
    for (int i = 0; i < C::DC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    if (n_it > 0) bar_wait(kv_full, 0);
    for (int j = 0; j < n_it; ++j) {
      const int s = j % C::STAGES, ph = (j / C::STAGES) & 1;
      const int q0 = (qt0 + j - j / nqt * nqt) * QM;
      bar_wait(full + s, ph);
      // keys all padded, all after every query of the tile, or all at or
      // before every query's window: P^T = 0 (both consumers agree)
      const bool idle = k0 >= kv_len ||
                        (causal && (long long)k0 >
                                       (long long)q_offset + q0 + QM - 1) ||
                        (WIN && (long long)k0 + 63 <=
                                    (long long)q_offset + q0 - window);
      if (!idle) {
        const uint32_t q_addr = smem_u32(sQ + s * C::QT_BYTES);
        const uint32_t o_addr = smem_u32(sO + s * C::QT_BYTES);

        // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1) over hd
        float sc[QM / 2];
        const uint32_t b_addr = w == 0 ? q_addr : o_addr;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(sc, desc_kmajor<HD>(a_addr, KN, kk),
                   desc_kmajor<HD>(b_addr, QM, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        uint32_t fp[QM / 16][4], fs[QM / 16][4];   // P^T, dS^T in bf16
        if (w == 0) {
          // P^T = exp(s scale - lse) on live pairs, exactly 0 elsewhere
          const bool masked =
              q0 + QM > S || k0 + 64 > kv_len ||
              (causal && (long long)k0 + 63 > (long long)q_offset + q0) ||
              (WIN && (long long)k0 <=
                          (long long)q_offset + q0 + QM - 1 - window);
          p_tile<WIN, true>(sc, sL + s * QM, masked, key_lo, cq, q0, S,
                            kv_len, q_offset, causal, window, scale_log2);
#pragma unroll
          for (int i = 0; i < QM / 8; ++i)
            xp[i * 128 + t] = make_float4(sc[4 * i], sc[4 * i + 1],
                                          sc[4 * i + 2], sc[4 * i + 3]);
          named_sync(kBarP, 256);
          to_a_frags(fp, sc);
        } else {
          named_sync(kBarP, 256);
          float p[QM / 2];
#pragma unroll
          for (int i = 0; i < QM / 8; ++i) {
            const float4 v = xp[i * 128 + t];
            p[4 * i] = v.x, p[4 * i + 1] = v.y;
            p[4 * i + 2] = v.z, p[4 * i + 3] = v.w;
          }
          // dS^T = P^T o (dP^T - D)
          const float* drow = sD + s * QM;
#pragma unroll
          for (int i = 0; i < QM / 8; ++i) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float d = drow[8 * i + cq + e];
              sc[4 * i + e] = p[4 * i + e] * (sc[4 * i + e] - d);
              sc[4 * i + 2 + e] = p[4 * i + 2 + e] * (sc[4 * i + 2 + e] - d);
            }
          }
          to_a_frags(fp, p);
          to_a_frags(fs, sc);
#pragma unroll
          for (int k = 0; k < QM / 16; ++k)
            xs[k * 128 + t] = make_uint4(fs[k][0], fs[k][1], fs[k][2],
                                         fs[k][3]);
        }

        // dV += P^T dO over the consumer's columns (P^T rounded to bf16)
        fence_regs(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QM / 16; ++kk)
          wgmma_rs(dv_acc, fp[kk], desc_mnmajor<HD>(o_addr + col_b, QM, kk));
        wgmma_commit();

        // dK += dS^T Q over the consumer's columns (dS^T rounded)
        named_sync(kBarS, 256);
        if (w == 0) {
#pragma unroll
          for (int k = 0; k < QM / 16; ++k) {
            const uint4 v = xs[k * 128 + t];
            fs[k][0] = v.x, fs[k][1] = v.y, fs[k][2] = v.z, fs[k][3] = v.w;
          }
        }
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QM / 16; ++kk)
          wgmma_rs(dk_acc, fs[kk], desc_mnmajor<HD>(q_addr + col_b, QM, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(fp);
        fence_regs(fs);
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      if (lane == 0) bar_arrive(empty + s);
    }

    if (part != nullptr) {           // this split's float32 sums
      const long long n = (long long)split * B * Hkv * T * HD;
      float* pk = part + (((long long)sp * B + b) * Hkv + hk) * T * HD;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = key_lo + 8 * half;
        if (key >= T) continue;
#pragma unroll
        for (int i = 0; i < C::DC / 8; ++i) {
          const int c = col0 + 8 * i + cq, a = 4 * i + 2 * half;
          float* p = pk + (long long)key * HD + c;
          *reinterpret_cast<float2*>(p) = make_float2(dk_acc[a], dk_acc[a + 1]);
          *reinterpret_cast<float2*>(p + n) =
              make_float2(dv_acc[a], dv_acc[a + 1]);
        }
      }
      return;
    }
    bf16* kb = dk + b * dks.b + hk * dks.h;
    bf16* vb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key_lo + 8 * half;
      if (key >= T) continue;
#pragma unroll
      for (int i = 0; i < C::DC / 8; ++i) {
        const int c = col0 + 8 * i + cq, a = 4 * i + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(kb + (long long)key * dks.s + c) =
            __floats2bfloat162_rn(dk_acc[a] * scale, dk_acc[a + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vb + (long long)key * dvs.s + c) =
            __floats2bfloat162_rn(dv_acc[a], dv_acc[a + 1]);
      }
    }
  }
}

// dK and dV of a split dK/dV call: the parts added in split order, dK
// scaled, each rounded to bf16 once; a thread a pair of columns.
template <int HD>
__global__ void __launch_bounds__(256)
fa_bwd_kv_sum(const float* __restrict__ part, bf16* __restrict__ dk,
              bf16* __restrict__ dv, Strides dks, Strides dvs, int B,
              int Hkv, int T, int split, float scale) {
  const long long pairs = (long long)B * Hkv * T * HD / 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  const long long n = (long long)split * B * Hkv * T * HD;
  const long long stride = (long long)B * Hkv * T * HD;
  const int c = (int)(i % (HD / 2)) * 2;
  const long long r = i / (HD / 2);             // (b, hk, key) row
  const int key = (int)(r % T), hk = (int)((r / T) % Hkv),
            b = (int)(r / ((long long)T * Hkv));
  float2 sk = make_float2(0.0f, 0.0f), sv = sk;
  for (int p = 0; p < split; ++p) {
    const float2 x = *reinterpret_cast<const float2*>(part + p * stride +
                                                      r * HD + c);
    const float2 y = *reinterpret_cast<const float2*>(part + n + p * stride +
                                                      r * HD + c);
    sk.x += x.x, sk.y += x.y, sv.x += y.x, sv.y += y.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + b * dks.b + hk * dks.h +
                                     (long long)key * dks.s + c) =
      __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  *reinterpret_cast<__nv_bfloat162*>(dv + b * dvs.b + hk * dvs.h +
                                     (long long)key * dvs.s + c) =
      __floats2bfloat162_rn(sv.x, sv.y);
}

// D (64 x 48, fp32) {=, +=} A (64 x 16) . B (16 x 48); A and B K-major in
// shared memory (descriptors da, db): the dQ kernel's scores over a 48-key
// tile at hd 256.
__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate));
}
using hopper::wgmma_ss;   // beside the overloads hopper.cuh defines

// ----------------------------------------------- dQ: 128 queries a block

constexpr int QB = 128;              // queries per block, 64 per consumer

// hd <= 128: 128-key tiles through a 2-stage ring. hd 256: 48-key tiles
// through a 2-stage ring, so that the next tile lands while the consumers
// work on this one: the block's Q and dO take 128 KB, and two stages of
// 64-key K and V tiles (128 KB) would not fit beside them; two of 48 keys
// take 96 KB. Timed at recurrentgemma-9b's training shape on an H100, the
// dQ kernel took 0.304 ms with 48-key tiles, 0.384 with 32 (m64n32
// products, each reading its 2 KB A tile for half the work of an m64n64)
// and 0.330 with one stage of 64 (the earlier design: the consumers waited
// for every tile's loads).
template <int HD>
struct DqCfg : Atom<HD> {
  static constexpr int KT = HD == 256 ? 48 : 128;  // keys a tile
  static constexpr int STAGES = 2;                 // the K/V ring
  static constexpr int Q_BYTES = QB * HD * 2;    // Q or dO, [NA][QB][AC]
  static constexpr int KV_BYTES = KT * HD * 2;   // K or V, [NA][KT][AC]
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024 +
                              64;
};

// One block per (128 query rows, q head, batch), shaped like the forward:
// the producer loads Q and dO once and streams the K and V tiles from the
// window's start (under a window) up to the causal limit through the
// ring; each consumer warpgroup owns 64 rows: S = Q K^T and dP = dO V^T
// (SS wgmma), dS in registers, dQ += dS K (RS wgmma, K MN-major). dQ is
// scaled and rounded to bf16 once, at the end. WIN as the dK/dV kernel's.
template <int HD, bool WIN>
__global__ void __launch_bounds__(kBlock, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse, const float* __restrict__ D,
                bf16* __restrict__ dq, Strides dqs, int B, int Hq, int G, int S,
                int kv_len, int q_offset, int causal, int window, float scale,
                float scale_log2) {
  using C = DqCfg<HD>;
  constexpr int KT = C::KT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;
  uint8_t* sO = sQ + C::Q_BYTES;
  uint8_t* sK = sO + C::Q_BYTES;                    // [stage]
  uint8_t* sV = sK + C::STAGES * C::KV_BYTES;       // [stage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + C::STAGES * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::STAGES;

  // block order: query tile slowest and last-first, so the first wave
  // holds every head's longest causal rows
  const int hb = blockIdx.x % (Hq * B);
  const int h = hb % Hq, b = hb / Hq;
  const int q0 = ((S + QB - 1) / QB - 1 - (int)(blockIdx.x / (Hq * B))) * QB;
  int kt0, kt1;                      // the key tiles the block's rows see
  key_tiles(q0, QB, kv_len, q_offset, causal, WIN ? window : 0, KT, kt0,
            kt1);
  const int nk = kt1 > kt0 ? kt1 - kt0 : 0;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, 8);                      // the consumers' warps
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kProducerRegs));
    if (threadIdx.x == 0) {
      const int hk = h / G;
      bar_expect_tx(q_full, 2 * C::Q_BYTES);
      tma_tile<HD>(sQ, &tq, QB, q0, h, b, q_full);
      tma_tile<HD>(sO, &tdo, QB, q0, h, b, q_full);
      for (int j = 0; j < nk; ++j) {
        const int s = j % C::STAGES, k0 = (kt0 + j) * KT;
        if (j >= C::STAGES) bar_wait(empty + s, (j / C::STAGES - 1) & 1);
        bar_expect_tx(full + s, 2 * C::KV_BYTES);
        tma_tile<HD>(sK + s * C::KV_BYTES, &tk, KT, k0, hk, b, full + s);
        tma_tile<HD>(sV + s * C::KV_BYTES, &tv, KT, k0, hk, b, full + s);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     kConsumerRegs));
    const int w = wg - 1;                          // rows 64w .. 64w + 63
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r_lo = q0 + 64 * w + 16 * warp + lane / 4;   // and r_lo + 8
    const long long pos_lo = (long long)q_offset + r_lo;
    const long long first_pos = (long long)q_offset + q0 + 64 * w;
    const int cq = 2 * (lane % 4);
    const long long row = ((long long)b * Hq + h) * S;
    // rows past S read zeros from TMA and are never written: 0 is safe
    const float l2_lo = r_lo < S ? lse[row + r_lo] * kLog2e : 0.0f;
    const float l2_hi = r_lo + 8 < S ? lse[row + r_lo + 8] * kLog2e : 0.0f;
    const float d_lo = r_lo < S ? D[row + r_lo] : 0.0f;
    const float d_hi = r_lo + 8 < S ? D[row + r_lo + 8] : 0.0f;
    const uint32_t q_addr = smem_u32(sQ) + w * 64 * C::ATOM_B;
    const uint32_t o_addr = smem_u32(sO) + w * 64 * C::ATOM_B;

    float dq_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq_acc[i] = 0.0f;

    bar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % C::STAGES, ph = (j / C::STAGES) & 1;
      const int k0 = (kt0 + j) * KT;
      bar_wait(full + s, ph);
      // every key of the tile after every row of this warpgroup, or at or
      // before every row's window: P = 0
      const bool idle = (causal && (long long)k0 > first_pos + 63) ||
                        (WIN && (long long)k0 + KT - 1 <= first_pos - window);
      if (!idle) {
        const uint32_t k_addr = smem_u32(sK + s * C::KV_BYTES);
        const uint32_t v_addr = smem_u32(sV + s * C::KV_BYTES);

        // S = Q K^T and dP = dO V^T over hd, two groups in flight
        float sacc[KT / 2], dp[KT / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(sacc, desc_kmajor<HD>(q_addr, QB, kk),
                   desc_kmajor<HD>(k_addr, KT, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          wgmma_ss(dp, desc_kmajor<HD>(o_addr, QB, kk),
                   desc_kmajor<HD>(v_addr, KT, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sacc);

        // P = exp(s scale - lse) on live pairs, exactly 0 elsewhere
        const bool masked = k0 + KT > kv_len ||
                            (causal && (long long)k0 + KT - 1 > first_pos) ||
                            (WIN && (long long)k0 <= first_pos + 63 - window);
#pragma unroll
        for (int i = 0; i < KT / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p_lo =
                exp2_p<HD == 256>(sacc[4 * i + e] * scale_log2 - l2_lo);
            float p_hi =
                exp2_p<HD == 256>(sacc[4 * i + 2 + e] * scale_log2 - l2_hi);
            if (masked) {
              const int kpos = k0 + 8 * i + cq + e;
              const bool pad = kpos >= kv_len;
              if (pad || (causal && kpos > pos_lo) ||
                  (WIN && kpos <= pos_lo - window))
                p_lo = 0.0f;
              if (pad || (causal && kpos > pos_lo + 8) ||
                  (WIN && kpos <= pos_lo + 8 - window))
                p_hi = 0.0f;
            }
            sacc[4 * i + e] = p_lo;
            sacc[4 * i + 2 + e] = p_hi;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);

        // dS = P o (dP - D), rounded to bf16; dQ += dS K
#pragma unroll
        for (int i = 0; i < KT / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dp[4 * i + e] = sacc[4 * i + e] * (dp[4 * i + e] - d_lo);
            dp[4 * i + 2 + e] = sacc[4 * i + 2 + e] * (dp[4 * i + 2 + e] - d_hi);
          }
        }
        uint32_t fa[KT / 16][4];
        to_a_frags(fa, dp);
        fence_regs(dq_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk)
          wgmma_rs(dq_acc, fa[kk], desc_mnmajor<HD>(k_addr, KT, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
      }
      if (lane == 0) bar_arrive(empty + s);
    }

    bf16* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + 8 * half;
      if (r >= S) continue;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int a = 4 * i + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(qb + (long long)r * dqs.s + 8 * i +
                                           cq) =
            __floats2bfloat162_rn(dq_acc[a] * scale, dq_acc[a + 1] * scale);
      }
    }
  }
}

}  // namespace tc

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  float* D;
  void *dq, *dk, *dv;
  int B, Hq, Hkv, S, T, kv_len, q_offset, causal, window;
  float scale;
  int split;        // the bf16 dK/dV kernel's head-group split (1: none)
  float* part;      // its float32 (2, split, B, Hkv, T, hd) parts, or null
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

// The dK/dV kernel of a head dim (launched with its shared memory and
// register check): fa_bwd_dkdv_hd256 at hd 256, with its head split and
// the parts' sum; fa_bwd_dkdv_wgmma below.
template <int HD, bool WIN>
int launch_dkdv(const Args& a, const CUtensorMap& tk, const CUtensorMap& tv,
                const CUtensorMap& tq, const CUtensorMap& tdo, int G,
                float scale_log2, cudaStream_t stream) {
  using namespace tc;
  if constexpr (HD == 256) {
    constexpr int KN = DkvHd256::KN;
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkdv_hd256<WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        DkvHd256::SMEM);
    if (e != cudaSuccess) return (int)e;
    e = check_regs(fa_bwd_dkdv_hd256<WIN>, kBlock, kProducerRegs,
                   kConsumerRegs);
    if (e != cudaSuccess) return (int)e;
    const long long nkv =
        (long long)(a.T + KN - 1) / KN * a.Hkv * a.B * a.split;
    const long long pairs = (long long)a.B * a.Hkv * a.T * HD / 2;
    if (nkv > 0x7fffffffLL || (pairs + 255) / 256 > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    fa_bwd_dkdv_hd256<WIN><<<(unsigned)nkv, kBlock, DkvHd256::SMEM,
                             stream>>>(
        tk, tv, tq, tdo, a.lse, a.D, (bf16*)a.dk, (bf16*)a.dv, a.dks, a.dvs,
        a.B, a.Hkv, G, a.S, a.T, a.kv_len, a.q_offset, a.causal, a.window,
        a.scale, scale_log2, a.split, a.split > 1 ? a.part : nullptr);
    e = cudaGetLastError();
    if (e != cudaSuccess || a.split == 1) return (int)e;
    fa_bwd_kv_sum<HD><<<(unsigned)((pairs + 255) / 256), 256, 0, stream>>>(
        a.part, (bf16*)a.dk, (bf16*)a.dv, a.dks, a.dvs, a.B, a.Hkv, a.T,
        a.split, a.scale);
    return (int)cudaGetLastError();
  } else {
    constexpr int KN = DkvCfg<HD>::KN;
    if (a.split > 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkdv_wgmma<HD, WIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, DkvCfg<HD>::SMEM);
    if (e != cudaSuccess) return (int)e;
    e = check_regs(fa_bwd_dkdv_wgmma<HD, WIN>, kBlock, kProducerRegs,
                   kConsumerRegs);
    if (e != cudaSuccess) return (int)e;
    const long long nkv = (long long)(a.T + KN - 1) / KN * a.Hkv * a.B;
    if (nkv > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    fa_bwd_dkdv_wgmma<HD, WIN>
        <<<(unsigned)nkv, kBlock, DkvCfg<HD>::SMEM, stream>>>(
        tk, tv, tq, tdo, a.lse, a.D, (bf16*)a.dk, (bf16*)a.dv, a.dks, a.dvs,
        a.B, a.Hkv, G, a.S, a.T, a.kv_len, a.q_offset, a.causal, a.window,
        a.scale, scale_log2);
    return (int)cudaGetLastError();
  }
}

template <int HD, bool WIN>
int launch_tc(const Args& a, cudaStream_t stream) {
  using namespace tc;
  if (!encode_fn()) return (int)cudaErrorSymbolNotFound;
  // boxes: K/V tiles of the dK/dV kernel's KN rows (128, 64 at hd 256) and
  // of the dQ kernel's KT rows (128, 48 at hd 256), 64-row Q/dO tiles
  // (dK/dV), 128-row Q/dO tiles (dQ)
  constexpr int KN = [] {
    if constexpr (HD == 256) return DkvHd256::KN;
    else return DkvCfg<HD>::KN;
  }();
  constexpr int KT = DqCfg<HD>::KT;
  CUtensorMap kkn, vkn, kkt, vkt, q64, do64, q128, do128;
  if (!make_map<HD>(&kkn, a.k, a.T, a.Hkv, a.B, a.ks, KN) ||
      !make_map<HD>(&vkn, a.v, a.T, a.Hkv, a.B, a.vs, KN) ||
      !make_map<HD>(&kkt, a.k, a.T, a.Hkv, a.B, a.ks, KT) ||
      !make_map<HD>(&vkt, a.v, a.T, a.Hkv, a.B, a.vs, KT) ||
      !make_map<HD>(&q64, a.q, a.S, a.Hq, a.B, a.qs, QM) ||
      !make_map<HD>(&do64, a.dO, a.S, a.Hq, a.B, a.dos, QM) ||
      !make_map<HD>(&q128, a.q, a.S, a.Hq, a.B, a.qs, QB) ||
      !make_map<HD>(&do128, a.dO, a.S, a.Hq, a.B, a.dos, QB))
    return (int)cudaErrorInvalidValue;
  const int G = a.Hq / a.Hkv;
  const float scale_log2 = (float)((double)a.scale * 1.4426950408889634);
  const long long nq = (long long)(a.S + QB - 1) / QB * a.Hq * a.B;
  if (nq > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  int err = launch_dkdv<HD, WIN>(a, kkn, vkn, q64, do64, G, scale_log2,
                                 stream);
  if (err) return err;

  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq_wgmma<HD, WIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DqCfg<HD>::SMEM);
  if (e != cudaSuccess) return (int)e;
  e = check_regs(fa_bwd_dq_wgmma<HD, WIN>, kBlock, kProducerRegs,
                 kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dq_wgmma<HD, WIN>
      <<<(unsigned)nq, kBlock, DqCfg<HD>::SMEM, stream>>>(
      q128, do128, kkt, vkt, a.lse, a.D, (bf16*)a.dq, a.dqs, a.B, a.Hq, G,
      a.S, a.kv_len, a.q_offset, a.causal, a.window, a.scale, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.Hq * a.S;
  const long long dot_blocks = (rows * 32 + 255) / 256;
  if (dot_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fa_bwd_dot<T><<<(unsigned)dot_blocks, 256, 0, stream>>>(
      (const T*)a.o, (const T*)a.dO, a.D, a.Hq, a.S, HD, rows, a.os, a.dos);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if constexpr (sizeof(T) == 2) {
    return a.window > 0 ? launch_tc<HD, true>(a, stream)
                        : launch_tc<HD, false>(a, stream);
  } else {                    // float32 on the CUDA cores
    const int G = a.Hq / a.Hkv;
    e = cudaFuncSetAttribute(fa_bwd_dkdv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SmemDKV<HD>::bytes);
    if (e != cudaSuccess) return (int)e;
    constexpr int BT = Simt<HD>::BT;
    const dim3 gkv((a.T + BT - 1) / BT, a.Hkv, a.B);
    fa_bwd_dkdv<HD><<<gkv, kThreads, SmemDKV<HD>::bytes, stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dO, a.lse, a.D, (float*)a.dk, (float*)a.dv, G, a.S,
        a.T, a.kv_len, a.q_offset, a.causal, a.window, a.scale, a.qs, a.ks,
        a.vs, a.dos, a.dks, a.dvs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    e = cudaFuncSetAttribute(fa_bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SmemDQ<HD>::bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 gq((a.S + BT - 1) / BT, a.Hq, a.B);
    fa_bwd_dq<HD><<<gq, kThreads, SmemDQ<HD>::bytes, stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dO, a.lse, a.D, (float*)a.dq, G, a.S, a.T, a.kv_len,
        a.q_offset, a.causal, a.window, a.scale, a.qs, a.ks, a.vs, a.dos,
        a.dqs);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, T>(a, stream);
    case 64: return launch<64, T>(a, stream);
    case 128: return launch<128, T>(a, stream);
    case 256: return launch<256, T>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, S, hd), k/v (B, Hkv, T, hd), o and dO (B, Hq, S, hd), dq (B,
// Hq, S, hd), dk/dv (B, Hkv, T, hd): each addressed by its (batch, head,
// row) element strides with a contiguous last dimension, all of one dtype
// (0: float32, 1: bfloat16). lse is the forward's contiguous float32 (B,
// Hq, S) log-sum-exp; D a float32 (B, Hq, S) scratch this call fills. hd in
// {32, 64, 128, 256}; Hq a multiple of Hkv; 1 <= kv_len <= T; q_offset >=
// 0; window 0 (none) or the sliding window's length, which needs causal.
// split: how many parts the bf16 dK/dV kernel cuts each KV head's G query
// heads into (a divisor of G; 1: none, and float32 takes only 1); part:
// with split > 1, a float32 scratch of 2 * split * B * Hkv * T * hd.
// Three launches on `stream` (D, then dK/dV, then dQ). Returns the first
// CUDA error (cudaSuccess = 0), cudaErrorInvalidValue for a shape the
// kernels do not take.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* D, void* dq, void* dk, void* dv,
    int dtype, int B, int Hq, int Hkv, int S, int T, int hd, int kv_len,
    int q_offset, int causal, int window, float scale, int split,
    void* part, const long long* strides, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || T <= 0 ||
      kv_len <= 0 || kv_len > T || q_offset < 0 || B > 65535 ||
      Hq > 65535 || window < 0 || (window > 0 && !causal) || split < 1 ||
      (Hq / Hkv) % split || (split > 1 && (part == nullptr || dtype != 1)))
    return (int)cudaErrorInvalidValue;
  const long long* sd = strides;        // 8 tensors x (batch, head, row)
  Args a{q, k, v, o, dO, (const float*)lse, (float*)D, dq, dk, dv,
         B, Hq, Hkv, S, T, kv_len, q_offset, causal, window, scale,
         split, (float*)part,
         {sd[0], sd[1], sd[2]}, {sd[3], sd[4], sd[5]},
         {sd[6], sd[7], sd[8]}, {sd[9], sd[10], sd[11]},
         {sd[12], sd[13], sd[14]}, {sd[15], sd[16], sd[17]},
         {sd[18], sd[19], sd[20]}, {sd[21], sd[22], sd[23]}};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hd<float>(hd, a, s);
  if (dtype == 1) {
    // TMA reads every bf16 row: 16-byte aligned bases and strides
    for (const void* p : {q, k, v, o, dO, (const void*)dq, (const void*)dk,
                          (const void*)dv})
      if (reinterpret_cast<uintptr_t>(p) % 16)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < 24; ++i)
      if (sd[i] % 8) return (int)cudaErrorInvalidValue;
    return dispatch_hd<__nv_bfloat16>(hd, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
