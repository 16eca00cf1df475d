// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of the
// causal or full, grouped-query attention that flash_attention.cu computes,
// by the standard recompute: P is rebuilt tile by tile from the scores and
// the forward's per-row log-sum-exp, never stored whole.
//
// Replaces: src/repro/kernels/flash_attention/ops.py `_bwd`, which has no
// Pallas kernel there: it is `jax.vjp` of the XLA `attention_ref`. Its
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
// Three kernels a call, on one stream, with no atomics: D = rowsum(dO o O)
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
// bfloat16 (`fa_bwd_dkdv_wgmma`, `fa_bwd_dq_wgmma`): both kernels have the
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
// float32 (`fa_bwd_dkdv`, `fa_bwd_dq`): 256-thread blocks of 64 rows on
// the CUDA cores, S and dP as 4x4 micro-tiles from shared memory, P and dS
// through shared memory, exact to the float32 equations up to summation
// order. Masking is the forward's: keys at or past kv_len and, when
// causal, keys after q_offset + row are dead, and their P is set to
// exactly 0. Tiles wholly in the causal future are skipped. Inputs and
// outputs are read and written through their (batch, head, row) strides,
// so the model's (B, S, H, hd) layout needs no copy.
#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256;

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

// Load a (64 x HD) row tile into shared memory transposed, X[d][row] with a
// row pitch of 65 floats; rows at or past `n` read as 0.
template <int HD>
__device__ __forceinline__ void load_t(float* X, const float* base,
                                       long long rs, int r0, int n) {
  for (int i = threadIdx.x; i < 64 * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    X[d * 65 + r] = r0 + r < n ? base[(long long)(r0 + r) * rs + d] : 0.0f;
  }
}

// s[a][c] = sum_d A[d][ty + 16a] B[d][tx + 16c]: a 4x4 micro-tile of a
// 64 x 64 product of two transposed tiles, summed in d order.
template <int HD>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* Bm, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[d * 65 + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = Bm[d * 65 + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = fmaf(x[a], y[c], s[a][c]);
  }
}

// P and dS of one (query tile q0, key tile k0) pair at the thread's
// micro-tile (rows ty + 16a, keys tx + 16c), from the raw scores s and
// dP = dO V^T; dead pairs get P = dS = 0.
__device__ __forceinline__ void p_and_ds(float (&s)[4][4], float (&dp)[4][4],
                                         const float* lse_s, const float* D_s,
                                         int q0, int k0, int S, int kv_len,
                                         int q_offset, int causal,
                                         float scale, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
    const long long qpos = (long long)q_offset + q0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kpos = k0 + tx + 16 * c;
      bool live = q0 + r < S && kpos < kv_len;
      if (causal) live = live && (long long)kpos <= qpos;
      const float p = live ? expf(s[a][c] * scale - lse_s[r]) : 0.0f;
      s[a][c] = p;
      dp[a][c] = p * (dp[a][c] - D_s[r]);
    }
  }
}

template <int HD>
struct SmemDKV {  // in floats
  static constexpr int TILE = HD * 65;
  static constexpr size_t bytes =
      sizeof(float) * (4 * TILE + 2 * 64 * 65 + 128);
};

template <int HD>
struct SmemDQ {
  static constexpr int TILE = HD * 65;
  static constexpr size_t bytes =
      sizeof(float) * (4 * TILE + 64 * 65 + 128);
};

// ------------------------------------------------------------------ dK, dV

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ D,
            float* __restrict__ dk, float* __restrict__ dv, int G, int S,
            int Tk, int kv_len, int q_offset, int causal, float scale,
            Strides qs, Strides ks, Strides vs, Strides dos, Strides dks,
            Strides dvs) {
  constexpr int OJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                       // Qs[d][row]
  float* Os = Qs + SmemDKV<HD>::TILE;     // dOs[d][row]
  float* Ks = Os + SmemDKV<HD>::TILE;     // Ks[d][key]
  float* Vs = Ks + SmemDKV<HD>::TILE;     // Vs[d][key]
  float* Ps = Vs + SmemDKV<HD>::TILE;     // Ps[row][key]
  float* dSs = Ps + 64 * 65;              // dSs[row][key]
  float* lse_s = dSs + 64 * 65;
  float* D_s = lse_s + 64;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y * G;

  load_t<HD>(Ks, k + b * ks.b + hk * ks.h, ks.s, k0, Tk);
  load_t<HD>(Vs, v + b * vs.b + hk * vs.h, vs.s, k0, Tk);

  float acc_k[4][OJ], acc_v[4][OJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < OJ; ++c) acc_k[a][c] = acc_v[a][c] = 0.0f;

  // the first query row that sees key k0, and so the first query tile
  int qt0 = 0;
  if (causal) {
    const long long first = (long long)k0 - q_offset;
    qt0 = first <= 0 ? 0 : (int)((first < S ? first : S) / BQ);
  }
  const int nq = (S + BQ - 1) / BQ;
  const bool dead = k0 >= kv_len;

  for (int g = 0; g < G && !dead; ++g) {
    const int h = hk * G + g;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* ob = dO + b * dos.b + h * dos.h;
    const float* lrow = lse + ((long long)b * Hq + h) * S;
    const float* drow = D + ((long long)b * Hq + h) * S;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();                  // the previous tile is consumed
      load_t<HD>(Qs, qb, qs.s, q0, S);
      load_t<HD>(Os, ob, dos.s, q0, S);
      if (tid < 64) {
        lse_s[tid] = q0 + tid < S ? lrow[q0 + tid] : 0.0f;
        D_s[tid] = q0 + tid < S ? drow[q0 + tid] : 0.0f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      tile_dot<HD>(s, Qs, Ks, ty, tx);
      tile_dot<HD>(dp, Os, Vs, ty, tx);
      p_and_ds(s, dp, lse_s, D_s, q0, k0, S, kv_len, q_offset, causal,
               scale, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Ps[(ty + 16 * a) * 65 + tx + 16 * c] = s[a][c];
          dSs[(ty + 16 * a) * 65 + tx + 16 * c] = dp[a][c];
        }
      __syncthreads();

      // dV[key][d] += sum_r P[r][key] dO[r][d]; dK likewise with dS and Q
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float p[4], ds[4], o[OJ], x[OJ];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          p[a] = Ps[r * 65 + ty + 16 * a];
          ds[a] = dSs[r * 65 + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < OJ; ++c) {
          o[c] = Os[(tx + 16 * c) * 65 + r];
          x[c] = Qs[(tx + 16 * c) * 65 + r];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
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
  for (int a = 0; a < 4; ++a) {
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
          int q_offset, int causal, float scale, Strides qs, Strides ks,
          Strides vs, Strides dos, Strides dqs) {
  constexpr int OJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + SmemDQ<HD>::TILE;
  float* Ks = Os + SmemDQ<HD>::TILE;
  float* Vs = Ks + SmemDQ<HD>::TILE;
  float* dSs = Vs + SmemDQ<HD>::TILE;     // dSs[row][key]
  float* lse_s = dSs + 64 * 65;
  float* D_s = lse_s + 64;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, Hq = gridDim.y;
  const int hk = h / G;

  load_t<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_t<HD>(Os, dO + b * dos.b + h * dos.h, dos.s, q0, S);
  if (tid < 64) {
    const long long row = ((long long)b * Hq + h) * S + q0 + tid;
    lse_s[tid] = q0 + tid < S ? lse[row] : 0.0f;
    D_s[tid] = q0 + tid < S ? D[row] : 0.0f;
  }

  float acc[4][OJ];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < OJ; ++c) acc[a][c] = 0.0f;

  // key tiles holding a key below kv_len and, when causal, one no later
  // than the tile's last query
  int nk = (kv_len + BK - 1) / BK;
  if (causal) {
    const long long last = (long long)q_offset + q0 + BQ - 1;
    const long long lim = last < 0 ? 0 : last / BK + 1;
    if (lim < nk) nk = (int)lim;
  }
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                    // the previous tile is consumed
    load_t<HD>(Ks, kb, ks.s, k0, Tk);
    load_t<HD>(Vs, vb, vs.s, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<HD>(s, Qs, Ks, ty, tx);
    tile_dot<HD>(dp, Os, Vs, ty, tx);
    p_and_ds(s, dp, lse_s, D_s, q0, k0, S, kv_len, q_offset, causal, scale,
             ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dSs[(ty + 16 * a) * 65 + tx + 16 * c] = dp[a][c];
    __syncthreads();

    // dQ[r][d] += sum_j dS[r][j] K[j][d]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float ds[4], x[OJ];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = dSs[(ty + 16 * a) * 65 + j];
#pragma unroll
      for (int c = 0; c < OJ; ++c) x[c] = Ks[(tx + 16 * c) * 65 + j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < OJ; ++c) acc[a][c] = fmaf(ds[a], x[c], acc[a][c]);
    }
  }

  float* qb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
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

// ------------------------------------------------ dK, dV: 128 keys a block

constexpr int KN = 128;              // keys per block, 64 per consumer
constexpr int QM = 64;               // queries per tile of the ring

template <int HD>
struct DkvCfg : Atom<HD> {
  static constexpr int STAGES = 3;               // the Q/dO ring
  static constexpr int KV_BYTES = KN * HD * 2;   // K or V, [NA][KN][AC]
  static constexpr int QT_BYTES = QM * HD * 2;   // Q or dO, [NA][QM][AC]
  static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGES * QT_BYTES +
                              2 * STAGES * QM * 4 + 1024 + 64;
};

// One block per (128-key tile, kv head, batch). The producer loads the
// block's K and V tiles once, then, for each query head of the group and
// each query tile from the causal limit on, Q and dO (TMA) and the rows'
// log2-scaled log-sum-exp and D (ordinary loads by warp 0's lanes: the
// float32 (B, Hq, S) rows are 16-byte aligned only when S is a multiple
// of 4) into a ring of STAGES stages. Each consumer warpgroup owns 64
// keys: S^T = K Q^T and dP^T = V dO^T (SS wgmma), P^T and dS^T in
// registers, dV += P^T dO and dK += dS^T Q (RS wgmma, dO and Q MN-major).
template <int HD>
__global__ void __launch_bounds__(kBlock, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  bf16* __restrict__ dk, bf16* __restrict__ dv, Strides dks,
                  Strides dvs, int B, int Hkv, int G, int S, int T, int kv_len,
                  int q_offset, int causal, float scale, float scale_log2) {
  using C = DkvCfg<HD>;
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
  const int k0 = (blockIdx.x / (Hkv * B)) * KN;
  const int Hq = Hkv * G;
  int qt0 = 0;                       // the first query tile that sees k0
  if (causal) {
    const long long first = (long long)k0 - q_offset;
    qt0 = first <= 0 ? 0 : (int)((first < S ? first : S) / QM);
  }
  const int nqt = k0 < kv_len ? (S + QM - 1) / QM - qt0 : 0;
  const int n_it = G * nqt;

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
    if (threadIdx.x < 32) {
      if (lane == 0 && n_it > 0) {
        bar_expect_tx(kv_full, 2 * C::KV_BYTES);
        tma_tile<HD>(sK, &tk, KN, k0, hk, b, kv_full);
        tma_tile<HD>(sV, &tv, KN, k0, hk, b, kv_full);
      }
      for (int j = 0; j < n_it; ++j) {
        const int s = j % C::STAGES;
        if (j >= C::STAGES) bar_wait(empty + s, (j / C::STAGES - 1) & 1);
        const int g = j / nqt, q0 = (qt0 + j - g * nqt) * QM;
        const int h = hk * G + g;
        const long long row = ((long long)b * Hq + h) * S + q0;
#pragma unroll
        for (int r = lane; r < QM; r += 32) {
          const bool in = q0 + r < S;
          sL[s * QM + r] = in ? lse[row + r] * kLog2e : 0.0f;
          sD[s * QM + r] = in ? D[row + r] : 0.0f;
        }
        if (lane == 0) {
          bar_expect_tx(full + s, 2 * C::QT_BYTES);
          tma_tile<HD>(sQ + s * C::QT_BYTES, &tq, QM, q0, h, b, full + s);
          tma_tile<HD>(sO + s * C::QT_BYTES, &tdo, QM, q0, h, b, full + s);
        } else {
          bar_arrive(full + s);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     kConsumerRegs));
    const int w = wg - 1;                          // keys 64w .. 64w + 63
    const int warp = (threadIdx.x / 32) % 4;
    const int kw0 = k0 + 64 * w;
    const int key_lo = kw0 + 16 * warp + lane / 4;   // and key_lo + 8
    const int cq = 2 * (lane % 4);
    const uint32_t k_addr = smem_u32(sK) + w * 64 * C::ATOM_B;
    const uint32_t v_addr = smem_u32(sV) + w * 64 * C::ATOM_B;

    float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;

    if (n_it > 0) bar_wait(kv_full, 0);
    for (int j = 0; j < n_it; ++j) {
      const int s = j % C::STAGES, ph = (j / C::STAGES) & 1;
      const int g = j / nqt, q0 = (qt0 + j - g * nqt) * QM;
      bar_wait(full + s, ph);
      // keys all padded, or all after every query of the tile: P^T = 0
      const bool idle = kw0 >= kv_len ||
                        (causal && (long long)kw0 >
                                       (long long)q_offset + q0 + QM - 1);
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
                                           (long long)q_offset + q0);
#pragma unroll
        for (int i = 0; i < QM / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * i + cq + e;
            const float l2 = lrow[col];
            float p_lo = exp2f(st[4 * i + e] * scale_log2 - l2);
            float p_hi = exp2f(st[4 * i + 2 + e] * scale_log2 - l2);
            if (masked) {
              const long long qpos = (long long)q_offset + q0 + col;
              const bool q_in = q0 + col < S;
              if (!q_in || key_lo >= kv_len || (causal && key_lo > qpos))
                p_lo = 0.0f;
              if (!q_in || key_lo + 8 >= kv_len ||
                  (causal && key_lo + 8 > qpos))
                p_hi = 0.0f;
            }
            st[4 * i + e] = p_lo;
            st[4 * i + 2 + e] = p_hi;
          }
        }

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

// ----------------------------------------------- dQ: 128 queries a block

constexpr int QB = 128;              // queries per block, 64 per consumer
constexpr int KT = 128;              // keys per tile of the ring

template <int HD>
struct DqCfg : Atom<HD> {
  static constexpr int STAGES = 2;               // the K/V ring
  static constexpr int Q_BYTES = QB * HD * 2;    // Q or dO, [NA][QB][AC]
  static constexpr int KV_BYTES = KT * HD * 2;   // K or V, [NA][KT][AC]
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024 +
                              64;
};

// One block per (128 query rows, q head, batch), shaped like the forward:
// the producer loads Q and dO once and streams the K and V tiles up to
// the causal limit through the ring; each consumer warpgroup owns 64
// rows: S = Q K^T and dP = dO V^T (SS wgmma), dS in registers, dQ += dS K
// (RS wgmma, K MN-major). dQ is scaled and rounded to bf16 once, at the
// end.
template <int HD>
__global__ void __launch_bounds__(kBlock, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const float* __restrict__ lse, const float* __restrict__ D,
                bf16* __restrict__ dq, Strides dqs, int B, int Hq, int G, int S,
                int kv_len, int q_offset, int causal, float scale,
                float scale_log2) {
  using C = DqCfg<HD>;
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
  int nk = (kv_len + KT - 1) / KT;
  if (causal) {
    const long long lim = ((long long)q_offset + q0 + QB - 1) / KT + 1;
    if (lim < nk) nk = (int)lim;
  }

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
        const int s = j % C::STAGES;
        if (j >= C::STAGES) bar_wait(empty + s, (j / C::STAGES - 1) & 1);
        bar_expect_tx(full + s, 2 * C::KV_BYTES);
        tma_tile<HD>(sK + s * C::KV_BYTES, &tk, KT, j * KT, hk, b, full + s);
        tma_tile<HD>(sV + s * C::KV_BYTES, &tv, KT, j * KT, hk, b, full + s);
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
      const int k0 = j * KT;
      bar_wait(full + s, ph);
      // every key of the tile after every row of this warpgroup: P = 0
      const bool idle = causal && (long long)k0 > first_pos + 63;
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
                            (causal && (long long)k0 + KT - 1 > first_pos);
#pragma unroll
        for (int i = 0; i < KT / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float p_lo = exp2f(sacc[4 * i + e] * scale_log2 - l2_lo);
            float p_hi = exp2f(sacc[4 * i + 2 + e] * scale_log2 - l2_hi);
            if (masked) {
              const int kpos = k0 + 8 * i + cq + e;
              const bool pad = kpos >= kv_len;
              if (pad || (causal && kpos > pos_lo)) p_lo = 0.0f;
              if (pad || (causal && kpos > pos_lo + 8)) p_hi = 0.0f;
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
  int B, Hq, Hkv, S, T, kv_len, q_offset, causal;
  float scale;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
};

template <int HD>
int launch_tc(const Args& a, cudaStream_t stream) {
  using namespace tc;
  if (!encode_fn()) return (int)cudaErrorSymbolNotFound;
  // boxes: 128-row K/V tiles (both kernels), 64-row Q/dO tiles (dK/dV),
  // 128-row Q/dO tiles (dQ)
  static_assert(KT == KN, "both kernels read K and V in boxes of KN rows");
  CUtensorMap k128, v128, q64, do64, q128, do128;
  if (!make_map<HD>(&k128, a.k, a.T, a.Hkv, a.B, a.ks, KN) ||
      !make_map<HD>(&v128, a.v, a.T, a.Hkv, a.B, a.vs, KN) ||
      !make_map<HD>(&q64, a.q, a.S, a.Hq, a.B, a.qs, QM) ||
      !make_map<HD>(&do64, a.dO, a.S, a.Hq, a.B, a.dos, QM) ||
      !make_map<HD>(&q128, a.q, a.S, a.Hq, a.B, a.qs, QB) ||
      !make_map<HD>(&do128, a.dO, a.S, a.Hq, a.B, a.dos, QB))
    return (int)cudaErrorInvalidValue;
  const int G = a.Hq / a.Hkv;
  const float scale_log2 = (float)((double)a.scale * 1.4426950408889634);

  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkdv_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DkvCfg<HD>::SMEM);
  if (e != cudaSuccess) return (int)e;
  e = check_regs(fa_bwd_dkdv_wgmma<HD>, kBlock, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  const long long nkv = (long long)(a.T + KN - 1) / KN * a.Hkv * a.B;
  const long long nq = (long long)(a.S + QB - 1) / QB * a.Hq * a.B;
  if (nkv > 0x7fffffffLL || nq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  fa_bwd_dkdv_wgmma<HD><<<(unsigned)nkv, kBlock, DkvCfg<HD>::SMEM, stream>>>(
      k128, v128, q64, do64, a.lse, a.D, (bf16*)a.dk, (bf16*)a.dv, a.dks,
      a.dvs, a.B, a.Hkv, G, a.S, a.T, a.kv_len, a.q_offset, a.causal,
      a.scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  e = cudaFuncSetAttribute(fa_bwd_dq_wgmma<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DqCfg<HD>::SMEM);
  if (e != cudaSuccess) return (int)e;
  e = check_regs(fa_bwd_dq_wgmma<HD>, kBlock, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dq_wgmma<HD><<<(unsigned)nq, kBlock, DqCfg<HD>::SMEM, stream>>>(
      q128, do128, k128, v128, a.lse, a.D, (bf16*)a.dq, a.dqs, a.B, a.Hq, G,
      a.S, a.kv_len, a.q_offset, a.causal, a.scale, scale_log2);
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
    return launch_tc<HD>(a, stream);
  } else {                    // float32 on the CUDA cores
    const int G = a.Hq / a.Hkv;
    e = cudaFuncSetAttribute(fa_bwd_dkdv<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SmemDKV<HD>::bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 gkv((a.T + BK - 1) / BK, a.Hkv, a.B);
    fa_bwd_dkdv<HD><<<gkv, kThreads, SmemDKV<HD>::bytes, stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dO, a.lse, a.D, (float*)a.dk, (float*)a.dv, G, a.S,
        a.T, a.kv_len, a.q_offset, a.causal, a.scale, a.qs, a.ks, a.vs,
        a.dos, a.dks, a.dvs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    e = cudaFuncSetAttribute(fa_bwd_dq<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SmemDQ<HD>::bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 gq((a.S + BQ - 1) / BQ, a.Hq, a.B);
    fa_bwd_dq<HD><<<gq, kThreads, SmemDQ<HD>::bytes, stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.dO, a.lse, a.D, (float*)a.dq, G, a.S, a.T, a.kv_len,
        a.q_offset, a.causal, a.scale, a.qs, a.ks, a.vs, a.dos, a.dqs);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, T>(a, stream);
    case 64: return launch<64, T>(a, stream);
    case 128: return launch<128, T>(a, stream);
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
// {32, 64, 128}; Hq a multiple of Hkv; 1 <= kv_len <= T; q_offset >= 0.
// Three launches on `stream` (D, then dK/dV, then dQ). Returns the first
// CUDA error (cudaSuccess = 0), cudaErrorInvalidValue for a shape the
// kernels do not take.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* D, void* dq, void* dk, void* dv,
    int dtype, int B, int Hq, int Hkv, int S, int T, int hd, int kv_len,
    int q_offset, int causal, float scale, const long long* strides,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || T <= 0 ||
      kv_len <= 0 || kv_len > T || q_offset < 0 || B > 65535 ||
      Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* sd = strides;        // 8 tensors x (batch, head, row)
  Args a{q, k, v, o, dO, (const float*)lse, (float*)D, dq, dk, dv,
         B, Hq, Hkv, S, T, kv_len, q_offset, causal, scale,
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
