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
// Three kernels a call: D = rowsum(dO o O) (`fa_bwd_dot`, one warp per
// row), then one block per (64-key tile, kv head, batch) for dK and dV,
// which keeps its K and V tile in shared memory and its dK and dV tiles
// in registers and walks every query head of its group and, for each, the
// query tiles from the causal limit on (S and dP of the pair, P and dS,
// then dV += P^T dO and dK += dS^T Q); then one block per (64-query tile,
// q head, batch) for dQ, walking the key tiles up to the causal limit (S
// and dP again, dS, dQ += dS K). S and dP are computed twice: seven
// products in all instead of five, the price of having no atomics. Every
// sum runs in float32 in one fixed order, so two calls are bit-equal.
//
// bfloat16 (`fa_bwd_dkdv_tc`, `fa_bwd_dq_tc`): 128-thread blocks on the
// tensor cores with `mma.sync` m16n8k16 (bf16 in, fp32 accumulate); each
// warp owns 16 rows of the block's 64 (keys for dK/dV, queries for dQ).
// The dK/dV kernel computes S^T = K Q^T and dP^T = V dO^T, so that P^T
// and dS^T leave the accumulators as the A operands of the next products
// without a trip through shared memory (the accumulator layout of two
// n8 tiles is the A layout of one k16 step); Q and dO serve as B operands
// of those products through `ldmatrix.trans`, as K does for dQ += dS K.
// P and dS are rounded to bf16 before their products, as the forward
// rounds P before P.V; the plain version keeps them in float32 (the
// stated tolerance in chip_smoke.py covers the difference). Tiles are
// staged with 16-byte loads into rows padded by 16 bytes, so the
// fragment loads and ldmatrix phases are free of bank conflicts; the
// wrapper raises on bf16 rows that are not 16-byte aligned.
//
// float32 (`fa_bwd_dkdv`, `fa_bwd_dq`): 256-thread blocks on the CUDA
// cores, S and dP as 4x4 micro-tiles from shared memory, P and dS through
// shared memory, exact to the float32 equations up to summation order.
// Masking is the forward's: keys at or past kv_len and, when causal, keys
// after q_offset + row are dead, and their P is set to exactly 0. Tiles
// wholly in the causal future are skipped; the longest blocks are issued
// first. Inputs and outputs are read and written through their (batch,
// head, row) strides, so the model's (B, S, H, hd) layout needs no copy.
// The tensor-core redesign (wgmma, TMA) is a later step; this one is
// right first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256;

struct Strides {
  long long b, h, s;
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

using bf16 = __nv_bfloat16;
constexpr int BT = 64;               // rows of a key or query tile
constexpr int kThreadsTC = 128;      // four warps of 16 rows each

template <int HD>
struct Tiles {
  static constexpr int P = HD + 8;   // row pitch in bf16: 16 bytes of pad
  static constexpr int TILE = BT * P;
  static constexpr size_t bytes = 4 * TILE * sizeof(bf16) +
                                  2 * BT * sizeof(float);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16 x 8, fp32) += A (16 x 16, bf16 row-major) . B (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed on the way in: the B fragments of
// two n8 tiles of a k16 step from a row-major (k, n) tile in shared memory.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// A (64 x HD) row tile into shared memory with 16-byte loads; rows at or
// past `n` read as 0.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* X, const bf16* base,
                                          long long rs, int r0, int n) {
  constexpr int CH = HD / 8, P = Tiles<HD>::P;
  for (int i = threadIdx.x; i < BT * CH; i += kThreadsTC) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(base + (long long)(r0 + r) * rs +
                                            c * 8);
    *reinterpret_cast<uint4*>(X + r * P + c * 8) = val;
  }
}

// The A fragment of one k16 step (columns 16ks..) of rows r and r + 8 of
// a row-major tile.
template <int P>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* X,
                                       int r, int ks, int tig) {
  const bf16* p = X + r * P + ks * 16 + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * P);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * P + 8);
}

// acc[nt] += A . B over HD for 8 n8 tiles, B^T rows (n) of tile Bt: the
// 16 x 64 product of a warp's rows with a tile's 64 rows.
template <int HD>
__device__ __forceinline__ void rows_dot(float (&acc)[8][4], const bf16* A,
                                         const bf16* Bt, int r, int g,
                                         int tig) {
  constexpr int P = Tiles<HD>::P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nt][c] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t a[4];
    a_frag<P>(a, A, r, ks, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* bp = Bt + (nt * 8 + g) * P + ks * 16 + 2 * tig;
      mma(acc[nt], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[n] += A (16 x 64, four k16 A fragments) . Xt (64 x HD, a row-major
// tile read through ldmatrix.trans).
template <int HD>
__device__ __forceinline__ void frag_times_tile(float (&acc)[HD / 8][4],
                                                const uint32_t (&a)[4][4],
                                                const bf16* X, int lane) {
  constexpr int P = Tiles<HD>::P;
  const int row = (lane % 8) + 8 * ((lane / 8) & 1), col = 8 * (lane / 16);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, X + (16 * j + row) * P + 16 * np + col);
      mma(acc[2 * np], a[j], b[0], b[1]);
      mma(acc[2 * np + 1], a[j], b[2], b[3]);
    }
}

// The accumulators of 8 n8 tiles (16 rows x 64 columns) as the bf16 A
// fragments of four k16 steps.
__device__ __forceinline__ void to_frags(uint32_t (&a)[4][4],
                                         const float (&c)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack(c[2 * j][0], c[2 * j][1]);
    a[j][1] = pack(c[2 * j][2], c[2 * j][3]);
    a[j][2] = pack(c[2 * j + 1][0], c[2 * j + 1][1]);
    a[j][3] = pack(c[2 * j + 1][2], c[2 * j + 1][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTC)
fa_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dO,
               const float* __restrict__ lse, const float* __restrict__ D,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int G, int S,
               int Tk, int kv_len, int q_offset, int causal, float scale,
               float scale_log2, Strides qs, Strides ks, Strides vs,
               Strides dos, Strides dks, Strides dvs) {
  constexpr int NT = HD / 8, P = Tiles<HD>::P;
  extern __shared__ __align__(16) uint8_t raw[];
  bf16* sK = reinterpret_cast<bf16*>(raw);
  bf16* sV = sK + Tiles<HD>::TILE;
  bf16* sQ = sV + Tiles<HD>::TILE;
  bf16* sO = sQ + Tiles<HD>::TILE;
  float* sL = reinterpret_cast<float*>(sO + Tiles<HD>::TILE);
  float* sD = sL + BT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4, kr = warp * 16 + g;
  const int k0 = blockIdx.x * BT, hk = blockIdx.y, b = blockIdx.z;
  const int Hq = gridDim.y * G;

  load_tile<HD>(sK, k + b * ks.b + hk * ks.h, ks.s, k0, Tk);
  load_tile<HD>(sV, v + b * vs.b + hk * vs.h, vs.s, k0, Tk);

  float acc_k[NT][4], acc_v[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_k[n][c] = acc_v[n][c] = 0.0f;

  int qt0 = 0;
  if (causal) {
    const long long first = (long long)k0 - q_offset;
    qt0 = first <= 0 ? 0 : (int)((first < S ? first : S) / BT);
  }
  const int nq = (S + BT - 1) / BT;
  const bool dead = k0 >= kv_len;

  for (int gi = 0; gi < G && !dead; ++gi) {
    const int h = hk * G + gi;
    const bf16* qb = q + b * qs.b + h * qs.h;
    const bf16* ob = dO + b * dos.b + h * dos.h;
    const float* lrow = lse + ((long long)b * Hq + h) * S;
    const float* drow = D + ((long long)b * Hq + h) * S;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();                  // the previous tile is consumed
      load_tile<HD>(sQ, qb, qs.s, q0, S);
      load_tile<HD>(sO, ob, dos.s, q0, S);
      if (tid < BT) {
        const bool in = q0 + tid < S;
        sL[tid] = in ? lrow[q0 + tid] * 1.4426950408889634f : 0.0f;
        sD[tid] = in ? drow[q0 + tid] : 0.0f;
      }
      __syncthreads();

      // P^T: the warp's 16 keys x the tile's 64 queries
      float st[8][4];
      rows_dot<HD>(st, sK, sQ, kr, g, tig);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + kr + 8 * (c >> 1);
          const int ql = nt * 8 + 2 * tig + (c & 1);
          bool live = q0 + ql < S && key < kv_len;
          if (causal) live = live && (long long)key <=
                                         (long long)q_offset + q0 + ql;
          st[nt][c] = live ? exp2f(st[nt][c] * scale_log2 - sL[ql]) : 0.0f;
        }
      uint32_t fa[4][4];
      to_frags(fa, st);
      frag_times_tile<HD>(acc_v, fa, sO, lane);   // dV += P^T dO
      // dS^T = P^T o (dP^T - D), dP^T = V dO^T; then dK += dS^T Q
      float dpt[8][4];
      rows_dot<HD>(dpt, sV, sO, kr, g, tig);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dpt[nt][c] = st[nt][c] * (dpt[nt][c] - sD[nt * 8 + 2 * tig +
                                                    (c & 1)]);
      to_frags(fa, dpt);
      frag_times_tile<HD>(acc_k, fa, sQ, lane);
    }
  }

  bf16* kb = dk + b * dks.b + hk * dks.h;
  bf16* vb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + kr + 8 * hh;
    if (key >= Tk) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(kb + (long long)key * dks.s + col) =
          __floats2bfloat162_rn(acc_k[n][2 * hh] * scale,
                                acc_k[n][2 * hh + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vb + (long long)key * dvs.s + col) =
          __floats2bfloat162_rn(acc_v[n][2 * hh], acc_v[n][2 * hh + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTC)
fa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ D,
             bf16* __restrict__ dq, int G, int S, int Tk, int kv_len,
             int q_offset, int causal, float scale, float scale_log2,
             Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs) {
  constexpr int NT = HD / 8;
  extern __shared__ __align__(16) uint8_t raw[];
  bf16* sQ = reinterpret_cast<bf16*>(raw);
  bf16* sO = sQ + Tiles<HD>::TILE;
  bf16* sK = sO + Tiles<HD>::TILE;
  bf16* sV = sK + Tiles<HD>::TILE;
  float* sL = reinterpret_cast<float*>(sV + Tiles<HD>::TILE);
  float* sD = sL + BT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4, qr = warp * 16 + g;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;    // longest first
  const int h = blockIdx.y, b = blockIdx.z, Hq = gridDim.y, hk = h / G;

  load_tile<HD>(sQ, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<HD>(sO, dO + b * dos.b + h * dos.h, dos.s, q0, S);
  if (tid < BT) {
    const bool in = q0 + tid < S;
    const long long row = ((long long)b * Hq + h) * S + q0 + tid;
    sL[tid] = in ? lse[row] * 1.4426950408889634f : 0.0f;
    sD[tid] = in ? D[row] : 0.0f;
  }

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;

  int nk = (kv_len + BT - 1) / BT;
  if (causal) {
    const long long last = (long long)q_offset + q0 + BT - 1;
    const long long lim = last < 0 ? 0 : last / BT + 1;
    if (lim < nk) nk = (int)lim;
  }
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();                    // the previous tile is consumed
    load_tile<HD>(sK, kb, ks.s, k0, Tk);
    load_tile<HD>(sV, vb, vs.s, k0, Tk);
    __syncthreads();

    // S and dP: the warp's 16 queries x the tile's 64 keys
    float s[8][4], dp[8][4];
    rows_dot<HD>(s, sQ, sK, qr, g, tig);
    rows_dot<HD>(dp, sO, sV, qr, g, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int ql = qr + 8 * (c >> 1);
        const int key = k0 + nt * 8 + 2 * tig + (c & 1);
        bool live = q0 + ql < S && key < kv_len;
        if (causal) live = live && (long long)key <=
                                       (long long)q_offset + q0 + ql;
        const float p = live ? exp2f(s[nt][c] * scale_log2 - sL[ql])
                             : 0.0f;
        dp[nt][c] = p * (dp[nt][c] - sD[ql]);
      }
    uint32_t da[4][4];
    to_frags(da, dp);
    frag_times_tile<HD>(acc, da, sK, lane);       // dQ += dS K
  }

  bf16* qo = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + qr + 8 * hh;
    if (row >= S) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(qo + (long long)row * dqs.s + n * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(acc[n][2 * hh] * scale,
                                acc[n][2 * hh + 1] * scale);
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
  using tc::bf16;
  const int G = a.Hq / a.Hkv;
  const float scale_log2 = (float)((double)a.scale * 1.4426950408889634);
  const int smem = (int)tc::Tiles<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      tc::fa_bwd_dkdv_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 gkv((a.T + tc::BT - 1) / tc::BT, a.Hkv, a.B);
  tc::fa_bwd_dkdv_tc<HD><<<gkv, tc::kThreadsTC, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dO, a.lse, a.D, (bf16*)a.dk, (bf16*)a.dv, G, a.S, a.T,
      a.kv_len, a.q_offset, a.causal, a.scale, scale_log2, a.qs, a.ks, a.vs,
      a.dos, a.dks, a.dvs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(tc::fa_bwd_dq_tc<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 gq((a.S + tc::BT - 1) / tc::BT, a.Hq, a.B);
  tc::fa_bwd_dq_tc<HD><<<gq, tc::kThreadsTC, smem, stream>>>(
      (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
      (const bf16*)a.dO, a.lse, a.D, (bf16*)a.dq, G, a.S, a.T, a.kv_len,
      a.q_offset, a.causal, a.scale, scale_log2, a.qs, a.ks, a.vs, a.dos,
      a.dqs);
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
    // 16-byte loads of every bf16 row
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
