// Backward of the chunked RWKV6 (Finch) WKV recurrence for Hopper (sm_90a):
// dr, dk, dv, dlogw, du and ds0 from dy and d(final state), at the chunk C
// of the forward (csrc/wkv6.cu). Per (batch, head) and chunk, with the
// forward's clw = cumsum(logw) (inclusive), ecl = clw - logw, total =
// clw[C-1], E1 = e^clip(ecl), E2 = e^clip(-clw), E3 = e^clip(total - clw),
// E4 = e^clip(total) (clip: +-25), q_ = r E1, k_ = k E2, kd = k E3, the
// chunk-start state S_{c-1} and G, the gradient of the chunk's end state:
//   dA  = strictly_lower(dy v^T)         dq_ = dy S_{c-1}^T + dA k_
//   dk_ = dA^T q_                        dkd = v G^T
//   dv  = A^T dy + diag dy + kd G        ddiag = sum_j dy v
//   dr  = ddiag u k + dq_ E1             dk = ddiag u r + dk_ E2 + dkd E3
//   du += sum_t ddiag r k                G <- E4 G + q_^T dy (next chunk back)
// and dlogw[t] = g4 + sum_{t'<t} g3 + sum_{t'>t} decl - sum_{t'>=t} g2 over
// the chunk's tokens, with decl = dq_ q_, g2 = dk_ k_, g3 = dkd kd, g4 = E4
// sum_j G S_{c-1}, each where its exponent's clamp passes a gradient (zero
// outside +-25, as the reference's clip). ``ref.wkv6_bwd_ref`` is the plain
// version of exactly these equations.
//
// Replaces: no Pallas kernel. The JAX package differentiates
// src/repro/models/rwkv6.py `wkv_chunked` (a `lax.scan` over chunks)
// through XLA; its Pallas forward (`repro/kernels/wkv6`) defines no VJP.
// The port needs a kernel because its forward is K4, a ctypes launch that
// autograd cannot see through.
//
// What bounds it on this card: operations. The call reads r, k, v, logw
// and dy and writes dr, dk, dv and dlogw (at (1, 4096, 64, 64), C = 32,
// bf16 r/k/v: ~405 MB, ~0.12 ms at 3.35 TB/s; the forward's 134 MB of
// chunk-start states that it reads come on top), and does ~8 hd^2 + 5 C hd
// float32 operations a token and head (~11.8 GFLOP there, ~0.18 ms on the
// CUDA cores' 67 TFLOP/s; `wkv6_bwd_flops` and `wkv6_bwd_bytes` in
// kernels/wkv6/wkv6.py count both). This first version is simple and
// right, not fast: every product is a loop of fmaf over shared memory on
// the CUDA cores.
//
// Design: four kernels a call, on one stream, float32 throughout, every
// sum in a fixed order and no atomics, so two calls are bit-equal.
//  1. `wkv6_bwd_state` walks the chunks backwards and writes G of every
//     chunk to a float32 scratch of (B, H, S/C, hd, hd). A block owns a
//     16 x 32 tile of the (hd, hd) gradient, 4 entries a thread, as K4's
//     state pass owns one of the state; it needs only its 16 channels of
//     r and logw (q_ over the chunk, by a sequential cumsum a channel) and
//     its 32 columns of dy. At the end it writes ds0.
//  2. `wkv6_bwd_out` runs one block per 32-token tile of a chunk (any C:
//     a chunk of C > 32 tokens is several tiles), head and batch. It
//     stages its tile; walks the chunk's earlier tiles (their k_ and v:
//     dA k_ into dq_, and the cumsum's carry), then its own (the strictly
//     lower dA and A), then the later ones (their q_ and dy: dk_ and A^T dy
//     into dv, and the chunk's total); adds the S_{c-1} and G terms with
//     S_{c-1} read from K4's scratch (the forward's chunk-start states,
//     not recomputed) and G from pass 1, staged 64 rows at a time; writes
//     dr, dk, dv, the tile's part of dlogw and du, and, for a chunk of
//     several tiles, the tile's sums of g3 and decl - g2.
//  3. `wkv6_bwd_fix` (only for C > 32) adds to each token's dlogw what the
//     chunk's other tiles contribute: g4 + the g3 of earlier tiles + the
//     decl - g2 of later ones.
//  4. `wkv6_bwd_du` sums du over the batch and the tiles, per head.
//
// Alignment: none needed (every load is scalar); the wrapper still
// checks 16-byte aligned bases and strides, the same rule as K4's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kClamp = 25.0f;
constexpr int kT = 32;             // tokens of a tile

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// e^clip(x), as K4 computes it (ex2 of a pre-scaled argument)
__device__ __forceinline__ float clip_exp(float x) {
  return exp2f(fminf(fmaxf(x, -kClamp), kClamp) * 1.4426950408889634f);
}
// 1 where the clamp passes a gradient (autograd's rule for clamp), else 0
__device__ __forceinline__ float inside(float x) {
  return (x >= -kClamp && x <= kClamp) ? 1.f : 0.f;
}

// --------------------------------------------------- pass 1: G per chunk

template <int HD>
struct GradTile {
  static constexpr int KR = 16;                   // key rows of a tile
  static constexpr int VC = HD < 32 ? HD : 32;    // value columns
  static constexpr int kThreads = KR * VC / 4;    // 4 entries each
  static constexpr int TILES = (HD / KR) * (HD / VC);
};

template <typename T, int HD>
__global__ void __launch_bounds__(GradTile<HD>::kThreads)
wkv6_bwd_state(const T* __restrict__ r, const float* __restrict__ logw,
               const float* __restrict__ dy, const float* __restrict__ ds,
               float* __restrict__ gscratch, float* __restrict__ ds0, int H,
               int S, int C, Strides rs, Strides ws, Strides gs) {
  using L = GradTile<HD>;
  constexpr int KR = L::KR, VC = L::VC, NT = L::kThreads;
  __shared__ float Ws[kT][KR + 1];
  __shared__ float Qs[kT][KR + 1];               // r, then q_
  __shared__ float Gy[kT][VC + 1];               // dy
  __shared__ float Cr[KR];                       // the cumsum's carry

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = (blockIdx.x / (HD / VC)) * KR;   // first key row
  const int c0 = (blockIdx.x % (HD / VC)) * VC;   // first value column
  const T* rb = r + b * rs.b + h * rs.h + r0;
  const float* wb = logw + b * ws.b + h * ws.h + r0;
  const float* gb = dy + b * gs.b + h * gs.h + c0;
  const size_t bh = (size_t)b * H + h;
  const int NC = S / C;

  const int i = tid / (VC / 4), j = (tid % (VC / 4)) * 4;
  const size_t at = (size_t)(r0 + i) * HD + c0 + j;
  float g[4] = {0.f, 0.f, 0.f, 0.f};
  if (ds != nullptr)
    for (int q = 0; q < 4; ++q) g[q] = ds[bh * HD * HD + at + q];

  for (int ch = NC - 1; ch >= 0; --ch) {
    float* out = gscratch + (bh * NC + ch) * HD * HD + at;
    for (int q = 0; q < 4; ++q) out[q] = g[q];    // G of chunk ch
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    __syncthreads();                    // every thread has read Cr
    if (tid < KR) Cr[tid] = 0.f;
    for (int s0 = 0; s0 < C; s0 += kT) {
      const int nt = min(kT, C - s0);
      const long long t0 = (long long)ch * C + s0;
      __syncthreads();                  // the previous sub-tile is consumed
      for (int e = tid; e < kT * KR; e += NT) {
        const int t = e / KR, c = e % KR;
        const bool on = t < nt;
        Ws[t][c] = on ? wb[(t0 + t) * ws.s + c] : 0.f;
        Qs[t][c] = on ? to_f(rb[(t0 + t) * rs.s + c]) : 0.f;
      }
      for (int e = tid; e < kT * VC; e += NT) {
        const int t = e / VC, c = e % VC;
        Gy[t][c] = t < nt ? gb[(t0 + t) * gs.s + c] : 0.f;
      }
      __syncthreads();
      if (tid < KR) {                   // q_ = r e^clip(ecl), channel tid
        float run = Cr[tid];
        for (int t = 0; t < nt; ++t) {
          const float w = Ws[t][tid];
          run += w;
          Qs[t][tid] *= clip_exp(run - w);
        }
        Cr[tid] = run;
      }
      __syncthreads();
      for (int t = 0; t < nt; ++t) {    // acc += q_^T dy
        const float qv = Qs[t][i];
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(qv, Gy[t][j + q], acc[q]);
      }
    }
    const float e4 = clip_exp(Cr[i]);   // Cr: the chunk's total
    for (int q = 0; q < 4; ++q) g[q] = fmaf(e4, g[q], acc[q]);
  }
  for (int q = 0; q < 4; ++q) ds0[bh * HD * HD + at + q] = g[q];
}

// ---------------------------------------------- pass 2: a tile's grads

template <int HD>
struct OutTile {
  static constexpr int kThreads = 256;
  static constexpr int DP = HD + 1;               // padded row
  static constexpr int NPT = kT * HD / kThreads;  // tokens a thread
  static constexpr int TSTEP = kThreads / HD;     // between its tokens
  static constexpr int RB = HD < 64 ? HD : 64;    // state rows staged
  static constexpr int TILE = kT * DP;
  // shared-memory layout, in floats
  static constexpr int kR = 0, kK = TILE, kV = 2 * TILE, kDY = 3 * TILE,
                       kW = 4 * TILE, kCLW = 5 * TILE, kQ = 6 * TILE,
                       kKm = 7 * TILE, kKD = 8 * TILE;
  // the other tile (3 arrays), or 64 state rows, or decl / g2 / g3
  static constexpr int kO = 9 * TILE;
  static constexpr int kM = 12 * TILE;            // a 32 x 32 product
  static constexpr int kU = kM + kT * (kT + 1);
  static constexpr int kCarry = kU + HD, kTot = kCarry + HD;
  static constexpr int kDG = kTot + HD, kDD = kDG + kT;
  static constexpr int kFloats = kDD + kT;
  static_assert(RB * DP <= 3 * TILE, "state rows exceed the region");
};

template <typename T, int HD>
__global__ void __launch_bounds__(OutTile<HD>::kThreads)
wkv6_bwd_out(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ logw,
             const float* __restrict__ dy, const float* __restrict__ u,
             const float* __restrict__ starts,
             const float* __restrict__ gscratch, T* __restrict__ dr,
             T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw,
             float* __restrict__ dupart, float* __restrict__ tsum,
             float* __restrict__ g4buf, int H, int S, int C, Strides rs,
             Strides ks, Strides vs, Strides ws, Strides gs, Strides drs,
             Strides dks, Strides dvs, Strides dws) {
  using L = OutTile<HD>;
  constexpr int NT = L::kThreads, DP = L::DP, NPT = L::NPT;
  constexpr int TSTEP = L::TSTEP, RB = L::RB, MP = kT + 1;
  extern __shared__ __align__(16) float sm[];
  float* R = sm + L::kR;
  float* K = sm + L::kK;
  float* V = sm + L::kV;
  float* DY = sm + L::kDY;
  float* W = sm + L::kW;
  float* CLW = sm + L::kCLW;
  float* Q = sm + L::kQ;                          // q_
  float* Km = sm + L::kKm;                        // k_
  float* KD = sm + L::kKD;                        // kd
  float* Xo = sm + L::kO;                         // other tile: k_ or q_
  float* Wo = Xo + L::TILE;                       //   its logw
  float* Yo = Wo + L::TILE;                       //   its v or dy
  float* M = sm + L::kM;
  float* U = sm + L::kU;
  float* Carry = sm + L::kCarry;
  float* Tot = sm + L::kTot;
  float* DG = sm + L::kDG;                        // diag = sum_c r u k
  float* DD = sm + L::kDD;                        // ddiag = sum_j dy v

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int TPC = (C + kT - 1) / kT, NC = S / C;
  const int ch = blockIdx.x / TPC, qt = blockIdx.x % TPC;
  const long long cs = (long long)ch * C;         // chunk start
  const int n = min(kT, C - qt * kT);
  const size_t bh = (size_t)b * H + h;
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* wb = logw + b * ws.b + h * ws.h;
  const float* gb = dy + b * gs.b + h * gs.h;
  const float* sp = starts + (bh * NC + ch) * HD * HD;   // S_{c-1}
  const float* gg = gscratch + (bh * NC + ch) * HD * HD; // G

  // this thread's outputs: channel (or value column) c, tokens tk(q)
  const int c = tid % HD;
  auto tk = [&](int q) { return tid / HD + q * TSTEP; };
  float aq[NPT], ak[NPT], av[NPT], akd[NPT];
  for (int q = 0; q < NPT; ++q) aq[q] = ak[q] = av[q] = akd[q] = 0.f;

  // stage n tokens from t0 (zeros past n) of a (T) and b (float or T)
  auto stage = [&](float* dst, const auto* src, long long ss, long long t0,
                   int nn) {
    for (int e = tid; e < kT * HD; e += NT) {
      const int t = e / HD, cc = e % HD;
      dst[t * DP + cc] = t < nn ? to_f(src[(t0 + t) * ss + cc]) : 0.f;
    }
  };
  // M[t][s] = sum over the row of X[t] Y[s], masked to s < t when `lower`
  auto product = [&](const float* X, const float* Y, bool lower) {
    for (int e = tid; e < kT * kT; e += NT) {
      const int t = e / kT, s = e % kT;
      float a = 0.f;
      if (!lower || s < t)
        for (int j = 0; j < HD; ++j) a = fmaf(X[t * DP + j], Y[s * DP + j], a);
      M[t * MP + s] = a;
    }
  };
  // the cumsum of logw over a tile, a channel a thread, carried in Carry;
  // X becomes X e^clip(clw - w) (`query`) or X e^clip(-clw)
  auto scan = [&](const float* Wt, float* X, bool query) {
    if (tid < HD) {
      float run = Carry[tid];
      for (int t = 0; t < kT; ++t) {
        const float w = Wt[t * DP + tid];
        run += w;
        X[t * DP + tid] *= query ? clip_exp(run - w) : clip_exp(-run);
      }
      Carry[tid] = run;
    }
  };

  // the own tile
  stage(R, rb, rs.s, cs + qt * kT, n);
  stage(K, kb, ks.s, cs + qt * kT, n);
  stage(V, vb, vs.s, cs + qt * kT, n);
  stage(DY, gb, gs.s, cs + qt * kT, n);
  stage(W, wb, ws.s, cs + qt * kT, n);
  if (tid < HD) {
    U[tid] = u[(size_t)h * HD + tid];
    Carry[tid] = 0.f;
  }
  __syncthreads();

  // the chunk's earlier tiles: dq_ += dA k_ (every key before the tile)
  for (int jt = 0; jt < qt; ++jt) {
    const long long t0 = cs + jt * kT;
    stage(Xo, kb, ks.s, t0, kT);
    stage(Wo, wb, ws.s, t0, kT);
    stage(Yo, vb, vs.s, t0, kT);
    __syncthreads();
    scan(Wo, Xo, false);                 // k_
    product(DY, Yo, false);                       // dA
    __syncthreads();
    for (int q = 0; q < NPT; ++q)
      for (int s = 0; s < kT; ++s)
        aq[q] = fmaf(M[tk(q) * MP + s], Xo[s * DP + c], aq[q]);
    __syncthreads();
  }

  // the own tile: q_, k_, the diagonals, the strictly lower dA and A
  for (int e = tid; e < kT * HD; e += NT) Q[(e / HD) * DP + e % HD] =
      R[(e / HD) * DP + e % HD];
  for (int e = tid; e < kT * HD; e += NT) Km[(e / HD) * DP + e % HD] =
      K[(e / HD) * DP + e % HD];
  __syncthreads();
  if (tid < HD) {
    float run = Carry[tid];
    for (int t = 0; t < kT; ++t) {
      const float w = W[t * DP + tid];
      run += w;                                   // w = 0 past n
      CLW[t * DP + tid] = run;
      Q[t * DP + tid] *= clip_exp(run - w);
      Km[t * DP + tid] *= clip_exp(-run);
    }
    Carry[tid] = run;
  }
  if (tid < kT) {
    float dg = 0.f, dd = 0.f;
    for (int j = 0; j < HD; ++j) {
      dg = fmaf(R[tid * DP + j], U[j] * K[tid * DP + j], dg);
      dd = fmaf(DY[tid * DP + j], V[tid * DP + j], dd);
    }
    DG[tid] = dg;
    DD[tid] = dd;
  }
  __syncthreads();
  product(DY, V, true);                           // dA, strictly lower
  __syncthreads();
  for (int q = 0; q < NPT; ++q) {
    const int t = tk(q);
    for (int s = 0; s < kT; ++s) {
      aq[q] = fmaf(M[t * MP + s], Km[s * DP + c], aq[q]);
      ak[q] = fmaf(M[s * MP + t], Q[s * DP + c], ak[q]);
    }
  }
  __syncthreads();
  product(Q, Km, true);                           // A, strictly lower
  __syncthreads();
  for (int q = 0; q < NPT; ++q) {
    const int t = tk(q);
    for (int s = 0; s < kT; ++s)
      av[q] = fmaf(M[s * MP + t], DY[s * DP + c], av[q]);
    av[q] = fmaf(DG[t], DY[t * DP + c], av[q]);
  }
  // dq_ += dy S_{c-1}^T, RB rows of S_{c-1} at a time
  for (int r0 = 0; r0 < HD; r0 += RB) {
    __syncthreads();
    for (int e = tid; e < RB * HD; e += NT)
      Xo[(e / HD) * DP + e % HD] = sp[(size_t)(r0 + e / HD) * HD + e % HD];
    __syncthreads();
    if (c >= r0 && c < r0 + RB)
      for (int q = 0; q < NPT; ++q)
        for (int j = 0; j < HD; ++j)
          aq[q] = fmaf(DY[tk(q) * DP + j], Xo[(c - r0) * DP + j], aq[q]);
  }
  __syncthreads();

  // the chunk's later tiles: dk_ += dA^T q_, dv += A^T dy
  for (int jt = qt + 1; jt < TPC; ++jt) {
    const long long t0 = cs + jt * kT;
    const int no = min(kT, C - jt * kT);
    stage(Xo, rb, rs.s, t0, no);
    stage(Wo, wb, ws.s, t0, no);
    stage(Yo, gb, gs.s, t0, no);
    __syncthreads();
    scan(Wo, Xo, true);                  // q_
    product(Yo, V, false);                        // dA (rows: later)
    __syncthreads();
    for (int q = 0; q < NPT; ++q)
      for (int s = 0; s < kT; ++s)
        ak[q] = fmaf(M[s * MP + tk(q)], Xo[s * DP + c], ak[q]);
    __syncthreads();
    product(Xo, Km, false);                       // A (rows: later)
    __syncthreads();
    for (int q = 0; q < NPT; ++q)
      for (int s = 0; s < kT; ++s)
        av[q] = fmaf(M[s * MP + tk(q)], Yo[s * DP + c], av[q]);
    __syncthreads();
  }

  // the chunk's total, then kd = k e^clip(total - clw)
  if (tid < HD) Tot[tid] = Carry[tid];
  __syncthreads();
  for (int e = tid; e < kT * HD; e += NT) {
    const int at = (e / HD) * DP + e % HD;
    KD[at] = K[at] * clip_exp(Tot[e % HD] - CLW[at]);
  }
  // dkd = v G^T and dv += kd G, RB rows of G at a time
  for (int r0 = 0; r0 < HD; r0 += RB) {
    __syncthreads();
    for (int e = tid; e < RB * HD; e += NT)
      Xo[(e / HD) * DP + e % HD] = gg[(size_t)(r0 + e / HD) * HD + e % HD];
    __syncthreads();
    for (int q = 0; q < NPT; ++q) {
      const int t = tk(q);
      if (c >= r0 && c < r0 + RB)
        for (int j = 0; j < HD; ++j)
          akd[q] = fmaf(V[t * DP + j], Xo[(c - r0) * DP + j], akd[q]);
      for (int rr = 0; rr < RB; ++rr)
        av[q] = fmaf(KD[t * DP + r0 + rr], Xo[rr * DP + c], av[q]);
    }
  }
  __syncthreads();

  // dr, dk, dv out; decl, g2, g3 into the region for dlogw
  float* DEC = Xo;
  float* G2 = Wo;
  float* G3 = Yo;
  for (int q = 0; q < NPT; ++q) {
    const int t = tk(q), at = t * DP + c;
    const float clw = CLW[at], w = W[at], tot = Tot[c];
    const float ecl = clw - w;
    const float dd = DD[t] * U[c];
    const float gr = fmaf(dd, K[at], aq[q] * clip_exp(ecl));
    const float gk = fmaf(dd, R[at], fmaf(ak[q], clip_exp(-clw),
                                          akd[q] * clip_exp(tot - clw)));
    if (t < n) {
      const long long row = cs + qt * kT + t;
      from_f(dr + b * drs.b + h * drs.h + row * drs.s + c, gr);
      from_f(dk + b * dks.b + h * dks.h + row * dks.s + c, gk);
      from_f(dv + b * dvs.b + h * dvs.h + row * dvs.s + c, av[q]);
    }
    DEC[at] = aq[q] * Q[at] * inside(ecl);
    G2[at] = ak[q] * Km[at] * inside(-clw);
    G3[at] = akd[q] * KD[at] * inside(tot - clw);
  }
  __syncthreads();

  if (tid < HD) {                       // a channel a thread, in order
    const int cc = tid;
    float g4 = 0.f;
    if (TPC == 1 || qt == 0) {          // E4 sum_j G S_{c-1}, row cc
      for (int j = 0; j < HD; ++j)
        g4 = fmaf(gg[(size_t)cc * HD + j], sp[(size_t)cc * HD + j], g4);
      g4 *= clip_exp(Tot[cc]) * inside(Tot[cc]);
    }
    float pre = 0.f;                    // sum of g3 before each token
    for (int t = 0; t < n; ++t) {
      const float x = G3[t * DP + cc];
      G3[t * DP + cc] = pre;
      pre += x;
    }
    float sd = 0.f, s2 = 0.f;           // sums of decl after, g2 from
    float* out = dw + b * dws.b + h * dws.h + (cs + qt * kT) * dws.s + cc;
    for (int t = n - 1; t >= 0; --t) {
      s2 += G2[t * DP + cc];
      const float x = G3[t * DP + cc] + sd - s2;
      out[t * dws.s] = TPC == 1 ? x + g4 : x;
      sd += DEC[t * DP + cc];
    }
    float du = 0.f;
    for (int t = 0; t < n; ++t)
      du = fmaf(DD[t], R[t * DP + cc] * K[t * DP + cc], du);
    const size_t tile = bh * (size_t)(NC * TPC) + blockIdx.x;
    dupart[tile * HD + cc] = du;
    if (TPC > 1) {
      tsum[(tile * 2) * HD + cc] = pre;
      tsum[(tile * 2 + 1) * HD + cc] = sd - s2;
      if (qt == 0) g4buf[(bh * NC + ch) * HD + cc] = g4;
    }
  }
}

// ------------------------------- pass 3: dlogw across a chunk's tiles

template <int HD>
__global__ void __launch_bounds__(256)
wkv6_bwd_fix(const float* __restrict__ tsum, const float* __restrict__ g4buf,
             float* __restrict__ dw, int H, int S, int C, Strides dws) {
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int TPC = (C + kT - 1) / kT, NC = S / C;
  const int ch = blockIdx.x / TPC, qt = blockIdx.x % TPC;
  const int n = min(kT, C - qt * kT);
  const size_t bh = (size_t)b * H + h;
  const size_t first = bh * (size_t)(NC * TPC) + (size_t)ch * TPC;
  const int c = tid % HD;
  float x = g4buf[(bh * NC + ch) * HD + c];
  for (int jt = 0; jt < TPC; ++jt) {    // in order: earlier g3, later rest
    if (jt < qt) x += tsum[((first + jt) * 2) * HD + c];
    if (jt > qt) x += tsum[((first + jt) * 2 + 1) * HD + c];
  }
  float* out = dw + b * dws.b + h * dws.h + ((long long)ch * C + qt * kT) *
               dws.s + c;
  for (int t = tid / HD; t < n; t += 256 / HD) out[t * dws.s] += x;
}

// ------------------------------------------------- pass 4: du per head

template <int HD>
__global__ void __launch_bounds__(HD)
wkv6_bwd_du(const float* __restrict__ dupart, float* __restrict__ du, int B,
            int H, int tiles) {
  const int h = blockIdx.x, c = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = dupart + ((size_t)b * H + h) * tiles * HD + c;
    for (int t = 0; t < tiles; ++t) acc += p[(size_t)t * HD];
  }
  du[(size_t)h * HD + c] = acc;
}

struct Args {
  const void *r, *k, *v;
  const float *logw, *dy, *u, *starts, *ds;
  void *dr, *dk, *dv;
  float *dw, *du, *ds0, *gscratch, *dupart, *tsum, *g4buf;
  int B, H, S, C;
  Strides rs, ks, vs, ws, gs, drs, dks, dvs, dws;
};

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  using GL = GradTile<HD>;
  using OL = OutTile<HD>;
  const int TPC = (a.C + kT - 1) / kT, NC = a.S / a.C;
  const long long tiles = (long long)NC * TPC;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = OL::kFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_out<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_state<T, HD><<<dim3(GL::TILES, a.H, a.B), GL::kThreads, 0,
                          stream>>>(
      (const T*)a.r, a.logw, a.dy, a.ds, a.gscratch, a.ds0, a.H, a.S, a.C,
      a.rs, a.ws, a.gs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_bwd_out<T, HD><<<dim3((unsigned)tiles, a.H, a.B), OL::kThreads, smem,
                        stream>>>(
      (const T*)a.r, (const T*)a.k, (const T*)a.v, a.logw, a.dy, a.u,
      a.starts, a.gscratch, (T*)a.dr, (T*)a.dk, (T*)a.dv, a.dw, a.dupart,
      a.tsum, a.g4buf, a.H, a.S, a.C, a.rs, a.ks, a.vs, a.ws, a.gs, a.drs,
      a.dks, a.dvs, a.dws);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (TPC > 1) {
    wkv6_bwd_fix<HD><<<dim3((unsigned)tiles, a.H, a.B), 256, 0, stream>>>(
        a.tsum, a.g4buf, a.dw, a.H, a.S, a.C, a.dws);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  wkv6_bwd_du<HD><<<a.H, HD, 0, stream>>>(a.dupart, a.du, a.B, a.H,
                                          (int)tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(a, stream);
    case 32:
      return launch<T, 32>(a, stream);
    case 64:
      return launch<T, 64>(a, stream);
    case 128:
      return launch<T, 128>(a, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p, long long elem, const Strides& s) {
  const long long e = 16 / elem;
  return ((uintptr_t)p & 15) == 0 && s.b % e == 0 && s.h % e == 0 &&
         s.s % e == 0;
}

}  // namespace

extern "C" {

// r/k/v (dtype 0: float32, 1: bfloat16), logw and dy (float32), and the
// outputs dr/dk/dv (r's dtype) and dlogw (float32): (B, H, S, hd), each
// addressed by its (batch, head, row) element strides with a contiguous
// last dimension. u (H, hd), starts (B, H, S / C, hd, hd: the forward's
// chunk-start states, K4's scratch), ds (B, H, hd, hd; null: zero), du
// (H, hd) and ds0 (B, H, hd, hd): contiguous float32. Scratch, float32,
// written before it is read: gscratch (B, H, S / C, hd, hd), dupart (B,
// H, tiles, hd), and for C > 32 tsum (B, H, tiles, 2, hd) and g4buf (B,
// H, S / C, hd), with tiles = S / C * ceil(C / 32). hd in {16, 32, 64,
// 128}; any C >= 1 that divides S. Runs three kernels on `stream` (four
// for C > 32). Returns the first CUDA error (cudaSuccess = 0),
// cudaErrorInvalidValue for a shape or pointer the kernels do not take.
int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                    const void* logw, const void* dy, const void* u,
                    const void* starts, const void* ds, void* dr, void* dk,
                    void* dv, void* dw, void* du, void* ds0, void* gscratch,
                    void* dupart, void* tsum, void* g4buf, int dtype, int B,
                    int H, int S, int hd, int C, const long long* strides,
                    void* stream) {
  Args a;
  a.r = r, a.k = k, a.v = v;
  a.logw = (const float*)logw, a.dy = (const float*)dy;
  a.u = (const float*)u, a.starts = (const float*)starts;
  a.ds = (const float*)ds;
  a.dr = dr, a.dk = dk, a.dv = dv;
  a.dw = (float*)dw, a.du = (float*)du, a.ds0 = (float*)ds0;
  a.gscratch = (float*)gscratch, a.dupart = (float*)dupart;
  a.tsum = (float*)tsum, a.g4buf = (float*)g4buf;
  a.B = B, a.H = H, a.S = S, a.C = C;
  Strides* all[9] = {&a.rs, &a.ks, &a.vs, &a.ws, &a.gs,
                     &a.drs, &a.dks, &a.dvs, &a.dws};
  for (int i = 0; i < 9; ++i)
    *all[i] = Strides{strides[3 * i], strides[3 * i + 1],
                      strides[3 * i + 2]};
  const long long es = dtype == 1 ? 2 : 4;
  if (B <= 0 || H <= 0 || S <= 0 || C <= 0 || B > 65535 || H > 65535 ||
      S % C || (dtype != 0 && dtype != 1) || !aligned16(r, es, a.rs) ||
      !aligned16(k, es, a.ks) || !aligned16(v, es, a.vs) ||
      !aligned16(logw, 4, a.ws) || !aligned16(dy, 4, a.gs) ||
      (C > kT && (tsum == nullptr || g4buf == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_hd<float>(hd, a, st);
  return dispatch_hd<__nv_bfloat16>(hd, a, st);
}

const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
