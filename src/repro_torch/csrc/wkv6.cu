// Chunked RWKV6 (Finch) WKV recurrence for Hopper (sm_90a). Per (batch,
// head) and per chunk of C tokens, with clw = cumsum(logw) (inclusive) and
// ecl = clw - logw (exclusive), all exponents clamped to +-25:
//   q_ = r e^ecl,  k_ = k e^-clw,  A = strictly_lower(q_ k_^T)  (C x C)
//   y  = A v + (sum_c r u k) v + q_ S
//   S <- e^clw[C-1] S + (k e^(clw[C-1] - clw))^T v
// The (hd, hd) float32 state carries from chunk to chunk. r, k, v in
// float32 or bfloat16; logw, u, s0, y and the final state in float32.
//
// Replaces: src/repro/kernels/wkv6/wkv6.py, `wkv6_chunked` (Pallas body
// `_wkv6_kernel`), reached through `ops.wkv6`.
//
// What bounds it on this card: the inputs are read once and y written once
// (~120 MB for (1, 2048, 64, 64) with bfloat16 r/k/v: ~0.036 ms at 3.35
// TB/s), and the work is ~4 hd^2 + 2 C hd float32 operations per token and
// head (~2.75 GFLOP there: ~0.041 ms on the CUDA cores' 67 TFLOP/s;
// tensor-core TF32 or bf16 would change the numbers). Only the state
// recurrence is sequential across chunks; a design that walks the chunks
// with everything else on that chain (this kernel's first version: 1.1 ms
// on an H100 at 700 W) is bound by the chain's latency, not by either
// bound.
//
// Design: two kernels per call, so that only the recurrence stays on the
// sequential chain.
//  1. `wkv6_state` walks the chunks in order and computes only the state.
//     A block owns a tile of it, 16 key rows x 32 value columns (8 tiles
//     per head at hd 64: 512 blocks for rwkv6-7b at batch 1), in registers,
//     4 entries a thread. Key row c of the update needs only channel c of k
//     and logw, value column j only column j of v, so a tile reads only its
//     own slices: cp.async stages them per sub-tile of 32 tokens, 3
//     sub-tiles ahead in a 4-deep ring. The cumsum of logw per channel is a
//     group scan (8 lanes a channel, 4 tokens a lane, joined by shuffles);
//     v is widened to float32 once a sub-tile; then each thread adds its
//     4 entries of (k e^clip(total - clw))^T v. At the start of every chunk
//     the block writes the chunk-start state S_{c-1} to a float32 scratch
//     of (B, H, S/C, hd, hd) that the wrapper allocates; at the end, the
//     final state. A chunk longer than 32 tokens first sums its logw by the
//     same scans, so the total is bit-equal to the walk's last clw.
//  2. `wkv6_out` runs one independent block per (32-token query tile of a
//     chunk, 64 value columns, head, batch): 4,096 blocks at the main
//     shape. It stages the tile channel-major with 16-byte loads (a swizzle
//     keeps both those stores and the float4 reads free of bank
//     conflicts), scans logw per channel with a warp scan (carrying the sum
//     of the chunk's earlier tiles), forms q_, k_ and the u diagonal,
//     builds A tile by tile (the query tile's own keys, strictly lower, then
//     every earlier key tile of the chunk), and adds A v and q_ S_{c-1},
//     S_{c-1} read from the scratch. A is never larger than 32 x 32, so a
//     chunk of any length, up to the whole sequence, works; blocks with the
//     most key tiles behind them start first. Every output is a 4x4
//     register tile fed by float4 reads of shared memory.
// All arithmetic is float32 on the CUDA cores (exponentials as ex2 of a
// pre-scaled argument), every sum has a fixed order and there are no
// atomics, so two calls are bit-equal.
//
// What bounds this design: bytes. The scratch at (1, 2048, 64, 64) with
// C = 32 is 64 chunks x 64 heads x 64 x 64 float32 = 64 MiB, above the
// 50 MB L2, so it costs one write and one read at device-memory rate; with
// it the two kernels move ~310 MB (~0.09 ms at 3.35 TB/s) where the call
// needs ~120 MB.
//
// Alignment: both passes read r, k, v and logw in 16-byte pieces and s0 as
// float4, so those need 16-byte aligned bases and (batch, head, row)
// strides; the wrapper checks and raises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kClamp = 25.0f;
constexpr int kT = 32;             // tokens per sub-tile: one warp scan
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// e^clip(x), as 2^(x log2 e): ex2 on the special-function unit plus one
// multiply. The rounding of the product adds a relative error of at most
// ~25 log2(e) 2^-24 (2e-6), far inside the 1e-3 the outputs are held to.
__device__ __forceinline__ float clip_exp(float x) {
  return exp2f(fminf(fmaxf(x, -kClamp), kClamp) * 1.4426950408889634f);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Inclusive prefix sum over the lanes of a warp, in a fixed order.
__device__ __forceinline__ float warp_scan(float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ------------------------------------------------------------ state pass

// The cumsum of one key channel over a sub-tile of n <= 32 tokens, by a
// group of G lanes (G divides 32, the group aligned within its warp): lane
// g of the group sums tokens g * 32 / G .. (g + 1) * 32 / G - 1 in order,
// and the group joins its parts by a shuffle scan. clw[q] becomes carry +
// the cumsum at the lane's q-th token; returns the cumsum at token n - 1
// (carry included) to the whole group. The same order everywhere makes
// the total that a long chunk's first walk finds bit-equal to its last clw.
template <int G, typename W>
__device__ __forceinline__ float group_scan(W w_at, int n, float carry,
                                            float (&clw)[32 / G]) {
  constexpr int M = 32 / G;                       // tokens a lane
  const int g = threadIdx.x % G;
  float run = 0.f;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const int t = g * M + q;
    run += t < n ? w_at(t) : 0.f;
    clw[q] = run;
  }
  float incl = run;                               // over the group's parts
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, d, G);
    if (g >= d) incl += y;
  }
  const float below = __shfl_up_sync(kFull, incl, 1, G);
  const float base = g ? below : 0.f;
#pragma unroll
  for (int q = 0; q < M; ++q) clw[q] = carry + (base + clw[q]);
  return __shfl_sync(kFull, carry + (base + run), (n - 1) / M, G);
}

template <typename T, int HD>
struct StateTile {
  static constexpr int KR = 16;                   // key rows of a tile
  static constexpr int VC = HD < 32 ? HD : 32;    // value columns
  static constexpr int kThreads = KR * VC / 4;    // 4 state entries each
  static constexpr int TILES = (HD / KR) * (HD / VC);
  static constexpr int NS = 4;                    // cp.async ring depth
  static constexpr int E = 16 / sizeof(T);        // elements per 16 bytes
  static constexpr int KP = KR / E, LP = KR / 4, VP = VC / E;  // pieces/row
  // staged rows; k and logw padded by 16 bytes against bank conflicts
  static constexpr int KS = KR + E, LS = KR + 4, DS = KR + 1;
};

template <typename T, int HD>
__global__ void __launch_bounds__(StateTile<T, HD>::kThreads)
wkv6_state(const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ logw, const float* __restrict__ s0,
           float* __restrict__ scratch, float* __restrict__ s_out, int H,
           int S, int C, Strides ks, Strides vs, Strides ws) {
  using L = StateTile<T, HD>;
  constexpr int KR = L::KR, VC = L::VC, NT = L::kThreads, NS = L::NS;
  constexpr int KS = L::KS, LS = L::LS, DS = L::DS, E = L::E;
  constexpr bool kF32 = sizeof(T) == 4;
  __shared__ __align__(16) T Kb[NS][kT * KS];
  __shared__ __align__(16) float Lb[NS][kT * LS];
  __shared__ __align__(16) T Vb[NS][kT * VC];
  __shared__ __align__(16) float Vf[kF32 ? 4 : kT * VC];   // v in float32
  __shared__ float Kd[kT * DS];                   // k e^clip(total - clw)
  __shared__ float Et[KR];                        // e^clip(total)

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = (blockIdx.x / (HD / VC)) * KR;   // first key row
  const int c0 = (blockIdx.x % (HD / VC)) * VC;   // first value column
  const T* kb = k + b * ks.b + h * ks.h + r0;
  const T* vb = v + b * vs.b + h * vs.h + c0;
  const float* wb = logw + b * ws.b + h * ws.h + r0;
  const size_t bh = (size_t)b * H + h;
  const int NC = S / C, per = (C + kT - 1) / kT, G = NC * per;

  // this thread's entries: key row i, value columns j .. j + 3
  const int i = tid / (VC / 4), j = (tid % (VC / 4)) * 4;
  const size_t at = (size_t)(r0 + i) * HD + c0 + j;
  float4 st = load4(s0 + bh * HD * HD + at);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  // the scan: a group of GL lanes owns key channel sc of the tile
  constexpr int GL = NT / KR, M = 32 / GL;
  const int sc = tid / GL;
  float carry = 0.f, total = 0.f, clw[M];

  auto load = [&](int g) {
    const int buf = g % NS, sub = g % per, nt = min(kT, C - sub * kT);
    const long long t0 = (long long)(g / per) * C + sub * kT;
    for (int p = tid; p < nt * L::KP; p += NT) {
      const int t = p / L::KP, q = (p % L::KP) * E;
      cp_async16(&Kb[buf][t * KS + q], kb + (t0 + t) * ks.s + q);
    }
    for (int p = tid; p < nt * L::LP; p += NT) {
      const int t = p / L::LP, q = (p % L::LP) * 4;
      cp_async16(&Lb[buf][t * LS + q], wb + (t0 + t) * ws.s + q);
    }
    for (int p = tid; p < nt * L::VP; p += NT) {
      const int t = p / L::VP, q = (p % L::VP) * E;
      cp_async16(&Vb[buf][t * VC + q], vb + (t0 + t) * vs.s + q);
    }
  };

#pragma unroll
  for (int g = 0; g < NS - 1; ++g) {    // NS - 1 sub-tiles in flight
    if (g < G) load(g);
    cp_async_commit();
  }
  for (int g = 0; g < G; ++g) {
    const int buf = g % NS, sub = g % per, ch = g / per;
    const int nt = min(kT, C - sub * kT);
    cp_async_wait<NS - 2>();
    __syncthreads();                    // sub-tile g landed, g - 1 consumed
    if (g + NS - 1 < G) load(g + NS - 1);
    cp_async_commit();                  // an empty group keeps the count

    if (sub == 0) {                     // chunk start: S_{c-1} out
      *reinterpret_cast<float4*>(scratch + (bh * NC + ch) * HD * HD + at) =
          st;
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
      carry = 0.f;
    }
    if (sub == 0 && per > 1) {          // a long chunk: its total first
      float cy = 0.f;
      for (int s = 0; s < per; ++s) {
        const long long t0 = (long long)ch * C + s * kT;
        const float last = group_scan<GL>(
            [&](int t) { return wb[(t0 + t) * ws.s + sc]; },
            min(kT, C - s * kT), cy, clw);
        if (s == per - 1) total = last;
        else cy = last;
      }
      if (tid % GL == 0) Et[sc] = clip_exp(total);
    }
    {
      const float* lw = Lb[buf];
      const float last = group_scan<GL>(
          [&](int t) { return lw[t * LS + sc]; }, nt, carry, clw);
      if (per == 1) {
        total = last;
        if (tid % GL == 0) Et[sc] = clip_exp(total);
      } else {
        carry = last;
      }
      const T* kk = Kb[buf];
#pragma unroll
      for (int q = 0; q < M; ++q) {
        const int t = (tid % GL) * M + q;
        if (t < nt)
          Kd[t * DS + sc] = to_f(kk[t * KS + sc]) * clip_exp(total - clw[q]);
      }
    }
    if constexpr (!kF32)                // v to float32, once a sub-tile
      for (int e = tid * 4; e < nt * VC; e += NT * 4)
        *reinterpret_cast<float4*>(&Vf[e]) = load4(&Vb[buf][e]);
    __syncthreads();

    const float* vv = kF32 ? reinterpret_cast<const float*>(Vb[buf]) : Vf;
#pragma unroll 8
    for (int s = 0; s < nt; ++s) {      // acc += kd^T v over the sub-tile
      const float kd = Kd[s * DS + i];
      const float4 w4 = load4(&vv[s * VC + j]);
      acc.x = fmaf(kd, w4.x, acc.x);
      acc.y = fmaf(kd, w4.y, acc.y);
      acc.z = fmaf(kd, w4.z, acc.z);
      acc.w = fmaf(kd, w4.w, acc.w);
    }
    if (sub == per - 1) {               // S <- e^clip(total) S + kd^T v
      const float e = Et[i];
      st.x = fmaf(e, st.x, acc.x);
      st.y = fmaf(e, st.y, acc.y);
      st.z = fmaf(e, st.z, acc.z);
      st.w = fmaf(e, st.w, acc.w);
    }
  }
  cp_async_wait<0>();
  *reinterpret_cast<float4*>(s_out + bh * HD * HD + at) = st;
}

// ----------------------------------------------------------- output pass

template <int HD>
struct OutTile {
  static constexpr int VT = HD < 64 ? HD : 64;    // value columns a block
  static constexpr int NV = HD / VT;
  static constexpr int kThreads = (kT / 4) * (VT / 4);   // 4x4 outputs each
  static constexpr int NW = kThreads / 32;
  static constexpr int P = kT + 4;     // row of a channel-major tile
  // shared-memory layout, in floats (every offset a multiple of 4)
  static constexpr int kQt = 0;                   // r, then q_   (HD x P)
  static constexpr int kKt = kQt + HD * P;        // k, then k_   (HD x P)
  static constexpr int kLt = kKt + HD * P;        // logw         (HD x P)
  static constexpr int kV = kLt + HD * P;         // v            (kT x VT)
  static constexpr int kS = kV + kT * VT;         // S_{c-1}      (HD x VT)
  // A^T (kT x P) takes the logw tile's place once the scan has read it
  static constexpr int kA = HD >= kT ? kLt : kS + HD * VT;
  static constexpr int kD = HD >= kT ? kS + HD * VT : kA + kT * P;  // u diag
  static constexpr int kU = kD + NW * kT;         // u            (HD)
  static constexpr int kFloats = kU + HD;
};

// Channel-major tiles hold token t of channel c at c * P + (t ^ sw(c)):
// XOR with a multiple of 4 keeps aligned groups of 4 tokens whole and in
// order (float4 reads), and spreads the staging stores, where a warp
// writes 8 channels of 4 tokens at once, over all 32 banks.
__device__ __forceinline__ int sw(int c) { return ((c >> 3) & 7) << 2; }

template <typename T, int HD>
__global__ void __launch_bounds__(OutTile<HD>::kThreads)
wkv6_out(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ logw,
         const float* __restrict__ u, const float* __restrict__ scratch,
         float* __restrict__ y, int H, int S, int C, Strides rs, Strides ks,
         Strides vs, Strides ws, Strides ys) {
  using L = OutTile<HD>;
  constexpr int VT = L::VT, NV = L::NV, NT = L::kThreads, NW = L::NW;
  constexpr int P = L::P, CPW = HD / NW;
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm + L::kQt;
  float* Kt = sm + L::kKt;
  float* Lt = sm + L::kLt;
  float* V = sm + L::kV;
  float* St = sm + L::kS;
  float* At = sm + L::kA;
  float* Dp = sm + L::kD;
  float* U = sm + L::kU;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int NC = S / C, TPC = (C + kT - 1) / kT;
  const int bx = blockIdx.x;            // the longest query tiles first
  const int vt = bx % NV, ch = (bx / NV) % NC;
  const int qt = TPC - 1 - bx / (NV * NC);
  const int c0 = vt * VT;
  const long long cs = (long long)ch * C;         // chunk start
  const int nq = min(kT, C - qt * kT);
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h + c0;
  const float* wb = logw + b * ws.b + h * ws.h;
  float* yb = y + b * ys.b + h * ys.h + c0;
  const size_t bh = (size_t)b * H + h;

  // stage tokens [t0, t0 + n) channel-major (zeros past n): logw always,
  // k and v when `keys`, r when `query`; 16-byte loads, so all of a
  // thread's loads are in flight at once
  constexpr int E = 16 / sizeof(T), F = 4;       // elements per 16 bytes
  auto put = [&](float* dst, int c, int t, const float* x, int m) {
#pragma unroll
    for (int q = 0; q < m; ++q) dst[(c + q) * P + (t ^ sw(c + q))] = x[q];
  };
  auto unpack = [&](const T* src, bool on, float* x) {
    if (!on) {
#pragma unroll
      for (int q = 0; q < E; ++q) x[q] = 0.f;
      return;
    }
    const uint4 w = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int q = 0; q < E; ++q) x[q] = to_f(e[q]);
  };
  auto stage = [&](long long t0, int n, bool keys, bool query) {
#pragma unroll
    for (int e = tid; e < kT * (HD / F); e += NT) {
      const int t = e / (HD / F), c = (e % (HD / F)) * F;
      float x[F] = {0.f, 0.f, 0.f, 0.f};
      if (t < n) {
        const float4 w = load4(wb + (t0 + t) * ws.s + c);
        x[0] = w.x, x[1] = w.y, x[2] = w.z, x[3] = w.w;
      }
      put(Lt, c, t, x, F);
    }
    if (keys || query)
#pragma unroll
      for (int e = tid; e < kT * (HD / E); e += NT) {
        const int t = e / (HD / E), c = (e % (HD / E)) * E;
        float x[E];
        if (keys) {
          unpack(kb + (t0 + t) * ks.s + c, t < n, x);
          put(Kt, c, t, x, E);
        }
        if (query) {
          unpack(rb + (t0 + t) * rs.s + c, t < n, x);
          put(Qt, c, t, x, E);
        }
      }
    if (keys)
#pragma unroll
      for (int e = tid; e < kT * (VT / E); e += NT) {
        const int t = e / (VT / E), jj = (e % (VT / E)) * E;
        float x[E];
        unpack(vb + (t0 + t) * vs.s + jj, t < n, x);
#pragma unroll
        for (int q = 0; q < E; q += 4)
          *reinterpret_cast<float4*>(&V[t * VT + jj + q]) =
              make_float4(x[q], x[q + 1], x[q + 2], x[q + 3]);
      }
  };

  // A^T[s][t] = sum_c q_[t][c] k_[s][c] over the staged tiles, strictly
  // lower (s < t) for the query tile's own keys; 4 rows x 2 keys a thread
  auto build_a = [&](bool lower) {
    for (int mt = tid; mt < (kT / 4) * (kT / 2); mt += NT) {
      const int t4 = (mt / (kT / 2)) * 4, s2 = (mt % (kT / 2)) * 2;
      float a[4][2] = {};
      if (!lower || s2 < t4 + 3)        // else wholly above the diagonal
#pragma unroll 8
      for (int c = 0; c < HD; ++c) {
        const float4 q = load4(&Qt[c * P + (t4 ^ sw(c))]);
        const float2 kk =
            *reinterpret_cast<const float2*>(&Kt[c * P + (s2 ^ sw(c))]);
        const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i][0] = fmaf(qv[i], kk.x, a[i][0]);
          a[i][1] = fmaf(qv[i], kk.y, a[i][1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = s2 + e;
        float o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[i] = (!lower || s < t4 + i) ? a[i][e] : 0.f;
        *reinterpret_cast<float4*>(&At[s * P + t4]) =
            make_float4(o[0], o[1], o[2], o[3]);
      }
    }
  };

  // this thread's outputs: rows t4 .. t4 + 3, value columns j4 .. j4 + 3
  const int t4 = (tid / (VT / 4)) * 4, j4 = (tid % (VT / 4)) * 4;
  float acc[4][4] = {};
  auto add_av = [&](int send) {         // keys s < send
#pragma unroll 4
    for (int s = 0; s < send; ++s) {
      const float4 a = load4(&At[s * P + t4]);
      const float4 w = load4(&V[s * VT + j4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, vv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], vv[jj], acc[i][jj]);
    }
  };

  for (int c = tid; c < HD; c += NT) U[c] = u[(size_t)h * HD + c];

  // the cumsum of logw over the chunk's earlier tiles, per channel
  float carry[CPW];
#pragma unroll
  for (int q = 0; q < CPW; ++q) carry[q] = 0.f;
  for (int jt = 0; jt < qt; ++jt) {
    __syncthreads();
    stage(cs + jt * kT, kT, false, false);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = warp + q * NW;
      const float clw = carry[q] + warp_scan(Lt[c * P + (lane ^ sw(c))]);
      carry[q] = __shfl_sync(kFull, clw, kT - 1);
    }
  }

  // the query tile, its keys and values, and the chunk-start state
  __syncthreads();
  stage(cs + qt * kT, nq, true, true);
  {
    const float* sb = scratch + (bh * NC + ch) * HD * HD + c0;
#pragma unroll
    for (int e = tid; e < HD * (VT / 4); e += NT) {
      const int c = e / (VT / 4), jj = (e % (VT / 4)) * 4;
      *reinterpret_cast<float4*>(&St[c * VT + jj]) = load4(sb + c * HD + jj);
    }
  }
  __syncthreads();
  {
    float d = 0.f;                      // this warp's part of sum_c r u k
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = warp + q * NW;
      const int at = c * P + (lane ^ sw(c));
      const float w = Lt[at];
      const float clw = carry[q] + warp_scan(w);
      const float rr = Qt[at], kk = Kt[at];
      d = fmaf(rr, U[c] * kk, d);
      Qt[at] = rr * clip_exp(clw - w);
      Kt[at] = kk * clip_exp(-clw);
    }
    Dp[warp * kT + lane] = d;
  }
  __syncthreads();
  build_a(true);
  __syncthreads();
  add_av(t4 + 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {         // + (sum_c r u k) v
    float d = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) d += Dp[w * kT + t4 + i];
    const float4 vv = load4(&V[(t4 + i) * VT + j4]);
    acc[i][0] = fmaf(d, vv.x, acc[i][0]);
    acc[i][1] = fmaf(d, vv.y, acc[i][1]);
    acc[i][2] = fmaf(d, vv.z, acc[i][2]);
    acc[i][3] = fmaf(d, vv.w, acc[i][3]);
  }
#pragma unroll 4
  for (int c = 0; c < HD; ++c) {        // + q_ S_{c-1}
    const float4 q = load4(&Qt[c * P + (t4 ^ sw(c))]);
    const float4 s4 = load4(&St[c * VT + j4]);
    const float qv[4] = {q.x, q.y, q.z, q.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[i][jj] = fmaf(qv[i], sv[jj], acc[i][jj]);
  }

  // every earlier key tile of the chunk: A v with the full 32 x 32 A
#pragma unroll
  for (int q = 0; q < CPW; ++q) carry[q] = 0.f;
  for (int jt = 0; jt < qt; ++jt) {
    __syncthreads();
    stage(cs + jt * kT, kT, true, false);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = warp + q * NW;
      const int at = c * P + (lane ^ sw(c));
      const float clw = carry[q] + warp_scan(Lt[at]);
      Kt[at] *= clip_exp(-clw);
      carry[q] = __shfl_sync(kFull, clw, kT - 1);
    }
    __syncthreads();
    build_a(false);
    __syncthreads();
    add_av(kT);
  }

  const long long q0 = cs + qt * kT;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (t4 + i < nq)
      *reinterpret_cast<float4*>(yb + (q0 + t4 + i) * ys.s + j4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* y, float* s_out,
           float* scratch, int B, int H, int S, int C, Strides rs,
           Strides ks, Strides vs, Strides ws, Strides ys,
           cudaStream_t stream) {
  using SL = StateTile<T, HD>;
  using OL = OutTile<HD>;
  const long long gx = (long long)(S / C) * ((C + kT - 1) / kT) * OL::NV;
  if (gx > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = OL::kFloats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_out<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wkv6_state<T, HD><<<dim3(SL::TILES, H, B), SL::kThreads, 0, stream>>>(
      (const T*)k, (const T*)v, logw, s0, scratch, s_out, H, S, C, ks, vs,
      ws);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wkv6_out<T, HD><<<dim3((unsigned)gx, H, B), OL::kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, logw, u, scratch, y, H, S, C,
      rs, ks, vs, ws, ys);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* r, const void* k, const void* v,
                const float* logw, const float* u, const float* s0, float* y,
                float* s_out, float* scratch, int B, int H, int S, int C,
                Strides rs, Strides ks, Strides vs, Strides ws, Strides ys,
                cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, s0, y, s_out, scratch, B, H, S,
                           C, rs, ks, vs, ws, ys, stream);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, y, s_out, scratch, B, H, S,
                           C, rs, ks, vs, ws, ys, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, y, s_out, scratch, B, H, S,
                           C, rs, ks, vs, ws, ys, stream);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, s0, y, s_out, scratch, B, H,
                            S, C, rs, ks, vs, ws, ys, stream);
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

// r/k/v/logw/y (B, H, S, hd), each addressed by its (batch, head, row)
// element strides with a contiguous last dimension; u (H, hd), s0 and
// s_out (B, H, hd, hd) contiguous float32; scratch (B, H, S / C, hd, hd)
// float32, written before it is read. dtype 0: float32 r/k/v, 1:
// bfloat16. hd in {16, 32, 64, 128}; any C >= 1 that divides S. r, k, v,
// logw and s0 need 16-byte aligned bases and strides. Runs two kernels on
// `stream`. Returns the first CUDA error (cudaSuccess = 0),
// cudaErrorInvalidValue for a shape the kernels do not take.
int wkv6_launch(const void* r, const void* k, const void* v, const void* logw,
                const void* u, const void* s0, void* y, void* s_out,
                void* scratch, int dtype, int B, int H, int S, int hd, int C,
                long long rsb, long long rsh, long long rss, long long ksb,
                long long ksh, long long kss, long long vsb, long long vsh,
                long long vss, long long wsb, long long wsh, long long wss,
                long long ysb, long long ysh, long long yss, void* stream) {
  const Strides rs{rsb, rsh, rss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      ws{wsb, wsh, wss}, ys{ysb, ysh, yss};
  const long long es = dtype == 1 ? 2 : 4;
  if (B <= 0 || H <= 0 || S <= 0 || C <= 0 || B > 65535 || H > 65535 ||
      S % C || (dtype != 0 && dtype != 1) || !aligned16(r, es, rs) ||
      !aligned16(k, es, ks) ||
      !aligned16(v, es, vs) || !aligned16(logw, 4, ws) ||
      ((uintptr_t)s0 & 15) || !aligned16(y, 4, ys))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float *lw = (const float*)logw, *uu = (const float*)u,
              *s = (const float*)s0;
  if (dtype == 0)
    return dispatch_hd<float>(hd, r, k, v, lw, uu, s, (float*)y,
                              (float*)s_out, (float*)scratch, B, H, S, C, rs,
                              ks, vs, ws, ys, st);
  return dispatch_hd<__nv_bfloat16>(hd, r, k, v, lw, uu, s, (float*)y,
                                    (float*)s_out, (float*)scratch, B, H, S,
                                    C, rs, ks, vs, ws, ys, st);
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
