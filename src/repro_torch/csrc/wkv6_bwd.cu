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
// What bounds it on this card: bytes. The call reads r, k, v, logw and dy
// and writes dr, dk, dv and dlogw (at (1, 4096, 64, 64), C = 32, bf16
// r/k/v: ~405 MB, ~0.12 ms at 3.35 TB/s); it also reads the forward's 134
// MB of chunk-start states and writes and reads G's 134 MB. Its ~8 hd^2 +
// 5 C hd operations a token and head (~11.8 GFLOP there) take ~0.024 ms at
// the tensor cores' 495 TFLOP/s in TF32, ~0.071 ms for the three products
// of the split below; on the CUDA cores' 67 TFLOP/s they would take ~0.18
// ms (`wkv6_bwd_flops` and `wkv6_bwd_bytes` in kernels/wkv6/wkv6.py count
// both). What bounds this design is latency: the state gradient is a
// chain of S/C steps, each a few dependent shared-memory, shuffle and
// mma.sync latencies long, and a tile block's phases (loads, scans,
// products, epilogue) follow one another with two blocks on an SM.
//
// Design: three kernels a call (four when C > 32), on one stream, every
// sum in a fixed order and no atomics, so two calls are bit-equal.
// Products run on the tensor cores as mma.sync.m16n8k8 in TF32 with
// float32 accumulators in registers (`mma3`): each operand is split into
// hi = x rounded to TF32 and lo = x - hi (of which the tensor core reads
// the TF32 part), and a product is lo.hi + hi.lo + hi.hi (3xTF32): TF32
// alone keeps ~3 decimal digits, the split ~21 bits, near float32's (the
// float32 outputs are held to 1e-4 of their largest magnitude). A
// bfloat16 v is exact in TF32, so its lo product is left out.
//  1. `wkv6_bwd_state` walks the chunks backwards and writes G of every
//     chunk to a float32 scratch of (B, H, S/C, hd, hd). A block owns a
//     16 x 32 tile of the (hd, hd) gradient (4 warps, each a 16 x 8
//     m16n8k8 tile), as K4's state pass owns one of the state: it reads
//     only its 16 channels of r and logw and its 32 columns of dy, which
//     cp.async stages per sub-tile of 32 tokens, 3 sub-tiles ahead in a
//     4-deep ring (rows padded against bank conflicts). The cumsum of
//     logw per channel is a group scan (8 lanes a channel, 4 tokens a
//     lane, joined by shuffles) that gives q_ over the sub-tile; then
//     q_^T dy is one K = 32 product a warp. At the end it writes ds0.
//  2. `wkv6_bwd_out` runs one block per 32-token tile of a chunk (any C:
//     a chunk of C > 32 tokens is several tiles), head and batch, 8 warps
//     (4 for hd < 64), two blocks an SM (one at hd 128). Its products:
//     A = strictly_lower(q_ k_^T) and dA, then dq_ = dA k_ + dy S_{c-1}^T,
//     dk_ = dA^T q_, dv = A^T dy + kd G and dkd = v G^T; a warp owns 16
//     rows and hd / 4 (hd / 2) columns of each (32, hd) product. For a
//     chunk of one tile, S_{c-1} (K4's scratch: the forward's chunk-start
//     states, not recomputed) and G are in flight by cp.async from the
//     start; r, k, v, dy and logw come in 16-byte register loads, all
//     issued before their stores. Shared arrays have rows of a multiple
//     of 32 floats and an XOR swizzle under which both m16n8k8 fragment
//     reads hit 32 banks; the (32, hd) tiles' swizzle (`atc`) also keeps
//     a column of 32 tokens conflict-free, for the cumsums (warp scans, a
//     warp per channel and a lane per token, all of a warp's channels in
//     flight together). A chunk's earlier tiles add their dA k_ to dq_,
//     its later ones their dA^T q_ and A^T dy; S and G then come after
//     them. The elementwise epilogue stays on the CUDA cores:
//     exponentials, clamp masks, the diagonals, dr, dk, dv, the tile's
//     part of du, and dlogw by one warp scan a channel over a
//     channel-major copy of decl, g2 and g3; for a chunk of several
//     tiles, the tile's sums of g3 and decl - g2.
//  3. `wkv6_bwd_fix` (only for C > 32) adds to each token's dlogw what the
//     chunk's other tiles contribute: g4 + the g3 of earlier tiles + the
//     decl - g2 of later ones.
//  4. `wkv6_bwd_du` sums du over the batch and the tiles, per head.
//
// Alignment: r, k, v, logw and dy are read in 16-byte pieces, so they need
// 16-byte aligned bases and (batch, head, row) strides, as K4's inputs do;
// the wrapper checks and raises.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kClamp = 25.0f;
constexpr int kT = 32;             // tokens of a tile
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// two outputs of a row, columns c and c + 1 (c even)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
// e^clip(x), as K4 computes it (ex2 of a pre-scaled argument)
__device__ __forceinline__ float clip_exp(float x) {
  return exp2f(fminf(fmaxf(x, -kClamp), kClamp) * 1.4426950408889634f);
}
// 1 where the clamp passes a gradient (autograd's rule for clamp), else 0
__device__ __forceinline__ float inside(float x) {
  return (x >= -kClamp && x <= kClamp) ? 1.f : 0.f;
}

// -------------------------------------- copies and TF32 products in PTX

// 16 bytes to shared memory, of which the first `bytes` (16 or 0) come
// from `gmem` and the rest are zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// d (16 x 8) += a (16 x 8, row-major fragment) b (8 x 8, column-major)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x rounded to TF32 (its 10 high mantissa bits, to
// nearest, ties away from zero, as cvt.rna rounds), lo = x - hi exactly,
// of which the tensor core reads the TF32 part (it ignores the 13 low
// bits): a product keeps ~21 bits where TF32 alone keeps ~11.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc[j] += X Y over k in [0, K) for a warp's 16 rows and NJ 8-column
// tiles, by the m16n8k8 fragments: lane l holds rows l/4 (+8) and k
// columns l%4 (+4) of A, k rows l%4 (+4) and column l/4 of B, rows l/4
// (+8) and columns 2(l%4) (+1) of D. x(m, k) and y(k, n) read X (m in
// [0, 16)) and Y (n in [0, 8 NJ)). Three TF32 products per step, in a
// fixed order: lo.hi, hi.lo, hi.hi; an operand that TF32 holds exactly
// (XT, YT: bfloat16 values) has no lo, and its product is left out.
template <int K, int NJ, bool XT = false, bool YT = false, typename FX,
          typename FY>
__device__ __forceinline__ void mma3(float (&acc)[NJ][4], FX x, FY y) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4                        // fully, it spills at hd 64
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(x(g, k0 + t), ah[0], al[0]);
    split_tf32(x(g + 8, k0 + t), ah[1], al[1]);
    split_tf32(x(g, k0 + t + 4), ah[2], al[2]);
    split_tf32(x(g + 8, k0 + t + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(y(k0 + t, 8 * j + g), bh0, bl0);
      split_tf32(y(k0 + t + 4, 8 * j + g), bh1, bl1);
      if (!XT) mma_tf32(acc[j], al, bh0, bh1);
      if (!YT) mma_tf32(acc[j], ah, bl0, bl1);
      mma_tf32(acc[j], ah, bh0, bh1);
    }
  }
}

// ------------------------------------------------------- warp reductions

// inclusive prefix sum over the lanes, in a fixed order
__device__ __forceinline__ float warp_scan(float x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}
// the sum over the lanes (the same bits in every lane)
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int d = 16; d; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

// --------------------------------------------------- pass 1: G per chunk

// The cumsum of one key channel over a sub-tile of n <= 32 tokens, by a
// group of GL lanes (GL divides 32, the group aligned within its warp), as
// K4's state pass scans: lane g of the group sums tokens g * 32 / GL ..
// (g + 1) * 32 / GL - 1 in order and the group joins its parts by a
// shuffle scan. clw[q] becomes carry + the cumsum at the lane's q-th
// token; returns the cumsum at token n - 1 (carry included) to the group.
template <int GL, typename W>
__device__ __forceinline__ float group_scan(W w_at, int n, float carry,
                                            float (&clw)[32 / GL]) {
  constexpr int M = 32 / GL;                      // tokens a lane
  const int g = threadIdx.x % GL;
  float run = 0.f;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const int t = g * M + q;
    run += t < n ? w_at(t) : 0.f;
    clw[q] = run;
  }
  float incl = run;                               // over the group's parts
#pragma unroll
  for (int d = 1; d < GL; d <<= 1) {
    const float y = __shfl_up_sync(kFull, incl, d, GL);
    if (g >= d) incl += y;
  }
  const float below = __shfl_up_sync(kFull, incl, 1, GL);
  const float base = g ? below : 0.f;
#pragma unroll
  for (int q = 0; q < M; ++q) clw[q] = carry + (base + clw[q]);
  return __shfl_sync(kFull, carry + (base + run), (n - 1) / M, GL);
}

template <typename T, int HD>
struct GradTile {
  static constexpr int KR = 16;                   // key rows of a tile
  static constexpr int VC = HD < 32 ? HD : 32;    // value columns
  static constexpr int kThreads = 32 * (VC / 8);  // a warp per 16 x 8
  static constexpr int TILES = (HD / KR) * (HD / VC);
  static constexpr int NS = 4;                    // cp.async ring depth
  static constexpr int GL = kThreads / KR;        // lanes of a channel
  static constexpr int E = 16 / sizeof(T);        // r elements per 16 bytes
  static constexpr int KP = KR / E, LP = KR / 4, VP = VC / 4;  // pieces/row
  // staged rows, padded by 16 bytes (r, logw) or 32 (dy, q_) against bank
  // conflicts: the B fragment reads 4 rows x 8 columns of dy, the A
  // fragment 4 rows x 8 channels of q_
  static constexpr int RS = KR + E, LS = KR + 4, YS = VC + 8, QS = KR + 8;
};

template <typename T, int HD>
__global__ void __launch_bounds__(GradTile<T, HD>::kThreads)
wkv6_bwd_state(const T* __restrict__ r, const float* __restrict__ logw,
               const float* __restrict__ dy, const float* __restrict__ ds,
               float* __restrict__ gscratch, float* __restrict__ ds0, int H,
               int S, int C, Strides rs, Strides ws, Strides gs) {
  using L = GradTile<T, HD>;
  constexpr int KR = L::KR, VC = L::VC, NT = L::kThreads, NS = L::NS;
  constexpr int RS = L::RS, LS = L::LS, YS = L::YS, QS = L::QS, E = L::E;
  constexpr int GL = L::GL, M = 32 / GL;
  __shared__ __align__(16) T Rb[NS * kT * RS];    // NS sub-tiles of r,
  __shared__ __align__(16) float Lb[NS * kT * LS];  // logw
  __shared__ __align__(16) float Yb[NS * kT * YS];  // and dy
  __shared__ float Qs[kT * QS];                   // q_ of the sub-tile
  __shared__ float Et[KR];                        // e^clip(total) a channel

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = (blockIdx.x / (HD / VC)) * KR;   // first key row
  const int c0 = (blockIdx.x % (HD / VC)) * VC;   // first value column
  const T* rb = r + b * rs.b + h * rs.h + r0;
  const float* wb = logw + b * ws.b + h * ws.h + r0;
  const float* gb = dy + b * gs.b + h * gs.h + c0;
  const size_t bh = (size_t)b * H + h;
  const int NC = S / C, per = (C + kT - 1) / kT, NG = NC * per;

  // this warp's 16 x 8 of the tile, in the m16n8k8 D layout: key rows i
  // and i + 8, value columns j and j + 1
  const int i = lane >> 2, j = 8 * warp + 2 * (lane & 3);
  const size_t at0 = (size_t)(r0 + i) * HD + c0 + j, at1 = at0 + 8 * HD;
  float g[4] = {0.f, 0.f, 0.f, 0.f};
  if (ds != nullptr) {
    const float* d = ds + bh * HD * HD;
    g[0] = d[at0], g[1] = d[at0 + 1], g[2] = d[at1], g[3] = d[at1 + 1];
  }
  float acc[1][4] = {};
  // the scan: a group of GL lanes owns key channel sc of the tile
  const int sc = tid / GL;
  float carry = 0.f;

  // sub-tile s: chunk NC - 1 - s / per (the chunks backwards), its
  // sub-tiles in token order; dy's rows past the chunk are zeros
  auto load = [&](int s) {
    const int buf = s % NS, sub = s % per, nt = min(kT, C - sub * kT);
    const long long t0 = (long long)(NC - 1 - s / per) * C + sub * kT;
    for (int p = tid; p < nt * L::KP; p += NT) {
      const int t = p / L::KP, q = (p % L::KP) * E;
      cp_async16(&Rb[(buf * kT + t) * RS + q], rb + (t0 + t) * rs.s + q, 16);
    }
    for (int p = tid; p < nt * L::LP; p += NT) {
      const int t = p / L::LP, q = (p % L::LP) * 4;
      cp_async16(&Lb[(buf * kT + t) * LS + q], wb + (t0 + t) * ws.s + q,
                 16);
    }
    for (int p = tid; p < kT * L::VP; p += NT) {
      const int t = p / L::VP, q = (p % L::VP) * 4;
      const bool on = t < nt;
      cp_async16(&Yb[(buf * kT + t) * YS + q],
                 on ? gb + (t0 + t) * gs.s + q : gb, on ? 16 : 0);
    }
  };
  // the tile's part of G (or of ds0) out
  auto store = [&](float* out) {
    *reinterpret_cast<float2*>(out + at0) = make_float2(g[0], g[1]);
    *reinterpret_cast<float2*>(out + at1) = make_float2(g[2], g[3]);
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {    // NS - 1 sub-tiles in flight
    if (s < NG) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < NG; ++s) {
    const int buf = s % NS, sub = s % per, ch = NC - 1 - s / per;
    const int nt = min(kT, C - sub * kT);
    cp_async_wait<NS - 2>();
    __syncthreads();                    // sub-tile s landed, s - 1 consumed
    if (s + NS - 1 < NG) load(s + NS - 1);
    cp_async_commit();                  // an empty group keeps the count
    if (sub == 0) {                     // chunk ch starts: its G out
      store(gscratch + (bh * NC + ch) * HD * HD);
      acc[0][0] = acc[0][1] = acc[0][2] = acc[0][3] = 0.f;
      carry = 0.f;
    }
    {                                   // q_ = r e^clip(ecl), channel sc
      const float* lw = Lb + buf * kT * LS;
      const T* rr = Rb + buf * kT * RS;
      float clw[M];
      carry = group_scan<GL>([&](int t) { return lw[t * LS + sc]; }, nt,
                             carry, clw);
#pragma unroll
      for (int q = 0; q < M; ++q) {
        const int t = (tid % GL) * M + q;
        Qs[t * QS + sc] = t < nt ? to_f(rr[t * RS + sc]) *
                                       clip_exp(clw[q] - lw[t * LS + sc])
                                 : 0.f;
      }
      if (sub == per - 1 && tid % GL == 0) Et[sc] = clip_exp(carry);
    }
    __syncthreads();                    // q_ of every channel
    const float* yy = Yb + buf * kT * YS;   // acc += q_^T dy, tensor cores
    mma3<kT, 1>(acc, [&](int m, int k) { return Qs[k * QS + m]; },
                [&](int k, int n) { return yy[k * YS + 8 * warp + n]; });
    if (sub == per - 1) {               // G <- e^clip(total) G + q_^T dy
      const float e0 = Et[i], e1 = Et[i + 8];
      g[0] = fmaf(e0, g[0], acc[0][0]);
      g[1] = fmaf(e0, g[1], acc[0][1]);
      g[2] = fmaf(e1, g[2], acc[0][2]);
      g[3] = fmaf(e1, g[3], acc[0][3]);
    }
  }
  cp_async_wait<0>();
  store(ds0 + bh * HD * HD);
}

// ---------------------------------------------- pass 2: a tile's grads

// Shared (rows, cols) float arrays have rows of P floats, P a multiple of
// 32, and hold element (row, col) at row * P + (col ^ swizzle(row)); both
// swizzles spread the m16n8k8 fragment reads over the 32 banks: rows
// r0 + l/4 and columns c0 + l%4 (A, and B from an (n, k) array) as well
// as rows k0 + l%4 and columns n0 + l/4 (B from a (k, n) array, and A
// read transposed), for r0, c0, k0, n0 multiples of 8 (c0 of 4).
// `at` (rows 0..7 into column bits 2..4) keeps aligned groups of 4 columns
// whole and in order, for 16-byte copies (S_{c-1}, G) and pairs (A, dA).
// `atc` also moves row bits 3..4 into column bits 0..1, so that a column
// of 32 rows (a lane per token) hits 32 banks too; its 16-byte stores
// permute their 4 values (`put4`). The (32, hd) tiles use `atc`.
__device__ __forceinline__ int sw(int row) {
  return ((row & 3) << 3) | (row & 4);
}
template <int P>
__device__ __forceinline__ int at(int row, int col) {
  return row * P + (col ^ sw(row));
}
template <int P>
__device__ __forceinline__ int atc(int row, int col) {
  return row * P + (col ^ sw(row) ^ ((row >> 3) & 3));
}
// columns c .. c + 3 (c a multiple of 4) of row t of an `atc` array
template <int P>
__device__ __forceinline__ void put4(float* A, int t, int c, float x0,
                                     float x1, float x2, float x3) {
  const int b = (t >> 3) & 3;           // slot j holds column c + (j ^ b)
  if (b & 1) {
    const float y0 = x0, y2 = x2;
    x0 = x1, x1 = y0, x2 = x3, x3 = y2;
  }
  if (b & 2) {
    const float y0 = x0, y1 = x1;
    x0 = x2, x1 = x3, x2 = y0, x3 = y1;
  }
  *reinterpret_cast<float4*>(&A[at<P>(t, c)]) = make_float4(x0, x1, x2, x3);
}
// decl, g2 and g3 channel-major: (channel c, token t) at c * 32 + (t ^
// f(c)), f a permutation of c's 5 low bits, free of bank conflicts for the
// fragments' stores, a lane per token and a lane per channel
__device__ __forceinline__ int atd(int c, int t) {
  return c * kT + (t ^ ((((c >> 1) & 3) << 3) | ((c & 1) << 2) |
                        ((c >> 3) & 3)));
}

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int HD>
struct OutTile {
  static constexpr int NW = HD >= 64 ? 8 : 4;      // warps
  static constexpr int kThreads = 32 * NW;
  static constexpr int P = HD < 32 ? 32 : HD;      // row of a (., hd) array
  static constexpr int TILE = kT * P;              // a (32, hd) array
  static constexpr int NJ = HD / (4 * NW);         // n8 tiles a warp owns of
  static constexpr int NJA = 8 / NW;               // a (32, hd), (32, 32) D
  static constexpr int CPW = HD / NW;              // channels a warp scans
  static constexpr int NSB = HD >= 128 ? 1 : 2;    // states staged at once
  // the region of S_{c-1} and G, or of another tile (3 arrays), or of the
  // channel-major decl, g2 and g3
  static constexpr int SR = cmax(cmax(NSB * HD * P, 3 * TILE), 3 * HD * kT);
  // shared-memory layout, in floats
  static constexpr int kR = 0, kK = TILE, kV = 2 * TILE, kDY = 3 * TILE,
                       kW = 4 * TILE, kCLW = 5 * TILE, kQ = 6 * TILE,
                       kKm = 7 * TILE, kM = 8 * TILE, kDM = kM + kT * kT,
                       kSR = kDM + kT * kT, kU = kSR + SR, kTot = kU + HD,
                       kG4 = kTot + HD, kDD = kG4 + HD, kDG = kDD + kT,
                       kFloats = kDG + kT;
};

// Tokens [t0, t0 + nn) of NA sequences (rows ss apart; float32 or
// bfloat16, widened) into `atc` tiles, zeros past nn: all of a thread's
// 16-byte loads are issued before its stores.
template <int NT, int HD, int P, int NA, typename S>
__device__ __forceinline__ void stage(float* const (&dst)[NA],
                                      const S* const (&src)[NA],
                                      const long long (&ss)[NA],
                                      long long t0, int nn) {
  constexpr int E = 16 / sizeof(S), N = kT * HD / E, IT = (N + NT - 1) / NT;
  uint4 w[NA][IT];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int q = 0; q < IT; ++q) {
      const int e = threadIdx.x + q * NT;
      const int t = e / (HD / E), c = (e % (HD / E)) * E;
      w[a][q] = make_uint4(0u, 0u, 0u, 0u);
      if (e < N && t < nn)
        w[a][q] = *reinterpret_cast<const uint4*>(src[a] + (t0 + t) * ss[a] +
                                                  c);
    }
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int q = 0; q < IT; ++q) {
      const int e = threadIdx.x + q * NT;
      const int t = e / (HD / E), c = (e % (HD / E)) * E;
      if (e >= N) continue;
      const S* x = reinterpret_cast<const S*>(&w[a][q]);
#pragma unroll
      for (int i = 0; i < E; i += 4)
        put4<P>(dst[a], t, c + i, to_f(x[i]), to_f(x[i + 1]),
                to_f(x[i + 2]), to_f(x[i + 3]));
    }
}

template <typename T, int HD>
__global__ void __launch_bounds__(OutTile<HD>::kThreads, HD >= 128 ? 1 : 2)
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
  constexpr int NT = L::kThreads, NW = L::NW, P = L::P, NJ = L::NJ;
  constexpr int NJA = L::NJA, CPW = L::CPW, NSB = L::NSB;
  constexpr bool kExact = sizeof(T) == 2;         // bfloat16 v is TF32-exact
  extern __shared__ __align__(16) float sm[];
  float* R = sm + L::kR;                          // the (32, hd) tiles, `atc`
  float* K = sm + L::kK;
  float* V = sm + L::kV;
  float* DY = sm + L::kDY;
  float* W = sm + L::kW;
  float* CLW = sm + L::kCLW;
  float* Q = sm + L::kQ;                          // q_, then kd
  float* Km = sm + L::kKm;                        // k_
  float* M = sm + L::kM;                          // A (32 x 32), `at`
  float* DM = sm + L::kDM;                        // dA
  float* Ss = sm + L::kSR;                        // S_{c-1}, `at`
  float* Gs = Ss + (NSB == 2 ? HD * P : 0);       // G
  float* Xo = sm + L::kSR;                        // another tile: k_ or q_,
  float* Wo = Xo + L::TILE;                       //   its logw,
  float* Yo = Wo + L::TILE;                       //   its v or dy
  float* DEC = sm + L::kSR;                       // decl, g2, g3: `atd`
  float* G2 = DEC + HD * kT;
  float* G3 = G2 + HD * kT;
  float* U = sm + L::kU;
  float* Tot = sm + L::kTot;
  float* G4 = sm + L::kG4;
  float* DD = sm + L::kDD;                        // ddiag = sum_j dy v
  float* DG = sm + L::kDG;                        // diag = sum_c r u k

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;        // fragment row, column
  const int m0 = (warp & 1) * 16;                 // the warp's 16 rows,
  const int n0 = (warp >> 1) * NJ * 8;            // columns of a (32, hd) D
  const int a0 = (warp >> 1) * NJA * 8;           // and of a (32, 32) D
  const int h = blockIdx.y, b = blockIdx.z;
  const int TPC = (C + kT - 1) / kT, NC = S / C;
  const int ch = blockIdx.x / TPC, qt = blockIdx.x % TPC;
  const long long cs = (long long)ch * C;         // chunk start
  const long long row0 = cs + qt * kT;            // the tile's first token
  const int n = min(kT, C - qt * kT);
  const size_t bh = (size_t)b * H + h;
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* wb = logw + b * ws.b + h * ws.h;
  const float* gb = dy + b * gs.b + h * gs.h;
  const float* sp = starts + (bh * NC + ch) * HD * HD;   // S_{c-1}
  const float* gg = gscratch + (bh * NC + ch) * HD * HD; // G
  const bool pre = TPC == 1;            // S (and G) in flight from the start

  // (hd, hd) float32 state rows into an `at` array by cp.async
  auto load_state = [&](float* dst, const float* src) {
    for (int e = tid; e < HD * HD / 4; e += NT) {
      const int row = e / (HD / 4), c = (e % (HD / 4)) * 4;
      cp_async16(&dst[at<P>(row, c)], src + (size_t)row * HD + c, 16);
    }
  };
  // The cumsum of logw over a tile, a warp per channel (CPW of them, all
  // scans in flight together) and a lane per token, carried from tile to
  // tile in `carry`: w and clw of (token lane, channel warp + q NW).
  float carry[CPW];
#pragma unroll
  for (int q = 0; q < CPW; ++q) carry[q] = 0.f;
  auto scan = [&](const float* Wt, float (&w)[CPW], float (&clw)[CPW]) {
#pragma unroll
    for (int q = 0; q < CPW; ++q) w[q] = Wt[atc<P>(lane, warp + q * NW)];
#pragma unroll
    for (int q = 0; q < CPW; ++q) clw[q] = carry[q] + warp_scan(w[q]);
#pragma unroll
    for (int q = 0; q < CPW; ++q)
      carry[q] = __shfl_sync(kFull, clw[q], kT - 1);
  };
  // X <- X e^clip(clw - w) (`query`: q_) or X e^clip(-clw) (k_) over a
  // tile whose logw is Wt
  auto decay = [&](const float* Wt, float* X, bool query) {
    float w[CPW], clw[CPW], x[CPW];
    scan(Wt, w, clw);
#pragma unroll
    for (int q = 0; q < CPW; ++q) x[q] = X[atc<P>(lane, warp + q * NW)];
#pragma unroll
    for (int q = 0; q < CPW; ++q)
      X[atc<P>(lane, warp + q * NW)] =
          x[q] * clip_exp(query ? clw[q] - w[q] : -clw[q]);
  };
  // D (32 x 32, `at`) = X Y^T over the head dim, X and Y (32, hd) tiles,
  // strictly lower (column < row) when `lower`; Y TF32-exact when `yt`
  auto product32 = [&](float* D, const float* X, const float* Y, bool lower,
                       bool yt) {
    float acc[NJA][4] = {};
    auto xa = [&](int m, int kk) { return X[atc<P>(m0 + m, kk)]; };
    auto ya = [&](int kk, int nn) { return Y[atc<P>(a0 + nn, kk)]; };
    if (!lower || a0 < m0 + 16) {       // else wholly above the diagonal
      if (yt) mma3<HD, NJA, false, true>(acc, xa, ya);
      else mma3<HD, NJA>(acc, xa, ya);
    }
#pragma unroll
    for (int jj = 0; jj < NJA; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + gq + 8 * hh, col = a0 + 8 * jj + 2 * tq;
        float x0 = acc[jj][2 * hh], x1 = acc[jj][2 * hh + 1];
        if (lower) {
          if (col >= row) x0 = 0.f;
          if (col + 1 >= row) x1 = 0.f;
        }
        *reinterpret_cast<float2*>(&D[at<kT>(row, col)]) =
            make_float2(x0, x1);
      }
  };

  // this warp's fragments of dq_, dk_, dv and dkd: rows m0.., columns n0..
  float aq[NJ][4] = {}, ak[NJ][4] = {}, av[NJ][4] = {}, akd[NJ][4] = {};

  // for a chunk of one tile its S_{c-1} and G, then the own tile
  if (pre) {
    load_state(Ss, sp);
    cp_async_commit();
    if constexpr (NSB == 2) {
      load_state(Gs, gg);
      cp_async_commit();
    }
  }
  stage<NT, HD, P, 2>({W, DY}, {wb, gb}, {ws.s, gs.s}, row0, n);
  stage<NT, HD, P, 3>({R, K, V}, {rb, kb, vb}, {rs.s, ks.s, vs.s}, row0, n);
  for (int c = tid; c < HD; c += NT) U[c] = u[(size_t)h * HD + c];
  __syncthreads();

  // the chunk's earlier tiles: dq_ += dA k_ over all of their keys
  for (int jt = 0; jt < qt; ++jt) {
    const long long t0 = cs + jt * kT;
    if (jt) __syncthreads();            // the previous tile is consumed
    stage<NT, HD, P, 1>({Wo}, {wb}, {ws.s}, t0, kT);
    stage<NT, HD, P, 2>({Xo, Yo}, {kb, vb}, {ks.s, vs.s}, t0, kT);
    __syncthreads();
    decay(Wo, Xo, false);                            // k_
    product32(DM, DY, Yo, false, kExact);            // dA
    __syncthreads();
    mma3<kT, NJ>(aq, [&](int m, int kk) { return DM[at<kT>(m0 + m, kk)]; },
                 [&](int kk, int nn) { return Xo[atc<P>(kk, n0 + nn)]; });
  }

  // the own tile: q_, k_, the diagonals, the strictly lower A and dA
  {
    float w[CPW], clw[CPW], rr[CPW], kk[CPW];
    scan(W, w, clw);
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int e = atc<P>(lane, warp + q * NW);
      rr[q] = R[e];
      kk[q] = K[e];
    }
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int e = atc<P>(lane, warp + q * NW);
      CLW[e] = clw[q];
      Q[e] = rr[q] * clip_exp(clw[q] - w[q]);
      Km[e] = kk[q] * clip_exp(-clw[q]);
    }
  }
  {                                     // a warp per token
    constexpr int TPW = kT / NW, CPL = (HD + 31) / 32;
    float dg[TPW], dd[TPW];
#pragma unroll
    for (int p = 0; p < TPW; ++p) {
      const int t = warp + p * NW;
      dg[p] = dd[p] = 0.f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int c = lane + 32 * q;
        if (c < HD) {
          const int e = atc<P>(t, c);
          dg[p] = fmaf(R[e], U[c] * K[e], dg[p]);
          dd[p] = fmaf(DY[e], V[e], dd[p]);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < TPW; ++p) {
      dg[p] = warp_sum(dg[p]);
      dd[p] = warp_sum(dd[p]);
    }
    if (lane == 0)
#pragma unroll
      for (int p = 0; p < TPW; ++p) {
        DG[warp + p * NW] = dg[p];
        DD[warp + p * NW] = dd[p];
      }
  }
  __syncthreads();
  product32(M, Q, Km, true, false);               // A
  product32(DM, DY, V, true, kExact);             // dA
  __syncthreads();
  mma3<kT, NJ>(aq, [&](int m, int kk) { return DM[at<kT>(m0 + m, kk)]; },
               [&](int kk, int nn) { return Km[atc<P>(kk, n0 + nn)]; });
  mma3<kT, NJ>(ak, [&](int m, int kk) { return DM[at<kT>(kk, m0 + m)]; },
               [&](int kk, int nn) { return Q[atc<P>(kk, n0 + nn)]; });
  mma3<kT, NJ>(av, [&](int m, int kk) { return M[at<kT>(kk, m0 + m)]; },
               [&](int kk, int nn) { return DY[atc<P>(kk, n0 + nn)]; });

  // dq_ += dy S_{c-1}^T
  if (pre) {
    if constexpr (NSB == 2) cp_async_wait<1>();
    else cp_async_wait<0>();
  } else {
    __syncthreads();                    // the other tiles' region is free
    load_state(Ss, sp);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  mma3<HD, NJ>(aq, [&](int m, int kk) { return DY[atc<P>(m0 + m, kk)]; },
               [&](int kk, int nn) { return Ss[at<P>(n0 + nn, kk)]; });

  // the chunk's later tiles: dk_ += dA^T q_, dv += A^T dy
  for (int jt = qt + 1; jt < TPC; ++jt) {
    const long long t0 = cs + jt * kT;
    const int no = min(kT, C - jt * kT);
    __syncthreads();                    // S or the previous tile consumed
    stage<NT, HD, P, 2>({Wo, Yo}, {wb, gb}, {ws.s, gs.s}, t0, no);
    stage<NT, HD, P, 1>({Xo}, {rb}, {rs.s}, t0, no);
    __syncthreads();
    decay(Wo, Xo, true);                             // q_
    product32(DM, Yo, V, false, kExact);             // dA (rows: later)
    __syncthreads();
    product32(M, Xo, Km, false, false);              // A (rows: later)
    __syncthreads();
    mma3<kT, NJ>(ak, [&](int m, int kk) { return DM[at<kT>(kk, m0 + m)]; },
                 [&](int kk, int nn) { return Xo[atc<P>(kk, n0 + nn)]; });
    mma3<kT, NJ>(av, [&](int m, int kk) { return M[at<kT>(kk, m0 + m)]; },
                 [&](int kk, int nn) { return Yo[atc<P>(kk, n0 + nn)]; });
  }

  // the chunk's total, and kd = k e^clip(total - clw) in q_'s place
  __syncthreads();
  float* KD = Q;
  {
    float kk[CPW], clw[CPW];
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int e = atc<P>(lane, warp + q * NW);
      kk[q] = K[e];
      clw[q] = CLW[e];
    }
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      KD[atc<P>(lane, warp + q * NW)] = kk[q] * clip_exp(carry[q] - clw[q]);
      if (lane == 0) Tot[warp + q * NW] = carry[q];
    }
  }
  const bool g_pre = pre && NSB == 2;
  if (g_pre) {
    cp_async_wait<0>();
  } else {                              // S and the tiles are consumed
    load_state(Gs, gg);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  // dkd = v G^T, dv += kd G
  mma3<HD, NJ, kExact>(
      akd, [&](int m, int kk) { return V[atc<P>(m0 + m, kk)]; },
      [&](int kk, int nn) { return Gs[at<P>(n0 + nn, kk)]; });
  mma3<HD, NJ>(av, [&](int m, int kk) { return KD[atc<P>(m0 + m, kk)]; },
               [&](int kk, int nn) { return Gs[at<P>(kk, n0 + nn)]; });
  if (TPC == 1 || qt == 0) {            // g4 = E4 sum_j G S_{c-1}, a warp
    constexpr int CPL = (HD + 31) / 32;  // per channel
    float x[CPW];
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = warp + q * NW;
      x[q] = 0.f;
#pragma unroll
      for (int p = 0; p < CPL; ++p) {
        const int jj = lane + 32 * p;
        if (jj < HD) {
          const float s = g_pre ? Ss[at<P>(c, jj)] : sp[(size_t)c * HD + jj];
          x[q] = fmaf(Gs[at<P>(c, jj)], s, x[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < CPW; ++q) x[q] = warp_sum(x[q]);
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < CPW; ++q)
        G4[warp + q * NW] = x[q] * clip_exp(carry[q]) * inside(carry[q]);
  }
  __syncthreads();                      // the products are done

  // dr, dk, dv out of the fragments; decl, g2, g3 channel-major
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int t = m0 + gq + 8 * hh, c = n0 + 8 * jj + 2 * tq;
      float gr[2], gk[2], gv[2], dec[2], g2[2], g3[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int e = atc<P>(t, c + x), f = 2 * hh + x, cc = c + x;
        const float clw = CLW[e], tot = Tot[cc], ecl = clw - W[e];
        const float e1 = clip_exp(ecl), e2 = clip_exp(-clw);
        const float e3 = clip_exp(tot - clw);
        const float rr = R[e], kk = K[e], dd = DD[t] * U[cc];
        gr[x] = fmaf(dd, kk, aq[jj][f] * e1);
        gk[x] = fmaf(dd, rr, fmaf(ak[jj][f], e2, akd[jj][f] * e3));
        gv[x] = fmaf(DG[t], DY[e], av[jj][f]);
        dec[x] = aq[jj][f] * (rr * e1) * inside(ecl);
        g2[x] = ak[jj][f] * (kk * e2) * inside(-clw);
        g3[x] = akd[jj][f] * (kk * e3) * inside(tot - clw);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int e = atd(c + x, t);
        DEC[e] = dec[x];
        G2[e] = g2[x];
        G3[e] = g3[x];
      }
      if (t < n) {
        const long long row = row0 + t;
        store2(dr + b * drs.b + h * drs.h + row * drs.s + c, gr[0], gr[1]);
        store2(dk + b * dks.b + h * dks.h + row * dks.s + c, gk[0], gk[1]);
        store2(dv + b * dvs.b + h * dvs.h + row * dvs.s + c, gv[0], gv[1]);
      }
    }
  __syncthreads();

  // dlogw, a warp per channel and a lane per token: g4 + the g3 before +
  // the decl after - the g2 from here on; du's part of the tile
  {
    const size_t tile = bh * (size_t)(NC * TPC) + blockIdx.x;
    const float ddl = DD[lane];
    float x3[CPW], xd[CPW], x2[CPW], rk[CPW];
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = warp + q * NW, e = atd(c, lane);
      const int te = atc<P>(lane, c);
      x3[q] = G3[e];
      xd[q] = DEC[e];
      x2[q] = G2[e];
      rk[q] = R[te] * K[te];
    }
    // with T = sum_t (decl - g2) over the tile, dlogw[t] = T - decl[t] +
    // sum_{t' < t} (g3 + g2 - decl) [+ g4]: one scan and one sum
    float pre[CPW], rest[CPW], du[CPW], all3[CPW];
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      pre[q] = warp_scan(x3[q] + x2[q] - xd[q]);
      rest[q] = warp_sum(xd[q] - x2[q]);
      du[q] = warp_sum(ddl * rk[q]);
      all3[q] = TPC > 1 ? warp_sum(x3[q]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
      const int c = warp + q * NW;
      const float up = __shfl_up_sync(kFull, pre[q], 1);
      const float x = (rest[q] - xd[q]) + (lane ? up : 0.f);
      DEC[atd(c, lane)] = TPC == 1 ? x + G4[c] : x;
      if (lane == 0) {
        dupart[tile * HD + c] = du[q];
        if (TPC > 1) {
          tsum[(tile * 2) * HD + c] = all3[q];
          tsum[(tile * 2 + 1) * HD + c] = rest[q];
          if (qt == 0) g4buf[(bh * NC + ch) * HD + c] = G4[c];
        }
      }
    }
  }
  __syncthreads();
  float* out = dw + b * dws.b + h * dws.h + row0 * dws.s;
  for (int e = tid; e < n * HD; e += NT) {
    const int t = e / HD, c = e % HD;
    out[t * dws.s + c] = DEC[atd(c, t)];
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
  using GL = GradTile<T, HD>;
  using OL = OutTile<HD>;
  const int TPC = (a.C + kT - 1) / kT, NC = a.S / a.C;
  const long long tiles = (long long)NC * TPC;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = OL::kFloats * sizeof(float);
  // all of the SM's unified cache as shared memory: two tile blocks (one
  // at hd 128) or four state blocks to an SM
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_bwd_out<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv6_bwd_out<T, HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wkv6_bwd_state<T, HD>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
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
// 128}; any C >= 1 that divides S. starts, gscratch and ds0 need 16-byte
// aligned bases; r, k, v, logw and dy 16-byte aligned bases and strides.
// Runs three kernels on `stream` (four for C > 32). Returns the first CUDA
// error (cudaSuccess = 0), cudaErrorInvalidValue for a shape or pointer
// the kernels do not take.
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
      !aligned16(dr, es, a.drs) || !aligned16(dk, es, a.dks) ||
      !aligned16(dv, es, a.dvs) || !aligned16(dw, 4, a.dws) ||
      ((uintptr_t)starts & 15) || ((uintptr_t)gscratch & 15) ||
      ((uintptr_t)ds0 & 15) ||
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
