// Flash-attention forward for Hopper (sm_90a): tiled online-softmax
// attention, causal or full, with grouped-query heads (query head h reads
// kv head h / G), a kv_len mask on padded keys, a q_offset that shifts
// the causal diagonal and, when window > 0, a sliding window: query
// position p (= q_offset + row) sees keys k with p - window < k <= p,
// the JAX package's `local_attention` mask. Output in the input's type.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// `flash_attention` (Pallas body `_fa_kernel`), reached through
// `ops.attention`.
//
// What bounds it on this card: operations. A causal (1, 32, 4096, 128)
// prefill is ~137 GFLOP against ~84 MB of q, k, v and output, far above
// the H100's ~295 FLOP per byte, so the floor is the tensor-core rate
// (989 TFLOP/s bf16).
//
// Two kernels, chosen by dtype:
//
// bfloat16 (the model's compute dtype): `fa_fwd_tc`, on the tensor cores.
// One block per (128 query rows, q head, batch), 384 threads in three
// warpgroups. Warpgroup 0 is the producer: one thread loads the query
// tile once and then each 128-key tile of K and of V with TMA into a
// 2-stage ring of shared-memory buffers guarded by mbarriers (full: bytes
// landed; empty, one for K and one for V: both consumers done with it),
// and gives most of its registers to the consumers (setmaxnreg).
// Warpgroups 1 and 2 each own 64 query rows: S = Q K^T by wgmma
// (m64n128k16, both operands from shared memory, fp32 accumulate), the
// online softmax in registers (row max and sum across each quad of lanes
// with shuffles, exp2 of log2e-scaled scores), P rounded to bf16 in
// registers and fed as wgmma's A operand for O += P V (V from shared
// memory, MN-major). The consumers' schedule puts the softmax beside the
// tensor cores' work, in the shape of FlashAttention-3:
//  - within a consumer, tile j's S_j = Q K_j^T and the tile before's
//    O += P_{j-1} V_{j-1} are issued together, and the softmax of S_j runs
//    while P_{j-1} V_{j-1} is still on the tensor cores (one S accumulator,
//    P of the tile before in its A fragments: O, S and P take 128 + 32 +
//    16 registers a thread at hd 256 under setmaxnreg 240, the producer
//    keeping 24; O's rescale by alpha_j follows the softmax of tile j and
//    is skipped where every alpha of the warp is exactly 1);
//  - across the two consumers, ping-pong: they take turns to issue their
//    products (two named barriers), so that one's products run while the
//    other runs its softmax and the O rescale, instead of both at once.
// Each row's operations are those of the tiles one after another in the
// same order (O_j = alpha_j O_{j-1} + P_j V_j), so the schedule changes no
// bit of the output. The reference keeps P in
// float32; rounding it to bf16 is the rounding the JAX package's XLA
// model path makes. The masking is the reference's: the finite -1e30 on
// keys at or past kv_len and in the causal future, and O / max(l, 1e-30)
// at the end. Key tiles wholly in the causal future are never loaded, and
// the query tiles of a head are issued last-first, so the longest causal
// blocks start in the first wave. TMA reads q, k and v through their
// (batch, head, row) strides (the model's (B, S, H, hd) layout needs no
// transpose); rows past S and T arrive zero-filled and are masked here.
// hd 64 and 128 use the 128-byte swizzle (hd 128 as two 64-column
// atoms), hd 32 the 64-byte swizzle.
//
// float32: `fa_fwd_simt`, on the CUDA cores, exact to the reference's
// 2e-5 (a bf16 P could not hold it). One 256-thread block per (64 query
// rows, q head, batch); per 64-key tile S = Q K^T as 4x4 micro-tiles from
// shared memory, the softmax by four lanes per row, O += P V in registers.
//
// The window: key tiles wholly before the block's first query row's window
// are never loaded (the work is O(S window), not O(S^2)), and keys at or
// before p - window get the same -1e30 as the causal future. Head dims 32,
// 64, 128 and 256 (recurrentgemma-9b's local attention). At hd 256 the
// tensor-core kernel takes 64-key tiles (Q 64 KB, a 2-stage ring of K and V
// 128 KB of shared memory; O as a 64 x 256 accumulator, 128 registers a
// consumer thread, by m64n256k16; S by m64n64k16). There the S product
// reads both operands from shared memory at about the rate shared memory
// gives (4 KB every 32 tensor-core cycles), and the two consumers' turns
// keep one consumer's softmax off the other's products.
//
// Both kernels write each row's natural log-sum-exp of the scaled, masked
// scores (m + log l, float32, (B, Hq, S) contiguous) when given a non-null
// `lse`: the backward (flash_attention_bwd.cu) rebuilds P from it. Serving
// passes null and the epilogue skips the store.
#include <climits>
#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// The first key tile (of `tile` keys) a block whose first query position
// is `first_pos` must visit under a window (0: none): the tile holding key
// first_pos - window + 1; at most `nk`, the tile count it visits otherwise.
__host__ __device__ __forceinline__ int first_tile(long long first_pos,
                                                   int window, int tile,
                                                   int nk) {
  if (window <= 0) return 0;
  const long long first_key = first_pos - window + 1;
  if (first_key <= 0) return 0;
  const long long t = first_key / tile;
  return t < nk ? (int)t : nk;
}

// ===================================================== float32, CUDA cores

constexpr int BQ = 64, BK = 64, kThreads = 256;

// shared-memory layout, in floats
template <int HD>
struct Smem {
  static constexpr int QS = HD * (BQ + 1);   // Qs[d][row]
  static constexpr int KS = HD * (BK + 1);   // Ks[d][key]
  static constexpr int VS = BK * HD;         // Vs[key][d]
  static constexpr int PS = BQ * (BK + 1);   // Ps[row][key]
  static constexpr size_t bytes =
      sizeof(float) * (QS + KS + VS + PS + 3 * BQ);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o,
            float* __restrict__ lse, int G, int S, int Tk, int kv_len,
            int q_offset, int causal, int window, float scale, Strides qs,
            Strides ks, Strides vs, Strides os) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int OJ = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + Smem<HD>::QS;
  float* Vs = Ks + Smem<HD>::KS;
  float* Ps = Vs + Smem<HD>::VS;
  float* m_s = Ps + Smem<HD>::PS;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + (h / G) * ks.h;
  const float* vb = v + b * vs.b + (h / G) * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    Qs[d * (BQ + 1) + r] = q0 + r < S ? qb[(long long)(q0 + r) * qs.s + d]
                                      : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.0f;
  }

  // key tiles to visit: those holding a key below kv_len and, when causal,
  // a key no later than the block's last query; with a window, from the
  // tile holding the first key of the block's first query's window
  int nk = (kv_len + BK - 1) / BK;
  if (causal) {
    const long long last = (long long)q_offset + q0 + BQ - 1;
    const long long lim = last < 0 ? 0 : last / BK + 1;
    if (lim < nk) nk = (int)lim;
  }
  const int kt0 = first_tile((long long)q_offset + q0, window, BK, nk);

  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.0f;

  for (int kt = kt0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const bool in = k0 + c < Tk;
      Ks[d * (BK + 1) + c] = in ? kb[(long long)(k0 + c) * ks.s + d] : 0.0f;
      Vs[c * HD + d] = in ? vb[(long long)(k0 + c) * vs.s + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[d * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j, kpos = k0 + c;
        bool live = kpos < kv_len;
        if (causal) live = live && (long long)kpos <=
                                       (long long)q_offset + q0 + r;
        if (window > 0)
          live = live && (long long)kpos > (long long)q_offset + q0 + r -
                                               window;
        Ps[r * (BK + 1) + c] = live ? s[i][j] * scale : kNegInf;
      }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row, 16 keys each
      const int r = tid / 4, part = tid % 4;
      float* pr = Ps + r * (BK + 1) + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < OJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = Vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();                   // l_s is final (also with no tile)
  if (lse != nullptr && tid < BQ && q0 + tid < S)
    lse[((long long)b * gridDim.y + h) * S + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    float* orow = ob + (long long)(q0 + r) * os.s;
#pragma unroll
    for (int j = 0; j < OJ; ++j) orow[tx + 16 * j] = acc[i][j] / l;
  }
}

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int S, int Tk, int kv_len,
                int q_offset, int causal, int window, float scale, Strides qs,
                Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_simt<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  fa_fwd_simt<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
      Hq / Hkv, S, Tk, kv_len, q_offset, causal, window, scale, qs, ks, vs,
      os);
  return (int)cudaGetLastError();
}

// ============================================ bfloat16, wgmma + TMA

namespace tc {

using namespace hopper;

constexpr int BM = 128;            // query rows per block, 64 per consumer
constexpr int kStages = 2;
constexpr int kBlock = 384;        // producer + two consumer warpgroups
constexpr int kProducerRegs = 24, kConsumerRegs = 240;   // 168 on average
constexpr int kTurn = 1;           // named barriers kTurn + consumer: its turn
constexpr int kBars = 1 + 4 * kStages;   // q_full, k/v full, k/v empty

template <int HD>
struct Cfg : Atom<HD> {
  static constexpr int TK = HD >= 256 ? 64 : 128;   // keys per tile
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = TK * HD * 2;
  static constexpr int SMEM =
      Q_BYTES + 2 * kStages * KV_BYTES + 1024 + 8 * kBars;
};

// O *= alpha, row by row: the thread's rows r (alpha lo) and r + 8 (hi)
template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], float lo, float hi) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    o[4 * i + 0] *= lo;
    o[4 * i + 1] *= lo;
    o[4 * i + 2] *= hi;
    o[4 * i + 3] *= hi;
  }
}

// 2^x for P. At hd 256 the bare special-function instruction (ex2.approx
// with denormal results flushed): exp2f is the same instruction with a
// fixup of arguments below -126 (a compare and two predicated products an
// element), where P is a denormal that it keeps and this flushes to 0.
// The other head dims keep exp2f, and their bits.
template <int HD>
__device__ __forceinline__ float exp2_p(float x) {
  if constexpr (HD >= 256) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
  } else {
    return exp2f(x);
  }
}

// wgmma_wait<0> spelled a second way, so that the compiler keeps one in
// each arm of a branch rather than one above it
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0; // all\n" ::: "memory");
}

// P goes from the S accumulators to the P.V product's A operand without a
// shuffle (the accumulator layout is the A-fragment layout: hopper.cuh).
template <int HD>
__global__ void __launch_bounds__(kBlock, 1)
fa_fwd_tc(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
          Strides os, int G, int S, int kv_len, int q_offset, int causal,
          int window, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int TK = C::TK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;                              // [NA][BM][AC]
  uint8_t* sK = sQ + C::Q_BYTES;                   // [stage][NA][TK][AC]
  uint8_t* sV = sK + kStages * C::KV_BYTES;        // [stage][NA][TK][AC]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* k_empty = bars + 1 + 2 * kStages;
  uint64_t* v_empty = bars + 1 + 3 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;   // longest first
  int nk = (kv_len + TK - 1) / TK;
  if (causal) {
    const long long last = (long long)q_offset + q0 + BM - 1;
    const long long lim = last < 0 ? 0 : last / TK + 1;
    if (lim < nk) nk = (int)lim;
  }
  const int j0 = first_tile((long long)q_offset + q0, window, TK, nk);

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full + s, 1);
      bar_init(v_full + s, 1);
      bar_init(k_empty + s, 8);                    // the consumers' warps
      bar_init(v_empty + s, 8);
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
      bar_expect_tx(q_full, C::Q_BYTES);
      tma_tile<HD>(sQ, &tq, BM, q0, h, b, q_full);
      for (int j = j0; j < nk; ++j) {
        const int it = j - j0, s = it % kStages;
        if (it >= kStages) bar_wait(k_empty + s, (it / kStages - 1) & 1);
        bar_expect_tx(k_full + s, C::KV_BYTES);
        tma_tile<HD>(sK + s * C::KV_BYTES, &tk, TK, j * TK, hk, b,
                     k_full + s);
        if (it >= kStages) bar_wait(v_empty + s, (it / kStages - 1) & 1);
        bar_expect_tx(v_full + s, C::KV_BYTES);
        tma_tile<HD>(sV + s * C::KV_BYTES, &tv, TK, j * TK, hk, b,
                     v_full + s);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     kConsumerRegs));
    const int w = wg - 1;                          // rows 64w .. 64w + 63
    const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
    const int r_lo = 64 * w + 16 * warp + lane / 4;  // and r_lo + 8
    // positions in 32 bits: the launcher keeps q_offset + S + BM below 2^31
    const int pos_lo = q_offset + q0 + r_lo;
    const int first_pos = q_offset + q0 + 64 * w;
    const int last_pos = first_pos + 63;
    const int cq = 2 * (lane % 4);

    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;
    // P of the tile before, as the P.V product's A fragments, and its
    // alpha (the factor O takes before that product)
    uint32_t pa[TK / 16][4];
    float al_lo = 1.0f, al_hi = 1.0f;

    // Ping-pong: the consumers take turns to issue their products, the
    // first consumer first, so that one's products run on the tensor cores
    // while the other runs its softmax. Each syncs on its own turn barrier
    // and arrives at the other's once a tile; the second consumer's first
    // arrival opens the first turn and it skips its last, so every arrival
    // is waited for.
    const int ntiles = nk - j0;                    // the same for both
    if (w == 1 && ntiles > 0) named_arrive(kTurn, 256);

    const uint32_t q_addr = smem_u32(sQ) + w * 64 * C::ATOM_B;
    bar_wait(q_full, 0);

    // S = Q K^T over hd in k16 steps, from the K tile at k_addr
    auto issue_s = [&](float (&sacc)[TK / 2], uint32_t k_addr) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(sacc, desc_kmajor<HD>(q_addr, BM, kk),
                 desc_kmajor<HD>(k_addr, TK, kk), kk > 0);
      wgmma_commit();
    };
    // O += P V over the tile's keys in k16 steps, from the V tile at v_addr
    auto issue_pv = [&](uint32_t v_addr) {
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs(oacc, pa[kk], desc_mnmajor<HD>(v_addr, TK, kk));
      wgmma_commit();
    };
    // Tile j's mask, then the online softmax (log2 domain) on the two rows:
    // m and l updated, alpha kept, the scores overwritten with P.
    auto softmax = [&](float (&sacc)[TK / 2], int j) {
      const int k0 = j * TK;
      const bool masked = k0 + TK > kv_len ||
                          (causal && k0 + TK - 1 > first_pos) ||
                          (window > 0 && k0 <= last_pos - window);
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x_lo = sacc[4 * i + e] * scale_log2;
          float x_hi = sacc[4 * i + 2 + e] * scale_log2;
          if (masked) {
            const int kpos = k0 + 8 * i + cq + e;
            const bool pad = kpos >= kv_len;
            if (pad || (causal && kpos > pos_lo) ||
                (window > 0 && kpos <= pos_lo - window))
              x_lo = kNegInf;
            if (pad || (causal && kpos > pos_lo + 8) ||
                (window > 0 && kpos <= pos_lo + 8 - window))
              x_hi = kNegInf;
          }
          sacc[4 * i + e] = x_lo;
          sacc[4 * i + 2 + e] = x_hi;
          mx_lo = fmaxf(mx_lo, x_lo);
          mx_hi = fmaxf(mx_hi, x_hi);
        }
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      al_lo = exp2f(m_lo - mn_lo);
      al_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p_lo = exp2_p<HD>(sacc[4 * i + e] - mn_lo);
          const float p_hi = exp2_p<HD>(sacc[4 * i + 2 + e] - mn_hi);
          sacc[4 * i + e] = p_lo;
          sacc[4 * i + 2 + e] = p_hi;
          sum_lo += p_lo;
          sum_hi += p_hi;
        }
      }
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
      l_lo = al_lo * l_lo + sum_lo;
      l_hi = al_hi * l_hi + sum_hi;
    };

    // Tile j (j > j0): S_j = Q K_j^T and, behind it, O += P_{j-1} V_{j-1}
    // are issued in one turn; the softmax of S_j runs while P_{j-1} V_{j-1}
    // is still on the tensor cores. Every row's operations are those of one
    // tile after another (O_{j-1} = alpha_{j-1} O_{j-2} + P_{j-1} V_{j-1}),
    // in the same order, so the output's bits do not depend on the overlap.
    // The first tile (S only) and the last P.V stand outside the loop, so
    // that its body is straight-line code: ptxas then follows which
    // products each wgmma wait retires, instead of injecting waits of its
    // own (and serialising the products).
    if (ntiles > 0) {
      {                                            // tile j0: S_j0 only
        float sacc[TK / 2];
        bar_wait(k_full, 0);
        named_sync(kTurn + w, 256);
        wgmma_fence();
        issue_s(sacc, smem_u32(sK));
        if (w == 0 || ntiles > 1) named_arrive(kTurn + 1 - w, 256);
        wgmma_wait<0>();
        fence_regs(sacc);
        if (lane == 0) bar_arrive(k_empty);
        softmax(sacc, j0);
        to_a_frags(pa, sacc);
      }
      for (int j = j0 + 1; j < nk; ++j) {
        const int it = j - j0, s = it % kStages, ph = (it / kStages) & 1;
        const int sp = (it - 1) % kStages, php = ((it - 1) / kStages) & 1;
        bar_wait(v_full + sp, php);
        bar_wait(k_full + s, ph);
        float sacc[TK / 2];
        named_sync(kTurn + w, 256);
        wgmma_fence();
        issue_s(sacc, smem_u32(sK + s * C::KV_BYTES));
        issue_pv(smem_u32(sV + sp * C::KV_BYTES));
        if (w == 0 || it + 1 < ntiles) named_arrive(kTurn + 1 - w, 256);
        wgmma_wait<1>();                           // S_j; P.V in flight
        fence_regs(sacc);
        softmax(sacc, j);
        if (lane == 0) bar_arrive(k_empty + s);
        // O_{j-1} = O after P_{j-1} V_{j-1}, times alpha_j before P_j V_j
        // is issued. The wait for P_{j-1} V_{j-1} stands in the two arms of
        // a branch on alpha_j: ptxas moves a wgmma wait to the top of its
        // basic block, and in the softmax's block it would come before the
        // exponentials. An alpha of exactly 1 (the rows' maxima unchanged,
        // as in most tiles after the first) leaves O as it is bit for bit,
        // so that arm skips the products. The branch is the warp's (a wgmma
        // wait is executed by the whole warp together): a lane of alpha 1
        // in a warp that rescales multiplies by 1, which changes no bit.
        if (__all_sync(0xffffffffu, al_lo == 1.0f && al_hi == 1.0f)) {
          wgmma_wait<0>();
        } else {
          wgmma_wait_all();
          fence_regs(oacc);
          rescale(oacc, al_lo, al_hi);
        }
        fence_regs(oacc);
        fence_regs(pa);
        if (lane == 0) bar_arrive(v_empty + sp);
        // P in bf16, as wgmma A fragments: one k16 step per two chunks
        to_a_frags(pa, sacc);
      }
      // O += P_last V_last (O already scaled by its alpha; after tile j0
      // alone O is 0, which its alpha leaves 0)
      const int it = ntiles - 1, s = it % kStages;
      bar_wait(v_full + s, (it / kStages) & 1);
      wgmma_fence();
      issue_pv(smem_u32(sV + s * C::KV_BYTES));
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pa);
    }

    // O / max(l, 1e-30), written in bf16 through the output's strides
    const float den[2] = {fmaxf(l_lo, 1e-30f), fmaxf(l_hi, 1e-30f)};
    __nv_bfloat16* ob = o + b * os.b + h * os.h;
    if (lse != nullptr && (lane & 3) == 0) {
      // the row's log-sum-exp in natural units: (m + log2 l) ln 2
      const float m2[2] = {m_lo, m_hi};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + r_lo + 8 * half;
        if (row < S)
          lse[((long long)b * gridDim.x + h) * S + row] =
              (m2[half] + log2f(den[half])) * 0.6931471805599453f;
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r_lo + 8 * half;
      if (row >= S) continue;
      __nv_bfloat16* orow = ob + (long long)row * os.s + cq;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            oacc[4 * i + 2 * half] / den[half],
            oacc[4 * i + 2 * half + 1] / den[half]);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) = v2;
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int S, int T, int kv_len, int q_offset,
           int causal, int window, float scale, Strides qs, Strides ks,
           Strides vs, Strides os, cudaStream_t stream) {
  if (!encode_fn()) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map<HD>(&tq, q, S, Hq, B, qs, BM) ||
      !make_map<HD>(&tk, k, T, Hkv, B, ks, Cfg<HD>::TK) ||
      !make_map<HD>(&tv, v, T, Hkv, B, vs, Cfg<HD>::TK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<HD>::SMEM);
  if (e != cudaSuccess) return (int)e;
  // the block must start with the 168 registers a thread that the
  // producer's and consumers' setmaxnreg counts add up to
  e = check_regs(fa_fwd_tc<HD>, kBlock, kProducerRegs, kConsumerRegs);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, B, (S + BM - 1) / BM);
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  fa_fwd_tc<HD><<<grid, kBlock, Cfg<HD>::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, os, Hq / Hkv, S, kv_len,
      q_offset, causal, window, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <bool BF16, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Hq, int Hkv, int S, int T, int kv_len,
              int q_offset, int causal, int window, float scale, Strides qs,
              Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  if constexpr (BF16)
    return tc::launch<HD>(q, k, v, o, lse, B, Hq, Hkv, S, T, kv_len,
                          q_offset, causal, window, scale, qs, ks, vs, os,
                          stream);
  else
    return launch_simt<HD>(q, k, v, o, lse, B, Hq, Hkv, S, T, kv_len,
                           q_offset, causal, window, scale, qs, ks, vs, os,
                           stream);
}

template <bool BF16>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int S, int T, int kv_len,
                int q_offset, int causal, int window, float scale, Strides qs,
                Strides ks, Strides vs, Strides os, cudaStream_t stream) {
#define FA_CASE(HD)                                                        \
  case HD:                                                                 \
    return launch_hd<BF16, HD>(q, k, v, o, lse, B, Hq, Hkv, S, T, kv_len,  \
                               q_offset, causal, window, scale, qs, ks, vs, \
                               os, stream);
  switch (hd) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// q (B, Hq, S, hd), k/v (B, Hkv, T, hd), o (B, Hq, S, hd), each addressed
// by its (batch, head, row) element strides with a contiguous last
// dimension; lse null or a contiguous float32 (B, Hq, S) that receives
// each row's log-sum-exp. dtype 0: float32, 1: bfloat16 (all four tensors;
// bfloat16 needs 16-byte aligned base addresses and row/head/batch strides,
// which TMA reads). hd in {32, 64, 128, 256}; Hq a multiple of Hkv;
// 1 <= kv_len <= T; window 0 (none) or the sliding window's length, which
// needs causal.
// Returns the first CUDA error (cudaSuccess = 0), cudaErrorInvalidValue
// for a shape or layout the kernel does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int dtype, int B, int Hq,
                           int Hkv, int S, int T, int hd, int kv_len,
                           int q_offset, int causal, int window,
                           float scale, long long qsb,
                           long long qsh, long long qss, long long ksb,
                           long long ksh, long long kss, long long vsb,
                           long long vsh, long long vss, long long osb,
                           long long osh, long long oss, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || T <= 0 ||
      kv_len <= 0 || kv_len > T || B > 65535 || Hq > 65535 || window < 0 ||
      (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 0)
    return dispatch_hd<false>(hd, q, k, v, o, l, B, Hq, Hkv, S, T, kv_len,
                              q_offset, causal, window, scale, qs, ks, vs, os,
                              s);
  if (dtype == 1) {
    for (const void* p : {q, k, v, (const void*)o})
      if (reinterpret_cast<uintptr_t>(p) % 16)
        return (int)cudaErrorInvalidValue;
    for (long long st : {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss})
      if ((st * 2) % 16) return (int)cudaErrorInvalidValue;
    if ((S + tc::BM - 1) / tc::BM > 65535 ||
        (long long)q_offset + S + tc::BM > INT_MAX)
      return (int)cudaErrorInvalidValue;
    return dispatch_hd<true>(hd, q, k, v, o, l, B, Hq, Hkv, S, T, kv_len,
                             q_offset, causal, window, scale, qs, ks, vs, os,
                             s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
