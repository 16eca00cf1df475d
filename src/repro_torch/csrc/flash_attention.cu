// Flash-attention forward for Hopper (sm_90a): tiled online-softmax
// attention, causal or full, with grouped-query heads (query head h reads
// kv head h / G), a kv_len mask on padded keys and a q_offset that shifts
// the causal diagonal. Output in the input's type.
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
// landed; empty: both consumers done), and gives most of its registers to
// the consumers (setmaxnreg). Warpgroups 1 and 2 each own 64 query rows:
// S = Q K^T by wgmma (m64n128k16, both operands from shared memory, fp32
// accumulate), the online softmax in registers (row max and sum across
// each quad of lanes with shuffles, exp2 of log2e-scaled scores), P
// rounded to bf16 in registers and fed as wgmma's A operand for
// O += P V (V from shared memory, MN-major). The reference keeps P in
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
// Both kernels write each row's natural log-sum-exp of the scaled, masked
// scores (m + log l, float32, (B, Hq, S) contiguous) when given a non-null
// `lse`: the backward (flash_attention_bwd.cu) rebuilds P from it. Serving
// passes null and the epilogue skips the store.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

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
            int q_offset, int causal, float scale, Strides qs, Strides ks,
            Strides vs, Strides os) {
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
  // a key no later than the block's last query
  int nk = (kv_len + BK - 1) / BK;
  if (causal) {
    const long long last = (long long)q_offset + q0 + BQ - 1;
    const long long lim = last < 0 ? 0 : last / BK + 1;
    if (lim < nk) nk = (int)lim;
  }

  float acc[4][OJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OJ; ++j) acc[i][j] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
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
  __syncthreads();                   // l_s is final (also when nk == 0)
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
                int q_offset, int causal, float scale, Strides qs, Strides ks,
                Strides vs, Strides os, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_simt<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  fa_fwd_simt<HD><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
      Hq / Hkv, S, Tk, kv_len, q_offset, causal, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

// ============================================ bfloat16, wgmma + TMA

namespace tc {

constexpr int BM = 128;            // query rows per block, 64 per consumer
constexpr int TK = 128;            // keys per tile
constexpr int kStages = 2;
constexpr int kBlock = 384;        // producer + two consumer warpgroups
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // 168 on average

template <int HD>
struct Cfg {
  static constexpr int ATOM_B = HD * 2 >= 128 ? 128 : HD * 2;  // swizzle
  static constexpr int AC = ATOM_B / 2;          // hd columns per atom
  static constexpr int NA = HD / AC;             // atoms along hd
  static constexpr int KPA = ATOM_B / 32;        // k16 steps per atom
  static constexpr uint64_t LAYOUT = ATOM_B == 128 ? 1 : 2;  // B128 / B64
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = TK * HD * 2;
  static constexpr int SMEM = Q_BYTES + 2 * kStages * KV_BYTES + 1024 + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A wait of more
// than ~2^34 cycles (seconds) can only be a fault: it traps, so the launch
// fails instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (!t0) t0 = clock64();
    else if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// One TMA box of a 4-D (hd, rows, heads, batch) tensor into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t mat_desc(uint32_t addr, uint32_t lbo,
                                             uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 32, fp32) += A (64 x 16, bf16 pairs in registers) . B (16 x 32);
// B MN-major in shared memory (descriptor db, transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) . B (16 x 64);
// B MN-major in shared memory (descriptor db, transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) {=, +=} A (64 x 16) . B (16 x 128); A and B K-major
// in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 pairs in registers) . B (16 x 128);
// B MN-major in shared memory (descriptor db, transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The wgmma accumulator layout (m64nN, fp32): warp w of the warpgroup
// holds rows 16w..16w+15; lane l holds rows r = l/4 and r + 8, and for
// every 8-column chunk i the columns 8i + 2(l%4) + {0, 1}: element
// 4i + 2*half + e is (row r + 8*half, column 8i + 2(l%4) + e). The same
// layout, packed in bf16 pairs, is wgmma's A fragment for one k16 step
// per two chunks, so P goes from S to the P.V product without a shuffle.
template <int HD>
__global__ void __launch_bounds__(kBlock, 1)
fa_fwd_tc(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
          Strides os, int G, int S, int kv_len, int q_offset, int causal,
          float scale_log2) {
  using C = Cfg<HD>;
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
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;   // longest first
  int nk = (kv_len + TK - 1) / TK;
  if (causal) {
    const long long last = (long long)q_offset + q0 + BM - 1;
    const long long lim = last < 0 ? 0 : last / TK + 1;
    if (lim < nk) nk = (int)lim;
  }

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full + s, 1);
      bar_init(v_full + s, 1);
      bar_init(empty + s, 8);                      // the consumers' warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
      for (int a = 0; a < C::NA; ++a)
        tma_load(sQ + a * BM * C::ATOM_B, &tq, a * C::AC, q0, h, b, q_full);
      for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        if (j >= kStages) bar_wait(empty + s, (j / kStages - 1) & 1);
        uint8_t* kd = sK + s * C::KV_BYTES;
        uint8_t* vd = sV + s * C::KV_BYTES;
        bar_expect_tx(k_full + s, C::KV_BYTES);
        for (int a = 0; a < C::NA; ++a)
          tma_load(kd + a * TK * C::ATOM_B, &tk, a * C::AC, j * TK, hk, b,
                   k_full + s);
        bar_expect_tx(v_full + s, C::KV_BYTES);
        for (int a = 0; a < C::NA; ++a)
          tma_load(vd + a * TK * C::ATOM_B, &tv, a * C::AC, j * TK, hk, b,
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
    const long long pos_lo = (long long)q_offset + q0 + r_lo;
    const long long first_pos = (long long)q_offset + q0 + 64 * w;
    const int cq = 2 * (lane % 4);

    float oacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.0f;
    float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;

    const uint32_t q_addr = smem_u32(sQ) + w * 64 * C::ATOM_B;
    const uint32_t sbo = 8 * C::ATOM_B;
    bar_wait(q_full, 0);

    for (int j = 0; j < nk; ++j) {
      const int s = j % kStages, ph = (j / kStages) & 1;
      const uint32_t k_addr = smem_u32(sK + s * C::KV_BYTES);
      const uint32_t v_addr = smem_u32(sV + s * C::KV_BYTES);

      // S = Q K^T over hd in k16 steps
      float sacc[TK / 2];
      bar_wait(k_full + s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % C::KPA) * 32;  // 16 bf16 along hd
        const uint64_t da = mat_desc(
            q_addr + (kk / C::KPA) * BM * C::ATOM_B + off, 16, sbo,
            C::LAYOUT);
        const uint64_t db = mat_desc(
            k_addr + (kk / C::KPA) * TK * C::ATOM_B + off, 16, sbo,
            C::LAYOUT);
        wgmma_ss(sacc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // mask, then the online softmax (log2 domain) on the two rows
      const int k0 = j * TK;
      const bool masked = k0 + TK > kv_len ||
                          (causal && (long long)k0 + TK - 1 > first_pos);
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
            if (pad || (causal && kpos > pos_lo)) x_lo = kNegInf;
            if (pad || (causal && kpos > pos_lo + 8)) x_hi = kNegInf;
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
      const float al_lo = exp2f(m_lo - mn_lo), al_hi = exp2f(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
      for (int i = 0; i < TK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p_lo = exp2f(sacc[4 * i + e] - mn_lo);
          const float p_hi = exp2f(sacc[4 * i + 2 + e] - mn_hi);
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

      // P in bf16, as wgmma A fragments: one k16 step per two chunks
      uint32_t pa[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        oacc[4 * i + 0] *= al_lo;
        oacc[4 * i + 1] *= al_lo;
        oacc[4 * i + 2] *= al_hi;
        oacc[4 * i + 3] *= al_hi;
      }

      // O += P V over the tile's keys in k16 steps
      bar_wait(v_full + s, ph);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint64_t db = mat_desc(v_addr + kk * 16 * C::ATOM_B,
                                     TK * C::ATOM_B, sbo, C::LAYOUT);
        wgmma_rs(oacc, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oacc);
      if (lane == 0) bar_arrive(empty + s);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (hd, rows, heads, batch) bf16 map over a strided tensor; boxes of
// (AC columns, box_rows rows) with the atom's swizzle; rows past `rows`
// read as zeros.
template <int HD>
bool make_map(CUtensorMap* map, const void* base, int rows, int heads,
              int batch, Strides st, int box_rows) {
  using C = Cfg<HD>;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::AC, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(base), dims, strides, box, estr,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     C::ATOM_B == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Hq, int Hkv, int S, int T, int kv_len, int q_offset,
           int causal, float scale, Strides qs, Strides ks, Strides vs,
           Strides os, cudaStream_t stream) {
  if (!encode_fn()) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map<HD>(&tq, q, S, Hq, B, qs, BM) ||
      !make_map<HD>(&tk, k, T, Hkv, B, ks, TK) ||
      !make_map<HD>(&tv, v, T, Hkv, B, vs, TK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<HD>::SMEM);
  if (e != cudaSuccess) return (int)e;
  // setmaxnreg moves registers between the warpgroups: the consumers'
  // raise waits forever unless the block started with the 168 per thread
  // that the producer's and consumers' counts add up to
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, fa_fwd_tc<HD>);
  if (e != cudaSuccess) return (int)e;
  if (attr.numRegs * kBlock < kProducerRegs * 128 + kConsumerRegs * 256)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(Hq, B, (S + BM - 1) / BM);
  const float scale_log2 = (float)((double)scale * 1.4426950408889634);
  fa_fwd_tc<HD><<<grid, kBlock, Cfg<HD>::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, os, Hq / Hkv, S, kv_len,
      q_offset, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace tc

template <bool BF16, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Hq, int Hkv, int S, int T, int kv_len,
              int q_offset, int causal, float scale, Strides qs, Strides ks,
              Strides vs, Strides os, cudaStream_t stream) {
  if constexpr (BF16)
    return tc::launch<HD>(q, k, v, o, lse, B, Hq, Hkv, S, T, kv_len,
                          q_offset, causal, scale, qs, ks, vs, os, stream);
  else
    return launch_simt<HD>(q, k, v, o, lse, B, Hq, Hkv, S, T, kv_len,
                           q_offset, causal, scale, qs, ks, vs, os, stream);
}

template <bool BF16>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Hq, int Hkv, int S, int T, int kv_len,
                int q_offset, int causal, float scale, Strides qs,
                Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<BF16, 32>(q, k, v, o, lse, B, Hq, Hkv, S, T,
                                 kv_len, q_offset, causal, scale, qs, ks, vs,
                                 os, stream);
    case 64:
      return launch_hd<BF16, 64>(q, k, v, o, lse, B, Hq, Hkv, S, T,
                                 kv_len, q_offset, causal, scale, qs, ks, vs,
                                 os, stream);
    case 128:
      return launch_hd<BF16, 128>(q, k, v, o, lse, B, Hq, Hkv, S, T,
                                  kv_len, q_offset, causal, scale, qs, ks, vs,
                                  os, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, S, hd), k/v (B, Hkv, T, hd), o (B, Hq, S, hd), each addressed
// by its (batch, head, row) element strides with a contiguous last
// dimension; lse null or a contiguous float32 (B, Hq, S) that receives
// each row's log-sum-exp. dtype 0: float32, 1: bfloat16 (all four tensors;
// bfloat16 needs 16-byte aligned base addresses and row/head/batch strides,
// which TMA reads). hd in {32, 64, 128}; Hq a multiple of Hkv;
// 1 <= kv_len <= T.
// Returns the first CUDA error (cudaSuccess = 0), cudaErrorInvalidValue
// for a shape or layout the kernel does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int dtype, int B, int Hq,
                           int Hkv, int S, int T, int hd, int kv_len,
                           int q_offset,
                           int causal, float scale, long long qsb,
                           long long qsh, long long qss, long long ksb,
                           long long ksh, long long kss, long long vsb,
                           long long vsh, long long vss, long long osb,
                           long long osh, long long oss, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv || S <= 0 || T <= 0 ||
      kv_len <= 0 || kv_len > T || B > 65535 || Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 0)
    return dispatch_hd<false>(hd, q, k, v, o, l, B, Hq, Hkv, S, T, kv_len,
                              q_offset, causal, scale, qs, ks, vs, os, s);
  if (dtype == 1) {
    for (const void* p : {q, k, v, (const void*)o})
      if (reinterpret_cast<uintptr_t>(p) % 16)
        return (int)cudaErrorInvalidValue;
    for (long long st : {qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss})
      if ((st * 2) % 16) return (int)cudaErrorInvalidValue;
    if ((S + tc::BM - 1) / tc::BM > 65535) return (int)cudaErrorInvalidValue;
    return dispatch_hd<true>(hd, q, k, v, o, l, B, Hq, Hkv, S, T, kv_len,
                             q_offset, causal, scale, qs, ks, vs, os, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
