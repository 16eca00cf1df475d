// Flash-attention forward for Hopper (sm_90a): tiled online-softmax
// attention, causal or full, with grouped-query heads (query head h reads
// kv head h / G), a kv_len mask on padded keys and a q_offset that shifts
// the causal diagonal. float32 or bfloat16 in, float32 arithmetic, output
// in the input's type.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py,
// `flash_attention` (Pallas body `_fa_kernel`), reached through
// `ops.attention`.
//
// What bounds it on this card: operations. A causal (1, 32, 4096, 128)
// prefill is ~137 GFLOP against ~84 MB of q, k, v and output, far above
// the H100's ~295 FLOP per byte, so the floor is the tensor-core rate.
// This first version does not reach it: it runs on the CUDA cores in
// float32 (no mma/wgmma, no TMA), which keeps the float32 path exact to
// the reference's tolerance. A tensor-core design is later work.
//
// Design: one 256-thread block per (query tile of 64 rows, q head, batch).
// The block keeps its query tile in shared memory (transposed, float32)
// and walks the 64-key tiles up to the causal limit; a tile that lies
// wholly in the future of every query of the block is never loaded, as
// in the reference. Per tile: S = Q K^T (each thread a 4x4 micro-tile),
// masking with the reference's finite -1e30 (never -inf, so a row whose
// first tile is fully masked cannot turn into NaN), a row max and sum by
// four threads per row, the running max / denominator / rescale kept in
// shared memory, and O = alpha O + P V in registers (4 rows x hd/16
// columns per thread). The output is O / max(l, 1e-30). Rows and keys
// past S and T are masked here, so the caller pads nothing; every tensor
// is addressed through its (batch, head, row) strides with a contiguous
// last dimension, so the model's (B, S, H, hd) layout needs no transpose.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fa_fwd(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, T* __restrict__ o, int G, int S, int Tk,
       int kv_len, int q_offset, int causal, float scale, Strides qs,
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + (h / G) * ks.h;
  const T* vb = v + b * vs.b + (h / G) * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    Qs[d * (BQ + 1) + r] =
        q0 + r < S ? to_f(qb[(long long)(q0 + r) * qs.s + d]) : 0.0f;
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
      Ks[d * (BK + 1) + c] =
          in ? to_f(kb[(long long)(k0 + c) * ks.s + d]) : 0.0f;
      Vs[c * HD + d] = in ? to_f(vb[(long long)(k0 + c) * vs.s + d]) : 0.0f;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = ob + (long long)(q0 + r) * os.s;
#pragma unroll
    for (int j = 0; j < OJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int Tk, int kv_len, int q_offset,
           int causal, float scale, Strides qs, Strides ks, Strides vs,
           Strides os, cudaStream_t stream) {
  const size_t smem = Smem<HD>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  fa_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq / Hkv, S, Tk, kv_len,
      q_offset, causal, scale, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                int B, int Hq, int Hkv, int S, int Tk, int kv_len,
                int q_offset, int causal, float scale, Strides qs,
                Strides ks, Strides vs, Strides os, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, Tk, kv_len, q_offset,
                           causal, scale, qs, ks, vs, os, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, Tk, kv_len, q_offset,
                           causal, scale, qs, ks, vs, os, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, Tk, kv_len, q_offset,
                            causal, scale, qs, ks, vs, os, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hq, S, hd), k/v (B, Hkv, T, hd), o (B, Hq, S, hd), each addressed
// by its (batch, head, row) element strides with a contiguous last
// dimension. dtype 0: float32, 1: bfloat16 (all four tensors). hd in
// {32, 64, 128}; Hq a multiple of Hkv; 1 <= kv_len <= T. Returns the first
// CUDA error (cudaSuccess = 0), cudaErrorInvalidValue for a shape the
// kernel does not take.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int Hq, int Hkv, int S,
                           int T, int hd, int kv_len, int q_offset,
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
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, Hq, Hkv, S, T, kv_len,
                              q_offset, causal, scale, qs, ks, vs, os, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Hq, Hkv, S, T,
                                      kv_len, q_offset, causal, scale, qs,
                                      ks, vs, os, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
