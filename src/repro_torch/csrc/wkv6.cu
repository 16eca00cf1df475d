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
// What bounds it on this card: the two bounds are close. The inputs are
// read once and y written once (~120 MB for (1, 2048, 64, 64) with
// bfloat16 r/k/v: ~0.036 ms at 3.35 TB/s), and the work is ~4 hd^2 + 2 C
// hd float32 operations per token and head (~2.75 GFLOP there: ~0.041 ms
// on the CUDA cores' 67 TFLOP/s; tensor-core TF32 would change the
// numbers). The chunks of one head are sequential, so the real limit of
// this first version is the latency of that chain, not either bound.
//
// Design: one 256-thread block per (value-column slice of VB = 32, head,
// batch), walking the chunks in order. Splitting the value columns is
// exact: column j of the state and of y depends on column j of v alone, so
// the slices never talk; it doubles the blocks at hd 64 (128 on 132 SMs
// for rwkv6-7b at batch 1) at the price of recomputing A per slice. The
// state slice (hd x VB float32) lives in shared memory for the whole
// call; the chunk's r, k, logw (C x hd, rows padded by one float against
// bank conflicts) and v slice are staged in shared memory, turned in place
// into q_, k_, clw and k e^(total - clw), and A goes through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kClamp = 25.0f;

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, -kClamp), kClamp));
}

template <int HD>
struct Layout {
  static constexpr int VB = HD < 32 ? HD : 32;   // value columns per block
  static constexpr int P = HD + 1;               // padded row of a C x HD
  // shared floats for a chunk of C tokens
  static size_t floats(int C) {
    return 4 * (size_t)C * P + (size_t)C * VB + (size_t)C * (C + 1) +
           (size_t)HD * VB + C + 2 * HD;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ logw,
         const float* __restrict__ u, const float* __restrict__ s0,
         float* __restrict__ y, float* __restrict__ s_out, int H, int S,
         int C, Strides rs, Strides ks, Strides vs, Strides ws, Strides ys) {
  using L = Layout<HD>;
  constexpr int VB = L::VB, P = L::P;
  extern __shared__ float sm[];
  float* Rq = sm;                 // r, then q_
  float* Kk = Rq + C * P;         // k, then k_
  float* Kd = Kk + C * P;         // k e^(total - clw)
  float* Lw = Kd + C * P;         // logw, then clw
  float* Vv = Lw + C * P;         // C x VB value slice
  float* A = Vv + C * VB;         // C x (C + 1)
  float* St = A + C * (C + 1);    // HD x VB state slice
  float* Dg = St + HD * VB;       // C: sum_c r u k
  float* U = Dg + C;              // HD: bonus u of this head
  float* Et = U + HD;             // HD: e^clip(total)

  const int tid = threadIdx.x;
  const int v0 = blockIdx.x * VB, h = blockIdx.y, b = blockIdx.z;
  const T* rb = r + b * rs.b + h * rs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* wb = logw + b * ws.b + h * ws.h;
  float* yb = y + b * ys.b + h * ys.h;
  const size_t sbase = ((size_t)b * H + h) * HD * HD;

  for (int i = tid; i < HD * VB; i += kThreads) {
    const int c = i / VB, j = i % VB;
    St[i] = s0[sbase + (size_t)c * HD + v0 + j];
  }
  for (int c = tid; c < HD; c += kThreads) U[c] = u[(size_t)h * HD + c];

  for (int t0 = 0; t0 < S; t0 += C) {
    __syncthreads();               // the previous chunk is consumed
    for (int i = tid; i < C * HD; i += kThreads) {
      const int t = i / HD, c = i % HD;
      const long long row = t0 + t;
      Rq[t * P + c] = to_f(rb[row * rs.s + c]);
      Kk[t * P + c] = to_f(kb[row * ks.s + c]);
      Lw[t * P + c] = wb[row * ws.s + c];
    }
    for (int i = tid; i < C * VB; i += kThreads) {
      const int t = i / VB, j = i % VB;
      Vv[i] = to_f(vb[(long long)(t0 + t) * vs.s + v0 + j]);
    }
    __syncthreads();

    // the u bonus on the diagonal, from the raw r and k
    for (int t = tid; t < C; t += kThreads) {
      float d = 0.0f;
      for (int c = 0; c < HD; ++c)
        d = fmaf(Rq[t * P + c], U[c] * Kk[t * P + c], d);
      Dg[t] = d;
    }
    __syncthreads();

    // per channel: clw by a running sum, then q_, k_ and the decayed keys
    for (int c = tid; c < HD; c += kThreads) {
      float run = 0.0f;
      for (int t = 0; t < C; ++t) {
        const float w = Lw[t * P + c];
        run += w;
        Lw[t * P + c] = run;
        Rq[t * P + c] *= clip_exp(run - w);
      }
      const float total = run;
      Et[c] = clip_exp(total);
      for (int t = 0; t < C; ++t) {
        const float cl = Lw[t * P + c], kv = Kk[t * P + c];
        Kd[t * P + c] = kv * clip_exp(total - cl);
        Kk[t * P + c] = kv * clip_exp(-cl);
      }
    }
    __syncthreads();

    // A = strictly lower (q_ k_^T)
    for (int i = tid; i < C * C; i += kThreads) {
      const int t = i / C, s = i % C;
      float a = 0.0f;
      if (s < t)
        for (int c = 0; c < HD; ++c)
          a = fmaf(Rq[t * P + c], Kk[s * P + c], a);
      A[t * (C + 1) + s] = a;
    }
    __syncthreads();

    // y = A v + diag v + q_ S, for this block's value columns
    for (int i = tid; i < C * VB; i += kThreads) {
      const int t = i / VB, j = i % VB;
      float acc = 0.0f;
      for (int s = 0; s < t; ++s)
        acc = fmaf(A[t * (C + 1) + s], Vv[s * VB + j], acc);
      acc += Dg[t] * Vv[t * VB + j];
      float qs = 0.0f;
      for (int c = 0; c < HD; ++c) qs = fmaf(Rq[t * P + c], St[c * VB + j], qs);
      yb[(long long)(t0 + t) * ys.s + v0 + j] = acc + qs;
    }
    __syncthreads();               // every read of the old state is done

    // S <- e^clip(total) S + (k e^clip(total - clw))^T v
    for (int i = tid; i < HD * VB; i += kThreads) {
      const int c = i / VB, j = i % VB;
      float acc = 0.0f;
      for (int s = 0; s < C; ++s) acc = fmaf(Kd[s * P + c], Vv[s * VB + j], acc);
      St[i] = Et[c] * St[i] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < HD * VB; i += kThreads) {
    const int c = i / VB, j = i % VB;
    s_out[sbase + (size_t)c * HD + v0 + j] = St[i];
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int H, int S, int C, Strides rs, Strides ks, Strides vs,
           Strides ws, Strides ys, cudaStream_t stream) {
  using L = Layout<HD>;
  const size_t smem = L::floats(C) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(HD / L::VB, H, B);
  wkv6_fwd<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, logw, u, s0, y, s_out, H, S, C,
      rs, ks, vs, ws, ys);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* r, const void* k, const void* v,
                const float* logw, const float* u, const float* s0, float* y,
                float* s_out, int B, int H, int S, int C, Strides rs,
                Strides ks, Strides vs, Strides ws, Strides ys,
                cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(r, k, v, logw, u, s0, y, s_out, B, H, S, C, rs,
                           ks, vs, ws, ys, stream);
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, y, s_out, B, H, S, C, rs,
                           ks, vs, ws, ys, stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, y, s_out, B, H, S, C, rs,
                           ks, vs, ws, ys, stream);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, s0, y, s_out, B, H, S, C, rs,
                            ks, vs, ws, ys, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r/k/v/logw/y (B, H, S, hd), each addressed by its (batch, head, row)
// element strides with a contiguous last dimension; u (H, hd), s0 and
// s_out (B, H, hd, hd) contiguous float32. dtype 0: float32 r/k/v, 1:
// bfloat16. hd in {16, 32, 64, 128}; C in {16, 32, 64} and S a multiple
// of C. Returns the first CUDA error (cudaSuccess = 0),
// cudaErrorInvalidValue for a shape the kernel does not take.
int wkv6_launch(const void* r, const void* k, const void* v, const void* logw,
                const void* u, const void* s0, void* y, void* s_out,
                int dtype, int B, int H, int S, int hd, int C, long long rsb,
                long long rsh, long long rss, long long ksb, long long ksh,
                long long kss, long long vsb, long long vsh, long long vss,
                long long wsb, long long wsh, long long wss, long long ysb,
                long long ysh, long long yss, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535 ||
      (C != 16 && C != 32 && C != 64) || S % C)
    return (int)cudaErrorInvalidValue;
  const Strides rs{rsb, rsh, rss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      ws{wsb, wsh, wss}, ys{ysb, ysh, yss};
  cudaStream_t st = (cudaStream_t)stream;
  const float *lw = (const float*)logw, *uu = (const float*)u,
              *s = (const float*)s0;
  if (dtype == 0)
    return dispatch_hd<float>(hd, r, k, v, lw, uu, s, (float*)y,
                              (float*)s_out, B, H, S, C, rs, ks, vs, ws, ys,
                              st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, r, k, v, lw, uu, s, (float*)y,
                                      (float*)s_out, B, H, S, C, rs, ks, vs,
                                      ws, ys, st);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
