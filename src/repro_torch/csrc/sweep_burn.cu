// Sustained-matmul burn for Hopper (sm_90a): the offline sweep's compute
// probe. Starting from x = a, `iters` times: y = x @ b, then
// x = y * rsqrt(mean(y^2) + 1e-12). float32 throughout.
//
// Replaces: src/repro/kernels/sweep_burn/sweep_burn.py, `burn` (Pallas
// body `_burn_kernel`), which keeps both operands resident in VMEM for the
// whole chain.
//
// What bounds it on this card: operations. 2*M*K*K flops per iteration
// against a few MB of operands that stay in the 50 MB L2 (512^2 float32 is
// 1 MB per operand), so the floor is the float32 CUDA-core peak (67 TFLOP/s
// on an H100 SXM at 700 W), not memory. No tensor cores: a TF32 mode would
// change the numbers.
//
// Design: one cooperative launch per call, one grid barrier per iteration.
// Each 128-thread block owns 32x64 tiles of y (each thread a 4x4
// micro-tile, float4 shared-memory reads, fused multiply-adds in k order).
//   * Resident mode (the K x 64 column panel of b fits in shared memory and
//     every tile has its own co-resident block; 512^2 gives 128 blocks):
//     the block loads its panel of b once and keeps it for the whole chain,
//     the Hopper form of the TPU kernel's VMEM-resident operand. Each
//     iteration it stages its 32 x K row panel of x from L2 with 16-byte
//     cp.async, in two halves so the second half's copy overlaps the first
//     half's products.
//   * Streaming mode (otherwise, e.g. 2048^2): blocks walk the tiles
//     grid-stride and stream x and b through double-buffered 64-deep
//     slices.
// After its products a block writes its tile of y and the tile's sum of
// squares into ping-pong buffers. After the grid barrier every block adds
// all the tiles' sums in the same fixed order, forms
// s = rsqrt(sum / count + 1e-12) and applies x = s * y to each element it
// stages (the same float32 multiply as the reference). The last iteration
// writes s * y to the output. No atomics on data and no split-K: every sum
// is taken in a fixed order, so the result repeats bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TM = 32, TN = 64, SK = 64;      // y tile; streamed k slice
constexpr int kThreads = 128;                 // (TM/4) x (TN/4) threads
constexpr int kPad = 4;                       // floats of padding per x row
constexpr size_t kSmemLimit = 232448;         // H100: per-block maximum

struct Args {
  const float* a;
  const float* b;
  float* ybuf;          // (2, M, K) ping-pong
  float* partial;       // (2, tiles) ping-pong sums of squares
  float* out;
  int M, K, iters;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Deterministic block-wide sum (fixed shuffle tree, fixed warp order);
// every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();                       // sh is free
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) t += sh[w];
  return t;
}

// s = rsqrt(sum of the tiles' sums of squares / count + 1e-12), the sums
// added in a fixed order that does not depend on the grid.
__device__ float chain_scale(const float* part, int tiles, size_t count,
                             float* sh) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < tiles; i += kThreads) s += part[i];
  const float tot = block_sum(s, sh);
  return rsqrtf(tot / (float)count + 1e-12f);
}

// Copy rows [r0, r0+TM) x columns [k0, k0+w) of src (row stride K) into
// xs (row stride ld), 16 bytes per cp.async. Each thread copies the same
// chunks in every call, so it can rescale its own chunks after its wait.
__device__ __forceinline__ void stage_x(float* xs, int ld, const float* src,
                                        int K, int r0, int k0, int w) {
  const int per_row = w / 4;
  for (int c = threadIdx.x; c < TM * per_row; c += kThreads) {
    const int r = c / per_row, q = c % per_row;
    cp_async16(xs + r * ld + k0 + 4 * q,
               src + (size_t)(r0 + r) * K + k0 + 4 * q);
  }
}
__device__ __forceinline__ void scale_x(float* xs, int ld, int k0, int w,
                                        float s) {
  const int per_row = w / 4;
  for (int c = threadIdx.x; c < TM * per_row; c += kThreads) {
    const int r = c / per_row, q = c % per_row;
    float4* p = reinterpret_cast<float4*>(xs + r * ld + k0 + 4 * q);
    float4 v = *p;
    v.x *= s; v.y *= s; v.z *= s; v.w *= s;
    *p = v;
  }
}

// acc += xs[:, k0:k0+depth] @ bs[k0:k0+depth, :]; xs row-major (ld), bs
// row-major with TN columns, depth a multiple of 8. Thread (ty, tx) owns
// rows 4ty.. and columns 4tx..; the fragments of the next four k are
// loaded while the current four are multiplied.
__device__ __forceinline__ void load_frag(float4 (&av)[4], float4 (&bv)[4],
                                          const float* xr, int ld,
                                          const float* bc, int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    av[i] = *reinterpret_cast<const float4*>(xr + i * ld + k);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    bv[kk] = *reinterpret_cast<const float4*>(bc + (size_t)(k + kk) * TN);
}
__device__ __forceinline__ void fma_frag(float (&acc)[4][4],
                                         const float4 (&av)[4],
                                         const float4 (&bv)[4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                    : kk == 2 ? av[i].z : av[i].w;
      acc[i][0] = fmaf(a, bv[kk].x, acc[i][0]);
      acc[i][1] = fmaf(a, bv[kk].y, acc[i][1]);
      acc[i][2] = fmaf(a, bv[kk].z, acc[i][2]);
      acc[i][3] = fmaf(a, bv[kk].w, acc[i][3]);
    }
  }
}
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const float* xs,
                                         int ld, const float* bs, int k0,
                                         int depth) {
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
  const float* xr = xs + 4 * ty * ld;
  const float* bc = bs + 4 * tx;
  float4 a0[4], b0[4], a1[4], b1[4];
  load_frag(a0, b0, xr, ld, bc, k0);
  for (int k = k0; k < k0 + depth; k += 8) {
    load_frag(a1, b1, xr, ld, bc, k + 4);
    fma_frag(acc, a0, b0);
    if (k + 8 < k0 + depth) load_frag(a0, b0, xr, ld, bc, k + 8);
    fma_frag(acc, a1, b1);
  }
}

// The thread's sum of squares of its micro-tile, in a fixed order.
__device__ __forceinline__ float sumsq(const float (&acc)[4][4]) {
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ss = fmaf(acc[i][j], acc[i][j], ss);
  return ss;
}

// Write the thread's micro-tile, times s, to dst (row stride K).
__device__ __forceinline__ void store_tile(const float (&acc)[4][4],
                                           float* dst, int K, int r0, int c0,
                                           float s) {
  const int tx = threadIdx.x % (TN / 4), ty = threadIdx.x / (TN / 4);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + (size_t)(r0 + 4 * ty + i) * K + c0 +
                               4 * tx) =
        make_float4(acc[i][0] * s, acc[i][1] * s, acc[i][2] * s,
                    acc[i][3] * s);
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// Resident mode: block t owns tile t (M/TM x K/TN tiles, one block each).
__global__ void __launch_bounds__(kThreads)
burn_resident(Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sh[kThreads / 32];
  const int K = p.K, ld = K + kPad;
  float* bs = smem;                      // (K, TN)
  float* xs = bs + (size_t)K * TN;       // (TM, K + pad)
  const int tiles_n = K / TN, tiles = (p.M / TM) * tiles_n;
  const int r0 = (blockIdx.x / tiles_n) * TM, c0 = (blockIdx.x % tiles_n) * TN;
  const size_t count = (size_t)p.M * K;
  cg::grid_group grid = cg::this_grid();

  for (int c = threadIdx.x; c < K * (TN / 4); c += kThreads) {
    const int r = c / (TN / 4), q = c % (TN / 4);
    cp_async16(bs + r * TN + 4 * q, p.b + (size_t)r * K + c0 + 4 * q);
  }
  cp_commit();                           // b's panel: the oldest group

  const int half = K / 2;                 // a multiple of 32
  float acc[4][4];
  for (int it = 0; it < p.iters; ++it) {
    const float* src = it == 0 ? p.a : p.ybuf + (size_t)((it - 1) & 1) * count;
    stage_x(xs, ld, src, K, r0, 0, half);
    cp_commit();
    stage_x(xs, ld, src, K, r0, half, half);
    cp_commit();
    // the grid-wide scale is summed while the row panel is in flight
    const float s = it == 0 ? 1.0f
        : chain_scale(p.partial + ((it - 1) & 1) * tiles, tiles, count, sh);
    zero(acc);
    cp_wait<1>();                        // b and the first half are in
    if (it) scale_x(xs, ld, 0, half, s);
    __syncthreads();
    mma_tile(acc, xs, ld, bs, 0, half);
    cp_wait<0>();
    if (it) scale_x(xs, ld, half, half, s);
    __syncthreads();
    mma_tile(acc, xs, ld, bs, half, half);
    if (it + 1 < p.iters)                // the last y stays in registers
      store_tile(acc, p.ybuf + (size_t)(it & 1) * count, K, r0, c0, 1.0f);
    const float tot = block_sum(sumsq(acc), sh);
    if (threadIdx.x == 0) p.partial[(it & 1) * tiles + blockIdx.x] = tot;
    grid.sync();                         // y and its sums are complete
  }
  const float s = chain_scale(p.partial + ((p.iters - 1) & 1) * tiles, tiles,
                              count, sh);
  store_tile(acc, p.out, K, r0, c0, s);
}

// Streaming mode: blocks walk the tiles grid-stride; x and b come in
// double-buffered SK-deep slices.
__global__ void __launch_bounds__(kThreads)
burn_streaming(Args p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float sh[kThreads / 32];
  constexpr int ld = SK + kPad;
  // buffer i: x slice at xs0 + i * TM * ld, b slice at bs0 + i * SK * TN
  float* xs0 = smem;
  float* bs0 = smem + 2 * TM * ld;
  const int K = p.K, tiles_n = K / TN, tiles = (p.M / TM) * tiles_n;
  const int slices = K / SK;
  const size_t count = (size_t)p.M * K;
  cg::grid_group grid = cg::this_grid();

  auto stage = [&](int buf, const float* src, int r0, int c0, int sl) {
    for (int c = threadIdx.x; c < TM * (SK / 4); c += kThreads) {
      const int r = c / (SK / 4), q = c % (SK / 4);
      cp_async16(xs0 + buf * TM * ld + r * ld + 4 * q,
                 src + (size_t)(r0 + r) * K + sl * SK + 4 * q);
    }
    for (int c = threadIdx.x; c < SK * (TN / 4); c += kThreads) {
      const int r = c / (TN / 4), q = c % (TN / 4);
      cp_async16(bs0 + buf * SK * TN + r * TN + 4 * q,
                 p.b + (size_t)(sl * SK + r) * K + c0 + 4 * q);
    }
    cp_commit();
  };

  for (int it = 0; it < p.iters; ++it) {
    const float* src = it == 0 ? p.a : p.ybuf + (size_t)((it - 1) & 1) * count;
    const float s = it == 0 ? 1.0f
        : chain_scale(p.partial + ((it - 1) & 1) * tiles, tiles, count, sh);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int r0 = (t / tiles_n) * TM, c0 = (t % tiles_n) * TN;
      float acc[4][4];
      zero(acc);
      stage(0, src, r0, c0, 0);
      for (int sl = 0; sl < slices; ++sl) {
        const int cur = sl & 1;
        if (sl + 1 < slices) {
          stage(cur ^ 1, src, r0, c0, sl + 1);
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        if (it) {                        // rescale this thread's own chunks
          for (int c = threadIdx.x; c < TM * (SK / 4); c += kThreads) {
            const int r = c / (SK / 4), q = c % (SK / 4);
            float4* v4 = reinterpret_cast<float4*>(xs0 + cur * TM * ld +
                                                  r * ld + 4 * q);
            float4 v = *v4;
            v.x *= s; v.y *= s; v.z *= s; v.w *= s;
            *v4 = v;
          }
        }
        __syncthreads();
        mma_tile(acc, xs0 + cur * TM * ld, ld, bs0 + cur * SK * TN, 0, SK);
        __syncthreads();                 // the buffer may be refilled
      }
      // a block holds several tiles, so y always goes through ybuf; the
      // last iteration's is rescaled into the output after the barrier
      store_tile(acc, p.ybuf + (size_t)(it & 1) * count, K, r0, c0, 1.0f);
      const float tot = block_sum(sumsq(acc), sh);
      if (threadIdx.x == 0) p.partial[(it & 1) * tiles + t] = tot;
    }
    grid.sync();
  }
  const int lastbuf = (p.iters - 1) & 1;
  const float s = chain_scale(p.partial + lastbuf * tiles, tiles, count, sh);
  const float* y = p.ybuf + (size_t)lastbuf * count;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < count / 4;
       i += (size_t)gridDim.x * kThreads) {
    float4 v = reinterpret_cast<const float4*>(y)[i];
    v.x *= s; v.y *= s; v.z *= s; v.w *= s;
    reinterpret_cast<float4*>(p.out)[i] = v;
  }
}

size_t resident_smem(int K) {
  return sizeof(float) * ((size_t)K * TN + (size_t)TM * (K + kPad));
}
constexpr size_t kStreamSmem = sizeof(float) * 2 * (TM * (SK + kPad) + SK * TN);

}  // namespace

extern "C" {

// a (M, K) and b (K, K) float32, out (M, K) float32, ybuf (2, M, K) and
// partial (2, (M/32)*(K/64)) float32 scratch; all 16-byte aligned and
// contiguous. M a multiple of 32, K a multiple of 64, iters >= 1. One
// cooperative launch on `stream`. *mode is set to 1 (b resident in shared
// memory) or 2 (b streamed) and *blocks to the grid size. Returns the
// first CUDA error (cudaSuccess = 0); cudaErrorCooperativeLaunchTooLarge
// when not even one block fits on an SM.
int sweep_burn_launch(const void* a, const void* b, void* out, void* ybuf,
                      void* partial, int M, int K, int iters, void* stream,
                      int* mode, int* blocks) {
  if (M <= 0 || K <= 0 || M % TM || K % TN || iters < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (M / TM) * (K / TN);
  Args args{(const float*)a, (const float*)b, (float*)ybuf, (float*)partial,
            (float*)out, M, K, iters};
  void* params[] = {&args};

  const size_t rs = resident_smem(K);
  if (rs <= kSmemLimit - 1024) {
    e = cudaFuncSetAttribute(burn_resident,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)rs);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, burn_resident,
                                                      kThreads, rs);
    if (e != cudaSuccess) return (int)e;
    if (tiles <= per_sm * sms) {
      *mode = 1;
      *blocks = tiles;
      e = cudaLaunchCooperativeKernel((const void*)burn_resident,
                                      dim3(tiles), dim3(kThreads), params, rs,
                                      (cudaStream_t)stream);
      return (int)(e != cudaSuccess ? e : cudaGetLastError());
    }
  }
  e = cudaFuncSetAttribute(burn_streaming,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kStreamSmem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, burn_streaming,
                                                    kThreads, kStreamSmem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = per_sm * sms < tiles ? per_sm * sms : tiles;
  *mode = 2;
  *blocks = grid;
  e = cudaLaunchCooperativeKernel((const void*)burn_streaming, dim3(grid),
                                  dim3(kThreads), params, kStreamSmem,
                                  (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

const char* sweep_burn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
