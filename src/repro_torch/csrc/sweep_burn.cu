// Sustained-matmul burn for Hopper (sm_90a): the offline sweep's compute
// probe. Starting from x = a, `iters` times: y = x @ b, then
// x = y * rsqrt(mean(y^2) + 1e-12). float32 throughout.
//
// Replaces: src/repro/kernels/sweep_burn/sweep_burn.py, `burn` (Pallas
// body `_burn_kernel`).
//
// What bounds it on this card: operations. 2*M*K*K flops per iteration
// against a few MB of operands that stay in the 50 MB L2 (512^2 float32 is
// 1 MB per operand), so the floor is the float32 CUDA-core peak (67 TFLOP/s
// on an H100 SXM at 700 W), not memory.
//
// Design: a tiled SIMT GEMM. Each 256-thread block computes a 64x64 tile
// of y from 16-deep slices of x and b staged in shared memory, each thread
// a 4x4 micro-tile in registers with fused multiply-adds. No tensor cores
// (a TF32 mode would change the numbers and stays a separate, later
// opt-in). The block also writes the sum of squares of its tile into its
// own slot of a partials buffer. A second small kernel adds the partials
// in a fixed order and rescales y into x. That is 2 launches per
// iteration, all issued by one C call on the caller's stream. There are
// no atomics and no split-K: every sum is taken in a fixed order, so the
// checksum repeats bit for bit from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);   // 256
constexpr int kScaleThreads = 256;

// Deterministic block-wide sum (fixed shuffle tree, fixed warp order);
// the total is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  float t = 0.0f;
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    t = lane < nw ? sh[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  }
  return t;
}

// y (M, K) = x (M, K) @ b (K, K); partial[tile] = sum of y^2 over the tile.
__global__ void __launch_bounds__(kGemmThreads)
burn_gemm(const float* __restrict__ x, const float* __restrict__ b,
          float* __restrict__ y, float* __restrict__ partial, int K) {
  __shared__ float As[BK][BM + 4];     // x tile, transposed: As[k][m]
  __shared__ float Bs[BK][BN];
  __shared__ float sh[32];
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += kGemmThreads) {
      const int r = i / BK, c = i % BK;
      As[c][r] = x[(size_t)(row0 + r) * K + k0 + c];
    }
    for (int i = threadIdx.x; i < BK * BN; i += kGemmThreads) {
      const int r = i / BN, c = i % BN;
      Bs[r][c] = b[(size_t)(k0 + r) * K + col0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = row0 + ty + i * (BM / TM), c = col0 + tx + j * (BN / TN);
      y[(size_t)r * K + c] = acc[i][j];
      ss = fmaf(acc[i][j], acc[i][j], ss);
    }
  const float tot = block_sum(ss, sh);
  if (threadIdx.x == 0) partial[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

// x = y * rsqrt(sum(partial) / count + 1e-12). Every block adds the
// partials itself, in the same fixed order, so no grid barrier is needed.
__global__ void __launch_bounds__(kScaleThreads)
burn_scale(const float* __restrict__ y, const float* __restrict__ partial,
           int n_partial, float* __restrict__ x, size_t count) {
  __shared__ float sh[32];
  __shared__ float scale;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n_partial; i += blockDim.x) s += partial[i];
  const float tot = block_sum(s, sh);
  if (threadIdx.x == 0) scale = rsqrtf(tot / (float)count + 1e-12f);
  __syncthreads();
  const float sc = scale;
  const size_t n4 = count / 4;
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* x4 = reinterpret_cast<float4*>(x);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = y4[i];
    v.x *= sc; v.y *= sc; v.z *= sc; v.w *= sc;
    x4[i] = v;
  }
}

}  // namespace

extern "C" {

// a (M, K) f32 is copied into x by the caller; b (K, K) f32. x is
// overwritten with the result, y (M, K) and partial ((M/64)*(K/64)) are
// scratch. M and K must be multiples of 64. Returns the first
// cudaGetLastError() that is not cudaSuccess, else cudaSuccess.
int sweep_burn_launch(void* x, const void* b, void* y, void* partial, int M,
                      int K, int iters, void* stream) {
  if (M <= 0 || K <= 0 || M % BM || K % BN || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(K / BN, M / BM);
  const int n_partial = (K / BN) * (M / BM);
  const size_t count = (size_t)M * K;
  const int scale_blocks = (int)((count / 4 + kScaleThreads - 1) /
                                 kScaleThreads);
  for (int it = 0; it < iters; ++it) {
    burn_gemm<<<grid, kGemmThreads, 0, s>>>(
        (const float*)x, (const float*)b, (float*)y, (float*)partial, K);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    burn_scale<<<scale_blocks, kScaleThreads, 0, s>>>(
        (const float*)y, (const float*)partial, n_partial, (float*)x, count);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* sweep_burn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
