// Fleet-score kernel for Hopper (sm_90a): peer median, MAD, robust z and
// threshold verdicts over (R, M, N) ring-buffer rows, float32.
//
// Replaces: src/repro/kernels/fleet_score/fleet_score.py, `fleet_score`
// (Pallas body `_fleet_score_kernel` -> `score_rows_jnp`, with the medians
// of `median_lastdim` / `kth_smallest_key`).
//
// What bounds it on this card: the arithmetic is trivial, so the floor is
// one read of the R*M*N inputs plus the writes of the outputs at device
// memory rate (16,384 nodes x 8 metrics is 512 KB: well under a
// microsecond), far below the launch latency. What it actually costs is
// latency: each exact order statistic takes 32 bisection rounds, each a
// pass over the row and a block-wide count, and in steady state (R = 1)
// only M = 8 blocks run on 132 SMs.
//
// Design: one block per (r, m) row. Threads stride over the N nodes and,
// each round, count the keys <= mid, then reduce the counts across the
// block. The row is re-read from global memory on every pass: eight rows
// of 131,072 nodes are 4 MB, which stays in the 50 MB L2, and a row that
// large does not fit in shared memory anyway. The two middle order
// statistics of an even N are bisected together, two counts per pass. The
// MAD keys |x - med| are computed on the fly. The step_time block also
// writes `rel` and `contrib`. There is no lane padding: the ragged edge is
// masked by N.
//
// Exactness: keys are the float32 bits mapped to IEEE total order, with
// every NaN first made the canonical 0x7fc00000 so that NaNs sort last as
// in np.partition. Every product, quotient and sum is a correctly rounded
// intrinsic (__fmul_rn, __fdiv_rn, __fadd_rn, __fsub_rn), the file is
// built with -fmad=false, and max() propagates NaN as np.maximum does, so
// the outputs are bit-identical to the NumPy oracle.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr uint32_t kSign = 0x80000000u;

__device__ __forceinline__ uint32_t float_key(float x) {
  uint32_t u = isnan(x) ? 0x7fc00000u : __float_as_uint(x);
  return (u & kSign) ? ~u : (u | kSign);
}

__device__ __forceinline__ float key_float(uint32_t k) {
  return __uint_as_float((k & kSign) ? (k ^ kSign) : ~k);
}

// np.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// Block-wide sum of two counts; every thread gets both totals.
__device__ __forceinline__ uint2 block_count2(uint32_t c1, uint32_t c2,
                                              uint32_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c1 = __reduce_add_sync(0xffffffffu, c1);
  c2 = __reduce_add_sync(0xffffffffu, c2);
  if (lane == 0) { sh[warp] = c1; sh[32 + warp] = c2; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    uint32_t v1 = lane < nw ? sh[lane] : 0u;
    uint32_t v2 = lane < nw ? sh[32 + lane] : 0u;
    v1 = __reduce_add_sync(0xffffffffu, v1);
    v2 = __reduce_add_sync(0xffffffffu, v2);
    if (lane == 0) { sh[64] = v1; sh[65] = v2; }
  }
  __syncthreads();
  return make_uint2(sh[64], sh[65]);
}

// Keys of the row as the bisection sees them: the values themselves
// (center is unused) or |x - center| for the MAD.
template <bool kAbsDev>
__device__ __forceinline__ uint32_t row_key(float x, float center) {
  if (kAbsDev) x = fabsf(__fsub_rn(x, center));
  return float_key(x);
}

// The k1-th and k2-th smallest keys of the row (0-based), by 32-round
// bisection over the uint32 key space, both in the same passes.
template <bool kAbsDev>
__device__ uint2 select2(const float* __restrict__ row, int n, float center,
                         uint32_t k1, uint32_t k2, uint32_t* sh) {
  uint32_t lo1 = 0u, hi1 = 0xffffffffu, lo2 = 0u, hi2 = 0xffffffffu;
  while (lo1 < hi1 || lo2 < hi2) {        // uniform across the block
    const uint32_t mid1 = lo1 + ((hi1 - lo1) >> 1);
    const uint32_t mid2 = lo2 + ((hi2 - lo2) >> 1);
    uint32_t c1 = 0u, c2 = 0u;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint32_t k = row_key<kAbsDev>(row[i], center);
      c1 += k <= mid1;
      c2 += k <= mid2;
    }
    const uint2 c = block_count2(c1, c2, sh);
    if (lo1 < hi1) {
      if (c.x >= k1 + 1u) hi1 = mid1; else lo1 = mid1 + 1u;
    }
    if (lo2 < hi2) {
      if (c.y >= k2 + 1u) hi2 = mid2; else lo2 = mid2 + 1u;
    }
  }
  return make_uint2(lo1, lo2);
}

// np.median of the row (or of |row - center|), float32.
template <bool kAbsDev>
__device__ float row_median(const float* __restrict__ row, int n,
                            float center, uint32_t* sh) {
  const uint32_t h = (uint32_t)(n / 2);
  const uint32_t k1 = (n & 1) ? h : h - 1u;
  const uint2 k = select2<kAbsDev>(row, n, center, k1, h, sh);
  if (n & 1) return key_float(k.y);
  return __fdiv_rn(__fadd_rn(key_float(k.x), key_float(k.y)), 2.0f);
}

__global__ void __launch_bounds__(kThreads)
fleet_score_kernel(const float* __restrict__ mats,
                   const float* __restrict__ dirs, int M, int N, int st_j,
                   float z_thr, float slow_floor, float mad_frac,
                   uint8_t* __restrict__ dev, float* __restrict__ rel,
                   float* __restrict__ contrib) {
  __shared__ uint32_t sh[66];
  const int r = blockIdx.x / M, m = blockIdx.x % M;
  const size_t base = ((size_t)r * M + m) * (size_t)N;
  const float* row = mats + base;

  const float med = row_median<false>(row, N, 0.0f, sh);
  const float mad = row_median<true>(row, N, med, sh);
  const float floor_ = nan_max(__fmul_rn(fabsf(med), mad_frac), 1e-9f);
  const float scale = nan_max(__fdiv_rn(mad, 0.6745f), floor_);
  const float d = dirs[m];
  const bool is_st = (m == st_j);
  const float ms = nan_max(med, 1e-9f);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float x = row[i];
    const float z = __fmul_rn(__fdiv_rn(__fsub_rn(x, med), scale), d);
    bool dv = z > z_thr;
    if (is_st) {
      const float rl = __fsub_rn(__fdiv_rn(x, ms), 1.0f);
      dv = dv && (rl > slow_floor);
      rel[(size_t)r * N + i] = rl;
      contrib[(size_t)r * N + i] = dv ? rl : 0.0f;
    }
    dev[base + i] = dv ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// mats (R, M, N) f32, dirs (M,) f32 -> dev (R, M, N) u8; rel and contrib
// (R, N) f32 are written only when 0 <= st_j < M (the caller zeroes them
// otherwise). Returns cudaGetLastError() after the launch.
int fleet_score_launch(const void* mats, const void* dirs, int R, int M,
                       int N, int st_j, float z_thr, float slow_floor,
                       float mad_frac, void* dev, void* rel, void* contrib,
                       void* stream) {
  if (R <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  fleet_score_kernel<<<R * M, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mats, (const float*)dirs, M, N, st_j, z_thr, slow_floor,
      mad_frac, (uint8_t*)dev, (float*)rel, (float*)contrib);
  return (int)cudaGetLastError();
}

const char* fleet_score_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
