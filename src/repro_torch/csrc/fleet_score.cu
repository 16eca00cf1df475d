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
// microsecond), far below the launch latency. What it costs is latency:
// in steady state (R = 1) only M = 8 blocks run on 132 SMs, and each exact
// order statistic is a chain of passes over the row, each ending in a
// block-wide step. A 32-round bisection over the uint32 key space needs
// 64 such passes for the median and the MAD; this design needs 8.
//
// Design: one block per (r, m) row. The row is staged once in shared
// memory when it has at most kStageMax = 49,152 nodes (192 KB; 16,384
// nodes are 64 KB); a longer row (131,072 nodes are 512 KB) is read from
// global memory, where it stays in the 50 MB L2, on every pass. Both paths
// are the same code through one pointer. Each order statistic is a radix
// select over its uint32 key: 4 rounds of 8-bit digits, most significant
// first. A round builds a 256-bin histogram of the keys that match the
// prefix found so far with integer atomicAdd in shared memory: a warp
// whose 32 keys fall in one bin (the common case in the first rounds,
// where a fleet's readings share their leading bits) adds 32 once, any
// other warp adds per key. Each thread loads 4 keys before it counts them,
// so the streamed path keeps 4 loads in flight. Then one warp scans the
// bins and picks the digit that holds the target rank. The two middle
// ranks of an even N are selected in the same rounds: they share a prefix
// until they part, after which a round fills two histograms. The MAD takes
// 4 more rounds over the keys of |x - med|, computed on the fly from the
// staged row. The step_time block also writes `rel` and `contrib`. There
// is no lane padding: the ragged edge is masked by N.
//
// What the rounds cost: each key visit is ~25 instructions (load, key,
// digit, prefix test, vote, add) and 8 rounds visit every key, so a block
// of 16,384 nodes issues ~100 K warp instructions on its one SM; that, not
// the bytes, is this design's floor.
//
// Exactness: keys are the float32 bits mapped to IEEE total order, with
// every NaN first made the canonical 0x7fc00000 so that NaNs sort last as
// in np.partition. Integer counts do not depend on the order of the
// atomics, so the selected keys are exact. Every product, quotient and sum
// is a correctly rounded intrinsic (__fmul_rn, __fdiv_rn, __fadd_rn,
// __fsub_rn), the file is built with -fmad=false, and max() propagates NaN
// as np.maximum does, so the outputs are bit-identical to the NumPy oracle.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kStageMax = 49152;        // nodes staged in shared memory
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

// Keys of the row as the select sees them: the values themselves (center
// is unused) or |x - center| for the MAD.
template <bool kAbsDev>
__device__ __forceinline__ uint32_t row_key(float x, float center) {
  if (kAbsDev) x = fabsf(__fsub_rn(x, center));
  return float_key(x);
}

// Run by one warp over a 256-bin histogram: the digit whose bin holds the
// 0-based rank *k among the counted keys; *k becomes the rank inside that
// bin. Lane l owns bins 8l .. 8l + 7.
__device__ __forceinline__ uint32_t pick_digit(const uint32_t* hist,
                                               uint32_t* k) {
  const int lane = threadIdx.x & 31;
  uint32_t own = 0u;
#pragma unroll
  for (int d = 0; d < 8; ++d) own += hist[lane * 8 + d];
  uint32_t incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  uint32_t below = incl - own, digit = 0u, rank = 0u;
  const bool mine = below <= *k && *k < incl;
  if (mine) {
    for (int d = 0; d < 8; ++d) {
      const uint32_t c = hist[lane * 8 + d];
      if (*k < below + c) {
        digit = lane * 8 + d;
        rank = *k - below;
        break;
      }
      below += c;
    }
  }
  const int src = __ffs(__ballot_sync(0xffffffffu, mine)) - 1;
  *k = __shfl_sync(0xffffffffu, rank, src);
  return __shfl_sync(0xffffffffu, digit, src);
}

// The k1-th and k2-th smallest keys of the row (0-based, k1 <= k2), by
// radix select with 8-bit digits, both in the same 4 rounds. hist holds
// 512 zeroed bins (the second 256 count the k2 prefix once the two ranks
// have parted) and is left zeroed; sel holds 4 words.
template <bool kAbsDev>
__device__ uint2 select2(const float* src, int n, float center, uint32_t k1,
                         uint32_t k2, uint32_t* hist, uint32_t* sel) {
  uint32_t p1 = 0u, p2 = 0u;              // the digits found so far
  for (int shift = 24; shift >= 0; shift -= 8) {
    const uint32_t hi = shift == 24 ? 0u : 0xffffffffu << (shift + 8);
    const bool parted = p1 != p2;
    for (int base = 0; base < n; base += 4 * blockDim.x) {
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * blockDim.x + threadIdx.x;
        x[u] = i < n ? src[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * blockDim.x + threadIdx.x;
        int bin = -1;
        if (i < n) {
          const uint32_t key = row_key<kAbsDev>(x[u], center);
          const int dig = (int)((key >> shift) & 255u);
          if ((key & hi) == p1) bin = dig;
          else if ((key & hi) == p2) bin = 256 + dig;
        }
        const int b0 = __shfl_sync(0xffffffffu, bin, 0);
        if (__all_sync(0xffffffffu, bin == b0)) {
          if ((threadIdx.x & 31) == 0 && b0 >= 0) atomicAdd(&hist[b0], 32u);
        } else if (bin >= 0) {
          atomicAdd(&hist[bin], 1u);
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const uint32_t d1 = pick_digit(hist, &k1);
      const uint32_t d2 = pick_digit(hist + (parted ? 256 : 0), &k2);
      __syncwarp();                       // every bin is read: clear them
      for (int b = threadIdx.x; b < 512; b += 32) hist[b] = 0u;
      if (threadIdx.x == 0) {
        sel[0] = p1 | (d1 << shift);
        sel[1] = p2 | (d2 << shift);
        sel[2] = k1;
        sel[3] = k2;
      }
    }
    __syncthreads();
    p1 = sel[0];
    p2 = sel[1];
    k1 = sel[2];
    k2 = sel[3];                          // rewritten after the next
  }                                       // round's first barrier
  return make_uint2(p1, p2);
}

// np.median of the row (or of |row - center|), float32.
template <bool kAbsDev>
__device__ float row_median(const float* src, int n, float center,
                            uint32_t* hist, uint32_t* sel) {
  const uint32_t h = (uint32_t)(n / 2);
  const uint32_t k1 = (n & 1) ? h : h - 1u;
  const uint2 k = select2<kAbsDev>(src, n, center, k1, h, hist, sel);
  if (n & 1) return key_float(k.y);
  return __fdiv_rn(__fadd_rn(key_float(k.x), key_float(k.y)), 2.0f);
}

__global__ void __launch_bounds__(kThreads)
fleet_score_kernel(const float* __restrict__ mats,
                   const float* __restrict__ dirs, int M, int N, int st_j,
                   float z_thr, float slow_floor, float mad_frac,
                   uint8_t* __restrict__ dev, float* __restrict__ rel,
                   float* __restrict__ contrib) {
  __shared__ uint32_t hist[512];
  __shared__ uint32_t sel[4];
  extern __shared__ float staged[];
  const int r = blockIdx.x / M, m = blockIdx.x % M;
  const size_t base = ((size_t)r * M + m) * (size_t)N;
  const float* row = mats + base;

  for (int b = threadIdx.x; b < 512; b += blockDim.x) hist[b] = 0u;
  const float* src = row;
  if (N <= kStageMax) {                   // stage the row once
    for (int i = threadIdx.x; i < N; i += blockDim.x) staged[i] = row[i];
    src = staged;
  }
  __syncthreads();

  const float med = row_median<false>(src, N, 0.0f, hist, sel);
  const float mad = row_median<true>(src, N, med, hist, sel);
  const float floor_ = nan_max(__fmul_rn(fabsf(med), mad_frac), 1e-9f);
  const float scale = nan_max(__fdiv_rn(mad, 0.6745f), floor_);
  const float d = dirs[m];
  const bool is_st = (m == st_j);
  const float ms = nan_max(med, 1e-9f);
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const float x = src[i];
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
// otherwise). A row of at most kStageMax nodes is staged in shared memory,
// a longer one read from global memory. Returns cudaGetLastError() after
// the launch.
int fleet_score_launch(const void* mats, const void* dirs, int R, int M,
                       int N, int st_j, float z_thr, float slow_floor,
                       float mad_frac, void* dev, void* rel, void* contrib,
                       void* stream) {
  if (R <= 0 || M <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;         // once: up to kStageMax floats
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        fleet_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageMax * (int)sizeof(float));
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const size_t smem = N <= kStageMax ? (size_t)N * sizeof(float) : 0;
  fleet_score_kernel<<<R * M, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)mats, (const float*)dirs, M, N, st_j, z_thr, slow_floor,
      mad_frac, (uint8_t*)dev, (float*)rel, (float*)contrib);
  return (int)cudaGetLastError();
}

const char* fleet_score_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
