// A CPU stand-in for the CUDA runtime, enough to run the port's backward
// WKV6 kernel (csrc/wkv6_bwd.cu) and RG-LRU scan (csrc/rglru.cu) through
// their C entry points with g++ and hold them to the plain PyTorch versions
// without a card: a std::thread per CUDA thread, std::barrier for
// __syncthreads, for named barriers and for warp exchanges (shuffles,
// mma.sync), blocks one after another, cp.async a copy.
// rewrite.py turns the kernel source into C++ against this header;
// check.py builds and runs it.
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <memory>
#include <mutex>
#include <algorithm>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3s { unsigned x, y, z; };
inline thread_local uint3s threadIdx, blockIdx;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
using std::exp2f; using std::fmaf; using std::fminf; using std::fmaxf;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaFuncAttributePreferredSharedMemoryCarveout = 9, cudaSharedmemCarveoutMaxShared = 100 };
template <class F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "shim"; }

namespace shim {
inline std::unique_ptr<std::barrier<>> block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
inline uint32_t xbuf[64][32];
inline uint32_t abuf[64][32][4], bbuf[64][32][2];
inline std::vector<float> dyn;
inline float* dyn_smem;
inline int nthreads;
// named barriers (ids 1..15), made at their first use in a block with the
// count that use names
inline std::mutex named_mu;
inline std::unique_ptr<std::barrier<>> named[16];
inline std::barrier<>& named_bar(int id, int count) {
  std::lock_guard<std::mutex> lock(named_mu);
  if (!named[id]) named[id] = std::make_unique<std::barrier<>>(count);
  return *named[id];
}
inline void wbar() { warp_bars[threadIdx.x / 32]->arrive_and_wait(); }
template <class F> float exchange(float v, F src) {
  int w = threadIdx.x / 32, l = threadIdx.x % 32;
  memcpy(&xbuf[w][l], &v, 4);
  wbar();
  int s = src(l);
  float r; memcpy(&r, &xbuf[w][s], 4);
  wbar();
  return r;
}
template <class F> void launch(dim3 g, dim3 b, size_t smem, cudaStream_t, F body) {
  nthreads = b.x;
  for (unsigned bz = 0; bz < g.z; ++bz)
    for (unsigned by = 0; by < g.y; ++by)
      for (unsigned bx = 0; bx < g.x; ++bx) {
        dyn.assign(smem / 4 + 8, std::nanf(""));
        dyn_smem = dyn.data();
        block_bar = std::make_unique<std::barrier<>>(nthreads);
        for (auto& n : named) n.reset();
        warp_bars.clear();
        for (int w = 0; w < (nthreads + 31) / 32; ++w) warp_bars.push_back(std::make_unique<std::barrier<>>(std::min(32, nthreads - 32 * w)));
        std::vector<std::thread> ts;
        for (int t = 0; t < nthreads; ++t)
          ts.emplace_back([&, t] { threadIdx = {(unsigned)t, 0, 0}; blockIdx = {bx, by, bz}; body(); });
        for (auto& th : ts) th.join();
      }
}
}  // namespace shim

inline void __syncthreads() { shim::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { shim::wbar(); }
inline float __shfl_sync(unsigned, float v, int src, int width = 32) {
  return shim::exchange(v, [&](int l) { return (l & ~(width - 1)) + (src % width); });
}
inline float __shfl_up_sync(unsigned, float v, int d, int width = 32) {
  return shim::exchange(v, [&](int l) { return (l % width) >= d ? l - d : l; });
}
inline float __shfl_down_sync(unsigned, float v, int d, int width = 32) {
  return shim::exchange(v, [&](int l) { return (l % width) + d < width ? l + d : l; });
}
inline float __shfl_xor_sync(unsigned, float v, int m, int width = 32) {
  return shim::exchange(v, [&](int l) { return l ^ m; });
}
// the kernel's PTX helpers (rewrite.py removes its own definitions)
inline void cp_async16(void* smem, const void* gmem, int bytes) {
  memset(smem, 0, 16);
  memcpy(smem, gmem, bytes);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
// IEEE's reciprocal and square root, rounded to nearest (the kernels'
// PTX fast paths compute them where they hold)
inline float rcp_rn(float y) { return 1.0f / y; }
inline float sqrt_rn(float v) { return std::sqrt(v); }
// bar.sync / bar.arrive on a named barrier of `count` threads
inline void named_sync(int id, int count) { shim::named_bar(id, count).arrive_and_wait(); }
inline void named_arrive(int id, int count) { auto token = shim::named_bar(id, count).arrive(); (void)token; }
// m16n8k8 TF32: the warp's fragments gathered, the low 13 bits of every
// operand ignored as the tensor core ignores them
inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int i = 0; i < 4; ++i) shim::abuf[w][l][i] = a[i];
  shim::bbuf[w][l][0] = b0; shim::bbuf[w][l][1] = b1;
  shim::wbar();
  float A[16][8], B[8][8];
  for (int L = 0; L < 32; ++L) {
    int g = L >> 2, t = L & 3;
    auto f = [](uint32_t u) { return __uint_as_float(u & 0xFFFFE000u); };
    A[g][t] = f(shim::abuf[w][L][0]); A[g + 8][t] = f(shim::abuf[w][L][1]);
    A[g][t + 4] = f(shim::abuf[w][L][2]); A[g + 8][t + 4] = f(shim::abuf[w][L][3]);
    B[t][g] = f(shim::bbuf[w][L][0]); B[t + 4][g] = f(shim::bbuf[w][L][1]);
  }
  shim::wbar();
  int g = l >> 2, t = l & 3;
  int rows[4] = {g, g, g + 8, g + 8}, cols[4] = {2 * t, 2 * t + 1, 2 * t, 2 * t + 1};
  for (int i = 0; i < 4; ++i) {
    double s = d[i];
    for (int k = 0; k < 8; ++k) s += (double)A[rows[i]][k] * B[k][cols[i]];
    d[i] = (float)s;
  }
}
