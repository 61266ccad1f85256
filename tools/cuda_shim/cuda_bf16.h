// CPU stand-in for the CUDA runtime: one std::thread per CUDA thread,
// std::barrier for __syncthreads/__syncwarp and the named and warpgroup
// barriers, wgmma emulated per warpgroup.
#pragma once
#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }

struct __nv_bfloat16 { uint16_t b; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __uint_as_float(uint32_t u) { float f; memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; memcpy(&u, &f, 4); return u; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) { return __uint_as_float(uint32_t(h.b) << 16); }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.b; }
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
inline __nv_bfloat162 __hmax2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return {__bfloat162float(a.x) >= __bfloat162float(b.x) ? a.x : b.x,
          __bfloat162float(a.y) >= __bfloat162float(b.y) ? a.y : b.y};
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return uint32_t((uint64_t(a) * b) >> 32); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __double2float_rn(double a) { return float(a); }
[[noreturn]] inline void __trap() { abort(); }
using std::min;
using std::max;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
enum { cudaDevAttrMultiProcessorCount = 16 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
int shim_sms();
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = shim_sms(); return 0; }
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }

struct ShimBlock {
  std::vector<unsigned char> smem;
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<uint32_t> frag;  // [warp][lane][6]: ldmatrix's and stmatrix's rows
  std::vector<std::unique_ptr<std::barrier<>>> wgbar;  // per warpgroup
  std::vector<uint32_t> wgfrag;  // [warpgroup][thread][4]: wgmma's A
  std::mutex mu;                 // guards `named`
  std::map<int, std::unique_ptr<std::barrier<>>> named;  // bar.sync ids
  dim3 idx;
};
extern thread_local ShimBlock* shim_blk;
extern thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline unsigned char* shim_smem() { return shim_blk->smem.data(); }
// a kernel's static __shared__ arrays, one after the other in the block's
// shared memory, in the order the kernel declares them (the same in every
// thread: each starts from offset 0)
extern thread_local size_t shim_static_off;
inline unsigned char* shim_static(size_t bytes) {
  unsigned char* p = shim_smem() + shim_static_off;
  shim_static_off += (bytes + 15) & ~size_t(15);
  return p;
}
inline void __syncthreads() { shim_blk->bar->arrive_and_wait(); }
inline void __syncwarp() { shim_blk->wbar[threadIdx.x / 32]->arrive_and_wait(); }

template <class K>
struct ShimLaunch {
  K k; dim3 g, b; size_t smem;
  template <class... A> void operator()(A... args) {
    const int nb = g.x * g.y * g.z, nt = b.x * b.y * b.z;
    const int par = std::max(1, 2048 / nt);
    for (int b0 = 0; b0 < nb; b0 += par) {
      std::vector<std::unique_ptr<ShimBlock>> blks;
      std::vector<std::thread> ths;
      for (int bi = b0; bi < std::min(nb, b0 + par); ++bi) {
        auto blk = std::make_unique<ShimBlock>();
        // dynamic shared memory, or the 48 KB static arrays may take;
        // garbage, not zeros
        blk->smem.assign(std::max<size_t>(smem, 49152), 0xA5);
        blk->bar = std::make_unique<std::barrier<>>(nt);
        for (int w = 0; w < (nt + 31) / 32; ++w)
          blk->wbar.push_back(std::make_unique<std::barrier<>>(32));
        blk->frag.assign((nt + 31) / 32 * 32 * 6, 0);
        for (int w = 0; w < nt / 128; ++w)
          blk->wgbar.push_back(std::make_unique<std::barrier<>>(128));
        blk->wgfrag.assign(std::max(nt / 128, 1) * 128 * 4, 0);
        blk->idx = dim3(bi % g.x, (bi / g.x) % g.y, bi / (g.x * g.y));
        ShimBlock* bp = blk.get();
        for (int t = 0; t < nt; ++t)
          ths.emplace_back([=, this]() {
            shim_blk = bp; blockIdx = bp->idx; blockDim = b; gridDim = g;
            shim_static_off = 0;
            threadIdx = dim3(t % b.x, (t / b.x) % b.y, t / (b.x * b.y));
            k(args...);
          });
        blks.push_back(std::move(blk));
      }
      for (auto& th : ths) th.join();
    }
  }
};
template <class K>
ShimLaunch<K> shim_launch(K k, dim3 g, dim3 b, size_t smem = 0, cudaStream_t = nullptr) {
  return {k, g, b, smem};
}
inline uint32_t __funnelshift_rc(uint32_t lo, uint32_t hi, uint32_t sh) {
  sh = std::min(sh, 32u);
  const uint64_t v = (uint64_t(hi) << 32) | lo;
  return uint32_t(v >> sh);
}
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
