// Device helpers shared by the tensor-core kernels of the port (stem.cu,
// conv3x3.cu, detail_tail.cu): bf16 packing, mma.sync m16n8k16 with bf16 in
// and f32 accumulate, cp.async with zero-fill, and the implicit-GEMM loop of
// a 3x3 conv over activations held in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

__device__ __forceinline__ uint32_t ld_b32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A(16x16, row) * B(16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float* d, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Asynchronous copies into shared memory; `src_bytes` below the copy's size
// fills the rest with zeros (0: all zeros, `gmem` not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The implicit GEMM of a 3x3 conv: MT 16-pixel M tiles of one warp against
// NT 8-wide n tiles, K = 9 taps x KC chunks of 16 input channels, the
// activations in shared memory as pixels of kChStride elements, rows of
// kRowStep pixels. base[2t], base[2t+1] are the element offsets of the
// lane's two A rows of tile t at tap (0, 0), channel 2*(lane & 3). wp holds
// the weights as B fragments [tap][kc][n-tile][lane] (uint2: k = 2t, 2t+1,
// 2t+8, 2t+9 of the chunk for lane n*4 + t), with `nts` n tiles per (tap,
// kc) and this call's first n tile at wp; tiles nt >= n_act are skipped.
// Each B fragment, one 8-byte load per lane, feeds MT mma.
template <int kRowStep, int kChStride, int KC, int NT, int MT>
__device__ __forceinline__ void conv3x3_mma(const bf16* src, const int* base,
                                            const uint2* __restrict__ wp,
                                            int nts, int n_act, int lane,
                                            float (*acc)[NT][4]) {
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[t][nt][k] = 0.f;
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int off = ((tap / 3) * kRowStep + (tap % 3)) * kChStride;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[MT][4];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const bf16* p0 = src + base[2 * t] + off + kc * 16;
        const bf16* p1 = src + base[2 * t + 1] + off + kc * 16;
        a[t][0] = ld_b32(p0);
        a[t][1] = ld_b32(p1);
        a[t][2] = ld_b32(p0 + 8);
        a[t][3] = ld_b32(p1 + 8);
      }
      const uint2* wk = wp + (size_t)((tap * KC + kc) * nts) * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (nt >= n_act) break;
        const uint2 bv = __ldg(wk + nt * 32);
#pragma unroll
        for (int t = 0; t < MT; ++t)
          mma_bf16_16816(acc[t][nt], a[t][0], a[t][1], a[t][2], a[t][3], bv.x,
                         bv.y);
      }
    }
  }
}

}  // namespace
