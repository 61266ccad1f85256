// Hopper (sm_90a) helpers shared by the warpgroup-MMA kernels of the port
// (stem.cu, stem7.cu, conv3x3.cu, detail_tail.cu) and by depthwise.cu's
// window kernel: wgmma.mma_async m64nNk16 (N = 16, 32, 64, 128) with A from
// registers and B from shared memory through a matrix descriptor, its
// fence/commit/wait, ldmatrix and stmatrix, mbarriers, the bulk copies
// (cp.async.bulk) global to shared, completing on an mbarrier, and shared to
// global in bulk groups, the tensor copy (TMA) of a 4-d box through a tensor
// map, and named barriers. Raw PTX, as in mma.cuh.
//
// The B operand layout (what ops/conv3x3.py and ops/stem.py pack): a slice
// is one (tap, 64-deep K chunk, 64-wide N chunk) of a 3x3 conv's weight,
// 8192 bytes: row n (output channel) at n * 128 bytes holds the 64 K values
// (input channels) in eight 16-byte chunks, logical chunk c stored at chunk
// c ^ (n & 7). That is wgmma's K-major canonical layout with the 128-byte
// swizzle when the slice starts on a 1024-byte boundary of shared memory:
// 8-row groups 1024 bytes apart (the descriptor's stride byte offset), and
// the hardware XORs address bits [4:7) with bits [7:10). A k16 step inside
// the slice is the descriptor's start address plus 32 bytes per step.
//
// Activations in shared memory use the same 16-byte XOR on pixel index:
// chunk q of pixel p (16 bytes, 8 channels) at ((q & ~7) | ((q ^ p) & 7)),
// so the eight row addresses of one ldmatrix phase, eight pixels in a row,
// land in eight distinct bank groups.

#pragma once

#include <cuda.h>  // CUtensorMap

#include "mma.cuh"

namespace {

// -- PTX begin (tools/cuda_shim/wgmma_impl.h stands in for this section)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8, row
// l % 8, and receives (row l / 4, cols 2 (l % 4), +1) of each in r[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator register
// across the wgmma fence/wait around it.
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// D(64x64, f32) += A(64x16, bf16, registers) * B(16x64, bf16, shared memory
// at descriptor b, K-major). Warp w of the warpgroup holds rows 16w..16w+15
// of A as an mma.sync m16n8k16 A fragment, and of D: d[4j + e] is row
// 16w + lane / 4 + 8 (e / 2), column 8j + 2 (lane % 4) + e % 2.
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same with N = 16 and N = 32 (B 16 or 32 rows, d[4j + e] for j < 2, 4).
__device__ __forceinline__ void wgmma_m64n16k16(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n32k16(float* d, const uint32_t* a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The same with N = 128: B is 128 rows (two 64-row slices back to back),
// d[4j + e] is column 8j + 2 (lane % 4) + e % 2, j < 16.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the mbarrier inits visible to the async proxy (the bulk copies).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` more of transfers on the barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// True once the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the copy engine; completes as transfer bytes on `bar`.
__device__ __forceinline__ void bulk_g2s(void* smem, const void* gmem,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The box of the 4-d tensor map `map` (a __grid_constant__ kernel parameter)
// whose first element sits at coordinates (c0, c1, c2, c3), innermost first,
// from global to shared memory (128-byte aligned) by the copy engine, dense
// in box order; elements outside the tensor arrive as zeros. Completes as the
// box's bytes, all of them, on `bar`.
__device__ __forceinline__ void tma_load_4d(void* smem, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(smem)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// Four (x4), two (x2) or one (x1) 8x8 b16 matrices from registers to shared
// memory, ldmatrix's inverse: lane l gives the row address of matrix l / 8,
// row l % 8 (lanes past the count give none), and r[i] holds (row l / 4,
// cols 2 (l % 4), +1) of matrix i, an mma accumulator fragment packed to
// bf16.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t* r) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
          addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ void stmatrix_x2(uint32_t addr, const uint32_t* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x2.shared.b16 [%0], {%1, %2};\n" ::"r"(
                   addr),
               "r"(r[0]), "r"(r[1])
               : "memory");
}

__device__ __forceinline__ void stmatrix_x1(uint32_t addr, uint32_t r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x1.shared.b16 [%0], {%1};\n" ::"r"(addr),
               "r"(r)
               : "memory");
}

// bf16(max(lo, 0)) and bf16(max(hi, 0)) in one word, lo in the low half
// (pack2 with the ReLU in the rounding instruction).
__device__ __forceinline__ uint32_t pack2_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Makes this thread's ordinary writes to shared memory visible to the copy
// engine (the bulk copies that read them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from shared to
// global memory by the copy engine, in this thread's open bulk group.
__device__ __forceinline__ void bulk_s2g(void* gmem, const void* smem,
                                         uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem),
      "r"(smem_u32(smem)), "r"(bytes)
      : "memory");
}

// Closes this thread's open bulk group.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's bulk groups still read their shared
// sources (their writes may still be in flight).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Until at most N of this thread's bulk groups are still in flight.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over the first `n` threads to
// reach it, n a multiple of 32.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// -- PTX end

// A wait that never ends (a schedule fault) traps after ~2^28 polls instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 28)) __trap();
}

// The descriptor of a K-major B operand with the 128-byte swizzle starting at
// shared address `addr` (its 1024-byte pattern aligned as the slice is):
// start address >> 4 in bits [0, 14), leading byte offset (unused by
// swizzled K-major layouts, 16) in [16, 30), stride byte offset 1024 between
// 8-row groups in [32, 46), base offset 0, layout type 1 (128B) in [62, 64).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma m64nNk16 for N in {16, 32, 64, 128}, chosen at compile time.
template <int N>
__device__ __forceinline__ void wgmma_m64nk16(float* d, const uint32_t* a,
                                              uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma N");
  if constexpr (N == 16) wgmma_m64n16k16(d, a, b);
  else if constexpr (N == 32) wgmma_m64n32k16(d, a, b);
  else if constexpr (N == 64) wgmma_m64n64k16(d, a, b);
  else wgmma_m64n128k16(d, a, b);
}

// Byte offset of 16-byte chunk q of pixel p in an activation buffer of
// `pix_bytes`-byte pixels (see the header).
__device__ __forceinline__ uint32_t swz(int p, int q, int pix_bytes) {
  return (uint32_t)(p * pix_bytes + (((q & ~7) | ((q ^ p) & 7)) << 4));
}

}  // namespace
