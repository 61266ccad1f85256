// Hopper (sm_90a) dropout kernel for the SegmentHead, bound with ctypes.
//
// Replaces the TPU kernel mds_tpu/ops/pallas/dropout.py (`_apply` :54,
// public `dropout_u8_pallas` :84), which draws its bits from the TPU's
// hardware generator. Here a counter-based Philox4x32-10 (Random123; the
// same function as curand_Philox4x32_10) gives element i of the tensor's
// dense storage, at e = offset + i, the word (e % 4) of
//
//   philox(key = (k0, k1), counter = (e / 4 as 64 bits in words 0-1, 0, 0)).
//
// The element offset (any u64) lets a rank that holds rows of a batch draw
// exactly those rows of the whole batch's mask. e % 4 is the same for every
// vector (a vector starts at a multiple of 8 or 4 elements), so it is a
// template parameter: at SH = offset % 4 = 0 a vector takes its words from
// two (bf16) or one (f32) Philox calls as at offset 0, otherwise from one
// call more, the words picked at compile-time indices.
//
// keep <=> (word >> 24) >= drop; y = keep ? T(float(x) * scale) : 0, with
// `scale` already rounded to T by the caller (a bf16 x bf16 product is exact
// in f32, so one rounding gives the bf16 product). The plain version in
// mds_tpu_torch/ops/dropout.py computes the same bits in torch int64 ops.
//
// Bound: memory. Each element is read once and written once; at the main
// head's shape (16, 1024, 64, 128) bf16 that is 268 MB in + 268 MB out,
// 0.160 ms at an H100 SXM's 3.35 TB/s (data-sheet rate, 700 W), and the five
// dropouts of a bs16 512x1024 step move 0.266 ms worth. Philox costs ~20 integer operations per element, which the
// CUDA cores hide under the memory traffic. Design: one thread handles one
// 16-byte vector (8 bf16 or 4 f32 values: one load, two or one Philox
// calls, one store) in a grid-stride loop over a grid capped at 16 blocks
// per SM; the few trailing elements past the last whole vector are masked
// to one thread. Element counts are 64-bit. x and y must be 16-byte
// aligned (the wrapper sees to it).
//
// The launcher returns the cudaError_t of its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint32_t k0, uint32_t k1,
                                               uint64_t ctr) {
  uint32_t c0 = (uint32_t)ctr, c1 = (uint32_t)(ctr >> 32), c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const uint32_t hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += kW0;
    k1 += kW1;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Two bf16 values packed in one word (element 2k in the low half), each
// with its own random word.
__device__ __forceinline__ uint32_t drop_bf16x2(uint32_t w, uint32_t r_lo,
                                                uint32_t r_hi, uint32_t drop,
                                                float scale) {
  const uint32_t lo =
      (r_lo >> 24) >= drop
          ? __bfloat16_as_ushort(__float2bfloat16_rn(__uint_as_float(w << 16) * scale))
          : 0u;
  const uint32_t hi =
      (r_hi >> 24) >= drop
          ? __bfloat16_as_ushort(
                __float2bfloat16_rn(__uint_as_float(w & 0xffff0000u) * scale))
          : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t drop_f32(uint32_t w, uint32_t r,
                                             uint32_t drop, float scale) {
  return (r >> 24) >= drop ? __float_as_uint(__uint_as_float(w) * scale) : 0u;
}

__device__ __forceinline__ uint32_t word_of(uint4 r, int j) {
  return j == 0 ? r.x : j == 1 ? r.y : j == 2 ? r.z : r.w;
}

// bf16: 8 elements per 16-byte vector; its words are w[SH .. SH + 7] of
// the Philox calls at counters c, c + 1 (and c + 2 when SH != 0).
template <int SH>
__global__ void __launch_bounds__(kThreads)
    dropout_bf16_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                        long long n, uint32_t k0, uint32_t k1, uint32_t drop,
                        float scale, unsigned long long offset) {
  const long long n_vec = n / 8;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint64_t base = offset >> 2;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_vec; t += stride) {
    const uint4 v = x[t];
    const uint64_t c = base + (uint64_t)t * 2;
    const uint4 r0 = philox4x32_10(k0, k1, c);
    const uint4 r1 = philox4x32_10(k0, k1, c + 1);
    const uint4 r2 = SH ? philox4x32_10(k0, k1, c + 2) : r1;
    const uint32_t w[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                            r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
    y[t] = make_uint4(drop_bf16x2(v.x, w[SH], w[SH + 1], drop, scale),
                      drop_bf16x2(v.y, w[SH + 2], w[SH + 3], drop, scale),
                      drop_bf16x2(v.z, w[SH + 4], w[SH + 5], drop, scale),
                      drop_bf16x2(v.w, w[SH + 6], w[SH + 7], drop, scale));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // masked tail, < 8 elements
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
    uint16_t* ys = reinterpret_cast<uint16_t*>(y);
    for (long long i = n_vec * 8; i < n; ++i) {
      const uint64_t e = offset + (uint64_t)i;
      const uint32_t r = word_of(philox4x32_10(k0, k1, e >> 2), (int)(e & 3));
      ys[i] = (uint16_t)drop_bf16x2((uint32_t)xs[i], r, 0u, drop, scale);
    }
  }
}

// f32: 4 elements per 16-byte vector; its words are w[SH .. SH + 3] of the
// Philox calls at counters c (and c + 1 when SH != 0).
template <int SH>
__global__ void __launch_bounds__(kThreads)
    dropout_f32_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                       long long n, uint32_t k0, uint32_t k1, uint32_t drop,
                       float scale, unsigned long long offset) {
  const long long n_vec = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint64_t base = offset >> 2;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_vec; t += stride) {
    const uint4 v = x[t];
    const uint4 r0 = philox4x32_10(k0, k1, base + (uint64_t)t);
    const uint4 r1 = SH ? philox4x32_10(k0, k1, base + (uint64_t)t + 1) : r0;
    const uint32_t w[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    y[t] = make_uint4(drop_f32(v.x, w[SH], drop, scale),
                      drop_f32(v.y, w[SH + 1], drop, scale),
                      drop_f32(v.z, w[SH + 2], drop, scale),
                      drop_f32(v.w, w[SH + 3], drop, scale));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // masked tail, < 4 elements
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(x);
    uint32_t* ys = reinterpret_cast<uint32_t*>(y);
    for (long long i = n_vec * 4; i < n; ++i) {
      const uint64_t e = offset + (uint64_t)i;
      const uint32_t r = word_of(philox4x32_10(k0, k1, e >> 2), (int)(e & 3));
      ys[i] = drop_f32(xs[i], r, drop, scale);
    }
  }
}

template <int SH>
void launch(bool is_f32, unsigned blocks, cudaStream_t s, const uint4* x, uint4* y,
            long long n, uint32_t k0, uint32_t k1, uint32_t drop, float scale,
            unsigned long long offset) {
  if (is_f32)
    dropout_f32_kernel<SH><<<blocks, kThreads, 0, s>>>(x, y, n, k0, k1, drop, scale,
                                                        offset);
  else
    dropout_bf16_kernel<SH><<<blocks, kThreads, 0, s>>>(x, y, n, k0, k1, drop, scale,
                                                         offset);
}

}  // namespace

extern "C" int mds_dropout_u8(const void* x, void* y, long long n, int is_f32,
                              long long k0, long long k1, int drop,
                              float scale, long long offset, void* stream) {
  if (n <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_vec = n / (is_f32 ? 4 : 8);
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  if (blocks < 1) blocks = 1;
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* yv = static_cast<uint4*>(y);
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned long long off = (unsigned long long)offset;
  const unsigned b = (unsigned)blocks;
  const uint32_t a0 = (uint32_t)k0, a1 = (uint32_t)k1, d = (uint32_t)drop;
  switch (off & 3) {
    case 0: launch<0>(is_f32, b, s, xv, yv, n, a0, a1, d, scale, off); break;
    case 1: launch<1>(is_f32, b, s, xv, yv, n, a0, a1, d, scale, off); break;
    case 2: launch<2>(is_f32, b, s, xv, yv, n, a0, a1, d, scale, off); break;
    default: launch<3>(is_f32, b, s, xv, yv, n, a0, a1, d, scale, off); break;
  }
  return (int)cudaGetLastError();
}
