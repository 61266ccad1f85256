// Hopper (sm_90a) kernel for the DetailBranch tail of BiSeNetV2, bound with
// ctypes.
//
// Replaces mds_tpu/ops/pallas/stem.py::detail_tail_fused (:1148-1226, body
// _tail_kernel :980-1145): S2_2 (3x3, 64->64) -> S2_3 (3x3, 64->64) ->
// S3_1 (3x3 s2, 64->128) -> S3_2 (3x3, 128->128) -> S3_3 (3x3, 128->128),
// every BN folded, every conv followed by a ReLU, from the /4 output of
// detail_s1s2_fused (B, H4, W4, 64) bf16 NHWC to the /8 detail feature
// (B, H4/2, W4/2, 128) bf16 NHWC; H4 and W4 even.
//
// Rounding points are the TPU kernel's: the weights are bf16(k * scale), the
// bias is f32 and added to the f32 sum, then the ReLU, and every stage is
// rounded to bf16. Out-of-image positions of every intermediate are the next
// conv's zero padding, never ReLU(bias) (stem.py:1056-1064, :1074-1082).
//
// Bound: arithmetic. At (1, 256, 512, 64) the five convs are 43.5 GFLOP
// (0.044 ms on the bf16 tensor cores) against 25 MB moved (0.0075 ms). The
// TPU kernel's point, kept here: no /4 or /8 intermediate reaches device
// memory. Design: persistent blocks, one per SM (the tile takes nearly all
// of the 227 KB of shared memory), walk 8x8 tiles of the /8 output. A tile
// stages its input with the halo of all five convs (29 x 29 pixels at /4)
// with cp.async, zero-filled outside the image, and keeps each stage in one
// of two shared-memory buffers that swap roles: input (A) -> S2_2 (B) ->
// S2_3 (A) -> S3_1 (B) -> S3_2 (A) -> S3_3 to device memory. Each stage is
// an implicit GEMM on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate): M = the stage's pixels, two 16-pixel M tiles per warp item,
// N = 64 output channels per item, K = 9 taps x the input channels. The
// weights do not fit in shared memory (the three 128-channel convs hold
// 737 KB in bf16); they are pre-packed in B-fragment order and read from
// L2, each fragment feeding two M tiles. The halo recomputes about as many
// MACs again as the tile's own (2.0x in all; the TPU kernel paid 1.6x).

#include "mma.cuh"

namespace {

constexpr int kT = 8;                  // /8 output tile: kT x kT pixels
constexpr int kIn = 2 * kT + 13;       // input region side at /4 (29)
constexpr int kD = 2 * kT + 11;        // S2_2 region side at /4 (27)
constexpr int kE = 2 * kT + 9;         // S2_3 region side at /4 (25)
constexpr int kF = kT + 4;             // S3_1 region side at /8 (12)
constexpr int kG = kT + 2;             // S3_2 region side at /8 (10)
constexpr int kCS64 = 72;              // pixel stride of 64-channel stages
constexpr int kCS128 = 136;            // pixel stride of 128-channel stages
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int cmax(int a, int b) { return a > b ? a : b; }
// buffer A: the input, S2_3, S3_2; buffer B: S2_2, S3_1 (in elements)
constexpr int kBufA = cmax(kIn * kIn * kCS64, cmax(kE * kE * kCS64, kG * kG * kCS128));
constexpr int kBufB = cmax(kD * kD * kCS64, kF * kF * kCS128);
constexpr size_t kSmem = (size_t)(kBufA + kBufB) * sizeof(bf16);
static_assert(kSmem <= 232448, "over the 227 KB a block may opt into");

// The packed weights of the five convs, one array: B fragments (uint2)
// [tap][kc][n-tile][lane] per conv, in this order; biases likewise, f32.
constexpr int kW64 = 9 * 4 * 8 * 32, kW6 = 9 * 4 * 16 * 32,
              kW128 = 9 * 8 * 16 * 32;
constexpr int kOffW4 = 0, kOffW5 = kW64, kOffW6 = 2 * kW64,
              kOffW7 = 2 * kW64 + kW6, kOffW8 = 2 * kW64 + kW6 + kW128;
constexpr int kOffB4 = 0, kOffB5 = 64, kOffB6 = 128, kOffB7 = 256,
              kOffB8 = 384;

// One conv stage: dst pixel (i, j) of a kDst x kDst region with origin
// (r0, c0) in a grid of (Hd, Wd) pixels <- ReLU(bias + conv over the src
// pixels (S*i + dy, S*j + dx)), src a kSrc-wide region of KC * 16 channels
// at stride kSrcCS; kN output channels. Out-of-image pixels are written as
// zero to a shared-memory dst (row stride kDstCS), skipped when `gout` (the
// last stage) is given instead.
template <int kSrc, int kSrcCS, int KC, int S, int kDst, int kDstCS, int kN>
__device__ __forceinline__ void tail_stage(const bf16* src,
                                           const uint2* __restrict__ wp,
                                           const float* __restrict__ bias,
                                           bf16* dst, bf16* gout, int r0,
                                           int c0, int Hd, int Wd) {
  constexpr int kM = kDst * kDst;
  constexpr int kPairs = ((kM + 15) / 16 + 1) / 2;
  constexpr int kNH = kN / 64;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  for (int item = warp; item < kPairs * kNH; item += kWarps) {
    const int pr = item / kNH, nh = item % kNH;
    int ms[4], base[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ms[k] = (2 * pr + k / 2) * 16 + gq + 8 * (k % 2);
      const int mc = min(ms[k], kM - 1);  // past M: load a real row, skip it
      base[k] = (S * (mc / kDst) * kSrc + S * (mc % kDst)) * kSrcCS + tq * 2;
    }
    float acc[2][8][4];
    conv3x3_mma<kSrc, kSrcCS, KC, 8, 2>(src, base, wp + nh * 8 * 32, kN / 8,
                                        8, lane, acc);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int m = ms[k], t = k / 2, h = k % 2;
      if (m >= kM) continue;
      const int r = r0 + m / kDst, c = c0 + m % kDst;
      const bool in = r >= 0 && r < Hd && c >= 0 && c < Wd;
      bf16* o;
      if (gout) {
        if (!in) continue;
        o = gout + ((size_t)r * Wd + c) * kN + nh * 64;
      } else {
        o = dst + m * kDstCS + nh * 64;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + tq * 2;
        float v0 = 0.f, v1 = 0.f;
        if (in) {
          v0 = fmaxf(acc[t][nt][2 * h] + __ldg(bias + nh * 64 + col), 0.f);
          v1 = fmaxf(acc[t][nt][2 * h + 1] + __ldg(bias + nh * 64 + col + 1),
                     0.f);
        }
        *reinterpret_cast<uint32_t*>(o + col) = pack2(v0, v1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    detail_tail_kernel(const bf16* __restrict__ y,
                       const uint2* __restrict__ wp,
                       const float* __restrict__ bp, bf16* __restrict__ out,
                       int B, int H4, int W4) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bufA = reinterpret_cast<bf16*>(smem);
  bf16* bufB = bufA + kBufA;
  const int H8 = H4 / 2, W8 = W4 / 2;
  const int tiles_x = (W8 + kT - 1) / kT, tiles_y = (H8 + kT - 1) / kT;
  const int tiles = tiles_x * tiles_y * B;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    const int q0 = ty * kT, p0 = tx * kT;  // the tile's origin at /8
    // the input region: /4 rows and cols from 2 * origin - 7
    const bf16* yb = y + (size_t)b * H4 * W4 * 64;
    const int R = 2 * q0 - 7, C = 2 * p0 - 7;
    for (int i = threadIdx.x; i < kIn * kIn * 8; i += kThreads) {
      const int q = i % 8, pix = i / 8;
      const int r = R + pix / kIn, c = C + pix % kIn;
      const bool ok = r >= 0 && r < H4 && c >= 0 && c < W4;
      const bf16* src = ok ? yb + ((size_t)r * W4 + c) * 64 + q * 8 : yb;
      cp_async16(bufA + pix * kCS64 + q * 8, src, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // S2_2: input (A) -> B, /4 region from 2 * origin - 6
    tail_stage<kIn, kCS64, 4, 1, kD, kCS64, 64>(
        bufA, wp + kOffW4, bp + kOffB4, bufB, nullptr, R + 1, C + 1, H4,
        W4);
    __syncthreads();
    // S2_3: B -> A, from 2 * origin - 5
    tail_stage<kD, kCS64, 4, 1, kE, kCS64, 64>(
        bufB, wp + kOffW5, bp + kOffB5, bufA, nullptr, R + 2, C + 2, H4,
        W4);
    __syncthreads();
    // S3_1 (stride 2): A -> B, /8 region from origin - 2
    tail_stage<kE, kCS64, 4, 2, kF, kCS128, 128>(
        bufA, wp + kOffW6, bp + kOffB6, bufB, nullptr, q0 - 2, p0 - 2, H8,
        W8);
    __syncthreads();
    // S3_2: B -> A, from origin - 1
    tail_stage<kF, kCS128, 8, 1, kG, kCS128, 128>(
        bufB, wp + kOffW7, bp + kOffB7, bufA, nullptr, q0 - 1, p0 - 1, H8,
        W8);
    __syncthreads();
    // S3_3: A -> the output tile
    tail_stage<kG, kCS128, 8, 1, kT, 0, 128>(
        bufA, wp + kOffW8, bp + kOffB8, nullptr,
        out + (size_t)b * H8 * W8 * 128, q0, p0, H8, W8);
    __syncthreads();  // the next tile's input overwrites A
  }
}

}  // namespace

// ------------------------------------------------------------ C interface

extern "C" int mds_detail_tail_fused(const void* y, const void* wp,
                                     const void* bp, void* out, int B, int H4,
                                     int W4, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(detail_tail_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((W4 / 2 + kT - 1) / kT) * ((H4 / 2 + kT - 1) / kT) * B;
  const long long blocks = tiles < sms ? tiles : sms;
  detail_tail_kernel<<<(unsigned)blocks, kThreads, kSmem,
                       (cudaStream_t)stream>>>(
      static_cast<const bf16*>(y), static_cast<const uint2*>(wp),
      static_cast<const float*>(bp), static_cast<bf16*>(out), B, H4, W4);
  return (int)cudaGetLastError();
}
