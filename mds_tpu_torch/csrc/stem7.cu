// Hopper (sm_90a) kernel for the 7x7 RGB stem of BiSeNetV1, bound with ctypes.
//
// Replaces mds_tpu/ops/pallas/stem.py::stem7_conv_bn_relu_s2 (:911, body
// _kernel7 :855-907): a 7x7 stride-2 pad-3 conv on a bf16 NHWC RGB image
// (B, H, W, 3), H and W even, with the eval BN folded in and an optional
// ReLU, bf16 NHWC out (B, H/2, W/2, O), O % 8 == 0, O <= 128. It is the
// ResNet18 conv1 and the SpatialPath conv1 of BiSeNetV1.
//
// Rounding points are the TPU kernel's: the weight is bf16(k * scale), the
// bias bf16(bias); the products of bf16 values accumulate in f32, the bias is
// added, then the ReLU, then one rounding to bf16.
//
// Bound: memory. At 1024x2048 with O = 64 the conv reads 12.6 MB and writes
// 67.1 MB (0.024 ms at 3.35 TB/s) for 9.9 GFLOP (0.010 ms at 989 TFLOP/s).
// Design: an implicit GEMM on the tensor cores with mma.sync m16n8k16 (bf16
// in, f32 accumulate): M = output pixels, N = output channels in groups of
// 64, K = 7 kernel rows x 22 taps, padded to 160. In NHWC at stride 2 the
// 21 taps (dx, ci) of one kernel row of an output pixel are 21 consecutive
// elements of the input row, starting at element 6 * (output column); a
// 22nd tap of weight zero keeps every pair of taps in one 4-byte word, so
// each A register is one 32-bit shared-memory load (the 22nd tap's half and
// the padding past K = 154 are masked to zero, so they never touch a
// non-finite input). Blocks are persistent: each loads the B fragments (the
// folded weights, pre-packed by the wrapper) into shared memory once, then
// walks 8x32 output tiles: the 21x70x3 input window goes to shared memory
// (zero outside the image: the conv's padding), each warp computes one output
// row as two M tiles, and the results go through shared memory to 16-byte
// stores, a row of the tile being contiguous in NHWC. Ragged tiles compute on
// the zero window and skip their stores, so any even H and W work.
//
// The launcher returns the cudaError_t of its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kTH = 8;                 // output rows per tile, one per warp
constexpr int kTW = 32;                // output cols per tile: two M tiles
constexpr int kThreads = 32 * kTH;     // 256
constexpr int kInRows = 2 * kTH + 5;   // input rows of a tile's window (21)
constexpr int kInCols = 2 * kTW + 6;   // input cols, the 22nd tap's too (70)
constexpr int kRS = kInCols * 3;       // window row stride in elements (even)
constexpr int kKRow = 22;              // K per kernel row: 21 taps + 1 zero
constexpr int kK = 7 * kKRow;          // K in use (154)
constexpr int kKC = 10;                // K chunks of 16 (160)
constexpr int kOutStride = 72;         // staged output stride (bank spread)

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
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

__host__ __device__ constexpr size_t stem7_smem(int nt) {
  return (size_t)kKC * nt * 32 * sizeof(uint2) +
         (size_t)kTH * kTW * kOutStride * sizeof(bf16) +
         (size_t)kInRows * kRS * sizeof(bf16);
}

// wfrag: the (160, O) bf16 weight matrix, row k = dy * 22 + dx * 3 + ci, as
// mma.sync B fragments [kc][n-tile][lane][4], lane = n * 4 + t holding rows
// 2t, 2t+1, 2t+8, 2t+9 of chunk kc. bias: bf16(bias) as f32, (O,).
__global__ void __launch_bounds__(kThreads, 2)
    stem7_kernel(const bf16* __restrict__ x, const uint2* __restrict__ wfrag,
                 const float* __restrict__ bias, bf16* __restrict__ out, int B,
                 int H, int W, int O, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NT = O / 8;
  uint2* ws = reinterpret_cast<uint2*>(smem);
  bf16* os = reinterpret_cast<bf16*>(smem + (size_t)kKC * NT * 32 * sizeof(uint2));
  bf16* win = os + kTH * kTW * kOutStride;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  for (int i = tid; i < kKC * NT * 32; i += kThreads) ws[i] = wfrag[i];

  // this lane's K pairs: slot s = 2 * kc + h holds rows kc*16 + 8h + 2tq and
  // the next. meta[s] packs their window offset from the pixel's origin (low
  // 16 bits) with the right shift of an all-ones mask (high bits): 16 keeps
  // only the first of the pair (the second is a row's 22nd tap), 32 zeroes
  // both (K padding)
  uint32_t meta[2 * kKC];
#pragma unroll
  for (int s = 0; s < 2 * kKC; ++s) {
    const int k = (s >> 1) * 16 + (s & 1) * 8 + 2 * tq;
    const int j = k % kKRow;
    meta[s] = k >= kK ? 32u << 16
                      : (uint32_t)((k / kKRow) * kRS + j) |
                            ((j == kKRow - 2 ? 16u : 0u) << 16);
  }
  // the lane's four A rows: M tile t, half h → output column 16t + 8h + gq,
  // whose window origin is 6 * column in the warp's window row
  int pb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pb[i] = 6 * ((i >> 1) * 16 + (i & 1) * 8 + gq);

  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + kTW - 1) / kTW, tiles_y = (H2 + kTH - 1) / kTH;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int tx = (int)(t % tiles_x);
    const long long tt = t / tiles_x;
    const int ty = (int)(tt % tiles_y), b = (int)(tt / tiles_y);
    const int r0 = ty * kTH, c0 = tx * kTW;
    const bf16* xb = x + (size_t)b * H * W * 3;

    // the input window: rows from 2*r0 - 3, cols from 2*c0 - 3, zero outside
    // the image (no warp reads the window of the previous tile any more: the
    // last store pass below ends in a barrier)
    const int y0 = 2 * r0 - 3, x0 = 2 * c0 - 3;
    for (int i = tid; i < kInRows * kRS; i += kThreads) {
      const int rr = i / kRS, e = i - rr * kRS;
      const int y = y0 + rr, xc = x0 + e / 3;
      unsigned short v = 0;
      if (y >= 0 && y < H && xc >= 0 && xc < W)
        v = reinterpret_cast<const unsigned short*>(xb)[((size_t)y * W + xc) * 3 + e % 3];
      reinterpret_cast<unsigned short*>(win)[i] = v;
    }
    __syncthreads();

    const bf16* wrow = win + 2 * warp * kRS;  // output row r0 + warp
    for (int n0 = 0; n0 < NT; n0 += 8) {
      float acc[2][8][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[m][nt][q] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKC; ++kc) {
        const int o0 = meta[2 * kc] & 0xffff, o1 = meta[2 * kc + 1] & 0xffff;
        const uint32_t k0 = __funnelshift_rc(0xffffffffu, 0u, meta[2 * kc] >> 16);
        const uint32_t k1 = __funnelshift_rc(0xffffffffu, 0u, meta[2 * kc + 1] >> 16);
        uint32_t a[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          a[m][0] = ld_b32(wrow + pb[2 * m] + o0) & k0;
          a[m][1] = ld_b32(wrow + pb[2 * m + 1] + o0) & k0;
          a[m][2] = ld_b32(wrow + pb[2 * m] + o1) & k1;
          a[m][3] = ld_b32(wrow + pb[2 * m + 1] + o1) & k1;
        }
        const uint2* wk = ws + ((size_t)kc * NT + n0) * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (n0 + nt < NT) {
            const uint2 bv = wk[nt * 32];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              mma_bf16_16816(acc[m][nt], a[m][0], a[m][1], a[m][2], a[m][3],
                             bv.x, bv.y);
          }
        }
      }
      // epilogue: + bias, ReLU, bf16, staged as [pixel][channel of group]
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (n0 + nt >= NT) continue;
        const int col = nt * 8 + 2 * tq;
        const float b0 = __ldg(bias + n0 * 8 + col);
        const float b1 = __ldg(bias + n0 * 8 + col + 1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = i >> 1, h = i & 1;
          float v0 = acc[m][nt][2 * h] + b0, v1 = acc[m][nt][2 * h + 1] + b1;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          const int p = warp * kTW + m * 16 + h * 8 + gq;
          *reinterpret_cast<uint32_t*>(os + p * kOutStride + col) = pack2(v0, v1);
        }
      }
      __syncthreads();
      // 16-byte stores: consecutive threads, consecutive 16 bytes of a row
      const int nv = min(8, NT - n0);  // 16-byte vectors per pixel
      for (int i = tid; i < kTH * kTW * nv; i += kThreads) {
        const int p = i / nv, v = i - p * nv;
        const int r = r0 + p / kTW, c = c0 + p % kTW;
        if (r < H2 && c < W2)
          *reinterpret_cast<uint4*>(out + (((size_t)b * H2 + r) * W2 + c) * O +
                                    n0 * 8 + v * 8) =
              *reinterpret_cast<const uint4*>(os + p * kOutStride + v * 8);
      }
      __syncthreads();
    }
  }
}

}  // namespace

// ------------------------------------------------------------ C interface

extern "C" int mds_stem7_conv_bn_relu_s2(const void* x, const void* wfrag,
                                         const void* bias, void* out, int B,
                                         int H, int W, int O, int relu,
                                         void* stream) {
  const size_t smem = stem7_smem(O / 8);
  cudaError_t err = cudaFuncSetAttribute(
      stem7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stem7_kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)B * ((H / 2 + kTH - 1) / kTH) *
                          ((W / 2 + kTW - 1) / kTW);
  const long long cap = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const long long blocks = tiles < cap ? tiles : cap;
  stem7_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint2*>(wfrag),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W, O,
      relu);
  return (int)cudaGetLastError();
}
