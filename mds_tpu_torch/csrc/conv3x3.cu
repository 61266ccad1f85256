// Hopper (sm_90a) kernel for the fused eval 3x3 conv, bound with ctypes.
//
// Replaces mds_tpu/ops/pallas/conv3x3.py::conv3x3_bn_relu_pallas (:69-128,
// body _kernel :28-66): a 3x3 stride-1 pad-1 conv on a bf16 NHWC input
// (B, H, W, Cin), Cin <= 64, then y = acc * scale + bias per output channel,
// an optional ReLU and one rounding to bf16, NHWC out (B, H, W, Cout),
// Cout % 8 == 0. Rounding points are the TPU kernel's: the weight is bf16(k)
// *unscaled*, the products accumulate in f32, and the folded BN's scale and
// bias apply to the f32 sum.
//
// Bound: about even. At DetailBranch S1_2's shape (1, 512, 1024, 64 -> 64)
// the conv is 38.7 GFLOP (0.039 ms on the bf16 tensor cores) and moves
// 134 MB (0.040 ms). Design: an implicit GEMM on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate): M = output pixels, N = output
// channels in groups of 64, K = 9 taps x Cin padded to a multiple of 16 (the
// pad channels are zero in shared memory). One block per 8x32 output tile:
// the input tile and its one-pixel halo (10 x 34 pixels) go to shared memory
// with cp.async, zero-filled outside the image (the conv's padding); each
// warp computes one output row as two M tiles against the weights, pre-packed
// once per call in B-fragment order and read from L1/L2; the epilogue stages
// each M tile's results in shared memory so the stores are 16 bytes wide.
// Ragged tiles compute on the zero window and skip their stores, so any H,
// W and B work.
//
// The launcher returns the cudaError_t of its launch (0 on success).

#include "mma.cuh"

namespace {

constexpr int kTH = 8;                  // output rows per tile, one per warp
constexpr int kTW = 32;                 // output cols per tile: two M tiles
constexpr int kThreads = 32 * kTH;      // 256
constexpr int kWinR = kTH + 2;          // input rows of a tile's window (10)
constexpr int kWinC = kTW + 2;          // input cols (34)
constexpr int kOutStride = 72;          // staged output stride (bank spread)

// A pixel of the window holds the KC * 16 (padded) channels and 8 more, so
// that the rows of one A fragment fall in distinct banks.
template <int KC>
__host__ __device__ constexpr int win_stride() {
  return KC * 16 + 8;
}

template <int KC>
constexpr size_t conv3x3_smem() {
  return (size_t)kWinR * kWinC * win_stride<KC>() * sizeof(bf16) +
         (size_t)(kThreads / 32) * 16 * kOutStride * sizeof(bf16);
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const bf16* __restrict__ x, const uint2* __restrict__ wp,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int H, int W, int Cin, int Cout, int relu) {
  constexpr int kCS = win_stride<KC>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* stage = win + kWinR * kWinC * kCS + warp * 16 * kOutStride;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW, b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * Cin;

  // the window, every channel chunk of 8 including the zero padding
  if (Cin % 8 == 0) {
    constexpr int kChunks = KC * 2;
    for (int i = threadIdx.x; i < kWinR * kWinC * kChunks; i += kThreads) {
      const int q = i % kChunks, pix = i / kChunks;
      const int iy = y0 - 1 + pix / kWinC, ix = x0 - 1 + pix % kWinC;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && q * 8 < Cin;
      const bf16* src = ok ? xb + ((size_t)iy * W + ix) * Cin + q * 8 : xb;
      cp_async16(win + pix * kCS + q * 8, src, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = threadIdx.x; i < kWinR * kWinC * KC * 16; i += kThreads) {
      const int ci = i % (KC * 16), pix = i / (KC * 16);
      const int iy = y0 - 1 + pix / kWinC, ix = x0 - 1 + pix % kWinC;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin;
      win[pix * kCS + ci] =
          ok ? xb[((size_t)iy * W + ix) * Cin + ci] : __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();

  // warp w computes output row y0 + w: pixels gq, gq + 8 (M tile 0) and
  // gq + 16, gq + 24 (M tile 1) of the lane
  const int gq = lane >> 2, tq = lane & 3;
  int base[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    base[k] = (warp * kWinC + 8 * k + gq) * kCS + tq * 2;
  const int oy = y0 + warp;
  for (int n0 = 0; n0 < Cout; n0 += 64) {
    const int n_act = min(8, (Cout - n0) / 8);
    float acc[2][8][4];
    conv3x3_mma<kWinC, kCS, KC, 8, 2>(win, base, wp + (n0 / 8) * 32, Cout / 8,
                                      n_act, lane, acc);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      // this M tile's 16 pixels x 8 * n_act channels through shared memory
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt >= n_act) break;
        const int col = nt * 8 + tq * 2;
        const float s0 = __ldg(scale + n0 + col), s1 = __ldg(scale + n0 + col + 1);
        const float c0 = __ldg(bias + n0 + col), c1 = __ldg(bias + n0 + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = __fadd_rn(__fmul_rn(acc[t][nt][2 * h], s0), c0);
          float v1 = __fadd_rn(__fmul_rn(acc[t][nt][2 * h + 1], s1), c1);
          if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          *reinterpret_cast<uint32_t*>(stage + (gq + 8 * h) * kOutStride +
                                       col) = pack2(v0, v1);
        }
      }
      __syncwarp();
      for (int i = lane; i < 16 * n_act; i += 32) {
        const int px = i / n_act, g = i % n_act;
        const int ox = x0 + 16 * t + px;
        if (oy < H && ox < W)
          *reinterpret_cast<uint4*>(
              out + (((size_t)b * H + oy) * W + ox) * Cout + n0 + 8 * g) =
              *reinterpret_cast<const uint4*>(stage + px * kOutStride + 8 * g);
      }
      __syncwarp();
    }
  }
}

template <int KC>
int launch(const void* x, const void* wp, const void* scale, const void* bias,
           void* out, int B, int H, int W, int Cin, int Cout, int relu,
           cudaStream_t stream) {
  constexpr size_t smem = conv3x3_smem<KC>();
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<KC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  conv3x3_kernel<KC><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint2*>(wp),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(out), H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C interface

// wp: bf16(k) with Cin padded to KC * 16 = 16 * ceil(Cin / 16) as mma.sync
// B fragments [tap][kc][n-tile][lane][4] (ops/stem.py _mma_b_pack).
extern "C" int mds_conv3x3_bn_relu(const void* x, const void* wp,
                                   const void* scale, const void* bias,
                                   void* out, int B, int H, int W, int Cin,
                                   int Cout, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch ((Cin + 15) / 16) {
    case 1: return launch<1>(x, wp, scale, bias, out, B, H, W, Cin, Cout, relu, s);
    case 2: return launch<2>(x, wp, scale, bias, out, B, H, W, Cin, Cout, relu, s);
    case 3: return launch<3>(x, wp, scale, bias, out, B, H, W, Cin, Cout, relu, s);
    case 4: return launch<4>(x, wp, scale, bias, out, B, H, W, Cin, Cout, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
