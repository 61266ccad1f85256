// Hopper (sm_90a) kernel for the fused eval 3x3 conv, bound with ctypes.
//
// Replaces mds_tpu/ops/pallas/conv3x3.py::conv3x3_bn_relu_pallas (:69-128,
// body _kernel :28-66): a 3x3 stride-1 pad-1 conv on a bf16 NHWC input
// (B, H, W, Cin), Cin <= 64, then y = acc * scale + bias per output channel,
// an optional ReLU and one rounding to bf16, NHWC out (B, H, W, Cout),
// Cout % 8 == 0. Rounding points are the TPU kernel's: the weight is bf16(k)
// *unscaled*, the products accumulate in f32, and the folded BN's scale and
// bias apply to the f32 sum (__fmul_rn, __fadd_rn: nothing contracted).
//
// Bound: about even. At DetailBranch S1_2's shape (1, 512, 1024, 64 -> 64)
// the conv is 38.7 GFLOP (0.039 ms on the bf16 tensor cores) and moves
// 134 MB (0.040 ms). Design: an implicit GEMM on warpgroup MMA
// (wgmma.mma_async m64n64k16, bf16 in, f32 accumulate in registers; see
// wgmma.cuh): M = output pixels, 64 per instruction (one row of a 4 x 64
// output tile), N = a 64-wide chunk of output channels (grid.y walks the
// chunks), K = 9 taps x Cin padded to 16. The chunk's whole weight, 9
// slices in wgmma's swizzled K-major layout (73.7 KB, packed once per model
// by ops/conv3x3.py pack_conv3x3), is copied into shared memory once per
// block by the copy engine (cp.async.bulk under an mbarrier) and read by
// every wgmma through its descriptor. Persistent blocks, about one per SM,
// walk the output tiles; a tile's input window (6 x 66 pixels of 128 bytes,
// zero outside the image and beyond Cin, 16-byte XOR swizzle on the pixel
// index) arrives by cp.async into one of two buffers while the previous
// tile computes. A comes from the window through ldmatrix.x4, each lane's
// row address shifted by the tap: one window serves all 9 taps, no im2col.
// Two warpgroups each own two M tiles; the next tap's A fragments load while
// the current tap's wgmmas run. The epilogue stages the tile through shared
// memory (swizzled, conflict-free) for 16-byte stores; ragged tiles compute
// on the zero window and skip their stores, so any B, H and W work.
//
// The launcher returns the cudaError_t of its launch (0 on success).

#include "wgmma.cuh"

namespace {

constexpr int kTH = 4;                  // output rows per tile, one M tile each
constexpr int kTW = 64;                 // output cols per tile: wgmma's M
constexpr int kWinR = kTH + 2;          // input rows of a tile's window (6)
constexpr int kWinC = kTW + 2;          // input cols (66)
constexpr int kPixB = 128;              // bytes of a shared pixel (64 channels)
constexpr int kWinBytes = kWinR * kWinC * kPixB;  // 50688
constexpr int kSliceBytes = 64 * 128;             // one tap of a 64-wide chunk
constexpr int kWgtBytes = 9 * kSliceBytes;        // 73728
constexpr int kStageBytes = kTH * kTW * kPixB;    // 32768
constexpr int kThreads = 256;           // two warpgroups, two M tiles each
// 1024 bytes of slack to align the weights to the swizzle's 1024-byte
// pattern, the weights, two windows, the output stage, the mbarrier
constexpr size_t kSmem =
    1024 + kWgtBytes + 2 * kWinBytes + kStageBytes + sizeof(uint64_t);

// The window of the tile whose output origin is (y0, x0): rows y0-1 ..
// y0+kTH, cols x0-1 .. x0+kTW, the 2 * KC 16-byte chunks the K loop reads.
template <int KC>
__device__ __forceinline__ void load_window(unsigned char* win,
                                            const bf16* __restrict__ xb,
                                            int y0, int x0, int H, int W,
                                            int Cin) {
  if (Cin % 8 == 0) {
    constexpr int kQ = 2 * KC;
    for (int i = threadIdx.x; i < kWinR * kWinC * kQ; i += kThreads) {
      const int q = i % kQ, pix = i / kQ;
      const int iy = y0 - 1 + pix / kWinC, ix = x0 - 1 + pix % kWinC;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && q * 8 < Cin;
      const bf16* src = ok ? xb + ((size_t)iy * W + ix) * Cin + q * 8 : xb;
      cp_async16(win + swz(pix, q, kPixB), src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kWinR * kWinC * KC * 16; i += kThreads) {
      const int ci = i % (KC * 16), pix = i / (KC * 16);
      const int iy = y0 - 1 + pix / kWinC, ix = x0 - 1 + pix % kWinC;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W && ci < Cin;
      *reinterpret_cast<bf16*>(win + swz(pix, ci >> 3, kPixB) + (ci & 7) * 2) =
          ok ? xb[((size_t)iy * W + ix) * Cin + ci] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int KC>
__global__ void __launch_bounds__(kThreads, 1)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wp,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int B, int H, int W, int Cin, int Cout, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wgt =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* win[2] = {wgt + kWgtBytes, wgt + kWgtBytes + kWinBytes};
  unsigned char* stage = win[1] + kWinBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + kStageBytes);
  const int n0 = blockIdx.y * 64;
  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const int tiles = tiles_x * tiles_y * B;

  // this chunk's weights, once per block, by the copy engine
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, kWgtBytes);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(wp) + (size_t)blockIdx.y * kWgtBytes;
    for (int t = 0; t < 9; ++t)
      bulk_g2s(wgt + t * kSliceBytes, src + t * kSliceBytes, kSliceBytes, bar);
  }
  int tile = blockIdx.x;
  {
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    load_window<KC>(win[0], x + (size_t)b * H * W * Cin, ty * kTH, tx * kTW,
                    H, W, Cin);
  }
  cp_async_commit();
  mbar_wait(bar, 0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wiw = warp & 3, gq = lane >> 2, tq = lane & 3;
  // this lane's ldmatrix row among the 64 of an M tile, and its 8-wide K half
  const int arow = 16 * wiw + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ahalf = lane >> 4;
  const uint32_t wgt_s = smem_u32(wgt);
  const int nq = min(64, Cout - n0) / 8;  // 16-byte chunks of output

  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles) {
      const int tx = next % tiles_x, ty = (next / tiles_x) % tiles_y;
      const int b = next / (tiles_x * tiles_y);
      load_window<KC>(win[buf ^ 1], x + (size_t)b * H * W * Cin, ty * kTH,
                      tx * kTW, H, W, Cin);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's window (the group before)
    __syncthreads();

    const uint32_t win_s = smem_u32(win[buf]);
    // the A row's window pixel at tap (0, 0) in this warpgroup's two M tiles
    const int p0[2] = {2 * wg * kWinC + arow, (2 * wg + 1) * kWinC + arow};
    float acc[2][32];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[t][i] = 0.f;
        reg_fence(acc[t][i]);
      }
    uint32_t a[2][KC][2][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        ldmatrix_x4(a[0][kc][t], win_s + swz(p0[t], 2 * kc + ahalf, kPixB));
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
#pragma unroll
        for (int t = 0; t < 2; ++t)
          wgmma_m64n64k16(acc[t], a[tap & 1][kc][t],
                          sw128_desc(wgt_s + tap * kSliceBytes + kc * 32));
      wgmma_commit();
      if (tap < 8) {
        // the next tap's fragments, into the registers the tap before used
        wgmma_wait<1>();
        const int off = ((tap + 1) / 3) * kWinC + (tap + 1) % 3;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc)
#pragma unroll
          for (int t = 0; t < 2; ++t)
            ldmatrix_x4(a[(tap + 1) & 1][kc][t],
                        win_s + swz(p0[t] + off, 2 * kc + ahalf, kPixB));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(acc[t][i]);

    // epilogue: ·scale + bias, [ReLU], bf16, through the stage
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j + 2 * tq;
      const bool nok = n < Cout;
      const float s0 = nok ? __ldg(scale + n) : 0.f;
      const float s1 = nok ? __ldg(scale + n + 1) : 0.f;
      const float c0 = nok ? __ldg(bias + n) : 0.f;
      const float c1 = nok ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = __fadd_rn(__fmul_rn(acc[t][4 * j + 2 * h], s0), c0);
          float v1 = __fadd_rn(__fmul_rn(acc[t][4 * j + 2 * h + 1], s1), c1);
          if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          const int sp = (2 * wg + t) * kTW + 16 * wiw + gq + 8 * h;
          *reinterpret_cast<uint32_t*>(stage + swz(sp, j, kPixB) + tq * 4) =
              pack2(v0, v1);
        }
    }
    __syncthreads();
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    for (int i = threadIdx.x; i < kTH * kTW * 8; i += kThreads) {
      const int q = i & 7, sp = i >> 3;
      const int oy = ty * kTH + sp / kTW, ox = tx * kTW + sp % kTW;
      if (q < nq && oy < H && ox < W)
        *reinterpret_cast<uint4*>(out + (((size_t)b * H + oy) * W + ox) * Cout +
                                  n0 + 8 * q) =
            *reinterpret_cast<const uint4*>(stage + swz(sp, q, kPixB));
    }
    __syncthreads();  // the stage and this window are free again
  }
}

template <int KC>
int launch(const void* x, const void* wp, const void* scale, const void* bias,
           void* out, int B, int H, int W, int Cin, int Cout, int relu,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv3x3_kernel<KC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (Cout + 63) / 64;
  const long long tiles =
      (long long)((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH) * B;
  long long per_chunk = sms / chunks > 0 ? sms / chunks : 1;
  if (per_chunk > tiles) per_chunk = tiles;
  const dim3 grid((unsigned)per_chunk, chunks);
  conv3x3_kernel<KC><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wp),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<bf16*>(out), B, H, W, Cin, Cout, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C interface

// wp: bf16(k) as ops/conv3x3.py pack_conv3x3 lays it out: for each 64-wide
// chunk of output channels, 9 slices (one per tap) of 64 rows x 128 bytes,
// Cin and Cout zero-padded to 64 (wgmma.cuh's B layout).
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
