// Hopper (sm_90a) kernels for the BiSeNetV2 deploy stems, bound with ctypes.
//
// Five kernels, one per TPU kernel of mds_tpu/ops/pallas/stem.py (numbered
// as PERF.md's table numbers them: 1, 2, 3, 4, 5). All take the memory of a
// channels_last bf16 tensor, i.e. an NHWC image (B, H, W, 3), and write NHWC
// bf16. They share stage A, a 3x3 stride-2 pad-1 conv on RGB with the BN
// folded into f32 weights:
//
//   w[28][O]: rows (dy*3 + dx)*3 + ci are k * scale, row 27 is the bias.
//
// Out-of-image positions of every intermediate are ZERO (the next conv's
// padding), never ReLU(folded bias); ragged tiles are masked, so any H and W
// divisible by 4 (by 2 for the single stems and the S1 pair) and any B >= 1
// work.
//
// Each launcher returns the cudaError_t of its launch (0 on success).

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------- helpers

// Stage A: the folded 3x3 s2 p1 RGB conv at half-resolution position (r, c).
// stem_taps gathers its 27 inputs (dy, dx, ci order; zero outside the
// image); stem_dot applies output channels [o0, o0 + NC) of the (28, O)
// folded table w (shared memory, 16-byte aligned, read as float4; NC, O
// and o0 multiples of 4), bias first, before any ReLU. Where all lanes of a
// warp share o0 the weight reads are broadcasts.
__device__ __forceinline__ void stem_taps(const bf16* __restrict__ xb, int H,
                                          int W, int r, int c, float* v) {
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int y = 2 * r - 1 + dy;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int x = 2 * c - 1 + dx;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const bf16* px = xb + ((size_t)(in ? y : 0) * W + (in ? x : 0)) * 3;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        v[(dy * 3 + dx) * 3 + ci] = in ? __bfloat162float(px[ci]) : 0.f;
    }
  }
}

template <int NC>
__device__ __forceinline__ void stem_dot(const float* v, const float* w, int O,
                                         int o0, float* acc) {
  static_assert(NC % 4 == 0, "stem_dot reads weights as float4");
#pragma unroll
  for (int j = 0; j < NC; j += 4) {
    const float4 b = *reinterpret_cast<const float4*>(w + 27 * O + o0 + j);
    acc[j] = b.x, acc[j + 1] = b.y, acc[j + 2] = b.z, acc[j + 3] = b.w;
  }
#pragma unroll
  for (int k = 0; k < 27; ++k) {
    const float* wr = w + k * O + o0;
#pragma unroll
    for (int j = 0; j < NC; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(wr + j);
      acc[j] = fmaf(v[k], q.x, acc[j]);
      acc[j + 1] = fmaf(v[k], q.y, acc[j + 1]);
      acc[j + 2] = fmaf(v[k], q.z, acc[j + 2]);
      acc[j + 3] = fmaf(v[k], q.w, acc[j + 3]);
    }
  }
}

// --------------------------------- TPU kernel 1: stem_conv_bn_relu_s2
//
// Replaces mds_tpu/ops/pallas/stem.py::_stem_fwd (fused case, :143-183).
// Bound: memory. At 1024x2048 with O=64 it reads 12 MB and writes 64 MB for
// 0.9 GFLOP. Design: one thread per output pixel gathers its 27 taps once
// and emits all O channels as 16-byte stores; the folded weights sit in
// shared memory, read as broadcasts, loaded once per block of a grid capped
// at 8 blocks per SM. (One thread per (pixel, 8 channels) stored coalesced
// but re-read every tap 8 times and ran 1.9x slower at O=64 on an H100.)

constexpr int kStemThreads = 256;

__global__ void __launch_bounds__(kStemThreads)
    stem_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                bf16* __restrict__ out, int B, int H, int W, int O, int relu) {
  extern __shared__ float ws[];
  for (int i = threadIdx.x; i < 28 * O; i += blockDim.x) ws[i] = w[i];
  __syncthreads();
  const int H2 = H / 2, W2 = W / 2;
  const long long total = (long long)B * H2 * W2;
  // grid-stride over pixels: a capped grid loads the weight table once per
  // block; each thread gathers a pixel's 27 taps once and walks the output
  // channels in groups of 8, the weight reads being warp-wide broadcasts
  for (long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       pix < total; pix += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(pix % W2);
    const long long t = pix / W2;
    const int r = (int)(t % H2);
    const int b = (int)(t / H2);
    float v[27];
    stem_taps(x + (size_t)b * H * W * 3, H, W, r, c, v);
    for (int o0 = 0; o0 < O; o0 += 8) {
      float acc[8];
      stem_dot<8>(v, ws, O, o0, acc);
      if (relu) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = fmaxf(acc[j], 0.f);
      }
      *reinterpret_cast<uint4*>(out + pix * O + o0) = pack8(acc);
    }
  }
}

// ------------------- TPU kernel 2: stem_conv_bn_relu_s2, its window variant
//
// Replaces mds_tpu/ops/pallas/stem.py::_stem_fwd_dma (:265-361, body
// _kernel_dma :186-262): kernel 1 with each tile's input window staged into
// shared memory by the kernel itself, double-buffered: while a block
// computes one tile from one buffer, cp.async fills the other with its next
// tile's window (the TPU kernel's make_async_copy into VMEM and semaphores).
// Bound: memory, as kernel 1. The arithmetic is kernel 1's, stem_dot on the
// same 27 taps, so the two agree bit for bit. Blocks are persistent; a tile
// is 4 x 64 output pixels, one per thread. Its window is 9 input rows of 130
// pixels starting at an even column, i.e. 65 pixel pairs of 3 four-byte
// words each: copied word by word, every word lies in one pair, and a pair
// is wholly inside or outside the image (W is even), so the zero-fill of
// cp.async is the conv's zero padding.

constexpr int kWinTR = 4;                      // output rows per tile
constexpr int kWinTC = 64;                     // output cols per tile
constexpr int kWinRows = 2 * kWinTR + 1;       // input rows of a window (9)
constexpr int kWinWords = 3 * (kWinTC + 1);    // words of a window row (195)
constexpr int kWinBuf = kWinRows * kWinWords;  // words of one buffer (1755)
static_assert(kWinTR * kWinTC == kStemThreads, "one output pixel per thread");

struct WinTile {
  int b, ty, tx;
};

__device__ __forceinline__ WinTile win_tile(int tile, int tiles_x,
                                            int tiles_y) {
  const int t = tile / tiles_x;
  return {t / tiles_y, t % tiles_y, tile % tiles_x};
}

// Start the cp.async copies of tile `tile`'s window into buf.
__device__ __forceinline__ void win_load(const bf16* __restrict__ x,
                                         uint32_t* buf, WinTile t, int H,
                                         int W) {
  const int pairs = W / 2;
  const int y0 = 2 * kWinTR * t.ty - 1;  // first input row
  const int p0 = kWinTC * t.tx - 1;      // first pixel pair (cols 2p, 2p+1)
  const uint32_t* xb =
      reinterpret_cast<const uint32_t*>(x + (size_t)t.b * H * W * 3);
  for (int i = threadIdx.x; i < kWinBuf; i += blockDim.x) {
    const int y = y0 + i / kWinWords, q = i % kWinWords, p = p0 + q / 3;
    const bool in = y >= 0 && y < H && p >= 0 && p < pairs;
    cp_async4(buf + i, in ? xb + ((size_t)y * pairs + p) * 3 + q % 3 : xb,
              in ? 4 : 0);
  }
}

__global__ void __launch_bounds__(kStemThreads)
    stem_window_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                       bf16* __restrict__ out, int B, int H, int W, int O,
                       int relu, int tiles_x, int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);
  uint32_t* bufs = reinterpret_cast<uint32_t*>(smem + 28 * O * sizeof(float));
  for (int i = threadIdx.x; i < 28 * O; i += blockDim.x) ws[i] = w[i];
  const int H2 = H / 2, W2 = W / 2, tiles = tiles_x * tiles_y * B;
  const int r = threadIdx.x / kWinTC, c = threadIdx.x % kWinTC;
  int tile = blockIdx.x;
  if (tile < tiles) win_load(x, bufs, win_tile(tile, tiles_x, tiles_y), H, W);
  cp_async_commit();
  for (int slot = 0; tile < tiles; tile += gridDim.x, slot ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles)
      win_load(x, bufs + (slot ^ 1) * kWinBuf,
               win_tile(next, tiles_x, tiles_y), H, W);
    cp_async_commit();  // possibly empty: the wait below stays uniform
    cp_async_wait<1>();
    __syncthreads();
    const WinTile t = win_tile(tile, tiles_x, tiles_y);
    const int orow = kWinTR * t.ty + r, ocol = kWinTC * t.tx + c;
    if (orow < H2 && ocol < W2) {
      // window row 2r + dy, column 2c + 1 + dx hold input (2*orow - 1 + dy,
      // 2*ocol - 1 + dx): the taps of kernel 1's stem_taps
      const bf16* win = reinterpret_cast<const bf16*>(bufs + slot * kWinBuf);
      float v[27];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
            v[(dy * 3 + dx) * 3 + ci] = __bfloat162float(
                win[(2 * r + dy) * 2 * kWinWords + (2 * c + 1 + dx) * 3 + ci]);
      bf16* o = out + (((size_t)t.b * H2 + orow) * W2 + ocol) * O;
      for (int o0 = 0; o0 < O; o0 += 8) {
        float acc[8];
        stem_dot<8>(v, ws, O, o0, acc);
        if (relu) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[j] = fmaxf(acc[j], 0.f);
        }
        *reinterpret_cast<uint4*>(o + o0) = pack8(acc);
      }
    }
    __syncthreads();  // the next iteration's copies overwrite this buffer
  }
}

// ------------------------------------ TPU kernel 4: detail_s1s2_fused
//
// Replaces mds_tpu/ops/pallas/stem.py::detail_s1s2_fused (:458-643).
// DetailBranch S1_1 (3x3 s2, 3->64) -> S1_2 (3x3, 64->64) -> S2_1 (3x3 s2,
// 64->64), every BN folded, every layer ReLU, bf16 out at /4.
// Bound: arithmetic. About 50 GFLOP at 1024x2048, 39 of them in S1_2. Design:
// one block per 4x32 tile of the /4 output keeps both S1 activations in
// shared memory (the TPU kernel's point: they never reach device memory),
// and runs the two 64->64 convs as implicit GEMMs on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate), M = pixels, N = 64,
// K = 9 taps x 64 channels. The weights come pre-packed in B-fragment order
// (one 8-byte load per lane, shared by two M tiles) from L1/L2. S1_1 runs on
// the CUDA cores, one pixel and all 64 channels per thread so the weight
// reads are broadcasts. (With 8 channels per thread and one M tile per warp
// pass, the call took 2.3x as long on an H100.)
//
// Rounding points follow the TPU kernel: S1_1 in f32 from f32 weights,
// rounded to bf16; S1_2 and S2_1 on bf16 weights bf16(k*scale), bias added
// to the f32 sum, ReLU, rounded to bf16.

constexpr int kDetTQ = 4;                 // /4 output rows per block
constexpr int kDetTP = 32;                // /4 output cols per block
constexpr int kDetAR = 2 * kDetTQ + 3;    // S1_1 rows held (11)
constexpr int kDetAC = 2 * kDetTP + 3;    // S1_1 cols held (67)
constexpr int kDetACh = 72;               // S1_1 channel stride (bank spread)
constexpr int kDetBR = 2 * kDetTQ + 1;    // S1_2 rows held (9)
constexpr int kDetBC = 2 * kDetTP + 1;    // S1_2 cols held (65)
constexpr int kDetBCh = 68;               // S1_2 channel stride (bank spread)
constexpr int kDetBM = kDetBR * kDetBC;   // S1_2 pixels = GEMM M (585)
constexpr int kDetThreads = 256;
constexpr size_t kDetSmem = 28 * 64 * sizeof(float) +
                            (size_t)kDetAR * kDetAC * kDetACh * sizeof(bf16) +
                            (size_t)kDetBM * kDetBCh * sizeof(bf16);

// Stage A of the detail kernels: S1_1 over a (rows, cols) region of the /2
// grid with origin (R, C), ReLU, as bf16 pixels of kDetACh elements in s1;
// one pixel (all 64 channels) per thread, so every weight read is a
// warp-wide broadcast; zero outside the image.
__device__ __forceinline__ void s1_1_region(const bf16* __restrict__ xb,
                                            int H, int W, const float* w1s,
                                            bf16* s1, int R, int C, int rows,
                                            int cols) {
  for (int p = threadIdx.x; p < rows * cols; p += blockDim.x) {
    const int r = R + p / cols, c = C + p % cols;
    uint4* dst = reinterpret_cast<uint4*>(s1 + p * kDetACh);
    if (r >= 0 && r < H / 2 && c >= 0 && c < W / 2) {
      float v[27], acc[64];
      stem_taps(xb, H, W, r, c, v);
      stem_dot<64>(v, w1s, 64, 0, acc);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = fmaxf(acc[j], 0.f);
#pragma unroll
      for (int g = 0; g < 8; ++g) dst[g] = pack8(acc + 8 * g);
    } else {
#pragma unroll
      for (int g = 0; g < 8; ++g) dst[g] = make_uint4(0, 0, 0, 0);
    }
  }
}

__global__ void __launch_bounds__(kDetThreads)
    detail_kernel(const bf16* __restrict__ x, const float* __restrict__ w1,
                  const uint2* __restrict__ w2p, const float* __restrict__ b2,
                  const uint2* __restrict__ w3p, const float* __restrict__ b3,
                  bf16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);
  bf16* s1 = reinterpret_cast<bf16*>(smem + 28 * 64 * sizeof(float));
  bf16* s2 = s1 + kDetAR * kDetAC * kDetACh;

  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int q0 = blockIdx.y * kDetTQ, p0 = blockIdx.x * kDetTP;
  const int b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * 3;
  const int tid = threadIdx.x;
  const int R1 = 2 * q0 - 2, C1 = 2 * p0 - 2;  // S1_1 origin (/2 coords)
  const int R2 = 2 * q0 - 1, C2 = 2 * p0 - 1;  // S1_2 origin (/2 coords)

  for (int i = tid; i < 28 * 64; i += kDetThreads) w1s[i] = w1[i];
  __syncthreads();

  // stage A: S1_1 over the (11, 67) halo region
  s1_1_region(xb, H, W, w1s, s1, R1, C1, kDetAR, kDetAC);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  constexpr int kWarps = kDetThreads / 32;

  // stage B: S1_2 over the (9, 65) region; GEMM M = 585 in 37 tiles, two
  // tiles per warp pass (the second may lie past M: loads clamp, stores skip)
  {
    constexpr int kTiles = (kDetBM + 15) / 16;
    float acc[2][8][4];
    for (int pr = warp; 2 * pr < kTiles; pr += kWarps) {
      int ms[4], base[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        ms[k] = (2 * pr + k / 2) * 16 + gq + 8 * (k % 2);
        const int mc = min(ms[k], kDetBM - 1);
        base[k] = ((mc / kDetBC) * kDetAC + mc % kDetBC) * kDetACh + tq * 2;
      }
      conv3x3_mma<kDetAC, kDetACh, 4, 8, 2>(s1, base, w2p, 8, 8, lane, acc);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int m = ms[k], t = k / 2, h = k % 2;
        if (m >= kDetBM) continue;
        const int r = R2 + m / kDetBC, c = C2 + m % kDetBC;
        const bool in = r >= 0 && r < H2 && c >= 0 && c < W2;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nt * 8 + tq * 2;
          float v0 = 0.f, v1 = 0.f;
          if (in) {
            v0 = fmaxf(acc[t][nt][2 * h] + __ldg(b2 + col), 0.f);
            v1 = fmaxf(acc[t][nt][2 * h + 1] + __ldg(b2 + col + 1), 0.f);
          }
          *reinterpret_cast<uint32_t*>(s2 + m * kDetBCh + col) = pack2(v0, v1);
        }
      }
    }
  }
  __syncthreads();

  // stage C: S2_1 (s2) for the 4x32 output tile; GEMM M = 128 in 8 tiles
  {
    float acc[1][8][4];
    for (int mt = warp; mt < kDetTQ * kDetTP / 16; mt += kWarps) {
      int ms[2], base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ms[h] = mt * 16 + gq + 8 * h;
        base[h] = ((2 * (ms[h] / kDetTP)) * kDetBC + 2 * (ms[h] % kDetTP)) *
                      kDetBCh + tq * 2;
      }
      conv3x3_mma<kDetBC, kDetBCh, 4, 8, 1>(s2, base, w3p, 8, 8, lane, acc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + ms[h] / kDetTP, p = p0 + ms[h] % kDetTP;
        if (q >= H4 || p >= W4) continue;
        bf16* o = out + (((size_t)b * H4 + q) * W4 + p) * 64;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = nt * 8 + tq * 2;
          const float v0 = fmaxf(acc[0][nt][2 * h] + __ldg(b3 + col), 0.f);
          const float v1 = fmaxf(acc[0][nt][2 * h + 1] + __ldg(b3 + col + 1), 0.f);
          *reinterpret_cast<uint32_t*>(o + col) = pack2(v0, v1);
        }
      }
    }
  }
}

// ------------------------------------ TPU kernel 3: stem_s1_pair_fused
//
// Replaces mds_tpu/ops/pallas/stem.py::stem_s1_pair_fused (:408-455, body
// _pair_kernel :365-405): DetailBranch S1_1 (3x3 s2, 3->64) -> S1_2 (3x3,
// 64->64), BNs folded, the second ReLU optional: kernel 4 without its stage
// C, with its rounding points. Bound: arithmetic, 40.5 GFLOP at 1024x2048
// (38.7 of them in S1_2) against 80 MB moved. Design: one block per 8x32
// tile of the /2 output; S1_1 over the tile and its one-pixel halo (10 x 34)
// in shared memory on the CUDA cores (s1_1_region); each warp computes one
// output row as two M tiles on the tensor cores and stores it.

constexpr int kPairTQ = 8;                // /2 output rows per block
constexpr int kPairTP = 32;               // /2 output cols per block
constexpr int kPairAR = kPairTQ + 2;      // S1_1 rows held (10)
constexpr int kPairAC = kPairTP + 2;      // S1_1 cols held (34)
constexpr size_t kPairSmem = 28 * 64 * sizeof(float) +
                             (size_t)kPairAR * kPairAC * kDetACh * sizeof(bf16);
static_assert(kPairTQ * 32 == kDetThreads, "one output row per warp");

__global__ void __launch_bounds__(kDetThreads)
    pair_kernel(const bf16* __restrict__ x, const float* __restrict__ w1,
                const uint2* __restrict__ w2p, const float* __restrict__ b2,
                bf16* __restrict__ out, int H, int W, int relu2) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w1s = reinterpret_cast<float*>(smem);
  bf16* s1 = reinterpret_cast<bf16*>(smem + 28 * 64 * sizeof(float));
  const int H2 = H / 2, W2 = W / 2;
  const int r0 = blockIdx.y * kPairTQ, c0 = blockIdx.x * kPairTP;
  const int b = blockIdx.z;
  for (int i = threadIdx.x; i < 28 * 64; i += kDetThreads) w1s[i] = w1[i];
  __syncthreads();
  s1_1_region(x + (size_t)b * H * W * 3, H, W, w1s, s1, r0 - 1, c0 - 1,
              kPairAR, kPairAC);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  int base[4];  // the lane's A rows: cols gq, gq + 8, gq + 16, gq + 24
#pragma unroll
  for (int k = 0; k < 4; ++k)
    base[k] = (warp * kPairAC + 8 * k + gq) * kDetACh + tq * 2;
  float acc[2][8][4];
  conv3x3_mma<kPairAC, kDetACh, 4, 8, 2>(s1, base, w2p, 8, 8, lane, acc);
  const int r = r0 + warp;
  if (r >= H2) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = c0 + 8 * k + gq, t = k / 2, h = k % 2;
    if (c >= W2) continue;
    bf16* o = out + (((size_t)b * H2 + r) * W2 + c) * 64;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + tq * 2;
      float v0 = acc[t][nt][2 * h] + __ldg(b2 + col);
      float v1 = acc[t][nt][2 * h + 1] + __ldg(b2 + col + 1);
      if (relu2) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
      *reinterpret_cast<uint32_t*>(o + col) = pack2(v0, v1);
    }
  }
}

// --------------------------------------- TPU kernel 5: stemblock_fused
//
// Replaces mds_tpu/ops/pallas/stem.py::stemblock_fused (:646-852). The whole
// StemBlock: stem 3x3 s2 3->16 -> {left_1 1x1 16->8 -> left_2 3x3 s2 8->16 ||
// maxpool 3x3 s2} -> concat 32 -> fuse 3x3 32->16, BN folded, ReLU each.
// Bound: memory and launch count in the library graph (six narrow layers,
// 8 to 32 channels, about 2 GFLOP at 1024x2048). Design: one block per 8x32
// tile of the /4 output keeps every intermediate in shared memory and
// computes them with f32 FMA on the CUDA cores (products of bf16 values are
// exact in f32, so this matches the TPU kernel's rounding points):
//   stem f32 + ReLU; left_1 on bf16(stem) and bf16 weights, f32 + ReLU;
//   maxpool over the stem (kept as bf16: rounding commutes with max);
//   left_2 on bf16(left_1), rounded to bf16; fuse on [left_2 | maxpool].
// Zero padding of the post-ReLU stem stands in for the maxpool's -inf.

constexpr int kSbTQ = 8;                 // /4 output rows per block
constexpr int kSbTP = 32;                // /4 output cols per block
constexpr int kSbSR = 2 * kSbTQ + 5;     // stem rows held (21)
constexpr int kSbSC = 2 * kSbTP + 5;     // stem cols held (69)
constexpr int kSbCR = kSbTQ + 2;         // concat rows held (10)
constexpr int kSbCC = kSbTP + 2;         // concat cols held (34)
constexpr int kSbThreads = kSbTQ * kSbTP;  // one thread per output pixel
// packed f32 weights: ws(28x16) wl1(16x8) bl1(8) wl2(9x8x16) bl2(16)
//                     wf(9x32x16) bf(16)
constexpr int kSbWs = 0, kSbWl1 = 448, kSbBl1 = 576, kSbWl2 = 584,
              kSbBl2 = 1736, kSbWf = 1752, kSbBf = 6360, kSbWTotal = 6376;
constexpr size_t kSbSmem = kSbWTotal * sizeof(float) +
                           (size_t)kSbSR * kSbSC * 24 * sizeof(bf16) +
                           (size_t)kSbCR * kSbCC * 32 * sizeof(bf16);

__global__ void __launch_bounds__(kSbThreads)
    stemblock_kernel(const bf16* __restrict__ x, const float* __restrict__ wg,
                     bf16* __restrict__ out, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);
  bf16* st = reinterpret_cast<bf16*>(smem + kSbWTotal * sizeof(float));
  bf16* cc = st + kSbSR * kSbSC * 24;

  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int q0 = blockIdx.y * kSbTQ, p0 = blockIdx.x * kSbTP;
  const int b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * 3;
  const int tid = threadIdx.x;
  const int RS = 2 * q0 - 3, CS = 2 * p0 - 3;  // stem origin (/2 coords)

  for (int i = tid; i < kSbWTotal; i += kSbThreads) wsm[i] = wg[i];
  __syncthreads();
  const float* ws = wsm + kSbWs;
  const float* wl1 = wsm + kSbWl1;
  const float* bl1 = wsm + kSbBl1;
  const float* wl2 = wsm + kSbWl2;
  const float* bl2 = wsm + kSbBl2;
  const float* wf = wsm + kSbWf;
  const float* bfs = wsm + kSbBf;

  // stage A: stem (16 ch) and left_1 (8 ch) per half-resolution pixel
  for (int p = tid; p < kSbSR * kSbSC; p += kSbThreads) {
    const int r = RS + p / kSbSC, c = CS + p % kSbSC;
    uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0, v2 = v0;
    if (r >= 0 && r < H2 && c >= 0 && c < W2) {
      float v[27], s[16], t[8];
      stem_taps(xb, H, W, r, c, v);
      stem_dot<16>(v, ws, 16, 0, s);
#pragma unroll
      for (int k = 0; k < 16; ++k) s[k] = fmaxf(s[k], 0.f);
#pragma unroll
      for (int o = 0; o < 8; ++o) t[o] = bl1[o];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float sv = bf16_round(s[k]);
#pragma unroll
        for (int o = 0; o < 8; ++o) t[o] = fmaf(sv, wl1[k * 8 + o], t[o]);
      }
#pragma unroll
      for (int o = 0; o < 8; ++o) t[o] = fmaxf(t[o], 0.f);
      v0 = pack8(s);
      v1 = pack8(s + 8);
      v2 = pack8(t);
    }
    uint4* dst = reinterpret_cast<uint4*>(st + p * 24);
    dst[0] = v0;
    dst[1] = v1;
    dst[2] = v2;
  }
  __syncthreads();

  // stage B: left_2 and maxpool per /4 position of the (10, 34) halo region
  for (int p = tid; p < kSbCR * kSbCC; p += kSbThreads) {
    const int a = p / kSbCC, bb = p % kSbCC;
    const int q = q0 - 1 + a, pc = p0 - 1 + bb;
    uint4 o4[4] = {make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0),
                   make_uint4(0, 0, 0, 0), make_uint4(0, 0, 0, 0)};
    if (q >= 0 && q < H4 && pc >= 0 && pc < W4) {
      float l2[16], mp[16];
#pragma unroll
      for (int o = 0; o < 16; ++o) {
        l2[o] = bl2[o];
        mp[o] = 0.f;
      }
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        const uint4* src = reinterpret_cast<const uint4*>(
            st + ((2 * a + dy) * kSbSC + 2 * bb + dx) * 24);
        float f[8];
        unpack8(src[0], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) mp[k] = fmaxf(mp[k], f[k]);
        unpack8(src[1], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) mp[8 + k] = fmaxf(mp[8 + k], f[k]);
        unpack8(src[2], f);
#pragma unroll
        for (int ci = 0; ci < 8; ++ci) {
          const float* wr = wl2 + (tap * 8 + ci) * 16;
#pragma unroll
          for (int o = 0; o < 16; ++o) l2[o] = fmaf(f[ci], wr[o], l2[o]);
        }
      }
#pragma unroll
      for (int o = 0; o < 16; ++o) l2[o] = fmaxf(l2[o], 0.f);
      o4[0] = pack8(l2);
      o4[1] = pack8(l2 + 8);
      o4[2] = pack8(mp);
      o4[3] = pack8(mp + 8);
    }
    uint4* dst = reinterpret_cast<uint4*>(cc + p * 32);
#pragma unroll
    for (int k = 0; k < 4; ++k) dst[k] = o4[k];
  }
  __syncthreads();

  // stage C: fuse conv 3x3 32->16, one thread per output pixel
  const int a = tid / kSbTP, bq = tid % kSbTP;
  const int q = q0 + a, pc = p0 + bq;
  if (q < H4 && pc < W4) {
    float acc[16];
#pragma unroll
    for (int o = 0; o < 16; ++o) acc[o] = bfs[o];
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint4* src = reinterpret_cast<const uint4*>(
          cc + ((a + dy) * kSbCC + bq + dx) * 32);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float f[8];
        unpack8(src[v], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float* wr = wf + (tap * 32 + v * 8 + e) * 16;
#pragma unroll
          for (int o = 0; o < 16; ++o) acc[o] = fmaf(f[e], wr[o], acc[o]);
        }
      }
    }
#pragma unroll
    for (int o = 0; o < 16; ++o) acc[o] = fmaxf(acc[o], 0.f);
    uint4* dst =
        reinterpret_cast<uint4*>(out + (((size_t)b * H4 + q) * W4 + pc) * 16);
    dst[0] = pack8(acc);
    dst[1] = pack8(acc + 8);
  }
}

}  // namespace

// ------------------------------------------------------------ C interface

extern "C" int mds_stem_conv_bn_relu_s2(const void* x, const void* w,
                                        void* out, int B, int H, int W, int O,
                                        int relu, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * (H / 2) * (W / 2);
  const long long need = (total + kStemThreads - 1) / kStemThreads;
  const long long blocks = need < 8LL * sms ? need : 8LL * sms;
  stem_kernel<<<(unsigned)blocks, kStemThreads, 28 * O * sizeof(float),
                (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w),
      static_cast<bf16*>(out), B, H, W, O, relu);
  return (int)cudaGetLastError();
}

extern "C" int mds_stem_conv_bn_relu_s2_window(const void* x, const void* w,
                                               void* out, int B, int H, int W,
                                               int O, int relu, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W / 2 + kWinTC - 1) / kWinTC;
  const int tiles_y = (H / 2 + kWinTR - 1) / kWinTR;
  const long long tiles = (long long)tiles_x * tiles_y * B;
  // persistent: about four tiles a block, so the double buffer has work
  const long long blocks = tiles < 4LL * sms ? tiles : 4LL * sms;
  const size_t smem = 28 * O * sizeof(float) + 2 * kWinBuf * sizeof(uint32_t);
  stem_window_kernel<<<(unsigned)blocks, kStemThreads, smem,
                       (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w),
      static_cast<bf16*>(out), B, H, W, O, relu, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

extern "C" int mds_stem_s1_pair_fused(const void* x, const void* w1,
                                      const void* w2p, const void* b2,
                                      void* out, int B, int H, int W,
                                      int relu2, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kPairSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 2 + kPairTP - 1) / kPairTP,
                  (H / 2 + kPairTQ - 1) / kPairTQ, B);
  pair_kernel<<<grid, kDetThreads, kPairSmem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w1),
      static_cast<const uint2*>(w2p), static_cast<const float*>(b2),
      static_cast<bf16*>(out), H, W, relu2);
  return (int)cudaGetLastError();
}

extern "C" int mds_detail_s1s2_fused(const void* x, const void* w1,
                                     const void* w2p, const void* b2,
                                     const void* w3p, const void* b3,
                                     void* out, int B, int H, int W,
                                     void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      detail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDetSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 4 + kDetTP - 1) / kDetTP, (H / 4 + kDetTQ - 1) / kDetTQ,
                  B);
  detail_kernel<<<grid, kDetThreads, kDetSmem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w1),
      static_cast<const uint2*>(w2p), static_cast<const float*>(b2),
      static_cast<const uint2*>(w3p), static_cast<const float*>(b3),
      static_cast<bf16*>(out), H, W);
  return (int)cudaGetLastError();
}

extern "C" int mds_stemblock_fused(const void* x, const void* w, void* out,
                                   int B, int H, int W, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stemblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSbSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W / 4 + kSbTP - 1) / kSbTP, (H / 4 + kSbTQ - 1) / kSbTQ, B);
  stemblock_kernel<<<grid, kSbThreads, kSbSmem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(w),
      static_cast<bf16*>(out), H, W);
  return (int)cudaGetLastError();
}
