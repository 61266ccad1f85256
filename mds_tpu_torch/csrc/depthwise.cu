// Hopper (sm_90a) depthwise / channel-multiplier 3x3 convolutions, bound
// with ctypes.
//
// Replaces two TPU kernels:
//   mds_dw3x3         <- mds_tpu/ops/pallas/depthwise.py depthwise3x3_pallas
//                        (stride 1 or 2, any multiplier m)
//   mds_dw3x3_window  <- mds_tpu/ops/pallas/depthwise_dma.py depthwise3x3_dma
//                        (stride 1, the input window staged by the kernel)
//
//   out[b, y, x, c*m + j] = sum over (dy, dx) of
//                           x[b, s*y + dy - 1, s*x + dx - 1, c] * w[c*m + j][dy*3 + dx]
//
// with zero padding 1. x is (B, H, W, C) in memory (a channels_last NCHW
// tensor), w the torch OIHW weight (C*m, 1, 3, 3) in x's type, read as it is,
// out (B, ceil(H/s), ceil(W/s), C*m). T is bf16 or f32. Arithmetic: each
// product in f32, the sum in (dy, dx) row-major order starting from the
// first product, no FMA contraction (__fmul_rn / __fadd_rn), one rounding to
// T at the end: the sum of mds_tpu/ops/depthwise.py:40-46 and of the plain
// version in mds_tpu_torch/ops/depthwise.py, bit for bit; a padding tap adds
// its +-0 product as the plain version's zero padding does. The two kernels
// are therefore bit-identical at stride 1.
//
// Bound: memory. Each output takes 9 multiply-adds for its 2 bytes (bf16):
// 4.5 flop/byte in, 9 per byte out, against the ~20 flop/byte at which an
// H100's 67 TFLOP/s of f32 CUDA-core work would overtake its 3.35 TB/s. The
// 16 depthwise convs of a 1024x2048 BiSeNetV2 frame move ~100 MB (~30 us at
// 3.35 TB/s).
//
// mds_dw3x3 (the model's kernel) has two forms. At a channel multiplier
// m > 1 (bf16, C % 8 == 0, m <= 12: BiSeNetV2's m = 6 expansions, which
// write the frame's largest depthwise outputs) a block stages its output
// tile's input window, 8 input channels of each pixel in one 16-byte
// cp.async, in shared memory, and each thread computes 4 pixels x 8 output
// channels from the 2 (at m = 6) input channels they read, its 72 weights
// in registers (staged in shared memory beside the window instead, the m = 6
// shapes took 1.1-1.6x as long on an H100): every input byte
// is read from device memory once per block, by 16-byte accesses (the
// section below). Otherwise a thread computes P neighbouring output pixels
// of one row for a run of 8 consecutive output channels: P = 4, 2 or 1, the
// most that gives every SM a block (at P = 4 the /32 shapes would fill half
// the SMs). Its 72 weights are one contiguous 144-byte run of the OIHW
// weight, loaded once into registers; each of the (P-1)*s + 3 input columns
// of the three rows is loaded once and fed to every pixel whose tap it is.
// Lanes run over the channel groups: a warp's loads and 16-byte stores are
// contiguous along C. Inputs come through the read-only path
// (ld.global.nc). With m = 1 and C % 8 == 0 a column is one 16-byte load;
// otherwise each output channel loads its own input channel. Ragged widths
// and channel counts are masked.
//
// mds_dw3x3_window (on no model path, as in JAX) stages its input window as
// the TPU kernel does, with Hopper's counterpart of that DMA: the Tensor
// Memory Accelerator. The NHWC input is a 4-d tensor map (C, W, H, B); one
// copy brings a tile's (TH+2) x (TW+2) x Cb window, the halo and the ragged
// right and bottom edges zero-filled by the hardware (the plain version's
// +0 padding), so the load side has no masks. Blocks are persistent: each
// keeps one run of Cb input channels for its life, its threads' weights in
// registers, and walks the run's tiles (b, y, x) with a ring of kWinStages
// windows (full and empty mbarriers): a producer warp's first lane issues
// the copy of tile k + kWinStages into a slot once the consumer warps have
// released it, so the copies overlap the arithmetic. Lanes run over
// channels, each thread computing P neighbouring pixels of a row (kWinP1 at
// m = 1, kWinPM at m > 1) with its weights in registers: at m = 1 it owns
// a 16-byte run of channels (8 bf16 or 4 f32), a window column one 16-byte
// shared load and its output one 16-byte store; at m > 1 it owns
// mc outputs of one input channel (mc the largest divisor of m up to 8:
// BiSeNetV2's m = 6 whole), so a column is one value that feeds all of them
// and a warp's stores cover whole runs of a pixel's outputs (the 8
// consecutive outputs of the first design read up to two input channels
// each, and the choice between them, value by value, was the largest part
// of its m = 6 time). Cb is
// the widest power of two dividing C with a 128-byte pixel run at m = 1 and
// 64 bytes at m > 1 (m = 6: 32 channels, a pixel's 192 outputs three
// 128-byte lines); a tile is kWinTW columns wide where the block's threads
// allow and as many rows as they fill (kWinTHMax at most), fewer where the
// tiles would not give every SM one. The tensor map needs C * sizeof(T) %
// 16 == 0 and a 16-byte aligned input; other shapes (C % 8 != 0 in bf16,
// C % 4 != 0 in f32, a misaligned tensor) take the masked kernel,
// dw3x3_window_masked: a block owns an 8x16 output tile and 8 input
// channels, copies its (8+2)x(16+2)x8 window with cp.async (16-byte chunks,
// the halo zero-filled through src-size 0) or, at C % 8 != 0, plain loads,
// then each thread reads its 9 taps for each group of 8 output channels.
// Both count as the wrapper's launches: a dispatch on shape between two
// CUDA kernels.
//
// JAX's XLA-side halo restack, stride-2 parity planes, _BLOCK_BYTES tiling
// and (..., m, C) output with an outside transpose are Mosaic workarounds and
// have no counterpart here. Each launcher returns the cudaError_t of its
// launch (0 on success).

#include "wgmma.cuh"

namespace {

constexpr int kVec = 8;  // output channels per thread
constexpr int kThreads = 128;
constexpr int kTH = 8, kTW = 16, kCT = 8;  // dw3x3_window_masked's tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// 8 consecutive values (16-byte aligned) as f32, through the read-only path.
__device__ __forceinline__ void load8(const bf16* p, float (&v)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
  v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
  v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z);
  v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 f32 values rounded to T, one or two 16-byte stores (16-byte aligned).
__device__ __forceinline__ void store8(bf16* p, const float (&v)[kVec]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}
__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The 72 weights of output channels o0 .. o0+7 (OIHW rows of 9), as
// wr[k][tap]; with `vec` one contiguous, 16-byte aligned run of 72 values,
// else masked at Co.
template <typename T>
__device__ __forceinline__ void load_weights(const T* __restrict__ w, int o0,
                                             int Co, bool vec,
                                             float (&wr)[kVec][9]) {
  if (vec) {
    const T* p = w + (long long)o0 * 9;
#pragma unroll
    for (int q = 0; q < 9; ++q) {  // 9 runs of 8 values
      float v[kVec];
      load8(p + q * kVec, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int f = q * kVec + e;  // flat index k*9 + tap
        wr[f / 9][f % 9] = v[e];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        wr[k][t] = o0 + k < Co ? to_f(__ldg(w + (long long)(o0 + k) * 9 + t))
                               : 0.f;
  }
}

// acc = first product, then acc + product, in tap order; no FMA.
__device__ __forceinline__ float madd(float acc, float v, float w, int tap) {
  const float p = __fmul_rn(v, w);
  return tap == 0 ? p : __fadd_rn(acc, p);
}

// ----------------------------------------------------- kernel 9: mds_dw3x3

// XVEC: m == 1, C % 8 == 0 and x 16-byte aligned (a column is one vector).
// OVEC: C*m % 8 == 0 and w, out 16-byte aligned.
// P: output pixels per thread.
template <typename T, int S, int P, bool XVEC, bool OVEC>
__global__ void __launch_bounds__(kThreads)
dw3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, int B, int H, int W, int C, int M, int Ho,
             int Wo, int G, int strips) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)B * Ho * strips * G) return;
  const int g = (int)(idx % G);
  long long r = idx / G;
  const int strip = (int)(r % strips);
  r /= strips;
  const int oy = (int)(r % Ho);
  const int b = (int)(r / Ho);
  const int Co = C * M;
  const int o0 = g * kVec;
  const int ox0 = strip * P;

  float wr[kVec][9];
  load_weights(w, o0, Co, OVEC, wr);
  int ci[kVec];  // input channel of each output channel, -1 past Co
#pragma unroll
  for (int k = 0; k < kVec; ++k) ci[k] = o0 + k < Co ? (o0 + k) / M : -1;

  float acc[P][kVec] = {};
  constexpr int kCols = (P - 1) * S + 3;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int iy = oy * S + dy - 1;
    const bool row_ok = iy >= 0 && iy < H;
    const T* xrow = x + ((long long)b * H + (row_ok ? iy : 0)) * W * C;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int ix = ox0 * S - 1 + j;
      const bool ok = row_ok && ix >= 0 && ix < W;
      float v[kVec];
      if (XVEC) {
        if (ok) {
          load8(xrow + (long long)ix * C + o0, v);
        } else {
#pragma unroll
          for (int k = 0; k < kVec; ++k) v[k] = 0.f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          v[k] = ok && ci[k] >= 0 ? to_f(__ldg(xrow + (long long)ix * C + ci[k]))
                                  : 0.f;
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int dx = j - S * p;  // this column's tap for pixel p
        if (dx < 0 || dx > 2) continue;
        const int tap = dy * 3 + dx;
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          acc[p][k] = madd(acc[p][k], v[k], wr[k][tap], tap);
      }
    }
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int ox = ox0 + p;
    if (ox >= Wo) break;
    T* dst = out + (((long long)b * Ho + oy) * Wo + ox) * Co + o0;
    if (OVEC) {
      store8(dst, acc[p]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (o0 + k < Co) dst[k] = from_f<T>(acc[p][k]);
    }
  }
}

// ------------------- kernel 10, the masked form: mds_dw3x3_window

// ASYNC: C % 8 == 0 and x 16-byte aligned (each window pixel is whole
// 16-byte chunks). OVEC as above.
template <typename T, bool ASYNC, bool OVEC>
__global__ void __launch_bounds__(kTH * kTW)
dw3x3_window_masked(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ out, int B, int H, int W, int C, int M) {
  __shared__ __align__(16) T win[kTH + 2][kTW + 2][kCT];
  const int nct = (C + kCT - 1) / kCT;
  const int b = blockIdx.z / nct, c0 = (blockIdx.z % nct) * kCT;
  const int ty0 = blockIdx.y * kTH, tx0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  constexpr int kPixels = (kTH + 2) * (kTW + 2);

  if (ASYNC) {
    constexpr int kChunk = 16 / sizeof(T);  // values per 16-byte chunk
    constexpr int kChunks = kCT / kChunk;   // chunks per window pixel
    for (int i = tid; i < kPixels * kChunks; i += kTH * kTW) {
      const int q = i % kChunks, pix = i / kChunks;
      const int wy = pix / (kTW + 2), wx = pix % (kTW + 2);
      const int iy = ty0 + wy - 1, ix = tx0 + wx - 1;
      const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const T* src =
          ok ? x + (((long long)b * H + iy) * W + ix) * C + c0 + q * kChunk : x;
      cp_async16(&win[wy][wx][q * kChunk], src, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {
    for (int i = tid; i < kPixels * kCT; i += kTH * kTW) {
      const int k = i % kCT, pix = i / kCT;
      const int wy = pix / (kTW + 2), wx = pix % (kTW + 2);
      const int iy = ty0 + wy - 1, ix = tx0 + wx - 1;
      const bool ok =
          iy >= 0 && iy < H && ix >= 0 && ix < W && c0 + k < C;
      win[wy][wx][k] =
          ok ? x[(((long long)b * H + iy) * W + ix) * C + c0 + k] : from_f<T>(0.f);
    }
  }
  __syncthreads();

  const int ty = tid / kTW, tx = tid % kTW;
  const int oy = ty0 + ty, ox = tx0 + tx;
  if (oy >= H || ox >= W) return;
  const int Co = C * M;
  T* dst_px = out + (((long long)b * H + oy) * W + ox) * Co;
  // the tile's 8*m output channels c0*m ... as m groups of 8
  for (int q = 0; q < M; ++q) {
    const int o0 = c0 * M + q * kVec;
    if (o0 >= Co) break;
    float wr[kVec][9];
    load_weights(w, o0, Co, OVEC, wr);
    int lc[kVec];  // window channel of each output channel
#pragma unroll
    for (int k = 0; k < kVec; ++k) lc[k] = min((q * kVec + k) / M, kCT - 1);
    float acc[kVec] = {};
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const T* px = win[ty + tap / 3][tx + tap % 3];
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        acc[k] = madd(acc[k], to_f(px[lc[k]]), wr[k][tap], tap);
    }
    T* dst = dst_px + o0;
    if (OVEC) {
      store8(dst, acc);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        if (o0 + k < Co) dst[k] = from_f<T>(acc[k]);
    }
  }
}

// ------------------------------ kernel 10, the TMA form: mds_dw3x3_window

constexpr int kWinStages = 3;   // windows in flight a block
// consumer threads a block, at most: with the producer warp 256 threads, two
// warps on each of an SM's four register-file quarters (255 registers a
// thread; a ninth warp would cap it at 168)
constexpr int kWinNC = 224;
// output pixels a thread (neighbours in a row), at m = 1 and at m > 1
constexpr int kWinP1 = 4, kWinPM = 8;
// tile columns where a block's threads allow, and tile rows at most
constexpr int kWinTW = 32, kWinTHMax = 32;
// a pixel's channel run in bytes, at most: at m = 1 and at m > 1
constexpr int kWinRunBytes1 = 128, kWinRunBytesM = 64;
constexpr int kWinMaxMC = 8;  // outputs of one input channel a thread, at m > 1

// A launch's shapes and tiling (host-computed, passed by value).
struct WinGeo {
  int H, W, C, M;
  int cb;           // input channels of a run
  int lanes;        // threads of a pixel strip: cb / (16 / sizeof(T)) at m = 1,
                    // cb * M / mc at m > 1
  int mc;           // m > 1: outputs a thread, all of one input channel
  int strips;       // strips of P pixels in a tile: th * spr
  int th, tw, spr;  // tile rows, columns (P * spr), strips a row
  int runs, tiles_x, tiles_y, tiles;  // channel runs; tiles of a run, all images
  int box_bytes;    // one window, as the copy counts it
  int stage_bytes;  // one ring slot (box_bytes rounded up to 128)
};

__device__ __forceinline__ void unpack16(uint4 u, float (&v)[8]) {
  v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x);
  v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
  v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z);
  v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
}
__device__ __forceinline__ void unpack16(float4 u, float (&v)[4]) {
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
// 16 bytes of T (16-byte aligned) as f32: from global memory through the
// read-only path, or from shared memory; and 16 bytes stored.
__device__ __forceinline__ void ldg16(const bf16* p, float (&v)[8]) {
  unpack16(__ldg(reinterpret_cast<const uint4*>(p)), v);
}
__device__ __forceinline__ void ldg16(const float* p, float (&v)[4]) {
  unpack16(__ldg(reinterpret_cast<const float4*>(p)), v);
}
__device__ __forceinline__ void lds16(const bf16* p, float (&v)[8]) {
  unpack16(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void lds16(const float* p, float (&v)[4]) {
  unpack16(*reinterpret_cast<const float4*>(p), v);
}
__device__ __forceinline__ void store16(bf16* p, const float (&v)[8]) { store8(p, v); }
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
// N consecutive values rounded to T: bf16 pairs as 4-byte stores where N is
// even (p then 4-byte aligned), else one value at a time.
template <int N>
__device__ __forceinline__ void store_n(bf16* p, const float (&v)[N]) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 2)
      *reinterpret_cast<uint32_t*>(p + i) = pack_bf16x2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = v[i];
}

// The 9 * V weights of output channels o0 .. o0 + V - 1 (OIHW rows of 9),
// as wr[k][tap]: one contiguous run of nine 16-byte chunks (aligned, as o0
// is a multiple of V) where V values are 16 bytes, else read one value at a
// time.
template <typename T, int V>
__device__ __forceinline__ void load_weights_run(const T* __restrict__ w, long long o0,
                                                 float (&wr)[V][9]) {
  const T* p = w + o0 * 9;
  if constexpr (V * sizeof(T) == 16) {
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      float v[V];
      ldg16(p + q * V, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int f = q * V + e;  // flat index k*9 + tap
        wr[f / 9][f % 9] = v[e];
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
#pragma unroll
      for (int t = 0; t < 9; ++t) wr[k][t] = to_f(__ldg(p + k * 9 + t));
  }
}

// MC == 0: m == 1, a thread's outputs are one 16-byte run of channels, each
// read from its own input channel (a column is one 16-byte shared load);
// else MC outputs of one input channel (a column is one value, no select).
// P: output pixels a thread. The warp after the consumers produces: its
// first lane issues window k into slot k % kWinStages once the consumer
// warps have released the window before it.
template <typename T, int MC, int P>
__global__ void __launch_bounds__(kWinNC + 32, 1)
dw3x3_window_kernel(const __grid_constant__ CUtensorMap xmap,
                    const T* __restrict__ w, T* __restrict__ out, const WinGeo g) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kOut = MC ? MC : kV;  // outputs a thread, of each pixel
  extern __shared__ __align__(128) unsigned char win_smem[];
  unsigned char* base = win_smem + ((128u - (smem_u32(win_smem) & 127u)) & 127u);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);  // a slot's window arrived
  uint64_t* empty = full + kWinStages;                 // a slot's window read
  unsigned char* ring = base + 128;
  const int workers = g.lanes * g.strips;
  const int nc = (workers + 31) / 32 * 32;  // consumer threads, whole warps
  const int run = blockIdx.x % g.runs, c0 = run * g.cb;
  const int first = blockIdx.x / g.runs, step = gridDim.x / g.runs;
  const int n = first < g.tiles ? (g.tiles - first + step - 1) / step : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWinStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, nc / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= nc) {  // the producer warp
    if (threadIdx.x == nc) {
      for (int k = 0; k < n; ++k) {
        const int slot = k % kWinStages, t = first + k * step;
        if (k >= kWinStages) mbar_wait(empty + slot, (k / kWinStages - 1) & 1);
        const int tx = t % g.tiles_x, ty = (t / g.tiles_x) % g.tiles_y;
        const int b = t / (g.tiles_x * g.tiles_y);
        mbar_arrive_expect_tx(full + slot, g.box_bytes);
        tma_load_4d(ring + slot * g.stage_bytes, &xmap, c0, tx * g.tw - 1,
                    ty * g.th - 1, b, full + slot);
      }
    }
    return;
  }

  const bool works = threadIdx.x < workers;
  const int lane = threadIdx.x % g.lanes, strip = threadIdx.x / g.lanes;
  const int r = strip / g.spr, px0 = (strip % g.spr) * P;
  // the run's input channel this thread reads (m = 1: its first) and its
  // first output channel
  int ch;
  long long o0;
  if constexpr (MC) {
    const int per = g.M / MC;  // threads of an input channel
    ch = lane / per;
    o0 = (long long)(c0 + ch) * g.M + lane % per * MC;
  } else {
    ch = lane * kV;
    o0 = c0 + ch;
  }
  const int Co = g.C * g.M;
  float wr[kOut][9];
  if (works) load_weights_run(w, o0, wr);
  const int row_vals = (g.tw + 2) * g.cb;  // values in a window row

  for (int k = 0; k < n; ++k) {
    const int slot = k % kWinStages, t = first + k * step;
    mbar_wait(full + slot, (k / kWinStages) & 1);
    if (works) {
      const T* win = reinterpret_cast<const T*>(ring + slot * g.stage_bytes);
      float acc[P][kOut] = {};
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const T* wrow = win + (r + dy) * row_vals + px0 * g.cb + ch;
#pragma unroll
        for (int j = 0; j < P + 2; ++j) {
          float v[kOut];
          if constexpr (MC) {
            const float c = to_f(wrow[j * g.cb]);
#pragma unroll
            for (int q = 0; q < kOut; ++q) v[q] = c;
          } else {
            lds16(wrow + j * g.cb, v);
          }
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int dx = j - p;  // this column's tap for pixel p
            if (dx < 0 || dx > 2) continue;
            const int tap = dy * 3 + dx;
#pragma unroll
            for (int q = 0; q < kOut; ++q) acc[p][q] = madd(acc[p][q], v[q], wr[q][tap], tap);
          }
        }
      }
      const int tx = t % g.tiles_x, ty = (t / g.tiles_x) % g.tiles_y;
      const int b = t / (g.tiles_x * g.tiles_y);
      const int oy = ty * g.th + r, ox0 = tx * g.tw + px0;
      if (oy < g.H) {
        T* dst = out + (((long long)b * g.H + oy) * g.W + ox0) * Co + o0;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (ox0 + p >= g.W) break;
          if constexpr (MC) store_n(dst + (long long)p * Co, acc[p]);
          else store16(dst + (long long)p * Co, acc[p]);
        }
      }
    }
    __syncwarp();  // the warp's reads of the slot are done
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
  }
}

// ------------------- kernel 9, channel multiplier m > 1: mds_dw3x3 staged
//
// A block owns a kMTH x kMTW tile of output pixels and one run of 8 input
// channels (8m output channels). It copies the tile's input window, each
// pixel's 8 channels one 16-byte cp.async (zero-filled outside the image),
// into shared memory: every input byte the block needs is read once, by
// 16-byte accesses. Thread (pixel strip, group g) then computes kMP pixels
// of output channels 8g .. 8g + 7 of the run from its 72 weights in
// registers; those 8 outputs read at most ND of the run's input channels
// (ND = 2 at m = 6), so a window column is ND shared loads, each feeding
// 8 / ND outputs of every pixel whose tap it is. The m groups of one pixel
// store 16 m contiguous bytes in 16-byte stores. bf16, C % 8 == 0, m <= 12.
constexpr int kMTH = 4, kMTW = 32, kMP = 4;  // output tile, pixels per thread
constexpr int kMStrips = kMTH * kMTW / kMP;  // threads per output group
constexpr int kMMax = 12;                    // the largest m it takes

template <int S, int ND>
__global__ void __launch_bounds__(kMMax * kMStrips)
dw3x3_kernel_mult(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  bf16* __restrict__ out, int H, int W, int C, int M, int Ho,
                  int Wo, int tiles_x, int tiles_y) {
  constexpr int kWR = (kMTH - 1) * S + 3, kWC = (kMTW - 1) * S + 3;
  __shared__ __align__(16) bf16 win[kWR * kWC * 8];
  const int tile = blockIdx.x, c8 = blockIdx.y;
  const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
  const int b = tile / (tiles_x * tiles_y);
  const int oy0 = ty * kMTH, ox0 = tx * kMTW;
  for (int i = threadIdx.x; i < kWR * kWC; i += blockDim.x) {
    const int iy = oy0 * S - 1 + i / kWC, ix = ox0 * S - 1 + i % kWC;
    const bool ok = iy >= 0 && iy < H && ix >= 0 && ix < W;
    const bf16* src = ok ? x + (((long long)b * H + iy) * W + ix) * C + 8 * c8 : x;
    cp_async16(win + 8 * i, src, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int g = threadIdx.x % M, strip = threadIdx.x / M;
  const int Co = C * M, o0 = 8 * c8 * M + 8 * g;
  float wr[kVec][9];
  load_weights(w, o0, Co, true, wr);
  // output k reads the run's input channel lo + off[k]
  const int lo = 8 * g / M;
  int off[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) off[k] = (8 * g % M + k) / M;
  const int r = strip / (kMTW / kMP), px0 = (strip % (kMTW / kMP)) * kMP;

  float acc[kMP][kVec] = {};
  constexpr int kCols = (kMP - 1) * S + 3;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const bf16* wrow = win + ((r * S + dy) * kWC + px0 * S) * 8;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float c[ND];
#pragma unroll
      for (int d = 0; d < ND; ++d) c[d] = to_f(wrow[j * 8 + min(lo + d, 7)]);
      float v[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        v[k] = c[0];
#pragma unroll
        for (int d = 1; d < ND; ++d) v[k] = off[k] == d ? c[d] : v[k];
      }
#pragma unroll
      for (int p = 0; p < kMP; ++p) {
        const int dx = j - S * p;  // this column's tap for pixel p
        if (dx < 0 || dx > 2) continue;
        const int tap = dy * 3 + dx;
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          acc[p][k] = madd(acc[p][k], v[k], wr[k][tap], tap);
      }
    }
  }
  const int oy = oy0 + r;
  if (oy >= Ho) return;
#pragma unroll
  for (int p = 0; p < kMP; ++p) {
    const int ox = ox0 + px0 + p;
    if (ox >= Wo) break;
    store8(out + (((long long)b * Ho + oy) * Wo + ox) * Co + o0, acc[p]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The most input channels that one group's 8 outputs read, at multiplier m.
int span(int M) {
  int nd = 1;
  for (int g = 0; g < M; ++g) nd = max(nd, (8 * g % M + 7) / M + 1);
  return nd;
}

template <typename T, int S>
cudaError_t launch_dw3x3(const void* x, const void* w, void* out, int B, int H,
                         int W, int C, int M, cudaStream_t stream) {
  const int Ho = (H + S - 1) / S, Wo = (W + S - 1) / S;
  const bool ovec = (C * M) % kVec == 0 && aligned16(w) && aligned16(out);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if constexpr (sizeof(T) == 2) {
    const int nd = span(M);
    if (M > 1 && M <= kMMax && C % kVec == 0 && aligned16(x) && ovec && nd <= 4) {
      const int tiles_x = (Wo + kMTW - 1) / kMTW, tiles_y = (Ho + kMTH - 1) / kMTH;
      const dim3 grid((unsigned)((long long)tiles_x * tiles_y * B), C / kVec);
      const int threads = M * kMStrips;
#define MDS_DW3X3_MULT(ND)                                                 \
  dw3x3_kernel_mult<S, ND><<<grid, threads, 0, stream>>>(                  \
      xp, wp, op, H, W, C, M, Ho, Wo, tiles_x, tiles_y)
      if (nd <= 2) MDS_DW3X3_MULT(2);
      else MDS_DW3X3_MULT(4);
#undef MDS_DW3X3_MULT
      return cudaGetLastError();
    }
  }
  // pixels per thread: the most of 4, 2, 1 that gives every SM a block
  const int G = (C * M + kVec - 1) / kVec;
  auto blocks_of = [&](int p) {
    return ((long long)B * Ho * ((Wo + p - 1) / p) * G + kThreads - 1) / kThreads;
  };
  const int P = blocks_of(4) >= sm_count() ? 4 : blocks_of(2) >= sm_count() ? 2 : 1;
  const int strips = (Wo + P - 1) / P;
  const unsigned blocks = (unsigned)blocks_of(P);
  const bool xvec = M == 1 && C % kVec == 0 && aligned16(x);
#define MDS_DW3X3(PP, XV, OV)                                              \
  dw3x3_kernel<T, S, PP, XV, OV><<<blocks, kThreads, 0, stream>>>(         \
      xp, wp, op, B, H, W, C, M, Ho, Wo, G, strips)
#define MDS_DW3X3_P(XV, OV)                                                \
  if (P == 4) MDS_DW3X3(4, XV, OV);                                        \
  else if (P == 2) MDS_DW3X3(2, XV, OV);                                   \
  else MDS_DW3X3(1, XV, OV)
  if (xvec && ovec) { MDS_DW3X3_P(true, true); }
  else if (ovec) { MDS_DW3X3_P(false, true); }
  else { MDS_DW3X3_P(false, false); }  // a misaligned w or out: all scalar
#undef MDS_DW3X3_P
#undef MDS_DW3X3
  return cudaGetLastError();
}

// The TMA form's tiling of (B, H, W, C) at multiplier M, P pixels a thread,
// or false where the shape takes the masked form.
template <typename T>
bool plan_window(int B, int H, int W, int C, int M, int P, WinGeo& g) {
  constexpr int kV = 16 / sizeof(T);
  g = WinGeo{H, W, C, M};
  // m > 1: the most outputs of one channel a thread that divides m
  g.mc = 0;
  for (int mc = min(M, kWinMaxMC); M > 1 && !g.mc; --mc)
    if (M % mc == 0) g.mc = mc;
  const int per_channel = M == 1 ? 1 : M / g.mc;  // threads of an input channel
  const int max_cb = (M == 1 ? kWinRunBytes1 : kWinRunBytesM) / (int)sizeof(T);
  for (int cb = max_cb; cb >= kV && !g.cb; cb /= 2)
    if (C % cb == 0 && (M == 1 ? cb / kV : cb * per_channel) <= kWinNC) g.cb = cb;
  if (!g.cb) return false;
  g.lanes = M == 1 ? g.cb / kV : g.cb * per_channel;
  // kWinTW columns where the block's threads allow (a power of two, so the
  // tiles divide the frame's widths), then as many rows
  g.spr = 1;
  while (2 * g.spr <= min(kWinNC / g.lanes, kWinTW / P)) g.spr *= 2;
  g.tw = P * g.spr;
  g.th = min(kWinTHMax, kWinNC / (g.lanes * g.spr));
  g.runs = C / g.cb;
  g.tiles_x = (W + g.tw - 1) / g.tw;
  auto tiles_of = [&](int th) { return (long long)B * ((H + th - 1) / th) * g.tiles_x; };
  while (g.th > 1 && tiles_of(g.th) * g.runs < sm_count()) g.th /= 2;  // every SM a tile
  if (tiles_of(g.th) >= (1LL << 31)) return false;
  g.strips = g.th * g.spr;
  g.tiles_y = (H + g.th - 1) / g.th;
  g.tiles = (int)tiles_of(g.th);
  g.box_bytes = (g.th + 2) * (g.tw + 2) * g.cb * (int)sizeof(T);
  g.stage_bytes = (g.box_bytes + 127) / 128 * 128;
  return true;
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

template <typename T, int MC, int P>
cudaError_t launch_window_tma(const CUtensorMap& map, const T* w, T* out, const WinGeo& g,
                              cudaStream_t stream) {
  auto kernel = dw3x3_window_kernel<T, MC, P>;
  const int threads = (g.lanes * g.strips + 31) / 32 * 32 + 32;  // + the producer
  const int smem = 256 + kWinStages * g.stage_bytes;  // barriers, alignment, ring
  static int smem_set = 0, last_threads = 0, last_smem = 0, per_sm = 1;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (threads != last_threads || smem != last_smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
            cudaSuccess || per_sm < 1)
      per_sm = 1;
    last_threads = threads;
    last_smem = smem;
  }
  // persistent: about every block the card holds at once, a whole number of
  // blocks per run and at most one per tile
  const int per_run = max(1, min(g.tiles, sm_count() * per_sm / g.runs));
  kernel<<<g.runs * per_run, threads, smem, stream>>>(map, w, out, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_window(const void* x, const void* w, void* out, int B, int H,
                          int W, int C, int M, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  constexpr int kV = 16 / sizeof(T);
  const int P = M == 1 ? kWinP1 : kWinPM;
  WinGeo g{};
  if (C % kV == 0 && aligned16(x) && aligned16(w) && aligned16(out) &&
      plan_window<T>(B, H, W, C, M, P, g)) {
    EncodeTiledFn encode = encode_tiled();
    if (!encode) return cudaErrorNotSupported;
    const size_t e = sizeof(T);
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {C * e, (cuuint64_t)W * C * e, (cuuint64_t)H * W * C * e};
    const cuuint32_t box[4] = {(cuuint32_t)g.cb, (cuuint32_t)g.tw + 2, (cuuint32_t)g.th + 2, 1};
    const cuuint32_t unit[4] = {1, 1, 1, 1};
    CUtensorMap map;
    if (encode(&map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               4, const_cast<void*>(x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
    switch (g.mc) {
      case 0: return launch_window_tma<T, 0, kWinP1>(map, wp, op, g, stream);
      case 1: return launch_window_tma<T, 1, kWinPM>(map, wp, op, g, stream);
      case 2: return launch_window_tma<T, 2, kWinPM>(map, wp, op, g, stream);
      case 3: return launch_window_tma<T, 3, kWinPM>(map, wp, op, g, stream);
      case 4: return launch_window_tma<T, 4, kWinPM>(map, wp, op, g, stream);
      case 5: return launch_window_tma<T, 5, kWinPM>(map, wp, op, g, stream);
      case 6: return launch_window_tma<T, 6, kWinPM>(map, wp, op, g, stream);
      case 7: return launch_window_tma<T, 7, kWinPM>(map, wp, op, g, stream);
      default: return launch_window_tma<T, 8, kWinPM>(map, wp, op, g, stream);
    }
  }
  const dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH,
                  B * ((C + kCT - 1) / kCT));
  const bool async = C % kCT == 0 && aligned16(x);
  const bool ovec = (C * M) % kVec == 0 && aligned16(w) && aligned16(out);
#define MDS_WINDOW(AS, OV)                                                 \
  dw3x3_window_masked<T, AS, OV><<<grid, kTH * kTW, 0, stream>>>(          \
      xp, wp, op, B, H, W, C, M)
  if (async && ovec) MDS_WINDOW(true, true);
  else if (async) MDS_WINDOW(true, false);
  else if (ovec) MDS_WINDOW(false, true);
  else MDS_WINDOW(false, false);
#undef MDS_WINDOW
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C), w (C*m, 9), out (B, ceil(H/s), ceil(W/s), C*m); f32 != 0
// selects float, else bf16; stride 1 or 2.
extern "C" int mds_dw3x3(const void* x, const void* w, void* out, int B, int H,
                         int W, int C, int M, int stride, int f32,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (stride != 1 && stride != 2) return (int)cudaErrorInvalidValue;
  if (f32)
    return (int)(stride == 1 ? launch_dw3x3<float, 1>(x, w, out, B, H, W, C, M, s)
                             : launch_dw3x3<float, 2>(x, w, out, B, H, W, C, M, s));
  return (int)(stride == 1 ? launch_dw3x3<bf16, 1>(x, w, out, B, H, W, C, M, s)
                           : launch_dw3x3<bf16, 2>(x, w, out, B, H, W, C, M, s));
}

// stride 1 only; shapes as mds_dw3x3.
extern "C" int mds_dw3x3_window(const void* x, const void* w, void* out, int B,
                                int H, int W, int C, int M, int f32,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(f32 ? launch_window<float>(x, w, out, B, H, W, C, M, s)
                   : launch_window<bf16>(x, w, out, B, H, W, C, M, s));
}
