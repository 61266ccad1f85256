// Hopper (sm_90a) kernel for the 7x7 RGB stem of BiSeNetV1, bound with ctypes.
//
// Replaces mds_tpu/ops/pallas/stem.py::stem7_conv_bn_relu_s2 (:911, body
// _kernel7 :855-907): a 7x7 stride-2 pad-3 conv on a bf16 NHWC RGB image
// (B, H, W, 3), H and W even, with the eval BN folded in and an optional
// ReLU, bf16 NHWC out (B, H/2, W/2, O), O % 8 == 0, O <= 128. It is the
// ResNet18 conv1 and the SpatialPath conv1 of BiSeNetV1.
//
// Rounding points are the TPU kernel's: the weight is bf16(k * scale), the
// bias bf16(bias), both in the GEMM (the bias times an A of one, as the TPU
// kernel's row of ones); the products of bf16 values accumulate in f32, then
// the ReLU, then one rounding to bf16.
//
// Bound: memory. At 1024x2048 with O = 64 the conv reads 12.6 MB and writes
// 67.1 MB (0.024 ms at 3.35 TB/s) for 9.9 GFLOP (0.010 ms at 989 TFLOP/s).
// The design keeps the store stream going; on the card the pace is set by
// the per-tile shared-memory traffic (A's loads, B's reads by the tensor
// cores, the stage) and the N = 64 MMAs (PERF.md §6).
//
// - The GEMM: M = 64 output pixels of one output row (a tile, one
//   warpgroup), N = O padded to 16, 32, 64 or 128, K = 7 kernel rows x 24.
//   In NHWC at stride 2 the 21 taps (dx, ci) of one kernel row of output
//   pixel c are 21 consecutive elements of the input row, from element 6c - 9;
//   a row's 24 K values are the elements from 6c - 10 (the one before the
//   taps, weight zero, so that every (k, k + 1) pair is one aligned 32-bit
//   word), the 21 taps and two more of weight zero. A K chunk of 8 (one
//   lane quad's share of a k16 half) is then one third of one kernel row:
//   each lane's 42 A words of the 7 rows (21 chunks, two pixels) are 32-bit
//   shared loads at offsets fixed per lane, plus the window row's 16-byte
//   shift, and the elements of weight zero are masked to zero in A. K 168
//   (chunk 21, the last half k16 step) is the bias: A = 1 there, no load.
// - wgmma m64nNk16 with A from registers and B, bf16(k * scale) in that K
//   order (ops/stem.py pack_stem7, packed once per parameter version), in
//   shared memory for the block's life: three 64-deep slices of N rows in
//   wgmma's K-major layout with the 128-byte swizzle (wgmma.cuh), one bulk
//   copy. 11 wgmma a tile, one commit.
// - The window: the tile's 7 input rows, each a 16-byte aligned run of
//   816 bytes from the chunk that holds its first wanted byte, copied in
//   16-byte cp.async with zero fill while the tile before computes (two
//   buffers). What lies outside the image (rows above and below, columns
//   left and right) arrives as zeros: the conv's padding. The chunk that
//   starts before its image row (the leftmost tile's) goes as four 4-byte
//   copies.
// - The output: the epilogue ([ReLU] and bf16 in one cvt) writes the
//   accumulators by stmatrix into one of two stage buffers as the
//   tile's NHWC image, one contiguous run of up to 64 x O x 2 bytes, and
//   thread 0 hands it to the copy engine in one bulk copy (cp.async.bulk
//   shared to global, a bulk group per tile), so the 67 MB of stores stream
//   on while the next tiles load and compute; a stage is written again only
//   once its copy has read it (wait_group.read 1, two tiles on).
// - Blocks are persistent, one warpgroup each, as many as fit an SM (four
//   at O <= 64), each walking every gridDim.x-th tile.
// Any B >= 1 and even H, W: the pixels of a ragged tile past the image
// compute on zeros and are not copied out.
//
// The launcher returns the cudaError_t of its launch (0 on success).

#include "wgmma.cuh"

namespace {

constexpr int k7TC = 64;        // output pixels per tile: wgmma's M
constexpr int k7Threads = 128;  // one warpgroup
constexpr int k7KRow = 24;      // K per kernel row
constexpr int k7Chunks = 21;    // 8-wide K chunks in use: 7 rows x 3
constexpr int k7Steps = 11;     // k16 steps: K = 176, the last half zero
constexpr int k7Slices = 3;     // 64-deep K slices of B (192)
// a window row: a tile's wanted 2 * (6 * 63 + 24) bytes from up to 12 bytes
// after a 16-byte boundary, in whole 16-byte chunks (816 bytes)
constexpr int k7RowBytes = (2 * (6 * (k7TC - 1) + k7KRow) + 12 + 15) / 16 * 16;
constexpr int k7RowChunks = k7RowBytes / 16;
constexpr int k7WinBytes = 7 * k7RowBytes;

__host__ __device__ constexpr int s7_stage_bytes(int n) { return k7TC * n * 2; }

// 1024 bytes of slack to align B to the swizzle's 1024-byte pattern, B,
// two windows, two stages, the mbarrier of B's copy
__host__ __device__ constexpr size_t s7_smem(int n) {
  return 1024 + k7Slices * n * 128 + 2 * k7WinBytes + 2 * s7_stage_bytes(n) +
         sizeof(uint64_t);
}

struct S7Tile {
  int b, r, c0;  // image, output row, first output column
};

__device__ __forceinline__ S7Tile s7_tile(int tile, int tiles_x, int H2) {
  const int t = tile / tiles_x;
  return {t / H2, t % H2, (tile - t * tiles_x) * k7TC};
}

// Byte offset in x of element 6 * c0 - 10 of input row 2r - 3 + dy: the
// first wanted byte of window row dy (before the image row at its left
// edge; anywhere for a row outside the image).
__device__ __forceinline__ long long s7_row_start(S7Tile t, int dy, int H, int W) {
  return (((long long)t.b * H + 2 * t.r - 3 + dy) * W) * 6 + 12LL * t.c0 - 20;
}

// Tile t's window into win by cp.async, the chunks spread over the block's
// threads; bytes outside the image row (or its rows outside the image) are
// zero.
__device__ __forceinline__ void s7_window(unsigned char* win,
                                          const unsigned char* __restrict__ xb,
                                          S7Tile t, int H, int W) {
  const long long rowb = 6LL * W;
  for (int i = threadIdx.x; i < 7 * k7RowChunks; i += k7Threads) {
    const int dy = i / k7RowChunks, q = i - dy * k7RowChunks;
    unsigned char* dst = win + dy * k7RowBytes + 16 * q;
    const int y = 2 * t.r - 3 + dy;
    if (y < 0 || y >= H) {
      cp_async16(dst, xb, 0);
      continue;
    }
    const long long row = ((long long)t.b * H + y) * rowb;
    const long long g = (s7_row_start(t, dy, H, W) & ~15LL) + 16 * q;
    const long long lo = max(g, row), hi = min(g + 16, row + rowb);
    if (hi <= lo) {
      cp_async16(dst, xb, 0);
    } else if (g >= row) {
      cp_async16(dst, xb + g, (int)(hi - g));
    } else {  // the chunk starts before the row (rows start 4-byte aligned)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long a = g + 4 * k;
        const bool in = a >= row && a < hi;
        cp_async4(dst + 4 * k, in ? xb + a : xb, in ? 4 : 0);
      }
    }
  }
}

// Tile t's A fragments from its window w (the lane's base folded in): K
// chunk m = 2s + i of k16 step s in registers 2i, 2i + 1; chunk 21 holds
// the bias's A of one (K 168: lane quad 0's low half).
__device__ __forceinline__ void s7_tile_a(const unsigned char* w, S7Tile t, int H,
                                          int W, uint32_t keep0, uint32_t keep2,
                                          uint32_t one, uint32_t (&a)[k7Steps][4]) {
  const int sh0 = (int)(s7_row_start(t, 0, H, W) & 15);
  const int rw = (6 * W) & 15;  // a window row's shift step from the one above
#pragma unroll
  for (int s = 0; s < k7Steps; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = 2 * s + i, dy = m / 3, part = m % 3;
      if (m == k7Chunks) {
        a[s][2 * i] = a[s][2 * i + 1] = one;
        continue;
      }
      const uint32_t keep = part == 0 ? keep0 : part == 2 ? keep2 : 0xffffffffu;
      const unsigned char* p = w + dy * k7RowBytes + ((sh0 + dy * rw) & 15) + 16 * part;
      a[s][2 * i] = *reinterpret_cast<const uint32_t*>(p) & keep;
      a[s][2 * i + 1] = *reinterpret_cast<const uint32_t*>(p + 96) & keep;
    }
}

// The accumulators of a tile: [ReLU], bf16, by stmatrix into stage st as
// the tile's NHWC image: matrix (h, j) is pixels 16 warp + 8h .. + 7,
// channels 8j .. 8j + 7.
template <int N>
__device__ __forceinline__ void s7_epilogue(const float (&acc)[N / 2],
                                            unsigned char* st, int O, int relu) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = O / 8;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t row = smem_u32(st) + (16 * warp + 8 * h + (lane & 7)) * O * 2;
#pragma unroll
    for (int j4 = 0; j4 < N / 8; j4 += 4) {
      if (j4 >= nv) break;
      uint32_t v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j4 + jj;
        if (j < N / 8) {
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          v[jj] = relu ? pack2_relu(v0, v1) : pack2(v0, v1);
        }
      }
      const int n = min(4, nv - j4);  // matrices of this group in O
      if (n == 4) {
        stmatrix_x4(row + 16 * (j4 + (lane >> 3)), v);
      } else {
        if (n >= 2) stmatrix_x2(row + 16 * (j4 + ((lane >> 3) & 1)), v);
        if (n != 2) stmatrix_x1(row + 16 * (j4 + (n & 2)), n & 2 ? v[2] : v[0]);
      }
    }
  }
  fence_proxy_async();
}

// The stage of tile t to out in one bulk copy (thread 0's bulk group).
__device__ __forceinline__ void s7_store(const unsigned char* st, bf16* out, S7Tile t,
                                         int H2, int W2, int O) {
  const int np = min(k7TC, W2 - t.c0);
  bulk_s2g(out + (((size_t)t.b * H2 + t.r) * W2 + t.c0) * O, st, np * O * 2);
  bulk_commit();
}

// wpk: ops/stem.py pack_stem7's three slices of N rows x 128 bytes.
template <int N>
__global__ void __launch_bounds__(k7Threads, N <= 64 ? 4 : 2)
    stem7_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wpk,
                 bf16* __restrict__ out, int B, int H, int W, int O, int relu,
                 int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* tbl = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* win = tbl + k7Slices * N * 128;
  unsigned char* stage = win + 2 * k7WinBytes;
  constexpr int kStage = s7_stage_bytes(N);
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + 2 * kStage);
  const int H2 = H / 2, W2 = W / 2, tiles = B * H2 * tiles_x;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  int tile = blockIdx.x;
  if (threadIdx.x == 0) {  // B, once per block, by the copy engine
    mbar_arrive_expect_tx(bar, k7Slices * N * 128);
    bulk_g2s(tbl, wpk, k7Slices * N * 128, bar);
  }
  if (tile < tiles) s7_window(win, xb, s7_tile(tile, tiles_x, H2), H, W);
  cp_async_commit();
  mbar_wait(bar, 0);

  const uint32_t tbl_s = smem_u32(tbl);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // the lane's share of a K chunk: elements 2 tq, 2 tq + 1 of it, at pixel
  // 16 warp + gq (12 bytes a pixel); element 0 of a row (the one before the
  // taps) and elements 22, 23 have weight zero and are masked
  const int lbase = 12 * (16 * warp + gq) + 4 * tq;
  const uint32_t keep0 = tq == 0 ? 0xffff0000u : 0xffffffffu;
  const uint32_t keep2 = tq == 3 ? 0u : 0xffffffffu;
  const uint32_t one = tq == 0 ? 0x3F80u : 0u;  // bf16 1 at K 168, the bias's A

  S7Tile t = s7_tile(tile, tiles_x, H2);
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1, next = tile + gridDim.x;
    const S7Tile tn = s7_tile(next, tiles_x, H2);
    // the next tile's window into the other buffer, which every thread has
    // read (before the last iteration's second barrier)
    if (next < tiles) s7_window(win + (buf ^ 1) * k7WinBytes, xb, tn, H, W);
    cp_async_commit();  // possibly empty: the wait below stays uniform
    if (threadIdx.x == 0) bulk_wait_read<1>();  // this stage's last copy read it
    cp_async_wait<1>();
    __syncthreads();  // this window is whole; this stage is free

    uint32_t a[k7Steps][4];
    s7_tile_a(win + buf * k7WinBytes + lbase, t, H, W, keep0, keep2, one, a);
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      acc[i] = 0.f;
      reg_fence(acc[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < k7Steps; ++s)
      wgmma_m64nk16<N>(acc, a[s], sw128_desc(tbl_s + s / 4 * N * 128 + 32 * (s % 4)));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) reg_fence(acc[i]);
    unsigned char* st = stage + buf * kStage;
    s7_epilogue<N>(acc, st, O, relu);
    __syncthreads();  // the stage is whole, and this window is read
    if (threadIdx.x == 0) s7_store(st, out, t, H2, W2, O);
    t = tn;
  }
  if (threadIdx.x == 0) bulk_wait<0>();
  cp_async_wait<0>();
}

template <int N>
int stem7_launch(const void* x, const void* wpk, void* out, int B, int H, int W,
                 int O, int relu, cudaStream_t stream) {
  auto kern = stem7_kernel<N>;
  constexpr size_t smem = s7_smem(N);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, k7Threads,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W / 2 + k7TC - 1) / k7TC;
  const long long tiles = (long long)B * (H / 2) * tiles_x;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > tiles) blocks = tiles;
  kern<<<(unsigned)blocks, k7Threads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wpk),
      static_cast<bf16*>(out), B, H, W, O, relu, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// ------------------------------------------------------------ C interface

// wpk: ops/stem.py pack_stem7 (N = O padded to 16, 32, 64 or 128).
extern "C" int mds_stem7_conv_bn_relu_s2(const void* x, const void* wpk, void* out,
                                         int B, int H, int W, int O, int relu,
                                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (O <= 0 || O % 8 || O > 128 || B < 1 || H < 2 || W < 2 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  if (O <= 16) return stem7_launch<16>(x, wpk, out, B, H, W, O, relu, s);
  if (O <= 32) return stem7_launch<32>(x, wpk, out, B, H, W, O, relu, s);
  if (O <= 64) return stem7_launch<64>(x, wpk, out, B, H, W, O, relu, s);
  return stem7_launch<128>(x, wpk, out, B, H, W, O, relu, s);
}
