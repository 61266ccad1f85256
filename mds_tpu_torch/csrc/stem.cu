// Hopper (sm_90a) kernels for the BiSeNetV2 stems, bound with ctypes.
//
// Five kernels, one per TPU kernel of mds_tpu/ops/pallas/stem.py (numbered
// as PERF.md's table numbers them: 1, 2, 3, 4, 5). All take the memory of a
// channels_last bf16 tensor, i.e. an NHWC image (B, H, W, 3), and write NHWC
// bf16 (kernel 1's training form: f32). Their first stage is a 3x3 stride-2
// pad-1 conv on RGB with the BN folded into f32 weights, run on the tensor
// cores from that table split into bf16 parts (see kernel 1's section).
//
// Out-of-image positions of every intermediate are ZERO (the next conv's
// padding), never ReLU(folded bias); ragged tiles are masked, so any H and W
// divisible by 4 (by 2 for the single stems and the S1 pair) and any B >= 1
// work.
//
// Each launcher returns the cudaError_t of its launch (0 on success).

#include "wgmma.cuh"

namespace {

// --------------- TPU kernels 1 and 2: stem_conv_bn_relu_s2, its training
// --------------- form and its window variant, on warpgroup MMA
//
// Kernel 1 replaces mds_tpu/ops/pallas/stem.py::_stem_fwd (:143-183), both
// its fused deploy case (folded BN, [ReLU], bf16 out) and its unfused case,
// the training form stem_conv3x3_s2 (:1235: unit scale, zero bias, no ReLU,
// f32 out, as _stem_fwd writes f32 when no BN is folded). Kernel 2 replaces
// _stem_fwd_dma (:265-361, body _kernel_dma :186-262): the same function,
// each tile's input window copied by the kernel itself into one of two
// buffers while the other tile computes (the TPU kernel's make_async_copy
// and semaphores; here cp.async.bulk under an mbarrier). Both run the same
// instructions on the same window bytes and agree bit for bit.
//
// Bound: memory. At (1, 1024, 2048) -> 64 the conv reads 12.6 MB and writes
// 67 MB (bf16) for 0.9 GFLOP; at the training shape (16, 512, 1024) -> 64 it
// writes 537 MB (f32). On the CUDA cores the 27 x O FMAs per pixel alone
// take longer than those bytes; on the tensor cores about 1% of the time.
//
// - The GEMM: M = 64 output pixels of one output row (a tile, one
//   warpgroup), N = the output channels padded to 16, 32, 64 or 128, K = 32:
//   for each input row dy the 10 bf16 values that start one element before
//   the pixel's 9 taps (elements 6c - 4 .. 6c + 5 of row 2r - 1 + dy), so
//   every (k, k + 1) pair of an A fragment is one aligned 32-bit word of the
//   window and none straddles two rows. K row dy * 10 (the element before
//   the taps) has weight zero and is masked to zero in A, row 30 is the
//   bias (A = 1), row 31 zero.
// - The f32 folded table keeps its precision as three bf16 parts, hi =
//   bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), whose sum is w
//   exactly (24 bits in 3 x 8). B is two slices of N rows x 128 bytes,
//   [hi | mid] and [lo | 0] (wgmma's K-major layout with the 128-byte
//   swizzle; ops/stem.py pack_stem): the same A registers go against hi
//   (k16 steps 0, 1), mid (2, 3) and lo (4, 5). Products of bf16 values are
//   exact in the f32 accumulator, so the conv is the f32 sum of the exact
//   products of x and the f32 table. (With hi and lo alone the weights err
//   by up to 2^-18, which moved 0.1-0.25% of the bf16 outputs off the plain
//   version's in a CPU trial, against the 0.999 bit-equal gate.) The
//   training form's weight is bf16 already: mid = lo = 0, and its f32 output
//   is the f32 sum of the exact products.
// - wgmma m64nNk16 with A from registers (wgmma.cuh), not mma.sync: A costs
//   the same to build for both (each lane loads its four words per k16 step
//   pair for each of its two pixels straight from the window: eight 32-bit
//   shared loads a tile, no im2col, no ldmatrix), but B stays in shared
//   memory, read by the tensor cores through a descriptor, where mma.sync
//   would hold the table's B fragments in 96-192 registers or reload them
//   for every 16 pixels; and a tile is 6 instructions, not 6 x N / 2.
// - The window: a tile's 3 input rows, each a 16-byte aligned run of global
//   memory that covers elements 6c0 - 4 .. 6c0 + 6 * 64 + 5 (the NHWC row
//   stride is 6W bytes, so the run starts up to 12 bytes before the first
//   wanted element; each lane adds that shift). Kernel 1 copies it in
//   16-byte chunks with cp.async (the next tile's while this one computes),
//   kernel 2 by one cp.async.bulk per row. Only chunks that overlap the
//   image row are copied; the pad row above the image and the pad column
//   left of it are zeroed where A is built. The tensor's size is a multiple
//   of 8 bytes, not always of 16: cp.async reads its last 8 bytes with zero
//   fill, kernel 2's producer with one 8-byte load.
// - The output: a tile's p pixels x O channels are one contiguous range of
//   NHWC memory. The epilogue ([ReLU], then bf16 rounding or f32) writes the
//   accumulators into one of two stage buffers (pixels O + 8 elements apart:
//   no bank conflicts at O = 16, 64, 128), and the warpgroup streams the
//   stage out in coalesced 16-byte stores, which overlap the next tile's
//   window wait and MMAs. Blocks are persistent, as many as fit the SMs.
// Any B >= 1 and even H, W: a ragged tile computes garbage in the A rows of
// its missing pixels and stores none of them.

constexpr int kStemTC = 64;        // output pixels per tile: wgmma's M
constexpr int kStemThreads = 128;  // one warpgroup
// a window row: the wanted 12 * kStemTC + 8 bytes from up to 15 bytes
// before them, in whole 16-byte chunks (800 bytes)
constexpr int kStemRowBytes = (12 * kStemTC + 8 + 15 + 15) / 16 * 16;
constexpr int kStemRowChunks = kStemRowBytes / 16;
constexpr int kStemWinBytes = 3 * kStemRowBytes;

__host__ __device__ constexpr int stem_stage_bytes(int n, bool f32) {
  return kStemTC * (n + 8) * (f32 ? 4 : 2);
}

// 1024 bytes of slack to align the table to the swizzle's 1024-byte
// pattern, the table (two slices), two windows, two stages, three mbarriers
// (the table's and one per window)
__host__ __device__ constexpr size_t stem_smem(int n, bool f32) {
  return 1024 + 2 * n * 128 + 2 * kStemWinBytes + 2 * stem_stage_bytes(n, f32) +
         3 * sizeof(uint64_t);
}

struct StemTile {
  int b, r, c0;  // image, output row, first output column
};

__device__ __forceinline__ StemTile stem_tile(int tile, int tiles_x, int H2) {
  const int t = tile / tiles_x;
  return {t / H2, t % H2, (tile - t * tiles_x) * kStemTC};
}

// Byte offset in x of element 6 * c0 - 4 of input row 2r - 1 + dy: the
// first wanted byte of window row dy (before the image row at its left edge).
__device__ __forceinline__ long long stem_row_start(StemTile t, int dy, int H,
                                                    int W) {
  return (((long long)t.b * H + 2 * t.r - 1 + dy) * W + 2LL * t.c0) * 6 - 8;
}

// Kernel 1: tile t's window into win by cp.async, 16-byte chunks spread over
// the threads; the chunks that hold no byte of the image row are skipped.
// tid: the thread's index among the kStemThreads that copy the window.
__device__ __forceinline__ void stem_window_async(
    unsigned char* win, const unsigned char* __restrict__ xb, long long total,
    StemTile t, int H, int W, int tid) {
  const long long s0 = stem_row_start(t, 0, H, W), row0 = s0 + 8 - 12LL * t.c0;
  for (int i = tid; i < 3 * kStemRowChunks; i += kStemThreads) {
    const int dy = i / kStemRowChunks, q = i - dy * kStemRowChunks;
    if (2 * t.r - 1 + dy < 0) continue;  // the pad row, zeroed in A
    const long long s = s0 + 6LL * W * dy, row = row0 + 6LL * W * dy;
    const long long lo = max(s, row);
    const long long hi = min(s + 12 * kStemTC + 8, row + 6LL * W);
    const long long g = (s & ~15LL) + 16 * q;
    if (g + 16 > lo && g < hi)
      cp_async16(win + dy * kStemRowBytes + 16 * q, xb + g,
                 (int)min(16LL, total - g));
  }
}

// Kernel 2: the same window by the copy engine, one cp.async.bulk per image
// row completing on bar; called by one thread.
__device__ __forceinline__ void stem_window_bulk(
    unsigned char* win, const unsigned char* __restrict__ xb, long long total,
    StemTile t, int H, int W, uint64_t* bar) {
  const long long end16 = total & ~15LL;
  long long src[3];
  uint32_t dst[3], len[3], bytes = 0;
  for (int dy = 0; dy < 3; ++dy) {
    len[dy] = 0;
    if (2 * t.r - 1 + dy < 0) continue;
    const long long s = stem_row_start(t, dy, H, W), row = s + 8 - 12LL * t.c0;
    const long long lo = max(s, row);
    const long long hi = min(s + 12 * kStemTC + 8, row + 6LL * W);
    const long long a = lo & ~15LL, e = min((hi + 15) & ~15LL, end16);
    if (e > a) {
      src[dy] = a;
      dst[dy] = dy * kStemRowBytes + (uint32_t)(a - (s & ~15LL));
      len[dy] = (uint32_t)(e - a);
      bytes += len[dy];
    }
    if (hi > end16)  // the tensor's last 8 bytes: no 16-byte copy may read them
      *reinterpret_cast<uint2*>(win + dy * kStemRowBytes + (end16 - (s & ~15LL))) =
          *reinterpret_cast<const uint2*>(xb + end16);
  }
  mbar_arrive_expect_tx(bar, bytes);
  for (int dy = 0; dy < 3; ++dy)
    if (len[dy]) bulk_g2s(win + dst[dy], xb + src[dy], len[dy], bar);
}

// A's per-lane constants, the same for every tile. The lane holds A
// columns k, k + 1 with k = 2 tq + 8 j (j < 4) for its pixels gq and gq + 8
// of its warp's 16: registers 0 and 1 of k16 step j / 2 for even j, 2 and 3
// for odd j. For each j: the pair's byte offset in the window at the lane's
// first pixel (row dy = k / 10, element e = k % 10; before the row's 16-byte
// shift), the shift's step to row dy in x (6W dy mod 16), and the word's
// mask: element 6c - 4 (e = 0) is no tap; k = 30 is the bias pair (1, 0),
// masked whole and set to bf16 1 in its low half.
struct StemLane {
  int off[4], rsh[4];
  uint32_t keep[4];
};

__device__ __forceinline__ StemLane stem_lane(int W, int row_bytes = kStemRowBytes) {
  const int lane = threadIdx.x & 31, tq = lane & 3;
  const int p = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  StemLane l;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 2 * tq + 8 * j, dy = min(k / 10, 2), e = k - 10 * (k / 10);
    l.off[j] = dy * row_bytes + 2 * e + 12 * p;
    l.rsh[j] = (6 * W * dy) & 15;
    l.keep[j] = k == 30 ? 0u : e == 0 ? 0xffff0000u : 0xffffffffu;
  }
  return l;
}

// Tile t's A fragments (K 0..15 in a[0], 16..31 in a[1]) from window win
// (the threads of one warpgroup, whichever of the block's it is). A tile
// with c0 <= 0 holds the image's left pad column (pixel -c0); pixels left of
// it read bytes outside the row and are the caller's to discard.
__device__ __forceinline__ void stem_tile_a(const unsigned char* win, StemTile t,
                                            const StemLane& l, int H, int W,
                                            uint32_t (&a)[2][4]) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int sh0 = (int)(stem_row_start(t, 0, H, W) & 15);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const unsigned char* w = win + l.off[j] + ((sh0 + l.rsh[j]) & 15);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // pixel gq + 8h: 96 bytes on
      const uint32_t v = *reinterpret_cast<const uint32_t*>(w + 96 * h);
      a[j >> 1][h + 2 * (j & 1)] = (v & l.keep[j]) | (l.keep[j] ? 0u : 0x3F80u);
    }
  }
  if (t.r == 0 || t.c0 <= 0) {  // the conv's padding: the row above the
#pragma unroll                  // image and the column left of it
    for (int j = 0; j < 4; ++j) {
      const int k = 2 * tq + 8 * j, dy = k / 10, e = k - 10 * dy;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (k != 30 && ((t.r == 0 && dy == 0) ||
                        (t.c0 + 16 * warp + gq + 8 * h == 0 && e <= 2)))
          a[j >> 1][h + 2 * (j & 1)] = 0;
    }
  }
}

// Tile t's GEMM from window win against the table at shared address tbl_s
// into acc (the warpgroup's m64nN accumulators), as stem_tile_a says.
template <int N>
__device__ __forceinline__ void stem_tile_acc(const unsigned char* win,
                                              uint32_t tbl_s, StemTile t,
                                              const StemLane& l, int H, int W,
                                              float (&acc)[N / 2]) {
  uint32_t a[2][4];
  stem_tile_a(win, t, l, H, W, a);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    acc[i] = 0.f;
    reg_fence(acc[i]);
  }
  wgmma_fence();
#pragma unroll
  for (int step = 0; step < 6; ++step)  // hi: steps 0, 1; mid: 2, 3; lo: 4, 5
    wgmma_m64nk16<N>(acc, a[step & 1],
                     sw128_desc(tbl_s + step / 4 * N * 128 + 32 * (step % 4)));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) reg_fence(acc[i]);
}

// Tile t's GEMM, then [ReLU] and the rounding, into stage: pixels of O + 8
// elements, f32 or bf16.
template <int N, bool F32>
__device__ __forceinline__ void stem_tile_mma(const unsigned char* win,
                                              uint32_t tbl_s,
                                              unsigned char* stage, StemTile t,
                                              const StemLane& l, int H, int W,
                                              int O, int relu) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[N / 2];
  stem_tile_acc<N>(win, tbl_s, t, l, H, W, acc);

  constexpr int kEs = F32 ? 4 : 2;
  const int ps = (O + 8) * kEs;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (8 * j >= O) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
      unsigned char* d =
          stage + (16 * warp + gq + 8 * h) * ps + (8 * j + 2 * tq) * kEs;
      if constexpr (F32)
        *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(d) = pack2(v0, v1);
    }
  }
}

// Tile t's stage to out: its min(64, W2 - c0) pixels x O channels are one
// contiguous range, written in coalesced 16-byte stores.
template <bool F32>
__device__ __forceinline__ void stem_tile_store(const unsigned char* stage,
                                                unsigned char* __restrict__ out,
                                                StemTile t, int H2, int W2,
                                                int O) {
  constexpr int kEs = F32 ? 4 : 2;
  const int cpp = O * kEs / 16, ps = (O + 8) * kEs;
  const int lg = (cpp & (cpp - 1)) ? -1 : __ffs(cpp) - 1;  // cpp = 2^lg
  const int n = min(kStemTC, W2 - t.c0) * cpp;
  unsigned char* dst =
      out + (((long long)t.b * H2 + t.r) * W2 + t.c0) * O * kEs;
  for (int i = threadIdx.x; i < n; i += kStemThreads) {
    const int p = lg >= 0 ? i >> lg : i / cpp;
    *reinterpret_cast<uint4*>(dst + 16LL * i) =
        *reinterpret_cast<const uint4*>(stage + p * ps + 16 * (i - p * cpp));
  }
}

// BULK: kernel 2 (window by cp.async.bulk), else kernel 1 (by cp.async).
template <int N, bool F32, bool BULK>
__global__ void __launch_bounds__(kStemThreads)
    stem_kernel(const bf16* __restrict__ x, const bf16* __restrict__ table,
                void* __restrict__ out, int B, int H, int W, int O, int relu,
                int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* tbl =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* win = tbl + 2 * N * 128;
  unsigned char* stage = win + 2 * kStemWinBytes;
  constexpr int kStage = stem_stage_bytes(N, F32);
  uint64_t* bar = reinterpret_cast<uint64_t*>(stage + 2 * kStage);
  const int H2 = H / 2, W2 = W / 2, tiles = B * H2 * tiles_x;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const long long total = 6LL * B * H * W;  // bytes of x

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  int tile = blockIdx.x;
  if (threadIdx.x == 0) {  // the table, once per block, by the copy engine
    mbar_arrive_expect_tx(bar, 2 * N * 128);
    bulk_g2s(tbl, table, 2 * N * 128, bar);
    if (BULK && tile < tiles)
      stem_window_bulk(win, xb, total, stem_tile(tile, tiles_x, H2), H, W,
                       bar + 1);
  }
  if (!BULK) {
    if (tile < tiles)
      stem_window_async(win, xb, total, stem_tile(tile, tiles_x, H2), H, W,
                        threadIdx.x);
    cp_async_commit();
  }
  mbar_wait(bar, 0);
  const uint32_t tbl_s = smem_u32(tbl);
  const StemLane lane = stem_lane(W);

  StemTile t = stem_tile(tile, tiles_x, H2);
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int buf = it & 1, next = tile + gridDim.x;
    const StemTile tn = stem_tile(next, tiles_x, H2);
    unsigned char* w_next = win + (buf ^ 1) * kStemWinBytes;
    // the next tile's window into the other buffer, which every thread has
    // read (before the last iteration's barrier); then wait for this one's
    if constexpr (BULK) {
      if (threadIdx.x == 0 && next < tiles)
        stem_window_bulk(w_next, xb, total, tn, H, W, bar + 1 + (buf ^ 1));
      mbar_wait(bar + 1 + buf, (it >> 1) & 1);
    } else {
      if (next < tiles)
        stem_window_async(w_next, xb, total, tn, H, W, threadIdx.x);
      cp_async_commit();  // possibly empty: the wait below stays uniform
      cp_async_wait<1>();
      __syncthreads();
    }
    unsigned char* st = stage + buf * kStage;
    stem_tile_mma<N, F32>(win + buf * kStemWinBytes, tbl_s, st, t, lane, H, W,
                          O, relu);
    __syncthreads();  // the stage is whole, and this window is read
    stem_tile_store<F32>(st, static_cast<unsigned char*>(out), t, H2, W2, O);
    t = tn;
  }
}

template <int N, bool F32, bool BULK>
int stem_launch(const void* x, const void* table, void* out, int B, int H,
                int W, int O, int relu, cudaStream_t stream) {
  auto kern = stem_kernel<N, F32, BULK>;
  constexpr size_t smem = stem_smem(N, F32);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kStemThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W / 2 + kStemTC - 1) / kStemTC;
  const long long tiles = (long long)B * (H / 2) * tiles_x;
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > tiles) blocks = tiles;
  kern<<<(unsigned)blocks, kStemThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(table), out, B, H,
      W, O, relu, tiles_x);
  return (int)cudaGetLastError();
}

// N: O padded to 16, 32, 64 or 128 (ops/stem.py _stem_n)
template <bool F32, bool BULK>
int stem_dispatch(const void* x, const void* table, void* out, int B, int H,
                  int W, int O, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (O <= 0 || O % 8 || O > 128 || B < 1 || H < 2 || W < 2 || H % 2 || W % 2)
    return (int)cudaErrorInvalidValue;
  if (O <= 16) return stem_launch<16, F32, BULK>(x, table, out, B, H, W, O, relu, s);
  if (O <= 32) return stem_launch<32, F32, BULK>(x, table, out, B, H, W, O, relu, s);
  if (O <= 64) return stem_launch<64, F32, BULK>(x, table, out, B, H, W, O, relu, s);
  return stem_launch<128, F32, BULK>(x, table, out, B, H, W, O, relu, s);
}

// ------------------------------------ TPU kernel 4: detail_s1s2_fused
//
// Replaces mds_tpu/ops/pallas/stem.py::detail_s1s2_fused (:582-643, body
// _detail_kernel :458-579). DetailBranch S1_1 (3x3 s2, 3->64) -> S1_2 (3x3,
// 64->64) -> S2_1 (3x3 s2, 64->64), every BN folded, every layer ReLU, bf16
// out at /4. Rounding points follow the TPU kernel: S1_1 in f32 from the f32
// folded weights, rounded to bf16; S1_2 and S2_1 on bf16(k * scale), the f32
// bias added to the f32 sum, ReLU, rounded to bf16. Out-of-image positions
// of S1_1 and S1_2 are the next conv's zero padding, never ReLU(bias).
//
// Bound: arithmetic. At (1, 3, 1024, 2048) the three convs are 50.2 GFLOP
// (38.7 of them in S1_2; 0.051 ms on the bf16 tensor cores) against 29 MB
// moved. Design: persistent blocks, one per SM, each walk a contiguous run
// of row steps down 62-column strips of the /4 output, keeping the last
// three rows of S1_1 and of S1_2 (127 and 125 pixels of 128 bytes, wgmma.cuh's
// 16-byte XOR swizzle) in shared memory as rings: a step (one /4 row q)
// computes two S1_1 rows, two S1_2 rows and one S2_1 row, so only the
// strip's side halo is recomputed (127/124 of S1_1, 125/124 of S1_2) and
// every M tile is whole but for one pixel. A run that starts a strip (or
// moves to the next) first computes three S1_1 rows and one S1_2 row.
// - All three convs on warpgroup MMA, bf16 in, f32 accumulate; two consumer
//   warpgroups, each one 64-pixel M tile of a row.
// - S1_1 is kernel 1 at O = 64 with ReLU (stem_tile_acc: A built from the
//   tile's image window, the f32 table as three bf16 parts, exact), its
//   window copied by cp.async one S1_1 row ahead; its output goes to the
//   ring, not to device memory.
// - S1_2 is an implicit GEMM (M = pixels, N = 64, K = 9 taps x 64) with A
//   from the S1_1 ring by ldmatrix.x4 (the tap's shift in each lane's row
//   address) and B from S1_2's 9 weight slices, resident in shared memory
//   for the whole run (pack_sw128, packed once per parameter version).
// - S2_1 likewise from the S1_2 ring at stride 2, one M tile per step, the
//   two warpgroups each 32 of its output channels (m64n32k16); its 9 slices
//   do not fit beside the rest and stream from L2 through a ring of four
//   slots by cp.async.bulk under full/empty mbarriers (72 KB per step, read
//   by both warpgroups): thread 0 refills a slot with the slice four ahead
//   once both warpgroups are done with it. (A producer warp of its own
//   would make nine warps, three on one SM sub-partition, which caps a
//   thread at 168 registers; the consumers' accumulators and A fragments
//   then spill.)
// A tap's wgmmas are one group; each conv's taps sum into two accumulators
// (dx & 1), added in f32 at the end. On an H100 that raised the share of
// outputs equal to the plain version with f64 sums from 0.9971 to 0.9976 at
// the frame shape (long chains of accumulation on the tensor cores lose
// precision) for 2% of the kernel's time. A tap's A fragments load two taps
// ahead; the loop over dy stays rolled, which keeps the registers below 255
// (three accumulators, or the nine taps unrolled with two, spilled). Rows,
// columns and strips past the image are computed on whatever the buffers
// hold and discarded (masked in the epilogue), so no wgmma is issued under a
// condition. Any B >= 1 and H, W divisible by 4.

constexpr int kHdW = 62;                        // /4 output cols of a strip
constexpr int kHdS1 = 2 * kHdW + 3;             // S1_1 pixels of a strip row
constexpr int kHdS2 = 2 * kHdW + 1;             // S1_2 pixels of a strip row
constexpr int kHdS1Row = kHdS1 * 128, kHdS2Row = kHdS2 * 128;  // bytes
constexpr int kHdSlice = 8192;                  // one tap x 64 K x 64 N
constexpr int kHdTbl = 2 * 64 * 128;            // S1_1's table (pack_stem)
constexpr int kHdSlots = 4;                     // S2_1's weight ring
constexpr int kHdThreads = 256;                 // two warpgroups
// 1024 bytes of slack to align the slices to the swizzle's 1024-byte
// pattern; S1_2's slices, S1_1's table, S2_1's ring, the S1_1 and S1_2
// rings, two windows per warpgroup, the barriers (weights, full and empty
// per slot)
constexpr size_t kHdSmem = 1024 + 9 * kHdSlice + kHdTbl + kHdSlots * kHdSlice +
                           3 * kHdS1Row + 3 * kHdS2Row + 4 * kStemWinBytes +
                           (1 + 2 * kHdSlots) * sizeof(uint64_t);
static_assert(kHdSmem <= 232448, "over the 227 KB a block may opt into");

// A run of row steps of one strip: /4 rows qa .. qb - 1 of the strip whose
// first /4 column is p0, image b, strips `width` /4 columns wide. Steps are
// numbered (b, strip, q), q fastest; a block's steps [s, end) split into such
// runs (kernels 4 and 5).
struct StripRun {
  int b, p0, qa, qb;
};

__device__ __forceinline__ StripRun strip_run(long long s, long long end, int H4,
                                              int strips, int width) {
  const int q = (int)(s % H4);
  const long long bs = s / H4;
  return {(int)(bs / strips), (int)(bs % strips) * width, q,
          (int)min((long long)H4, q + (end - s))};
}

// S2_1's weight ring: slice k of the block's stream (tap k % 9 of a step)
// lives in slot k % kHdSlots.
struct HdRing {
  unsigned char* base;       // slot 0
  uint64_t* full;            // per slot: thread 0's arrival and the bytes
  uint64_t* empty;           // per slot: one arrival per warp
  const unsigned char* src;  // S2_1's 9 packed slices
  uint32_t total;            // slices in the block's stream

  __device__ __forceinline__ void load(uint32_t k) const {
    const uint32_t slot = k % kHdSlots;
    mbar_arrive_expect_tx(full + slot, kHdSlice);
    bulk_g2s(base + slot * kHdSlice, src + (k % 9) * kHdSlice, kHdSlice, full + slot);
  }
  // Slice k is done with in this warp; thread 0 then refills its slot with
  // slice k + kHdSlots once every warp is done with it.
  __device__ __forceinline__ void release(uint32_t k) const {
    const uint32_t slot = k % kHdSlots;
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot);
    if (threadIdx.x == 0 && k + kHdSlots < total) {
      mbar_wait(empty + slot, (k / kHdSlots) & 1);
      load(k + kHdSlots);
    }
  }
};

// A ring slot of row r (r >= -6).
__device__ __forceinline__ int hd_slot(int r) { return (r + 6) % 3; }

// S1_1 row r of image b, M tile `tile` of a strip row of npix pixels (local
// pixels 64 tile .. 64 tile + 63, local pixel 0 at /2 column c1), by this
// warpgroup from window win: ReLU, bf16, into ring row dst; zero outside the
// image (kernels 3 and 4).
__device__ __forceinline__ void hd_s1(const unsigned char* win, uint32_t tbl_s,
                                      unsigned char* dst, int b, int r, int c1,
                                      int npix, int tile, const StemLane& l, int H,
                                      int W) {
  const int warp = (threadIdx.x >> 5) & 3;
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const StemTile t{b, r, c1 + 64 * tile};
  float acc[32];
  stem_tile_acc<64>(win, tbl_s, t, l, H, W, acc);
  const bool row_in = r >= 0 && r < H / 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 16 * warp + gq + 8 * h, loc = 64 * tile + p, c = t.c0 + p;
    if (loc >= npix) continue;
    const bool in = row_in && c >= 0 && c < W / 2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float v0 = in ? fmaxf(acc[4 * j + 2 * h], 0.f) : 0.f;
      const float v1 = in ? fmaxf(acc[4 * j + 2 * h + 1], 0.f) : 0.f;
      *reinterpret_cast<uint32_t*>(dst + swz(loc, j, 128) + tq * 4) = pack2(v0, v1);
    }
  }
}

// The lane's ldmatrix row among the 64 of its warpgroup's M tile, and its
// 8-wide K half.
__device__ __forceinline__ int hd_arow() {
  const int lane = threadIdx.x & 31;
  return 16 * ((threadIdx.x >> 5) & 3) + (lane & 7) + 8 * ((lane >> 3) & 1);
}

// A fragments of one tap (its 4 k16 steps) for the lane's row pixel pix of
// ring row `row` (shared address).
__device__ __forceinline__ void hd_load_a(uint32_t (&a)[4][4], uint32_t row,
                                          int pix) {
  const int ahalf = (threadIdx.x & 31) >> 4;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(a[ks], row + swz(pix, 2 * ks + ahalf, 128));
}

// S1_2's implicit GEMM at ring row r (kernels 3 and 4): into acc[0], the
// sum over the 9 taps of S1_1 rows r - 1 .. r + 1 (ring at s1_s, rows
// row_bytes apart) times the resident slices at w_s, for the M row of this
// lane's ldmatrix row pixel pix (its taps at pix .. pix + 2). Tap (dy, dx)
// sums into acc[dx & 1], the two added in f32 at the end.
__device__ __forceinline__ void s12_acc(uint32_t s1_s, int row_bytes, uint32_t w_s,
                                        int r, int pix, float (&acc)[2][32]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      acc[j][i] = 0.f;
      reg_fence(acc[j][i]);
    }
  uint32_t a[3][4][4];  // tap (dy, dx) in a[dx]
  const uint32_t row0 = s1_s + hd_slot(r - 1) * row_bytes;
  hd_load_a(a[0], row0, pix);
  hd_load_a(a[1], row0, pix + 1);
#pragma unroll 1
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = 3 * dy + dx;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n64k16(acc[dx & 1], a[dx][ks],
                        sw128_desc(w_s + tap * kHdSlice + 32 * ks));
      wgmma_commit();
      wgmma_wait<1>();  // tap - 1 is done: its registers take tap + 2
      if (tap < 7)
        hd_load_a(a[(dx + 2) % 3], s1_s + hd_slot(r - 1 + (tap + 2) / 3) * row_bytes,
                  pix + (dx + 2) % 3);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(acc[j][i]);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[0][i] += acc[1][i];
}

// S1_2 row r of run g: ReLU(b2 + S1_1 rows r - 1 .. r + 1 (ring at s1_s) *
// the resident slices at w_s), bf16, into ring row dst; zero outside the
// image. Warpgroup wg computes local pixels 64 wg .. 64 wg + 63 (/2 column
// 2 p0 - 1 + local; the last tile's pixel 125 reads a clamped one and is
// not stored).
__device__ __forceinline__ void hd_s12(uint32_t s1_s, unsigned char* dst,
                                       uint32_t w_s,
                                       const float* __restrict__ b2,
                                       const StripRun& g, int r, int H2, int W2) {
  const int wg = threadIdx.x >> 7, wiw = (threadIdx.x >> 5) & 3;
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  float acc[2][32];
  s12_acc(s1_s, kHdS1Row, w_s, r, min(64 * wg + hd_arow(), kHdS2 - 1), acc);
  const bool row_in = r >= 0 && r < H2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int loc = 64 * wg + 16 * wiw + gq + 8 * h, c = 2 * g.p0 - 1 + loc;
    if (loc >= kHdS2) continue;
    const bool in = row_in && c >= 0 && c < W2;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * tq;
      const float v0 = in ? fmaxf(acc[0][4 * j + 2 * h] + __ldg(b2 + n), 0.f) : 0.f;
      const float v1 = in ? fmaxf(acc[0][4 * j + 2 * h + 1] + __ldg(b2 + n + 1), 0.f) : 0.f;
      *reinterpret_cast<uint32_t*>(dst + swz(loc, j, 128) + tq * 4) = pack2(v0, v1);
    }
  }
}

// S2_1 row q of run g from the S1_2 ring at s2_s (rows 2q - 1 .. 2q + 1, at
// stride 2) and the next 9 slices of the weight ring (slices n .. n + 8 of
// the block's stream; each is released once this warpgroup's wgmmas on it
// are done): ReLU(b3 + sum), bf16, to out.
// Warpgroup wg computes output channels 32 wg .. 32 wg + 31 of the row's
// 62 pixels (M rows 62, 63 read a clamped pixel and are not stored).
__device__ __forceinline__ void hd_s21(uint32_t s2_s, const HdRing& ring,
                                       uint32_t& n, const float* __restrict__ b3,
                                       bf16* __restrict__ out, const StripRun& g,
                                       int q, int H4, int W4) {
  const int wg = threadIdx.x >> 7, wiw = (threadIdx.x >> 5) & 3;
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int pix = 2 * min(hd_arow(), kHdW - 1);
  float acc[2][16];  // tap (dy, dx) sums into acc[dx & 1]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      acc[j][i] = 0.f;
      reg_fence(acc[j][i]);
    }
  uint32_t a[3][4][4];  // tap (dy, dx) in a[dx]
  const uint32_t ring_s = smem_u32(ring.base);
  const uint32_t row0 = s2_s + hd_slot(2 * q - 1) * kHdS2Row;
  hd_load_a(a[0], row0, pix);
  hd_load_a(a[1], row0, pix + 1);
#pragma unroll 1
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = 3 * dy + dx;
      const uint32_t sl = n + tap, slot = sl % kHdSlots;
      mbar_wait(ring.full + slot, (sl / kHdSlots) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_m64n32k16(acc[dx & 1], a[dx][ks],
                        sw128_desc(ring_s + slot * kHdSlice + wg * 32 * 128 + 32 * ks));
      wgmma_commit();
      wgmma_wait<1>();  // tap - 1 is done: its slot goes back, its registers
      if (tap > 0) ring.release(sl - 1);  // take tap + 2
      if (tap < 7)
        hd_load_a(a[(dx + 2) % 3], s2_s + hd_slot(2 * q - 1 + (tap + 2) / 3) * kHdS2Row,
                  pix + (dx + 2) % 3);
    }
  }
  wgmma_wait<0>();
  ring.release(n + 8);
  n += 9;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 16; ++i) reg_fence(acc[j][i]);
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[0][i] += acc[1][i];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * wiw + gq + 8 * h, p = g.p0 + i;
    if (i >= kHdW || p >= W4) continue;
    bf16* o = out + (((size_t)g.b * H4 + q) * W4 + p) * 64 + 32 * wg;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 8 * j + 2 * tq;
      const float v0 = fmaxf(acc[0][4 * j + 2 * h] + __ldg(b3 + 32 * wg + c), 0.f);
      const float v1 = fmaxf(acc[0][4 * j + 2 * h + 1] + __ldg(b3 + 32 * wg + c + 1), 0.f);
      *reinterpret_cast<uint32_t*>(o + c) = pack2(v0, v1);
    }
  }
}

__global__ void __launch_bounds__(kHdThreads, 1)
    detail_head_kernel(const bf16* __restrict__ x, const bf16* __restrict__ tbl,
                       const bf16* __restrict__ w2p, const float* __restrict__ b2,
                       const bf16* __restrict__ w3p, const float* __restrict__ b3,
                       bf16* __restrict__ out, int B, int H, int W, int strips,
                       int per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* w12 = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* t1 = w12 + 9 * kHdSlice;
  unsigned char* ring = t1 + kHdTbl;
  unsigned char* s1 = ring + kHdSlots * kHdSlice;
  unsigned char* s2 = s1 + 3 * kHdS1Row;
  unsigned char* wins = s2 + 3 * kHdS2Row;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(wins + 4 * kStemWinBytes);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + kHdSlots;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const long long steps = (long long)B * strips * H4;
  const long long s0 = (long long)blockIdx.x * per_block;
  const long long end = min(steps, s0 + per_block);

  const HdRing wring{ring, full, empty, reinterpret_cast<const unsigned char*>(w3p),
                     (uint32_t)(9 * (end - s0))};
  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    for (int i = 0; i < kHdSlots; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kHdThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // S1_2's slices and S1_1's table, once per block;
    mbar_arrive_expect_tx(wbar, 9 * kHdSlice + kHdTbl);  // S2_1's first slices
    const unsigned char* w2 = reinterpret_cast<const unsigned char*>(w2p);
    for (int t = 0; t < 9; ++t)
      bulk_g2s(w12 + t * kHdSlice, w2 + t * kHdSlice, kHdSlice, wbar);
    bulk_g2s(t1, tbl, kHdTbl, wbar);
    for (uint32_t k = 0; k < kHdSlots && k < wring.total; ++k) wring.load(k);
  }

  const int wg = threadIdx.x >> 7;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const long long total = 6LL * B * H * W;  // bytes of x
  const StemLane lane = stem_lane(W);
  unsigned char* win = wins + wg * 2 * kStemWinBytes;
  const uint32_t tbl_s = smem_u32(t1), w12_s = smem_u32(w12);
  const uint32_t s1_s = smem_u32(s1), s2_s = smem_u32(s2);

  // The S1_1 rows in the order this block computes them (runs one after
  // the other; a run's rows 2 qa - 2 .. 2 qb), for the window prefetch.
  long long fs = s0;
  StripRun fg = strip_run(s0, end, H4, strips, kHdW);
  int fr = 2 * fg.qa - 2;
  bool fvalid = true;
  // this warpgroup's window of the prefetch cursor's row into buf, then on
  auto fetch = [&](unsigned char* buf) {
    if (fvalid && fr >= 0 && fr < H2)
      stem_window_async(buf, xb, total, StemTile{fg.b, fr, 2 * fg.p0 - 2 + 64 * wg},
                        H, W, threadIdx.x & 127);
    cp_async_commit();  // possibly empty: the waits stay uniform
    if (fr < 2 * fg.qb) {
      ++fr;
    } else {
      fs += fg.qb - fg.qa;
      fvalid = fs < end;
      if (fvalid) {
        fg = strip_run(fs, end, H4, strips, kHdW);
        fr = 2 * fg.qa - 2;
      }
    }
  };
  int k = 0;  // S1_1 rows computed by this warpgroup: row k's window in buf k & 1
  fetch(win);
  mbar_wait(wbar, 0);
  auto s1_row = [&](const StripRun& g, int r) {
    named_bar_sync(2 + wg, 128);  // buffer (k + 1) & 1 is read
    fetch(win + ((k + 1) & 1) * kStemWinBytes);
    cp_async_wait<1>();
    named_bar_sync(2 + wg, 128);  // row k's window is whole
    hd_s1(win + (k & 1) * kStemWinBytes, tbl_s, s1 + hd_slot(r) * kHdS1Row, g.b, r,
          2 * g.p0 - 2, kHdS1, wg, lane, H, W);
    ++k;
  };

  uint32_t n = 0;  // S2_1 slices consumed
  for (long long s = s0; s < end;) {
    const StripRun g = strip_run(s, end, H4, strips, kHdW);
    for (int r = 2 * g.qa - 2; r <= 2 * g.qa; ++r) s1_row(g, r);
    named_bar_sync(1, kHdThreads);
    hd_s12(s1_s, s2 + hd_slot(2 * g.qa - 1) * kHdS2Row, w12_s, b2, g,
           2 * g.qa - 1, H2, W2);
    named_bar_sync(1, kHdThreads);
    for (int q = g.qa; q < g.qb; ++q) {
      if (q > g.qa) hd_s21(s2_s, wring, n, b3, out, g, q - 1, H4, W4);
      s1_row(g, 2 * q + 1);
      named_bar_sync(1, kHdThreads);
      hd_s12(s1_s, s2 + hd_slot(2 * q) * kHdS2Row, w12_s, b2, g, 2 * q, H2, W2);
      named_bar_sync(1, kHdThreads);
      s1_row(g, 2 * q + 2);
      named_bar_sync(1, kHdThreads);
      hd_s12(s1_s, s2 + hd_slot(2 * q + 1) * kHdS2Row, w12_s, b2, g, 2 * q + 1,
             H2, W2);
      named_bar_sync(1, kHdThreads);
    }
    hd_s21(s2_s, wring, n, b3, out, g, g.qb - 1, H4, W4);
    named_bar_sync(1, kHdThreads);
    s += g.qb - g.qa;
  }
  cp_async_wait<0>();
}

// ------------------------------------ TPU kernel 3: stem_s1_pair_fused
//
// Replaces mds_tpu/ops/pallas/stem.py::stem_s1_pair_fused (:408, body
// _pair_kernel :321): DetailBranch S1_1 (3x3 s2, 3->64) -> S1_2 (3x3,
// 64->64), BNs folded, the second ReLU optional, bf16 out at /2: the first
// two convs of kernel 4, with its rounding points (S1_1 the f32 sum of x and
// the f32 folded table, + bias, ReLU, bf16; S1_2 on bf16(k2 * scale2), + the
// f32 bias, [ReLU], bf16). Out-of-image positions of S1_1 are S1_2's zero
// padding, never ReLU(bias).
//
// Bound: arithmetic. At (1, 3, 1024, 2048) the two convs are 40.5 GFLOP
// (38.7 of them in S1_2; 0.041 ms on the bf16 tensor cores) against 12.6 MB
// read and 67.1 MB written (0.024 ms). Design: kernel 4's rolling rows
// without S2_1, writing S1_2 out. Persistent blocks, one per SM, of two
// warpgroups; each warpgroup walks its own contiguous run of row steps down
// 62-column strips of the /2 output, keeping the last three S1_1 rows of its
// strip (64 pixels of 128 bytes, wgmma.cuh's 16-byte XOR swizzle: one whole
// M tile) in a shared-memory ring of its own: a step (one output row r)
// computes S1_1 row r + 1 and S1_2 row r, so only the strip's two halo
// columns of S1_1 are recomputed (64/62). A run that starts a strip (or
// moves to the next) first computes two S1_1 rows. The warpgroups share
// only the weights and meet at no barrier, so one's S1_1 and epilogue run
// beside the other's S1_2 MMAs.
// - Both convs on warpgroup MMA, bf16 in, f32 accumulate.
// - S1_1 is kernel 1 at O = 64 with ReLU (hd_s1: A built from the tile's
//   image window, the f32 table as three exact bf16 parts), its window
//   copied by cp.async one row ahead.
// - S1_2 is kernel 4's implicit GEMM (s12_acc: A from the ring by ldmatrix,
//   its 9 B slices, 72 KB, resident for the block's life, two accumulators).
// - The epilogue (+ bias, [ReLU] in the rounding cvt, bf16) writes the row
//   by stmatrix into one of the warpgroup's two stages as the NHWC image of
//   its 64 pixels, and the warpgroup's first thread hands the row's min(62,
//   W/2 - c0) pixels to the copy engine in one bulk copy (a bulk group a
//   step; a stage is written again once wait_group.read says its copy two
//   steps back has read it), so the 67 MB of stores stream on under the
//   next steps' MMAs.
// - The weights (pack_s1_pair: S1_1's table, S1_2's slices, its f32 bias)
//   are packed once per parameter version by the caller and copied into
//   shared memory once per block.
// Columns and strips past the image are computed on whatever the buffers
// hold and never copied out, so no wgmma is issued under a condition. Any
// B >= 1 and even H, W.

constexpr int kPrW = 62;               // /2 output cols of a strip
constexpr int kPrS1 = kPrW + 2;        // S1_1 pixels of a strip row: one M tile
constexpr int kPrRow = kPrS1 * 128;    // bytes of an S1_1 ring row, of a stage
constexpr int kPrThreads = 256;        // two warpgroups, each on its own strips
// a warpgroup's ring (three rows), stages (two) and windows (two), in whole
// 128-byte lines
constexpr int kPrWg = 5 * kPrRow + (2 * kStemWinBytes + 127) / 128 * 128;
// 1024 bytes of slack to align the slices to the swizzle's 1024-byte
// pattern; S1_2's slices, S1_1's table, the warpgroups' buffers, the
// weights' mbarrier
constexpr size_t kPrSmem = 1024 + 9 * kHdSlice + kHdTbl + 2 * kPrWg + sizeof(uint64_t);
static_assert(kPrSmem <= 232448, "over the 227 KB a block may opt into");

// S1_2 row r: + b2, [ReLU], bf16, by stmatrix into stage as the NHWC image of
// the warpgroup's 64 strip pixels (pixels 62 and 63 read a clamped one and
// are never copied out).
__device__ __forceinline__ void pr_s12(uint32_t s1_s, uint32_t w_s,
                                       const float* __restrict__ b2,
                                       unsigned char* stage, int r, int relu2) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, tq = lane & 3;
  float acc[2][32];
  s12_acc(s1_s, kPrRow, w_s, r, min(hd_arow(), kPrW - 1), acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // matrix (h, j): pixels 16 warp + 8h .. + 7, channels 8j .. 8j + 7
    const uint32_t row = smem_u32(stage) + (16 * warp + 8 * h + (lane & 7)) * 128;
#pragma unroll
    for (int j4 = 0; j4 < 8; j4 += 4) {
      uint32_t v[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j4 + jj, n = 8 * j + 2 * tq;
        const float v0 = acc[0][4 * j + 2 * h] + __ldg(b2 + n);
        const float v1 = acc[0][4 * j + 2 * h + 1] + __ldg(b2 + n + 1);
        v[jj] = relu2 ? pack2_relu(v0, v1) : pack2(v0, v1);
      }
      stmatrix_x4(row + 16 * (j4 + (lane >> 3)), v);
    }
  }
  fence_proxy_async();
}

// t1: pack_stem of S1_1 (two slices); w2p: pack_sw128 of bf16(k2 * s2) (9
// slices); b2: S1_2's f32 bias. Warpgroup u = 2 blockIdx.x + wg runs steps
// [u per_wg, (u + 1) per_wg) of the B x strips x H/2 (q fastest).
__global__ void __launch_bounds__(kPrThreads, 1)
    pair_kernel(const bf16* __restrict__ x, const bf16* __restrict__ t1,
                const bf16* __restrict__ w2p, const float* __restrict__ b2,
                bf16* __restrict__ out, int B, int H, int W, int relu2, int strips,
                int per_wg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* w12 = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* tb = w12 + 9 * kHdSlice;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(tb + kHdTbl + 2 * kPrWg);
  const int wg = threadIdx.x >> 7, wt = threadIdx.x & 127;
  unsigned char* s1 = tb + kHdTbl + wg * kPrWg;  // this warpgroup's ring,
  unsigned char* stage = s1 + 3 * kPrRow;        // stages
  unsigned char* win = stage + 2 * kPrRow;       // and windows
  const int H2 = H / 2, W2 = W / 2;
  const long long steps = (long long)B * strips * H2;
  const long long s0 = (2LL * blockIdx.x + wg) * per_wg;
  const long long end = min(steps, s0 + per_wg);

  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // S1_2's slices and S1_1's table, once per block
    mbar_arrive_expect_tx(wbar, 9 * kHdSlice + kHdTbl);
    const unsigned char* w2 = reinterpret_cast<const unsigned char*>(w2p);
    for (int t = 0; t < 9; ++t)
      bulk_g2s(w12 + t * kHdSlice, w2 + t * kHdSlice, kHdSlice, wbar);
    bulk_g2s(tb, t1, kHdTbl, wbar);
  }

  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const long long total = 6LL * B * H * W;  // bytes of x
  const StemLane lane = stem_lane(W);
  const uint32_t tbl_s = smem_u32(tb), w12_s = smem_u32(w12), s1_s = smem_u32(s1);

  // The S1_1 rows in the order this warpgroup computes them (runs one after
  // the other; a run's rows qa - 1 .. qb), for the window prefetch.
  long long fs = s0;
  StripRun fg = strip_run(s0, end, H2, strips, kPrW);
  int fr = fg.qa - 1;
  bool fvalid = s0 < end;
  // the window of the prefetch cursor's row into buf, then on
  auto fetch = [&](unsigned char* buf) {
    if (fvalid && fr >= 0 && fr < H2)
      stem_window_async(buf, xb, total, StemTile{fg.b, fr, fg.p0 - 1}, H, W, wt);
    cp_async_commit();  // possibly empty: the waits stay uniform
    if (fr < fg.qb) {
      ++fr;
    } else {
      fs += fg.qb - fg.qa;
      fvalid = fs < end;
      if (fvalid) {
        fg = strip_run(fs, end, H2, strips, kPrW);
        fr = fg.qa - 1;
      }
    }
  };
  int k = 0;  // S1_1 rows computed: row k's window in buf k & 1
  fetch(win);
  mbar_wait(wbar, 0);
  auto s1_row = [&](const StripRun& g, int r) {
    named_bar_sync(2 + wg, 128);  // buffer (k + 1) & 1 is read
    fetch(win + ((k + 1) & 1) * kStemWinBytes);
    cp_async_wait<1>();
    named_bar_sync(2 + wg, 128);  // row k's window is whole
    hd_s1(win + (k & 1) * kStemWinBytes, tbl_s, s1 + hd_slot(r) * kPrRow, g.b, r,
          g.p0 - 1, kPrS1, 0, lane, H, W);
    ++k;
  };

  int n = 0;  // rows stored: row n's stage is n & 1
  for (long long s = s0; s < end;) {
    const StripRun g = strip_run(s, end, H2, strips, kPrW);
    s1_row(g, g.qa - 1);
    s1_row(g, g.qa);
    for (int r = g.qa; r < g.qb; ++r, ++n) {
      s1_row(g, r + 1);
      if (wt == 0) bulk_wait_read<1>();  // the copy of row n - 2 has read it
      named_bar_sync(2 + wg, 128);  // S1_1 rows r - 1 .. r + 1 are whole, and
      unsigned char* st = stage + (n & 1) * kPrRow;  // stage n & 1 is free
      pr_s12(s1_s, w12_s, b2, st, r, relu2);
      named_bar_sync(2 + wg, 128);  // the stage is whole; ring row r - 1 is read
      if (wt == 0) {
        bulk_s2g(out + (((size_t)g.b * H2 + r) * W2 + g.p0) * 64, st,
                 min(kPrW, W2 - g.p0) * 128);
        bulk_commit();
      }
    }
    s += g.qb - g.qa;
  }
  if (wt == 0) bulk_wait<0>();
  cp_async_wait<0>();
}

// --------------------------------------- TPU kernel 5: stemblock_fused
//
// Replaces mds_tpu/ops/pallas/stem.py::stemblock_fused (:775, body
// _stemblock_kernel :646-771). The whole StemBlock: stem 3x3 s2 3->16 ->
// {left_1 1x1 16->8 -> left_2 3x3 s2 8->16 || maxpool 3x3 s2} -> concat 32
// -> fuse 3x3 32->16, BN folded, ReLU each, bf16 out at /4. Rounding points
// are the TPU kernel's: the stem is the f32 sum of bf16 x and the f32 folded
// table (+ bias, ReLU); left_1 sums bf16(stem) x bf16(k * scale) in f32
// (+ bias, ReLU) and rounds to bf16; left_2 likewise on bf16(left_1); the
// maxpool of the stem rounded to bf16 (rounding commutes with max, so it is
// taken over bf16(stem)); the fuse on [left_2 | maxpool]. The stem is >= 0,
// so the maxpool's zero padding is exact.
//
// Bound: memory, 12.6 MB read and 4.2 MB written at (1, 3, 1024, 2048) (5
// us), against 2.1 GFLOP (2 us on the bf16 tensor cores, 31 us in f32 FMA).
// Design: every stage with K >= 16 on warpgroup MMA (m64n16k16), bf16 in,
// f32 accumulate, one warpgroup per block, persistent blocks (three an SM),
// each walking a contiguous run of row steps down 61-column strips of the
// /4 output (kernel 4's scheme). A step (one /4 row) computes two stem rows
// (127 pixels: two M tiles each), one concat row (63 pixels) and one fuse
// row (61 pixels): every M tile whole but for one to three pixels, and only
// the strip's side halo recomputed. The rows live in shared memory rings:
// three stem rows (bf16, 16 channels), three left_1 rows (8, even columns
// then odd, so that left_2's stride-2 ldmatrix rows are contiguous), three
// concat rows (32, the 16-byte chunks XOR-swizzled by pixel for ldmatrix).
// A run starts with three steps that fill the rings (stem rows from 2 qa - 4,
// concat rows from qa - 1).
// - The stem: kernel 1's A build against its exact three-part table
//   (pack_stem, N = 16), six k16 steps a tile, the four tiles of a step in
//   one group, from the step's window: the five input rows of its two stem
//   rows across both M tiles, copied by cp.async one step ahead.
// - left_1 straight from the stem's accumulators: ReLU, bf16, and the m64n16
//   D fragment is the A fragment of the next k16 (N = 16, the upper 8
//   columns of B zero).
// - The maxpool on the CUDA cores: bf16x2 max over the stem ring, 16 bytes
//   a load (the ring's pixels swapped in pairs against bank conflicts).
// - left_2: K = 9 taps x 8 = 72, padded to 80, A by ldmatrix from the left_1
//   ring at stride 2; the fuse: K = 9 x 32 = 288, 18 k16 steps, A by
//   ldmatrix from the concat ring, two accumulators (alternate k16 steps).
// - Every B (pack_stemblock: the stem's table, left_1, left_2 and the fuse,
//   20 KB in the 128-byte swizzle, packed once per parameter version) stays
//   in shared memory for the block's life, one bulk copy.
// Out-of-image positions of the stem, left_1 and concat rows are zero (the
// next layers' padding, never ReLU(bias)); pixels and rows past the image
// compute on whatever the buffers hold and are discarded, so no wgmma is
// issued under a condition. Any B >= 1 and H, W divisible by 4.

constexpr int kSbP = 61;                      // /4 output cols of a strip
constexpr int kSbC = kSbP + 2;                // concat pixels of a strip row
constexpr int kSbThreads = 128;               // one warpgroup
constexpr int kSbMaxPerSm = 3;                // blocks an SM
constexpr int kSbSlice = 16 * 128;            // one B slice: 16 rows x 64 K
// the packed weights (pack_stemblock), bf16: the stem's table (two slices),
// left_1 (one), left_2 (two), the fuse (five)
constexpr int kSbL1 = 2 * kSbSlice, kSbL2 = 3 * kSbSlice, kSbF = 5 * kSbSlice;
constexpr int kSbWBytes = 10 * kSbSlice;
constexpr int kSbStemRow = 128 * 32;          // 128 pixels x 16 channels
constexpr int kSbL1Odd = 68;                  // left_1 ring: odd columns' entry
constexpr int kSbL1Row = (kSbL1Odd + 64) * 16;  //   (a 16-byte pixel each)
constexpr int kSbCatRow = 64 * 64;            // 64 pixels x 32 channels
// a step's window: input rows 4u - 1 .. 4u + 3, each the wanted 12 * 128 + 8
// bytes of the strip's two M tiles from up to 15 bytes before them, in
// whole 16-byte chunks (1568 bytes)
constexpr int kSbWinRow = (12 * 2 * kStemTC + 8 + 15 + 15) / 16 * 16;
constexpr int kSbWinChunks = kSbWinRow / 16;
constexpr int kSbWins = 5 * kSbWinRow;
// 1024 bytes of slack to align B to the swizzle's 1024-byte pattern, B, two
// steps' windows, the three rings, the mbarrier of B's copy
constexpr size_t kSbSmem = 1024 + kSbWBytes + 2 * kSbWins + 3 * kSbStemRow +
                           3 * kSbL1Row + 3 * kSbCatRow + sizeof(uint64_t);

// The max of two bf16 pairs, element by element.
__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Ring slots of stem row r (r >= -6) and concat row m (m >= -3).
__device__ __forceinline__ int sb_slot(int r) { return (r + 6) % 3; }

// The stem ring pixel of strip stem pixel ls: pixels swapped in pairs where
// bit 2 of ls is set, so that the maxpool's 16-byte loads (eight lanes:
// four pixels 2 apart, two halves) fall in eight distinct bank groups.
__device__ __forceinline__ int sb_stem_px(int ls) { return ls ^ ((ls >> 2) & 1); }

// The left_1 ring entry of strip stem pixel ls (even columns, then odd).
__device__ __forceinline__ int sb_l1_entry(int ls) {
  return (ls & 1) * kSbL1Odd + (ls >> 1);
}

// Byte offset of 16-byte chunk c (0-3) of concat pixel lp in its ring row.
__device__ __forceinline__ int sb_cat(int lp, int c) {
  return lp * 64 + ((c ^ ((lp >> 1) & 3)) << 4);
}

// Step u's window (input rows 4u - 1 .. 4u + 3 of image b, from the byte
// before the taps of /2 column c0) into win by cp.async, chunk q of each
// row by thread q; only chunks that overlap the image row are copied. Rows
// and columns outside the image are masked or discarded where A is built
// (stem_tile_a) and the rows stored.
__device__ __forceinline__ void sb_window(unsigned char* win,
                                          const unsigned char* __restrict__ xb,
                                          long long total, int b, int u, int c0,
                                          int H, int W) {
  static_assert(kSbWinChunks <= kSbThreads, "a chunk of each row per thread");
  const int q = threadIdx.x;
  if (q >= kSbWinChunks) return;
#pragma unroll 1
  for (int dy = 0; dy < 5; ++dy) {
    const int y = 4 * u - 1 + dy;
    if (y < 0 || y >= H) continue;
    const long long row = ((long long)b * H + y) * W * 6, s = row + 12LL * c0 - 8;
    const long long lo = max(s, row);
    const long long hi = min(s + 12 * 2 * kStemTC + 8, row + 6LL * W);
    const long long g = (s & ~15LL) + 16 * q;
    if (g + 16 > lo && g < hi)
      cp_async16(win + dy * kSbWinRow + 16 * q, xb + g, (int)min(16LL, total - g));
  }
}

// Stem rows 2u, 2u + 1 of run g from the step's window (tile i: row 2u + i /
// 2, window rows 2 (i / 2) .., strip stem pixels 64 (i % 2) .. + 63 at /2
// column 2 p0 - 3 + pixel): the stem, ReLU, and left_1 on its bf16, + bias,
// ReLU; both bf16 into their ring rows, zero outside the image. l: the
// lanes' offsets for window rows kSbWinRow bytes apart.
__device__ __forceinline__ void sb_stem_rows(const unsigned char* win, uint32_t w_s,
                                             unsigned char* stem, unsigned char* l1,
                                             const float* __restrict__ bias,
                                             const StripRun& g, int u,
                                             const StemLane& l, int H, int W) {
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  uint32_t a[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    stem_tile_a(win + (i >> 1) * 2 * kSbWinRow + (i & 1) * 12 * kStemTC,
                StemTile{g.b, 2 * u + (i >> 1), 2 * g.p0 - 3 + 64 * (i & 1)}, l, H, W,
                a[i]);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[i][e] = 0.f;
      reg_fence(acc[i][e]);
    }
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int step = 0; step < 6; ++step)  // hi: steps 0, 1; mid: 2, 3; lo: 4, 5
      wgmma_m64n16k16(acc[i], a[i][step & 1],
                      sw128_desc(w_s + step / 4 * kSbSlice + 32 * (step % 4)));
  wgmma_commit();
  wgmma_wait<0>();
  // left_1: the D fragment of ReLU(stem), as bf16, is left_1's A fragment
  uint32_t a1[4][4];
  float acc1[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      reg_fence(acc[i][e]);
      acc[i][e] = fmaxf(acc[i][e], 0.f);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) a1[i][r] = pack2(acc[i][2 * r], acc[i][2 * r + 1]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc1[i][e] = 0.f;
      reg_fence(acc1[i][e]);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < 4; ++i) wgmma_m64n16k16(acc1[i], a1[i], sw128_desc(w_s + kSbL1));
  wgmma_commit();
  wgmma_wait<0>();
  const float b0 = __ldg(bias + 2 * tq), b1 = __ldg(bias + 2 * tq + 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * u + (i >> 1);
    unsigned char* srow = stem + sb_slot(r) * kSbStemRow;
    unsigned char* lrow = l1 + sb_slot(r) * kSbL1Row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ls = 64 * (i & 1) + 16 * warp + gq + 8 * h, c = 2 * g.p0 - 3 + ls;
      const bool in = r >= 0 && r < H / 2 && c >= 0 && c < W / 2;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<uint32_t*>(srow + sb_stem_px(ls) * 32 + 16 * j + 4 * tq) =
            in ? a1[i][2 * j + h] : 0u;
      reg_fence(acc1[i][2 * h]);
      reg_fence(acc1[i][2 * h + 1]);
      const float v0 = in ? fmaxf(acc1[i][2 * h] + b0, 0.f) : 0.f;
      const float v1 = in ? fmaxf(acc1[i][2 * h + 1] + b1, 0.f) : 0.f;
      *reinterpret_cast<uint32_t*>(lrow + sb_l1_entry(ls) * 16 + 4 * tq) = pack2(v0, v1);
    }
  }
}

// Concat row u of run g (strip pixels lp = 0 .. 62 at /4 column p0 - 1 +
// lp): channels 0-15 left_2 on left_1 rows 2u - 1 .. 2u + 1 (+ bias, ReLU),
// 16-31 the maxpool of the stem rows, bf16 into its ring row, zero outside
// the image.
__device__ __forceinline__ void sb_concat(const unsigned char* stem, uint32_t l1_s,
                                          unsigned char* cat, uint32_t w_s,
                                          const float* __restrict__ bias,
                                          const StripRun& g, int u, int H4, int W4) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  unsigned char* crow = cat + sb_slot(u) * kSbCatRow;
  // left_2's A: k16 step s holds taps 2s (K 0-7) and 2s + 1 (8-15); tap 9
  // is zero
  const int lp = hd_arow(), ahalf = lane >> 4;
  uint32_t a[5][4];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int tap = min(2 * s + ahalf, 8), dy = tap / 3, dx = tap % 3;
    ldmatrix_x4(a[s], l1_s + sb_slot(2 * u - 1 + dy) * kSbL1Row +
                          sb_l1_entry(2 * lp + dx) * 16);
  }
  a[4][2] = a[4][3] = 0u;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc[e] = 0.f;
    reg_fence(acc[e]);
  }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 5; ++s)
    wgmma_m64n16k16(acc, a[s], sw128_desc(w_s + kSbL2 + s / 4 * kSbSlice + 32 * (s % 4)));
  wgmma_commit();
  // the maxpool meanwhile: thread t < 126 takes channels 8 (t & 1) .. + 7 of
  // pixel t / 2, its taps at strip stem pixels 2 lp .. 2 lp + 2
  const bool row_in = u >= 0 && u < H4;
  if (threadIdx.x < 2 * kSbC) {
    const int mp = threadIdx.x >> 1, half = threadIdx.x & 1, p = g.p0 - 1 + mp;
    uint32_t m[4];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const unsigned char* srow = stem + sb_slot(2 * u - 1 + dy) * kSbStemRow;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            srow + sb_stem_px(2 * mp + dx) * 32 + 16 * half);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) m[k] = dy == 0 && dx == 0 ? w[k] : bmax2(m[k], w[k]);
      }
    }
    const bool in = row_in && p >= 0 && p < W4;
    *reinterpret_cast<uint4*>(crow + sb_cat(mp, 2 + half)) =
        in ? make_uint4(m[0], m[1], m[2], m[3]) : make_uint4(0, 0, 0, 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < 8; ++e) reg_fence(acc[e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lo = 16 * warp + gq + 8 * h, p = g.p0 - 1 + lo;
    if (lo >= kSbC) continue;
    const bool in = row_in && p >= 0 && p < W4;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 8 * j + 2 * tq;
      const float v0 = in ? fmaxf(acc[4 * j + 2 * h] + __ldg(bias + 8 + n), 0.f) : 0.f;
      const float v1 =
          in ? fmaxf(acc[4 * j + 2 * h + 1] + __ldg(bias + 8 + n + 1), 0.f) : 0.f;
      *reinterpret_cast<uint32_t*>(crow + sb_cat(lo, j) + 4 * tq) = pack2(v0, v1);
    }
  }
}

// Fuse row q of run g (strip pixels 0 .. 60 at /4 column p0 + pixel) from
// concat rows q - 1 .. q + 1: + bias, ReLU, bf16, to out.
__device__ __forceinline__ void sb_fuse(uint32_t cat_s, uint32_t w_s,
                                        const float* __restrict__ bias,
                                        bf16* __restrict__ out, const StripRun& g,
                                        int q, int H4, int W4) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int lp0 = min(hd_arow(), kSbP - 1), ahalf = lane >> 4;
  // k16 step s: tap s / 2, channels 16 (s % 2) .. + 15
  uint32_t a[18][4];
#pragma unroll
  for (int s = 0; s < 18; ++s) {
    const int tap = s >> 1, dy = tap / 3, dx = tap % 3, lp = lp0 + dx;
    ldmatrix_x4(a[s], cat_s + sb_slot(q - 1 + dy) * kSbCatRow +
                          sb_cat(lp, 2 * (s & 1) + ahalf));
  }
  float acc[2][8];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[k][e] = 0.f;
      reg_fence(acc[k][e]);
    }
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 18; ++s)
    wgmma_m64n16k16(acc[s & 1], a[s],
                    sw128_desc(w_s + kSbF + s / 4 * kSbSlice + 32 * (s % 4)));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) reg_fence(acc[k][e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = 16 * warp + gq + 8 * h, p = g.p0 + i;
    if (i >= kSbP || p >= W4) continue;
    bf16* o = out + (((size_t)g.b * H4 + q) * W4 + p) * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = 8 * j + 2 * tq;
      const float v0 = fmaxf(acc[0][4 * j + 2 * h] + acc[1][4 * j + 2 * h] +
                                 __ldg(bias + 24 + n), 0.f);
      const float v1 = fmaxf(acc[0][4 * j + 2 * h + 1] + acc[1][4 * j + 2 * h + 1] +
                                 __ldg(bias + 24 + n + 1), 0.f);
      *reinterpret_cast<uint32_t*>(o + n) = pack2(v0, v1);
    }
  }
}

// w: pack_stemblock's 10 slices; bias: f32 left_1 (8), left_2 (16), fuse (16).
__global__ void __launch_bounds__(kSbThreads, kSbMaxPerSm)
    stemblock_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                     const float* __restrict__ bias, bf16* __restrict__ out, int B,
                     int H, int W, int strips, int per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* wts = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* wins = wts + kSbWBytes;
  unsigned char* stem = wins + 2 * kSbWins;
  unsigned char* l1 = stem + 3 * kSbStemRow;
  unsigned char* cat = l1 + 3 * kSbL1Row;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(cat + 3 * kSbCatRow);
  const int H4 = H / 4, W4 = W / 4;
  const long long steps = (long long)B * strips * H4;
  const long long s0 = (long long)blockIdx.x * per_block;
  const long long end = min(steps, s0 + per_block);

  if (threadIdx.x == 0) {
    mbar_init(wbar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // every B, once per block, by the copy engine
    mbar_arrive_expect_tx(wbar, kSbWBytes);
    bulk_g2s(wts, w, kSbWBytes, wbar);
  }

  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const long long total = 6LL * B * H * W;  // bytes of x
  const StemLane lane = stem_lane(W, kSbWinRow);
  const uint32_t w_s = smem_u32(wts), l1_s = smem_u32(l1), cat_s = smem_u32(cat);

  // The steps in the order this block runs them (runs one after the other;
  // a run's steps u = qa - 2 .. qb, stem rows 2u, 2u + 1), for the window
  // prefetch.
  long long fs = s0;
  StripRun fg = strip_run(s0, end, H4, strips, kSbP);
  int fu = fg.qa - 2;
  bool fvalid = s0 < end;
  // the window of the prefetch cursor's step into buf, then on
  auto fetch = [&](unsigned char* buf) {
    if (fvalid) sb_window(buf, xb, total, fg.b, fu, 2 * fg.p0 - 3, H, W);
    cp_async_commit();  // possibly empty: the waits stay uniform
    if (fu < fg.qb) {
      ++fu;
    } else {
      fs += fg.qb - fg.qa;
      fvalid = fs < end;
      if (fvalid) {
        fg = strip_run(fs, end, H4, strips, kSbP);
        fu = fg.qa - 2;
      }
    }
  };
  int k = 0;  // steps run: step k's windows in buffer k & 1
  fetch(wins);
  mbar_wait(wbar, 0);
  for (long long s = s0; s < end;) {
    const StripRun g = strip_run(s, end, H4, strips, kSbP);
    for (int u = g.qa - 2; u <= g.qb; ++u, ++k) {
      fetch(wins + ((k + 1) & 1) * kSbWins);  // read in step k - 1
      cp_async_wait<1>();
      __syncthreads();  // step k's windows are whole; step k - 1 is done
      sb_stem_rows(wins + (k & 1) * kSbWins, w_s, stem, l1, bias, g, u, lane, H, W);
      __syncthreads();  // stem and left_1 rows 2u - 1 .. 2u + 1 are whole
      if (u >= g.qa - 1) sb_concat(stem, l1_s, cat, w_s, bias, g, u, H4, W4);
      __syncthreads();  // concat rows u - 2 .. u are whole
      if (u > g.qa) sb_fuse(cat_s, w_s, bias, out, g, u - 1, H4, W4);
    }
    s += g.qb - g.qa;
  }
  cp_async_wait<0>();
}

}  // namespace

// ------------------------------------------------------------ C interface

// table: ops/stem.py pack_stem's two slices of N rows x 128 bytes, N = O
// padded to 16, 32, 64 or 128. f32: the training form's f32 output (else
// bf16).
extern "C" int mds_stem_conv_bn_relu_s2(const void* x, const void* table,
                                        void* out, int B, int H, int W, int O,
                                        int relu, int f32, void* stream) {
  return f32 ? stem_dispatch<true, false>(x, table, out, B, H, W, O, relu, stream)
             : stem_dispatch<false, false>(x, table, out, B, H, W, O, relu, stream);
}

extern "C" int mds_stem_conv_bn_relu_s2_window(const void* x, const void* table,
                                               void* out, int B, int H, int W,
                                               int O, int relu, void* stream) {
  return stem_dispatch<false, true>(x, table, out, B, H, W, O, relu, stream);
}

// t1: pack_stem of S1_1 (O = 64, two slices); w2p: pack_sw128 of bf16(k2 *
// scale2) (9 slices); b2: its f32 bias (ops/stem.py pack_s1_pair).
extern "C" int mds_stem_s1_pair_fused(const void* x, const void* t1,
                                      const void* w2p, const void* b2,
                                      void* out, int B, int H, int W,
                                      int relu2, void* stream) {
  if (B < 1 || H < 2 || W < 2 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kPrSmem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (W / 2 + kPrW - 1) / kPrW;
  const long long steps = (long long)B * strips * (H / 2);
  const long long per_wg = (steps + 2LL * sms - 1) / (2LL * sms);
  if (per_wg >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = ((steps + per_wg - 1) / per_wg + 1) / 2;
  pair_kernel<<<(unsigned)blocks, kPrThreads, kPrSmem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(t1),
      static_cast<const bf16*>(w2p), static_cast<const float*>(b2),
      static_cast<bf16*>(out), B, H, W, relu2, strips, (int)per_wg);
  return (int)cudaGetLastError();
}

// t1: pack_stem of S1_1 (O = 64, two slices); w2p, w3p: pack_sw128 of
// bf16(k * scale) of S1_2 and S2_1 (9 slices each); b2, b3: their f32 biases.
extern "C" int mds_detail_s1s2_fused(const void* x, const void* t1,
                                     const void* w2p, const void* b2,
                                     const void* w3p, const void* b3,
                                     void* out, int B, int H, int W,
                                     void* stream) {
  if (B < 1 || H < 4 || W < 4 || H % 4 || W % 4) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(detail_head_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kHdSmem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (W / 4 + kHdW - 1) / kHdW;
  const long long steps = (long long)B * strips * (H / 4);
  const long long per_block = (steps + sms - 1) / sms;
  if (per_block >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = (steps + per_block - 1) / per_block;
  detail_head_kernel<<<(unsigned)blocks, kHdThreads, kHdSmem,
                       (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(t1),
      static_cast<const bf16*>(w2p), static_cast<const float*>(b2),
      static_cast<const bf16*>(w3p), static_cast<const float*>(b3),
      static_cast<bf16*>(out), B, H, W, strips, (int)per_block);
  return (int)cudaGetLastError();
}

extern "C" int mds_stemblock_fused(const void* x, const void* w, const void* bias,
                                   void* out, int B, int H, int W, void* stream) {
  if (B < 1 || H < 4 || W < 4 || H % 4 || W % 4) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stemblock_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSbSmem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, stemblock_kernel,
                                                        kSbThreads, kSbSmem);
  if (err != cudaSuccess) return (int)err;
  const int strips = (W / 4 + kSbP - 1) / kSbP;
  const long long steps = (long long)B * strips * (H / 4);
  const long long cap = (long long)max(1, min(per_sm, kSbMaxPerSm)) * sms;
  const long long per_block = (steps + cap - 1) / cap;
  if (per_block >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = (steps + per_block - 1) / per_block;
  stemblock_kernel<<<(unsigned)blocks, kSbThreads, kSbSmem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), B, H, W, strips,
      (int)per_block);
  return (int)cudaGetLastError();
}
