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
// memory. Design: persistent blocks, one per SM, walk 8x8 tiles of the /8
// output. A tile stages its input with the halo of all five convs (29 x 29
// pixels at /4) with cp.async, zero-filled outside the image, and keeps
// each stage in one of two shared-memory buffers that swap roles: input (A)
// -> S2_2 (B) -> S2_3 (A) -> S3_1 (B) -> S3_2 (A) -> S3_3 to device memory.
// Pixels are 128 or 256 bytes with wgmma.cuh's 16-byte XOR swizzle (201 KB
// for both buffers). Each stage is an implicit GEMM on warpgroup MMA
// (wgmma.mma_async m64n64k16, bf16 in, f32 accumulate): M = the stage's
// pixels in 64-pixel tiles (the last one partial: its extra rows read a
// clamped pixel and are not stored), N = 64 output channels per pass, K = 9
// taps x the input channels; A comes from the source buffer by ldmatrix.x4
// with the tap's shift in each lane's row address. The five convs' weights
// (864 KB packed, L2-resident) cannot stay in shared memory: a producer warp
// streams them (packed once per model by ops/stem.py pack_detail_tail, as
// 8 KB slices of one tap x 64 K x 64 N in wgmma's swizzled K-major layout)
// by cp.async.bulk under full/empty mbarriers, in the order the two consumer
// warpgroups read them, into two rings of three slots: one slice a slot for
// the S2 stages, outside the buffers; both N halves of a (tap, kc) back to
// back for the S3 stages, one 128-row B operand for m64n128k16, in buffer B
// behind S3_1's output (free once S2_3 has read B). Each warpgroup holds two
// M tiles' accumulators per S2 pass and one M tile of 128 channels per S3
// pass, so a slice feeds up to four 64-pixel tiles. The halo recomputes
// about as many MACs again as the tile's own (2.0x in all; the TPU kernel
// paid 1.6x). tools/tail_stages_torch.py measures the cycles per stage.

#include "wgmma.cuh"

namespace {

constexpr int kT = 8;                  // /8 output tile: kT x kT pixels
constexpr int kIn = 2 * kT + 13;       // input region side at /4 (29)
constexpr int kD = 2 * kT + 11;        // S2_2 region side at /4 (27)
constexpr int kE = 2 * kT + 9;         // S2_3 region side at /4 (25)
constexpr int kF = kT + 4;             // S3_1 region side at /8 (12)
constexpr int kG = kT + 2;             // S3_2 region side at /8 (10)
constexpr int kConsumers = 256;        // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
// M tiles a warpgroup holds per pass, per stage: S2_2, S2_3, S3_1, S3_2, S3_3
// (an S3 pass covers both 64-wide N halves: one m64n128k16 per M tile)
constexpr int kP4 = 2, kP5 = 2, kP6 = 1, kP7 = 1, kP8 = 1;
constexpr int kSlice = 8192;           // bytes of one weight slice
constexpr int kSlots = 3;              // slots per ring (S2 and S3 each)

constexpr int cmax(int a, int b) { return a > b ? a : b; }
// buffer A: the input, S2_3, S3_2; buffer B: S2_2, S3_1 (in bytes)
constexpr int kBufA = cmax(kIn * kIn * 128, cmax(kE * kE * 128, kG * kG * 256));
constexpr int kBufB = cmax(kD * kD * 128, kF * kF * 256);
constexpr int kS31 = kF * kF * 256;    // S3_1's output at the head of B
static_assert(kS31 + 1023 + kSlots * 2 * kSlice <= kBufB,
              "the S3 ring does not fit behind S3_1's output");
// 1024 bytes of slack align the S2 ring to the swizzle's 1024-byte pattern;
// barriers: full and empty per slot of either ring, and B's tail free
constexpr size_t kSmem = 1024 + kSlots * kSlice + kBufA + kBufB +
                         (4 * kSlots + 1) * sizeof(uint64_t);
static_assert(kSmem <= 232448, "over the 227 KB a block may opt into");

// The packed weights, one array of slices [conv][nh][tap][kc] (nh: 64-wide
// N chunk, kc: 64-deep K chunk); biases f32 likewise, in this order.
constexpr int kSl4 = 0, kSl5 = 9, kSl6 = 18, kSl7 = 36, kSl8 = 72;
constexpr int kOffB4 = 0, kOffB5 = 64, kOffB6 = 128, kOffB7 = 256,
              kOffB8 = 384;

// Passes over a stage's M tiles, 2 * p (p per warpgroup) at a time.
__host__ __device__ constexpr int stage_groups(int dst, int p) {
  return ((dst * dst + 63) / 64 + 2 * p - 1) / (2 * p);
}

// A ring of weight slots as the producer and the consumers walk it, each
// with its own copy: the S2 ring's slots hold one slice (8 KB) outside the
// activation buffers, the S3 ring's both N halves of one (tap, kc) back to
// back (16 KB, one 128-row B operand) in buffer B behind S3_1's output.
// `phase` holds each slot's use parity.
struct Ring {
  uint32_t base;    // shared address of slot 0
  uint32_t bytes;   // of a slot
  uint64_t* full;   // per slot: the producer's arrival and the bytes
  uint64_t* empty;  // per slot: one arrival per consumer warp
  int next;
  uint32_t phase;

  __device__ __forceinline__ int take() {
    const int slot = next;
    next = next + 1 == kSlots ? 0 : next + 1;
    return slot;
  }
  __device__ __forceinline__ uint32_t addr(int slot) const {
    return base + slot * bytes;
  }
  __device__ __forceinline__ uint32_t parity(int slot) const {
    return (phase >> slot) & 1;
  }
};

// The producer's side of one stage: every slice the consumers read, in
// their order (pass, tap, kc), each slot taking the stage's nhs N halves.
__device__ __forceinline__ void produce(const unsigned char* conv, int nhs,
                                        int groups, int kcs,
                                        unsigned char* base, Ring& ring) {
  for (int g = 0; g < groups; ++g)
    for (int sl = 0; sl < 9 * kcs; ++sl) {
      const int slot = ring.take();
      mbar_wait(&ring.empty[slot], ring.parity(slot) ^ 1);
      ring.phase ^= 1u << slot;
      mbar_arrive_expect_tx(&ring.full[slot], nhs * kSlice);
      for (int nh = 0; nh < nhs; ++nh)
        bulk_g2s(base + (ring.addr(slot) + nh * kSlice - smem_u32(base)),
                 conv + (size_t)(nh * 9 * kcs + sl) * kSlice, kSlice,
                 &ring.full[slot]);
    }
}

// A fragments of P M tiles for slice sl (tap sl / KC, 64-deep K chunk
// sl % KC), k16 step ks: the lane's row pixel pb[i] shifted by the tap.
template <int kSrc, int KC, int P>
__device__ __forceinline__ void load_a(uint32_t (&a)[P][4], const int (&pb)[P],
                                       uint32_t src_s, int sl, int ks,
                                       int ahalf) {
  const int tap = sl / KC, kc = sl % KC;
  const int off = (tap / 3) * kSrc + tap % 3;
#pragma unroll
  for (int i = 0; i < P; ++i)
    ldmatrix_x4(a[i], src_s + swz(pb[i] + off, 8 * kc + 2 * ks + ahalf, KC * 128));
}

// One conv stage on the consumers: dst pixel (i, j) of a kDst x kDst region
// with origin (r0, c0) in a grid of (Hd, Wd) pixels <- ReLU(bias + conv over
// the src pixels (S*i + dy, S*j + dx)), src a kSrc-wide region of KC * 64
// channels; kN output channels, all of them each pass (m64nNk16, N = kN).
// Out-of-image pixels are written as zero to the shared dst, skipped when
// kOut (the last stage writes gout). Each warpgroup computes P M tiles per
// pass, all of them every time (a tile past the stage reads clamped pixels
// and stores nothing): a wgmma under a condition would serialize them all.
// A k16 step's wgmmas are one group; the next step's A loads while it runs,
// across slice boundaries too; a slot goes back to the producer once its
// last step is done.
template <int kSrc, int KC, int S, int kDst, int kN, int P, bool kOut>
__device__ __forceinline__ void tail_stage(const unsigned char* src,
                                           unsigned char* dst, bf16* gout,
                                           const float* __restrict__ bias,
                                           Ring& ring, int r0, int c0, int Hd,
                                           int Wd) {
  constexpr int kM = kDst * kDst;
  constexpr int kNM = (kM + 63) / 64;
  constexpr int kDstPB = kN * 2;
  constexpr int kSlices = 9 * KC;
  constexpr int kAcc = kN / 2;         // accumulator registers per M tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wiw = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int arow = 16 * wiw + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int ahalf = lane >> 4;
  const uint32_t src_s = smem_u32(src);
  for (int g = 0; g < stage_groups(kDst, P); ++g) {
    int pb[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int mt = g * 2 * P + wg + 2 * i;
      const int mc = min(64 * mt + arow, kM - 1);
      pb[i] = S * (mc / kDst) * kSrc + S * (mc % kDst);
    }
    float acc[P][kAcc];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        acc[i][e] = 0.f;
        reg_fence(acc[i][e]);
      }
    uint32_t a[2][P][4];
    load_a<kSrc, KC, P>(a[0], pb, src_s, 0, 0, ahalf);
#pragma unroll 1
    for (int sl = 0; sl < kSlices; ++sl) {
      const int slot = ring.take();
      const uint32_t slot_s = ring.addr(slot);
      mbar_wait(&ring.full[slot], ring.parity(slot));
      ring.phase ^= 1u << slot;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < P; ++i) {
          if (kN == 128)
            wgmma_m64n128k16(acc[i], a[ks & 1][i], sw128_desc(slot_s + ks * 32));
          else
            wgmma_m64n64k16(acc[i], a[ks & 1][i], sw128_desc(slot_s + ks * 32));
        }
        wgmma_commit();
        if (ks < 3) {
          wgmma_wait<1>();  // the step before is done
        } else {
          wgmma_wait<0>();  // the slot is read: it goes back
          if (lane == 0) mbar_arrive(&ring.empty[slot]);
        }
        if (ks < 3)
          load_a<kSrc, KC, P>(a[(ks + 1) & 1], pb, src_s, sl, ks + 1, ahalf);
        else if (sl + 1 < kSlices)
          load_a<kSrc, KC, P>(a[0], pb, src_s, sl + 1, 0, ahalf);
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int e = 0; e < kAcc; ++e) reg_fence(acc[i][e]);

    float bj[kN / 8][2];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      bj[j][0] = __ldg(bias + 8 * j + 2 * tq);
      bj[j][1] = __ldg(bias + 8 * j + 2 * tq + 1);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int mt = g * 2 * P + wg + 2 * i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 64 * mt + 16 * wiw + gq + 8 * h;
        if (m >= kM) continue;
        const int r = r0 + m / kDst, c = c0 + m % kDst;
        const bool in = r >= 0 && r < Hd && c >= 0 && c < Wd;
        if (kOut && !in) continue;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          float v0 = 0.f, v1 = 0.f;
          if (in) {
            v0 = fmaxf(acc[i][4 * j + 2 * h] + bj[j][0], 0.f);
            v1 = fmaxf(acc[i][4 * j + 2 * h + 1] + bj[j][1], 0.f);
          }
          if (kOut)
            *reinterpret_cast<uint32_t*>(gout + ((size_t)r * Wd + c) * kN +
                                         8 * j + 2 * tq) = pack2(v0, v1);
          else
            *reinterpret_cast<uint32_t*>(dst + swz(m, j, kDstPB) + tq * 4) =
                pack2(v0, v1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    detail_tail_kernel(const bf16* __restrict__ y,
                       const bf16* __restrict__ wp,
                       const float* __restrict__ bp, bf16* __restrict__ out,
                       int B, int H4, int W4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* slots =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* bufA = slots + kSlots * kSlice;
  unsigned char* bufB = bufA + kBufA;
  uint64_t* bars = reinterpret_cast<uint64_t*>(bufB + kBufB);
  Ring r2{smem_u32(slots), kSlice, bars, bars + kSlots, 0, 0};
  Ring r3{(smem_u32(bufB + kS31) + 1023) & ~1023u, 2 * kSlice,
          bars + 2 * kSlots, bars + 3 * kSlots, 0, 0};
  uint64_t* btail = bars + 4 * kSlots;  // B's tail is free, once a tile
  const int H8 = H4 / 2, W8 = W4 / 2;
  const int tiles_x = (W8 + kT - 1) / kT, tiles_y = (H8 + kT - 1) / kT;
  const int tiles = tiles_x * tiles_y * B;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&r2.full[s], 1);
      mbar_init(&r2.empty[s], kConsumers / 32);
      mbar_init(&r3.full[s], 1);
      mbar_init(&r3.empty[s], kConsumers / 32);
    }
    mbar_init(btail, 1);
    mbar_fence_init();
  }
  __syncthreads();  // the last block-wide barrier: the roles split here

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const unsigned char* w = reinterpret_cast<const unsigned char*>(wp);
      uint32_t n = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++n) {
        produce(w + kSl4 * kSlice, 1, stage_groups(kD, kP4), 1, slots, r2);
        produce(w + kSl5 * kSlice, 1, stage_groups(kE, kP5), 1, slots, r2);
        mbar_wait(btail, n & 1);  // S2_3 has read B
        produce(w + kSl6 * kSlice, 2, stage_groups(kF, kP6), 1, slots, r3);
        produce(w + kSl7 * kSlice, 2, stage_groups(kG, kP7), 2, slots, r3);
        produce(w + kSl8 * kSlice, 2, stage_groups(kT, kP8), 2, slots, r3);
      }
    }
    return;
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int tx = tile % tiles_x, ty = (tile / tiles_x) % tiles_y;
    const int b = tile / (tiles_x * tiles_y);
    const int q0 = ty * kT, p0 = tx * kT;  // the tile's origin at /8
    // the input region: /4 rows and cols from 2 * origin - 7
    const bf16* yb = y + (size_t)b * H4 * W4 * 64;
    const int R = 2 * q0 - 7, C = 2 * p0 - 7;
    for (int i = threadIdx.x; i < kIn * kIn * 8; i += kConsumers) {
      const int q = i % 8, pix = i / 8;
      const int r = R + pix / kIn, c = C + pix % kIn;
      const bool ok = r >= 0 && r < H4 && c >= 0 && c < W4;
      const bf16* src = ok ? yb + ((size_t)r * W4 + c) * 64 + q * 8 : yb;
      cp_async16(bufA + swz(pix, q, 128), src, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    named_bar_sync(1, kConsumers);
    // S2_2: input (A) -> B, /4 region from 2 * origin - 6
    tail_stage<kIn, 1, 1, kD, 64, kP4, false>(bufA, bufB, nullptr, bp + kOffB4,
                                              r2, R + 1, C + 1, H4, W4);
    named_bar_sync(1, kConsumers);
    // S2_3: B -> A, from 2 * origin - 5
    tail_stage<kD, 1, 1, kE, 64, kP5, false>(bufB, bufA, nullptr, bp + kOffB5,
                                             r2, R + 2, C + 2, H4, W4);
    named_bar_sync(1, kConsumers);
    if (threadIdx.x == 0) mbar_arrive(btail);  // B's tail may take weights
    // S3_1 (stride 2): A -> B, /8 region from origin - 2
    tail_stage<kE, 1, 2, kF, 128, kP6, false>(bufA, bufB, nullptr, bp + kOffB6,
                                              r3, q0 - 2, p0 - 2, H8, W8);
    named_bar_sync(1, kConsumers);
    // S3_2: B -> A, from origin - 1
    tail_stage<kF, 2, 1, kG, 128, kP7, false>(bufB, bufA, nullptr, bp + kOffB7,
                                              r3, q0 - 1, p0 - 1, H8, W8);
    named_bar_sync(1, kConsumers);
    // S3_3: A -> the output tile
    tail_stage<kG, 2, 1, kT, 128, kP8, true>(
        bufA, nullptr, out + (size_t)b * H8 * W8 * 128, bp + kOffB8, r3, q0,
        p0, H8, W8);
    named_bar_sync(1, kConsumers);  // the next tile's input overwrites A
  }
}

}  // namespace

// ------------------------------------------------------------ C interface

// wp: the five convs' bf16(k * scale) as ops/stem.py pack_detail_tail lays
// them out (slices [conv][nh][tap][kc] of wgmma.cuh's B layout); bp: their
// f32 biases, 64 + 64 + 128 + 128 + 128.
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
      static_cast<const bf16*>(y), static_cast<const bf16*>(wp),
      static_cast<const float*>(bp), static_cast<bf16*>(out), B, H4, W4);
  return (int)cudaGetLastError();
}
