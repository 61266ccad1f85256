// Hopper (sm_90a) fused x s bilinear upsample + argmax over classes, bound
// with ctypes.
//
// Replaces the TPU kernel mds_tpu/ops/pallas/upsample_argmax.py
// upsample_argmax_pallas (:76, its kernel `_kernel` :56): logits (B, h, w, C)
// in memory (a channels_last NCHW tensor), bf16 or f32, to the int32 label
// map (B, h*s, w*s) of the half-pixel bilinear upsample, without writing the
// (B, C, h*s, w*s) class volume anywhere.
//
// Semantics, the TPU kernel's. Along each axis output i reads inputs
// lo = floor(src), lo + 1 (clamped to the edge) with weights 1 - f and f,
// src = (i + 0.5) * n_in / n_out - 0.5, f = src - lo, computed in f64 as
// interp_matrix (:33-46) does (two clamped taps on one input add up), then
// rounded to f32 and to the logits' type (JAX casts its interpolation
// matrices to it). Per class, the vertical pass
// t = wlo*L[lo] + whi*L[hi] runs in f32 and is rounded to the logits' type;
// the horizontal pass o = wlo*t[lo] + whi*t[hi] runs in f32; a running
// argmax over the classes takes a class only if strictly greater, so the
// earliest class wins a tie. The kernel equals the plain version in
// mds_tpu_torch/ops/upsample_argmax.py bit for bit, bf16 and f32.
//
// Bound: at BiSeNetV2's tail, (1, 19, 128, 256) bf16 -> (1, 1024, 2048)
// int32, the logits are 1.2 MB read once and the labels 8.4 MB written once:
// 2.9 us at 3.35 TB/s. The f32 work is about 6 instructions per output pixel
// per class (two for a lerp, three for the compare and the two selects, a
// share of the vertical pass), ~250 M lane-instructions at the tail: the
// kernel is bound by its instruction issue (~8 us on 132 SMs) before it is
// bound by its bytes.
//
// Design: work by input cell. With the integer factor s, the outputs along
// an axis come in runs of s that share one (lo, hi) pair: run j (lo = j)
// covers outputs s*j + o .. s*j + o + s - 1, o = s / 2, for j = -1 .. n_in - 1.
// Runs 0 .. n_in - 2 are interior (two taps); run -1 and run n_in - 1 are the
// edge runs, whose clamped taps fall on one input (only their outputs inside
// the image exist). The weights depend only on a run's kind (left edge,
// interior, right edge) and the phase p of the output within it: each block
// computes that table of 3 x s weight pairs per axis once, in f64 as
// interp_matrix does from the first run of each kind (runs of one kind round
// to the same f32 weights; ops/upsample_argmax.py phase_taps describes the
// table and tests/test_torch_upsample_argmax.py holds it to interp_matrix).
// - A thread owns one x run (s columns; KP of them where s is not 8) x 2 rows
//   of one y run: every pixel it computes lies in one input cell. Per class
//   it reads the cell's four corners once, computes 2 x 2 vertical values
//   (rounded to T) and 2 x s horizontal ones, and keeps the best value and
//   class of each pixel in registers across all classes: one pass, no chunk
//   loop and no barrier inside it (the classes are staged in chunks only
//   where C exceeds 184 at s = 8).
// - A block is 32 x runs x 4 row pairs of one y run (at s = 8); it stages
//   the span of the two input rows its cells read (a channels_last row is one
//   contiguous run of w * C values, read in 16-byte loads, a thread's two
//   loads in flight together) into shared memory as f32, class-major so
//   that neighbouring threads read neighbouring words, 5 KB at the tail.
//   1161 blocks of 128 threads at the tail, six an SM, so that one block's
//   staging runs beside the others' compute.
// - With bf16 logits the weights are bf16 values and every product of a
//   value and a weight is exact in f32, so __fmaf_rn(a, b, c * d) rounds once
//   where (a * b) + (c * d) rounds once too: the same bits, one instruction
//   fewer per lerp. With f32 logits the products are not exact and the lerp
//   keeps its three rounded operations (__fmul_rn / __fadd_rn: nvcc would
//   otherwise contract them into an FMA).
// - Stores: at s = 8 an interior run starts at column 8j + 4, 16-byte
//   aligned, so a thread's 8 labels of a row are two 16-byte stores and a
//   warp writes 1 KB of a row; edge runs and other s store masked words.
// JAX's NCHW transpose and MXU matmuls are TPU workarounds with no
// counterpart here. Any B, h, w, C >= 1 and s >= 1.
//
// The launcher returns the cudaError_t of its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kUaXT = 32;      // x units (runs, or KP-wide parts of runs) a block
constexpr int kUaYT = 4;       // row pairs a block at once
constexpr int kUaRows = 2;     // output rows a thread
constexpr int kUaPhases = 8;   // x phases a thread where s is not 8
constexpr int kUaThreads = kUaXT * kUaYT;
constexpr int kUaCols = kUaXT + 1;  // staged input columns: the block's runs + 1
constexpr int kUaSmem = 48 * 1024;  // a block's shared memory unless one class needs more
// Blocks an SM at s = 8: six hold 80 registers a thread without a spill, and
// their staging overlaps more of the others' compute than at four (122
// registers); the generic path (96 registers) spills at six.
constexpr int kUaBlocksPerSm = 6;

__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// wlo * a + whi * b in f32, rounded as the plain version rounds it: with bf16
// weights and values every product is exact (see the header).
__device__ __forceinline__ float lerp2(float wlo, float a, float whi, float b, bf16*) {
  return __fmaf_rn(wlo, a, __fmul_rn(whi, b));
}
__device__ __forceinline__ float lerp2(float wlo, float a, float whi, float b, float*) {
  return __fadd_rn(__fmul_rn(wlo, a), __fmul_rn(whi, b));
}

// The (w_lo, w_hi) of output i along an axis of n_in inputs and n_out
// outputs, as interp_matrix builds row i (f64, clamped taps summed), rounded
// to f32 and then to T; where both taps clamp to one input, its weight is
// the sum and w_hi is 0.
template <typename T>
__device__ float2 interp_weights(int i, int n_in, int n_out) {
  const double src = __dadd_rn(
      __ddiv_rn(__dmul_rn((double)i + 0.5, (double)n_in), (double)n_out), -0.5);
  const double fl = floor(src);
  const double f = __dadd_rn(src, -fl);
  const int l = (int)fl;
  const int lo = min(max(l, 0), n_in - 1), hi = min(max(l + 1, 0), n_in - 1);
  const double a = __dadd_rn(1.0, -f);
  T* tag = nullptr;
  if (lo == hi) return make_float2(round_to(__double2float_rn(__dadd_rn(a, f)), tag), 0.f);
  return make_float2(round_to(__double2float_rn(a), tag),
                     round_to(__double2float_rn(f), tag));
}

// Classes [c0, c0 + nc) of input rows ylo and yhi, columns [col0, col0 +
// ncol), of image b into stage[row][class - c0][column - col0] as f32 (a
// class's row kUaCols floats, chunk stride cc classes), read in 16-byte loads
// spread over the block, two of a thread's loads in flight before their
// values go to shared memory. The logits start 16-byte aligned; a load past
// the tensor's end reads its elements one by one.
template <typename T>
__device__ __forceinline__ void ua_stage(const T* __restrict__ logits, float* stage,
                                         long long n_el, int b, int ylo, int yhi, int h,
                                         int w, int C, int col0, int ncol, int c0, int nc,
                                         int cc) {
  constexpr int kE = 16 / sizeof(T);  // elements a load
  long long e0[2], a0[2];  // each row's first element and first load
  int nl[2];               // each row's loads
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    e0[rr] = (((long long)b * h + (rr ? yhi : ylo)) * w + col0) * C;
    a0[rr] = e0[rr] & ~(long long)(kE - 1);
    nl[rr] = (int)((e0[rr] + (long long)ncol * C - a0[rr] + kE - 1) / kE);
  }
  const int total = nl[0] + nl[1];
  for (int i0 = threadIdx.x; i0 < total; i0 += 2 * kUaThreads) {
    uint32_t u[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = i0 + m * kUaThreads, rr = i >= nl[0];
      const long long a = a0[rr] + (long long)(i - rr * nl[0]) * kE;
      if (i >= total) break;
      if (a + kE <= n_el) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(logits + a));
        u[m][0] = q.x, u[m][1] = q.y, u[m][2] = q.z, u[m][3] = q.w;
      } else {
        const unsigned char* p = reinterpret_cast<const unsigned char*>(logits + a);
        unsigned char bytes[16];
        for (int k = 0; k < 16; ++k)
          bytes[k] = a + k / (int)sizeof(T) < n_el ? p[k] : 0;
        for (int k = 0; k < 4; ++k)
          u[m][k] = bytes[4 * k] | bytes[4 * k + 1] << 8 | bytes[4 * k + 2] << 16 |
                    (uint32_t)bytes[4 * k + 3] << 24;
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int i = i0 + m * kUaThreads, rr = i >= nl[0];
      if (i >= total) break;
      // (column, class) of the load's first element, then element by element
      const int d = (int)(a0[rr] - e0[rr]) + (i - rr * nl[0]) * kE;
      int col = d >= 0 ? d / C : -((-d + C - 1) / C);
      int c = d - col * C;
      float* dst = stage + rr * cc * kUaCols;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        float v;
        if constexpr (sizeof(T) == 2)
          v = __uint_as_float(e & 1 ? u[m][e / 2] & 0xffff0000u : u[m][e / 2] << 16);
        else
          v = __uint_as_float(u[m][e]);
        if (col >= 0 && col < ncol && c >= c0 && c < c0 + nc)
          dst[(c - c0) * kUaCols + col] = v;
        if (++c == C) c = 0, ++col;
      }
    }
  }
}

// One class of the thread's 2 x KP pixels: the cell's corners (r0: row lo,
// r1: row hi, at columns cxl, cxh), two vertical values per row, KP
// horizontal ones per row, the running argmax (kFirst: class 0 sets it).
template <bool kFirst, int KP, typename T>
__device__ __forceinline__ void ua_class(const float* r0, const float* r1, int cxl,
                                         int cxh, const float (&wy)[kUaRows][2],
                                         const float (&wx)[KP][2], int c,
                                         float (&best)[kUaRows][KP],
                                         int (&arg)[kUaRows][KP]) {
  T* tag = nullptr;
  const float a0 = r0[cxl], a1 = r0[cxh], b0 = r1[cxl], b1 = r1[cxh];
#pragma unroll
  for (int r = 0; r < kUaRows; ++r) {
    const float tl = round_to(lerp2(wy[r][0], a0, wy[r][1], b0, tag), tag);
    const float th = round_to(lerp2(wy[r][0], a1, wy[r][1], b1, tag), tag);
#pragma unroll
    for (int p = 0; p < KP; ++p) {
      const float v = lerp2(wx[p][0], tl, wx[p][1], th, tag);
      if (kFirst || v > best[r][p]) {  // strict: the earliest class wins a tie
        best[r][p] = v;
        arg[r][p] = c;
      }
    }
  }
}

// S: the factor where fixed at compile time (8, BiSeNetV2's pred), else 0.
// cc: classes staged at once (C unless shared memory holds fewer).
template <typename T, int S>
__global__ void __launch_bounds__(kUaThreads, S ? kUaBlocksPerSm : 4)
    upsample_argmax_kernel(const T* __restrict__ logits, int* __restrict__ out, int h,
                           int w, int C, int s_arg, int cc) {
  constexpr int KP = S ? S : kUaPhases;
  const int s = S ? S : s_arg;
  const int nq = S ? 1 : (s + KP - 1) / KP;  // threads an x run
  const int o = s / 2;                       // run 0's first output
  const int H = h * s, W = w * s;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* tbl = reinterpret_cast<float2*>(smem);  // [axis x, y][kind][phase]
  float* stage = reinterpret_cast<float*>(smem + ((48 * s + 15) & ~15));
  const int tx = threadIdx.x % kUaXT, ty = threadIdx.x / kUaXT;
  const int b = blockIdx.z, jy = (int)blockIdx.y - 1;
  const int u0 = blockIdx.x * kUaXT, u = u0 + tx;
  // the block's runs u0 / nq - 1 .. read input columns col0 .. col0 + ncol - 1
  const int col0 = max(u0 / nq - 1, 0);
  const int ncol = min((u0 + kUaXT - 1) / nq, w - 1) - col0 + 1;
  const bool xin = u / nq - 1 <= w - 1;  // a unit past the last run stores nothing
  const int jx = min(u / nq - 1, w - 1), q = u % nq;
  const long long n_el = (long long)gridDim.z * h * w * C;

  // the weight table: kind 0 (run -1), 1 (run 0), 2 (run n - 1), phase p
  for (int i = threadIdx.x; i < 6 * s; i += kUaThreads) {
    const int kind = (i / s) % 3, n = i < 3 * s ? w : h, p = i % s;
    const int j = kind == 0 ? -1 : kind == 1 ? 0 : n - 1;
    tbl[i] = interp_weights<T>(min(max(s * j + o + p, 0), n * s - 1), n, n * s);
  }
  const int ylo = max(jy, 0), yhi = min(jy + 1, h - 1);
  const int nchunk = (C + cc - 1) / cc;
  if (nchunk == 1)
    ua_stage(logits, stage, n_el, b, ylo, yhi, h, w, C, col0, ncol, 0, C, cc);
  __syncthreads();

  const int kx = jx < 0 ? 0 : jx == w - 1 ? 2 : 1;
  const int ky = jy < 0 ? 0 : jy == h - 1 ? 2 : 1;
  const int cxl = max(jx, 0) - col0, cxh = min(jx + 1, w - 1) - col0;
  float wx[KP][2];
#pragma unroll
  for (int p = 0; p < KP; ++p) {
    const float2 t = tbl[kx * s + min(q * KP + p, s - 1)];
    wx[p][0] = t.x, wx[p][1] = t.y;
  }
  const int x0 = s * jx + o + q * KP;
  const int nit = ((s + kUaRows - 1) / kUaRows + kUaYT - 1) / kUaYT;
  const bool vec = S == 8 && kx == 1 && xin && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int it = 0; it < nit; ++it) {
    const int py0 = (ty + kUaYT * it) * kUaRows;
    float wy[kUaRows][2];
#pragma unroll
    for (int r = 0; r < kUaRows; ++r) {
      const float2 t = tbl[(3 + ky) * s + min(py0 + r, s - 1)];
      wy[r][0] = t.x, wy[r][1] = t.y;
    }
    float best[kUaRows][KP];
    int arg[kUaRows][KP];
    for (int ch = 0; ch < nchunk; ++ch) {
      const int c0 = ch * cc, nc = min(cc, C - c0);
      if (nchunk > 1) {  // every thread is done with the last chunk, then this one
        __syncthreads();
        ua_stage(logits, stage, n_el, b, ylo, yhi, h, w, C, col0, ncol, c0, nc, cc);
        __syncthreads();
      }
      const float* r0 = stage;
      const float* r1 = stage + cc * kUaCols;
      int k = 0;
      if (c0 == 0) {
        ua_class<true, KP, T>(r0, r1, cxl, cxh, wy, wx, 0, best, arg);
        k = 1;
      }
      for (; k < nc; ++k)
        ua_class<false, KP, T>(r0 + k * kUaCols, r1 + k * kUaCols, cxl, cxh, wy, wx,
                               c0 + k, best, arg);
    }
#pragma unroll
    for (int r = 0; r < kUaRows; ++r) {
      const int py = py0 + r, y = s * jy + o + py;
      if (py >= s || y < 0 || y >= H) continue;
      int* dst = out + ((long long)b * H + y) * W;
      if (vec) {
        *reinterpret_cast<int4*>(dst + x0) =
            make_int4(arg[r][0], arg[r][1], arg[r][2], arg[r][3]);
        *reinterpret_cast<int4*>(dst + x0 + 4) =
            make_int4(arg[r][4], arg[r][5], arg[r][6], arg[r][7]);
      } else {
#pragma unroll
        for (int p = 0; p < KP; ++p) {
          const int x = x0 + p;
          if (xin && q * KP + p < s && x >= 0 && x < W) dst[x] = arg[r][p];
        }
      }
    }
  }
}

template <typename T, int S>
int ua_launch(const void* logits, void* out, int B, int h, int w, int C, int s,
              cudaStream_t stream) {
  auto kern = upsample_argmax_kernel<T, S>;
  const int nq = S ? 1 : (s + kUaPhases - 1) / kUaPhases;
  const long long units = (long long)(w + 1) * nq;
  const size_t tbl = (48 * (size_t)s + 15) & ~(size_t)15;
  const size_t per_class = 2 * kUaCols * sizeof(float);
  const size_t budget = tbl + per_class > kUaSmem ? tbl + per_class : kUaSmem;
  if (budget > 232448 || (units + kUaXT - 1) / kUaXT >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const size_t fit = (budget - tbl) / per_class;
  const int cc = (size_t)C < fit ? C : (int)fit;
  const size_t smem = tbl + cc * per_class;
  if (smem > kUaSmem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((units + kUaXT - 1) / kUaXT), h + 1, B);
  kern<<<grid, kUaThreads, smem, stream>>>(static_cast<const T*>(logits),
                                           static_cast<int*>(out), h, w, C, s, cc);
  return (int)cudaGetLastError();
}

}  // namespace

// logits (B, h, w, C), 16-byte aligned, out (B, h*s, w*s) int32; f32 != 0
// selects float logits, else bf16.
extern "C" int mds_upsample_argmax(const void* logits, void* out, int B, int h,
                                   int w, int C, int s, int f32, void* stream) {
  if (B < 1 || h < 1 || w < 1 || C < 1 || s < 1 || B > 65535 || h >= 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    return s == 8 ? ua_launch<float, 8>(logits, out, B, h, w, C, s, st)
                  : ua_launch<float, 0>(logits, out, B, h, w, C, s, st);
  return s == 8 ? ua_launch<bf16, 8>(logits, out, B, h, w, C, s, st)
                : ua_launch<bf16, 0>(logits, out, B, h, w, C, s, st);
}
