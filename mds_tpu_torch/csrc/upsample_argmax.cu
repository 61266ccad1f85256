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
// earliest class wins a tie. No FMA (__fmul_rn / __fadd_rn): with bf16 logits
// every product is exact in f32 and the kernel equals the plain version in
// mds_tpu_torch/ops/upsample_argmax.py bit for bit; with f32 logits too.
//
// Bound: memory. At BiSeNetV2's tail, (1, 19, 128, 256) bf16 -> (1, 1024,
// 2048) int32, the logits are 1.2 MB read once and the labels 8.4 MB written
// once: 2.9 us at 3.35 TB/s, against the 80 MB bf16 class volume (written
// and read back) of the library's interpolate + argmax. The f32 work is ~6
// operations per output pixel per class (~240 M at the tail), a few us of
// CUDA-core time.
//
// Design: a block owns 4 output rows x 256 output columns; a thread 4
// neighbouring pixels of one row, written as one 16-byte int32 store. For a
// chunk of classes the block first runs the vertical pass of its rows over
// the input columns its pixels read (256/s + 2 of them) into shared memory,
// reading the logits of one (row, column) as a contiguous run of classes;
// then each thread runs the horizontal pass and the argmax for its pixels
// from shared memory and keeps best value and class in registers across
// chunks. The chunk holds as many classes as 48000 bytes of shared memory take
// (88 at s = 8), so any C and any s >= 1 fit. JAX's NCHW transpose and MXU
// matmuls are TPU workarounds with no counterpart here.
//
// The launcher returns the cudaError_t of its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTY = 4;             // output rows per block
constexpr int kPx = 4;             // output pixels per thread
constexpr int kRowThreads = 64;    // threads per output row
constexpr int kTX = kRowThreads * kPx;  // output columns per block
constexpr int kThreads = kTY * kRowThreads;
constexpr int kSmemFloats = 12000;  // 48000 bytes of vertical-pass values

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// v rounded to T, as f32
__device__ __forceinline__ float round_to(float v, float*) { return v; }
__device__ __forceinline__ float round_to(float v, bf16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

struct Tap {
  int lo, hi;
  float wlo, whi;
};

// The two taps of output i along an axis of n_in inputs and n_out outputs,
// as interp_matrix builds row i (f64, clamped taps summed), the weights
// rounded to f32 and then to T.
template <typename T>
__device__ Tap interp_tap(int i, int n_in, int n_out) {
  const double src = __dadd_rn(
      __ddiv_rn(__dmul_rn((double)i + 0.5, (double)n_in), (double)n_out), -0.5);
  const double fl = floor(src);
  const double f = __dadd_rn(src, -fl);
  const int l = (int)fl;
  const int lo = min(max(l, 0), n_in - 1), hi = min(max(l + 1, 0), n_in - 1);
  const double a = __dadd_rn(1.0, -f);
  T* tag = nullptr;
  Tap t;
  t.lo = lo;
  if (lo == hi) {
    t.hi = lo;
    t.wlo = round_to(__double2float_rn(__dadd_rn(a, f)), tag);
    t.whi = 0.f;
  } else {
    t.hi = hi;
    t.wlo = round_to(__double2float_rn(a), tag);
    t.whi = round_to(__double2float_rn(f), tag);
  }
  return t;
}

__device__ __forceinline__ float lerp2(float wlo, float a, float whi, float b) {
  return __fadd_rn(__fmul_rn(wlo, a), __fmul_rn(whi, b));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upsample_argmax_kernel(const T* __restrict__ logits, int* __restrict__ out,
                       int h, int w, int C, int s) {
  __shared__ float tv[kSmemFloats];
  __shared__ Tap ytap[kTY];
  T* tag = nullptr;
  const int H = h * s, W = w * s;
  const int X0 = blockIdx.x * kTX, Y0 = blockIdx.y * kTY, b = blockIdx.z;
  const int rows = min(kTY, H - Y0);
  // input columns [xf, xf + ncol) cover every tap of the block's columns
  const int xf = interp_tap<T>(X0, w, W).lo;
  const int ncol = interp_tap<T>(min(X0 + kTX, W) - 1, w, W).hi - xf + 1;
  const int chunk = min(C, max(1, kSmemFloats / (rows * ncol)));
  const int tid = threadIdx.x;
  if (tid < rows) ytap[tid] = interp_tap<T>(Y0 + tid, h, H);

  const int ty = tid / kRowThreads, tx = X0 + (tid % kRowThreads) * kPx;
  Tap xt[kPx];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    xt[p] = interp_tap<T>(min(tx + p, W - 1), w, W);
    xt[p].lo -= xf;
    xt[p].hi -= xf;
  }
  float best[kPx];
  int arg[kPx];
  const T* img = logits + (long long)b * h * w * C;
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += chunk) {
    const int nc = min(chunk, C - c0);
    // vertical pass: tv[(r * nc + k) * ncol + col] = T(t) of class c0 + k
    for (int i = tid; i < rows * ncol * nc; i += kThreads) {
      const int k = i % nc, rc = i / nc;
      const int col = rc % ncol, r = rc / ncol;
      const Tap yt = ytap[r];
      const T* px = img + (long long)(xf + col) * C + c0 + k;
      const float v = lerp2(yt.wlo, to_f(px[(long long)yt.lo * w * C]), yt.whi,
                            to_f(px[(long long)yt.hi * w * C]));
      tv[(r * nc + k) * ncol + col] = round_to(v, tag);
    }
    __syncthreads();
    if (ty < rows) {
      for (int k = 0; k < nc; ++k) {
        const float* t = tv + (ty * nc + k) * ncol;
        const int c = c0 + k;
#pragma unroll
        for (int p = 0; p < kPx; ++p) {
          const float o = lerp2(xt[p].wlo, t[xt[p].lo], xt[p].whi, t[xt[p].hi]);
          if (c == 0 || o > best[p]) {  // strict: the earliest class wins a tie
            best[p] = o;
            arg[p] = c;
          }
        }
      }
    }
    __syncthreads();
  }

  if (ty >= rows || tx >= W) return;
  int* dst = out + ((long long)b * H + Y0 + ty) * W + tx;
  if (tx + kPx <= W && (W & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    *reinterpret_cast<int4*>(dst) = make_int4(arg[0], arg[1], arg[2], arg[3]);
  } else {
#pragma unroll
    for (int p = 0; p < kPx; ++p)
      if (tx + p < W) dst[p] = arg[p];
  }
}

}  // namespace

// logits (B, h, w, C), out (B, h*s, w*s) int32; f32 != 0 selects float
// logits, else bf16.
extern "C" int mds_upsample_argmax(const void* logits, void* out, int B, int h,
                                   int w, int C, int s, int f32, void* stream) {
  if (B < 1 || h < 1 || w < 1 || C < 1 || s < 1)
    return (int)cudaErrorInvalidValue;
  const int H = h * s, W = w * s;
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (f32)
    upsample_argmax_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(logits), static_cast<int*>(out), h, w, C, s);
  else
    upsample_argmax_kernel<bf16><<<grid, kThreads, 0, st>>>(
        static_cast<const bf16*>(logits), static_cast<int*>(out), h, w, C, s);
  return (int)cudaGetLastError();
}
