"""The deploy stem kernels: wrappers, plain versions, counters.

Counterparts of mds_tpu/ops/pallas/stem.py (TPU kernel numbers as in
PERF.md's table):

  stem_conv_bn_relu_s2        ← _stem_fwd (fused case), 1  — csrc/stem.cu
  stem_conv3x3_s2             ← stem_conv3x3_s2 (kernel 1's training form,
                                a custom_vjp), 1            — csrc/stem.cu
  stem_conv_bn_relu_s2_window ← _stem_fwd_dma, 2           — csrc/stem.cu
  stem_s1_pair_fused          ← stem_s1_pair_fused, 3      — csrc/stem.cu
  detail_s1s2_fused           ← detail_s1s2_fused, 4       — csrc/stem.cu
  stemblock_fused             ← stemblock_fused, 5         — csrc/stem.cu
  stem7_conv_bn_relu_s2       ← stem7_conv_bn_relu_s2, 6   — csrc/stem7.cu
  detail_tail_fused           ← detail_tail_fused, 7       — csrc/detail_tail.cu

All but the 7×7 stem carry BiSeNetV2, the 7×7 stem BiSeNetV1 (its two RGB
stems). stem_conv3x3_s2 is an autograd Function: kernel 1 forward (unit
scale, zero bias, no ReLU, f32 out as JAX's `_stem_fwd` writes it without a
BN), the library conv's gradients backward, as JAX's custom_vjp; the
train-mode RGB stems take it under set_stem_impl("kernel").
`set_stem_variant("dma")` makes stem_conv_bn_relu_s2 launch the window
kernel (2) instead of kernel 1 on a CUDA tensor, as JAX's set_stem_variant
does (stem.py:1248-1284); the two share one plain version and agree bit for
bit. Kernels 1 and 2 read their weights as `pack_stem` lays them out (the
f32 table as three bf16 parts), kernels 3-7 as `pack_s1_pair`,
`pack_detail_head`, `pack_stemblock`, `pack_stem7` and `pack_detail_tail`
do; a caller that holds the weights packs once and passes `packed`, else the
wrapper packs in the call. stem_s1_pair_fused is on no model path, as in
JAX.

Each wrapper takes logically NCHW tensors stored channels_last (NHWC in
memory), torch OIHW conv weights and the folded eval-BN (scale, bias) of each
conv. On a CPU tensor it runs its `*_plain` version, which has the same
folding and rounding points built from F.conv2d / F.max_pool2d in f32 with
explicit bf16 casts. On a CUDA tensor it launches the CUDA kernel or raises.
`<wrapper>.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

_BF16 = torch.bfloat16
_CL = torch.channels_last


def _fold(k: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """k·scale per output channel, in f32 (OIHW)."""
    return k.float() * scale.float().reshape(-1, 1, 1, 1)


def _fold_bf16(k: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """bf16(k·scale) as f32 values — the fused kernels' weights after stage A."""
    return _fold(k, scale).to(_BF16).float()


def _conv(x, w, b=None, stride=1, pad=1):
    """The plain versions' f32 conv. On the CPU it sums in f64 and rounds once
    to f32: the CPU library's f32 3×3 conv lands small outputs far enough
    from their exact sums that a chain of five convs kept only 95% of its
    bf16 outputs equal to JAX's interpret-mode kernel (99.9% in f64)."""
    if x.device.type == "cpu":
        y = F.conv2d(x.double(), w.double(), None if b is None else b.double(),
                     stride=stride, padding=pad)
        return y.float()
    return F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                    stride=stride, padding=pad)


def _out(y: torch.Tensor) -> torch.Tensor:
    return y.to(_BF16).contiguous(memory_format=_CL)


# ------------------------------------------------------------------ checks

def _is_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"expected a CPU or CUDA tensor, got {x.device}")
    return False


def _check_image(x: torch.Tensor, mult: int, name: str) -> None:
    if x.dtype != _BF16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"{name}: x must be (B, 3, H, W), got {tuple(x.shape)}")
    b, _, h, w = x.shape
    if b < 1 or h % mult or w % mult:
        raise ValueError(f"{name}: need B >= 1 and H, W divisible by {mult}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=_CL):
        raise ValueError(f"{name}: x must be channels_last contiguous")


def _check_params(x: torch.Tensor, name: str, ts: Sequence[torch.Tensor]):
    for t in ts:
        if t.device != x.device:
            raise ValueError(f"{name}: parameter on {t.device}, x on {x.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def _stem_n(o: int) -> int:
    """Kernels 1 and 2's GEMM width N for O output channels: 16, 32, 64, 128."""
    return next(n for n in (16, 32, 64, 128) if o <= n)


def _kmajor_sw128(m: torch.Tensor) -> torch.Tensor:
    """A GEMM's B as (N, K) (row n: output channel n's K values, already those
    the kernel multiplies by; N % 8 == 0) → csrc/wgmma.cuh's B operand, flat
    bf16: K zero-padded to a multiple of 64, slices of 64 K × N rows (128
    bytes a row), logical 16-byte chunk c of row n stored at chunk c ^ (n % 8)
    (wgmma's K-major layout, 128-byte swizzle)."""
    n, k = m.shape
    m = F.pad(m.float(), (0, -k % 64)).reshape(n, -1, 8, 8).permute(1, 0, 2, 3)
    r = torch.arange(n, device=m.device).reshape(n, 1)
    c = torch.arange(8, device=m.device).reshape(1, 8)
    return m[:, r, c ^ (r % 8)].to(_BF16).contiguous().flatten()


@torch.no_grad()
def pack_stem(k, scale=None, bias=None):
    """Kernels 1 and 2's weights (csrc/stem.cu): the f32 folded table in
    their K order, split into three bf16 parts hi = bf16(w), mid = bf16(w −
    hi), lo = bf16(w − hi − mid), which sum to w exactly. Column j of the
    (O, 32) table: dy·10 + 1 + dx·3 + ci holds k·scale at (dy, dx, ci);
    dy·10 is zero (the element before a pixel's taps); 30 holds the bias; 31
    is zero. As _kmajor_sw128 of the (N, 128) matrix [hi | mid | lo | 0], N
    = _stem_n(O) rows (zero past O): two slices, [hi | mid] and [lo | 0].
    scale=None, bias=None: unit scale, zero bias (the training form; for a
    bf16 k, mid and lo are zero)."""
    o = k.shape[0]
    w = k.float() if scale is None else _fold(k, scale)
    w = F.pad(w.permute(0, 2, 3, 1).reshape(o, 3, 9), (1, 0)).reshape(o, 30)
    b = torch.zeros(o, 1, device=k.device) if bias is None else bias.float().reshape(o, 1)
    w = torch.cat([w, b, torch.zeros_like(b)], 1)
    hi = w.to(_BF16)
    mid = (w - hi.float()).to(_BF16)
    lo = (w - hi.float() - mid.float()).to(_BF16)
    t = torch.cat([hi, mid, lo, torch.zeros_like(lo)], 1).float()
    return _kmajor_sw128(F.pad(t, (0, 0, 0, _stem_n(o) - o)))


def pack_sw128(w: torch.Tensor) -> torch.Tensor:
    """3×3 weights (O, I, 3, 3), values already those the kernel multiplies
    by → the B operand slices of csrc/wgmma.cuh, flat bf16: [O/64][tap][I/64]
    slices of 64 rows (output channel n) × 8 chunks × 8 values (input
    channels), O and I zero-padded to multiples of 64, logical chunk c of row
    n stored at chunk c ^ (n % 8) (wgmma's K-major layout, 128-byte swizzle)."""
    o, i = w.shape[:2]
    op, ip = -(-o // 64) * 64, -(-i // 64) * 64
    w = F.pad(w.float(), (0, 0, 0, 0, 0, ip - i, 0, op - o))
    # dims: nh, n, kc, chunk, e, tap  →  nh, tap, kc, n, chunk, e
    w = w.reshape(op // 64, 64, ip // 64, 8, 8, 9).permute(0, 5, 2, 1, 3, 4)
    n = torch.arange(64, device=w.device).reshape(64, 1)
    c = torch.arange(8, device=w.device).reshape(1, 8)
    return w[:, :, :, n, c ^ (n % 8)].to(_BF16).contiguous().flatten()


def _check_aligned(t: torch.Tensor, n: int, name: str) -> None:
    if t.data_ptr() % n:
        raise ValueError(f"{name}: the kernel's copies need a {n}-byte "
                         "aligned input")


# ------------------------------------------------- kernel 1: the RGB stem

def stem_conv_bn_relu_s2_plain(x, k, scale, bias, relu=False):
    """3×3 s2 p1 conv on RGB with folded BN, optional ReLU, bf16 out."""
    y = _conv(x, _fold(k, scale), bias, stride=2)
    return _out(F.relu(y) if relu else y)


_STEM_VARIANT = "tiles"


def set_stem_variant(variant: str) -> None:
    """"tiles" (kernel 1, the default) or "dma" (the window kernel 2) for
    stem_conv_bn_relu_s2 on a CUDA tensor."""
    if variant not in ("tiles", "dma"):
        raise ValueError(f"stem variant must be 'tiles' or 'dma', got {variant!r}")
    global _STEM_VARIANT
    _STEM_VARIANT = variant


def get_stem_variant() -> str:
    return _STEM_VARIANT


def _stem_launch(fn_name, x, k, scale, bias, relu, name, packed, f32=False):
    """Launch kernel 1 or 2 (`fn_name`) on x with the table `packed`
    (pack_stem of k, scale, bias; packed here when None)."""
    _check_image(x, 2, name)
    _check_aligned(x, 16, name)
    o = k.shape[0]
    if tuple(k.shape[1:]) != (3, 3, 3) or o % 8 or o > 128:
        raise ValueError(f"{name}: k must be (O,3,3,3), O % 8 == 0, O <= 128")
    if packed is None:
        packed = pack_stem(k, scale, bias)
    if packed.dtype != _BF16 or packed.numel() != _stem_n(o) * 128:
        raise ValueError(f"{name}: packed is not pack_stem's table for O={o}")
    _check_params(x, name, (k, packed) if scale is None else (k, scale, bias, packed))
    from mds_tpu_torch.ops.build import load

    b, _, h, w = x.shape
    out = torch.empty((b, o, h // 2, w // 2), dtype=torch.float32 if f32 else _BF16,
                      device=x.device, memory_format=_CL)
    extra = (int(f32),) if fn_name == "mds_stem_conv_bn_relu_s2" else ()
    err = getattr(load(), fn_name)(
        _ptr(x), _ptr(packed), _ptr(out), b, h, w, o, int(relu), *extra, _stream())
    _raise_on(err, name)
    return out


def stem_conv_bn_relu_s2(x, k, scale, bias, relu=False, packed=None):
    """x (B,3,H,W) bf16 channels_last, H and W even; k (O,3,3,3) with
    O % 8 == 0 and O <= 128 → (B,O,H/2,W/2) bf16 channels_last. `packed`:
    pack_stem(k, scale, bias), made once; a CUDA launch packs itself when it
    is None. Under set_stem_variant("dma") a CUDA tensor goes to the window
    kernel (stem_conv_bn_relu_s2_window), which counts its own launches."""
    if _is_cpu(x):
        return stem_conv_bn_relu_s2_plain(x, k, scale, bias, relu)
    if _STEM_VARIANT == "dma":
        return stem_conv_bn_relu_s2_window(x, k, scale, bias, relu, packed)
    out = _stem_launch("mds_stem_conv_bn_relu_s2", x, k, scale, bias, relu,
                       "stem_conv_bn_relu_s2", packed)
    stem_conv_bn_relu_s2.launches += 1
    return out


stem_conv_bn_relu_s2.launches = 0


# ------------------------- kernel 1's training form: an autograd Function

def stem_conv3x3_s2_plain(x, k):
    """3×3 s2 p1 conv of x on k, the f32 sum (kernel 1 with unit scale, zero
    bias, no ReLU and f32 out), channels_last."""
    return _conv(x, k.float(), stride=2).contiguous(memory_format=_CL)


class _StemConv3x3S2(torch.autograd.Function):
    """Forward: kernel 1 in its f32-output mode on a CUDA tensor (its plain
    version on a CPU one). Backward: the library conv's gradients, the
    incoming gradient cast to x's dtype first
    (mds_tpu/ops/pallas/stem.py:1291-1299, `_bwd`)."""

    @staticmethod
    def forward(ctx, x, k, packed):
        ctx.save_for_backward(x, k)
        if _is_cpu(x):
            return stem_conv3x3_s2_plain(x, k)
        out = _stem_launch("mds_stem_conv_bn_relu_s2", x, k, None, None, False,
                           "stem_conv3x3_s2", packed, f32=True)
        stem_conv3x3_s2.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xx, kk = x.detach().requires_grad_(need[0]), k.detach().requires_grad_(need[1])
            y = F.conv2d(xx, kk.to(x.dtype), stride=2, padding=1)
            wrt = [t for t, n in zip((xx, kk), need) if n]
            grads = iter(torch.autograd.grad(y, wrt, g.to(x.dtype)))
        return (*(next(grads) if n else None for n in need), None)


def stem_conv3x3_s2(x, k, packed=None):
    """x (B,3,H,W) bf16 channels_last, H and W even; k (O,3,3,3) in x's dtype
    with O % 8 == 0 and O <= 128 → (B,O,H/2,W/2) f32 channels_last, with
    gradients for x and k. `packed`: pack_stem(k), made once; a CUDA launch
    packs itself when it is None."""
    return _StemConv3x3S2.apply(x, k, packed)


stem_conv3x3_s2.launches = 0


# ------------------------------------ kernel 2: the stem, window variant

def stem_conv_bn_relu_s2_window(x, k, scale, bias, relu=False, packed=None):
    """Kernel 1's function (stem_conv_bn_relu_s2_plain) with each tile's
    input window copied into shared memory by the copy engine,
    double-buffered; bit-equal to kernel 1. Same arguments and limits."""
    if _is_cpu(x):
        return stem_conv_bn_relu_s2_plain(x, k, scale, bias, relu)
    out = _stem_launch("mds_stem_conv_bn_relu_s2_window", x, k, scale, bias,
                       relu, "stem_conv_bn_relu_s2_window", packed)
    stem_conv_bn_relu_s2_window.launches += 1
    return out


stem_conv_bn_relu_s2_window.launches = 0


# ------------------------------------------------- kernel 3: the S1 pair

def stem_s1_pair_fused_plain(x, k1, s1, b1, k2, s2, b2, relu2=True):
    y = F.relu(_conv(x, _fold(k1, s1), b1, stride=2)).to(_BF16)
    y = _conv(y, _fold_bf16(k2, s2), b2)
    return _out(F.relu(y) if relu2 else y)


def pack_s1_pair(k1, s1, b1, k2, s2, b2):
    """Kernel 3's weights as csrc/stem.cu reads them: (pack_stem of S1_1's
    f32 folded table, pack_sw128 of bf16(k2·s2), S1_2's f32 bias). Made once
    per parameter version by a caller that holds the weights."""
    if tuple(k1.shape) != (64, 3, 3, 3) or tuple(k2.shape) != (64, 64, 3, 3):
        raise ValueError(f"pack_s1_pair: bad kernel shapes {k1.shape} {k2.shape}")
    return (pack_stem(k1, s1, b1), pack_sw128(_fold_bf16(k2, s2)),
            b2.float().contiguous())


def stem_s1_pair_fused(x, k1, s1, b1, k2, s2, b2, relu2=True, packed=None):
    """DetailBranch S1_1 → S1_2 with folded BNs, the first ReLU always, the
    second if relu2. x (B,3,H,W) bf16 channels_last, H and W even;
    k1 (64,3,3,3), k2 (64,64,3,3) → (B,64,H/2,W/2) bf16 channels_last.
    `packed`: the same parameters through pack_s1_pair, made once; a CUDA
    launch packs them itself when it is None."""
    params = (k1, s1, b1, k2, s2, b2)
    if _is_cpu(x):
        return stem_s1_pair_fused_plain(x, *params, relu2)
    name = "stem_s1_pair_fused"
    _check_image(x, 2, name)
    _check_aligned(x, 16, name)
    _check_params(x, name, params)
    t1, w2p, b2f = pack_s1_pair(*params) if packed is None else packed
    if (t1.dtype != _BF16 or t1.numel() != 2 * 64 * 64 or w2p.dtype != _BF16
            or w2p.numel() != 9 * 4096 or b2f.dtype != torch.float32
            or b2f.numel() != 64):
        raise ValueError(f"{name}: packed weights are not pack_s1_pair's")
    _check_params(x, name, (t1, w2p, b2f))
    from mds_tpu_torch.ops.build import load

    b, _, h, w = x.shape
    out = torch.empty((b, 64, h // 2, w // 2), dtype=_BF16, device=x.device,
                      memory_format=_CL)
    err = load().mds_stem_s1_pair_fused(
        _ptr(x), _ptr(t1), _ptr(w2p), _ptr(b2f), _ptr(out), b, h, w,
        int(relu2), _stream())
    _raise_on(err, name)
    stem_s1_pair_fused.launches += 1
    return out


stem_s1_pair_fused.launches = 0


# ------------------------------------------- kernel 4: detail S1_1+S1_2+S2_1

def detail_s1s2_fused_plain(x, k1, s1, b1, k2, s2, b2, k3, s3, b3):
    y = F.relu(_conv(x, _fold(k1, s1), b1, stride=2)).to(_BF16)
    y = F.relu(_conv(y, _fold_bf16(k2, s2), b2)).to(_BF16)
    return _out(F.relu(_conv(y, _fold_bf16(k3, s3), b3, stride=2)))


def pack_detail_head(k1, s1, b1, k2, s2, b2, k3, s3, b3):
    """Kernel 4's weights as csrc/stem.cu reads them: (pack_stem of S1_1's
    f32 folded table, pack_sw128 of bf16(k·scale) of S1_2, its f32 bias, the
    same of S2_1). Once per parameter version: the route caches it
    (models/bisenetv2.py DetailBranch)."""
    if (tuple(k1.shape) != (64, 3, 3, 3) or tuple(k2.shape) != (64, 64, 3, 3)
            or tuple(k3.shape) != (64, 64, 3, 3)):
        raise ValueError(f"pack_detail_head: bad kernel shapes {k1.shape} "
                         f"{k2.shape} {k3.shape}")
    return (*pack_s1_pair(k1, s1, b1, k2, s2, b2), pack_sw128(_fold_bf16(k3, s3)),
            b3.float().contiguous())


def detail_s1s2_fused(x, k1, s1, b1, k2, s2, b2, k3, s3, b3, packed=None):
    """DetailBranch S1_1 → S1_2 → S2_1 with folded BNs and ReLUs.
    x (B,3,H,W) bf16 channels_last, H and W divisible by 4; k1 (64,3,3,3),
    k2/k3 (64,64,3,3) → (B,64,H/4,W/4) bf16 channels_last. `packed`: the
    same parameters through pack_detail_head, made once; a CUDA launch
    packs them itself when it is None."""
    params = (k1, s1, b1, k2, s2, b2, k3, s3, b3)
    if _is_cpu(x):
        return detail_s1s2_fused_plain(x, *params)
    name = "detail_s1s2_fused"
    _check_image(x, 4, name)
    _check_aligned(x, 16, name)
    _check_params(x, name, params)
    t1, w2p, b2f, w3p, b3f = pack_detail_head(*params) if packed is None else packed
    if (t1.dtype != _BF16 or t1.numel() != 2 * 64 * 64 or w2p.dtype != _BF16
            or w2p.numel() != 9 * 4096 or w3p.dtype != _BF16 or w3p.numel() != 9 * 4096
            or b2f.dtype != torch.float32 or b2f.numel() != 64
            or b3f.dtype != torch.float32 or b3f.numel() != 64):
        raise ValueError(f"{name}: packed weights are not pack_detail_head's")
    _check_params(x, name, (t1, w2p, b2f, w3p, b3f))
    from mds_tpu_torch.ops.build import load

    b, _, h, w = x.shape
    out = torch.empty((b, 64, h // 4, w // 4), dtype=_BF16, device=x.device,
                      memory_format=_CL)
    err = load().mds_detail_s1s2_fused(
        _ptr(x), _ptr(t1), _ptr(w2p), _ptr(b2f), _ptr(w3p), _ptr(b3f),
        _ptr(out), b, h, w, _stream())
    _raise_on(err, name)
    detail_s1s2_fused.launches += 1
    return out


detail_s1s2_fused.launches = 0


# ------------------------------------------------- kernel 5: the StemBlock

def stemblock_fused_plain(x, k_s, s_s, b_s, k_l1, s_l1, b_l1,
                          k_l2, s_l2, b_l2, k_f, s_f, b_f):
    s = F.relu(_conv(x, _fold(k_s, s_s), b_s, stride=2))  # f32
    t = F.relu(_conv(s.to(_BF16), _fold_bf16(k_l1, s_l1), b_l1, pad=0))
    left = F.relu(_conv(t.to(_BF16), _fold_bf16(k_l2, s_l2), b_l2, stride=2))
    right = F.max_pool2d(s, 3, 2, 1)
    cat = torch.cat([left.to(_BF16), right.to(_BF16)], dim=1)
    return _out(F.relu(_conv(cat, _fold_bf16(k_f, s_f), b_f)))


_SB_SHAPES = [(16, 3, 3, 3), (8, 16, 1, 1), (16, 8, 3, 3), (16, 32, 3, 3)]


def pack_stemblock(k_s, s_s, b_s, k_l1, s_l1, b_l1, k_l2, s_l2, b_l2, k_f, s_f,
                   b_f):
    """Kernel 5's weights as csrc/stem.cu reads them: (one flat bf16 tensor
    of ten _kmajor_sw128 slices of 16 rows: the stem's f32 folded table as
    pack_stem lays it out (two slices); bf16(k·scale) of left_1 (one: column
    ci, rows 8-15 zero), of left_2 (two: column tap·8 + ci, tap = dy·3 + dx)
    and of the fuse (five: column tap·32 + ci); the f32 biases of left_1,
    left_2 and the fuse, 8 + 16 + 16). Once per parameter version: the
    StemBlock caches it (models/bisenetv2.py)."""
    shapes = [tuple(k.shape) for k in (k_s, k_l1, k_l2, k_f)]
    if shapes != _SB_SHAPES:
        raise ValueError(f"pack_stemblock: bad kernel shapes {shapes}")
    l1 = F.pad(_fold_bf16(k_l1, s_l1)[:, :, 0, 0], (0, 0, 0, 8))
    l2 = _fold_bf16(k_l2, s_l2).permute(0, 2, 3, 1).reshape(16, 72)
    fu = _fold_bf16(k_f, s_f).permute(0, 2, 3, 1).reshape(16, 288)
    w = torch.cat([pack_stem(k_s, s_s, b_s), _kmajor_sw128(l1), _kmajor_sw128(l2),
                   _kmajor_sw128(fu)])
    return w, torch.cat([t.float().flatten() for t in (b_l1, b_l2, b_f)])


def stemblock_fused(x, k_s, s_s, b_s, k_l1, s_l1, b_l1,
                    k_l2, s_l2, b_l2, k_f, s_f, b_f, packed=None):
    """BiSeNetV2 StemBlock with folded BNs and ReLUs. x (B,3,H,W) bf16
    channels_last, H and W divisible by 4; k_s (16,3,3,3), k_l1 (8,16,1,1),
    k_l2 (16,8,3,3), k_f (16,32,3,3) → (B,16,H/4,W/4) bf16 channels_last.
    `packed`: the same parameters through pack_stemblock, made once; a CUDA
    launch packs them itself when it is None."""
    args = (k_s, s_s, b_s, k_l1, s_l1, b_l1, k_l2, s_l2, b_l2, k_f, s_f, b_f)
    if _is_cpu(x):
        return stemblock_fused_plain(x, *args)
    name = "stemblock_fused"
    _check_image(x, 4, name)
    _check_aligned(x, 16, name)
    _check_params(x, name, args)
    shapes = [tuple(k.shape) for k in (k_s, k_l1, k_l2, k_f)]
    if shapes != _SB_SHAPES:
        raise ValueError(f"{name}: bad kernel shapes {shapes}")
    w, bias = pack_stemblock(*args) if packed is None else packed
    if (w.dtype != _BF16 or w.numel() != 10 * 1024 or bias.dtype != torch.float32
            or bias.numel() != 40):
        raise ValueError(f"{name}: packed weights are not pack_stemblock's")
    _check_params(x, name, (w, bias))
    from mds_tpu_torch.ops.build import load

    b, _, h, wd = x.shape
    out = torch.empty((b, 16, h // 4, wd // 4), dtype=_BF16, device=x.device,
                      memory_format=_CL)
    err = load().mds_stemblock_fused(_ptr(x), _ptr(w), _ptr(bias), _ptr(out), b, h,
                                     wd, _stream())
    _raise_on(err, name)
    stemblock_fused.launches += 1
    return out


stemblock_fused.launches = 0


# ------------------------------- kernel 6: the 7×7 RGB stem of BiSeNetV1

def pack_stem7(k, scale, bias):
    """Kernel 6's weights (csrc/stem7.cu): bf16(k·scale) and bf16(bias) as the
    (N, 169) GEMM matrix through _kmajor_sw128, three slices, N = _stem_n(O)
    rows, zero past O: column dy·24 + 1 + dx·3 + ci holds tap (dy, dx, ci),
    columns dy·24, dy·24 + 22 and dy·24 + 23 are zero (the element before a
    pixel's taps and two after them), column 168 holds the bias (the
    kernel's A is 1 there). Once per parameter version: the 7×7 route caches
    it (models/layers.py conv_bn_relu)."""
    o = k.shape[0]
    if tuple(k.shape[1:]) != (3, 7, 7) or o % 8 or not 0 < o <= 128:
        raise ValueError(f"pack_stem7: k must be (O,3,7,7), O % 8 == 0, O <= 128, "
                         f"got {tuple(k.shape)}")
    w = F.pad(_fold_bf16(k, scale).permute(0, 2, 3, 1).reshape(o, 7, 21), (1, 2))
    w = torch.cat([w.reshape(o, 168), bias.to(_BF16).float().reshape(o, 1)], 1)
    return _kmajor_sw128(F.pad(w, (0, 0, 0, _stem_n(o) - o)))


def stem7_conv_bn_relu_s2_plain(x, k, scale, bias, relu=True):
    """7×7 s2 p3 conv on RGB with the BN folded as the kernel rounds it:
    f32 conv on bf16(k·scale), + bf16(bias), optional ReLU, bf16 out."""
    y = _conv(x, _fold_bf16(k, scale), bias.to(_BF16), stride=2, pad=3)
    return _out(F.relu(y) if relu else y)


def stem7_conv_bn_relu_s2(x, k, scale, bias, relu=True, packed=None):
    """x (B,3,H,W) bf16 channels_last, H and W even; k (O,3,7,7) with
    O % 8 == 0 and O <= 128; the folded eval BN (scale, bias) →
    (B,O,H/2,W/2) bf16 channels_last. `packed`: pack_stem7(k, scale, bias),
    made once; a CUDA launch packs itself when it is None."""
    if _is_cpu(x):
        return stem7_conv_bn_relu_s2_plain(x, k, scale, bias, relu)
    name = "stem7_conv_bn_relu_s2"
    _check_image(x, 2, name)
    _check_aligned(x, 16, name)
    _check_params(x, name, (k, scale, bias))
    o = k.shape[0]
    if tuple(k.shape[1:]) != (3, 7, 7) or o % 8 or not 0 < o <= 128:
        raise ValueError(f"{name}: k must be (O,3,7,7), O % 8 == 0, O <= 128")
    wp = pack_stem7(k, scale, bias) if packed is None else packed
    if wp.dtype != _BF16 or wp.numel() != 3 * 64 * _stem_n(o):
        raise ValueError(f"{name}: packed is not pack_stem7's for O={o}")
    _check_params(x, name, (wp,))
    from mds_tpu_torch.ops.build import load

    b, _, h, w = x.shape
    out = torch.empty((b, o, h // 2, w // 2), dtype=_BF16, device=x.device,
                      memory_format=_CL)
    err = load().mds_stem7_conv_bn_relu_s2(
        _ptr(x), _ptr(wp), _ptr(out), b, h, w, o, int(relu), _stream())
    _raise_on(err, name)
    stem7_conv_bn_relu_s2.launches += 1
    return out


stem7_conv_bn_relu_s2.launches = 0

# ------------------------------------------- kernel 7: the DetailBranch tail

_TAIL_SHAPES = [(64, 64), (64, 64), (128, 64), (128, 128), (128, 128)]
_TAIL_STRIDES = (1, 1, 2, 1, 1)
_TAIL_SLICES = sum(-(-o // 64) * 9 * -(-i // 64) for o, i in _TAIL_SHAPES)  # 108


def detail_tail_fused_plain(y, *params):
    """S2_2 → S2_3 → S3_1 (s2) → S3_2 → S3_3: each conv on bf16(k·scale) in
    f32, + f32 bias, ReLU, rounded to bf16. params: (k, scale, bias) × 5."""
    for i, st in enumerate(_TAIL_STRIDES):
        k, s, b = params[3 * i:3 * i + 3]
        y = F.relu(_conv(y, _fold_bf16(k, s), b, stride=st)).to(_BF16)
    return _out(y)


def pack_detail_tail(k4, s4, b4, k5, s5, b5, k6, s6, b6, k7, s7, b7, k8, s8,
                     b8):
    """The tail's weights as csrc/detail_tail.cu reads them: (bf16(k·scale)
    of the five convs as pack_sw128 slices, one flat bf16 tensor; their f32
    biases, 64 + 64 + 128 + 128 + 128). Once per model: the route caches it
    (models/bisenetv2.py DetailBranch)."""
    params = (k4, s4, b4, k5, s5, b5, k6, s6, b6, k7, s7, b7, k8, s8, b8)
    ks = params[0::3]
    if [tuple(k.shape) for k in ks] != [(o, i, 3, 3) for o, i in _TAIL_SHAPES]:
        raise ValueError(f"pack_detail_tail: bad kernel shapes {[k.shape for k in ks]}")
    wp = torch.cat([pack_sw128(_fold_bf16(k, s)) for k, s in zip(ks, params[1::3])])
    return wp, torch.cat([t.float().flatten() for t in params[2::3]])


def detail_tail_fused(y, k4, s4, b4, k5, s5, b5, k6, s6, b6, k7, s7, b7,
                      k8, s8, b8, packed=None):
    """DetailBranch S2_2 → S2_3 → S3_1 → S3_2 → S3_3 with folded BNs and
    ReLUs. y (B,64,H4,W4) bf16 channels_last (detail_s1s2_fused's output),
    H4 and W4 even; k4, k5 (64,64,3,3), k6 (128,64,3,3) stride 2, k7, k8
    (128,128,3,3) → (B,128,H4/2,W4/2) bf16 channels_last. `packed`: the
    same parameters through pack_detail_tail, made once; a CUDA launch
    packs them itself when it is None."""
    params = (k4, s4, b4, k5, s5, b5, k6, s6, b6, k7, s7, b7, k8, s8, b8)
    if _is_cpu(y):
        return detail_tail_fused_plain(y, *params)
    name = "detail_tail_fused"
    if y.dtype != _BF16 or y.dim() != 4 or y.shape[1] != 64:
        raise ValueError(f"{name}: y must be (B,64,H4,W4) bfloat16, got "
                         f"{tuple(y.shape)} {y.dtype}")
    b, _, h4, w4 = y.shape
    if h4 % 2 or w4 % 2 or not y.is_contiguous(memory_format=_CL):
        raise ValueError(f"{name}: need even H4, W4 and channels_last, got "
                         f"{tuple(y.shape)}")
    _check_aligned(y, 16, name)
    _check_params(y, name, params)
    wp, bp = pack_detail_tail(*params) if packed is None else packed
    if (wp.dtype != _BF16 or wp.numel() != _TAIL_SLICES * 4096
            or bp.dtype != torch.float32 or bp.numel() != 512):
        raise ValueError(f"{name}: packed weights are not pack_detail_tail's")
    _check_params(y, name, (wp, bp))
    from mds_tpu_torch.ops.build import load

    out = torch.empty((b, 128, h4 // 2, w4 // 2), dtype=_BF16, device=y.device,
                      memory_format=_CL)
    err = load().mds_detail_tail_fused(_ptr(y), _ptr(wp), _ptr(bp), _ptr(out),
                                       b, h4, w4, _stream())
    _raise_on(err, name)
    detail_tail_fused.launches += 1
    return out


detail_tail_fused.launches = 0

KERNELS = (stem_conv_bn_relu_s2, stem_conv3x3_s2, stem_conv_bn_relu_s2_window,
           stem_s1_pair_fused, detail_s1s2_fused, stemblock_fused,
           stem7_conv_bn_relu_s2, detail_tail_fused)
