"""Depthwise / channel-multiplier 3×3 convolution: wrappers, plain version,
counters.

Counterparts of mds_tpu/ops/pallas/depthwise.py and depthwise_dma.py, with
the math of mds_tpu/ops/depthwise.py:26-54:

  depthwise3x3      ← depthwise3x3_pallas (stride 1 or 2) — csrc/depthwise.cu mds_dw3x3
  depthwise3x3_dma  ← depthwise3x3_dma (stride 1)         — csrc/depthwise.cu mds_dw3x3_window

    out[b, c·m + j, y, x] = Σ_{dy,dx} x[b, c, s·y + dy − 1, s·x + dx − 1] · w[c·m + j, 0, dy, dx]

x is logically (B, C, H, W), stored channels_last, bf16 or f32; w is the
torch OIHW weight (C·m, 1, 3, 3) in x's dtype, which the kernels read as it
is; zero padding 1; the output (B, C·m, ⌈H/s⌉, ⌈W/s⌉) is channels_last in
x's dtype. The 9 products are summed in f32 in (dy, dx) row-major order,
starting from the first product, and rounded once: `depthwise3x3_plain` does
that with library ops, and the CUDA kernels do it without FMA, so the three
agree bit for bit. Neither kernel has a backward (the TPU kernel has none):
the wrappers refuse inputs that require grad. On a CPU tensor a wrapper runs
the plain version; on a CUDA tensor it launches its kernel or raises.
`<wrapper>.launches` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mds_tpu_torch.ops import build as _build
from mds_tpu_torch.ops.stem import _custom_ops, _is_cpu, _ptr, _raise_on, _stream

_DTYPES = (torch.bfloat16, torch.float32)


def depthwise3x3_plain(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """f32 strided slices of the zero-padded input, times each output
    channel's tap, summed in tap order; rounded to x's dtype once."""
    _, c, h, wd = x.shape
    co = w.shape[0]
    ho, wo = -(-h // stride), -(-wd // stride)
    xp = F.pad(x.float(), (1, 1, 1, 1))
    if co != c:
        xp = xp.repeat_interleave(co // c, dim=1)  # output channel c·m + j ← c
    taps = w.float().reshape(co, 9)
    acc = None
    for t in range(9):
        dy, dx = divmod(t, 3)
        tap = xp[:, :, dy:dy + (ho - 1) * stride + 1:stride,
                 dx:dx + (wo - 1) * stride + 1:stride]
        term = tap * taps[:, t].reshape(1, co, 1, 1)
        acc = term if acc is None else acc + term
    return acc.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, name: str) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError(
            f"{name} has no backward, as its TPU kernel has none: call it under "
            "torch.no_grad() / torch.inference_mode(), or use "
            "set_depthwise_impl('plain') to train")
    if x.dim() != 4 or x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x must be 4-d bf16 or f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    c = x.shape[1]
    if (w.dim() != 4 or tuple(w.shape[1:]) != (1, 3, 3) or w.shape[0] < c
            or w.shape[0] % c):
        raise ValueError(f"{name}: w must be (C·m, 1, 3, 3) for C = {c}, got "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"{name}: w must be {x.dtype} on {x.device}, got "
                         f"{w.dtype} on {w.device}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")


def _launch(fn_name: str, x, w, stride: int) -> torch.Tensor:
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{fn_name}: x must be channels_last contiguous")
    if not w.is_contiguous():
        raise ValueError(f"{fn_name}: w must be contiguous")
    b, c, h, wd = x.shape
    co = w.shape[0]
    out = torch.empty((b, co, -(-h // stride), -(-wd // stride)), dtype=x.dtype,
                      device=x.device, memory_format=torch.channels_last)
    f32 = int(x.dtype == torch.float32)
    lib = _build.load()
    if fn_name == "depthwise3x3":
        err = lib.mds_dw3x3(_ptr(x), _ptr(w), _ptr(out), b, h, wd, c, co // c,
                            stride, f32, _stream())
    else:
        err = lib.mds_dw3x3_window(_ptr(x), _ptr(w), _ptr(out), b, h, wd, c,
                                   co // c, f32, _stream())
    _raise_on(err, fn_name)
    return out


def depthwise3x3(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise / channel-multiplier 3×3 conv, pad 1, stride 1 or 2 (TPU
    kernel 9): x (B, C, H, W) channels_last, w (C·m, 1, 3, 3) →
    (B, C·m, ⌈H/s⌉, ⌈W/s⌉) channels_last, in x's dtype. While torch.export
    traces, it calls its custom op (ops/custom_ops.py), whose body is this
    wrapper."""
    if torch.compiler.is_compiling():
        return _custom_ops().depthwise3x3(x, w, stride)
    _check(x, w, stride, "depthwise3x3")
    if _is_cpu(x):
        return depthwise3x3_plain(x, w, stride)
    out = _launch("depthwise3x3", x, w, stride)
    depthwise3x3.launches += 1
    return out


depthwise3x3.launches = 0


def depthwise3x3_dma(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """depthwise3x3 at stride 1 with the input window staged in shared
    memory (TPU kernel 10): tensor-map (TMA) copies into a ring that
    persistent blocks walk, or, for C·size % 16 != 0 or a misaligned
    tensor, cp.async; the same function, bit for bit."""
    _check(x, w, 1, "depthwise3x3_dma")
    if _is_cpu(x):
        return depthwise3x3_plain(x, w, 1)
    out = _launch("depthwise3x3_dma", x, w, 1)
    depthwise3x3_dma.launches += 1
    return out


depthwise3x3_dma.launches = 0

KERNELS = (depthwise3x3, depthwise3x3_dma)
