"""The fused pred tail — ×s bilinear upsample + argmax over classes: wrapper,
plain version, counter.

Counterpart of mds_tpu/ops/pallas/upsample_argmax.py
(`upsample_argmax_pallas` :76), the CUDA kernel in csrc/upsample_argmax.cu.
Logits (B, C, h, w), stored channels_last, bf16 or f32 → the int32 label map
(B, h·s, w·s), as the TPU kernel computes it (:56-73):

- each axis interpolates half-pixel with edge clamp, with the weights of
  `interp_matrix` (:33-46: f64, two clamped taps on one input add up),
  rounded to f32 and then to the logits' dtype;
- per class the vertical pass runs in f32 and is rounded to the logits'
  dtype, then the horizontal pass runs in f32;
- the argmax takes the earliest class among equal maxima.

Every weight at s = 2, 4, 8 is k/(2s), exact in bf16, so with bf16 logits
every product is exact in f32: `upsample_argmax_plain` (two separable passes
with that rounding, no dense interpolation matrix) and the kernel agree bit
for bit. The kernel works by input cell and takes its weights from a table
per run kind and phase, which `phase_taps` describes. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises. `upsample_argmax.launches` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mds_tpu_torch.ops.stem import _check_aligned, _is_cpu, _ptr, _raise_on, _stream

_DTYPES = (torch.bfloat16, torch.float32)


def interp_taps(n_in: int, scale: int, dtype: torch.dtype,
                device=None) -> Tuple[torch.Tensor, ...]:
    """(lo, hi, w_lo, w_hi) of each of the n_in·scale outputs along an axis:
    row i of mds_tpu's interp_matrix(n_in, n_in·scale) as its two taps (one
    tap of the summed weight and a zero where the edge clamps both to one
    input), the weights f32 values rounded to `dtype`."""
    n_out = n_in * scale
    src = (torch.arange(n_out, dtype=torch.float64) + 0.5) * n_in / n_out - 0.5
    fl = torch.floor(src)
    f = src - fl
    lo = fl.long().clamp(0, n_in - 1)
    hi = (fl.long() + 1).clamp(0, n_in - 1)
    one = lo == hi
    w_lo = torch.where(one, (1.0 - f) + f, 1.0 - f)
    w_hi = torch.where(one, torch.zeros_like(f), f)

    def rounded(v):
        return v.float().to(dtype).float().to(device)

    return lo.to(device), hi.to(device), rounded(w_lo), rounded(w_hi)


def phase_taps(n_in: int, scale: int, dtype: torch.dtype) -> torch.Tensor:
    """The kernel's weight table along an axis (csrc/upsample_argmax.cu):
    (3, scale, 2) f32 values (w_lo, w_hi) by run kind and phase. Run j, the
    outputs scale·j + scale//2 + p (p < scale) between inputs j and j + 1,
    is of kind 0 for j = −1 (the left edge), 2 for j = n_in − 1 (the right
    edge) and 1 between; each kind's weights are those of its first run's
    outputs as interp_taps gives them (an output outside the image: the
    nearest one's)."""
    _, _, w_lo, w_hi = interp_taps(n_in, scale, dtype)
    p = torch.arange(scale)
    pos = torch.stack([(scale * j + scale // 2 + p).clamp(0, n_in * scale - 1)
                       for j in (-1, 0, n_in - 1)])
    return torch.stack([w_lo[pos], w_hi[pos]], -1)


def upsample_argmax_plain(logits: torch.Tensor, scale: int) -> torch.Tensor:
    """Vertical pass (f32, rounded to the logits' dtype), horizontal pass
    (f32), argmax over classes (first maximum) → (B, h·s, w·s) int32."""
    _, _, h, w = logits.shape
    dt, dev = logits.dtype, logits.device
    ylo, yhi, wylo, wyhi = interp_taps(h, scale, dt, dev)
    xlo, xhi, wxlo, wxhi = interp_taps(w, scale, dt, dev)
    x = logits.float()
    t = x[:, :, ylo, :] * wylo[:, None] + x[:, :, yhi, :] * wyhi[:, None]
    t = t.to(dt).float()
    o = t[:, :, :, xlo] * wxlo + t[:, :, :, xhi] * wxhi
    return o.argmax(dim=1).to(torch.int32)


def upsample_argmax(logits: torch.Tensor, scale: int) -> torch.Tensor:
    """Fused ×`scale` bilinear upsample + argmax (TPU kernel 11): logits
    (B, C, h, w) channels_last, bf16 or f32 → (B, h·scale, w·scale) int32."""
    name = "upsample_argmax"
    if logits.dim() != 4 or logits.dtype not in _DTYPES:
        raise ValueError(f"{name}: logits must be 4-d bf16 or f32, got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    if int(scale) != scale or scale < 1:
        raise ValueError(f"{name}: scale must be an integer >= 1, got {scale}")
    scale = int(scale)
    if _is_cpu(logits):
        return upsample_argmax_plain(logits, scale)
    if not logits.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: logits must be channels_last contiguous")
    _check_aligned(logits, 16, name)
    from mds_tpu_torch.ops.build import load

    b, c, h, w = logits.shape
    out = torch.empty((b, h * scale, w * scale), dtype=torch.int32,
                      device=logits.device)
    err = load().mds_upsample_argmax(_ptr(logits), _ptr(out), b, h, w, c, scale,
                                     int(logits.dtype == torch.float32), _stream())
    _raise_on(err, name)
    upsample_argmax.launches += 1
    return out


upsample_argmax.launches = 0

KERNELS = (upsample_argmax,)
