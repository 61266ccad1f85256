"""The SegmentHead dropout: wrapper, plain version, autograd function, counter.

Counterpart of mds_tpu/ops/pallas/dropout.py (`dropout_u8_pallas` :84, its
kernel `_apply` :54 and custom VJP :83-110), the CUDA kernel in
csrc/dropout.cu. The TPU kernel draws its bits from the TPU's hardware
generator; here they come from a counter-based Philox4x32-10:

  key     = the two u32 seed words
  counter = (e // 4 as 64 bits in words 0-1, 0, 0), e = offset + i, i the
            element's index in the tensor's dense storage order and
            `offset` the caller's (0 by default); the element takes output
            word e % 4
  keep    ⇔ (word >> 24) >= drop,     drop = round(rate · 256)
  y       = keep ? x · dtype(256 / (256 − drop)) : 0

The scale is rounded to x's dtype first, as JAX's `x * jnp.asarray(scale,
x.dtype)`; a product of two bf16 values is exact in f32, so the one rounding
to bf16 gives the bf16 product. The plain version runs the same Philox in
torch int64 ops, so it reproduces the kernel's mask bit for bit. The
backward regenerates the mask from the same seed words and offset instead
of storing it. With `offset` = r · n a tensor of n elements draws elements
[r·n, (r + 1)·n) of a larger tensor's mask: a data-parallel rank holding
rows r of a batch draws those rows of the whole batch's mask
(models/layers.py FastDropout). `dropout_u8.launches` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key increments per round
_MASK32 = 0xFFFFFFFF
_DTYPES = (torch.bfloat16, torch.float32)


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the u32 product a·b, with b's values in
    [0, 2³²) held as int64: b splits into 16-bit halves so that no partial
    product leaves int64."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
                  c3: torch.Tensor, k0: int, k1: int):
    """Philox4x32-10 (Random123, curand_Philox4x32_10) on int64 tensors
    holding u32 counter words; returns the four u32 output words."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def _random_words(n: int, k0: int, k1: int, device, offset: int = 0) -> torch.Tensor:
    """Element e's u32 word (as int64) for e in [offset, offset + n)."""
    first, last = offset // 4, (offset + n + 3) // 4
    ctr = torch.arange(first, last, dtype=torch.int64, device=device)
    zero = torch.zeros_like(ctr)
    words = philox4x32_10(ctr & _MASK32, ctr >> 32, zero, zero, k0, k1)
    return torch.stack(words, dim=1).reshape(-1)[offset % 4:offset % 4 + n]


def _scale(drop: int, dtype: torch.dtype) -> float:
    return torch.tensor(256.0 / (256.0 - drop), dtype=dtype).item()


def _flat(t: torch.Tensor) -> torch.Tensor:
    """1-d view of a dense tensor's storage, in storage order."""
    return t.as_strided((t.numel(),), (1,))


def _memory_format(x: torch.Tensor, name: str) -> torch.memory_format:
    if x.is_contiguous():
        return torch.contiguous_format
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    raise ValueError(f"{name}: x must be dense in a memory format "
                     f"(contiguous or channels_last), got strides {x.stride()}")


def _check_drop(drop: int, offset: int) -> None:
    if not 0 < drop < 256:
        raise ValueError(f"drop must be in [1, 255], got {drop}")
    if not 0 <= offset < 1 << 62:
        raise ValueError(f"offset must be in [0, 2^62), got {offset}")


def _is_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"dropout_u8: expected a CPU or CUDA tensor, got {x.device}")
    return False


def _stream(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def dropout_u8_plain(x: torch.Tensor, k0: int, k1: int, drop: int,
                     offset: int = 0) -> torch.Tensor:
    """The kernel's function in torch ops, on any device."""
    _check_drop(drop, offset)
    fmt = _memory_format(x, "dropout_u8_plain")
    keep = (_random_words(x.numel(), k0, k1, x.device, offset) >> 24) >= drop
    xf = _flat(x)
    y = torch.where(keep, (xf.float() * _scale(drop, x.dtype)).to(x.dtype),
                    torch.zeros((), dtype=x.dtype, device=x.device))
    out = torch.empty_like(x, memory_format=fmt)
    _flat(out).copy_(y)
    return out


def dropout_u8(x: torch.Tensor, k0: int, k1: int, drop: int,
               offset: int = 0) -> torch.Tensor:
    """x: bf16 or f32, dense in its memory format; k0, k1: u32 seed words;
    drop in [1, 255]; `offset`: the element offset of x's first element in
    the mask. A CPU tensor runs the plain version; a CUDA tensor launches
    csrc/dropout.cu on the current stream or raises."""
    if _is_cpu(x):
        return dropout_u8_plain(x, k0, k1, drop, offset)
    name = "dropout_u8"
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x must be bfloat16 or float32, got {x.dtype}")
    _check_drop(drop, offset)
    fmt = _memory_format(x, name)
    if x.data_ptr() % 16:  # the kernel reads 16-byte vectors
        x = x.clone(memory_format=fmt)
    from mds_tpu_torch.ops.build import load

    out = torch.empty_like(x, memory_format=fmt)
    err = load().mds_dropout_u8(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        x.numel(), int(x.dtype == torch.float32), k0 & _MASK32, k1 & _MASK32,
        drop, _scale(drop, x.dtype), offset, _stream(x))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
    dropout_u8.launches += 1
    return out


dropout_u8.launches = 0
KERNELS = (dropout_u8,)


class DropoutU8(torch.autograd.Function):
    """y = dropout_u8(x); the backward runs the same op, with the same seed
    words and offset, on the gradient brought to x's strides (the mask
    follows storage order). Saves the seed words, drop and the offset, never
    the mask."""

    @staticmethod
    def forward(ctx, x, k0: int, k1: int, drop: int, offset: int = 0):
        ctx.seed = (k0, k1, drop, offset)
        ctx.strides = x.stride()
        return dropout_u8(x, k0, k1, drop, offset)

    @staticmethod
    def backward(ctx, g):
        if g.stride() != ctx.strides:
            g = g.new_empty_strided(g.shape, ctx.strides).copy_(g)
        return dropout_u8(g, *ctx.seed), None, None, None, None


def seed_words(generator: Optional[torch.Generator] = None) -> Tuple[int, int]:
    """Two u32 seed words from a CPU generator (the default one if None):
    host only, no device tensor, no sync."""
    k = torch.randint(0, 1 << 32, (2,), dtype=torch.int64, generator=generator)
    return int(k[0]), int(k[1])


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            offset: int = 0) -> torch.Tensor:
    """Dropout at `rate` (quantized to 1/256), differentiable, x's first
    element at `offset` in the mask; rate 0 returns x and rate 1 zeros, with
    no launch (dropout.py:91-94)."""
    drop = int(round(rate * 256))
    if drop <= 0:
        return x
    if drop >= 256:
        return torch.zeros_like(x)
    return DropoutU8.apply(x, *seed_words(generator), drop, offset)
