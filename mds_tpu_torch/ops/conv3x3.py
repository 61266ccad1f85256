"""The fused eval 3×3 conv: wrapper, plain version, counter.

Counterpart of mds_tpu/ops/pallas/conv3x3.py (TPU kernel 8 of PERF.md's
table):

  conv3x3_bn_relu ← conv3x3_bn_relu_pallas — csrc/conv3x3.cu

    y = [ReLU](conv3×3_s1_p1(x, k) · scale + bias)

x is logically (B, Cin, H, W), stored channels_last; k the torch OIHW weight
(Cout, Cin, 3, 3); scale and bias the folded eval BN, f32. The rounding is
the TPU kernel's (conv3x3.py:36-65, :106-110), not the stem kernels': the
conv multiplies by k in x's dtype, *unscaled*, accumulates in f32, and only
then applies ·scale + bias, the ReLU and one rounding to x's dtype.
`conv3x3_bn_relu_plain` does that in f32 with library ops. The kernel takes
bf16 with Cin <= 64 and Cout % 8 == 0 (wgmma's N; JAX's kernel takes any
Cout), any B, H and W. On a CPU tensor the wrapper runs the plain version;
on a CUDA tensor it launches the kernel or raises. The kernel reads k as
`pack_conv3x3` lays it out; a caller that holds the weights (the conv3 route,
models/layers.py) packs once and passes the result as `wp`.
`conv3x3_bn_relu.launches` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mds_tpu_torch.ops.stem import (
    _check_aligned,
    _check_params,
    _conv,
    _is_cpu,
    _ptr,
    _raise_on,
    _stream,
    pack_sw128,
)

MAX_CIN = 64


def conv3x3_bn_relu_plain(x, k, scale, bias, relu=True):
    """f32 conv of x on k rounded to x's dtype, then ·scale + bias, [ReLU],
    rounded to x's dtype, channels_last."""
    y = _conv(x, k.to(x.dtype).float())
    y = y * scale.float().reshape(1, -1, 1, 1) + bias.float().reshape(1, -1, 1, 1)
    y = F.relu(y) if relu else y
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def pack_conv3x3(k):
    """bf16(k), unscaled, as csrc/conv3x3.cu reads it: pack_sw128's slices,
    [Cout/64][tap] each 64 output × 64 input channels, zero-padded."""
    return pack_sw128(k.to(torch.bfloat16))


def conv3x3_bn_relu(x, k, scale, bias, relu=True, wp=None):
    """x (B,Cin,H,W) bf16 channels_last, Cin <= 64; k (Cout,Cin,3,3) with
    Cout % 8 == 0 → (B,Cout,H,W) bf16 channels_last. `wp`: pack_conv3x3(k),
    made once; a CUDA launch packs k itself when it is None."""
    if _is_cpu(x):
        return conv3x3_bn_relu_plain(x, k, scale, bias, relu)
    name = "conv3x3_bn_relu"
    if x.dtype != torch.bfloat16 or x.dim() != 4:
        raise ValueError(f"{name}: x must be (B,C,H,W) bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    b, cin, h, w = x.shape
    cout = k.shape[0]
    if not 0 < cin <= MAX_CIN or tuple(k.shape) != (cout, cin, 3, 3) or cout % 8:
        raise ValueError(f"{name}: need Cin <= {MAX_CIN}, k (Cout,Cin,3,3) and "
                         f"Cout % 8 == 0, got x {tuple(x.shape)}, k {tuple(k.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: x must be channels_last contiguous")
    if cin % 8 == 0:
        _check_aligned(x, 16, name)
    _check_params(x, name, (k, scale, bias))
    from mds_tpu_torch.ops.build import load

    if wp is None:
        wp = pack_conv3x3(k)
    if wp.dtype != torch.bfloat16 or wp.numel() != -(-cout // 64) * 9 * 4096:
        raise ValueError(f"{name}: wp is not pack_conv3x3's layout of k")
    _check_params(x, name, (wp,))
    s, c = scale.float().contiguous(), bias.float().contiguous()
    out = torch.empty((b, cout, h, w), dtype=torch.bfloat16, device=x.device,
                      memory_format=torch.channels_last)
    err = load().mds_conv3x3_bn_relu(_ptr(x), _ptr(wp), _ptr(s), _ptr(c),
                                     _ptr(out), b, h, w, cin, cout, int(relu),
                                     _stream())
    _raise_on(err, name)
    conv3x3_bn_relu.launches += 1
    return out


conv3x3_bn_relu.launches = 0

KERNELS = (conv3x3_bn_relu,)
