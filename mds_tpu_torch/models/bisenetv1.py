"""BiSeNetV1 in PyTorch — counterpart of mds_tpu/models/bisenetv1.py.

Single-dataset: a ResNet18 ContextPath with attention refinement, a
SpatialPath, a feature fusion module and BiSeNetOutput heads (1 main, ×8;
2 aux, ×8 and ×16). Module names follow the reference torch layout
(mds_tpu/deploy/torch_import.py:766-820: `cp.resnet.*`, `cp.arm16.conv.conv`,
`sp.conv1.bn`, `ffm.convblk`, `conv_out.conv_out`, ...), so a reference
checkpoint loads strictly. Every BN is a plain BatchNorm2d evaluated in
flax's order and rounding (layers.bn_eval: in train mode flax's batch moments and
biased running variance at momentum 0.9); bf16 elementwise steps (the ARM
and FFM gates) round where JAX's bf16 graph does. With
set_stem_impl("kernel") the two bf16 7×7 RGB stems (ResNet18 conv1, the
SpatialPath's conv1) run as one CUDA kernel each in eval; in train mode
they take the library conv with the BN unfolded, as JAX's do
(mds_tpu/models/bisenetv1.py:43).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.models.layers import (
    PackCache,
    bn_eval,
    conv2d,
    conv_bn_relu,
    conv_init,
    global_avg_pool,
    lecun_init,
    upsample,
)
from mds_tpu_torch.models.resnet import Resnet18
from mds_tpu_torch.registry import MODELS

class ConvBNReLU1(nn.Module):
    """conv → single BN → ReLU (mds_tpu/models/bisenetv1.py:25-65); a 7×7
    s2 p3 conv on RGB takes the stem kernel route (layers.conv_bn_relu), its
    fold and packed weight kept once per parameter version (a PackCache)."""

    def __init__(self, in_chan: int, out_chan: int, ks: int = 3,
                 stride: int = 1, padding: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_chan, out_chan, ks, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out_chan)
        self.dtype = dtype
        self._packs = PackCache()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn_relu(self.conv, self.bn, x, self.dtype, self._packs)


class AttentionRefinementModule(nn.Module):
    """conv3×3 → GAP → 1×1 conv-BN → sigmoid gate
    (mds_tpu/models/bisenetv1.py:68-85)."""

    def __init__(self, in_chan: int, out_chan: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvBNReLU1(in_chan, out_chan, 3, dtype=dtype)
        self.conv_atten = nn.Conv2d(out_chan, out_chan, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(out_chan)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.conv(x)
        atten = conv2d(self.conv_atten, global_avg_pool(feat), self.dtype)
        return feat * torch.sigmoid(bn_eval(self.bn_atten, atten, self.dtype))


class ContextPath(nn.Module):
    """ResNet18 + ARM pyramid; returns the (x8, x16) features
    (mds_tpu/models/bisenetv1.py:88-118)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resnet = Resnet18(dtype)
        self.arm16 = AttentionRefinementModule(256, 128, dtype)
        self.arm32 = AttentionRefinementModule(512, 128, dtype)
        self.conv_head32 = ConvBNReLU1(128, 128, 3, dtype=dtype)
        self.conv_head16 = ConvBNReLU1(128, 128, 3, dtype=dtype)
        self.conv_avg = ConvBNReLU1(512, 128, 1, padding=0, dtype=dtype)

    def forward(self, x: torch.Tensor):
        _, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(global_avg_pool(feat32))
        feat32_up = self.conv_head32(upsample(self.arm32(feat32) + avg, 2))
        feat16_up = self.conv_head16(upsample(self.arm16(feat16) + feat32_up, 2))
        return feat16_up, feat32_up


class SpatialPath(nn.Module):
    """Three stride-2 convs and a 1×1 to 128 channels, /8
    (mds_tpu/models/bisenetv1.py:121-131)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNReLU1(3, 64, 7, 2, 3, dtype)
        self.conv2 = ConvBNReLU1(64, 64, 3, 2, 1, dtype)
        self.conv3 = ConvBNReLU1(64, 64, 3, 2, 1, dtype)
        self.conv_out = ConvBNReLU1(64, 128, 1, 1, 0, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv3(self.conv2(self.conv1(x))))


class FeatureFusionModule(nn.Module):
    """concat → 1×1 conv-BN-ReLU → GAP-gated residual
    (mds_tpu/models/bisenetv1.py:134-153)."""

    def __init__(self, in_chan: int, out_chan: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.convblk = ConvBNReLU1(in_chan, out_chan, 1, 1, 0, dtype)
        self.conv = nn.Conv2d(out_chan, out_chan, 1, bias=False)
        self.bn = nn.BatchNorm2d(out_chan)
        self.dtype = dtype

    def forward(self, fsp: torch.Tensor, fcp: torch.Tensor) -> torch.Tensor:
        feat = self.convblk(torch.cat([fsp, fcp], dim=1))
        atten = conv2d(self.conv, global_avg_pool(feat), self.dtype)
        atten = torch.sigmoid(bn_eval(self.bn, atten, self.dtype))
        return feat * atten + feat


class BiSeNetOutput(nn.Module):
    """conv3×3-BN-ReLU → 1×1 conv with bias → bilinear ×up_factor in f32
    (jax.image.resize "linear": half-pixel, no antialias when enlarging), or
    left at head resolution with up=False (mds_tpu/models/bisenetv1.py:156-178)."""

    def __init__(self, in_chan: int, mid_chan: int, n_classes: int,
                 up_factor: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvBNReLU1(in_chan, mid_chan, 3, dtype=dtype)
        self.conv_out = nn.Conv2d(mid_chan, n_classes, 1, bias=True)
        self.up_factor = up_factor
        self.dtype = dtype

    def forward(self, x: torch.Tensor, up: bool = True) -> torch.Tensor:
        x = conv2d(self.conv_out, self.conv(x), self.dtype)
        if not up:
            return x
        h, w = x.shape[-2:]
        return F.interpolate(x.float(), size=(h * self.up_factor, w * self.up_factor),
                             mode="bilinear", align_corners=False)


@MODELS.register("bisenetv1")
class BiSeNetV1(nn.Module):
    """BiSeNetV1 (mds_tpu/models/bisenetv1.py:181-239). Single-dataset as
    in the reference; `n_classes` is a 1-tuple and n_bn must be 1, for the
    factory signature BiSeNetV2 shares. Params stay f32, the compute runs in
    `dtype`; inputs (B, 3, H, W), best stored channels_last."""

    def __init__(self, n_classes: Sequence[int] = (19,), n_bn: int = 1,
                 aux: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_bn != 1 or len(n_classes) != 1:
            raise ValueError("BiSeNetV1 is single-dataset in the reference: "
                             f"got n_classes={tuple(n_classes)}, n_bn={n_bn}")
        n = n_classes[0]
        self.cp = ContextPath(dtype)
        self.sp = SpatialPath(dtype)
        self.ffm = FeatureFusionModule(256, 256, dtype)
        self.conv_out = BiSeNetOutput(256, 256, n, up_factor=8, dtype=dtype)
        if aux:
            self.conv_out16 = BiSeNetOutput(128, 64, n, up_factor=8, dtype=dtype)
            self.conv_out32 = BiSeNetOutput(128, 64, n, up_factor=16, dtype=dtype)
        self.n_classes = tuple(n_classes)
        self.n_bn = 1
        self.aux = aux
        self.dtype = dtype

    def _features(self, x: torch.Tensor):
        """(fused feature, ContextPath's x8, its x16)."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        feat_cp8, feat_cp16 = self.cp(x)
        return self.ffm(self.sp(x), feat_cp8), feat_cp8, feat_cp16

    def forward(self, xs, up: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict:
        """The list-form call of the JAX model (xs = [x];
        mds_tpu/models/bisenetv1.py:212-232): the main logits under
        "logits"; in train mode with aux heads the two aux heads' under
        "aux" as [[x8 head], [x16 head]]. up=False leaves every head at 1/8
        or 1/16 and adds "up_factors" = (main factor, [aux factors]).
        `generator` is taken for the trainers' common call: V1 has no
        dropout."""
        x = xs[0] if isinstance(xs, (list, tuple)) else xs
        feat, feat_cp8, feat_cp16 = self._features(x)
        out = {"logits": [self.conv_out(feat, up)]}
        if not up:
            out["up_factors"] = (self.conv_out.up_factor,
                                 [self.conv_out16.up_factor, self.conv_out32.up_factor]
                                 if self.aux else [])
        if self.aux and self.training:
            out["aux"] = [[self.conv_out16(feat_cp8, up)], [self.conv_out32(feat_cp16, up)]]
        return out

    def eval_logits(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """Main logits (B, C, H, W) in f32 at input resolution."""
        return self.conv_out(self._features(x)[0])

    def pred(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """Argmax label map (B, H, W)."""
        return self.eval_logits(x, dataset).argmax(dim=1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BiSeNetV1":
        """Seeded random init: kaiming fan-out for every conv followed by a
        BN, lecun normal for the ARM and FFM attention convs and the heads'
        conv_out, zero biases, unit BN."""
        plain = [self.ffm.conv, self.cp.arm16.conv_atten, self.cp.arm32.conv_atten]
        plain += [m.conv_out for m in self.modules() if isinstance(m, BiSeNetOutput)]
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                if any(m is p for p in plain):
                    lecun_init(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                else:
                    conv_init(m.weight, generator)
        return self
