"""SwiftNet-pyramid ResNet18 backbone ("snp") — counterpart of
mds_tpu/models/swiftnet.py (`SharedListBN` :44, `BasicBlock` :186,
`bicubic_downsample` :255, `UpsampleBlend` :266, `SwiftNetPyramid` :292).

- The ResNet18 trunk runs once per image-pyramid level (1, 1/2, 1/4 of the
  input, bicubic) with one BN stat set per level; each pass gives 4 skips
  (the pre-ReLU residual outputs of layer1-4) projected to `num_features`
  by 1×1 bottlenecks, summed into shifted slots across levels; a chain of
  upsample-add-BN-ReLU-conv3×3 blends decodes them to 1/4 resolution.
- Activations flow as per-dataset lists where an absent dataset is None.
  Every BN normalizes with the joint moments of the whole list (the
  reference's BN on the stacked batch), not per dataset.
- Module and buffer names are the reference torch layout (the inverse of
  mds_tpu/deploy/torch_import.py `swiftnet_backbone_from_torch` :283):
  `conv1`, `bn1.{level}`, `layer{1..4}.{b}.{conv1,bn1.{level},conv2,
  bn2.{level},downsample.{0,1}}`, `upsample_bottlenecks.{j}` (j = 0 is
  layer4's), `upsample_blends.{i}.blend_conv.{norm,conv}`. Each stat set is
  one BatchNorm2d, so a level's running stats are tensors of their own.
- `remat` (the config's `network.efficient`, on by default as in JAX)
  recomputes each residual block in the backward (torch.utils.checkpoint);
  the recompute leaves the BN running stats as the forward moved them.
- Eval with set_stem_impl("kernel") on a bf16 3-channel input: each pyramid
  level's 7×7 s2 stem conv + its own level's BN + ReLU runs as kernel 6
  (ops/stem.py stem7_conv_bn_relu_s2) with that level's BN folded in,
  where the level's H and W are even (JAX's `fuse7` at :314-334, without
  its W ≥ 512 Mosaic guard). The fold and the packed weight are cached per
  level (`PackCache` entries "fold/{level}" and "stem7/{level}") until the
  conv weight or one of that level's BN tensors changes.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mds_tpu_torch.models.layers import (
    MultiX,
    PackCache,
    _c,
    bn_fold,
    conv2d,
    conv_init,
    get_stem_impl,
    lmap,
    lmap2,
    max_pool_3x3_s2,
    resize_bilinear,
    wide,
)

# True while a remat block recomputes its forward for the backward: the BN
# running stats were moved by the forward already
_STATS_FROZEN = False


@contextlib.contextmanager
def _frozen_stats(frozen: bool):
    global _STATS_FROZEN
    before, _STATS_FROZEN = _STATS_FROZEN, frozen
    try:
        yield
    finally:
        _STATS_FROZEN = before


class SharedListBN(nn.BatchNorm2d):
    """One BN stat set over a per-dataset list (mds_tpu/models/swiftnet.py:44
    in its shared mode; a pyramid level's set is one of these). f32 below
    means `wide`: f64 in an f64 model.

    Train: the joint moments of every non-None entry, s1 and s2 summed in
    f32 over the list, m = s1/N, v = max(s2/N − m², 0); the gradient flows
    through them; the running mean and variance move by momentum 0.1, the
    variance with the unbiased v·N/max(N − 1, 1). Eval: the running stats.
    Both: y = ((x − m)·rsqrt(v + eps))·scale + bias in f32, cast to
    `dtype`."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32,
                 eps: float = 1e-5):
        super().__init__(features, eps=eps, momentum=0.1)
        self.dtype = dtype

    def forward(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        live = [x for x in xs if x is not None]
        if not live:
            raise ValueError("SharedListBN needs at least one input")
        if self.training:
            total = sum(x.numel() // x.shape[1] for x in live)
            s1 = sum(wide(x).sum(dim=(0, 2, 3)) for x in live)
            s2 = sum(wide(x).square().sum(dim=(0, 2, 3)) for x in live)
            m = s1 / total
            v = torch.clamp(s2 / total - m.square(), min=0.0)
            if not _STATS_FROZEN:
                mom = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_((1 - mom) * self.running_mean + mom * m)
                    self.running_var.copy_((1 - mom) * self.running_var
                                           + mom * (v * (total / max(total - 1, 1))))
        else:
            m, v = self.running_mean, self.running_var
        inv = torch.rsqrt(v + self.eps)

        def norm(x):
            y = (wide(x) - _c(m)) * _c(inv)
            return (y * _c(self.weight) + _c(self.bias)).to(self.dtype)

        return lmap(norm, xs)


def _levels(features: int, n: int, dtype: torch.dtype) -> nn.ModuleList:
    """One SharedListBN per pyramid level (the reference's ModuleList)."""
    return nn.ModuleList(SharedListBN(features, dtype) for _ in range(n))


def _relu(xs: MultiX) -> List[Optional[torch.Tensor]]:
    return lmap(F.relu, xs)


class BasicBlock(nn.Module):
    """ResNet BasicBlock with one BN set per level; returns (relu output,
    pre-ReLU skip) (mds_tpu/models/swiftnet.py:186-221). The downsample BN
    is one set for every level, the reference's quirk that JAX keeps."""

    def __init__(self, in_chan: int, planes: int, stride: int = 1,
                 use_downsample: bool = False, levels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chan, planes, 3, stride, 1, bias=False)
        self.bn1 = _levels(planes, levels, dtype)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _levels(planes, levels, dtype)
        self.downsample = None
        if use_downsample:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_chan, planes, 1, stride, bias=False),
                SharedListBN(planes, dtype))
        self.dtype = dtype

    def forward(self, xs: MultiX, level: int):
        conv = lambda c: (lambda x: conv2d(c, x, self.dtype))
        out = _relu(self.bn1[level](lmap(conv(self.conv1), xs)))
        out = self.bn2[level](lmap(conv(self.conv2), out))
        residual = xs
        if self.downsample is not None:
            dconv, dbn = self.downsample
            residual = dbn(lmap(conv(dconv), xs))
        skip = lmap2(torch.add, out, residual)
        return _relu(skip), skip


# torch's bicubic (a = −0.75, align_corners=False) at an even factor f is
# JAX's 4-tap edge-padded filter (−0.09375, 0.59375, 0.59375, −0.09375)
def bicubic_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """F.interpolate(mode='bicubic', align_corners=False) at 1/factor on an
    f32 copy, cast back: the reference's pyramid_subsample
    (mds_tpu/models/swiftnet.py:255-263). The sample spacing is `factor`
    whatever the size (scale_factor, not a size), as JAX's taps."""
    if factor % 2:
        raise ValueError(f"bicubic_downsample needs an even factor, got {factor}")
    y = F.interpolate(wide(x), scale_factor=1.0 / factor, mode="bicubic",
                      align_corners=False, recompute_scale_factor=False)
    return y.to(x.dtype)


class _BNReluConv(nn.Module):
    """BN → ReLU → conv (the reference's _BNReluConv order and names)."""

    def __init__(self, in_chan: int, out_chan: int, k: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.norm = SharedListBN(in_chan, dtype)
        self.conv = nn.Conv2d(in_chan, out_chan, k, 1, k // 2, bias=bias)
        self.dtype = dtype

    def forward(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        return lmap(lambda x: conv2d(self.conv, x, self.dtype), _relu(self.norm(xs)))


class UpsampleBlend(nn.Module):
    """upsample to the skip's size → add the skip → BN-ReLU-conv3×3
    (mds_tpu/models/swiftnet.py:266-289)."""

    def __init__(self, num_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blend_conv = _BNReluConv(num_features, num_features, 3, False, dtype)

    def forward(self, xs: MultiX, skips: MultiX) -> List[Optional[torch.Tensor]]:
        size = next(s.shape[-2:] for s in skips if s is not None)
        xs = lmap(lambda x: resize_bilinear(x, size), xs)
        return self.blend_conv(lmap2(torch.add, xs, skips))


class SwiftNetPyramid(nn.Module):
    """ResNet18 pyramid encoder-decoder, output stride 4
    (mds_tpu/models/swiftnet.py:292-425)."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), num_features: int = 128,
                 pyramid_levels: int = 3, planes: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        lvls = pyramid_levels
        self.conv1 = nn.Conv2d(3, planes[0], 7, 2, 3, bias=False)
        self.bn1 = _levels(planes[0], lvls, dtype)
        in_chan = planes[0]
        for li, (p, n) in enumerate(zip(planes, layers)):
            blocks = []
            for bi in range(n):
                stride = 2 if (bi == 0 and li > 0) else 1
                blocks.append(BasicBlock(in_chan, p, stride, li > 0 and bi == 0,
                                         lvls, dtype))
                in_chan = p
            setattr(self, f"layer{li + 1}", nn.ModuleList(blocks))
        self.upsample_bottlenecks = nn.ModuleList(
            nn.Conv2d(p, num_features, 1, bias=False) for p in reversed(planes))
        self.upsample_blends = nn.ModuleList(
            UpsampleBlend(num_features, dtype) for _ in range(2 + lvls))
        self.pyramid_levels = lvls
        self.dtype = dtype
        self.remat = remat
        self._packs = PackCache()

    def stem_kernel_ok(self, x: torch.Tensor) -> bool:
        """Whether a level's input takes kernel 6: eval with
        set_stem_impl("kernel"), bf16 compute, 3 channels, even H and W, and
        an output width the kernel takes (O % 8 == 0, O <= 128)."""
        o = self.conv1.out_channels
        return (not self.training and get_stem_impl() == "kernel"
                and self.dtype == torch.bfloat16 and x.shape[1] == 3
                and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
                and o % 8 == 0 and o <= 128)

    def _stem7(self, x: torch.Tensor, level: int) -> torch.Tensor:
        """Kernel 6 with level `level`'s BN folded in; the fold and the
        packed weight (a CUDA input's only) cached per level."""
        from mds_tpu_torch.ops.stem import pack_stem7, stem7_conv_bn_relu_s2

        bn, conv = self.bn1[level], self.conv1
        stats = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
        scale, bias = self._packs.get(f"fold/{level}", stats, lambda: bn_fold(bn))
        packed = None if x.device.type == "cpu" else self._packs.get(
            f"stem7/{level}", (conv.weight, *stats),
            lambda: pack_stem7(conv.weight, scale, bias))
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return stem7_conv_bn_relu_s2(x, conv.weight, scale, bias, packed=packed)

    def _stem(self, xs: MultiX, level: int) -> List[Optional[torch.Tensor]]:
        if all(x is None or self.stem_kernel_ok(x) for x in xs):
            return [None if x is None else self._stem7(x, level) for x in xs]
        xs = lmap(lambda x: conv2d(self.conv1, x, self.dtype), xs)
        return _relu(self.bn1[level](xs))

    def _block(self, blk: BasicBlock, xs: MultiX, level: int):
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return blk(xs, level)
        first = [True]

        def run(*xs):
            with _frozen_stats(not first[0]):
                first[0] = False
                return blk(list(xs), level)

        return checkpoint(run, *xs, use_reentrant=False)

    def forward(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        lvls = self.pyramid_levels
        stages = [getattr(self, f"layer{i + 1}") for i in range(4)]
        slot_sums: List[Optional[List]] = [None] * (lvls + 3)
        pyramid = [list(xs)] + [lmap(lambda x, f=2 ** l: bicubic_downsample(x, f), xs)
                                for l in range(1, lvls)]
        for idx, p in enumerate(pyramid):
            x = lmap(max_pool_3x3_s2, self._stem(p, idx))
            feats = []
            for stage in stages:
                skip = None
                for blk in stage:
                    x, skip = self._block(blk, x, idx)
                feats.append(skip)
            # bottleneck j projects layer (4 − j); the skip of layer i goes
            # to slot idx + i − 1
            for i, f in enumerate(feats):
                s = lmap(lambda t, c=self.upsample_bottlenecks[3 - i]: conv2d(c, t, self.dtype), f)
                slot = idx + i
                slot_sums[slot] = s if slot_sums[slot] is None else lmap2(
                    torch.add, slot_sums[slot], s)
        slot_sums = slot_sums[::-1]  # deepest first
        x = slot_sums[0]
        for i, blend in enumerate(self.upsample_blends):
            x = blend(x, slot_sums[i + 1])
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SwiftNetPyramid":
        """Kaiming fan-out for every conv (mds_tpu/models/swiftnet.py
        conv_init), unit BN."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                conv_init(m.weight, generator)
            elif isinstance(m, SharedListBN):
                m.reset_parameters()
        return self
