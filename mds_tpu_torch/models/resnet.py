"""ResNet18 feature trunk of BiSeNetV1 — counterpart of mds_tpu/models/resnet.py.

Single-BN, torchvision layout (`conv1`, `bn1`, `layer{1..4}.{0,1}.conv1/bn1/
conv2/bn2`, `downsample.0/1`), so a torchvision or reference checkpoint
loads strictly. Every BN is a plain BatchNorm2d run in flax's order and
rounding, in train mode with flax's semantics (layers.bn_eval). In eval
with set_stem_impl("kernel") the bf16 7×7 stem conv1 + bn1 + ReLU runs as
one CUDA kernel, its fold and packed weight kept once per parameter
version (a PackCache).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.models.layers import (
    PackCache,
    bn_eval,
    conv2d,
    conv_bn_relu,
    max_pool_3x3_s2,
)


class BasicBlock(nn.Module):
    """conv3×3-BN-ReLU-conv3×3-BN + shortcut (1×1 conv-BN where the shape
    changes), ReLU (mds_tpu/models/resnet.py:21-46)."""

    def __init__(self, in_chan: int, out_chan: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chan, out_chan, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(out_chan)
        self.conv2 = nn.Conv2d(out_chan, out_chan, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(out_chan)
        self.downsample = None
        if in_chan != out_chan or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_chan, out_chan, 1, stride, bias=False),
                nn.BatchNorm2d(out_chan))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = conv_bn_relu(self.conv1, self.bn1, x, self.dtype)
        r = bn_eval(self.bn2, conv2d(self.conv2, r, self.dtype), self.dtype)
        s = x
        if self.downsample is not None:
            conv, bn = self.downsample
            s = bn_eval(bn, conv2d(conv, x, self.dtype), self.dtype)
        return F.relu(s + r)


class Resnet18(nn.Module):
    """7×7 s2 stem → 3×3 s2 max pool → 4 stages of 2 BasicBlocks; returns
    (feat8, feat16, feat32) (mds_tpu/models/resnet.py:49-104)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        chans = (64, 64, 128, 256, 512)
        for i in range(1, 5):
            stride = 1 if i == 1 else 2
            setattr(self, f"layer{i}", nn.Sequential(
                BasicBlock(chans[i - 1], chans[i], stride, dtype),
                BasicBlock(chans[i], chans[i], 1, dtype)))
        self.dtype = dtype
        self._packs = PackCache()

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
        x = max_pool_3x3_s2(conv_bn_relu(self.conv1, self.bn1, x, self.dtype,
                                          self._packs))
        feat8 = self.layer2(self.layer1(x))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)
