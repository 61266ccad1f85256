"""BiSeNetV2 in PyTorch — counterpart of mds_tpu/models/bisenetv2.py.

Multi-dataset: every ConvBNReLU holds per-dataset BN stats with a shared
affine pair (or a per-dataset affine, `bisenetv2_origin`), and each dataset
has its own heads. Activations are per-dataset lists; `forward` is the train
call (main and aux logits per dataset), `eval_logits` and `pred` take one
dataset's NCHW batch. In eval, with `set_detail_fuse(True)` and a bf16
compute dtype, the DetailBranch's first three convs and the whole StemBlock
run as one CUDA kernel each (ops/stem.py), and with `set_detail_tail(True)`
too the DetailBranch's last five convs as one more; `set_depthwise_impl(
"kernel")` runs the 16 depthwise convs as ops/depthwise.py's kernel and
`set_pred_impl("fused")` the pred tail as ops/upsample_argmax.py's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.models.layers import (
    ConvBN,
    ConvBNReLU,
    DatasetNorm,
    MultiX,
    PackCache,
    SegmentHead,
    as_multi,
    avg_pool_3x3_s2,
    conv2d,
    conv_init,
    get_detail_fuse,
    get_detail_tail,
    get_pred_impl,
    global_avg_pool,
    lecun_init,
    lmap,
    lmap2,
    max_pool_3x3_s2,
    upsample,
)
from mds_tpu_torch.registry import MODELS


def _fusable(module: nn.Module, xs: MultiX) -> bool:
    """The deploy fusions run in eval only, on bf16 RGB with H and W
    divisible by 4 (mds_tpu/models/bisenetv2.py:59-67)."""
    return (not module.training and get_detail_fuse()
            and module.dtype == torch.bfloat16) and all(
        x is None or (x.shape[1] == 3 and x.shape[2] % 4 == 0
                      and x.shape[3] % 4 == 0)
        for x in xs)


def _pack_cached(owner, name, modules, i, pack, params, x):
    """pack(*params) for dataset i, once per parameter version of the
    modules' conv weights and BN tensors (owner's PackCache); None for a CPU
    x, whose plain version reads no pack."""
    if x.device.type == "cpu":
        return None
    srcs = [t for m in modules
            for t in (m.conv.weight, *m.bn.tensors_at(i, m._shared()))]
    return owner._packs.get((name, i), srcs, lambda: pack(*params))


class DetailBranch(nn.Module):
    """High-resolution detail path (mds_tpu/models/bisenetv2.py:42)."""

    def __init__(self, n_bn=1, shared_affine=True, dtype=torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, shared_affine=shared_affine, dtype=dtype)
        self.S1_1 = ConvBNReLU(3, 64, 3, stride=2, **cfg)
        self.S1_2 = ConvBNReLU(64, 64, 3, **cfg)
        self.S2_1 = ConvBNReLU(64, 64, 3, stride=2, **cfg)
        self.S2_2 = ConvBNReLU(64, 64, 3, **cfg)
        self.S2_3 = ConvBNReLU(64, 64, 3, **cfg)
        self.S3_1 = ConvBNReLU(64, 128, 3, stride=2, **cfg)
        self.S3_2 = ConvBNReLU(128, 128, 3, **cfg)
        self.S3_3 = ConvBNReLU(128, 128, 3, **cfg)
        self.dtype = dtype
        self._packs = PackCache()

    def forward(self, xs: MultiX):
        if _fusable(self, xs):
            xs = [None if x is None else self._head_fused(x.to(self.dtype), i)
                  for i, x in enumerate(xs)]
            # the tail: S2_2 … S3_3 as one kernel on the /4 output, whose H4
            # and W4 must be even (H, W divisible by 8; JAX asks H4 % 16 == 0
            # for its tile, mds_tpu/models/bisenetv2.py:98-119)
            if get_detail_tail() and all(
                    x is None or (x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)
                    for x in xs):
                return [None if x is None else self._tail_fused(x, i)
                        for i, x in enumerate(xs)]
        else:
            xs = self.S2_1(self.S1_2(self.S1_1(xs)))
        for layer in self._tail():
            xs = layer(xs)
        return xs

    def _head(self):
        return (self.S1_1, self.S1_2, self.S2_1)

    def _tail(self):
        return (self.S2_2, self.S2_3, self.S3_1, self.S3_2, self.S3_3)

    def _head_fused(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Dataset i's input through the head kernel (S1_1, S1_2, S2_1), its
        folds and packed weights made once per parameter version."""
        from mds_tpu_torch.ops.stem import detail_s1s2_fused, pack_detail_head

        params = [t for m in self._head()
                  for t in (m.conv.weight, *m.fold_cached(i))]
        packed = _pack_cached(self, "head", self._head(), i, pack_detail_head, params, x)
        return detail_s1s2_fused(x, *params, packed)

    def _tail_fused(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Dataset i's /4 feature through the tail kernel, its weights folded
        and packed once per parameter version (PackCache, keyed on every
        conv weight and BN tensor of the five modules and on i)."""
        from mds_tpu_torch.ops.stem import detail_tail_fused, pack_detail_tail

        params = [t for m in self._tail()
                  for t in (m.conv.weight, *m.fold_cached(i))]
        packed = _pack_cached(self, "tail", self._tail(), i, pack_detail_tail, params, x)
        return detail_tail_fused(x, *params, packed)


class StemBlock(nn.Module):
    """Stem: conv ×2↓ then conv path ‖ maxpool, fuse
    (mds_tpu/models/bisenetv2.py:128). Fused (see the module docstring), its
    folds and packed weights are made once per parameter version."""

    def __init__(self, n_bn=1, shared_affine=True, dtype=torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, shared_affine=shared_affine, dtype=dtype)
        self.conv = ConvBNReLU(3, 16, 3, stride=2, **cfg)
        self.left_1 = ConvBNReLU(16, 8, 1, **cfg)
        self.left_2 = ConvBNReLU(8, 16, 3, stride=2, **cfg)
        self.fuse = ConvBNReLU(32, 16, 3, **cfg)
        self.dtype = dtype
        self._packs = PackCache()

    def _convs(self):
        return (self.conv, self.left_1, self.left_2, self.fuse)

    def _fused(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """Dataset i's input through the StemBlock kernel (PackCache keyed on
        the four modules' conv weights and BN tensors and on i)."""
        from mds_tpu_torch.ops.stem import pack_stemblock, stemblock_fused

        params = [t for m in self._convs() for t in (m.conv.weight, *m.fold_cached(i))]
        packed = _pack_cached(self, "stemblock", self._convs(), i, pack_stemblock, params, x)
        return stemblock_fused(x, *params, packed=packed)

    def forward(self, xs: MultiX):
        if _fusable(self, xs):
            return [None if x is None else self._fused(x.to(self.dtype), i)
                    for i, x in enumerate(xs)]
        xs = self.conv(xs)
        left = self.left_2(self.left_1(xs))
        right = lmap(max_pool_3x3_s2, xs)
        return self.fuse(lmap2(lambda a, b: torch.cat([a, b], dim=1),
                               left, right))


class CEBlock(nn.Module):
    """Context embedding: GAP → per-dataset BN with its own affine → 1×1
    conv → broadcast add → 3×3 conv (mds_tpu/models/bisenetv2.py:187)."""

    def __init__(self, n_bn=1, shared_affine=True, dtype=torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, shared_affine=shared_affine, dtype=dtype)
        self.bn = DatasetNorm(128, n_bn, affine=True, dtype=dtype)
        self.conv_gap = ConvBNReLU(128, 128, 1, **cfg)
        self.conv_last = ConvBNReLU(128, 128, 3, **cfg)

    def forward(self, xs: MultiX):
        gap = self.conv_gap(self.bn(lmap(global_avg_pool, xs)))
        return self.conv_last(lmap2(lambda x, g: x + g, xs, gap))


class GELayerS1(nn.Module):
    """Gather-expand layer, stride 1 (mds_tpu/models/bisenetv2.py:209)."""

    def __init__(self, in_chan, out_chan, exp_ratio=6, n_bn=1,
                 shared_affine=True, dtype=torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, shared_affine=shared_affine, dtype=dtype)
        mid = in_chan * exp_ratio
        self.conv1 = ConvBNReLU(in_chan, in_chan, 3, **cfg)
        self.dwconv = ConvBNReLU(in_chan, mid, 3, groups=in_chan, **cfg)
        self.conv2 = ConvBN(mid, out_chan, 1, **cfg)

    def forward(self, xs: MultiX):
        f = self.conv2(self.dwconv(self.conv1(xs)))
        return lmap2(lambda a, b: F.relu(a + b), f, xs)


class GELayerS2(nn.Module):
    """Gather-expand layer, stride 2, depthwise shortcut
    (mds_tpu/models/bisenetv2.py:229)."""

    def __init__(self, in_chan, out_chan, exp_ratio=6, n_bn=1,
                 shared_affine=True, dtype=torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, shared_affine=shared_affine, dtype=dtype)
        mid = in_chan * exp_ratio
        self.conv1 = ConvBNReLU(in_chan, in_chan, 3, **cfg)
        self.dwconv1 = ConvBN(in_chan, mid, 3, stride=2, groups=in_chan, **cfg)
        self.dwconv2 = ConvBN(mid, mid, 3, groups=mid, **cfg)
        self.conv2 = ConvBN(mid, out_chan, 1, **cfg)
        self.shortcut_1 = ConvBN(in_chan, in_chan, 3, stride=2, groups=in_chan,
                                 **cfg)
        self.shortcut_2 = ConvBN(in_chan, out_chan, 1, **cfg)

    def forward(self, xs: MultiX):
        f = self.conv2(self.dwconv2(self.dwconv1(self.conv1(xs))))
        s = self.shortcut_2(self.shortcut_1(xs))
        return lmap2(lambda a, b: F.relu(a + b), f, s)


class SegmentBranch(nn.Module):
    """Semantic path: stem + GE stages + context embedding
    (mds_tpu/models/bisenetv2.py:253)."""

    def __init__(self, n_bn=1, shared_affine=True, dtype=torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, shared_affine=shared_affine, dtype=dtype)
        self.S1S2 = StemBlock(**cfg)
        self.S3_1 = GELayerS2(16, 32, **cfg)
        self.S3_2 = GELayerS1(32, 32, **cfg)
        self.S4_1 = GELayerS2(32, 64, **cfg)
        self.S4_2 = GELayerS1(64, 64, **cfg)
        self.S5_4_1 = GELayerS2(64, 128, **cfg)
        self.S5_4_2 = GELayerS1(128, 128, **cfg)
        self.S5_4_3 = GELayerS1(128, 128, **cfg)
        self.S5_4_4 = GELayerS1(128, 128, **cfg)
        self.S5_5 = CEBlock(**cfg)

    def forward(self, xs: MultiX):
        feat2 = self.S1S2(xs)
        feat3 = self.S3_2(self.S3_1(feat2))
        feat4 = self.S4_2(self.S4_1(feat3))
        feat5 = self.S5_4_1(feat4)
        for layer in (self.S5_4_2, self.S5_4_3, self.S5_4_4):
            feat5 = layer(feat5)
        return feat2, feat3, feat4, feat5, self.S5_5(feat5)


class BGALayer(nn.Module):
    """Bilateral guided aggregation (mds_tpu/models/bisenetv2.py:277)."""

    def __init__(self, n_bn=1, shared_affine=True, dtype=torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, shared_affine=shared_affine, dtype=dtype)
        self.left1_convbn = ConvBN(128, 128, 3, groups=128, **cfg)
        self.left1_conv = nn.Conv2d(128, 128, 1, bias=False)
        self.left2_convbn = ConvBN(128, 128, 3, stride=2, **cfg)
        self.right1 = ConvBN(128, 128, 3, **cfg)
        self.right2_convbn = ConvBN(128, 128, 3, groups=128, **cfg)
        self.right2_conv = nn.Conv2d(128, 128, 1, bias=False)
        self.conv = ConvBNReLU(128, 128, 3, **cfg)
        self.dtype = dtype

    def forward(self, x_d: MultiX, x_s: MultiX):
        left1 = lmap(lambda x: conv2d(self.left1_conv, x, self.dtype),
                     self.left1_convbn(x_d))
        left2 = lmap(avg_pool_3x3_s2, self.left2_convbn(x_d))
        right1 = lmap(lambda x: upsample(x, 4, "nearest"), self.right1(x_s))
        right2 = lmap(lambda x: conv2d(self.right2_conv, x, self.dtype),
                      self.right2_convbn(x_s))
        left = lmap2(lambda a, b: a * torch.sigmoid(b), left1, right1)
        right = lmap2(lambda a, b: a * torch.sigmoid(b), left2, right2)
        right = lmap(lambda x: upsample(x, 4, "nearest"), right)
        return self.conv(lmap2(lambda a, b: a + b, left, right))


@MODELS.register("bisenetv2")
class BiSeNetV2(nn.Module):
    """Multi-dataset BiSeNetV2 (mds_tpu/models/bisenetv2.py:308).

    n_classes: per-dataset class counts (n_datasets = n_bn). Inputs are
    (B, 3, H, W), best stored channels_last; params stay f32 and the compute
    runs in `dtype`."""

    def __init__(self, n_classes: Sequence[int], n_bn: int = 1, aux: bool = True,
                 shared_affine: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, shared_affine=shared_affine, dtype=dtype)
        self.detail = DetailBranch(**cfg)
        self.segment = SegmentBranch(**cfg)
        self.bga = BGALayer(**cfg)
        self.head = nn.ModuleList(
            SegmentHead(128, 1024, n, up_factor=8, aux=False, dtype=dtype)
            for n in n_classes)
        if aux:
            for name, c_in, up in (("aux2", 16, 4), ("aux3", 32, 8),
                                   ("aux4", 64, 16), ("aux5_4", 128, 32)):
                setattr(self, name, nn.ModuleList(
                    SegmentHead(c_in, 128, n, up_factor=up, dtype=dtype)
                    for n in n_classes))
        self.n_classes = tuple(n_classes)
        self.aux = aux
        self.n_bn = n_bn
        self.dtype = dtype

    def backbone(self, xs: MultiX):
        xs = lmap(lambda x: x.to(self.dtype).contiguous(
            memory_format=torch.channels_last), xs)
        feat_d = self.detail(xs)
        feat2, feat3, feat4, feat5_4, feat_s = self.segment(xs)
        return self.bga(feat_d, feat_s), (feat2, feat3, feat4, feat5_4)

    def forward(self, xs: MultiX, up: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict:
        """The train call (mds_tpu/models/bisenetv2.py:346-377): per-dataset
        lists (None for an absent dataset) of main logits under "logits" and,
        in train mode with aux heads, the 4 aux heads' under "aux". up=False
        leaves every head at its own resolution and adds "up_factors" =
        (main factor, [aux factors]). `generator` seeds the dropout masks."""
        feat_head, feats_aux = self.backbone(xs)
        out = {"logits": [
            None if p is None else self.head[i](p, up, generator)
            for i, p in enumerate(feat_head)]}
        heads = [self.aux2, self.aux3, self.aux4, self.aux5_4] if self.aux else []
        if not up:
            out["up_factors"] = (self.head[0].residual_factor,
                                 [h[0].residual_factor for h in heads])
        if heads and self.training:
            out["aux"] = [
                [None if p is None else hs[i](p, up, generator)
                 for i, p in enumerate(feat)]
                for hs, feat in zip(heads, feats_aux)]
        return out

    def eval_logits(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """Main logits for one dataset at input resolution (B, C, H, W)."""
        feat_head, _ = self.backbone(as_multi(x, dataset, self.n_bn))
        return self.head[dataset](feat_head[dataset])

    def pred(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """Argmax label map (B, H, W). With set_pred_impl("fused") the head
        stays at its resolution and the ×8 bilinear upsample and the argmax
        run as one pass that writes only the int32 labels
        (ops/upsample_argmax.py; mds_tpu/models/bisenetv2.py:385-400)."""
        if get_pred_impl() == "fused":
            from mds_tpu_torch.ops.upsample_argmax import upsample_argmax

            feat_head, _ = self.backbone(as_multi(x, dataset, self.n_bn))
            head = self.head[dataset]
            logits = head(feat_head[dataset], up=False)
            return upsample_argmax(
                logits.contiguous(memory_format=torch.channels_last),
                head.residual_factor)
        return self.eval_logits(x, dataset).argmax(dim=1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BiSeNetV2":
        """Seeded random init of every conv, the aux heads' included:
        kaiming fan-out for the BN'd convs, lecun normal for the plain convs,
        zero biases, unit BN."""
        for m in self.modules():
            if isinstance(m, ConvBNReLU):
                conv_init(m.conv.weight, generator)
            elif isinstance(m, SegmentHead):
                lecun_init(m.conv2.weight, generator)
                m.conv2.bias.zero_()
        lecun_init(self.bga.left1_conv.weight, generator)
        lecun_init(self.bga.right2_conv.weight, generator)
        return self


@MODELS.register("bisenetv2_origin")
def bisenetv2_origin(n_classes, n_bn=1, dtype=torch.float32, **kw):
    """Per-dataset BN with its own affine (mds_tpu/models/bisenetv2.py:403)."""
    return BiSeNetV2(n_classes=n_classes, n_bn=n_bn, shared_affine=False,
                     dtype=dtype, **kw)
