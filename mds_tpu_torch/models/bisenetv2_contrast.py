"""BiSeNetV2 with the pixel-contrast heads — counterpart of
mds_tpu/models/bisenetv2_contrast.py.

The port's own BiSeNetV2 trunk (DetailBranch, SegmentBranch, BGALayer), so
every deploy route of the base model (`set_stem_impl`, `set_detail_fuse`,
`set_detail_tail`, `set_depthwise_impl`) reaches it unchanged, then:

  * ONE unified segmentation head over `num_unify_classes`, with a BN slot
    per dataset (`UnifiedSegmentHead`), and 4 aux heads of its kind;
  * the convmlp projection head (`ProjHead`) whose L2-normalized
    embeddings at 1/8 feed the pixel-contrast loss and its memory bank;
  * optional per-dataset aux heads over each dataset's own classes.

Module names are the reference torch layout (`head.conv`, `head.proj.conv`,
`aux2.conv1`, `projHead.conv1`, `projHead.conv_last`,
`dataset_aux_head.{i}`), so deploy/weights.py imports a reference
checkpoint by name. Tensors are NCHW stored channels_last, params f32, the
compute in `dtype`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from mds_tpu_torch.losses.contrast import l2_normalize
from mds_tpu_torch.models.bisenetv2 import BGALayer, DetailBranch, SegmentBranch
from mds_tpu_torch.models.layers import (
    ConvBNReLU,
    FastDropout,
    MultiX,
    as_multi,
    conv2d,
    conv_init,
    lecun_init,
    lmap,
    resize_bilinear_ac,
    upsample,
)
from mds_tpu_torch.registry import MODELS


def _channels_l2(x: torch.Tensor) -> torch.Tensor:
    """x (B, C, h, w) L2-normalized over C in f32, back in x's dtype."""
    return l2_normalize(x.float(), dim=1).to(x.dtype)


class ProjHead(nn.Module):
    """convmlp projection (mds_tpu/models/bisenetv2_contrast.py:42-65):
    conv3×3-BN-ReLU at twice the width (a BN slot per dataset) → 1×1 conv
    with bias → L2 normalization with max(norm, 1e-12)."""

    def __init__(self, dim_in: int, proj_dim: int, n_bn: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNReLU(dim_in, 2 * dim_in, 3, n_bn=n_bn, dtype=dtype)
        self.conv_last = nn.Conv2d(2 * dim_in, proj_dim, 1, bias=True)
        self.dtype = dtype

    def forward(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        return lmap(lambda x: _channels_l2(conv2d(self.conv_last, x, self.dtype)),
                    self.conv1(xs))


class ConvNorm(nn.Module):
    """The ConvNorm cosine classifier, bias-free
    (mds_tpu/models/bisenetv2_contrast.py:101-122): logits = w·x /
    (|x|·|w_class| + 1e-8), the products of x and w in the compute dtype
    summed in f32 (a matmul: no TF32), out in `dtype`."""

    def __init__(self, in_chan: int, n_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(in_chan, n_classes, 1, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.flatten(1)  # (U, C) f32
        xf = x.float()
        feat = xf.permute(0, 2, 3, 1) @ w.to(x.dtype).float().T  # (B, h, w, U)
        norm_x = xf.square().sum(dim=1).sqrt()[..., None]
        norm_w = w.float().square().sum(dim=1).sqrt()
        return (feat / (norm_x * norm_w + 1e-8)).to(self.dtype).permute(0, 3, 1, 2)


class UnifiedSegmentHead(nn.Module):
    """One head over the unified label space with a BN slot per dataset
    (mds_tpu/models/bisenetv2_contrast.py:68-139): conv3×3-BN-ReLU →
    dropout(0.1) (train only; kernel 12 on CUDA tensors) → [aux: ×2
    nearest → conv3×3-BN-ReLU to up²] → ConvNorm → bilinear ×factor with
    align_corners=True, unlike the base model's head, cast to `dtype`."""

    def __init__(self, in_chan: int, mid_chan: int, n_classes: int, up_factor: int = 8,
                 aux: bool = True, n_bn: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan, 3, n_bn=n_bn, dtype=dtype)
        self.drop = FastDropout(0.1)
        out_in = mid_chan
        if aux:
            out_in = up_factor * up_factor
            self.conv1 = ConvBNReLU(mid_chan, out_in, 3, n_bn=n_bn, dtype=dtype)
        self.proj = ConvNorm(out_in, n_classes, dtype)
        self.factor = up_factor // 2 if aux else up_factor
        self.aux = aux
        self.dtype = dtype

    def forward(self, xs: MultiX, generator: Optional[torch.Generator] = None
                ) -> List[Optional[torch.Tensor]]:
        xs = lmap(lambda x: self.drop(x, generator), self.conv(xs))
        if self.aux:
            xs = self.conv1(lmap(lambda x: upsample(x, 2, "nearest"), xs))
        xs = lmap(self.proj, xs)
        if self.factor > 1:
            xs = lmap(lambda x: resize_bilinear_ac(
                x, (x.shape[2] * self.factor, x.shape[3] * self.factor)).to(self.dtype), xs)
        return xs


class WNClassifier(nn.Module):
    """Weight-normalized (cosine) 1×1 classifier, the `_wn` variant's
    (mds_tpu/models/bisenetv2_contrast.py:142-159): each class's weight
    column L2-normalized with max(norm, 1e-12), the products in the input's
    dtype summed in f32; `weight` is JAX's (C_in, n) kernel."""

    def __init__(self, in_chan: int, n_classes: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_chan, n_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight / torch.clamp(
            self.weight.square().sum(dim=0, keepdim=True).sqrt(), min=1e-12)
        out = x.float().permute(0, 2, 3, 1) @ w.to(x.dtype).float()
        return out.permute(0, 3, 1, 2)


class BiSeNetV2Contrast(nn.Module):
    """Unified-head BiSeNetV2 with embedding, aux and per-dataset aux
    outputs (mds_tpu/models/bisenetv2_contrast.py:162-267)."""

    def __init__(self, num_unify_classes: int, datasets_cats: Sequence[int] = (),
                 n_bn: int = 1, proj_dim: int = 256, aux: bool = True,
                 with_dataset_aux_heads: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, dtype=dtype)
        self.detail = DetailBranch(**cfg)
        self.segment = SegmentBranch(**cfg)
        self.bga = BGALayer(**cfg)
        n = num_unify_classes
        self.head = UnifiedSegmentHead(128, 1024, n, up_factor=8, aux=False, **cfg)
        if aux:
            for name, c_in, up in (("aux2", 16, 4), ("aux3", 32, 8),
                                   ("aux4", 64, 16), ("aux5_4", 128, 32)):
                setattr(self, name, UnifiedSegmentHead(c_in, 128, n, up_factor=up, **cfg))
        self.projHead = ProjHead(128, proj_dim, n_bn, dtype)
        if with_dataset_aux_heads:
            self.dataset_aux_head = nn.ModuleList(
                UnifiedSegmentHead(128, 1024, c, up_factor=8, aux=False, **cfg)
                for c in datasets_cats)
        self.num_unify_classes = n
        self.datasets_cats = tuple(datasets_cats)
        self.n_bn = n_bn
        self.proj_dim = proj_dim
        self.aux = aux
        self.with_dataset_aux_heads = with_dataset_aux_heads
        self.dtype = dtype
        # the emb eval mode's (U, K, D) prototypes (evaluation/drivers.py
        # sets the memory bank's class means); not in the state dict
        self.prototypes: Optional[torch.Tensor] = None

    @classmethod
    def from_configer(cls, configer, dtype: torch.dtype = torch.float32, **kw
                      ) -> "BiSeNetV2Contrast":
        n = configer.n_datasets
        return cls(num_unify_classes=int(configer.get("num_unify_classes")),
                   datasets_cats=tuple(configer.n_cats(i) for i in range(n)),
                   n_bn=int(configer.get("n_bn", default=n)),
                   proj_dim=int(configer.get("contrast", "proj_dim", default=256)),
                   with_dataset_aux_heads=bool(configer.get("dataset_aux_head", default=False)),
                   dtype=dtype, **kw)

    def backbone(self, xs: MultiX):
        xs = lmap(lambda x: x.to(self.dtype).contiguous(
            memory_format=torch.channels_last), xs)
        feat_d = self.detail(xs)
        feat2, feat3, feat4, feat5_4, feat_s = self.segment(xs)
        return self.bga(feat_d, feat_s), (feat2, feat3, feat4, feat5_4)

    def forward(self, xs: MultiX, generator: Optional[torch.Generator] = None) -> Dict:
        """The train call (aux_mode 'train'): per-dataset lists of unified
        logits at full resolution under "seg" and L2-normalized embeddings
        at 1/8 under "embed"; in train mode the 4 aux heads' logits under
        "aux"; with per-dataset aux heads, "dataset_aux". `generator`
        seeds the dropout masks."""
        feat_head, feats_aux = self.backbone(xs)
        out = {"seg": self.head(feat_head, generator), "embed": self.projHead(feat_head)}
        if self.aux and self.training:
            heads = (self.aux2, self.aux3, self.aux4, self.aux5_4)
            out["aux"] = [h(f, generator) for h, f in zip(heads, feats_aux)]
        if self.with_dataset_aux_heads:
            out["dataset_aux"] = [
                None if f is None else self.dataset_aux_head[i](
                    as_multi(f, i, self.n_bn), generator)[i]
                for i, f in enumerate(feat_head)]
        return out

    def embed(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        """The embeddings alone (the EMA teacher's keys): the backbone and
        the projection head, without the segmentation heads."""
        return self.projHead(self.backbone(xs)[0])

    def eval_logits(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """Unified logits (B, U, H, W) of one dataset's batch."""
        feat_head, _ = self.backbone(as_multi(x, dataset, self.n_bn))
        return self.head(feat_head)[dataset]

    def pred(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        return self.eval_logits(x, dataset).argmax(dim=1)

    def emb_logits(self, x: torch.Tensor, dataset: int = 0,
                   prototypes: Optional[torch.Tensor] = None) -> torch.Tensor:
        """aux_mode 'pred_by_emb' (mds_tpu/models/bisenetv2_contrast.py:
        244-262): the similarity (B, U, h, w) at 1/8, in f32, of the
        embeddings to (U, K, D) prototypes, max over K; `prototypes`
        defaults to the model's own."""
        protos = self.prototypes if prototypes is None else prototypes
        if protos is None:
            raise ValueError("emb_logits needs (U, K, D) prototypes")
        feat_head, _ = self.backbone(as_multi(x, dataset, self.n_bn))
        emb = self.projHead(feat_head)[dataset]
        U, K, D = protos.shape
        p = torch.as_tensor(protos, device=emb.device).to(emb.dtype).float()
        sim = emb.float().permute(0, 2, 3, 1) @ p.reshape(U * K, D).T
        return sim.unflatten(-1, (U, K)).amax(dim=-1).permute(0, 3, 1, 2)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BiSeNetV2Contrast":
        """Seeded random init: kaiming fan-out for the BN'd convs, lecun
        normal for the plain ones (ConvNorm, the projection's last conv,
        BGA's two), zero biases, unit BN."""
        for m in self.modules():
            if isinstance(m, ConvBNReLU):
                conv_init(m.conv.weight, generator)
            elif isinstance(m, ConvNorm):
                lecun_init(m.conv.weight, generator)
        lecun_init(self.projHead.conv_last.weight, generator)
        self.projHead.conv_last.bias.zero_()
        lecun_init(self.bga.left1_conv.weight, generator)
        lecun_init(self.bga.right2_conv.weight, generator)
        return self


def _factory(**defaults):
    def build(configer=None, dtype: torch.dtype = torch.float32, **kw):
        return BiSeNetV2Contrast.from_configer(configer, dtype=dtype, **{**defaults, **kw})
    return build


# the four names of the contrast family (mds_tpu/models/bisenetv2_contrast.py:
# 270-296) build one model: JAX's _wn sets up a `wn_cls` it never calls (no
# parameters, no output), _bn's BN-normalized classifier folds into the same
# head, and _ema's teacher is engine/contrast_trainer.py's second copy
MODELS.register("bisenetv2_contrast")(_factory())
MODELS.register("bisenetv2_contrast_wn")(_factory())
MODELS.register("bisenetv2_contrast_bn")(_factory())
MODELS.register("bisenetv2_contrast_ema")(_factory())
