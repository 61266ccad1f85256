"""HRNet-W48 in PyTorch — counterpart of mds_tpu/models/hrnet.py
(`BasicBlock` :50, `Bottleneck` :74, `HighResolutionModule` :103,
`HRNetBackbone` :164, `ProjectionHead` :215, `HRNetW48` :234 and its four
registrations :333-346).

- The HRNetV2 trunk: two stride-2 3×3 stems, four Bottlenecks to 256
  channels at 1/4, then stages 2-4 of parallel branches (1/4 … 1/32) with
  a transition before each stage and full fusion after each module. Every
  conv is a per-dataset-BN `ConvBNReLU`/`ConvBN` (models/layers.py);
  activations are per-dataset lists where an absent dataset is None.
- Fusion into branch i (hrnet.py:130-154): branch j > i through a 1×1
  ConvBN, resized to branch i's size (align_corners=True, in f32, cast back
  to the branch's dtype); branch j < i through i − j stride-2 3×3 convs,
  ConvBNReLU at branch j's width then a last ConvBN to branch i's; the sum
  starts from branch i and adds j in increasing order, then a ReLU.
- HRNetW48: the four branches resized to 1/4 and concatenated (720
  channels at width 48) → `ProjectionHead` (3×3 ConvBNReLU to twice the
  width, 1×1 conv with bias to `output_feat_dim`) → the unified-prototype
  classifier with per-dataset bipartite graphs (semseg.py `PrototypeHeads`,
  the interface snp_rn18 has: `bipartite_graphs`, `set_bipartite_graphs`,
  `eval_logits`, `pred`). The graphs start at zeros as JAX's (hrnet.py
  :290-294), so an untrained model's eval logits are all 0.
- Module names are the reference torch layout JAX's importers read
  (mds_tpu/deploy/torch_import.py:408-603), under `backbone.`: `conv1`,
  `conv2`, `layer1.{b}.{conv1,conv2,conv3,downsample}`, `transition{t}.{i}`
  (a channel adapt) or `transition{t}.{i}.0` (a new branch),
  `stage{s}.{m}.branches.{i}.{b}.{conv1,conv2,downsample}`,
  `stage{s}.{m}.fuse_layers.{i}.{j}` (j > i) and `.{i}.{j}.{k}` (j < i); the
  head is `proj_head.{conv1,conv_out}`.
- The stem conv (3 → 64, 3×3 s2, no bias) is a `StemConv3x3S2`: in eval
  with set_stem_impl("kernel") on a bf16 input, each dataset's forward runs
  kernel 1 (ops/stem.py stem_conv_bn_relu_s2) once, with that dataset's BN
  folded in, as JAX's layer does (mds_tpu/models/layers.py:513-518).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.models.layers import (
    ConvBN,
    ConvBNReLU,
    MultiX,
    conv2d,
    conv_init,
    lecun_init,
    lmap,
    lmap2,
    resize_bilinear_ac,
)
from mds_tpu_torch.models.semseg import PrototypeHeads
from mds_tpu_torch.registry import MODELS

# the HRNET_48 and HRNET_18 stage dicts (mds_tpu/models/hrnet.py:31-47)
HRNET48_STAGES = {
    "stage2": dict(num_modules=1, num_branches=2, num_blocks=(4, 4),
                   num_channels=(48, 96)),
    "stage3": dict(num_modules=4, num_branches=3, num_blocks=(4, 4, 4),
                   num_channels=(48, 96, 192)),
    "stage4": dict(num_modules=3, num_branches=4, num_blocks=(4, 4, 4, 4),
                   num_channels=(48, 96, 192, 384)),
}
HRNET18_STAGES = {
    "stage2": dict(num_modules=1, num_branches=2, num_blocks=(4, 4),
                   num_channels=(18, 36)),
    "stage3": dict(num_modules=4, num_branches=3, num_blocks=(4, 4, 4),
                   num_channels=(18, 36, 72)),
    "stage4": dict(num_modules=3, num_branches=4, num_blocks=(4, 4, 4, 4),
                   num_channels=(18, 36, 72, 144)),
}
_STAGES = ("stage2", "stage3", "stage4")


def _add_relu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.relu(a + b)


def _resized(xs: MultiX, size_hw) -> List[Optional[torch.Tensor]]:
    """Each tensor align-corners resized to `size_hw` in f32, cast back."""
    return lmap(lambda x: resize_bilinear_ac(x, size_hw).to(x.dtype), xs)


def _size(xs: MultiX):
    return next(x for x in xs if x is not None).shape[-2:]


class BasicBlock(nn.Module):
    """conv3-BN-ReLU → conv3-BN + residual, ReLU (hrnet.py:50-71)."""

    def __init__(self, in_chan: int, planes: int, stride: int = 1,
                 downsample: bool = False, n_bn: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, dtype=dtype)
        self.conv1 = ConvBNReLU(in_chan, planes, 3, stride, **cfg)
        self.conv2 = ConvBN(planes, planes, 3, **cfg)
        self.downsample = ConvBN(in_chan, planes, 1, stride, **cfg) if downsample else None

    def forward(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        res = xs if self.downsample is None else self.downsample(xs)
        return lmap2(_add_relu, self.conv2(self.conv1(xs)), res)


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1 (×4) + residual, ReLU (hrnet.py:74-96)."""

    def __init__(self, in_chan: int, planes: int, stride: int = 1,
                 downsample: bool = False, n_bn: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, dtype=dtype)
        self.conv1 = ConvBNReLU(in_chan, planes, 1, **cfg)
        self.conv2 = ConvBNReLU(planes, planes, 3, stride, **cfg)
        self.conv3 = ConvBN(planes, planes * 4, 1, **cfg)
        self.downsample = (ConvBN(in_chan, planes * 4, 1, stride, **cfg)
                           if downsample else None)

    def forward(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        res = xs if self.downsample is None else self.downsample(xs)
        return lmap2(_add_relu, self.conv3(self.conv2(self.conv1(xs))), res)


class HighResolutionModule(nn.Module):
    """Parallel branches of BasicBlocks + full fusion (hrnet.py:103-154).
    `in_channels`: each branch's input width; a branch's first block takes
    a 1×1 downsample where it differs from the branch's width (JAX's
    `need_ds`, read there from the input's channel axis)."""

    def __init__(self, num_blocks: Sequence[int], in_channels: Sequence[int],
                 num_channels: Sequence[int], n_bn: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = dict(n_bn=n_bn, dtype=dtype)
        nb = len(num_channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(in_channels[i] if b == 0 else num_channels[i],
                                       num_channels[i], 1,
                                       b == 0 and in_channels[i] != num_channels[i], **cfg)
                            for b in range(num_blocks[i])))
            for i in range(nb))
        self.fuse_layers = None
        if nb > 1:
            rows = []
            for i in range(nb):
                row = []
                for j in range(nb):
                    if j == i:
                        row.append(None)
                    elif j > i:
                        row.append(ConvBN(num_channels[j], num_channels[i], 1, **cfg))
                    else:
                        chain = [ConvBNReLU(num_channels[j], num_channels[j], 3, 2, **cfg)
                                 for _ in range(i - j - 1)]
                        chain.append(ConvBN(num_channels[j], num_channels[i], 3, 2, **cfg))
                        row.append(nn.Sequential(*chain))
                rows.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs_list: List[MultiX]) -> List[List[Optional[torch.Tensor]]]:
        xs_list = [branch(xs) for branch, xs in zip(self.branches, xs_list)]
        if self.fuse_layers is None:
            return xs_list
        fused = []
        for i, row in enumerate(self.fuse_layers):
            tgt = _size(xs_list[i])
            y = xs_list[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                f = layer(xs_list[j])
                if j > i:
                    f = _resized(f, tgt)
                y = lmap2(torch.add, y, f)
            fused.append(lmap(F.relu, y))
        return fused


class HRNetBackbone(nn.Module):
    """HRNetV2 trunk → the 4 branch outputs at 1/4, 1/8, 1/16, 1/32, each a
    per-dataset list (hrnet.py:164-212); stem stride 2 + 2."""

    def __init__(self, stages: Optional[Dict[str, Any]] = None, n_bn: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        stages = stages or HRNET48_STAGES
        cfg = dict(n_bn=n_bn, dtype=dtype)
        self.conv1 = ConvBNReLU(3, 64, 3, 2, **cfg)
        self.conv2 = ConvBNReLU(64, 64, 3, 2, **cfg)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if b == 0 else 256, 64, 1, b == 0, **cfg)
                                      for b in range(4)))
        prev = [256]
        for t, key in enumerate(_STAGES, start=1):
            sc = stages[key]
            chans = list(sc["num_channels"])
            trans = []
            for i in range(sc["num_branches"]):
                if i < len(prev):
                    trans.append(None if prev[i] == chans[i] else
                                 ConvBNReLU(prev[i], chans[i], 3, **cfg))
                else:
                    trans.append(nn.Sequential(ConvBNReLU(prev[-1], chans[i], 3, 2, **cfg)))
            setattr(self, f"transition{t}", nn.ModuleList(trans))
            # every branch a transition leaves or makes has the stage's width
            setattr(self, key, nn.Sequential(*(
                HighResolutionModule(sc["num_blocks"], chans, chans, **cfg)
                for _ in range(sc["num_modules"]))))
            prev = chans
        self.out_channels = prev

    def forward(self, xs: MultiX) -> List[List[Optional[torch.Tensor]]]:
        xs = self.layer1(self.conv2(self.conv1(xs)))
        branches = [xs]
        for t, key in enumerate(_STAGES, start=1):
            new = []
            for i, layer in enumerate(getattr(self, f"transition{t}")):
                if i < len(branches):
                    new.append(branches[i] if layer is None else layer(branches[i]))
                else:
                    new.append(layer(branches[-1]))
            branches = getattr(self, key)(new)
        return branches


class ProjectionHead(nn.Module):
    """convmlp projection (hrnet.py:215-231): 3×3 ConvBNReLU to twice the
    width → 1×1 conv with bias."""

    def __init__(self, in_chan: int, proj_dim: int, n_bn: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNReLU(in_chan, in_chan * 2, 3, n_bn=n_bn, dtype=dtype)
        self.conv_out = nn.Conv2d(in_chan * 2, proj_dim, 1, bias=True)
        self.dtype = dtype

    def forward(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        return lmap(lambda x: conv2d(self.conv_out, x, self.dtype), self.conv1(xs))


class HRNetW48(PrototypeHeads, nn.Module):
    """HRNet-W48 with the unified-prototype classifier and bipartite remap
    (hrnet.py:234-331). `stages` overrides the width's stage dict (48:
    HRNET48_STAGES, else HRNET18_STAGES); n_bn must equal the number of
    datasets for the per-dataset lists of eval_logits."""

    def __init__(self, datasets_cats: Sequence[int], output_feat_dim: int = 720,
                 unify_ratio: float = 1.0, with_datasets_aux: bool = False,
                 n_bn: int = 1, width: int = 48, stages: Optional[Dict[str, Any]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.datasets_cats = tuple(int(c) for c in datasets_cats)
        self.output_feat_dim = int(output_feat_dim)
        self.with_datasets_aux = bool(with_datasets_aux)
        self.n_bn = int(n_bn)
        self.dtype = dtype
        stages = stages or (HRNET48_STAGES if width == 48 else HRNET18_STAGES)
        self.backbone = HRNetBackbone(stages, self.n_bn, dtype)
        self.proj_head = ProjectionHead(sum(self.backbone.out_channels),
                                        self.output_feat_dim, self.n_bn, dtype)
        self._init_heads(self.datasets_cats, self.output_feat_dim, unify_ratio,
                         self.with_datasets_aux)

    @classmethod
    def from_configer(cls, configer, dtype: torch.dtype = torch.float32, **kw):
        """hrnet.py:257-271: `GNN.output_feat_dim` (720), `GNN.unify_ratio`,
        `loss.with_datasets_aux`, `n_bn` (default: the number of datasets)
        and `hrnet.width` (48); `hrnet.full_res_stem` is not read."""
        n = configer.n_datasets
        return cls(
            datasets_cats=tuple(configer.n_cats(i) for i in range(n)),
            output_feat_dim=int(configer.get("GNN", "output_feat_dim", default=720)),
            unify_ratio=float(configer.get("GNN", "unify_ratio", default=1.0)),
            with_datasets_aux=bool(configer.get("loss", "with_datasets_aux", default=False)),
            n_bn=int(configer.get("n_bn", default=n)),
            width=int(configer.get("hrnet", "width", default=48)),
            dtype=dtype, **kw)

    def features(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        """The branches resized to 1/4 and concatenated, through the
        projection head: per-dataset features at 1/4 in the compute dtype
        (hrnet.py:296-304)."""
        xs = lmap(lambda x: x.to(self.dtype).contiguous(memory_format=torch.channels_last), xs)
        branches = self.backbone(xs)
        tgt = _size(branches[0])
        cat = branches[0]
        for b in branches[1:]:
            cat = lmap2(lambda a, c: torch.cat([a, c], dim=1), cat, _resized(b, tgt))
        return self.proj_head(cat)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "HRNetW48":
        """kaiming fan-out for every BN'd conv, lecun normal for the head's
        1×1 conv with a zero bias, truncated normal(0.02) prototypes, zero
        graphs (hrnet.py:273-294)."""
        for m in self.modules():
            if isinstance(m, ConvBNReLU):
                conv_init(m.conv.weight, generator)
        lecun_init(self.proj_head.conv_out.weight, generator)
        self.proj_head.conv_out.bias.zero_()
        self._init_heads_weights(generator)
        return self


@MODELS.register("hrnet_w48")
@MODELS.register("hrnet_w48_gnn")
@MODELS.register("hrnet_w48_clip")
@MODELS.register("hrnet_w48_contrast")
def hrnet_w48(configer=None, dtype: torch.dtype = torch.float32, **kw):
    """JAX's `configer=` factory (hrnet.py:333-346). The CLIP-prototype and
    contrast variants share the model; where the prototypes come from is a
    trainer's concern."""
    return HRNetW48.from_configer(configer, dtype=dtype, **kw)
