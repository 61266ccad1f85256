"""SemsegModel ("snp_rn18"): a unified-prototype classifier over the
SwiftNet pyramid — counterpart of mds_tpu/models/semseg.py (`proto_logits`
:36, `remap_logits` :45, `SemsegModel` :54, `set_bipartite_graphs` :228,
`set_unify_prototype` :246, the `snp_rn18` factory :270 and `snp_rn18_mulbn`
:274).

- SwiftNet pyramid → 128-d features at 1/4 → `logits` head (BN, ReLU, 1×1
  conv with bias to `output_feat_dim`) → per-pixel logits against the
  (M, D) unified prototype, M = int(unify_ratio · Σ n_cats); with
  `with_datasets_aux`, per-dataset aux prototypes (n_cats_i, D).
- The per-dataset bipartite graphs (n_cats_i, M) are buffers: they remap
  unified logits to a dataset's label space and take no gradient.
- Names are the reference torch layout (the inverse of
  mds_tpu/deploy/torch_import.py `semseg_from_torch` :343): `backbone.*`,
  `logits.{norm,conv}`, `unify_prototype`, `aux_prototype.{i}`,
  `bipartite_graphs.{i}`.
- `mulbn` (snp_rn18_mulbn, semseg.py:274-278): every BN of the backbone
  and the head's (`logits.norm.{dataset}`) keeps a stat set and an affine
  for each dataset (models/swiftnet.py `DatasetListBN`).
- `PrototypeHeads` holds the classifier, its forwards and the injection
  API; HRNet-W48 (models/hrnet.py) ends in the same heads.
- Logits are NCHW. The prototype products take the features in the compute
  dtype and sum in f32 (JAX's preferred_element_type=f32): they run on f32
  copies of the bf16 values (f64 in an f64 model, layers.wide).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.models.layers import (
    MultiX,
    as_multi,
    lecun_init,
    lmap,
    resize_bilinear_ac,
    wide,
)
from mds_tpu_torch.models.swiftnet import SwiftNetPyramid, _BNReluConv
from mds_tpu_torch.registry import MODELS


def proto_logits(feat: torch.Tensor, prototypes: torch.Tensor) -> torch.Tensor:
    """einsum('bchw,nc->bnhw') of the features (compute dtype) and the
    prototypes rounded to it, summed in f32; f32 out."""
    return torch.einsum("bchw,nc->bnhw", wide(feat), wide(prototypes.to(feat.dtype)))


def remap_logits(logits: torch.Tensor, bi_graph: torch.Tensor) -> torch.Tensor:
    """einsum('bnhw,cn->bchw'): unified logits → the dataset's label space
    through its (n_cats, M) graph, summed in f32."""
    return torch.einsum("bnhw,cn->bchw", wide(logits), wide(bi_graph.to(logits.dtype)))


def _trunc_normal(t: torch.Tensor, stddev: float, generator: torch.Generator):
    """flax's truncated_normal(stddev): a normal cut at ±2σ whose standard
    deviation after the cut is `stddev`."""
    s = stddev / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=generator)


def _tensor(a) -> torch.Tensor:
    return a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a, np.float32))


class _Graphs(nn.Module):
    """The per-dataset bipartite graphs as buffers named 0, 1, ..."""

    def __init__(self, shapes: Sequence[Sequence[int]]):
        super().__init__()
        for i, shape in enumerate(shapes):
            self.register_buffer(str(i), torch.zeros(tuple(shape)))

    def __getitem__(self, i: int) -> torch.Tensor:
        return getattr(self, str(i))

    def __len__(self) -> int:
        return len(self._buffers)


class PrototypeHeads:
    """The unified-prototype classifier snp_rn18 and HRNet-W48 end in
    (mds_tpu/models/semseg.py:158-246, mds_tpu/models/hrnet.py:280-331): a
    (M, D) `unify_prototype`, with `with_datasets_aux` per-dataset
    `aux_prototype`s, and the per-dataset bipartite graphs as buffers. The
    model supplies `features(xs)` (per-dataset features in the compute
    dtype) and `n_bn`; this mixin comes before nn.Module in its bases."""

    def _init_heads(self, datasets_cats: Sequence[int], output_feat_dim: int,
                    unify_ratio: float, with_datasets_aux: bool) -> None:
        M, D = int(unify_ratio * sum(datasets_cats)), int(output_feat_dim)
        self.unify_prototype = nn.Parameter(torch.zeros(M, D))
        if with_datasets_aux:
            self.aux_prototype = nn.ParameterList(
                nn.Parameter(torch.zeros(c, D)) for c in datasets_cats)
        self.bipartite_graphs = _Graphs([(c, M) for c in datasets_cats])

    @property
    def max_num_unify_class(self) -> int:
        return self.unify_prototype.shape[0]

    def forward(self, xs: MultiX) -> Dict:
        """The train call (semseg.py:158-173): "seg" the unified logits, "feat"
        the features and, with aux prototypes, "aux" their logits, each a
        per-dataset list."""
        feats = self.features(xs)
        out = {"seg": lmap(lambda f: proto_logits(f, self.unify_prototype), feats),
               "feat": feats}
        if self.with_datasets_aux:
            out["aux"] = [None if f is None else proto_logits(f, self.aux_prototype[i])
                          for i, f in enumerate(feats)]
        return out

    def _feature(self, x: torch.Tensor, dataset: int) -> torch.Tensor:
        return self.features(as_multi(x, dataset, self.n_bn))[dataset]

    def uni_eval_logits(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """Unified-class logits at 1/4 (semseg.py:184)."""
        return proto_logits(self._feature(x, dataset), self.unify_prototype)

    def eval_logits(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """The unified logits remapped through the dataset's graph, at 1/4
        (semseg.py:175)."""
        return remap_logits(self.uni_eval_logits(x, dataset), self.bipartite_graphs[dataset])

    def pred(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """remap → ×4 bilinear (align_corners=True) → argmax (semseg.py:190)."""
        logits = self.eval_logits(x, dataset)
        h, w = logits.shape[-2:]
        return resize_bilinear_ac(logits, (h * 4, w * 4)).argmax(dim=1)

    def clip_logits(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """Logits against the dataset's own prototype rows [Σc_<i, Σc_<i +
        c_i) (semseg.py:200)."""
        cur = sum(self.datasets_cats[:dataset])
        rows = self.unify_prototype[cur:cur + self.datasets_cats[dataset]]
        return proto_logits(self._feature(x, dataset), rows)

    def unseen_pred_logits(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """The unified argmax as a one-hot, remapped through the dataset's
        graph (semseg.py:211)."""
        logits = self.uni_eval_logits(x, dataset)
        one_hot = F.one_hot(logits.argmax(dim=1), logits.shape[1]).permute(0, 3, 1, 2)
        return remap_logits(one_hot.to(logits.dtype), self.bipartite_graphs[dataset])

    # -------------------------------------------------------- graph injection
    @torch.no_grad()
    def set_bipartite_graphs(self, bi_graphs: Sequence):
        """semseg.py:228: n graphs, or 2n ([max0, soft0, max1, ...]) of
        which the even ones are taken."""
        n = len(self.bipartite_graphs)
        if len(bi_graphs) == 2 * n:
            bi_graphs = [bi_graphs[2 * i] for i in range(n)]
        for i in range(n):
            old = self.bipartite_graphs[i]
            old.copy_(_tensor(bi_graphs[i]).reshape(old.shape))
        return self

    @torch.no_grad()
    def set_unify_prototype(self, proto):
        """semseg.py:246: with aux prototypes the first Σ n_cats rows feed
        them, the rest the unified prototype."""
        proto = _tensor(proto).float()
        if self.with_datasets_aux:
            total = sum(self.datasets_cats)
            self.unify_prototype.copy_(proto[total:])
            cur = 0
            for i, c in enumerate(self.datasets_cats):
                self.aux_prototype[i].copy_(proto[cur:cur + c])
                cur += c
        else:
            self.unify_prototype.copy_(proto)
        return self

    @torch.no_grad()
    def _init_heads_weights(self, generator: torch.Generator) -> None:
        """Truncated normal(0.02) prototypes, zero graphs."""
        _trunc_normal(self.unify_prototype, 0.02, generator)
        if self.with_datasets_aux:
            for p in self.aux_prototype:
                _trunc_normal(p, 0.02, generator)
        for i in range(len(self.bipartite_graphs)):
            self.bipartite_graphs[i].zero_()


class SemsegModel(PrototypeHeads, nn.Module):
    """snp_rn18 (mds_tpu/models/semseg.py:54). `datasets_cats`: per-dataset
    class counts; the backbone knobs (layers, planes, num_features,
    pyramid_levels) default to the reference ResNet18 pyramid."""

    def __init__(self, datasets_cats: Sequence[int], output_feat_dim: int = 512,
                 unify_ratio: float = 1.0, with_datasets_aux: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 backbone_layers: Sequence[int] = (2, 2, 2, 2),
                 backbone_planes: Sequence[int] = (64, 128, 256, 512),
                 backbone_features: int = 128, pyramid_levels: int = 3,
                 mulbn: bool = False):
        super().__init__()
        self.datasets_cats = tuple(int(c) for c in datasets_cats)
        self.output_feat_dim = int(output_feat_dim)
        self.with_datasets_aux = bool(with_datasets_aux)
        self.dtype = dtype
        self.mulbn = bool(mulbn)
        nd = len(self.datasets_cats)
        self.backbone = SwiftNetPyramid(backbone_layers, backbone_features,
                                        pyramid_levels, backbone_planes, dtype, remat,
                                        self.mulbn, nd)
        self.logits = _BNReluConv(backbone_features, output_feat_dim, 1, True, dtype,
                                  self.mulbn, nd)
        self._init_heads(self.datasets_cats, output_feat_dim, unify_ratio,
                         self.with_datasets_aux)
        self.n_bn = len(self.datasets_cats)

    @classmethod
    def from_configer(cls, configer, dtype: torch.dtype = torch.float32, **kw):
        """mds_tpu/models/semseg.py:82-108: the config's `backbone` block
        for the knobs, `network.efficient` (default true) for remat."""
        bk = {"remat": bool(configer.get("network", "efficient", default=True))}
        for key, field in (("layers", "backbone_layers"), ("planes", "backbone_planes"),
                           ("num_features", "backbone_features"),
                           ("pyramid_levels", "pyramid_levels")):
            v = configer.get("backbone", key, default=None)
            if v is not None:
                bk[field] = tuple(v) if isinstance(v, (list, tuple)) else int(v)
        bk.update(kw)
        return cls(
            datasets_cats=tuple(configer.n_cats(i) for i in range(configer.n_datasets)),
            output_feat_dim=int(configer.get("GNN", "output_feat_dim", default=512)),
            unify_ratio=float(configer.get("GNN", "unify_ratio", default=1.0)),
            with_datasets_aux=bool(configer.get("loss", "with_datasets_aux", default=False)),
            dtype=dtype, **bk)

    def features(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        """backbone + the `logits` head → per-dataset features at 1/4, in
        the compute dtype."""
        xs = lmap(lambda x: x.to(self.dtype).contiguous(memory_format=torch.channels_last), xs)
        return self.logits(self.backbone(xs))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SemsegModel":
        """The backbone's kaiming fan-out, lecun normal for the 1×1 `logits`
        conv with a zero bias, truncated normal(0.02) prototypes, zero
        graphs (mds_tpu/models/semseg.py:110-148)."""
        self.backbone.init_weights(generator)
        self.logits.norm.reset_parameters()
        lecun_init(self.logits.conv.weight, generator)
        self.logits.conv.bias.zero_()
        self._init_heads_weights(generator)
        return self


@MODELS.register("snp_rn18")
def snp_rn18(configer=None, dtype: torch.dtype = torch.float32, **kw):
    """JAX's `configer=` factory (mds_tpu/models/semseg.py:270)."""
    return SemsegModel.from_configer(configer, dtype=dtype, **kw)


@MODELS.register("snp_rn18_mulbn")
def snp_rn18_mulbn(configer=None, dtype: torch.dtype = torch.float32, **kw):
    """Per-dataset BN (mds_tpu/models/semseg.py:274)."""
    return SemsegModel.from_configer(configer, dtype=dtype, mulbn=True, **kw)
