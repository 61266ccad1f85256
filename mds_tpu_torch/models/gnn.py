"""The label-space-unifying bipartite GNN — counterpart of
mds_tpu/models/gnn.py (`GCNLayer` :49, `GSAGELayer` :62, `normalize_adj`
:117, `LearnableTopologyBGNN` :124, `max_mask_graphs` :393,
`gumbel_softmax_decay` :406).

The graph has Σ n_cats dataset-class nodes followed by M unified-class
nodes. Its adjacency is a learnable (Σ n_cats, M) block (`adj_mode`
"direct", the `learnable_topology_BGNN_adj` of the flagship configs):
softmax(block/τ) over each dataset's rows at τ = 0.07, placed in both
off-diagonal blocks of the (T + M)² matrix and row-normalized. Four GSAGE
(or GCN) layers with dropout propagate the node features; `linear1` gives
the unified prototypes (with the dataset rows in front when the seg model
has aux prototypes). The per-dataset softmax blocks are the differentiable
bipartite graphs; the discrete ones (max-masked, or UOT at a stage switch)
are made by the caller.

Parameters keep JAX's layout: `linear_before`/`linear1` are nn.Linear (the
transposed flax kernel), `gcn_layers.{i}.{weight,bias}` JAX's (in, out)
weight, `unify_node_features` (M, nfeat), `adj_matrix` (T, M). The dropout
masks come from an explicit CPU torch.Generator (flax's masks cannot be
reproduced).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.registry import MODELS

WAITING = "ROADMAP queue 1, item 6b (the flagship's waiting features: {})"


def _uniform_init(t: torch.Tensor, generator: torch.Generator) -> None:
    """U(−1/√out, 1/√out), out = the last axis (module_helper.py:768-772)."""
    stdv = 1.0 / math.sqrt(t.shape[-1])
    nn.init.uniform_(t, -stdv, stdv, generator=generator)


def _lecun_dense(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax nn.Dense's default: lecun normal (truncated at ±2σ, σ
    corrected), zero bias."""
    s = math.sqrt(1.0 / layer.in_features) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, 0.0, s, -2 * s, 2 * s, generator=generator)
    layer.bias.zero_()


class GCNLayer(nn.Module):
    """x' = tanh(adj @ (x W) + b + x) (mds_tpu/models/gnn.py:49)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return torch.tanh(adj @ (x @ self.weight) + self.bias + x)


class GSAGELayer(nn.Module):
    """x' = tanh([x ∥ adj@x] W + b) (mds_tpu/models/gnn.py:62)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(2 * in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return torch.tanh(torch.cat([x, adj @ x], dim=-1) @ self.weight + self.bias)


def normalize_adj(mx: torch.Tensor) -> torch.Tensor:
    """Row-normalize D⁻¹A, a zero row staying zero (gnn.py:117)."""
    rowsum = mx.sum(dim=1)
    r_inv = torch.where(rowsum != 0, 1.0 / rowsum, torch.zeros_like(rowsum))
    return mx * r_inv[:, None]


def dropout(t: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each element with probability 1 − rate (a CPU draw from
    `generator`), kept ones scaled by 1/(1 − rate) (gnn.py:326-332)."""
    keep = torch.rand(t.shape, generator=generator) < (1.0 - rate)
    return torch.where(keep.to(t.device), t / (1.0 - rate), torch.zeros_like(t))


class LearnableTopologyBGNN(nn.Module):
    """The direct-adjacency BGNN (mds_tpu/models/gnn.py:124 at
    adj_mode="direct"). The research forks raise NotImplementedError."""

    def __init__(self, dataset_cats: Sequence[int], nfeat: int = 1024,
                 nfeat_out: int = 512, output_feat_dim: int = 512,
                 unify_ratio: float = 1.0, dropout_rate: float = 0.5,
                 gnn_type: str = "GSAGE", adj_mode: str = "direct",
                 mse_or_adv: str = "None", with_datasets_aux: bool = False,
                 init_stage: bool = False, temperature: float = 0.07,
                 n_gcn_layers: int = 4, with_unlabel: bool = False):
        super().__init__()
        if adj_mode != "direct":
            raise NotImplementedError(WAITING.format(f"the BGNN fork adj_mode={adj_mode!r}"))
        if gnn_type not in ("GSAGE", "GCN"):
            raise NotImplementedError(WAITING.format(f"GNN_type {gnn_type!r}"))
        if with_unlabel:
            raise NotImplementedError(WAITING.format("the unlabel BGNN fork"))
        if mse_or_adv == "adv":
            raise NotImplementedError(WAITING.format(
                "mse_or_adv='adv' (the Discriminator, the netD optimizer, the BCE term)"))
        self.dataset_cats = tuple(int(c) for c in dataset_cats)
        self.total_cats = sum(self.dataset_cats)
        self.max_num_unify_class = int(unify_ratio * self.total_cats)
        self.nfeat, self.nfeat_out = int(nfeat), int(nfeat_out)
        self.output_feat_dim = int(output_feat_dim)
        self.dropout_rate = float(dropout_rate)
        self.mse_or_adv = mse_or_adv
        self.with_datasets_aux = bool(with_datasets_aux)
        self.init_stage = bool(init_stage)
        self.temperature = float(temperature)
        T, M = self.total_cats, self.max_num_unify_class
        self.linear_before = nn.Linear(self.nfeat, self.nfeat_out)
        self.linear1 = nn.Linear(self.nfeat_out, self.output_feat_dim)
        layer = {"GSAGE": GSAGELayer, "GCN": GCNLayer}[gnn_type]
        self.gcn_layers = nn.ModuleList(layer(self.nfeat_out, self.nfeat_out)
                                        for _ in range(n_gcn_layers))
        self.unify_node_features = nn.Parameter(torch.zeros(M, self.nfeat))
        self.adj_matrix = nn.Parameter(torch.zeros(T, M))

    @classmethod
    def from_configer(cls, configer, adj_mode: Optional[str] = None, **kw):
        """mds_tpu/models/gnn.py:197-225: the GNN block of the config."""
        name = configer.get("GNN", "model_name", default="learnable_topology_BGNN_adj")
        kw.setdefault("adj_mode", adj_mode or ("direct" if name.endswith("_adj") else "cosine"))
        g = lambda k, d: configer.get("GNN", k, default=d)
        base = dict(
            dataset_cats=tuple(configer.n_cats(i) for i in range(configer.n_datasets)),
            nfeat=int(g("nfeat", 1024)), nfeat_out=int(g("nfeat_out", 512)),
            output_feat_dim=int(g("output_feat_dim", 512)),
            unify_ratio=float(g("unify_ratio", 1.0)),
            dropout_rate=float(g("dropout_rate", 0.5)),
            gnn_type=g("GNN_type", "GSAGE"), mse_or_adv=g("mse_or_adv", "None"),
            with_datasets_aux=bool(configer.get("loss", "with_datasets_aux", default=False)),
            init_stage=bool(g("init_by_eval", False)))
        base.update(kw)
        return cls(**base)

    # ------------------------------------------------------------ adjacency
    def _softmax_blocks(self, block: torch.Tensor) -> torch.Tensor:
        """softmax(block/τ) over each dataset's rows."""
        return torch.cat([torch.softmax(b / self.temperature, dim=0)
                          for b in torch.split(block, self.dataset_cats, dim=0)])

    def calc_adjacency(self):
        """→ (normalized (T+M)² adjacency, the (T, M) bipartite block)."""
        block = self.adj_matrix if self.init_stage else self._softmax_blocks(self.adj_matrix)
        T, M = block.shape
        upper = torch.cat([block.new_zeros(T, T), block], dim=1)
        lower = torch.cat([block.t(), block.new_zeros(M, M)], dim=1)
        return normalize_adj(torch.cat([upper, lower], dim=0)), block

    # -------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict:
        """x: (Σ n_cats, nfeat) class-node features → dict(unify_prototype,
        bi_graphs (the per-dataset softmax blocks), adv_pairs, adj_block,
        ret_feats) (gnn.py:308-359). Dropout in train mode only, its masks
        from `generator`."""
        T = self.total_cats
        feat1 = self.linear_before(torch.cat([x, self.unify_node_features], dim=0))
        adj, block = self.calc_adjacency()
        h = F.relu(feat1)
        drop = self.training and self.dropout_rate > 0.0
        feats, adv_pairs = [], []
        for li, layer in enumerate(self.gcn_layers):
            h_out = layer(dropout(h, self.dropout_rate, generator) if drop else h, adj)
            prev = F.relu(feat1) if li == 0 else feats[-1]
            adv_pairs.append((prev.detach(), h_out))
            feats.append(h_out)
            h = h_out
        feat_out = self.linear1(feats[-1])
        return {"unify_prototype": feat_out if self.with_datasets_aux else feat_out[T:],
                "bi_graphs": self.sep_bipartite_graphs(block),
                "adv_pairs": adv_pairs, "adj_block": block,
                "ret_feats": [f[T:] for f in feats] + [feat_out[T:]]}

    def sep_bipartite_graphs(self, block: torch.Tensor) -> List[torch.Tensor]:
        """The per-dataset (n_cats_i, M) rows of the block."""
        return list(torch.split(block, self.dataset_cats, dim=0))

    def infer_prototypes(self, x: torch.Tensor):
        """The stage switch's forward without dropout → (prototype rows, the
        bipartite block) (gnn.py:371-376)."""
        training = self.training
        self.eval()
        try:
            out = self(x)
        finally:
            self.train(training)
        return out["unify_prototype"], out["adj_block"]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LearnableTopologyBGNN":
        """flax's inits: lecun-normal Dense kernels with zero biases, the
        GCN layers' U(−1/√out, 1/√out), truncated normal(0.02) unified node
        features, a U(0, 1) adjacency (torch.rand, as the reference)."""
        _lecun_dense(self.linear_before, generator)
        _lecun_dense(self.linear1, generator)
        for layer in self.gcn_layers:
            _uniform_init(layer.weight, generator)
            _uniform_init(layer.bias, generator)
        s = 0.02 / 0.87962566103423978
        nn.init.trunc_normal_(self.unify_node_features, 0.0, s, -2 * s, 2 * s,
                              generator=generator)
        nn.init.uniform_(self.adj_matrix, 0.0, 1.0, generator=generator)
        return self


def max_mask_graphs(block: torch.Tensor, dataset_cats: Sequence[int]) -> List[torch.Tensor]:
    """Zero all but each column's max row, per dataset (gnn.py:393)."""
    out = []
    for g in torch.split(block, tuple(dataset_cats), dim=0):
        mx = g.max(dim=0, keepdim=True).values
        out.append(torch.where(g == mx, g, torch.zeros_like(g)))
    return out


def gumbel_softmax_decay(current_iter: int, r: float = 2e-5, max_temp: float = 10.0,
                         min_temp: float = 0.01) -> float:
    """τ = max(min_temp, max_temp·e^(−r·iter)) (gnn.py:406)."""
    return float(np.maximum(min_temp, max_temp * np.exp(-r * current_iter)))


def gumbel_max_graphs(*args, **kw):
    raise NotImplementedError(WAITING.format("Gumbel graphs (GNN.GumbelSoftmax)"))


@MODELS.register("learnable_topology_BGNN_adj")
def ltbgnn_adj(configer=None, **kw):
    return LearnableTopologyBGNN.from_configer(configer, adj_mode="direct", **kw)


def _waiting(name: str, what: str):
    def factory(configer=None, **kw):
        raise NotImplementedError(WAITING.format(f"{name} ({what})"))

    MODELS.register(name)(factory)


for _name, _what in (
        ("learnable_topology_BGNN", "the cosine BGNN fork"),
        ("learnable_topology_BGNN_unlabel", "the unlabel BGNN fork"),
        ("learnable_topology_BGNN_sfg", "the sfg BGNN fork"),
        ("learnable_topology_BGNN_adj3", "the direct_full BGNN fork"),
        ("learnable_topology_BGNN_adj_tg", "ops/target_graph.py's target graphs"),
        ("learnable_topology_BGAT", "the GAT BGNN fork"),
        ("self_attention_GNN", "SelfAttentionGNN"),
        ("learnable_topology_GAT", "LearnableTopologyGAT"),
        ("graph_attention_network", "SelfAttentionGNN")):
    _waiting(_name, _what)


def build_gnn(configer) -> nn.Module:
    """The config's GNN.model_name from MODELS (the waiting ones raise)."""
    import mds_tpu_torch.models  # noqa: F401 — fills MODELS

    return MODELS[configer.get("GNN", "model_name",
                               default="learnable_topology_BGNN_adj")](configer=configer)
