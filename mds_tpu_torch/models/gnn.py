"""The label-space-unifying graph nets — counterpart of mds_tpu/models/gnn.py
(`GCNLayer` :49, `GSAGELayer` :62, `GATLayer` :76, `Discriminator` :102,
`normalize_adj` :117, `LearnableTopologyBGNN` :124, `max_mask_graphs` :393,
`gumbel_softmax_decay` :406, `gumbel_max_graphs` :417,
`AttentionalPropagation` :438, `fixed_block_adjacency` :462,
`SelfAttentionGNN` :489, `LearnableTopologyGAT` :569, the `MODELS` names
:662-727).

The BGNN's graph has the dataset-class nodes (Σ n_cats, plus one
"unlabeled" node a dataset with `with_unlabel`: `eff_cats`, `total_nodes`)
followed by M unified-class nodes. Its (total_nodes, M) bipartite block is
softmax(·/τ) over each dataset's rows at τ = 0.07 of
- `adj_mode` "direct": a learnable (total_nodes, M) parameter (the flagship
  configs' `learnable_topology_BGNN_adj`);
- "direct_full": the cross block of a learnable (T + M)² parameter (the
  adj3 and sfg forks, sfg with 3 layers);
- "cosine": the cosine similarity of `linear_adj` features (256-d) of the
  nodes (`learnable_topology_BGNN`, and every name JAX's table lacks).
The block goes into both off-diagonal blocks of the (T + M)² adjacency,
row-normalized. GSAGE, GCN or GAT layers with dropout propagate the node
features; `linear1` gives the unified prototypes (with the dataset rows in
front when the seg model has aux prototypes). The per-dataset softmax
blocks are the differentiable bipartite graphs; the discrete ones
(max-masked, Gumbel-softmax samples, or UOT/KM at a stage switch) are made
by the caller. With `mse_or_adv` "adv" one `Discriminator` a layer scores
the (real, fake) feature pairs.

Parameters keep JAX's layout: Dense layers are nn.Linear (the transposed
flax kernel), `gcn_layers.{i}.{weight,bias}` (or GAT's `weight`, `attn`) as
JAX's (in, out) arrays, `unify_node_features` (M, nfeat),
`unlabel_node_features` (n, nfeat), `adj_matrix`, `netD.{i}.{hidden,out}`.
`linear_adj` exists only in cosine mode, `netD` only in adv mode, as flax
creates them. Dropout masks and Gumbel noise come from an explicit CPU
torch.Generator (flax's draws cannot be reproduced), so the card and the
CPU draw the same ones.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.registry import MODELS


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


def _xavier_dense(layer: nn.Linear, generator: torch.Generator) -> None:
    nn.init.xavier_uniform_(layer.weight, generator=generator)
    layer.bias.zero_()


def _trunc_normal(t: torch.Tensor, generator: torch.Generator, stddev: float = 0.02) -> None:
    """flax's truncated_normal(stddev)."""
    s = stddev / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, s, -2 * s, 2 * s, generator=generator)


class GCNLayer(nn.Module):
    """x' = tanh(adj @ (x W) + b + x) (mds_tpu/models/gnn.py:49)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return torch.tanh(adj @ (x @ self.weight) + self.bias + x)

    def init_weights(self, generator: torch.Generator) -> None:
        _uniform_init(self.weight, generator)
        _uniform_init(self.bias, generator)


class GSAGELayer(GCNLayer):
    """x' = tanh([x ∥ adj@x] W + b) (mds_tpu/models/gnn.py:62)."""

    def __init__(self, in_features: int, features: int):
        super().__init__(2 * in_features, features)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return torch.tanh(torch.cat([x, adj @ x], dim=-1) @ self.weight + self.bias)


class GATLayer(nn.Module):
    """Dense graph attention (mds_tpu/models/gnn.py:76): h = x W, e_ij =
    LeakyReLU_0.2(aᵀ[h_i ∥ h_j]) where adj > 0 (−1e9 elsewhere), h' =
    tanh(softmax_j(e) h). aᵀ[h_i ∥ h_j] is taken as a₁·h_i + a₂·h_j, which
    never forms JAX's (N², 2F) concatenation."""

    def __init__(self, in_features: int, features: int, alpha: float = 0.2):
        super().__init__()
        self.alpha = alpha
        self.weight = nn.Parameter(torch.zeros(in_features, features))
        self.attn = nn.Parameter(torch.zeros(2 * features, 1))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        h = x @ self.weight
        f = h.shape[1]
        e = F.leaky_relu(h @ self.attn[:f] + (h @ self.attn[f:]).t(), self.alpha)
        e = torch.where(adj > 0, e, torch.full_like(e, -1e9))
        return torch.tanh(torch.softmax(e, dim=-1) @ h)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.xavier_uniform_(self.weight, generator=generator)
        nn.init.xavier_uniform_(self.attn, generator=generator)


class Discriminator(nn.Module):
    """Linear(128) → LeakyReLU(0.01) → dropout → Linear(1) → sigmoid
    (mds_tpu/models/gnn.py:102)."""

    def __init__(self, in_features: int, hidfeat: int = 128, dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.hidden = nn.Linear(in_features, hidfeat)
        self.out = nn.Linear(hidfeat, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        x = F.leaky_relu(self.hidden(x), 0.01)
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, generator)
        return torch.sigmoid(self.out(x))

    def init_weights(self, generator: torch.Generator) -> None:
        _xavier_dense(self.hidden, generator)
        _xavier_dense(self.out, generator)


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


def _bipartite_adjacency(block: torch.Tensor) -> torch.Tensor:
    """The (T, M) block in both off-diagonal blocks of the (T + M)²
    adjacency, row-normalized."""
    T, M = block.shape
    upper = torch.cat([block.new_zeros(T, T), block], dim=1)
    lower = torch.cat([block.t(), block.new_zeros(M, M)], dim=1)
    return normalize_adj(torch.cat([upper, lower], dim=0))


def _softmax_rows(block: torch.Tensor, cats: Sequence[int], temperature: float) -> torch.Tensor:
    """softmax(block/τ) over each dataset's rows."""
    return torch.cat([torch.softmax(b / temperature, dim=0)
                      for b in torch.split(block, tuple(cats), dim=0)])


def _cosine(feats: torch.Tensor) -> torch.Tensor:
    """The nodes' cosine similarity (norms floored at 1e-12)."""
    nf = feats / feats.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return nf @ nf.t()


class LearnableTopologyBGNN(nn.Module):
    """The BGNN and its research forks (mds_tpu/models/gnn.py:124); see the
    module docstring."""

    # GNN.model_name → constructor options (mds_tpu/models/gnn.py:184-194);
    # any other name: "direct" if it ends in "_adj", else "cosine"
    NAME_KW = {
        "learnable_topology_BGNN": dict(adj_mode="cosine"),
        "learnable_topology_BGNN_adj": dict(adj_mode="direct"),
        "learnable_topology_BGNN_adj_tg": dict(adj_mode="direct"),
        "learnable_topology_BGNN_adj3": dict(adj_mode="direct_full"),
        "learnable_topology_BGNN_sfg": dict(adj_mode="direct_full", n_gcn_layers=3),
        "learnable_topology_BGNN_unlabel": dict(adj_mode="direct", with_unlabel=True),
        "learnable_topology_BGAT": dict(adj_mode="cosine", gnn_type="GAT"),
    }
    LAYERS = {"GSAGE": GSAGELayer, "GCN": GCNLayer, "GAT": GATLayer}

    def __init__(self, dataset_cats: Sequence[int], nfeat: int = 1024,
                 nfeat_out: int = 512, nfeat_adj: int = 256, output_feat_dim: int = 512,
                 unify_ratio: float = 1.0, dropout_rate: float = 0.5,
                 gnn_type: str = "GSAGE", adj_mode: str = "direct",
                 mse_or_adv: str = "None", with_datasets_aux: bool = False,
                 init_stage: bool = False, temperature: float = 0.07,
                 n_gcn_layers: int = 4, with_unlabel: bool = False):
        super().__init__()
        if adj_mode not in ("direct", "direct_full", "cosine"):
            raise ValueError(f"adj_mode {adj_mode!r} is not direct, direct_full or cosine")
        if gnn_type not in self.LAYERS:
            raise ValueError(f"GNN_type {gnn_type!r} is not one of {sorted(self.LAYERS)}")
        self.dataset_cats = tuple(int(c) for c in dataset_cats)
        self.with_unlabel = bool(with_unlabel)
        self.eff_cats = tuple(c + self.with_unlabel for c in self.dataset_cats)
        self.total_nodes = sum(self.eff_cats)
        self.total_cats = sum(self.dataset_cats)
        self.max_num_unify_class = int(unify_ratio * self.total_cats)
        self.nfeat, self.nfeat_out = int(nfeat), int(nfeat_out)
        self.output_feat_dim = int(output_feat_dim)
        self.dropout_rate = float(dropout_rate)
        self.gnn_type, self.adj_mode, self.mse_or_adv = gnn_type, adj_mode, mse_or_adv
        self.with_datasets_aux = bool(with_datasets_aux)
        self.init_stage = bool(init_stage)
        self.temperature = float(temperature)
        T, M = self.total_nodes, self.max_num_unify_class
        self.linear_before = nn.Linear(self.nfeat, self.nfeat_out)
        if adj_mode == "cosine":
            self.linear_adj = nn.Linear(self.nfeat_out, int(nfeat_adj))
        self.linear1 = nn.Linear(self.nfeat_out, self.output_feat_dim)
        self.gcn_layers = nn.ModuleList(self.LAYERS[gnn_type](self.nfeat_out, self.nfeat_out)
                                        for _ in range(n_gcn_layers))
        self.unify_node_features = nn.Parameter(torch.zeros(M, self.nfeat))
        if self.with_unlabel:
            self.unlabel_node_features = nn.Parameter(
                torch.zeros(len(self.dataset_cats), self.nfeat))
        if adj_mode == "direct":
            self.adj_matrix = nn.Parameter(torch.zeros(T, M))
        elif adj_mode == "direct_full":
            self.adj_matrix = nn.Parameter(torch.zeros(T + M, T + M))
        if mse_or_adv == "adv":
            self.netD = nn.ModuleList(Discriminator(self.nfeat_out, dropout_rate=dropout_rate)
                                      for _ in range(n_gcn_layers))

    @classmethod
    def from_configer(cls, configer, adj_mode: Optional[str] = None, **kw):
        """mds_tpu/models/gnn.py:197-225: the GNN block of the config, its
        model_name's options from NAME_KW; `adj_mode` and `kw` win."""
        g = lambda k, d: configer.get("GNN", k, default=d)
        name = g("model_name", "learnable_topology_BGNN_adj")
        name_kw = dict(cls.NAME_KW.get(
            name, {"adj_mode": "direct" if name.endswith("_adj") else "cosine"}))
        if adj_mode is not None:
            name_kw["adj_mode"] = adj_mode
        base = dict(
            dataset_cats=tuple(configer.n_cats(i) for i in range(configer.n_datasets)),
            nfeat=int(g("nfeat", 1024)), nfeat_out=int(g("nfeat_out", 512)),
            nfeat_adj=int(g("nfeat_adj", 256)),
            output_feat_dim=int(g("output_feat_dim", 512)),
            unify_ratio=float(g("unify_ratio", 1.0)),
            dropout_rate=float(g("dropout_rate", 0.5)),
            gnn_type=g("GNN_type", "GSAGE"), mse_or_adv=g("mse_or_adv", "None"),
            with_datasets_aux=bool(configer.get("loss", "with_datasets_aux", default=False)),
            init_stage=bool(g("init_by_eval", False)))
        base.update(name_kw)
        base.update(kw)
        return cls(**base)

    # ------------------------------------------------------------ adjacency
    def calc_adjacency(self, feat1: torch.Tensor):
        """→ (normalized (T+M)² adjacency, the (T, M) bipartite block)."""
        T = self.total_nodes
        if self.adj_mode == "cosine":
            block = _softmax_rows(_cosine(self.linear_adj(feat1))[:T, T:], self.eff_cats,
                                  self.temperature)
        else:
            block = self.adj_matrix if self.adj_mode == "direct" else self.adj_matrix[:T, T:]
            if not self.init_stage:
                block = _softmax_rows(block, self.eff_cats, self.temperature)
        return _bipartite_adjacency(block), block

    # -------------------------------------------------------------- forward
    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict:
        """x: (Σ n_cats, nfeat) class-node features → dict(unify_prototype,
        bi_graphs (the per-dataset softmax blocks), adv_pairs, adj_block,
        ret_feats, and in adv mode adv_out) (gnn.py:308-359). Dropout in
        train mode only, its masks from `generator`."""
        T = self.total_nodes
        if self.with_unlabel:  # each dataset's classes, then its unlabeled node
            parts = []
            for i, xi in enumerate(torch.split(x, self.dataset_cats, dim=0)):
                parts += [xi, self.unlabel_node_features[i:i + 1].to(x.dtype)]
            x = torch.cat(parts)
        feat1 = self.linear_before(torch.cat([x, self.unify_node_features], dim=0))
        adj, block = self.calc_adjacency(feat1)
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
        out = {"unify_prototype": feat_out if self.with_datasets_aux else feat_out[T:],
               "bi_graphs": self.sep_bipartite_graphs(block),
               "adv_pairs": adv_pairs, "adj_block": block,
               "ret_feats": [f[T:] for f in feats] + [feat_out[T:]]}
        if self.mse_or_adv == "adv":
            out["adv_out"] = self.discriminate(adv_pairs, generator)
        return out

    def discriminate(self, adv_pairs, generator: Optional[torch.Generator] = None) -> Dict:
        """Each layer's discriminator on (real, fake.detach(), fake)
        (gnn.py:378-391)."""
        return {f"ADV{i + 1}": [d(real.detach(), generator), d(fake.detach(), generator),
                                d(fake, generator)]
                for i, (d, (real, fake)) in enumerate(zip(self.netD, adv_pairs))}

    def sep_bipartite_graphs(self, block: torch.Tensor) -> List[torch.Tensor]:
        """The per-dataset (eff_cats_i, M) rows of the block."""
        return list(torch.split(block, self.eff_cats, dim=0))

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
        GCN/GSAGE layers' U(−1/√out, 1/√out), GAT's and the discriminators'
        xavier, truncated normal(0.02) node features, a U(0, 1) adjacency
        (torch.rand, as the reference)."""
        _lecun_dense(self.linear_before, generator)
        if self.adj_mode == "cosine":
            _lecun_dense(self.linear_adj, generator)
        _lecun_dense(self.linear1, generator)
        for layer in self.gcn_layers:
            layer.init_weights(generator)
        _trunc_normal(self.unify_node_features, generator)
        if self.with_unlabel:
            _trunc_normal(self.unlabel_node_features, generator)
        if self.adj_mode != "cosine":
            nn.init.uniform_(self.adj_matrix, 0.0, 1.0, generator=generator)
        for d in getattr(self, "netD", ()):
            d.init_weights(generator)
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


def gumbel_noise(dataset_cats: Sequence[int], M: int,
                 generator: Optional[torch.Generator]) -> List[torch.Tensor]:
    """Standard Gumbel noise −log(−log u) a (n_cats_i, M) graph, u ~ U[tiny,
    1) in f32 drawn on the CPU from `generator` (gnn.py:429-432)."""
    tiny = torch.finfo(torch.float32).tiny
    return [-torch.log(-torch.log(torch.rand((c, M), generator=generator).clamp_min(tiny)))
            for c in dataset_cats]


def gumbel_max_graphs(block: torch.Tensor, dataset_cats: Sequence[int], tau: float,
                      noise: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The GNN.GumbelSoftmax "max" graphs (gnn.py:417): per dataset,
    softmax((10·block + noise)/τ) over its rows, differentiable."""
    return [torch.softmax((10.0 * g + z.to(g)) / tau, dim=0)
            for g, z in zip(torch.split(block, tuple(dataset_cats), dim=0), noise)]


# ------------------------------------------------- the non-BGNN graph nets
class AttentionalPropagation(nn.Module):
    """Masked multi-head attention message passing (gnn.py:438): message =
    MHA(q = x, k = v = source, mask adj > 0), out = mlp([x ∥ message])."""

    def __init__(self, in_features: int, features: int, nheads: int = 4):
        super().__init__()
        self.h, self.d = nheads, max(features // nheads, 1)
        hd = self.h * self.d
        self.q, self.k, self.v = (nn.Linear(in_features, hd) for _ in range(3))
        self.mlp = nn.Linear(in_features + hd, features)

    def forward(self, x, source, adj):
        h, d = self.h, self.d
        q = self.q(x).reshape(-1, h, d)
        k = self.k(source).reshape(-1, h, d)
        v = self.v(source).reshape(-1, h, d)
        logits = torch.einsum("nhd,mhd->hnm", q, k) / math.sqrt(d)
        logits = torch.where(adj[None] > 0, logits, torch.full_like(logits, -1e9))
        msg = torch.einsum("hnm,mhd->nhd", torch.softmax(logits, dim=-1), v).reshape(-1, h * d)
        return self.mlp(torch.cat([x, msg], dim=-1))

    def init_weights(self, generator: torch.Generator) -> None:
        for layer in (self.q, self.k, self.v, self.mlp):
            _lecun_dense(layer, generator)


def fixed_block_adjacency(dataset_cats: Sequence[int], M: int) -> np.ndarray:
    """SelfAttentionGNN's fixed adjacency (gnn.py:462): the unified rows and
    columns fully connected, identity sub-blocks on the bipartite diagonal
    (clipped where M runs out), identity within each side; D^-1/2 A D^-1/2."""
    T = int(sum(dataset_cats))
    A = np.zeros((T + M, T + M), np.float32)
    A[T:, :] = 1.0
    A[:, T:] = 1.0
    cur = 0
    for c in dataset_cats:
        cc = min(c, max(M - cur, 0))
        if cc > 0:
            A[cur:cur + cc, T + cur:T + cur + cc] = np.eye(cc)
            A[T + cur:T + cur + cc, cur:cur + cc] = np.eye(cc)
        cur += c
    A[:T, :T] = np.eye(T)
    A[T:, T:] = np.eye(M)
    r = A.sum(1)
    r_inv_sqrt = np.where(r > 0, r ** -0.5, 0.0)
    return (r_inv_sqrt[:, None] * A * r_inv_sqrt[None, :]).astype(np.float32)


def _graph_config(configer, **defaults) -> Dict:
    """The GNN block's shared sizes, and `defaults`' keys, from the config."""
    g = lambda k, d: configer.get("GNN", k, default=d)
    out = dict(dataset_cats=tuple(configer.n_cats(i) for i in range(configer.n_datasets)),
               nfeat=int(g("nfeat", 1024)), nfeat_out=int(g("nfeat_out", 512)),
               output_feat_dim=int(g("output_feat_dim", 512)),
               unify_ratio=float(g("unify_ratio", 1.0)),
               dropout_rate=float(g("dropout_rate", 0.5)))
    out.update({k: int(g(k, d)) for k, d in defaults.items()})
    return out


class SelfAttentionGNN(nn.Module):
    """Self_Attention_GNN (gnn.py:489): the fixed block adjacency, two
    AttentionalPropagation layers (the second with a residual and ELU),
    bipartite graphs softmax(arch features' similarity / 0.05) over each
    dataset's rows; `pretrain` gives the identity graphs."""

    def __init__(self, dataset_cats: Sequence[int], nfeat: int = 1024, nfeat_out: int = 512,
                 nheads: int = 4, adj_feat_dim: int = 256, output_feat_dim: int = 512,
                 unify_ratio: float = 1.0, dropout_rate: float = 0.5):
        super().__init__()
        self.dataset_cats = tuple(int(c) for c in dataset_cats)
        self.total_cats = sum(self.dataset_cats)
        self.max_num_unify_class = M = int(unify_ratio * self.total_cats)
        self.nfeat, self.dropout_rate = int(nfeat), float(dropout_rate)
        self.unify_node_features = nn.Parameter(torch.zeros(M, self.nfeat))
        self.linear_before = nn.Linear(self.nfeat, nfeat_out)
        self.attn1 = AttentionalPropagation(nfeat_out, nfeat_out, nheads)
        self.attn2 = AttentionalPropagation(nfeat_out, nfeat_out, nheads)
        self.linear1 = nn.Linear(nfeat_out, output_feat_dim)
        self.arch_linear = nn.Linear(nfeat_out, adj_feat_dim)
        self.register_buffer("adj", torch.from_numpy(
            fixed_block_adjacency(self.dataset_cats, M)), persistent=False)

    @classmethod
    def from_configer(cls, configer, **kw):
        return cls(**{**_graph_config(configer, nheads=4, adj_feat_dim=256), **kw})

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                pretrain: bool = False) -> Dict:
        T, M = self.total_cats, self.max_num_unify_class
        drop = self.training and self.dropout_rate > 0.0
        adj = self.adj.to(x.dtype)
        x = F.relu(self.linear_before(torch.cat([x, self.unify_node_features], dim=0)))
        x = dropout(x, self.dropout_rate, generator) if drop else x
        feat = self.attn1(x, x, adj)
        x = dropout(feat, self.dropout_rate, generator) if drop else feat
        x = F.elu(self.attn2(x, x, adj) + x)
        proto = self.linear1(x)
        arch = self.arch_linear(F.relu(x))
        if pretrain:
            from mds_tpu_torch.ops.uot_match import pretrain_bipartite_graphs

            graphs = [torch.from_numpy(g).to(x) for g in
                      pretrain_bipartite_graphs(self.dataset_cats, M)]
        else:
            graphs = [torch.softmax(a @ arch[T:].t() / 0.05, dim=0)
                      for a in torch.split(arch[:T], self.dataset_cats, dim=0)]
        return {"unify_prototype": proto[T:], "bi_graphs": graphs}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SelfAttentionGNN":
        _trunc_normal(self.unify_node_features, generator)
        for layer in (self.linear_before, self.linear1, self.arch_linear):
            _lecun_dense(layer, generator)
        self.attn1.init_weights(generator)
        self.attn2.init_weights(generator)
        return self


class LearnableTopologyGAT(nn.Module):
    """Learnable_Topology_GAT (gnn.py:569): the cosine adjacency of
    `linear_adj` features, nheads GAT layers concatenated (with a residual
    where the widths agree), dropout, an output GAT layer with an ELU
    residual; bipartite graphs softmax(raw block / 0.07) over each
    dataset's rows."""

    def __init__(self, dataset_cats: Sequence[int], nfeat: int = 1024, nfeat_out: int = 512,
                 nfeat_adj: int = 256, nhid: int = 128, nheads: int = 4,
                 output_feat_dim: int = 512, unify_ratio: float = 1.0,
                 dropout_rate: float = 0.5, temperature: float = 0.07):
        super().__init__()
        self.dataset_cats = tuple(int(c) for c in dataset_cats)
        self.total_cats = sum(self.dataset_cats)
        self.max_num_unify_class = M = int(unify_ratio * self.total_cats)
        self.nfeat, self.dropout_rate = int(nfeat), float(dropout_rate)
        self.temperature = float(temperature)
        self.unify_node_features = nn.Parameter(torch.zeros(M, self.nfeat))
        self.linear_before = nn.Linear(self.nfeat, nfeat_out)
        self.linear_adj = nn.Linear(nfeat_out, nfeat_adj)
        self.att1 = nn.ModuleList(GATLayer(nfeat_out, nhid) for _ in range(nheads))
        self.out_att = GATLayer(nhid * nheads, nhid * nheads)
        self.linear1 = nn.Linear(nhid * nheads, output_feat_dim)

    @classmethod
    def from_configer(cls, configer, **kw):
        return cls(**{**_graph_config(configer, nfeat_adj=256, nhid=128, nheads=4), **kw})

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> Dict:
        T = self.total_cats
        x = self.linear_before(torch.cat([x, self.unify_node_features], dim=0))
        block_raw = _cosine(self.linear_adj(x))[:T, T:]
        adj = _bipartite_adjacency(_softmax_rows(block_raw, self.dataset_cats, self.temperature))
        x = F.relu(x)
        feat = torch.cat([layer(x, adj) for layer in self.att1], dim=1)
        x = feat + x if feat.shape[-1] == x.shape[-1] else feat
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, generator)
        x = F.elu(self.out_att(x, adj) + x)
        proto = self.linear1(x)
        graphs = list(torch.split(_softmax_rows(block_raw, self.dataset_cats, 0.07),
                                  self.dataset_cats, dim=0))
        return {"unify_prototype": proto[T:], "bi_graphs": graphs, "adj_block": block_raw}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LearnableTopologyGAT":
        _trunc_normal(self.unify_node_features, generator)
        for layer in (self.linear_before, self.linear_adj, self.linear1):
            _lecun_dense(layer, generator)
        for layer in (*self.att1, self.out_att):
            layer.init_weights(generator)
        return self


# ------------------------------------- MODELS names (gnn.py:662-727)
def _bgnn(name: str, adj_mode: str, **fixed):
    def factory(configer=None, **kw):
        for k, v in fixed.items():
            kw.setdefault(k, v)
        return LearnableTopologyBGNN.from_configer(configer, adj_mode=adj_mode, **kw)

    MODELS.register(name)(factory)


for _name, _mode, _fixed in (
        ("learnable_topology_BGNN_adj", "direct", {}),
        ("learnable_topology_BGNN", "cosine", {}),
        ("learnable_topology_BGNN_unlabel", "direct", {"with_unlabel": True}),
        ("learnable_topology_BGNN_sfg", "direct_full", {"n_gcn_layers": 3}),
        ("learnable_topology_BGNN_adj3", "direct_full", {}),
        # the target-graph supervision lives in the loss (its term is
        # read from preds["target_bi_graph"], which no trainer sets)
        ("learnable_topology_BGNN_adj_tg", "direct", {}),
        ("learnable_topology_BGAT", "cosine", {"gnn_type": "GAT"})):
    _bgnn(_name, _mode, **_fixed)


@MODELS.register("self_attention_GNN")
def self_attention_gnn(configer=None, **kw):
    return SelfAttentionGNN.from_configer(configer, **kw)


@MODELS.register("learnable_topology_GAT")
def learnable_topology_gat(configer=None, **kw):
    return LearnableTopologyGAT.from_configer(configer, **kw)


@MODELS.register("graph_attention_network")
def graph_attention_network(configer=None, **kw):
    """JAX registers this name as SelfAttentionGNN (gnn.py:722-727); the
    alternating trainer, which builds through
    LearnableTopologyBGNN.from_configer, makes it the cosine BGNN."""
    return SelfAttentionGNN.from_configer(configer, **kw)
