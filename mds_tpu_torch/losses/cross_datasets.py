"""The cross-dataset loss of the flagship's alternating trainer —
counterpart of mds_tpu/losses/cross_datasets.py (`similarity_dsb` :41,
`CrossDatasetsCELossAdvGNN` :53).

Terms, as JAX reproduces the reference's CrossDatasetsCELoss_AdvGNN:
- remap CE: per dataset, features × (unified prototype folded into the
  bipartite graph: (f·Pᵀ)·Gᵀ = f·(Pᵀ·Gᵀ), exact reassociation that never
  forms the (B, M, h, w) unified volume), ×4 bilinear (align_corners=True,
  f32), one OHEM pool over every dataset at 0.4 (`MdsOhemCELoss`, the
  exact rule); with 2n graphs [max0, soft0, ...] the max- and softmax-graph
  CEs mix by `max_rate`;
- orth: the entropy of softmax(P·Pᵀ/τ) of the unified prototypes;
- spa (Σ‖softmax graph‖²), max_enc (mean (max over the unified columns −
  1)²), the adjacency target (masked squared error ÷ M);
- aux: each dataset's aux-prototype logits, ×4 up, OHEM at 0.7, × aux_weight;
- init stage: graph MSE ×10 to the identity graphs, prototype MSE ×10·n to
  the frozen seg prototypes;
- `mse`: the squared differences of the first 3 consecutive GCN layers;
  `adv`: the generator's BCE of the first 3 discriminators on the live
  fake features (target 0) × adv_loss_weight into the loss, and the
  discriminators' BCE (real → 0, detached fake → 1) as metrics["adv_loss"],
  which the trainer adds before its one backward.

Per-dataset tensors arrive as lists (None for an absent dataset): features
(B, D, h, w) in the compute dtype, labels (B, H, W) at the crop's
resolution. JAX recomputes the remap → upsample → OHEM region in the
backward (jax.checkpoint, for v5e's 16 GB); the port keeps its activations:
on an H100 the recompute saved 0.69 of the flagship SEG step's 10.49 GB and
no time (PERF.md §6).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from mds_tpu_torch.losses.ohem_ce import MdsOhemCELoss, OhemCELoss
from mds_tpu_torch.models.layers import resize_bilinear_ac, wide
from mds_tpu_torch.models.semseg import proto_logits, remap_logits


def similarity_dsb(proto_vecs: torch.Tensor, temperature: float = 0.07,
                   reduce: str = "mean") -> torch.Tensor:
    """Entropy of the prototype self-similarity softmax (cross_datasets.py:41)."""
    z = proto_vecs @ proto_vecs.t() / temperature
    h = torch.softmax(z, dim=1) * torch.log_softmax(z, dim=1)
    return -h.mean() if reduce == "mean" else -h.sum()


def _bce(p: torch.Tensor, y: float, eps: float = 1e-7) -> torch.Tensor:
    """Mean binary cross-entropy of probabilities `p` against the constant
    label `y` (cross_datasets.py:290-292)."""
    return -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps)).mean()


class CrossDatasetsCELossAdvGNN:
    def __init__(self, configer):
        g = lambda *k, d=None: configer.get(*k, default=d)
        self.n_datasets = configer.n_datasets
        self.n_cats = [configer.n_cats(i) for i in range(self.n_datasets)]
        self.total_cats = sum(self.n_cats)
        self.temperature = float(g("contrast", "temperature", d=0.07))
        self.with_datasets_aux = bool(g("loss", "with_datasets_aux", d=False))
        self.with_orth = bool(g("GNN", "with_orth", d=False))
        self.orth_weight = float(g("GNN", "orth_weight", d=1.0))
        self.with_spa = bool(g("loss", "with_spa", d=False))
        self.spa_loss_weight = float(g("loss", "spa_loss_weight", d=0.1))
        self.with_max_enc = bool(g("loss", "with_max_enc", d=False))
        self.max_enc_weight = float(g("loss", "max_enc_weight", d=1.0))
        self.aux_weight = float(g("loss", "aux_weight", d=0.2))
        self.adv_loss_weight = float(g("loss", "adv_loss_weight", d=1.0))
        self.adj_loss_weight = float(g("loss", "adj_loss_weight", d=1.0))
        self.mse_or_adv = g("GNN", "mse_or_adv", d="None")
        self.with_softmax_and_max = bool(g("GNN", "output_softmax_and_max_adj", d=False))
        self.with_max_adj = bool(g("GNN", "output_max_adj", d=False))
        self.ohem = OhemCELoss(0.7)
        self.mds_ohem = MdsOhemCELoss(0.4)

    # ---------------------------------------------------------------- pieces
    def _remap_ce(self, feats, graphs, targets, upscale: int = 4, proto=None):
        """Per-dataset remap, ×upscale bilinear (align_corners=True), one
        OHEM pool. proto given: `feats` are features and the prototype is
        folded into each graph (cross_datasets.py:81-124)."""

        logits, labels = [], []
        for lg, g, lb in zip(feats, graphs, targets):
            if lg is None:
                continue
            if proto is not None:
                fold = torch.einsum("md,cm->dc", wide(proto), wide(g))
                rl = torch.einsum("bdhw,dc->bchw", wide(lg), wide(fold.to(lg.dtype)))
            else:
                rl = remap_logits(lg, g)
            h, w = rl.shape[-2:]
            logits.append(resize_bilinear_ac(rl, (h * upscale, w * upscale)))
            labels.append(lb.long())
        return self.mds_ohem(logits, labels)

    def _aux_ce(self, aux_logits, target):
        return self.ohem(resize_bilinear_ac(aux_logits, target.shape[-2:]), target.long())

    def _split_aux(self, unify_prototype, bi_graphs) -> bool:
        """Whether the prototype carries the aux rows in front (Σ n_cats +
        M rows, the GNN's layout) rather than the seg model's M."""
        return (self.with_datasets_aux and unify_prototype.shape[0]
                != (bi_graphs[0].shape[1] if bi_graphs else -1))

    # ------------------------------------------------------------------ main
    def __call__(self, preds: Dict[str, Any], targets: Sequence[Optional[torch.Tensor]], *,
                 is_adv: bool = True, init_gnn_stage: bool = False,
                 max_rate: float = 0.0, second_stage: bool = False):
        """preds: "seg" the per-dataset features; "unify_prototype" (Σ n_cats
        + M, D), (M, D) or None; "bi_graphs" n or 2n graphs; "aux",
        "adv_pairs", "adv_out", "adj_block", "pretrain_bipart_graph", "seg_prototype",
        "target_bi_graph" where the stage has them. → (loss, metrics)."""
        n = self.n_datasets
        feats = preds["seg"]
        proto = preds.get("unify_prototype")
        bi_graphs = preds.get("bi_graphs", [])
        metrics: Dict[str, torch.Tensor] = {}
        loss = 0.0

        aux_logits = preds.get("aux")
        fold_proto = None
        if proto is not None and not init_gnn_stage:
            if self._split_aux(proto, bi_graphs):
                aux_logits, cur = [], 0
                for i in range(n):
                    f = feats[i]
                    aux_logits.append(None if f is None else
                                      proto_logits(f, proto[cur:cur + self.n_cats[i]]))
                    cur += self.n_cats[i]
                fold_proto = proto[self.total_cats:]
            else:
                fold_proto = proto

        if is_adv and self.with_orth and proto is not None:
            up = proto[self.total_cats:] if self._split_aux(proto, bi_graphs) else proto
            orth = self.orth_weight * similarity_dsb(up, self.temperature)
            loss = loss + orth
            metrics["orth_loss"] = orth

        two_n = len(bi_graphs) == 2 * n
        tbg = preds.get("target_bi_graph")
        for i in range(n):
            if targets[i] is None:
                continue
            if is_adv and self.with_spa and not second_stage and two_n:
                loss = loss + self.spa_loss_weight * bi_graphs[2 * i + 1].square().sum()
            if is_adv and self.with_max_enc:
                g = bi_graphs[2 * i] if two_n else bi_graphs[i]
                loss = loss + self.max_enc_weight * (g.max(dim=1).values - 1.0).square().mean()
            if is_adv and tbg is not None and not second_stage:
                g = bi_graphs[2 * i + 1] if two_n else bi_graphs[i]
                mask = (tbg[i] != 255).float()
                adj_l = ((g - tbg[i]) * mask).square().sum() / g.shape[1]
                loss = loss + self.adj_loss_weight * adj_l
                metrics["adj_loss"] = metrics.get("adj_loss", 0.0) + adj_l

        if self.with_datasets_aux and aux_logits is not None and not init_gnn_stage:
            aux_total = 0.0
            for i in range(n):
                if aux_logits[i] is not None and targets[i] is not None:
                    aux_total = aux_total + self._aux_ce(aux_logits[i], targets[i])
            loss = loss + self.aux_weight * aux_total
            metrics["aux_loss"] = aux_total

        if not init_gnn_stage:
            if (is_adv and self.with_softmax_and_max and self.with_max_adj
                    and not second_stage and two_n):
                ce_max = self._remap_ce(feats, bi_graphs[0::2], targets, proto=fold_proto)
                ce_soft = self._remap_ce(feats, bi_graphs[1::2], targets, proto=fold_proto)
                ce = max_rate * ce_max + (1.0 - max_rate) * ce_soft
            else:
                graphs = bi_graphs[0::2] if two_n else bi_graphs
                ce = self._remap_ce(feats, graphs, targets, proto=fold_proto)
            loss = loss + ce
            metrics["ce_loss"] = ce

        if init_gnn_stage:
            pbg = preds.get("pretrain_bipart_graph")
            if preds.get("adj_block") is not None and pbg is not None:
                graph_l, cur = 0.0, 0
                for j in range(n):
                    blk = preds["adj_block"][cur:cur + self.n_cats[j]]
                    graph_l = graph_l + 10.0 * (blk - pbg[j]).square().mean()
                    cur += self.n_cats[j]
                loss = loss + graph_l
                metrics["graph_loss"] = graph_l
            if proto is not None and preds.get("seg_prototype") is not None:
                mse = n * 10.0 * (proto - preds["seg_prototype"]).square().mean()
                loss = loss + mse
                metrics["init_proto_mse"] = mse

        if is_adv and self.mse_or_adv == "mse" and "adv_pairs" in preds:
            adv = sum((fake - real).square().mean() for real, fake in preds["adv_pairs"][:3])
            loss = loss + self.adv_loss_weight * adv
            metrics["adv_loss"] = adv
        elif is_adv and self.mse_or_adv == "adv" and "adv_out" in preds:
            d = preds["adv_out"]
            g_fake = sum(_bce(d[f"ADV{k}"][2], 0.0) for k in (1, 2, 3))
            d_loss = sum(_bce(d[f"ADV{k}"][0], 0.0) + _bce(d[f"ADV{k}"][1], 1.0)
                         for k in (1, 2, 3))
            loss = loss + self.adv_loss_weight * g_fake
            metrics["adv_loss"] = d_loss  # the discriminators' loss

        metrics["loss"] = loss
        return loss, metrics
