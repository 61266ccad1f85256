"""The loss-helper family — counterpart of mds_tpu/losses/helpers.py
(`recall_cross_entropy` :20, `focal_loss` :47, `nll_plus_loss` :67,
`weighted_nll_plus_loss` :87, `adj_nll_plus_loss` :97, `circle_loss` :114,
`multi_label_cross_entropy` :125).

Logits and their per-class masks are NCHW (class axis 1, as the port's
models return them); label maps are (B, H, W) with ignore = 255.
`multi_label_cross_entropy` and `circle_loss` take rows with the class on
the last axis, (N, C), as JAX's. The per-pixel math is f32 whatever the
logits' dtype, f64 where they are f64.

In a data-parallel step (parallel/mesh.py; the multi-prototype contrast
trainer at world size > 1) the two losses that trainer takes reduce over
the global batch: `multi_label_cross_entropy` returns this rank's rows'
sum over the global row count (its share of the global mean), and
`weighted_nll_plus_loss` takes −log of the global mean (the sum and the
count through `global_sum`), which every rank then holds whole, weighted
1/world.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mds_tpu_torch.losses.ohem_ce import cross_entropy_per_pixel
from mds_tpu_torch.models.layers import resize_bilinear_ac, wide
from mds_tpu_torch.parallel import mesh


def _pick(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values (B, C, H, W), idx (B, H, W) → values[b, idx, h, w]."""
    return values.gather(1, idx.unsqueeze(1)).squeeze(1)


def recall_cross_entropy(logits: torch.Tensor, target: torch.Tensor, n_classes: int,
                         ignore: int = 255) -> torch.Tensor:
    """CE weighted by each class's false-negative rate: weight[c] = the
    misclassified pixels of class c over its pixels, a count of 0 read as
    1, and 0 for ignore."""
    logits = wide(logits)
    target = target.long()
    valid = target != ignore
    tgt = torch.where(valid, target, ignore).reshape(-1)
    wrong = (logits.argmax(dim=1).reshape(-1) != tgt) & valid.reshape(-1)
    size = ignore + 1
    gt_counts = logits.new_zeros(size).index_add_(0, tgt, valid.reshape(-1).to(logits.dtype))
    fn_counts = logits.new_zeros(size).index_add_(0, tgt, wrong.to(logits.dtype))
    weight = (torch.where(fn_counts > 0, fn_counts, 1.0)
              / torch.where(gt_counts > 0, gt_counts, 1.0))
    weight[ignore] = 0.0
    ce, _ = cross_entropy_per_pixel(logits, target, ignore)
    return (weight[tgt].reshape(target.shape) * ce).mean()


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
               alpha: Optional[torch.Tensor] = None, ignore: int = 255,
               reduction: str = "mean") -> torch.Tensor:
    """FL(p) = −α (1 − p)^γ log p over the valid pixels; reduction "mean"
    (over the valid count, at least 1), "sum" or "none"."""
    ce, valid = cross_entropy_per_pixel(logits, target, ignore)
    fl = (1 - torch.exp(-ce)) ** gamma * ce
    if alpha is not None:
        fl = fl * alpha[torch.where(valid, target, 0).long()]
    fl = torch.where(valid, fl, 0.0)
    if reduction == "none":
        return fl
    if reduction == "sum":
        return fl.sum()
    return fl.sum() / valid.sum().clamp_min(1).to(fl.dtype)


def nll_plus_loss(logits: torch.Tensor, labels_k: Sequence[torch.Tensor],
                  ignore: int = 255) -> torch.Tensor:
    """Multi-positive NLL: for each admissible label map, the mean softmax
    probability at its valid pixels; −log of their sum."""
    p = torch.softmax(wide(logits), dim=1)
    total = None
    for lb in labels_k:
        lb = lb.long()
        valid = lb != ignore
        picked = _pick(p, torch.where(valid, lb, 0))
        val = torch.where(valid, picked, 0.0).sum() / valid.sum().clamp_min(1).to(p.dtype)
        total = val if total is None else total + val
    return -torch.log(total.clamp_min(1e-12))


def weighted_nll_plus_loss(logits: torch.Tensor, weighted_mask: torch.Tensor) -> torch.Tensor:
    """−log of the mean over pixels of Σ_c softmax(x)_c · mask_c; the mask
    (B, C, H, W) as the logits. In a data-parallel step the mean is over
    every rank's pixels, and this rank's share is 1/world of the loss."""
    b, _, h, w = logits.shape
    p = torch.softmax(wide(logits), dim=1)
    total = (p * weighted_mask.to(p.dtype)).sum()
    total, count = mesh.step_sum(torch.stack([total, total.new_tensor(b * h * w)]))
    return -torch.log((total / count).clamp_min(1e-12)) * mesh.replicated_share()


def adj_nll_plus_loss(logits: torch.Tensor, adj: torch.Tensor, lb: torch.Tensor,
                      ignore: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax → the graph's class probabilities einsum('bchw,nc->bnhw')
    → align-corners bilinear to the label's size → NLL at the label.
    → (per-pixel losses, 0 where ignored; valid mask)."""
    p = torch.softmax(wide(logits), dim=1)
    probs = torch.einsum("bchw,nc->bnhw", p, adj.to(p.dtype))
    probs = resize_bilinear_ac(probs, tuple(lb.shape[-2:]))
    nll = -torch.log(probs.clamp_min(1e-12))
    lb = lb.long()
    valid = lb != ignore
    return torch.where(valid, _pick(nll, torch.where(valid, lb, 0)), 0.0), valid


def circle_loss(sp: torch.Tensor, sn: torch.Tensor, m: float, gamma: float) -> torch.Tensor:
    """CircleLoss over positive similarities `sp` and negative `sn`
    (reduced over axis 0); the margins' weights take no gradient."""
    ap = torch.clamp(-sp.detach() + 1 + m, min=0.0)
    an = torch.clamp(sn.detach() + m, min=0.0)
    logit_p = -ap * (sp - (1 - m)) * gamma
    logit_n = an * (sn - m) * gamma
    return F.softplus(torch.logsumexp(logit_n, dim=0) + torch.logsumexp(logit_p, dim=0))


def multi_label_cross_entropy(logits: torch.Tensor, multi_hot: torch.Tensor,
                              m: float = 0.0, gamma: float = 1.0) -> torch.Tensor:
    """Circle-style multi-label CE over rows (…, C) with multi-hot targets:
    softplus(logsumexp over the negatives of (x + m)·γ + logsumexp over the
    positives of −x·γ), masked entries at −1e12; the mean over rows (in a
    data-parallel step, every rank's rows)."""
    c = logits.shape[-1]
    x = wide(logits).reshape(-1, c)
    pos = multi_hot.reshape(-1, c) > 0
    logit_p = torch.where(pos, -x * gamma, -1e12)
    logit_n = torch.where(~pos, (x + m) * gamma, -1e12)
    rows = F.softplus(torch.logsumexp(logit_n, dim=-1) + torch.logsumexp(logit_p, dim=-1))
    # in a data-parallel step, this rank's share of the mean over every rank's rows
    return rows.sum() / mesh.step_sum(rows.new_tensor(rows.shape[0]))
