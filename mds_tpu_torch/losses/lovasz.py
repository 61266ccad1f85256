"""Lovász-softmax and the boundary-aware focal loss — counterpart of
mds_tpu/losses/lovasz.py (`lovasz_grad` :16, `lovasz_softmax_flat` :28,
`lovasz_softmax` :54, `boundary_aware_focal_loss` :67).

Logits are NCHW; labels (B, H, W) with ignore=255. Lovász sorts each
class's errors in descending order, the classes at once (a stable sort,
as jnp.argsort's, so ties keep pixel order); ignored pixels carry error 0
and no foreground. The Jaccard gradient of the sorted foreground is
detached, as the reference's Variable wrapper does: the loss's gradient
flows through the sorted errors alone. f32, or f64 for f64 logits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mds_tpu_torch.models.layers import wide


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """The Lovász extension's gradient along dim 0 of sorted foreground
    indicators (P, …)."""
    gts = gt_sorted.sum(dim=0, keepdim=True)
    intersection = gts - gt_sorted.cumsum(dim=0)
    union = gts + (1.0 - gt_sorted).cumsum(dim=0)
    jaccard = 1.0 - intersection / torch.clamp(union, min=1e-12)
    if gt_sorted.shape[0] > 1:
        jaccard = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
    return jaccard


def lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                        classes: str = "present") -> torch.Tensor:
    """probas (P, C) softmax probabilities, labels (P,), valid (P,) bool."""
    C = probas.shape[1]
    fg = ((labels[:, None] == torch.arange(C, device=labels.device))
          & valid[:, None]).to(probas.dtype)
    err = torch.where(valid[:, None], (fg - probas).abs(), 0.0)
    perm = torch.sort(-err.detach(), dim=0, stable=True).indices
    err_sorted = err.gather(0, perm)
    grad = lovasz_grad(fg.gather(0, perm))
    losses = (err_sorted * grad.detach()).sum(dim=0)
    if classes == "present":
        pm = (fg.sum(dim=0) > 0).to(losses.dtype)
        return (losses * pm).sum() / torch.clamp(pm.sum(), min=1.0)
    return losses.mean()


def lovasz_softmax(logits: torch.Tensor, labels: torch.Tensor, ignore: int = 255,
                   classes: str = "present") -> torch.Tensor:
    """NCHW logits → softmax → the flat Lovász over every pixel."""
    C = logits.shape[1]
    probas = torch.softmax(wide(logits), dim=1).permute(0, 2, 3, 1).reshape(-1, C)
    labels = labels.long().reshape(-1)
    valid = labels != ignore
    return lovasz_softmax_flat(probas, torch.where(valid, labels, 0), valid, classes)


def boundary_aware_focal_loss(logits: torch.Tensor, target: torch.Tensor,
                              alphas: torch.Tensor, gamma: float = 0.5,
                              ignore: int = 255) -> torch.Tensor:
    """Σ α·e^{γ(1 − p_t)}·(−log p_t) / #(α > 0), p_t detached in the
    factor; α (B, H, W) from a label distance transform, 0 at ignore."""
    target = target.long()
    safe = torch.where(target != ignore, target, 0)
    logpt = F.log_softmax(wide(logits), dim=1).gather(1, safe[:, None])[:, 0]
    pt = logpt.detach().exp()
    alphas = wide(alphas)
    n = torch.clamp((alphas > 0).to(alphas.dtype).sum(), min=1.0)
    return (-alphas * torch.exp(gamma * (1.0 - pt)) * logpt).sum() / n
