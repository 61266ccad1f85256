"""OHEM cross-entropy losses — counterparts of mds_tpu/losses/ohem_ce.py.

Logits are NCHW (class axis 1, as the port's models return them); labels are
(B, H, W) integer maps with ignore=255. Per-pixel CE is f32 whatever the
logits' dtype. The hard-pixel rule is the exact one of
mds_tpu/ops/ohem.py `ohem_mean_exact` (:114-131): keep the valid pixels with
loss > −log(thresh); if fewer than n_min = n_valid // n_min_ratio do, keep
every pixel at or above the n_min-th largest loss instead; mean over the
kept. The selection runs under no_grad and without a host sync (the top-k is
taken at the static bound n // n_min_ratio and indexed on the device); the
mean over the kept pixels carries the gradient.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


def cross_entropy_per_pixel(logits: torch.Tensor, labels: torch.Tensor,
                            ignore: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-pixel CE, valid mask): logsumexp − true logit in f32, 0 where
    the label is `ignore` (mds_tpu/losses/ohem_ce.py:33)."""
    logits = logits.float()
    valid = labels != ignore
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=1)
    true_logit = logits.gather(1, safe.unsqueeze(1)).squeeze(1)
    return torch.where(valid, logz - true_logit, 0.0), valid


def ohem_mean(losses: torch.Tensor, valid: torch.Tensor, thresh: float,
              n_min_ratio: int = 16) -> torch.Tensor:
    """Mean over the OHEM-kept pixels; `thresh` is the −log(p) loss floor."""
    losses = losses.reshape(-1).float()
    valid = valid.reshape(-1)
    n = losses.numel()
    k = max(n // n_min_ratio, 1)  # n_min never exceeds it
    with torch.no_grad():
        n_min = valid.sum() // n_min_ratio
        masked = torch.where(valid, losses, -math.inf)
        kth = masked.topk(k).values.gather(0, (n_min - 1).clamp(0, k - 1).reshape(1))
        n_above = (masked > thresh).sum()
        cutoff = torch.where(n_above >= n_min, thresh, kth[0])
        keep = (valid & ((losses > thresh) | (losses >= cutoff))).float()
    return (losses * keep).sum() / keep.sum().clamp_min(1.0)


class OhemCELoss(nn.Module):
    """CE with the OHEM keep rule (mds_tpu/losses/ohem_ce.py:125)."""

    def __init__(self, thresh: float = 0.7, ignore_lb: int = 255,
                 n_min_ratio: int = 16):
        super().__init__()
        self.thresh = -math.log(thresh)
        self.ignore_lb = ignore_lb
        self.n_min_ratio = n_min_ratio

    def forward(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        ce, valid = cross_entropy_per_pixel(logits, labels, self.ignore_lb)
        return ohem_mean(ce, valid, self.thresh, self.n_min_ratio)


class MdsOhemCELoss(OhemCELoss):
    """Multi-dataset OHEM: per-dataset logits lists (None = absent), one
    hard-pixel pool over all of them (mds_tpu/losses/ohem_ce.py:152)."""

    def forward(self, logits_list: Sequence[Optional[torch.Tensor]],
                labels_list: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        pairs = [cross_entropy_per_pixel(lg, lb, self.ignore_lb)
                 for lg, lb in zip(logits_list, labels_list) if lg is not None]
        ce = torch.cat([c.reshape(-1) for c, _ in pairs])
        valid = torch.cat([v.reshape(-1) for _, v in pairs])
        return ohem_mean(ce, valid, self.thresh, self.n_min_ratio)
