"""Region Mutual Information loss — counterpart of mds_tpu/losses/rmi.py
(`log_det_by_cholesky` :51, `map_get_pairs` :57, `rmi_lower_bound` :73,
`rmi_loss` :115).

Logits are NCHW; labels (B, H, W) with ignore=255. The masked per-class
BCE with logits, sum over (valid + 1), plus the RMI lower bound: each
class's label and probability maps, pooled (avg by default, max, or
resized), become radius² shifted-patch vectors; the label vectors'
covariance conditioned on the probability vectors, loaded with 1e-3 on
the diagonal, gives 0.5·log det through a Cholesky factor, averaged over
the batch, over radius², summed over classes. f32 throughout, as JAX's (f64
for f64 logits, `wide`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mds_tpu_torch.models.layers import wide

_CLIP_MIN = 1e-6
_POS_ALPHA = 1e-3


def log_det_by_cholesky(mat: torch.Tensor) -> torch.Tensor:
    diag = torch.diagonal(torch.linalg.cholesky(mat), dim1=-2, dim2=-1)
    return 2.0 * torch.log(torch.clamp(diag, min=1e-12)).sum(dim=-1)


def map_get_pairs(labels: torch.Tensor, probs: torch.Tensor, radius: int = 3):
    """(N, C, H, W) maps → two (N, C, r², P) stacks of the r² shifted
    windows, P = (H − r + 1)(W − r + 1)."""
    n, c, h, w = labels.shape
    nh, nw = h - (radius - 1), w - (radius - 1)
    la = torch.stack([labels[:, :, y:y + nh, x:x + nw]
                      for y in range(radius) for x in range(radius)], dim=2)
    pr = torch.stack([probs[:, :, y:y + nh, x:x + nw]
                      for y in range(radius) for x in range(radius)], dim=2)
    return la.reshape(n, c, radius * radius, -1), pr.reshape(n, c, radius * radius, -1)


def _pool(x: torch.Tensor, pool_size: int, pool_way: int, labels: bool) -> torch.Tensor:
    p = pool_size // 2
    if pool_way == 0:
        return F.max_pool2d(x, pool_size, pool_size, p)
    if pool_way == 1:
        return F.avg_pool2d(x, pool_size, pool_size, p, count_include_pad=True)
    size = (x.shape[2] // pool_size, x.shape[3] // pool_size)
    if labels:
        return F.interpolate(x, size=size, mode="nearest-exact")
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


def rmi_lower_bound(labels: torch.Tensor, probs: torch.Tensor, radius: int = 3,
                    pool_size: int = 4, pool_way: int = 1) -> torch.Tensor:
    """labels and probs (N, C, H, W) in [0, 1] (rmi.py:73-112)."""
    if pool_size > 1:
        labels = _pool(labels, pool_size, pool_way, True)
        probs = _pool(probs, pool_size, pool_way, False)
    half_d = radius * radius
    la, pr = map_get_pairs(labels, probs, radius)
    la = la.detach()
    eye = torch.eye(half_d, dtype=la.dtype, device=la.device)
    la = la - la.mean(dim=3, keepdim=True)
    pr = pr - pr.mean(dim=3, keepdim=True)
    la_cov = la @ la.transpose(2, 3)
    pr_cov_inv = torch.linalg.inv(pr @ pr.transpose(2, 3) + eye * _POS_ALPHA)
    la_pr_cov = la @ pr.transpose(2, 3)
    appro_var = la_cov - la_pr_cov @ pr_cov_inv @ la_pr_cov.transpose(2, 3)
    rmi = 0.5 * log_det_by_cholesky(appro_var + eye * _POS_ALPHA)  # (N, C)
    return (rmi.mean(dim=0) / float(half_d)).sum()


def rmi_loss(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
             radius: int = 3, pool_size: int = 4, pool_way: int = 1,
             weight_lambda: float = 0.5, lambda_way: bool = True,
             ignore: int = 255) -> torch.Tensor:
    """The masked BCE + RMI (rmi.py:115-138)."""
    logits = wide(logits)
    labels = labels.long()
    valid = labels < num_classes
    mask = valid.to(logits.dtype)[:, None]
    onehot = F.one_hot(torch.where(valid, labels, 0), num_classes).permute(0, 3, 1, 2)
    onehot = onehot.to(logits.dtype) * mask
    bce = -(onehot * F.logsigmoid(logits) + (1 - onehot) * F.logsigmoid(-logits)) * mask
    bce_loss = bce.sum() / (mask.sum() + 1.0)
    probs = torch.sigmoid(logits) * mask + _CLIP_MIN
    rmi = rmi_lower_bound(onehot, probs, radius, pool_size, pool_way)
    if lambda_way:
        return weight_lambda * bce_loss + rmi * (1 - weight_lambda)
    return bce_loss + rmi * weight_lambda
