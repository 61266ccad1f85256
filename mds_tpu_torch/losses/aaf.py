"""Adaptive Affinity Fields loss — counterpart of mds_tpu/losses/aaf.py
(`eight_corner` :25, `adaptive_affinity_loss` :40, `AAFLoss` :85).

For patch sizes 1, 2 and 3, each pixel and its 8 corner neighbours at that
distance: the per-class binary KL divergence of the centre's and the
neighbour's probabilities (clipped to [1e-4, 1]); pairs whose classes
differ (edges) take the hinge max(0, margin − KL)·w_edge, the others
KL·w_not_edge, pairs touching an ignored pixel none; each mean over its
pairs. `AAFLoss` holds the reference's learnable (C, 3) per-class,
per-size weights as parameters (zeros: a uniform 1/3 after the softmax
over sizes, JAX's default); weights passed to the call take their place.
Logits NCHW; the neighbourhoods run NHWC inside, as JAX's; f32, or f64
for f64 logits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.models.layers import wide


def eight_corner(x: torch.Tensor, size: int, pad_value: float = 0.0) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, C, 8): the 8 corners of the (2·size + 1)²
    patch around each pixel, `pad_value` outside the image."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, size, size, size, size), value=pad_value)
    groups = [xp[:, sy:sy + h, sx:sx + w, :]
              for sy in range(0, 2 * size + 1, size) for sx in range(0, 2 * size + 1, size)
              if not (sy == size and sx == size)]
    return torch.stack(groups, dim=-1)


def adaptive_affinity_loss(labels: torch.Tensor, probs: torch.Tensor, size: int,
                           kld_margin: float = 3.0, w_edge: Optional[torch.Tensor] = None,
                           w_not_edge: Optional[torch.Tensor] = None,
                           ignore: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """labels (B, H, W), probs (B, H, W, C) → the (edge, not-edge) means."""
    c = probs.shape[-1]
    labels = labels.long()
    valid = labels != ignore
    onehot = F.one_hot(torch.where(valid, labels, 0), c).to(probs.dtype)
    lab_nb = eight_corner(labels[..., None].float(), size, float(ignore))[..., 0, :]
    valid_nb = ((lab_nb != ignore) & valid[..., None])[:, :, :, None, :]
    differ = onehot[..., None] != eight_corner(onehot, size)
    edge = (differ & valid_nb).to(probs.dtype)
    not_edge = (~differ & valid_nb).to(probs.dtype)
    probs_nb = eight_corner(probs, size)
    p = torch.clamp(probs[..., None], 1e-4, 1.0)
    pn = torch.clamp(probs_nb, 1e-4, 1.0)
    q = torch.clamp(1.0 - probs[..., None], 1e-4, 1.0)
    qn = torch.clamp(1.0 - probs_nb, 1e-4, 1.0)
    kld = p * (torch.log(p) - torch.log(pn)) + q * (torch.log(q) - torch.log(qn))
    ones = torch.ones(c, dtype=probs.dtype, device=probs.device)
    w_edge = ones if w_edge is None else w_edge
    w_not_edge = ones if w_not_edge is None else w_not_edge
    edge_term = torch.clamp(kld_margin - kld, min=0.0) * w_edge[:, None]
    not_edge_term = kld * w_not_edge[:, None]
    return ((edge_term * edge).sum() / torch.clamp(edge.sum(), min=1.0),
            (not_edge_term * not_edge).sum() / torch.clamp(not_edge.sum(), min=1.0))


class AAFLoss(nn.Module):
    """The AAF_Loss wrapper: sizes (1, 2, 3), per-class per-size weights
    softmaxed over sizes, λ₁ = λ₂ = 1 scaling and the dec = 1e-2 decay."""

    def __init__(self, num_classes: int, kld_margin: float = 3.0,
                 kld_lambda_1: float = 1.0, kld_lambda_2: float = 1.0,
                 dec: float = 1e-2, ignore: int = 255):
        super().__init__()
        self.num_classes = num_classes
        self.kld_margin, self.l1, self.l2 = kld_margin, kld_lambda_1, kld_lambda_2
        self.dec, self.ignore = dec, ignore
        self.w_edge = nn.Parameter(torch.zeros(num_classes, 3))
        self.w_not_edge = nn.Parameter(torch.zeros(num_classes, 3))

    def forward(self, logits: torch.Tensor, labels: torch.Tensor,
                w_edge: Optional[torch.Tensor] = None,
                w_not_edge: Optional[torch.Tensor] = None) -> torch.Tensor:
        """logits (B, C, H, W) at the labels' resolution."""
        probs = torch.softmax(wide(logits), dim=1).permute(0, 2, 3, 1)
        w_e = torch.softmax(self.w_edge if w_edge is None else w_edge, dim=-1)
        w_ne = torch.softmax(self.w_not_edge if w_not_edge is None else w_not_edge, dim=-1)
        total = probs.new_zeros(())
        for i, size in enumerate((1, 2, 3)):
            e, ne = adaptive_affinity_loss(labels, probs, size, self.kld_margin,
                                           w_e[:, i], w_ne[:, i], self.ignore)
            total = total + self.l1 * e * self.dec + self.l2 * ne * self.dec
        return total
