"""The FS ("fully supervised") loss wrappers and SegFix — counterpart of
mds_tpu/losses/fs.py (`fs_ce` :42, `FSCELoss` :58, `FSOhemCELoss` :81,
`FSAuxCELoss` :99, `FSRMILoss` :117, `FSAuxRMILoss` :130, `FSCELOVASZLoss`
:149, `distance_to_mask_label` :167, `angle_to_direction_label` :178,
`SegFixLoss` :201).

Logits NCHW; labels (B, H, W). A label map of another size than the
logits is resized to theirs by nearest neighbour with half-pixel centres
(jax.image.resize "nearest"). The OHEM wrapper runs the port's exact keep
rule (losses/ohem_ce.py; JAX's default is its bisection, which keeps the
same pixels unless the n_min-th largest loss decides). SegFix's two label
helpers are JAX's own (the reference imports a module its tree lacks):
boundary where the distance transform is under the threshold, direction
the angle quantised into sectors, −1 where invalid.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from mds_tpu_torch.losses.lovasz import lovasz_softmax
from mds_tpu_torch.losses.ohem_ce import OhemCELoss, cross_entropy_per_pixel
from mds_tpu_torch.losses.rmi import rmi_loss
from mds_tpu_torch.models.layers import wide


def _scale_target(target: torch.Tensor, hw) -> torch.Tensor:
    """A (B, H, W) label map resized to hw by nearest neighbour."""
    target = target.long()
    if tuple(target.shape[1:3]) == tuple(hw):
        return target
    return F.interpolate(target[:, None].float(), size=tuple(hw),
                         mode="nearest-exact")[:, 0].long()


def fs_ce(logits: torch.Tensor, target: torch.Tensor, class_weight=None,
          ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over the valid pixels, each weighted by its class's weight
    where given."""
    target = _scale_target(target, logits.shape[2:])
    ce, valid = cross_entropy_per_pixel(logits, target, ignore_index)
    w = valid.float()
    if class_weight is not None:
        cw = torch.as_tensor(class_weight, dtype=torch.float32, device=logits.device)
        w = cw[torch.clamp(target, 0, len(class_weight) - 1)] * w
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def _loss_params(configer):
    return (configer.get("loss", "params", default={}) or {}) if configer is not None else {}


def _loss_weights(configer, seg_weight: float, aux_weight: float):
    if configer is None:
        return seg_weight, aux_weight
    lw = configer.get("network", "loss_weights", default={}) or {}
    return float(lw.get("seg_loss", seg_weight)), float(lw.get("aux_loss", aux_weight))


class FSCELoss:
    """CE over one tensor or a weighted list of tensors (`loss.params`
    ce_ignore_index and ce_weight)."""

    def __init__(self, configer=None, ignore_index: int = 255, class_weight=None):
        params = _loss_params(configer)
        self.ignore_index = int(params.get("ce_ignore_index", ignore_index))
        self.class_weight = params.get("ce_weight", class_weight)

    def __call__(self, inputs, target, weights: Optional[Sequence] = None):
        if isinstance(inputs, (list, tuple)):
            weights = [1.0] * len(inputs) if weights is None else weights
            return sum(w * fs_ce(x, target, self.class_weight, self.ignore_index)
                       for w, x in zip(weights, inputs))
        return fs_ce(inputs, target, self.class_weight, self.ignore_index)


class FSOhemCELoss:
    """The OHEM CE on the label map resized to the logits (`loss.params`
    ohem_thresh, ce_ignore_index)."""

    def __init__(self, configer=None, thresh: float = 0.7, ignore_index: int = 255):
        params = _loss_params(configer)
        self._ohem = OhemCELoss(float(params.get("ohem_thresh", thresh)),
                                int(params.get("ce_ignore_index", ignore_index)))

    def __call__(self, logits, target):
        return self._ohem(logits, _scale_target(target, logits.shape[2:]))


class FSAuxCELoss:
    """seg_weight·CE(seg) + aux_weight·CE(aux); inputs (aux, seg)
    (`network.loss_weights` seg_loss and aux_loss)."""

    def __init__(self, configer=None, seg_weight: float = 1.0, aux_weight: float = 0.4,
                 **kw):
        self.seg_weight, self.aux_weight = _loss_weights(configer, seg_weight, aux_weight)
        self.ce = FSCELoss(configer, **kw)

    def __call__(self, inputs, target):
        aux_out, seg_out = inputs
        return (self.seg_weight * self.ce(seg_out, target)
                + self.aux_weight * self.ce(aux_out, target))


class FSRMILoss:
    """RMI on the main head."""

    def __init__(self, configer=None, ignore_index: int = 255):
        self.ignore_index = ignore_index

    def __call__(self, logits, target):
        return rmi_loss(logits, _scale_target(target, logits.shape[2:]),
                        num_classes=logits.shape[1], ignore=self.ignore_index)


class FSAuxRMILoss:
    """seg_weight·RMI(seg) + aux_weight·CE(aux); inputs (aux, seg)."""

    def __init__(self, configer=None, seg_weight: float = 1.0, aux_weight: float = 0.4):
        self.seg_weight, self.aux_weight = _loss_weights(configer, seg_weight, aux_weight)
        self.ce = FSCELoss(configer)
        self.rmi = FSRMILoss(configer)

    def __call__(self, inputs, target):
        aux_out, seg_out = inputs
        return (self.seg_weight * self.rmi(seg_out, target)
                + self.aux_weight * self.ce(aux_out, target))


class FSCELOVASZLoss:
    """ce_weight·CE + lovasz_weight·Lovász-softmax."""

    def __init__(self, configer=None, ce_weight: float = 1.0, lovasz_weight: float = 1.0,
                 ignore_index: int = 255):
        self.ce = FSCELoss(configer, ignore_index=ignore_index)
        self.ce_weight, self.lovasz_weight = ce_weight, lovasz_weight
        self.ignore_index = ignore_index

    def __call__(self, logits, target):
        target = _scale_target(target, logits.shape[2:])
        return (self.ce_weight * self.ce(logits, target)
                + self.lovasz_weight * lovasz_softmax(logits, target, ignore=self.ignore_index))


# --------------------------------------------------------------------- SegFix
def distance_to_mask_label(distance_map: torch.Tensor, seg_label_map: torch.Tensor,
                           boundary_threshold: float = 5.0,
                           ignore_index: int = 255) -> torch.Tensor:
    """1 where the distance is under the threshold and the label valid, 0
    elsewhere, −1 at invalid labels (int64)."""
    valid = seg_label_map != ignore_index
    mask = (distance_map < boundary_threshold) & valid
    return torch.where(valid, mask.long(), -1)


def angle_to_direction_label(angle_map: torch.Tensor, seg_label_map: torch.Tensor,
                             num_directions: int = 8, extra_ignore_mask=None,
                             ignore_index: int = 255) -> torch.Tensor:
    """Angles in degrees ([−180, 180]) → one of `num_directions` sectors;
    −1 at invalid labels and where `extra_ignore_mask` is set."""
    ang = torch.remainder(angle_map.float() + 180.0, 360.0)
    lab = torch.clamp(torch.floor(ang / (360.0 / num_directions)).long(), 0, num_directions - 1)
    invalid = seg_label_map == ignore_index
    if extra_ignore_mask is not None:
        invalid = invalid | extra_ignore_mask
    return torch.where(invalid, -1, lab)


def _balanced_weights(label_map: torch.Tensor, num_classes: int) -> torch.Tensor:
    """1 − each class's share of the labelled (≥ 0) pixels."""
    oh = F.one_hot(torch.clamp(label_map, 0, num_classes - 1), num_classes).float()
    counts = (oh * (label_map >= 0)[..., None].float()).reshape(-1, num_classes).sum(dim=0)
    return 1.0 - counts / torch.clamp(counts.sum(), min=1.0)


def _weighted_ce(logits: torch.Tensor, target: torch.Tensor,
                 class_weight: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(wide(logits), dim=1)
    t = torch.clamp(target, 0, logits.shape[1] - 1)
    nll = -logp.gather(1, t[:, None])[:, 0]
    w = class_weight[t] * (target >= 0).float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


class SegFixLoss:
    """Boundary-mask CE + direction CE, each class-balanced. inputs =
    (pred_mask (B, 2, H, W), pred_direction (B, D, H, W)); targets =
    (seg_label_map, distance_map, angle_map)."""

    def __init__(self, configer=None, mask_weight: float = 1.0,
                 direction_weight: float = 1.0, mask_threshold: float = 0.5,
                 ignore_index: int = 255):
        self.mask_weight, self.direction_weight = mask_weight, direction_weight
        self.mask_threshold, self.ignore_index = mask_threshold, ignore_index

    def __call__(self, inputs, targets):
        pred_mask, pred_direction = inputs
        seg_label, distance_map, angle_map = targets
        gt_mask = distance_to_mask_label(distance_map, seg_label, ignore_index=self.ignore_index)
        mask_loss = _weighted_ce(pred_mask, gt_mask, _balanced_weights(gt_mask, 2))
        binary = torch.softmax(pred_mask.float(), dim=1)[:, 1] > self.mask_threshold
        n_dir = pred_direction.shape[1]
        gt_dir = angle_to_direction_label(angle_map, seg_label, n_dir, extra_ignore_mask=~binary,
                                          ignore_index=self.ignore_index)
        dir_loss = _weighted_ce(pred_direction, gt_dir, _balanced_weights(gt_dir, n_dir))
        return self.mask_weight * mask_loss + self.direction_weight * dir_loss
