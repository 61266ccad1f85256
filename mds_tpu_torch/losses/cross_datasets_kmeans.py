"""The k-means-era cross-dataset loss — counterpart of
mds_tpu/losses/cross_datasets_kmeans.py (`multi_hot_nll` :35,
`update_prototypes` :49, `_match_hw` :73, `CrossDatasetsCELossKMeans`
:91-202).

- Warmup: the multi-hot NLL of each dataset's seg logits over every
  unified class its label admits (ClassRemapOneHotLabel.SegRemappingOneHot).
- Every step pushes each dataset's detached embeddings at the network
  stride into the class memory bank under their single-mapped unified
  class (losses/contrast.py `memory_bank_push`), warmup included.
- Main phase: the embeddings' similarities to the (U·P, D) prototypes
  sharpen each multi-mapped pixel's admissible set
  (ClassRemapOneHotLabel.ContrastRemapping, the similarities passed in);
  pixels left with one slot are pushed into the bank under its class; the
  temperature-scaled similarities take the multi-hot NLL against the
  sharpened mask or the single one-hot, the seg logits against the
  sharpened seg mask, and the prototypes move toward the normalised mean
  of each class's real bank entries (coefficient mix, renormalised; a class
  with none keeps its prototype), detached.
- The aux heads take the phase's mask, weighted by loss.aux_weight.

Logits and embeddings are the port's NCHW; masks have the class last, as
JAX's, so the NLL runs on class-last views. Returns (loss, metrics, bank,
prototypes); the bank is a new MemoryBank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mds_tpu_torch.data.class_remap import ClassRemapOneHotLabel
from mds_tpu_torch.losses.contrast import MemoryBank, memory_bank_push


def multi_hot_nll(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """−log of the mean admissible softmax probability over the pixels
    with a non-empty mask (the NLLPlus reduction). logits (…, C) with the
    class last, mask the same shape, bool."""
    p = torch.softmax(logits.float(), dim=-1)
    tot = (p * mask.float()).sum(dim=-1)
    valid = mask.any(dim=-1)
    mean_p = torch.where(valid, tot, 0.0).sum() / torch.clamp(valid.float().sum(), min=1.0)
    return -torch.log(torch.clamp(mean_p, min=1e-12))


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def update_prototypes(bank: MemoryBank, prototypes: torch.Tensor,
                      coefficient: float) -> torch.Tensor:
    """normalize(coef·old + (1 − coef)·normalize(mean of the class's real
    bank entries)) for each class whose queue holds one, the old prototype
    elsewhere."""
    C, M, _ = bank.feats.shape
    written = (torch.arange(M, device=bank.feats.device)[None, :]
               < bank.count[:, None]).float()
    mean = (bank.feats * written[..., None]).sum(dim=1) / torch.clamp(
        bank.count[:, None].float(), min=1.0)
    mixed = _normalize(coefficient * prototypes + (1.0 - coefficient) * _normalize(mean))
    return torch.where((bank.count > 0)[:, None], mixed, prototypes)


def _match_hw(mask: torch.Tensor, hw) -> torch.Tensor:
    """A (B, H, W, C) bool mask at spatial size hw: strided where H and W
    are multiples of it, else nearest with half-pixel centres."""
    if tuple(mask.shape[1:3]) == tuple(hw):
        return mask
    if mask.shape[1] % hw[0] == 0 and mask.shape[2] % hw[1] == 0 and mask.shape[1] >= hw[0]:
        return mask[:, ::mask.shape[1] // hw[0], ::mask.shape[2] // hw[1]]
    up = F.interpolate(mask.permute(0, 3, 1, 2).float(), size=tuple(hw), mode="nearest-exact")
    return up.permute(0, 2, 3, 1) > 0.5


def _last(t: torch.Tensor) -> torch.Tensor:
    """An NCHW tensor as (B, H, W, C)."""
    return t.permute(0, 2, 3, 1)


class CrossDatasetsCELossKMeans:
    """CrossDatasetsCELoss_KMeans on per-dataset lists (config keys
    num_unify_classes, contrast.{num_prototype, coefficient, loss_weight,
    use_contrast, temperature, update_sim_thresh}, loss.aux_weight,
    network.stride, the class_remap tables)."""

    def __init__(self, configer):
        g = lambda *k, d=None: configer.get(*k, default=d)
        self.remapper = ClassRemapOneHotLabel(configer)
        self.n = configer.n_datasets
        self.U = int(g("num_unify_classes"))
        self.P = int(g("contrast", "num_prototype", d=1))
        self.coefficient = float(g("contrast", "coefficient", d=0.9))
        self.loss_weight = float(g("contrast", "loss_weight", d=1.0))
        self.aux_weight = float(g("loss", "aux_weight", d=1.0))
        self.stride = int(g("network", "stride", d=8))
        self.use_contrast = bool(g("contrast", "use_contrast", d=True))
        self.temperature = float(g("contrast", "temperature", d=0.07))

    def __call__(self, preds: Dict, lbs: Sequence[Optional[torch.Tensor]], bank: MemoryBank,
                 prototypes: torch.Tensor, is_warmup: bool = False,
                 cur_iter=0) -> Tuple[torch.Tensor, Dict, MemoryBank, torch.Tensor]:
        """preds: "seg" (and "aux" sets) per-dataset NCHW logits, "embed"
        per-dataset NCHW embeddings at the network stride; prototypes
        (U·P, D) unit-norm."""
        seg_list, embeds = preds["seg"], preds.get("embed")
        ref = next(t for t in seg_list if t is not None)
        total_seg = ref.new_zeros((), dtype=torch.float32)
        total_contrast = ref.new_zeros((), dtype=torch.float32)
        contrast_on = self.use_contrast and not is_warmup
        ignore, s = self.remapper.ignore_index, self.stride
        for i in range(self.n):
            logits, lb = seg_list[i], lbs[i]
            if logits is None or lb is None:
                continue
            lb = lb.long()
            hw = logits.shape[2:]
            if self.use_contrast and embeds is not None and embeds[i] is not None:
                embed = _last(embeds[i]).detach().float()
                D = embed.shape[-1]
                lb_small = lb[:, ::s, ::s]
                uni = self.remapper.SingleSegRemapping(lb_small, i)
                bank = memory_bank_push(bank, embed.reshape(-1, D), uni.reshape(-1))
            if not contrast_on:
                seg_mask = self.remapper.SegRemappingOneHot(lb, i)
                total_seg = total_seg + multi_hot_nll(_last(logits), _match_hw(seg_mask, hw))
            else:
                sim = torch.einsum("bhwd,ud->bhwu", _last(embeds[i]).float(), prototypes)
                cm, seg_mask = self.remapper.ContrastRemapping(lb, sim.detach(), i, cur_iter)
                assigned = torch.where((cm.sum(dim=-1) == 1) & (uni == ignore),
                                       cm.to(torch.uint8).argmax(dim=-1) // self.P, ignore)
                bank = memory_bank_push(bank, embed.reshape(-1, D), assigned.reshape(-1))
                one_hot = self.remapper.SingleSegRemappingOneHot(lb_small, i)
                if self.P > 1:
                    one_hot = one_hot.repeat_interleave(self.P, dim=-1)
                total_contrast = total_contrast + multi_hot_nll(sim / self.temperature,
                                                                cm | one_hot)
                total_seg = total_seg + multi_hot_nll(_last(logits), _match_hw(seg_mask, hw))
            for aux_set in preds.get("aux", []) or []:
                if aux_set[i] is None:
                    continue
                total_seg = total_seg + self.aux_weight * multi_hot_nll(
                    _last(aux_set[i]), _match_hw(seg_mask, aux_set[i].shape[2:]))
        if contrast_on:
            prototypes = update_prototypes(bank, prototypes, self.coefficient).detach()
        loss = total_seg + self.loss_weight * total_contrast
        return loss, {"loss": loss, "seg_loss": total_seg,
                      "contrast_loss": total_contrast}, bank, prototypes
