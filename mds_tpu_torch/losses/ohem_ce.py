"""OHEM cross-entropy losses — counterparts of mds_tpu/losses/ohem_ce.py
(`cross_entropy_per_pixel` :33, `_phase_taps` :46, `cross_entropy_upsampled`
:60, `OhemCELoss` :125 with `upsampled` :140, `MdsOhemCELoss` :152,
`MdsOhemNLLPlusLoss` :182).

Logits are NCHW (class axis 1, as the port's models return them); labels are
(B, H, W) integer maps with ignore=255. Per-pixel CE is f32 whatever the
logits' dtype. The hard-pixel rule is the exact one of
mds_tpu/ops/ohem.py `ohem_mean_exact` (:114-131): keep the valid pixels with
loss > −log(thresh); if fewer than n_min = n_valid // n_min_ratio do, keep
every pixel at or above the n_min-th largest loss instead; mean over the
kept. The selection runs under no_grad and without a host sync (the top-k is
taken at the static bound n // n_min_ratio and indexed on the device); the
mean over the kept pixels carries the gradient. In a SyncBN step
(parallel/mesh.py) the pool is every rank's pixels, as in JAX's sharded
step: each rank returns its kept sum over the global kept count.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.parallel import mesh


def cross_entropy_per_pixel(logits: torch.Tensor, labels: torch.Tensor,
                            ignore: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-pixel CE, valid mask): logsumexp − true logit in f32, 0 where
    the label is `ignore` (mds_tpu/losses/ohem_ce.py:33); f64 logits stay
    f64."""
    logits = logits if logits.dtype == torch.float64 else logits.float()
    valid = labels != ignore
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=1)
    true_logit = logits.gather(1, safe.unsqueeze(1)).squeeze(1)
    return torch.where(valid, logz - true_logit, 0.0), valid


def _phase_taps(f: int) -> List[Tuple[int, float]]:
    """Bilinear ×f (half-pixel) per output phase p: out[f·q + p] =
    (1 − frac)·src[q − 1 + a] + frac·src[q + a]; returns [(a, frac)]."""
    taps = []
    for p in range(f):
        off = (p + 0.5) / f - 0.5
        taps.append((0, 1.0 + off) if off < 0 else (1, off))
    return taps


def cross_entropy_upsampled(logits: torch.Tensor, labels: torch.Tensor,
                            factor: int, ignore: int = 255
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel CE of the ×factor bilinear upsample (half-pixel, edges
    replicated) of `logits` (B, C, hs, ws) against `labels` (B, hs·f,
    ws·f), in the f² sub-pixel phases of the upsample: (ce, valid), each
    (f², B, hs, ws) in JAX's phase-major order. As a multiset of pixels it
    is the CE of the upsampled logits.

    Phases that take the same two taps differ only in their blend weight,
    so they run as one broadcast axis: at most 2 × 2 groups of row and
    column phases. Each group's blend (npr, npc, B, C, hs, ws) is an f32
    tensor that eager PyTorch materializes and keeps for the backward:
    together the groups hold as many elements as the upsampled volume."""
    b, c, hs, ws = logits.shape
    f = int(factor)
    if labels.shape[-2:] != (hs * f, ws * f):
        raise ValueError(f"labels {tuple(labels.shape)} are not logits "
                         f"{tuple(logits.shape)} × {f}")
    taps = _phase_taps(f)
    fracs = [fr for _, fr in taps]
    n_lo = sum(1 for a, _ in taps if a == 0)  # phases with taps (q − 1, q)
    xp = F.pad(logits.float(), (1, 1, 1, 1), mode="replicate")
    lab5 = labels.reshape(b, hs, f, ws, f)
    groups = [(0, 0, n_lo), (1, n_lo, f)]
    ces, vals = [], []
    for ra, r_lo, r_hi in groups:
        if r_lo == r_hi:
            continue
        npr = r_hi - r_lo
        frs = torch.tensor(fracs[r_lo:r_hi], dtype=torch.float32,
                           device=logits.device).reshape(npr, 1, 1, 1, 1)
        r0 = xp[:, :, ra:ra + hs][None]
        r1 = xp[:, :, ra + 1:ra + 1 + hs][None]
        t = (1.0 - frs) * r0 + frs * r1  # (npr, B, C, hs, ws + 2)
        for ca, c_lo, c_hi in groups:
            if c_lo == c_hi:
                continue
            npc = c_hi - c_lo
            fcs = torch.tensor(fracs[c_lo:c_hi], dtype=torch.float32,
                               device=logits.device).reshape(1, npc, 1, 1, 1, 1)
            c0 = t[..., ca:ca + ws][:, None]
            c1 = t[..., ca + 1:ca + 1 + ws][:, None]
            z = (1.0 - fcs) * c0 + fcs * c1  # (npr, npc, B, C, hs, ws)
            lb_blk = lab5[:, :, r_lo:r_hi, :, c_lo:c_hi].permute(2, 4, 0, 1, 3)
            ce, valid = cross_entropy_per_pixel(
                z.flatten(0, 2), lb_blk.flatten(0, 2), ignore)
            ces.append(ce.reshape(npr * npc, b, hs, ws))
            vals.append(valid.reshape(npr * npc, b, hs, ws))
    return torch.cat(ces), torch.cat(vals)


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """Integers in the order of the floats `x` (f32 → int32, f64 → int64):
    a non-negative float's bits as they are, a negative one's with the
    magnitude bits flipped. −0.0 sorts just below +0.0."""
    bits = x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)
    mag = torch.iinfo(bits.dtype).max
    return torch.where(bits < 0, bits ^ mag, bits)


def _global_kth(masked: torch.Tensor, n_min: torch.Tensor) -> torch.Tensor:
    """The n_min-th largest of every rank's `masked` along its last axis
    (n_min ≥ 1, one for each leading index), exactly, with no gather and
    no host sync: the largest key t with at least n_min keys ≥ t over all
    ranks, built from the top bit down (32 steps for f32, 64 for f64), each
    a count on the device and an all_reduce of one number a row. Neither
    the memory nor the traffic grows with the world size."""
    keys = _order_keys(masked)
    nbits = keys.element_size() * 8
    low, mag = torch.iinfo(keys.dtype).min, torch.iinfo(keys.dtype).max
    t = torch.full(keys.shape[:-1], low, dtype=keys.dtype, device=keys.device)
    for b in range(nbits - 1, -1, -1):
        # the key space read unsigned: setting bit 63/31 clears the sign bit
        cand = t ^ low if b == nbits - 1 else t | (1 << b)
        count = mesh.all_reduce((keys >= cand[..., None]).sum(-1))
        t = torch.where(count >= n_min, cand, t)
    return torch.where(t < 0, t ^ mag, t).view(masked.dtype)


def _ohem_mean_global(losses, valid, thresh, n_min_ratio):
    """ohem_mean over every rank's pixels (SyncBN): n_valid, n_above and the
    kept count from all_reduces, the fallback's cutoff from `_global_kth`;
    this rank's kept sum over the global kept count."""
    with torch.no_grad():
        masked = torch.where(valid, losses, -math.inf)
        n_valid, n_above = mesh.all_reduce(
            torch.stack([valid.sum(), (masked > thresh).sum()]))
        n_min = n_valid // n_min_ratio
        cutoff = torch.where(n_above >= n_min, torch.full_like(losses[0], thresh),
                             _global_kth(masked, n_min))
        kept = valid & ((losses > thresh) | (losses >= cutoff))
        n_keep = mesh.all_reduce(kept.sum()).clamp_min(1).to(losses.dtype)
    return (losses * kept.to(losses.dtype)).sum() / n_keep


def ohem_mean(losses: torch.Tensor, valid: torch.Tensor, thresh: float,
              n_min_ratio: int = 16) -> torch.Tensor:
    """Mean over the OHEM-kept pixels; `thresh` is the −log(p) loss floor."""
    losses = losses.reshape(-1)
    losses = losses if losses.dtype == torch.float64 else losses.float()
    valid = valid.reshape(-1)
    if mesh.sync_active():
        return _ohem_mean_global(losses, valid, thresh, n_min_ratio)
    n = losses.numel()
    k = max(n // n_min_ratio, 1)  # n_min never exceeds it
    with torch.no_grad():
        n_min = valid.sum() // n_min_ratio
        masked = torch.where(valid, losses, -math.inf)
        kth = masked.topk(k).values.gather(0, (n_min - 1).clamp(0, k - 1).reshape(1))
        n_above = (masked > thresh).sum()
        cutoff = torch.where(n_above >= n_min, thresh, kth[0])
        keep = (valid & ((losses > thresh) | (losses >= cutoff))).to(losses.dtype)
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

    def upsampled(self, logits: torch.Tensor, labels: torch.Tensor,
                  factor: int) -> torch.Tensor:
        """OHEM CE of the ×factor bilinear upsample of `logits`, through
        `cross_entropy_upsampled`: the upsampled volume is never formed."""
        if factor == 1:
            return self(logits, labels)
        ce, valid = cross_entropy_upsampled(logits, labels, factor, self.ignore_lb)
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


class MdsOhemNLLPlusLoss(nn.Module):
    """Graph-aware multi-dataset OHEM (mds_tpu/losses/ohem_ce.py:182): each
    dataset's `adj_nll_plus_loss` through its (n_cats, C) graph, one
    hard-pixel pool over all of them. The keep rule is the exact one, which
    JAX takes with `exact=True`; JAX's default is its histogram top-k."""

    def __init__(self, thresh: float = 0.4, ignore_lb: int = 255,
                 n_min_ratio: int = 16):
        super().__init__()
        self.thresh = -math.log(thresh)
        self.ignore_lb = ignore_lb
        self.n_min_ratio = n_min_ratio

    def forward(self, logits_list: Sequence[Optional[torch.Tensor]],
                adjs: Sequence[torch.Tensor],
                labels_list: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        from mds_tpu_torch.losses.helpers import adj_nll_plus_loss

        pairs = [adj_nll_plus_loss(lg, adj, lb, self.ignore_lb)
                 for lg, adj, lb in zip(logits_list, adjs, labels_list) if lg is not None]
        nll = torch.cat([c.reshape(-1) for c, _ in pairs])
        valid = torch.cat([v.reshape(-1) for _, v in pairs])
        return ohem_mean(nll, valid, self.thresh, self.n_min_ratio)
