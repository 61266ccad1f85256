"""Pixel-contrast loss with a memory bank — counterpart of
mds_tpu/losses/contrast.py (`hard_anchor_sample` :28, `contrastive_loss`
:58, `MemoryBank` :87, `memory_bank_push` :108, `PixelContrastLoss` :134).

Every shape is static, as in JAX: per unified class, `n_view` anchor pixels
ranked hard-first (a mispredicted pixel scores 1 over a correct one) with
uniform noise breaking the ranks, a class valid when it has more than
`max_views` pixels; the bank is a (U, M, D) circular buffer of
L2-normalized class means.

The ranking noise is an argument, (U, P) uniform [0, 1) values: the
trainer draws it from the step's CPU `torch.Generator` (`anchor_noise`),
so a run on the card draws what one on the CPU draws, and a test can feed
in JAX's own draws.

In a data-parallel step (parallel/mesh.py `data_parallel`, the contrast
trainer at world size > 1) each rank holds its rows of the global batch;
rank r's P pixels are the dataset's global columns [r·P, (r + 1)·P) in
NHWC order, and what the one-process step computes on the global batch is
computed here over every rank (mds_tpu/engine/contrast_trainer.py:301-316
runs it on JAX's data mesh):
- `anchor_noise` draws the global (C, world·P) noise and keeps this rank's
  columns;
- `hard_anchor_sample` ranks each class's pixels over every rank: each
  rank's n_view best candidates with their scores and global indices are
  gathered (`mesh.gather_rows`), the global best n_view taken, the class
  count summed; the fill of a class with few pixels scores by the global
  index;
- `contrastive_loss`, computed whole on every rank from the gathered
  anchors and the replicated bank, is weighted 1/world;
- `memory_bank_push` sums the class sums and counts over the ranks, so
  every rank writes the same bank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from mds_tpu_torch.parallel import mesh


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x / max(sqrt(Σ x²), 1e-12) along `dim` (jnp.linalg.norm's sum of
    squares, not a scaled norm)."""
    return x / torch.clamp(x.square().sum(dim, keepdim=True).sqrt(), min=1e-12)


def anchor_noise(n_classes: int, n_pixels: int, generator: torch.Generator,
                 device="cpu") -> torch.Tensor:
    """(n_classes, n_pixels) uniform [0, 1) f32 ranking noise drawn from a
    CPU generator, on `device` (a CUDA copy from page-locked memory, not
    waited for). In a data-parallel step `n_pixels` is this rank's count:
    the draw is the global (n_classes, world·n_pixels) one, and this rank
    keeps its columns."""
    if mesh.sync_active():
        cols, total = mesh.global_rows([n_pixels])
        t = torch.rand((n_classes, total), generator=generator)[:, cols]
    else:
        t = torch.rand((n_classes, n_pixels), generator=generator)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _top(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's k largest of `score` in descending order, ties to the
    lower index (XLA's top_k rule): (values, indices)."""
    values, idx = torch.sort(score, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def anchor_picks(labels: torch.Tensor, preds: torch.Tensor, noise: torch.Tensor,
                 n_view: int, max_views: int = 2):
    """The anchors' choice of `hard_anchor_sample` (labels and preds (P,),
    noise (C, P)) → (this rank's candidates (C, k) as local indices, the
    picks as positions among every rank's gathered candidates (C, n_view),
    rank r's k candidates at [r·k, (r + 1)·k), valid (C,) bool). Class c
    ranks its pixels by noise + hard (hard: predicted other than c); the
    pixels outside it score −1 − (global index)/(global count), distinct,
    below every real score and falling with the index, so that a class
    with fewer than n_view pixels fills up with other classes' pixels,
    lowest global index first, as XLA's top_k breaks the ties of JAX's
    −inf scores. Outside a data-parallel step the candidates are the
    picks."""
    C, P = noise.shape
    labels = labels.long()
    sync = mesh.sync_active()
    off, total = (mesh.rank() * P, mesh.world() * P) if sync else (0, P)
    classes = torch.arange(C, device=labels.device)[:, None]
    mask = labels[None, :] == classes
    hard = mask & (preds.long()[None, :] != classes)
    gidx = torch.arange(off, off + P, device=noise.device)
    outside = -1.0 - gidx.to(noise.dtype) / total
    score = torch.where(mask, noise + hard.to(noise.dtype), outside[None, :])
    count = mask.sum(dim=1)
    top, cand = _top(score, min(n_view, P))
    if not sync:
        pos = torch.arange(cand.shape[1], device=cand.device).expand_as(cand)
        return cand, pos, count > max_views
    # every rank's candidates, rank-major: (world·k, C), ordered by global
    # index before the stable ranking so that equal scores go to the lower
    all_scores = mesh.gather_rows(top.T.contiguous()).T
    all_gidx = mesh.gather_rows(gidx[cand].T.contiguous()).T
    by_index = all_gidx.argsort(dim=1)
    _, pos = _top(all_scores.gather(1, by_index), n_view)
    return cand, by_index.gather(1, pos), mesh.all_reduce(count) > max_views


def hard_anchor_sample(feats: torch.Tensor, labels: torch.Tensor, preds: torch.Tensor,
                       noise: torch.Tensor, n_view: int, max_views: int = 2
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (P, D), labels and preds (P,), noise (C, P) → anchors
    (C, n_view, D) and valid (C,) bool: each class's n_view pixels of
    highest noise + hard (`anchor_picks`). In a data-parallel step over
    every rank's pixels: the anchors are the same on every rank, and their
    gradient (`mesh.gather_rows`) reaches the rank that holds each pixel."""
    cand, pos, valid = anchor_picks(labels, preds, noise, n_view, max_views)
    if not mesh.sync_active():
        return feats[cand], valid
    # (k, C, D) → every rank's, (world·k, C, D) → (C, world·k, D)
    gathered = mesh.gather_rows(feats[cand].transpose(0, 1).contiguous()).transpose(0, 1)
    return gathered.gather(1, pos[..., None].expand(-1, -1, feats.shape[1])), valid


def contrastive_loss(anchors: torch.Tensor, valid: torch.Tensor, memory: torch.Tensor,
                     temperature: float = 0.07, base_temperature: float = 0.07
                     ) -> torch.Tensor:
    """InfoNCE of each anchor against the (C, M, D) class queues:
    positives its own class's entries, negatives every other's."""
    C, V, D = anchors.shape
    M = memory.shape[1]
    logits = torch.einsum("cvd,nd->cvn", anchors, memory.reshape(C * M, D)) / temperature
    logits = logits - logits.max(dim=-1, keepdim=True).values.detach()
    mem_cls = torch.arange(C, device=anchors.device).repeat_interleave(M)
    pos = (mem_cls[None, None, :] == torch.arange(C, device=anchors.device)[:, None, None]
           ).to(logits.dtype)
    log_prob = logits - torch.log(logits.exp().sum(dim=-1, keepdim=True) + 1e-12)
    mean_log_prob_pos = (pos * log_prob).sum(-1) / torch.clamp(pos.sum(-1), min=1.0)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    w = valid.to(loss.dtype)[:, None]
    return (loss * w).sum() / torch.clamp(w.sum() * V, min=1.0)


@dataclass
class MemoryBank:
    """Per-class circular feature queues: feats (C, M, D) f32, the next
    slot `ptr` (C,) and the real entries `count` (C,) int32, which saturates
    at M."""

    feats: torch.Tensor
    ptr: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(n_classes: int, memory_size: int, dim: int, device="cpu") -> "MemoryBank":
        feats = torch.zeros(n_classes, memory_size, dim, device=device)
        feats[:, :, 0] = 1.0  # unit-norm placeholders
        zeros = torch.zeros(n_classes, dtype=torch.int32, device=device)
        return MemoryBank(feats, zeros, zeros.clone())

    def to(self, device) -> "MemoryBank":
        return MemoryBank(self.feats.to(device), self.ptr.to(device), self.count.to(device))


@torch.no_grad()
def memory_bank_push(bank: MemoryBank, feats: torch.Tensor, labels: torch.Tensor
                     ) -> MemoryBank:
    """Write the L2-normalized mean of each class present among `labels`
    (P,) over feats (P, D) (f32, as the bank) into its queue at `ptr`, advance `ptr` and
    `count`; the others stay. A new bank (the tensors are not changed in
    place). In a data-parallel step the class sums and counts are every
    rank's."""
    C, M, _ = bank.feats.shape
    labels = labels.long()
    # the ignore label, or any other id outside [0, C), counts nowhere
    onehot = F.one_hot(torch.where((labels >= 0) & (labels < C), labels, C),
                       C + 1)[:, :C].to(feats.dtype)
    # in a data-parallel step every rank's pixels (module docstring)
    counts, sums = mesh.step_sum(onehot.sum(dim=0)), mesh.step_sum(onehot.T @ feats)
    means = l2_normalize(sums / torch.clamp(counts[:, None], min=1.0))
    present = counts > 0
    rows = torch.arange(C, device=labels.device)
    slot = bank.ptr.long()
    new_feats = bank.feats.clone()
    new_feats[rows, slot] = torch.where(present[:, None], means, bank.feats[rows, slot])
    ptr = torch.where(present, (bank.ptr + 1) % M, bank.ptr)
    count = torch.where(present, torch.clamp(bank.count + 1, max=M), bank.count)
    return MemoryBank(new_feats, ptr, count)


class PixelContrastLoss:
    """The reference PixelContrastLoss on a frozen memory bank (config keys
    contrast.temperature, base_temperature, max_views; loss.ignore_index)."""

    def __init__(self, configer=None, temperature: float = 0.07,
                 base_temperature: float = 0.07, max_views: int = 2, n_view: int = 16,
                 ignore: int = 255):
        if configer is not None:
            def g(*k, d=None):
                return configer.get(*k, default=d)
            temperature = float(g("contrast", "temperature", d=temperature))
            base_temperature = float(g("contrast", "base_temperature", d=base_temperature))
            max_views = int(g("contrast", "max_views", d=max_views))
            ignore = int(g("loss", "ignore_index", d=ignore))
        self.temperature = temperature
        self.base_temperature = base_temperature
        self.max_views = max_views
        self.n_view = n_view
        self.ignore = ignore

    def __call__(self, feats: torch.Tensor, labels: torch.Tensor, preds: torch.Tensor,
                 bank: MemoryBank, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """feats (B, D, h, w); labels and preds (B, h, w) at the features'
        resolution; `noise` (C, B·h·w), else drawn from `generator`. Pixels
        are taken in NHWC order, as JAX flattens them."""
        D = feats.shape[1]
        flat = l2_normalize(feats.permute(0, 2, 3, 1).reshape(-1, D))
        if noise is None:
            noise = anchor_noise(bank.feats.shape[0], flat.shape[0], generator, flat.device)
        anchors, valid = hard_anchor_sample(
            flat, labels.reshape(-1), preds.reshape(-1), noise, self.n_view,
            self.max_views)
        loss = contrastive_loss(anchors, valid, bank.feats, self.temperature,
                                self.base_temperature)
        # every rank computes the loss whole: its share (module docstring)
        return loss * mesh.replicated_share()
