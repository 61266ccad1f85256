"""Per-pixel Sinkhorn prototype assignment — the port's counterpart of
mds_tpu/ops/prototype_learning.py (`grouped_sinkhorn` :28, `hard_assignment`
:86, `prototype_learning` :110).

With P prototype slots a unified class, each pixel embedding is assigned
by a balanced Sinkhorn among its own class's P slots; the correctly
predicted pixels move the slots by momentum; the slot index of each pixel
becomes its contrast target (`slot + P·class`). Classes partition the
pixels, so every class's Sinkhorn runs at once on the dense (N, P) score
matrix: its sums per (class, slot) are `index_add_` over the class id.

The Gumbel noise of the hard assignment is an argument: a tensor the
caller draws (`gumbel_noise`, on the CPU from an explicit generator);
`noise=None` is the deterministic argmax, as JAX's `rng=None`.

In a data-parallel step (parallel/mesh.py) the rows are this rank's share
of the global batch and every per-class quantity is taken over every rank,
as JAX's step takes it on its data mesh: the Sinkhorn's class max
(an all_reduce max), its counts, totals and per-(class, slot) sums in each
round, and the momentum update's per-slot masses and sums. The row
normalization stays local; the prototypes come out the same on every
rank. The caller passes this rank's rows of the global noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mds_tpu_torch.models.layers import wide
from mds_tpu_torch.parallel import mesh

SINKHORN_ITERS = 3
EPSILON = 0.05  # the Sinkhorn's entropic temperature
TAU = 0.5  # the hard assignment's Gumbel temperature


def grouped_sinkhorn(scores: torch.Tensor, seg_ids: torch.Tensor, num_classes: int,
                     valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each class's Sinkhorn on its own rows of `scores` (N, P): L =
    exp(s/ε) shifted by the class's max, L /= ΣL over the class; then
    SINKHORN_ITERS rounds of slot rows to 1/P and pixel columns to 1/n_k; L·n_k.
    → (plan (N, P), argmax slot (N,)); invalid rows give 0 and slot 0."""
    P = scores.shape[1]
    # in a data-parallel step each per-class reduction is every rank's
    red = mesh.step_sum
    seg = torch.where(valid, seg_ids, num_classes).long()
    K1 = num_classes + 1  # a spare class takes the invalid rows
    s = wide(scores) / EPSILON
    vf = valid[:, None].to(s.dtype)
    row_max = torch.where(valid[:, None], s, -torch.inf).max(dim=1).values
    smax = red(s.new_full((K1,), -torch.inf).scatter_reduce(
        0, seg, row_max, reduce="amax"), op="max")
    s = s - torch.where(torch.isfinite(smax), smax, 0.0)[seg][:, None]
    L = torch.exp(s) * vf

    def per_class_sum(mat):
        return red(mat.new_zeros(K1, P).index_add_(0, seg, mat))

    cnt = red(s.new_zeros(K1).index_add_(0, seg, valid.to(s.dtype)))
    tot = per_class_sum(L).sum(dim=1)
    L = L / tot.clamp_min(1e-30)[seg][:, None]
    for _ in range(SINKHORN_ITERS):
        L = L / per_class_sum(L)[seg].clamp_min(1e-30) / P
        L = L / L.sum(dim=1, keepdim=True).clamp_min(1e-30)
        L = L / cnt.clamp_min(1.0)[seg][:, None]
    L = L * cnt[seg][:, None] * vf
    return L, L.argmax(dim=1)


def gumbel_noise(shape, generator: torch.Generator, device="cpu") -> torch.Tensor:
    """Gumbel samples −log(−log(u) + 1e-20), u uniform on [1e-20, 1), drawn
    on the CPU from `generator` and copied to `device`."""
    u = torch.rand(shape, generator=generator) * (1.0 - 1e-20) + 1e-20
    return (-torch.log(-torch.log(u) + 1e-20)).to(device)


def hard_assignment(q: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-hot of argmax((q + noise)/τ) — the reference's
    gumbel_softmax(hard=True) forward; argmax q without noise."""
    if noise is not None:
        q = (q + noise.to(q.device, q.dtype)) / TAU
    return F.one_hot(q.argmax(dim=1), q.shape[1]).to(q.dtype)


class ProtoLearnResult(NamedTuple):
    proto_logits: torch.Tensor  # (N, K·P) embedding · every slot
    proto_target: torch.Tensor  # (N,) slot + P·class where valid, else the gt id
    prototypes: torch.Tensor  # (K, P, D) after the momentum update


def prototype_learning(prototypes: torch.Tensor, emb: torch.Tensor, gt_seg: torch.Tensor,
                       correct: torch.Tensor, coefficient: float = 0.999,
                       noise: Optional[torch.Tensor] = None) -> ProtoLearnResult:
    """prototypes (K, P, D) unit rows, emb (N, D) (f32, or f64 where it is
    f64), gt_seg (N,) unified ids
    (≥ K ignored), correct (N,) bool, noise (N, P) Gumbel or None.

    The logits against every slot; each valid pixel's own-class block
    through `grouped_sinkhorn`; the hard assignment q; from the correctly
    predicted valid pixels the per-slot sums f = Σ q·emb and masses n;
    slots with mass take coefficient·old + (1 − coefficient)·f/|f|. The
    target is the soft plan's argmax slot + P·class. The logits carry the
    embeddings' gradient, as JAX's; nothing else takes one."""
    K, P, D = prototypes.shape
    emb = wide(emb)
    protos = prototypes.detach().to(emb.dtype)
    proto_logits = emb @ protos.reshape(K * P, D).T
    with torch.no_grad():
        emb = emb.detach()
        valid = gt_seg < K
        gt = torch.where(valid, gt_seg, 0).long()
        block = gt[:, None] * P + torch.arange(P, device=gt.device)[None, :]
        init_q = proto_logits.detach().gather(1, block)
        plan, idx = grouped_sinkhorn(init_q, gt, K, valid)
        q = hard_assignment(plan, noise) * valid[:, None].to(plan.dtype)
        w = q * (correct & valid)[:, None].to(plan.dtype)
        n = w.new_zeros(K, P).index_add_(0, gt, w)
        f = torch.stack([emb.new_zeros(K, D).index_add_(0, gt, emb * w[:, p:p + 1])
                         for p in range(P)], dim=1)
        n, f = mesh.step_sum(n), mesh.step_sum(f)  # every rank's correct pixels
        f_norm = f / torch.linalg.norm(f, dim=-1, keepdim=True).clamp_min(1e-12)
        mixed = coefficient * protos + (1.0 - coefficient) * f_norm
        protos = torch.where((n > 0)[..., None], mixed, protos)
        target = torch.where(valid, idx + P * gt, gt_seg.long())
    return ProtoLearnResult(proto_logits, target, protos.to(prototypes.dtype))
