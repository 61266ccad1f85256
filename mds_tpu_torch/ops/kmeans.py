"""K-means (euclidean or cosine) and soft-DTW — counterpart of
mds_tpu/ops/kmeans.py (`kmeans` :34, `soft_dtw` :60, `pairwise_soft_dtw`
:99).

- `kmeans`: Lloyd iterations from the rows `init_idx` of x; a cluster
  left empty keeps its old center. JAX draws the initial indices with
  jax.random.choice inside the call; here they are an argument, drawn by
  the caller (`kmeans_init_indices` from an explicit CPU generator), so a
  test can hand in JAX's. The distances are the broadcast differences
  summed over D, as JAX's, computed in row chunks so the (N, K, D)
  intermediate stays bounded; argmin takes the first of equal distances.
- `soft_dtw`: R[i, j] = D[i, j] + softmin_γ(R[i−1, j], R[i, j−1],
  R[i−1, j−1]) with R[−1, −1] = 0 and 1e30 on the other borders, JAX's
  stand-in for infinity; softmin_γ(a, b, c) = −γ·logsumexp(−(a, b, c)/γ).
  The cells of one anti-diagonal depend only on the two before it, so each
  anti-diagonal is one vectorised step (n + m − 1 steps), over any leading
  batch dimensions; differentiable.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_BIG = 1e30  # JAX's stand-in for infinity on the DP's borders
_CHUNK = 1 << 24  # elements of one chunk's (rows, K, D) difference tensor


def _pairwise(x: torch.Tensor, centers: torch.Tensor, distance: str) -> torch.Tensor:
    if distance == "euclidean":
        rows = max(1, _CHUNK // max(1, centers.numel()))
        return torch.cat([(x[i:i + rows, None, :] - centers[None]).square().sum(-1)
                          for i in range(0, x.shape[0], rows)])
    if distance == "cosine":
        xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        cn = centers / torch.clamp(torch.linalg.vector_norm(centers, dim=-1, keepdim=True),
                                   min=1e-12)
        return 1.0 - xn @ cn.T
    raise ValueError(distance)


def kmeans_init_indices(n: int, n_clusters: int, generator: torch.Generator) -> torch.Tensor:
    """n_clusters distinct row indices of [0, n), drawn on the CPU."""
    return torch.randperm(n, generator=generator)[:n_clusters]


@torch.no_grad()
def kmeans_assign(x: torch.Tensor, centers: torch.Tensor,
                  distance: str = "euclidean") -> torch.Tensor:
    """Each row of x's nearest center (the first of equal distances)."""
    return _pairwise(x, centers, distance).argmin(dim=1)


@torch.no_grad()
def kmeans(x: torch.Tensor, init_idx: torch.Tensor, n_iter: int = 20,
           distance: str = "euclidean") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), init_idx (K,) → (centers (K, D), assignment (N,) int64)."""
    k = init_idx.shape[0]
    centers = x[init_idx.to(x.device)]
    for _ in range(n_iter):
        onehot = F.one_hot(kmeans_assign(x, centers, distance), k).to(x.dtype)
        counts = onehot.sum(dim=0)[:, None]
        centers = torch.where(counts > 0, (onehot.T @ x) / torch.clamp(counts, min=1.0),
                              centers)
    return centers, kmeans_assign(x, centers, distance)


def _softmin(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, gamma: float) -> torch.Tensor:
    return -gamma * torch.logsumexp(-torch.stack([a, b, c]) / gamma, dim=0)


def soft_dtw(D: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Soft-DTW value of (…, n, m) pairwise-cost matrices → (…)."""
    n, m = D.shape[-2:]
    lead = D.shape[:-2]
    R = D.new_full((*lead, n + 1, m + 1), _BIG)
    R[..., 0, 0] = 0.0
    for k in range(n + m - 1):
        i = torch.arange(max(0, k - m + 1), min(k, n - 1) + 1, device=D.device)
        j = k - i
        R[..., i + 1, j + 1] = D[..., i, j] + _softmin(R[..., i, j + 1], R[..., i + 1, j],
                                                       R[..., i, j], gamma)
    return R[..., n, m]


def pairwise_soft_dtw(x: torch.Tensor, centers: torch.Tensor,
                      gamma: float = 1.0) -> torch.Tensor:
    """Soft-DTW between sequence sets (N, L, D) × (K, L, D) → (N, K), each
    pair's cost the squared euclidean distance of its steps."""
    cost = (x[:, None, :, None, :] - centers[None, :, None, :, :]).square().sum(-1)
    return soft_dtw(cost, gamma)
