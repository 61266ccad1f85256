"""Optimal transport — counterpart of mds_tpu/ops/sinkhorn.py: POT's
unbalanced Sinkhorn (`sinkhorn_knopp_unbalanced` :72) on the host in numpy
f32, and the balanced log-domain solvers (`log_sinkhorn_iterations` :20,
`log_optimal_transport` :36, `solve_optimal_transport` :46) in torch, which
no trainer calls (in JAX neither).

It runs once per GNN→SEG stage switch on a (M, n_cats) cost per dataset:
about a thousand tiny matvecs with a data-dependent stop, each of which
would cost a host sync on the device. JAX without x64 runs it in f32, and so
does this copy. The 1e-38 floor on K·v and Kᵀ·u (subnormal in f32, where
XLA's CPU flushes subnormals to zero and numpy does not) is never reached
on the flagship's costs: a softmax block's entries lie in [0, 1], so a cost
(1 − a + 1e-8)/2 is at most about 0.5 and K = exp(−cost/0.01) ≥ e⁻⁵⁰ ≈
1.9e-22, and the sums stay far above it.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def log_sinkhorn_iterations(Z: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                            iters: int) -> torch.Tensor:
    """Balanced Sinkhorn normalization in log space of Z (b, m, n) to the
    marginals log_mu (b, m) and log_nu (b, n), `iters` rounds from u = v =
    0."""
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(Z + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(Z + u[:, :, None], dim=1)
    return Z + u[:, :, None] + v[:, None, :]


def log_optimal_transport(scores: torch.Tensor, iters: int) -> torch.Tensor:
    """The log plan of uniform marginals 1/(m + n) over scores (b, m, n),
    scaled back by m + n."""
    b, m, n = scores.shape
    norm = -math.log(m + n)
    log_mu = scores.new_full((b, m), norm)
    log_nu = scores.new_full((b, n), norm)
    return log_sinkhorn_iterations(scores, log_mu, log_nu, iters) - norm


def solve_optimal_transport(scores: torch.Tensor, iters: int,
                            match_threshold: float) -> Dict[str, torch.Tensor]:
    """Mutual-max matches of the plan: matches0 (b, m) and matches1 (b, n)
    (−1 unmatched, or a match whose exp(log plan) is at most the
    threshold) and their scores."""
    Z = log_optimal_transport(scores, iters)
    _, m, n = Z.shape
    max0, indices0 = Z.max(dim=2)
    indices1 = Z.argmax(dim=1)
    ar0 = torch.arange(m, device=Z.device)[None, :]
    ar1 = torch.arange(n, device=Z.device)[None, :]
    mutual0 = ar0 == torch.gather(indices1, 1, indices0)
    mutual1 = ar1 == torch.gather(indices0, 1, indices1)
    mscores0 = torch.where(mutual0, max0.exp(), torch.zeros_like(max0))
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, indices1),
                           torch.zeros_like(indices1, dtype=Z.dtype))
    valid0 = mutual0 & (mscores0 > match_threshold)
    valid1 = mutual1 & torch.gather(valid0, 1, indices1)
    return {"matches0": torch.where(valid0, indices0, -1),
            "matches1": torch.where(valid1, indices1, -1),
            "matching_scores0": mscores0, "matching_scores1": mscores1}


def sinkhorn_knopp_unbalanced(a, b, M, reg: float, reg_m: float,
                              num_iter_max: int = 1000,
                              stop_thr: float = 1e-6) -> np.ndarray:
    """a (dim_a,), b (dim_b,) marginals, M (dim_a, dim_b) cost → the plan
    diag(u)·K·diag(v), K = exp(−M/reg), from u = (a/Kv)^fi, v = (b/Kᵀu)^fi,
    fi = reg_m/(reg_m + reg), stopped when the mean of u's and v's largest
    relative change is at most `stop_thr` or after `num_iter_max` rounds.
    f32 throughout."""
    f32 = np.float32
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    K = np.exp(-np.asarray(M, f32) / f32(reg))
    fi = f32(reg_m / (reg_m + reg))
    floor = f32(1e-38)
    u = np.ones(a.shape[0], f32) / f32(a.shape[0])
    v = np.ones(b.shape[0], f32) / f32(b.shape[0])
    err, i = np.inf, 0
    while i < num_iter_max and err > stop_thr:
        u_prev, v_prev = u, v
        u = np.power(a / np.maximum(K @ v, floor), fi)
        v = np.power(b / np.maximum(K.T @ u, floor), fi)
        err_u = np.max(np.abs(u - u_prev)) / max(np.max(np.abs(u)), np.max(np.abs(u_prev)), f32(1))
        err_v = np.max(np.abs(v - v_prev)) / max(np.max(np.abs(v)), np.max(np.abs(v_prev)), f32(1))
        err = f32(0.5) * (err_u + err_v)
        i += 1
    return u[:, None] * K * v[None, :]
