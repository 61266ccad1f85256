"""POT's unbalanced Sinkhorn — counterpart of mds_tpu/ops/sinkhorn.py
`sinkhorn_knopp_unbalanced` (:72), on the host in numpy f32.

It runs once per GNN→SEG stage switch on a (M, n_cats) cost per dataset:
about a thousand tiny matvecs with a data-dependent stop, each of which
would cost a host sync on the device. JAX without x64 runs it in f32, and so
does this copy. The 1e-38 floor on K·v and Kᵀ·u (subnormal in f32, where
XLA's CPU flushes subnormals to zero and numpy does not) is never reached
on the flagship's costs: a softmax block's entries lie in [0, 1], so a cost
(1 − a + 1e-8)/2 is at most about 0.5 and K = exp(−cost/0.01) ≥ e⁻⁵⁰ ≈
1.9e-22, and the sums stay far above it. The balanced solvers of that file
(:20-70) are not ported yet (ROADMAP queue 1, item 6b).
"""

from __future__ import annotations

import numpy as np


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
