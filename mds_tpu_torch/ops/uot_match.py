"""Discrete bipartite matching from a learned affinity block by unbalanced
optimal transport, or by KM — the port's copy of mds_tpu/ops/uot_match.py
(`uot_bipartite_match` :30, `sep_bipartite_graphs_by_uot` :78,
`km_bipartite_match` :97, `sep_bipartite_graphs_by_km` :119,
`pretrain_bipartite_graphs` :131), host numpy at the stage switch.

Per dataset: cost = (1 − affinity + 1e-8)/2 as (M, n_cats); the UOT plan
Q (reg 0.01, reg_m 5) normalized to sum 1; each unified column to its
argmax dataset class; repair A gives every dataset class at least one
column (an empty row takes the lowest-confidence column of a row with
more than one), repair B drops an over-mapped row's columns below
uot_ratio/(M·n_cats), keeping its best; β ← 0.7·β + 0.3·(Q's column sums).
KM (GNN.use_km): the Hungarian assignment of largest total affinity
(scipy's linear_sum_assignment), every column it leaves uncovered to its
argmax dataset class.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from mds_tpu_torch.ops.sinkhorn import sinkhorn_knopp_unbalanced


def uot_bipartite_match(affinity: np.ndarray, beta: np.ndarray, uot_ratio: float = 1.0,
                        reg: float = 0.01, reg_m: float = 5.0,
                        mu: float = 0.7) -> Tuple[np.ndarray, np.ndarray]:
    """One dataset's (n_cats, M) affinity block → (0/1 graph, new β)."""
    n_cats, M = affinity.shape
    cost = ((-affinity + 1.0 + 1e-8) / 2.0).T  # (M, n_cats)
    alpha = np.full(M, 1.0 / M)
    Q = sinkhorn_knopp_unbalanced(alpha, np.asarray(beta), cost, reg, reg_m).astype(np.float64)
    Q_bar = Q / Q.sum()

    out = np.zeros((n_cats, M), np.float32)
    out[Q_bar.argmax(axis=1), np.arange(M)] = 1.0

    # repair A: every dataset class keeps at least one column
    for row in range(n_cats):
        if out[row].sum() == 0:
            for col in np.argsort(Q_bar.T[row]):  # ascending confidence
                owner = int(np.flatnonzero(out[:, col] == 1)[0])
                if out[owner].sum() > 1:
                    out[row, col], out[owner, col] = 1.0, 0.0
                    break

    # repair B: prune over-mapped rows below the confidence floor
    floor = uot_ratio / (Q_bar.shape[0] * Q_bar.shape[1])
    for row in range(n_cats):
        if out[row].sum() > 1:
            cols = np.flatnonzero(out[row] == 1)
            best = cols[np.argmax(Q_bar[cols, row])]
            for col in cols:
                if Q_bar[col, row] < floor:
                    out[row, col] = 0.0
            if out[row].sum() == 0:
                out[row, best] = 1.0

    return out, mu * np.asarray(beta) + (1 - mu) * Q_bar.sum(axis=0)


def sep_bipartite_graphs_by_uot(adj: np.ndarray, dataset_cats: Sequence[int],
                                betas: List[np.ndarray], uot_ratio: float = 1.0
                                ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Every dataset's matching over the (Σ n_cats, M) affinity block →
    (graphs, updated βs)."""
    graphs, new_betas, cur = [], [], 0
    for i, c in enumerate(dataset_cats):
        g, nb = uot_bipartite_match(np.asarray(adj[cur:cur + c], np.float64), betas[i],
                                    uot_ratio)
        graphs.append(g)
        new_betas.append(nb)
        cur += c
    return graphs, new_betas


def km_bipartite_match(affinity: np.ndarray) -> np.ndarray:
    """One dataset's (n_cats, M) affinity block → its 0/1 KM graph: each
    dataset class keeps the column the assignment gave it, and no column
    is left without a class."""
    from scipy.optimize import linear_sum_assignment

    n_cats, M = affinity.shape
    rows, cols = linear_sum_assignment(-np.asarray(affinity, np.float64))
    out = np.zeros((n_cats, M), np.float32)
    out[rows, cols] = 1.0
    covered = np.zeros(M, bool)
    covered[cols] = True
    for j in np.flatnonzero(~covered):
        out[int(np.argmax(affinity[:, j])), j] = 1.0
    return out


def sep_bipartite_graphs_by_km(adj: np.ndarray, dataset_cats: Sequence[int]) -> List[np.ndarray]:
    """Every dataset's KM graph over the (Σ n_cats, M) affinity block."""
    graphs, cur = [], 0
    for c in dataset_cats:
        graphs.append(km_bipartite_match(np.asarray(adj[cur:cur + c])))
        cur += c
    return graphs


def pretrain_bipartite_graphs(dataset_cats: Sequence[int], M: int) -> List[np.ndarray]:
    """Identity block-diagonal init graphs; with M < Σ n_cats class j of
    the dataset at offset cur folds onto column (cur + j) mod M."""
    out, cur = [], 0
    for c in dataset_cats:
        g = np.zeros((c, M), np.float32)
        for j in range(c):
            g[j, (cur + j) % M] = 1.0
        out.append(g)
        cur += c
    return out
