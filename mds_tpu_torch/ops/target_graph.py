"""Target bipartite graphs for the `_tg` (target-graph) variants — the
port's copy of mds_tpu/ops/target_graph.py (`target_graphs_from_remap`
:22, `target_graphs_from_pairs` :44).

A target graph of dataset i is (n_cats_i, M) f32: 1 where class k may map
to unified class u, 0 where it must not, 255 (no constraint) elsewhere.
The graph-net loss's adjacency-target term (losses/cross_datasets.py)
reads them as `preds["target_bi_graph"]`; `with_target_graphs` puts them
there.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def target_graphs_from_remap(configer, max_num_unify_class: Optional[int] = None,
                             constrain_negatives: bool = True) -> List[np.ndarray]:
    """From the config's `class_remap{i}` maps: 1 at each admissible
    (class, unified id < M), else 0 (`constrain_negatives`) or 255."""
    from mds_tpu_torch.data.class_remap import ClassRemap

    remap = ClassRemap(configer)
    M = max_num_unify_class or int(configer.get("num_unify_classes", default=0))
    out = []
    for i in range(configer.n_datasets):
        n_cats = configer.n_cats(i)
        g = np.full((n_cats, M), 0.0 if constrain_negatives else 255.0, np.float32)
        for k, v in remap.remapList[i].items():
            if k >= n_cats:
                continue
            for u in v:
                if u < M:
                    g[k, u] = 1.0
        out.append(g)
    return out


def target_graphs_from_pairs(dataset_cats: Sequence[int], M: int,
                             pairs_per_dataset: Sequence[Sequence]) -> List[np.ndarray]:
    """From explicit (class, unified) pair lists; unlisted entries 255."""
    out = []
    for n_cats, pairs in zip(dataset_cats, pairs_per_dataset):
        g = np.full((n_cats, M), 255.0, np.float32)
        for k, u in pairs:
            g[k, u] = 1.0
        out.append(g)
    return out


def with_target_graphs(preds: Dict, graphs: Sequence, device="cpu") -> Dict:
    """`preds` with `target_bi_graph` set to the graphs as f32 tensors on
    `device` (the graph net's), for the loss's `_tg` term."""
    return {**preds, "target_bi_graph": [
        torch.as_tensor(np.asarray(g), dtype=torch.float32, device=device) for g in graphs]}
