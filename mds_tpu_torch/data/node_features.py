"""Graph node features per dataset class — the port's copy of
mds_tpu/data/node_features.py (`_hash_feature` :26,
`gen_graph_node_features` :48).

Resolution order: the configured or given cache file (`.npy`, or a torch
tensor saved with torch.save), else a deterministic fallback, bit for bit
JAX's: each class name's sha256 seeds a numpy normal vector of `nfeat`,
unit-normalized. JAX tries local CLIP text features in between; the port
has no CLIP weights to compute them from (the repo holds none), so it takes
them from the cache file only.
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional

import numpy as np


def _hash_feature(name: str, dim: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little")
    v = np.random.default_rng(seed).normal(0, 1, dim).astype(np.float32)
    return v / np.linalg.norm(v)


def class_names_of(configer) -> List[List[str]]:
    """Each dataset's class names: its spec's, else dataset{i}_class{j}."""
    from mds_tpu_torch.data.labels import get_spec

    out = []
    for i in range(configer.n_datasets):
        spec_name, n_cats = configer.dataset_cfg(i).get("spec"), configer.n_cats(i)
        names = (get_spec(spec_name).class_names if spec_name
                 else [f"dataset{i}_class{j}" for j in range(n_cats)])
        out.append(list(names)[:n_cats])
    return out


def gen_graph_node_features(configer=None, class_names: Optional[List[List[str]]] = None,
                            nfeat: int = 1024, cache_path: Optional[str] = None) -> np.ndarray:
    """(Σ n_cats, nfeat) f32 node features in dataset order."""
    if cache_path is None and configer is not None:
        cache_path = configer.get("GNN", "node_features_path", default=None)
    if cache_path and os.path.exists(cache_path):
        if cache_path.endswith(".npy"):
            return np.load(cache_path).astype(np.float32)
        import torch

        return torch.load(cache_path, map_location="cpu").numpy().astype(np.float32)
    if class_names is None:
        class_names = class_names_of(configer)
    return np.stack([_hash_feature(n, nfeat) for ds in class_names for n in ds])
