"""Per-dataset label specs — the port's own copy of mds_tpu/data/labels.py
(:31-98): class count, normalization mean/std, the id→trainId lookup
tables, the class names by trainId and the palette the demos render with,
read from this package's `label_specs.json` (a copy of the JAX package's
table); `load_specs` gives every spec, `apply_lut` remaps a label map."""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

_SPEC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "label_specs.json")


@functools.lru_cache(maxsize=1)
def _raw_specs() -> Dict[str, dict]:
    with open(_SPEC_PATH) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_cats: int
    mean: np.ndarray       # (3,) RGB in [0, 1]
    std: np.ndarray        # (3,)
    lut_eval: np.ndarray   # (256,) uint8 id → trainId
    lut_train: np.ndarray  # (256,) uint8, trainId 255/-1 → n_cats
    class_names: Tuple[str, ...] = ()  # by trainId: the first name of each
    palette: Optional[np.ndarray] = None  # (256, 3) uint8 color by trainId

    @property
    def ignore_label(self) -> int:
        return 255


def get_spec(name: str) -> DatasetSpec:
    raw = _raw_specs()
    if name not in raw:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(raw)}")
    spec = raw[name]
    n_cats = int(spec["n_cats"])
    lut_eval = np.arange(256, dtype=np.uint8)
    lut_train = np.arange(256, dtype=np.uint8)
    names = [""] * n_cats
    # a color per trainId: a seeded draw, each labelled trainId's own color
    # over it (the JAX package's draw, so both render alike)
    palette = np.random.default_rng(123).integers(0, 256, size=(256, 3), dtype=np.uint8)
    for el in spec["labels_info"]:
        # id -1 and trainId -1 wrap to 255, as a uint8 index does in torch
        tid = el["trainId"]
        lut_eval[el["id"]] = np.uint8(tid & 0xFF)
        lut_train[el["id"]] = np.uint8(n_cats if tid in (255, -1) else tid & 0xFF)
        if 0 <= tid < n_cats:
            if not names[tid]:
                names[tid] = el["name"]
            if el.get("color") is not None:
                palette[tid] = np.asarray(el["color"], np.uint8)
    return DatasetSpec(name=name, n_cats=n_cats,
                       mean=np.asarray(spec["mean"], np.float32),
                       std=np.asarray(spec["std"], np.float32),
                       lut_eval=lut_eval, lut_train=lut_train,
                       class_names=tuple(names), palette=palette)


def load_specs() -> Dict[str, DatasetSpec]:
    """Every dataset's spec, by name."""
    return {name: get_spec(name) for name in _raw_specs()}


def apply_lut(label: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """id → trainId remap of a uint8 label map (reference:
    lib/base_dataset.py:81-83)."""
    return lut[label]
