"""Config-driven per-dataset class → unified-class remapping — the part of
mds_tpu/data/class_remap.py's `ClassRemap` (:28-135) that the contrast
trainer runs.

The config's `class_remap{i}` maps each class id of dataset i to one or
more unified class ids. The trainer's labels keep the uniquely-mapped
classes only: `single_lut` is that 256-entry table (ignore for a class
mapped to several unified ids or to none), and the remap is a gather
through it on the labels' device.

The multi-alternative maps (`SegRemapping`), the reverse remap, the remap
and reweighting matrices, the multi-hot masks and `ClassRemapOneHotLabel`
(:136) serve the multi-prototype contrast path and wait with it (ROADMAP
queue 1, item 7b).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class ClassRemap:
    def __init__(self, configer):
        self.ignore_index = int(configer.get("loss", "ignore_index", default=255))
        self.remapList: List[Dict[int, List[int]]] = []
        self._single: List[np.ndarray] = []
        for i in range(1, configer.n_datasets + 1):
            raw = configer.get(f"class_remap{i}")
            if raw is None:
                raise KeyError(f"class_remap{i} missing from config")
            remap: Dict[int, List[int]] = {}
            class_id = 0
            while str(class_id) in raw:
                remap[class_id] = list(raw[str(class_id)])
                class_id += 1
            single = np.full(256, self.ignore_index, np.int64)
            for k, v in remap.items():
                if len(v) == 1:
                    single[k] = v[0]
            self.remapList.append(remap)
            self._single.append(single)

    def single_lut(self, dataset_id: int, device="cpu") -> torch.Tensor:
        """Dataset label id → unified id where the class maps to exactly
        one, ignore elsewhere: int64 (256,), on `device`; remap a label map
        by `lut[labels.long()]`."""
        return torch.as_tensor(self._single[dataset_id], device=device)
