"""Config-driven per-dataset class → unified-class remapping — the part of
mds_tpu/data/class_remap.py (`ClassRemap` :28-135, `ClassRemapOneHotLabel`
:136-291) that the port's trainers and losses run.

The config's `class_remap{i}` maps each class id of dataset i to one or
more unified class ids. Every remap is a gather through a table of 256
rows (one per label byte) built once from the config and moved once to
the labels' device:
- `single_lut` / `SingleSegRemapping`: the unified id of a class mapped to
  exactly one, ignore elsewhere;
- `ClassRemapOneHotLabel`: bool (…, U) one-hots of the single-mapped
  classes (`SingleSegRemappingOneHot`) and multi-hots of every mapping
  (`SegRemappingOneHot`), which the k-means loss reads, and
  `ContrastRemapping`, which sharpens a multi-mapped pixel's admissible set
  to its most similar prototype slot where the similarity clears
  `contrast.update_sim_thresh` and the pixel is in its slot's top share, a
  share annealed over the iterations. Masks have the class on the last
  axis, as JAX's.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from mds_tpu_torch.losses.ohem_ce import _global_kth
from mds_tpu_torch.parallel import mesh


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
        self._device_tables: Dict = {}

    def _on(self, name: str, dataset_id: int, device) -> torch.Tensor:
        """Table `name` of the dataset on `device`, moved there once."""
        key = (name, dataset_id, str(device))
        if key not in self._device_tables:
            self._device_tables[key] = torch.as_tensor(getattr(self, name)[dataset_id],
                                                       device=device)
        return self._device_tables[key]

    def single_lut(self, dataset_id: int, device="cpu") -> torch.Tensor:
        """Dataset label id → unified id where the class maps to exactly
        one, ignore elsewhere: int64 (256,), on `device`; remap a label map
        by `lut[labels.long()]`."""
        return self._on("_single", dataset_id, device)

    def SingleSegRemapping(self, labels: torch.Tensor, dataset_id: int) -> torch.Tensor:
        return self.single_lut(dataset_id, labels.device)[labels.long()]


class ClassRemapOneHotLabel(ClassRemap):
    """Multi-hot supervision over the unified space (mds_tpu/data/
    class_remap.py:136): 256-row bool tables of each dataset's
    single-mapped classes (`_single_onehot`), every class's admissible
    classes (`_multi_hot`), the multi-mapped rows' admissible classes
    (`_multi_only_hot`) and which classes are multi-mapped (`_is_multi`)."""

    def __init__(self, configer):
        super().__init__(configer)
        g = lambda *k, d=None: configer.get(*k, default=d)
        self.num_unify_classes = int(g("num_unify_classes", d=0))
        self.update_sim_thresh = float(g("contrast", "update_sim_thresh", d=0.6))
        self.network_stride = int(g("network", "stride", d=8))
        self.max_iter = int(g("lr", "max_iter", d=1))
        self.num_prototype = int(g("contrast", "num_prototype", d=1))
        U = self.num_unify_classes
        self._single_onehot, self._multi_hot, self._multi_only_hot, self._is_multi = [], [], [], []
        for remap in self.remapList:
            single = np.zeros((256, U), bool)
            multi = np.zeros((256, U), bool)
            multi_only = np.zeros((256, U), bool)
            is_multi = np.zeros(256, bool)
            for k, v in remap.items():
                multi[k, v] = True
                if len(v) == 1:
                    single[k, v[0]] = True
                else:
                    is_multi[k] = True
                    multi_only[k, v] = True
            self._single_onehot.append(single)
            self._multi_hot.append(multi)
            self._multi_only_hot.append(multi_only)
            self._is_multi.append(is_multi)

    def _tables(self, dataset_id: int, device):
        """The dataset's single one-hot, multi-only and is-multi tables on
        `device`."""
        return tuple(self._on(n, dataset_id, device)
                     for n in ("_single_onehot", "_multi_only_hot", "_is_multi"))

    def SingleSegRemappingOneHot(self, labels: torch.Tensor, dataset_id: int) -> torch.Tensor:
        """(…, U) bool one-hot of the single-mapped classes (:183)."""
        return self._on("_single_onehot", dataset_id, labels.device)[labels.long()]

    def SegRemappingOneHot(self, labels: torch.Tensor, dataset_id: int) -> torch.Tensor:
        """(…, U) bool multi-hot over every admissible unified class (:188)."""
        return self._on("_multi_hot", dataset_id, labels.device)[labels.long()]

    @torch.no_grad()
    def ContrastRemapping(self, labels: torch.Tensor, sim: torch.Tensor, dataset_id: int,
                          cur_iter: Union[int, float, torch.Tensor] = 0):
        """→ (contrast_mask (B, h, w, U·P) bool, seg_mask (B, H, W, U) bool)
        (mds_tpu/data/class_remap.py:212-291, with the similarities passed
        in, as the multi-prototype trainer passes its prototype logits).

        labels (B, H, W): the dataset's own ids; sim (B, h, w, U·P) at the
        network stride. A multi-mapped pixel takes the one-hot of its most
        similar admissible slot where that similarity is at least
        update_sim_thresh and at least its slot's ⌈count·ratio⌉-th largest
        (ratio = min(1.25·cur_iter/max_iter, 1)); elsewhere it keeps its
        admissible set, and a single-mapped pixel its one class, over the P
        slots of each unified class. The seg mask is the contrast mask's
        classes at full size (nearest), single-mapped pixels their class,
        multi-mapped pixels left empty their admissible set, ignored pixels
        none.

        In a data-parallel step (parallel/mesh.py) `labels` and `sim` are
        this rank's rows of the global batch, and each slot's count and its
        ⌈count·ratio⌉-th largest similarity are taken over every rank, the
        order statistic exactly by losses/ohem_ce.py's bisection."""
        U, P, stride = self.num_unify_classes, self.num_prototype, self.network_stride
        single, multi_only, is_multi_t = self._tables(dataset_id, labels.device)
        labels = labels.long()
        clb = labels[:, ::stride, ::stride]
        B, h, w = clb.shape
        is_multi = is_multi_t[clb]
        adm_p = multi_only[clb].repeat_interleave(P, dim=-1)
        sim = torch.where(adm_p, sim.float(), -torch.inf)
        max_sim, assign = sim.max(dim=-1)
        confident = max_sim >= self.update_sim_thresh
        ratio = torch.clamp(1.25 * torch.as_tensor(cur_iter, dtype=torch.float32,
                                                   device=labels.device)
                            / max(self.max_iter, 1), max=1.0)
        flat_sim, flat_assign = max_sim.reshape(-1), assign.reshape(-1)
        valid = (confident & is_multi).reshape(-1)
        slot_mask = torch.nn.functional.one_hot(flat_assign, U * P).bool() & valid[:, None]
        counts = mesh.step_sum(slot_mask.sum(dim=0))
        keep_n = torch.clamp(torch.ceil(counts.float() * ratio), min=1.0)
        scores = torch.where(slot_mask.T, flat_sim[None, :], -torch.inf)
        if mesh.sync_active():
            thr = _global_kth(scores, keep_n.long())
        else:
            order = scores.sort(dim=1, descending=True).values
            idx = (keep_n.long() - 1).clamp(0, order.shape[1] - 1)
            thr = order.gather(1, idx[:, None])[:, 0]
        keep = (valid & (flat_sim >= thr[flat_assign])).reshape(B, h, w)
        onehot = torch.nn.functional.one_hot(assign, U * P).bool()
        single_p = single[clb].repeat_interleave(P, dim=-1)
        contrast_mask = torch.where(is_multi[..., None],
                                    torch.where(keep[..., None], onehot, adm_p), single_p)
        cm_u = contrast_mask.reshape(B, h, w, U, P).any(dim=-1)
        seg = cm_u.repeat_interleave(stride, dim=1).repeat_interleave(stride, dim=2)
        seg = seg[:, :labels.shape[1], :labels.shape[2]]
        seg = torch.where(single.any(dim=-1)[labels][..., None], single[labels], seg)
        empty = ~seg.any(dim=-1)
        seg = torch.where((is_multi_t[labels] & empty)[..., None], multi_only[labels], seg)
        seg = seg & (labels != self.ignore_index)[..., None]
        return contrast_mask, seg
