"""Concatenated multi-dataset readers and unified-label single readers —
the port's copy of mds_tpu/data/multiset.py (`MultiSetReader` :21,
`AllDatasetsReader` :47, `build_translation_lut` :67, `CITY_TO_CAMVID`
:80, `translate_labels` :96), registered in `DATASETS` under the same
names.

`MultiSetReader` concatenates N readers: index j reads the reader whose
range holds it, and the sample carries its `dataset_id`.
`AllDatasetsReader` reads one ann file whose labels are already unified
ids (an identity table in place of a dataset's).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from mds_tpu_torch.data.base import AnnFileDataset
from mds_tpu_torch.data.labels import DatasetSpec
from mds_tpu_torch.registry import DATASETS


@DATASETS.register("MultiSetReader")
class MultiSetReader:
    def __init__(self, readers: Sequence):
        self.readers = list(readers)
        self._offsets = np.cumsum([0] + [len(r) for r in self.readers])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def reader_index(self, idx: int) -> Tuple[int, int]:
        """(reader, index within it) of concatenated index `idx`."""
        ds = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return ds, idx - int(self._offsets[ds])

    def read(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        ds, local = self.reader_index(idx)
        sample = dict(self.readers[ds].read(local, rng))
        sample["dataset_id"] = ds
        return sample

    __getitem__ = read


@DATASETS.register("AllDatasetsReader")
class AllDatasetsReader(AnnFileDataset):
    def __init__(self, dataroot, annpath, trans_func=None, mode="train", n_cats: int = 0):
        ident = np.arange(256, dtype=np.uint8)
        n = n_cats or 255
        spec = DatasetSpec(name="unified", n_cats=n, mean=np.zeros(3, np.float32),
                           std=np.ones(3, np.float32), lut_eval=ident, lut_train=ident,
                           class_names=tuple(str(i) for i in range(n)))
        super().__init__(dataroot, annpath, spec, trans_func, mode)


def build_translation_lut(pairs, default: int = 255) -> np.ndarray:
    """trainId → trainId table from (src, dst) pairs; 255 stays 255."""
    lut = np.full(256, default, np.uint8)
    lut[255] = 255
    for src, dst in pairs:
        lut[src] = dst
    return lut


# Cityscapes trainId → CamVid trainId: sky, building, pole, road, sidewalk,
# vegetation, sign, fence, car, pedestrian, bicycle; the rest ignore
CITY_TO_CAMVID = build_translation_lut([
    (10, 0), (2, 1), (5, 2), (0, 3), (1, 4), (8, 5), (7, 6), (4, 7), (13, 8),
    (11, 9), (18, 10)])


def translate_labels(labels: np.ndarray, lut: np.ndarray) -> np.ndarray:
    return lut[labels]
