"""Dataset readers returning uint8 numpy samples — the port's own copy of
mds_tpu/data/base.py (`AnnFileDataset` :61, `_make_reader` :123 and its
registered readers, `SyntheticDataset` :157), registered in
`mds_tpu_torch.registry.DATASETS` under the JAX package's names.

An ann-file reader reads one `im_path,lb_path` pair a line, decodes the RGB
image and the label (the native library's libjpeg/libpng where it is built,
PIL otherwise), maps label ids through the dataset's eval table (unless the
train transform applies it itself) and runs the transform. A sample is
`dict(im=uint8 HxWx3, lb=uint8 HxW)`; normalization is left to the device.
"""

from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np

from mds_tpu_torch.data import native as _native
from mds_tpu_torch.data.labels import DatasetSpec, get_spec
from mds_tpu_torch.registry import DATASETS


def _decode_native(path: str, channels: int) -> Optional[np.ndarray]:
    """Decode through the native library where that is safe, else None
    (the caller uses PIL). A label PNG that is 16-bit, palette or RGB keeps
    PIL's reading: libpng's conversions would remap the ids PIL reads
    verbatim."""
    if not _native.available():
        return None
    low = path.lower()
    is_jpg = low.endswith((".jpg", ".jpeg"))
    if not (is_jpg or low.endswith(".png")):
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if is_jpg:
        return _native.decode_jpeg(data) if channels == 3 else None
    # PNG IHDR: byte 24 = bit depth, byte 25 = colour type (0 gray,
    # 2 rgb, 3 palette, 4 gray+alpha, 6 rgba)
    if len(data) <= 25:
        return None
    if channels == 1 and (data[24] == 16 or data[25] not in (0, 4)):
        return None
    return _native.decode_png(data, channels=channels)


class AnnFileDataset:
    """`im,lb` per line, labels through the spec's eval table."""

    def __init__(self, dataroot: str, annpath: str, spec: DatasetSpec,
                 trans_func=None, mode: str = "train"):
        self.mode = mode
        self.trans_func = trans_func
        self.spec = spec
        self.lb_map = spec.lut_eval
        self.n_cats = spec.n_cats
        self.img_paths, self.lb_paths = [], []
        with open(annpath) as fr:
            for line in fr.read().splitlines():
                if not line.strip():
                    continue
                imgpth, lbpth = line.split(",")
                self.img_paths.append(osp.join(dataroot, imgpth))
                self.lb_paths.append(osp.join(dataroot, lbpth))

    def __len__(self) -> int:
        return len(self.img_paths)

    def get_image(self, impth: str) -> np.ndarray:
        out = _decode_native(impth, channels=3)
        if out is not None:
            return out
        from PIL import Image

        return np.asarray(Image.open(impth).convert("RGB"))

    def get_label(self, lbpth: str) -> np.ndarray:
        out = _decode_native(lbpth, channels=1)
        if out is not None:
            return out
        from PIL import Image

        return np.asarray(Image.open(lbpth)).astype(np.uint8)

    def read(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        label = self.get_label(self.lb_paths[idx])
        if not getattr(self.trans_func, "wants_raw_label", False):
            label = self.lb_map[label]
        im_lb = dict(im=self.get_image(self.img_paths[idx]), lb=label)
        if self.trans_func is not None:
            im_lb = self.trans_func(im_lb, rng or np.random.default_rng())
        return im_lb

    __getitem__ = read


def _make_reader(spec_name: str):
    class _Reader(AnnFileDataset):
        def __init__(self, dataroot, annpath, trans_func=None, mode="train"):
            super().__init__(dataroot, annpath, get_spec(spec_name), trans_func, mode)

    _Reader.__name__ = spec_name.capitalize() + "Reader"
    _Reader.__qualname__ = _Reader.__name__
    return _Reader


# the JAX package's reader names (mds_tpu/data/base.py:137-154, :217-220)
for _name, _spec in (
        ("CityScapes", "cityscapes"), ("CamVid", "camvid"), ("A2D2Data", "a2d2"),
        ("Mapiv1", "mapillary"), ("Sunrgbd", "sunrgbd"), ("Bdd100k", "bdd100k"),
        ("Idd", "idd"), ("ade2016", "ade20k"), ("Coco_data", "cocostuff"),
        ("wd2", "wilddash2"), ("scannet", "scannet"), ("Kitti", "kitti"),
        ("Voc", "voc"), ("Mapiv1_mseg", "mapillary_mseg"),
        ("ade2016_mseg", "ade20k_mseg"), ("Coco_data_mseg", "cocostuff_mseg")):
    DATASETS.register(_name)(_make_reader(_spec))


@DATASETS.register("Synthetic")
class SyntheticDataset:
    """Deterministic generated dataset for tests and pipeline measurements:
    a label map of a few random class blocks with `ignore_frac` of its
    pixels ignored, and an image of one colour per class plus noise, all
    from numpy generators seeded by (seed, idx)."""

    def __init__(self, dataroot=None, annpath=None, trans_func=None,
                 mode: str = "train", n_cats: int = 8, size=(64, 64),
                 length: int = 32, seed: int = 0, ignore_frac: float = 0.1):
        self.trans_func = trans_func
        self.mode = mode
        self.n_cats = n_cats
        self.size = tuple(size)
        self.length = length
        self.seed = seed
        self.ignore_frac = ignore_frac
        self.spec = None

    def __len__(self) -> int:
        return self.length

    def read(self, idx: int, rng: Optional[np.random.Generator] = None) -> dict:
        g = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.size
        lb = np.zeros((h, w), dtype=np.uint8)
        for _ in range(4):
            cls = g.integers(0, self.n_cats)
            y0, x0 = g.integers(0, h), g.integers(0, w)
            bh, bw = g.integers(h // 4, h), g.integers(w // 4, w)
            lb[y0: y0 + bh, x0: x0 + bw] = cls
        if self.ignore_frac > 0:
            mask = g.random((h, w)) < self.ignore_frac
            lb = np.where(mask, np.uint8(255), lb)
        colors = np.random.default_rng(self.seed).integers(
            0, 256, size=(256, 3), dtype=np.int64)
        im = colors[lb] + g.normal(0, 8, size=(h, w, 3))
        im_lb = dict(im=np.clip(im, 0, 255).astype(np.uint8), lb=lb)
        if self.trans_func is not None:
            im_lb = self.trans_func(im_lb, rng or np.random.default_rng())
        return im_lb

    __getitem__ = read
