"""The native one-pass train augmentation — the port's own copy of
mds_tpu/data/fast_transforms.py (`NativeTransformationTrain` :23).

It draws the random parameters of `transforms.TransformationTrain` (scale,
crop offsets, flip, jitter rates) from the generator in the same order and
runs them as one native pass (`native.fused_augment`). Where the native
library is not available it runs the numpy `TransformationTrain`, per call,
as the JAX package does; `get_data_loader` logs which of the two it took.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from mds_tpu_torch.data import native
from mds_tpu_torch.data.transforms import TransformationTrain


class NativeTransformationTrain:
    def __init__(self, scales: Sequence[float], cropsize: Tuple[int, int],
                 min_side: Optional[int] = 1080,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, flip_keep_p: float = 0.5,
                 lb_lut: Optional[np.ndarray] = None):
        self.scales = scales
        self.crop = tuple(cropsize)
        self.min_side = min_side
        self.b = [max(1 - brightness, 0.0), 1 + brightness]
        self.c = [max(1 - contrast, 0.0), 1 + contrast]
        self.s = [max(1 - saturation, 0.0), 1 + saturation]
        self.flip_keep_p = flip_keep_p
        self.lb_lut = np.arange(256, dtype=np.uint8) if lb_lut is None else lb_lut
        # True: the reader hands over raw label ids and the native pass
        # applies the id→trainId table (a full-resolution gather saved)
        self.wants_raw_label = lb_lut is not None
        self._fallback = TransformationTrain(scales, cropsize, min_side=min_side)

    def set_label_lut(self, lut: np.ndarray) -> None:
        """Apply the dataset's id→trainId table inside the native pass."""
        self.lb_lut = np.ascontiguousarray(lut.astype(np.uint8))
        self.wants_raw_label = True

    def __call__(self, im_lb: dict, rng: np.random.Generator) -> dict:
        if not native.available():
            if self.wants_raw_label:
                im_lb = dict(im=im_lb["im"], lb=self.lb_lut[im_lb["lb"]])
            return self._fallback(im_lb, rng)
        im, lb = im_lb["im"], im_lb["lb"]
        h, w = im.shape[:2]
        crop_h, crop_w = self.crop
        # RandomResizedCrop's draws
        scale = rng.uniform(min(self.scales), max(self.scales))
        if self.min_side is not None and min(h, w) < self.min_side:
            scale = scale * (self.min_side / min(h, w))
        rh, rw = math.ceil(h * scale), math.ceil(w * scale)
        pad_h = (crop_h - rh) // 2 + 1 if rh < crop_h else 0
        pad_w = (crop_w - rw) // 2 + 1 if rw < crop_w else 0
        ph, pw = rh + 2 * pad_h, rw + 2 * pad_w
        off_y = int(rng.random() * (ph - crop_h)) if ph > crop_h else 0
        off_x = int(rng.random() * (pw - crop_w)) if pw > crop_w else 0
        # the flip's draw (keep when rand < p), then the jitter's three
        flip = not (rng.random() < self.flip_keep_p)
        br = rng.uniform(*self.b)
        ct = rng.uniform(*self.c)
        st = rng.uniform(*self.s)
        out_im, out_lb = native.fused_augment(
            im, lb, (rh, rw), (pad_h, pad_w), (off_y, off_x), (crop_h, crop_w),
            flip, br, ct, st, self.lb_lut)
        return dict(im=out_im, lb=out_lb)
