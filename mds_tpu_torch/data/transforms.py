"""Host-side train augmentations in numpy and PIL — the port's own copy of
mds_tpu/data/transforms.py: `RandomResizedCrop` (:68, with the reference's
upscale of a min side under `min_side` and its pad of deficit // 2 + 1 on
both sides, 0 for the image and 255 for the label), `RandomHorizontalFlip`
(:115, which flips when rand >= p), `ColorJitter` (:131: brightness and
contrast uint8 tables, contrast centred at 74, the saturation 3×3 matrix),
`TransformationTrain` (:192) and `TransformationVal` (:204).

Every transform takes and returns `dict(im=uint8 HxWx3 RGB, lb=uint8 HxW)`
and draws from the explicit `np.random.Generator` passed in, in the JAX
package's order, so both packages augment a sample alike for one seed.
Normalization is left to the device (engine/train_step.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

try:
    from PIL import Image
except ImportError:  # pragma: no cover - the numpy resize below stands in
    Image = None


def resize_image(im: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear uint8 image resize, half-pixel convention: PIL where it
    imports, else `_resize_bilinear_np` (as the JAX package chooses)."""
    h, w = size_hw
    if im.shape[:2] == (h, w):
        return im
    if Image is not None:
        return np.asarray(Image.fromarray(im).resize((w, h), Image.BILINEAR))
    return _resize_bilinear_np(im, (h, w))


def _resize_bilinear_np(im: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    h_out, w_out = size_hw
    h_in, w_in = im.shape[:2]
    ys = (np.arange(h_out) + 0.5) * h_in / h_out - 0.5
    xs = (np.arange(w_out) + 0.5) * w_in / w_out - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h_in - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w_in - 1)
    y1 = np.clip(y0 + 1, 0, h_in - 1)
    x1 = np.clip(x0 + 1, 0, w_in - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    p = im.astype(np.float32)
    top = p[y0][:, x0] * (1 - wx) + p[y0][:, x1] * wx
    bot = p[y1][:, x0] * (1 - wx) + p[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def resize_label(lb: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest label resize, half-pixel convention: exact for class ids."""
    h_out, w_out = size_hw
    h_in, w_in = lb.shape[:2]
    if (h_in, w_in) == (h_out, w_out):
        return lb
    ys = np.minimum(((np.arange(h_out) + 0.5) * h_in / h_out).astype(np.int64), h_in - 1)
    xs = np.minimum(((np.arange(w_out) + 0.5) * w_in / w_out).astype(np.int64), w_in - 1)
    return lb[ys][:, xs]


class RandomResizedCrop:
    """Random-scale resize, pad and random crop to `size` = (crop_h, crop_w)
    from a uniform scale in `scales`."""

    def __init__(self, scales: Sequence[float] = (0.5, 1.0), size=(384, 384),
                 min_side: Optional[int] = 1080):
        self.scales = scales
        self.size = tuple(size) if size is not None else None
        self.min_side = min_side

    def __call__(self, im_lb: dict, rng: np.random.Generator) -> dict:
        if self.size is None:
            return im_lb
        im, lb = im_lb["im"], im_lb["lb"]
        crop_h, crop_w = self.size
        h, w = im.shape[:2]
        scale = rng.uniform(min(self.scales), max(self.scales))
        if self.min_side is not None and min(h, w) < self.min_side:
            scale = scale * (self.min_side / min(h, w))
        im_h, im_w = math.ceil(h * scale), math.ceil(w * scale)
        im = resize_image(im, (im_h, im_w))
        lb = resize_label(lb, (im_h, im_w))
        if (im_h, im_w) == (crop_h, crop_w):
            return dict(im=im, lb=lb)
        pad_h = (crop_h - im_h) // 2 + 1 if im_h < crop_h else 0
        pad_w = (crop_w - im_w) // 2 + 1 if im_w < crop_w else 0
        if pad_h > 0 or pad_w > 0:
            im = np.pad(im, ((pad_h, pad_h), (pad_w, pad_w), (0, 0)))
            lb = np.pad(lb, ((pad_h, pad_h), (pad_w, pad_w)), constant_values=255)
        im_h, im_w = im.shape[:2]
        sh = int(rng.random() * (im_h - crop_h))
        sw = int(rng.random() * (im_w - crop_w))
        return dict(im=np.ascontiguousarray(im[sh: sh + crop_h, sw: sw + crop_w]),
                    lb=np.ascontiguousarray(lb[sh: sh + crop_h, sw: sw + crop_w]))


class RandomHorizontalFlip:
    """Keeps the sample when rand < p, else flips it (`p` is the keep
    probability, as in the reference)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, im_lb: dict, rng: np.random.Generator) -> dict:
        if rng.random() < self.p:
            return im_lb
        return dict(im=np.ascontiguousarray(im_lb["im"][:, ::-1]),
                    lb=np.ascontiguousarray(im_lb["lb"][:, ::-1]))


class ColorJitter:
    """Brightness and contrast uint8 tables, then the saturation matrix."""

    def __init__(self, brightness=None, contrast=None, saturation=None):
        def rng_of(v):
            if v is None or v < 0:
                return None
            return [max(1 - v, 0.0), 1 + v]

        self.brightness = rng_of(brightness)
        self.contrast = rng_of(contrast)
        self.saturation = rng_of(saturation)

    @staticmethod
    def adj_brightness(im: np.ndarray, rate: float) -> np.ndarray:
        table = (np.arange(256, dtype=np.float64) * rate).clip(0, 255).astype(np.uint8)
        return table[im]

    @staticmethod
    def adj_contrast(im: np.ndarray, rate: float) -> np.ndarray:
        table = (74 + (np.arange(256, dtype=np.float64) - 74) * rate).clip(0, 255).astype(np.uint8)
        return table[im]

    @staticmethod
    def adj_saturation(im: np.ndarray, rate: float) -> np.ndarray:
        m = np.float32([[1 + 2 * rate, 1 - rate, 1 - rate],
                        [1 - rate, 1 + 2 * rate, 1 - rate],
                        [1 - rate, 1 - rate, 1 + 2 * rate]])
        out = np.matmul(im.reshape(-1, 3).astype(np.float32), m).reshape(im.shape) / 3
        return np.clip(out, 0, 255).astype(np.uint8)

    def __call__(self, im_lb: dict, rng: np.random.Generator) -> dict:
        im, lb = im_lb["im"], im_lb["lb"]
        if self.brightness is not None:
            im = self.adj_brightness(im, rng.uniform(*self.brightness))
        if self.contrast is not None:
            im = self.adj_contrast(im, rng.uniform(*self.contrast))
        if self.saturation is not None:
            im = self.adj_saturation(im, rng.uniform(*self.saturation))
        return dict(im=im, lb=lb)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, im_lb: dict, rng: np.random.Generator) -> dict:
        for t in self.transforms:
            im_lb = t(im_lb, rng)
        return im_lb


def TransformationTrain(scales, cropsize, min_side: Optional[int] = 1080) -> Compose:
    """Random resized crop, flip, jitter (0.4, 0.4, 0.4)."""
    return Compose([RandomResizedCrop(scales, cropsize, min_side=min_side),
                    RandomHorizontalFlip(),
                    ColorJitter(brightness=0.4, contrast=0.4, saturation=0.4)])


def TransformationVal() -> Compose:
    """The identity."""
    return Compose([])
