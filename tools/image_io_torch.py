"""Image files for the port's tools (segment_torch, demo_torch,
demo_video_torch, label_tools_torch): a `.npy` path is read and written
with numpy, any other path (`.png`, `.jpg`, ...) with PIL, which the tools
need only for such a path. Label maps are resized to a frame size with
PIL's nearest resize where PIL imports, as the JAX tools do, else with the
port's numpy nearest resize (mds_tpu_torch/data/transforms.py
`resize_label`).

Imported by those tools, which run from tools/ (python tools/<tool>.py), so
this module sits beside them on sys.path.
"""

import os

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("this path needs PIL to read or write it, and PIL is not "
                           "installed: give a .npy path instead") from e
    return Image


def is_image(name: str) -> bool:
    return name.lower().endswith((".npy", ".png", ".jpg", ".jpeg", ".bmp"))


def read_image(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB: a .npy array as it is, else the file through
    PIL, converted to RGB."""
    if path.endswith(".npy"):
        im = np.load(path)
        if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
            raise ValueError(f"{path}: expected an (H, W, 3) uint8 array, got "
                             f"{im.dtype} {im.shape}")
        return im
    return np.asarray(_pil().open(path).convert("RGB"))


def write_image(path: str, im: np.ndarray) -> None:
    """A uint8 (H, W, 3) color frame or (H, W) mask: np.save for .npy, else
    PIL, which picks the format from the extension."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if path.endswith(".npy"):
        np.save(path, im)
    else:
        _pil().fromarray(im).save(path)


def resize_labels(lb: np.ndarray, size_hw) -> np.ndarray:
    """A label map (clipped to uint8) at (H, W) by nearest resize."""
    lb = np.clip(lb, 0, 255).astype(np.uint8)
    h, w = size_hw
    if lb.shape == (h, w):
        return lb
    try:
        from PIL import Image
    except ImportError:
        from mds_tpu_torch.data.transforms import resize_label

        return resize_label(lb, (h, w))
    return np.asarray(Image.fromarray(lb).resize((w, h), Image.NEAREST))
