#!/usr/bin/env python
"""Label utilities of the PyTorch port: RGB color-coded masks → trainId
maps, class listings; the counterpart of tools/label_tools.py (the
reference's tools/rbg_conver_to_lb.py, tools/mapi_rgb_conver_to_lb.py,
tools/json_to_color_lb.py, tools/get_label_name.py).

  python tools/label_tools_torch.py names --spec cityscapes
  python tools/label_tools_torch.py rgb2id --spec camvid --in DIR --out DIR

rgb2id maps each pixel whose color is one of the spec's classes' palette
colors to that trainId and every other pixel to 255. The masks in --in are
.npy (H, W, 3) uint8 arrays or .png/.bmp images (PIL); each is written
under its own name into --out (tools/image_io_torch.py).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def cmd_names(args):
    from mds_tpu_torch.data.labels import get_spec

    for i, n in enumerate(get_spec(args.spec).class_names):
        print(f"{i:3d}  {n}")


def rgb_to_id_lut(palette: np.ndarray, n_cats: int):
    """Each class color's trainId, by its packed RGB key."""
    keys = (palette[:n_cats, 0].astype(np.int64) * 65536
            + palette[:n_cats, 1].astype(np.int64) * 256
            + palette[:n_cats, 2].astype(np.int64))
    return {int(k): i for i, k in enumerate(keys)}


def cmd_rgb2id(args):
    from image_io_torch import read_image, write_image
    from mds_tpu_torch.data.labels import get_spec

    spec = get_spec(args.spec)
    lut = rgb_to_id_lut(spec.palette, spec.n_cats)
    src = getattr(args, "in")
    n = 0
    for f in sorted(os.listdir(src)):
        if not f.lower().endswith((".npy", ".png", ".bmp")):
            continue
        rgb = read_image(os.path.join(src, f)).astype(np.int64)
        packed = rgb[..., 0] * 65536 + rgb[..., 1] * 256 + rgb[..., 2]
        out = np.full(packed.shape, 255, np.uint8)
        for k, i in lut.items():
            out[packed == k] = i
        write_image(os.path.join(args.out, f), out)
        n += 1
    print(f"converted {n} masks")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("names")
    p.add_argument("--spec", required=True)
    p.set_defaults(fn=cmd_names)
    p = sub.add_parser("rgb2id")
    p.add_argument("--spec", required=True)
    p.add_argument("--in", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_rgb2id)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
