#!/usr/bin/env python
"""Per-class pixel statistics → class weights and dataset mean/std, with
the PyTorch port's config and loader: the counterpart of
tools/calc_class_weight.py (reference: tools/Clac_class_weight.py and
tools/Clac_dataset_mean_var.py).

  python tools/calc_class_weight_torch.py --config cfg.json [--dataset 0] [--max-n 500]

Scans up to --max-n batches of the dataset's eval loader and prints one
JSON object: median-frequency class weights (the `class_weight{i}` config
maps), the per-channel mean and std of the images in [0, 1], and the
pixel count of each class (255 ignored).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--dataset", type=int, default=0)
    ap.add_argument("--max-n", type=int, default=500)
    args = ap.parse_args(argv)

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.loader import get_data_loader

    configer = Configer(config_file=args.config)
    loader = get_data_loader(configer, "eval")[args.dataset]
    n_cats = configer.n_cats(args.dataset)

    counts = np.zeros(n_cats, np.int64)
    px_sum = np.zeros(3, np.float64)
    px_sq = np.zeros(3, np.float64)
    n_px = 0
    for i, batch in enumerate(loader):
        if i >= args.max_n:
            break
        lb = np.asarray(batch["lb"]).ravel()
        lb = lb[lb != 255]
        counts += np.bincount(lb, minlength=n_cats)[:n_cats]
        im = np.asarray(batch["im"], np.float64) / 255.0
        px_sum += im.reshape(-1, 3).sum(0)
        px_sq += (im.reshape(-1, 3) ** 2).sum(0)
        n_px += im.size // 3

    freq = counts / max(counts.sum(), 1)
    # median-frequency balancing (the usual Clac_class_weight recipe)
    med = np.median(freq[freq > 0])
    weights = np.where(freq > 0, med / np.maximum(freq, 1e-12), 0.0)
    mean = px_sum / max(n_px, 1)
    std = np.sqrt(np.maximum(px_sq / max(n_px, 1) - mean**2, 0))

    print(json.dumps({
        "class_weight": {str(i): round(float(w), 4) for i, w in enumerate(weights)},
        "mean": [round(float(m), 4) for m in mean],
        "std": [round(float(s), 4) for s in std],
        "pixel_counts": counts.tolist(),
    }, indent=1))


if __name__ == "__main__":
    main()
