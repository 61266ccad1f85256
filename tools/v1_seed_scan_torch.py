#!/usr/bin/env python
"""BiSeNetV1 of the PyTorch port on one CUDA card: the 7×7 stem kernel route
against the plain path, over random-weight seeds 0-5, at chip_smoke.py's
1024×2048.

  python tools/v1_seed_scan_torch.py

A random model's bf16 argmax agreement between two routes depends on how
many of its pixels sit within rounding noise of a tie between classes, so
whether a seed passes chip_smoke.py's gates (agreement > 0.995, logits rel
max-diff < 2e-2) depends on the seed; chip_smoke.py's V1_WEIGHT_SEED is
chosen from this scan. For each seed s the model is built as chip_smoke.py's
v1_slice phase builds it (tools/serve_torch.py build_e2e with seed s, BN
statistics from seed s + 1) and runs that phase's first frame on both
routes, the plain one with TF32 off as there; one JSON line per seed:
agreement, logits rel, classes in the map.
"""

import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

SEEDS = range(6)


def main():
    import numpy as np
    import torch

    from chip_smoke import H, V1_CONFIG, W, normalized, randomize_bn, rel, route
    from serve_torch import build_e2e

    if not torch.cuda.is_available():
        raise RuntimeError("v1_seed_scan_torch needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frame = np.random.default_rng(4).integers(0, 256, (3, 1, H, W, 3)).astype(np.uint8)[0]
    print(torch.cuda.get_device_name(0), flush=True)
    for seed in SEEDS:
        e2e = build_e2e(V1_CONFIG, seed=seed, device="cuda")
        randomize_bn(e2e.model, seed + 1)
        x = normalized(e2e, frame)
        with torch.inference_mode():
            plain = e2e.model.eval_logits(x)
            with route("kernel"):
                kernel = e2e.model.eval_logits(x)
        labels = kernel.argmax(dim=1)
        print(json.dumps({
            "seed": seed,
            "agreement": (labels == plain.argmax(dim=1)).float().mean().item(),
            "logits_rel": rel(kernel, plain),
            "classes": int(labels.unique().numel())}), flush=True)


if __name__ == "__main__":
    main()
