#!/usr/bin/env python
"""The contrast trainer's step with no process group, on one CUDA card:
configs/bisenetv2_contrast_3ds.json at full width, bf16, one fixed batch of
1 + 1 + 2 crops of 512×1024, at `contrast.num_prototype` 1 (the config's)
and 4; and the anchor choice alone (`losses/contrast.py
hard_anchor_sample`) at each dataset's shape in that step.

  python tools/contrast_step_bench_torch.py [--tree DIR] [--steps 8]

Prints the card (name, power limit, SM clock) and one JSON line: for each P
the step ms (the trainer's own CUDA events, the median over `--steps`
steps after 2 warm ones) and the peak memory; for each dataset the anchor
choice's ms (CUDA events, median of 20 after 3 warm-up calls) on its (46,
B·64·128) noise. `--tree` times another checkout's package (the parent's,
unpacked with `git archive` into a git-ignored directory); compare two
trees in one call, in turns: parent, change, change, parent, each its own
process.
"""

import argparse
import json
import statistics
import tempfile

import numpy as np
import torch

from bench_util_torch import ROOT, cuda_ms, open_tree, print_card

CONFIG = str(ROOT / "configs" / "bisenetv2_contrast_3ds.json")
CATS = (19, 11, 36)  # the config's datasets: Cityscapes, CamVid, A2D2
N_VIEW = 16  # PixelContrastLoss's anchors a class


def batch(cfg):
    """One fixed batch on the card: uint8 images, labels drawn at 1/8
    resolution and repeated ×8 (bench.py:186-189)."""
    rng = np.random.default_rng(0)
    h, w = cfg.get("train", "cropsize")
    out = {"ims": [], "lbs": []}
    for i, n in enumerate(CATS):
        b = int(cfg.dataset_cfg(i)["ims_per_gpu"])
        lb = rng.integers(0, n, (b, h // 8, w // 8))
        lb = np.repeat(np.repeat(lb, 8, 1), 8, 2).astype(np.uint8)
        out["ims"].append(torch.from_numpy(rng.integers(0, 256, (b, h, w, 3), np.uint8)).cuda())
        out["lbs"].append(torch.from_numpy(lb).cuda())
    return out


def step_ms(P, steps):
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer

    cfg = Configer(config_file=CONFIG, args_parser=["contrast.num_prototype", str(P)])
    b = batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as work:
        t = ContrastTrainer(cfg, work_dir=work, compute_dtype=torch.bfloat16, device="cuda")
        for _ in range(steps + 2):
            t.step(b)
        ms = [r["step_ms"] for r in t.read_timings()[2:]]
    del t
    torch.cuda.empty_cache()
    return {"step_ms": statistics.median(ms), "step_ms_all": ms,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}


def anchor_ms(U=46, D=256):
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.losses.contrast import hard_anchor_sample

    cfg = Configer(config_file=CONFIG)
    h, w = cfg.get("train", "cropsize")
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for i in range(len(CATS)):
        n = int(cfg.dataset_cfg(i)["ims_per_gpu"]) * (h // 8) * (w // 8)
        feats = torch.randn(n, D, device="cuda", generator=gen)
        labels = torch.randint(0, U, (n,), device="cuda", generator=gen)
        preds = torch.randint(0, U, (n,), device="cuda", generator=gen)
        noise = torch.rand(U, n, device="cuda", generator=gen)
        out.append({"pixels": n, "ms": cuda_ms(
            lambda: hard_anchor_sample(feats, labels, preds, noise, N_VIEW), n=20)})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None, help="the checkout whose package to time")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    tree = open_tree(args.tree, "contrast_step_bench_torch")
    print_card()
    out = {"tree": str(tree), "anchors": anchor_ms()}
    for P in (1, 4):
        out[f"P{P}"] = step_ms(P, args.steps)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
