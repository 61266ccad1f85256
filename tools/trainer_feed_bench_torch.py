#!/usr/bin/env python
"""What the data loader, the host feed and the checkpoint save cost around
the port's train step, on one CUDA card.

  python tools/trainer_feed_bench_torch.py [--steps 6] [--variants ...]

Each variant runs the port's `Trainer` in this process on
configs/bisenetv2_city.json with the Synthetic reader at Cityscapes'
1024×2048 frame (BiSeNetV2, bs16 crops of 512×1024, bf16, SGD) for
`--steps` steps, a log line and a device sync every step and a checkpoint
at the last:

  fixed          one batch made beforehand and fed again every step: no
                 data work on the host while the steps run
  numpy-8        the numpy augment pipeline on 8 loader threads (the
                 config's `train.num_workers`)
  numpy-2        the same on 2 threads
  native-8       the native augment pipeline (cpp/mdspre.cpp) on 8 threads,
                 where the library builds; else its build error is printed
  fixed-fused    `fixed` with train.fused_up_loss
  numpy-8-fused  `numpy-8` with train.fused_up_loss

One JSON line a variant: the medians over steps 2 onward of the step's ms
(CUDA events), the iteration's host ms (`loop_ms`), the ms waited on the
loader and on the host side of the H2D copy; the loop's images/s over the
same window (all its images over the sum of its `loop_ms`, the checkpoint
save and any stall included); the checkpoint save's ms; the peak memory. The card's name and power limit come first. Last, the loader's
work per frame on one host thread (host clock, median of 6 frames): making
a Synthetic 1024×2048 frame, and the config's train augment of it on the
numpy pipeline and, where it builds, the native one.
"""

import argparse
import gc
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CONFIG = os.path.join(ROOT, "configs", "bisenetv2_city.json")
SYNTHETIC = ["dataset1.data_reader", "Synthetic",
             "dataset1.reader_kwargs", "{'n_cats': 19, 'size': [1024, 2048], 'length': 64}",
             "train.log_interval", "1"]
VARIANTS = ("fixed", "numpy-8", "numpy-2", "native-8", "fixed-fused", "numpy-8-fused")


def overrides(variant, steps):
    threads = variant.split("-")[1] if variant.startswith(("numpy", "native")) else "8"
    return SYNTHETIC + [
        "lr.max_iter", str(steps), "train.ckpt_interval", str(steps),
        "train.num_workers", threads,
        "train.native_pipeline", str(variant.startswith("native")),
        "train.fused_up_loss", str(variant.endswith("fused"))]


def run(variant, steps):
    import torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data import native
    from mds_tpu_torch.data.loader import get_data_loader
    from mds_tpu_torch.engine.trainer import Trainer

    if variant.startswith("native") and not native.available():
        return {"variant": variant, "skipped": f"native library: {native.build_error}"}
    cfg = Configer(config_file=CONFIG, args_parser=overrides(variant, steps))
    with tempfile.TemporaryDirectory() as work:
        t = Trainer(cfg, work_dir=work, device="cuda")
        loader = None
        if variant.startswith("fixed"):
            real = get_data_loader(cfg, "train")
            loader = itertools.repeat(next(real))
            real.close()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t.train(loader=loader)
        peak = torch.cuda.max_memory_allocated()
    recs = t.timings[1:]  # the first step builds and tunes

    def med(key):
        return float(np.median([r[key] for r in recs]))

    out = {"variant": variant, "pipeline": t.pipeline or "fixed batch",
           "steps": len(t.timings), "median_step_ms": med("step_ms"),
           "median_loop_ms": med("loop_ms"), "median_loader_wait_ms": med("loader_ms"),
           "median_copy_ms": med("copy_ms"),
           "checkpoint_save_ms": [r["ckpt_ms"] for r in t.timings if "ckpt_ms" in r],
           "images_per_s_step": 16e3 / med("step_ms"),
           "images_per_s_loop": 16e3 * len(recs) / sum(r["loop_ms"] for r in recs),
           "step_ms": [r["step_ms"] for r in t.timings],
           "loop_ms": [r["loop_ms"] for r in t.timings],
           "max_memory_allocated": peak}
    del t
    gc.collect()
    torch.cuda.empty_cache()
    return out


def loader_split(frames=6):
    """Host ms per frame, one thread: the Synthetic frame, then each
    augment pipeline on it."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data import native
    from mds_tpu_torch.data.base import SyntheticDataset
    from mds_tpu_torch.data.fast_transforms import NativeTransformationTrain
    from mds_tpu_torch.data.transforms import TransformationTrain

    cfg = Configer(config_file=CONFIG)
    aug = dict(scales=cfg.get("train", "scales"), cropsize=cfg.get("train", "cropsize"),
               min_side=cfg.get("train", "min_side", default=1080))
    ds = SyntheticDataset(n_cats=19, size=(1024, 2048), length=64)
    out, samples = {}, []
    times = []
    for i in range(frames):
        t0 = time.perf_counter()
        samples.append(ds.read(i))
        times.append((time.perf_counter() - t0) * 1e3)
    out["synthetic_frame_ms"] = float(np.median(times))
    pipelines = {"numpy_augment_ms": TransformationTrain(**aug)}
    if native.available():
        pipelines["native_augment_ms"] = NativeTransformationTrain(**aug)
    for name, trans in pipelines.items():
        rng, times = np.random.default_rng(0), []
        for s in samples:
            t0 = time.perf_counter()
            trans(s, rng)
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(times))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--variants", nargs="*", default=list(VARIANTS), choices=VARIANTS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("trainer_feed_bench_torch needs a CUDA device")
    from mds_tpu_torch.ops.build import load

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "cpus": os.cpu_count()}), flush=True)
    load()  # builds the kernels: not part of any variant's time
    for v in args.variants:
        print(json.dumps(run(v, args.steps)), flush=True)
    print(json.dumps({"loader_per_frame_one_thread": loader_split()}), flush=True)


if __name__ == "__main__":
    main()
