#!/usr/bin/env python
"""Evaluate with the PyTorch port: the counterpart of tools/evaluate.py.

  python tools/evaluate_torch.py --config configs/bisenetv2_city.json \\
      [--ckpt DIR] [--mode ss|ssc|msf|mscf|...] [--work-dir res] \\
      [--precise-bn N] [--device cuda|cpu] [key.path value ...]

The model is the config's, its weights the latest checkpoint the port's
trainer wrote under DIR (else under `<work-dir>/ckpt`, `<work-dir>/
ckpt_gnn` for the flagship snp_rn18 and the alternating trainer's modes,
or `<work-dir>/ckpt_contrast` for train.mode contrast; with none, the
seeded init). An HRNet config (configs/hrnet_w48_city.json, the
hrnet_w48_gnn ones) takes the plain route: `build_model`, then `<DIR>`'s
checkpoint (no trainer writes one: chip_smoke.py's hrnet phase saves
`{"model": state_dict, "step": 0}` with engine/checkpoints.py).
`--precise-bn N` first recomputes the BN running stats over
N train batches. It prints one `dataset{i} mIoU ({mode}): x` line per
dataset. It runs on the CUDA card; without one it exits non-zero unless
`--device cpu` is given. It sets no route switch: a caller that wants the
deploy kernels sets `models/layers.py`'s switches around `main`, as
bench.py does.

Modes: ss, ssc, msf, mscf, aux, contrast, uni, label_link and unlabel;
unseen and clip on the prototype models (snp_rn18, snp_rn18_mulbn,
HRNet); emb on the
contrast family (configs/bisenetv2_contrast_3ds.json: the memory bank's
class means as prototypes); dsg, the contrast protocol over each
dataset's stage-2 train list (`train_im_anns` with `_2.txt`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    from mds_tpu_torch.evaluation.evaluator import EVAL_MODES

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--mode", default="ss", choices=list(EVAL_MODES))
    ap.add_argument("--work-dir", default="./res")
    ap.add_argument("--precise-bn", type=int, default=0, metavar="N",
                    help="recompute the BN running stats over N train batches first")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotted-key config overrides")
    return ap.parse_args(argv)


def main(argv=None):
    """Evaluate as the arguments ask; returns the per-dataset mIoU."""
    args = parse_args(argv)

    import torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.evaluation.drivers import run_evaluation

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate_torch needs a CUDA device; pass --device cpu "
                           "to evaluate on the CPU")
    configer = Configer(config_file=args.config, args_parser=args.overrides)
    mious = run_evaluation(configer, mode=args.mode, ckpt=args.ckpt,
                           work_dir=args.work_dir, precise_bn=args.precise_bn,
                           device=args.device)
    for i, miou in enumerate(mious):
        print(f"dataset{i + 1} mIoU ({args.mode}): {miou:.4f}", flush=True)
    return mious


if __name__ == "__main__":
    main()
