#!/usr/bin/env python
"""Train with the PyTorch port: the counterpart of the supervised seg branch
of tools/train.py (the JAX package's entry point).

  python tools/train_torch.py --config configs/bisenetv2_city.json \\
      [--work-dir res] [--max-iter N] [--finetune-from PATH] \\
      [--device cuda|cpu] [key.path value ...]

Dotted overrides set config keys (`lr.max_iter 6`, `train.fused_up_loss
True`, `dataset1.data_reader Synthetic`). The run resumes from the latest
checkpoint under `<work-dir>/ckpt` when there is one. It runs on the CUDA
card; without one it exits non-zero unless `--device cpu` is given. The
alternating SEG/GNN trainer (`--gnn`, `train.mode` alternate/gnn/clip) and
the contrast trainer (`train.mode` contrast) are not in the port yet.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--work-dir", default="./res")
    ap.add_argument("--max-iter", type=int, default=None)
    ap.add_argument("--gnn", action="store_true", help="alternating SEG/GNN training")
    ap.add_argument("--finetune-from", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotted-key config overrides")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the training the arguments ask for; returns the Trainer."""
    args = parse_args(argv)

    import torch

    from mds_tpu_torch.engine.trainer import NOT_PORTED, train_from_config

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_torch needs a CUDA device; pass --device cpu "
                           "to train on the CPU")
    if args.gnn:
        raise NotImplementedError(NOT_PORTED.format("gnn"))
    return train_from_config(args.config, args.overrides, work_dir=args.work_dir,
                             max_iter=args.max_iter, device=args.device,
                             finetune_from=args.finetune_from)


if __name__ == "__main__":
    main()
