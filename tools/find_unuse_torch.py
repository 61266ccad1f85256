#!/usr/bin/env python
"""The label-usage audit with the PyTorch port: the counterpart of
tools/find_unuse.py.

  python tools/find_unuse_torch.py --config configs/ltbgnn_3_datasets_snp.json \\
      [--ckpt DIR] [--work-dir res] [--out target_bipart.npz] \\
      [--device cuda|cpu] [key.path value ...]

The model is the one tools/evaluate_torch.py would evaluate (the flagship
snp_rn18 or snp_rn18_mulbn from the alternating trainer's latest
checkpoint under DIR, else under `<work-dir>/ckpt_gnn`). Per dataset it
prints, as JSON, the unified slots each class owns in its bipartite graph
and uses (more than a tenth of the class's predictions over them), then
the audit's seconds; `--out` writes each dataset's use/unuse target graph
`target_bipart_{i}` (n_cats_i, M) into an .npz. Both passes run over the
eval lists, as the JAX tool's do. It runs on the CUDA card; without one it
exits non-zero unless `--device cpu` is given. Launched as several
processes (`torchrun --nproc_per_node N`, or the MDS_COORDINATOR,
MDS_NUM_PROCESSES and MDS_PROCESS_ID variables), each reads its rank's
share of the eval lists, the counts are summed over the ranks, and rank 0
writes `--out`.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None, help="checkpoint directory")
    ap.add_argument("--work-dir", default="./res")
    ap.add_argument("--out", default=None, help="write target_bipart_{i} into this .npz")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotted-key config overrides")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the audit; returns (the per-dataset used slots, the target
    graphs, the seconds of each pass)."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.loader import get_data_loader
    from mds_tpu_torch.engine.trainer import dataset_stats
    from mds_tpu_torch.evaluation.drivers import (
        build_eval_bundle,
        eval_find_use_and_unuse_label,
        find_unuse_label,
    )
    from mds_tpu_torch.parallel import mesh

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("find_unuse_torch needs a CUDA device; pass --device cpu "
                           "to run on the CPU")
    mesh.maybe_initialize_distributed(args.device)
    rank, world = mesh.rank(), mesh.world()
    configer = Configer(config_file=args.config, args_parser=args.overrides)
    model = build_eval_bundle(configer, ckpt=args.ckpt, work_dir=args.work_dir,
                              device=mesh.local_device(args.device))
    means, stds = dataset_stats(configer)
    t0 = time.perf_counter()
    used = []
    for i, loader in enumerate(get_data_loader(configer, "eval", rank=rank, world=world)):
        buckets = find_unuse_label(configer, model, loader, configer.n_cats(i), i,
                                   mean=means[i], std=stds[i])
        used.append(buckets)
        print(f"dataset{i + 1} used slots per class:")
        print(json.dumps({str(k): v for k, v in sorted(buckets.items())}), flush=True)
    t1 = time.perf_counter()
    _, _, target_bipart = eval_find_use_and_unuse_label(
        configer, model, get_data_loader(configer, "eval", rank=rank, world=world),
        means=means, stds=stds)
    t2 = time.perf_counter()
    seconds = {"find_unuse_s": t1 - t0, "use_and_unuse_s": t2 - t1}
    print(json.dumps({"audit_seconds": seconds}), flush=True)
    if args.out and rank == 0:
        np.savez(args.out, **{f"target_bipart_{i}": t for i, t in enumerate(target_bipart)})
        print(f"wrote {args.out}", flush=True)
    return used, target_bipart, seconds


if __name__ == "__main__":
    main()
