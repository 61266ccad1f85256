#!/usr/bin/env python
"""Print the bipartite graphs of the PyTorch port's alternating trainer:
the counterpart of tools/print_bigraph.py.

  python tools/print_bigraph_torch.py --config configs/ltbgnn_3_datasets_snp.json \\
      [--ckpt DIR] [--dataset I] [--device cuda|cpu] [key.path value ...]

It builds the trainer of the config, restores the checkpoint under DIR
(without one the graphs come from the seeded init), runs the trainer's
`optimal_matching` (the graph net's prototypes and its UOT graphs, or KM
graphs with GNN.use_km) and prints, per dataset class, the unified slots
its graph maps it to. It runs on the CUDA card; without one it exits
non-zero unless `--device cpu` is given.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def print_bipartite(graphs, class_names=None, unified_names=None):
    for i, g in enumerate(graphs):
        g = np.asarray(g)
        print(f"== dataset {i} ({g.shape[0]} classes → {g.shape[1]} unified) ==")
        for row in range(g.shape[0]):
            cols = np.flatnonzero(g[row] > 0)
            name = class_names[i][row] if class_names else str(row)
            uni = ", ".join(unified_names[c] if unified_names else str(int(c)) for c in cols)
            print(f"  {name:>24s} -> [{uni}]")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="the alternating trainer's checkpoint directory "
                         "(tools/train_torch.py --gnn writes <work-dir>/ckpt_gnn)")
    ap.add_argument("--dataset", type=int, default=None, help="print only this dataset's graph")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("overrides", nargs="*", help="dotted-key config overrides")
    return ap.parse_args(argv)


def main(argv=None):
    """Print the graphs; returns them (numpy, one a dataset)."""
    args = parse_args(argv)

    import torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("print_bigraph_torch needs a CUDA device; pass --device cpu "
                           "to run on the CPU")
    configer = Configer(config_file=args.config, args_parser=args.overrides)
    t = AlternatingTrainer(configer, device=args.device)
    if args.ckpt:
        t.restore(args.ckpt)
    _, graphs = t.optimal_matching()
    names = []
    for i in range(configer.n_datasets):
        spec = configer.dataset_cfg(i).get("spec")
        names.append(list(get_spec(spec).class_names) if spec
                     else [str(j) for j in range(configer.n_cats(i))])
    graphs = list(graphs)
    if args.dataset is not None:
        print(f"(dataset {args.dataset})")
        graphs, names = [graphs[args.dataset]], [names[args.dataset]]
    print_bipartite(graphs, names)
    return graphs


if __name__ == "__main__":
    main()
