#!/usr/bin/env python
"""Train with the PyTorch port: the counterpart of tools/train.py (the JAX
package's entry point).

  python tools/train_torch.py --config configs/bisenetv2_city.json \\
      [--work-dir res] [--max-iter N] [--finetune-from PATH] \\
      [--device cuda|cpu] [key.path value ...]
  python tools/train_torch.py --config configs/bisenetv1_city.json
  python tools/train_torch.py --config configs/ltbgnn_3_datasets_snp.json --gnn
  python tools/train_torch.py --config configs/bisenetv2_contrast_3ds.json
  python tools/train_torch.py --config configs/clip_5_datasets.json

Dotted overrides set config keys (`lr.max_iter 6`, `train.fused_up_loss
True`, `dataset1.data_reader Synthetic`). `--gnn`, or `train.mode`
alternate, seg, gnn or clip, runs the flagship's alternating SEG/GNN
trainer (snp_rn18 + BGNN; clip: SEG steps against prototypes frozen at the
node features' text half), which resumes from `<work-dir>/ckpt_gnn`; `train.mode`
contrast the pixel-contrast trainer (BiSeNetV2Contrast, memory bank, EMA
teacher; log line every `train.log_interval` steps with the contrast
loss), which resumes from `<work-dir>/ckpt_contrast`; otherwise the
supervised trainer (BiSeNetV2, BiSeNetV1), which resumes from
`<work-dir>/ckpt`. The compute dtype is each trainer's own, as in JAX: f32
for the alternating trainer, bf16 for the others. It runs on the CUDA
card; without one it exits non-zero unless `--device cpu` is given.

On N cards: `torchrun --nproc_per_node N tools/train_torch.py --config
...` (with `--gnn` or `train.mode contrast` too), or N processes with
MDS_COORDINATOR=host:port, MDS_NUM_PROCESSES=N and MDS_PROCESS_ID=r (the
JAX tool's variables). Each process joins the group (NCCL on the card,
gloo with `--device cpu`) before touching the device and trains on its
rank's `ims_per_gpu` images a dataset; rank 0 logs and saves, and a
resume broadcasts rank 0's checkpoint. The supervised trainer takes
SyncBN or local BN as the config's `use_sync_bn` says
(engine/trainer.py); the alternating and contrast trainers always take
the one-process step on the global batch (SyncBN, global anchors, bank
pushes and prototype Sinkhorn; engine/gnn_trainer.py,
engine/contrast_trainer.py), as JAX's do on their data mesh.
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
    """Run the training the arguments ask for; returns the trainer."""
    args = parse_args(argv)

    import torch

    from mds_tpu_torch.engine.trainer import train_from_config
    from mds_tpu_torch.parallel import mesh

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_torch needs a CUDA device; pass --device cpu "
                           "to train on the CPU")
    mesh.maybe_initialize_distributed(args.device)
    return train_from_config(args.config, args.overrides, work_dir=args.work_dir,
                             max_iter=args.max_iter, device=args.device,
                             finetune_from=args.finetune_from, gnn=args.gnn)


if __name__ == "__main__":
    main()
