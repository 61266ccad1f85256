"""The evaluation drivers the eval CLI runs — counterpart of
mds_tpu/evaluation/drivers.py (`build_eval_bundle` :29,
`recompute_bn_stats` :89, `run_evaluation` :131).

The model comes from the trainer's `build_model` and its weights from the
latest checkpoint the port's `Trainer` wrote (`<ckpt>/<step>.pt`), so any
checkpoint the train CLI writes is evaluable; BiSeNetV1 checkpoints load
too. The flagship (snp_rn18, or `train.mode` alternate, seg, gnn or clip) comes
from the alternating trainer and its checkpoint (`<ckpt>`, else
`<work_dir>/ckpt_gnn`): the seg state with its bipartite graphs. The
contrast family (`train.mode` contrast) comes from the contrast trainer
and its checkpoint (`<ckpt>`, else `<work_dir>/ckpt_contrast`), with the
memory bank's class means as the `emb` mode's prototypes. The
label-usage audit (`_unified_hist`, `find_unuse_label`,
`eval_find_use_and_unuse_label`, `_slot_buckets`, `find_label_relation`,
:169-297) waits (ROADMAP queue 1, item 6b).
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch
from torch import nn

from mds_tpu_torch.evaluation.evaluator import eval_model

DSG_ITEM = ("eval mode 'dsg' scores the stage-2 train lists, which need the "
            "loader's `stage` option: ROADMAP queue 1, item 6b")


def is_alternating(configer) -> bool:
    """Whether the config trains through the alternating trainer."""
    from mds_tpu_torch.engine.gnn_trainer import MODES

    return (configer.get("train", "mode", default=None) in MODES
            or configer.get("model_name", default=None) == "snp_rn18")


def build_eval_bundle(configer, ckpt: Optional[str] = None, work_dir: str = "./res",
                      device="cuda") -> nn.Module:
    """The model for `eval_model`, in eval mode on `device`: the config's
    model (bf16 compute) at its seeded init, then the latest checkpoint of
    `ckpt` (else of `<work_dir>/ckpt`) when there is one. The flagship: the
    alternating trainer's seg model (bf16, JAX's identity graphs at init,
    and in clip mode the node features' text prototypes) restored from
    the latest checkpoint of `ckpt` (else of
    `<work_dir>/ckpt_gnn`), its graphs included (mds_tpu/evaluation/
    drivers.py:46-58). `train.mode` contrast: the contrast trainer's
    model (bf16) restored from the latest checkpoint of `ckpt` (else of
    `<work_dir>/ckpt_contrast`), its `prototypes` the (U, 1, D) class means
    of the memory bank, `feats.mean(axis=1, keepdims=True)` (:58-76)."""
    from mds_tpu_torch.engine.checkpoints import CheckpointManager, load_train_state
    from mds_tpu_torch.engine.trainer import build_model

    mode = configer.get("train", "mode", default=None)
    if is_alternating(configer):
        from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

        tr = AlternatingTrainer(configer, compute_dtype=torch.bfloat16, device=device)
        directory = os.path.abspath(ckpt) if ckpt else os.path.join(work_dir, "ckpt_gnn")
        if tr.latest_step(directory) is not None:
            tr.restore(directory)
        return tr.seg_model.eval()
    if mode == "contrast":
        from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer

        tr = ContrastTrainer(configer, work_dir=work_dir, device=device)
        directory = os.path.abspath(ckpt) if ckpt else tr.ckpt.directory
        if os.path.isdir(directory) and CheckpointManager(directory).latest_step() is not None:
            tr.restore(directory)
        tr.model.prototypes = tr.bank.feats.mean(dim=1, keepdim=True)
        return tr.model.eval()
    model = build_model(configer)
    seed = int(configer.get("seed", default=0) or 0)
    model.init_weights(torch.Generator().manual_seed(seed))
    directory = os.path.abspath(ckpt) if ckpt else os.path.join(work_dir, "ckpt")
    if os.path.isdir(directory):
        manager = CheckpointManager(directory)
        if manager.latest_step() is not None:
            state, _ = manager.restore()
            load_train_state(model, None, state)
    return model.to(device).eval()


def recompute_bn_stats(configer, model: nn.Module, n_batches: int,
                       compute_dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """Precise BN over `n_batches` batches of the config's train loader,
    normalized per dataset as the train step does, every batch with the
    same dropout generator (seed 0, as JAX's PRNGKey(0)). `model` is
    updated in place and left in eval mode."""
    from mds_tpu_torch.data.loader import get_data_loader
    from mds_tpu_torch.engine.precise_bn import update_bn_stats
    from mds_tpu_torch.engine.train_step import normalize_images
    from mds_tpu_torch.engine.trainer import dataset_stats

    device = next(model.parameters()).device
    means, stds = dataset_stats(configer)

    def forward(model, batch):
        ims = [torch.from_numpy(x).to(device) for x in batch["ims"]]
        xs = normalize_images(ims, means, stds, compute_dtype)
        if hasattr(model, "bipartite_graphs"):  # snp_rn18: no dropout
            model.features(xs)
        else:
            model(xs, generator=torch.Generator().manual_seed(0))

    def batches():
        for _ in range(n_batches):
            yield next(loader)

    loader = get_data_loader(configer, "train")
    try:
        return update_bn_stats(model, batches(), forward)
    finally:
        loader.close()


def run_evaluation(configer, mode: str = "ss", ckpt: Optional[str] = None,
                   work_dir: str = "./res", precise_bn: int = 0,
                   device="cuda") -> List[float]:
    """Config → per-dataset mIoU for an eval mode (the eval CLI's body).
    precise_bn > 0 first recomputes the BN running stats over that many
    train batches."""
    from mds_tpu_torch.data.loader import get_data_loader

    if mode == "dsg":
        raise NotImplementedError(DSG_ITEM)
    model = build_eval_bundle(configer, ckpt=ckpt, work_dir=work_dir, device=device)
    if precise_bn > 0:
        recompute_bn_stats(configer, model, precise_bn, compute_dtype=model.dtype)
    return eval_model(configer, model, get_data_loader(configer, "eval"), mode=mode)
