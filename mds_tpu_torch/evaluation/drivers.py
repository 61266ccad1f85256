"""The evaluation drivers the eval CLI runs — counterpart of
mds_tpu/evaluation/drivers.py (`build_eval_bundle` :29,
`recompute_bn_stats` :89, `run_evaluation` :131) and of its label-usage
audit (`_unified_hist` :169, `_slot_buckets` :205, `find_unuse_label`
:223, `eval_find_use_and_unuse_label` :247, `find_label_relation` :280).

The model comes from the trainer's `build_model` and its weights from the
latest checkpoint the port's `Trainer` wrote (`<ckpt>/<step>.pt`), so any
checkpoint the train CLI writes is evaluable; BiSeNetV1 checkpoints load
too. The flagship (snp_rn18, or `train.mode` alternate, seg, gnn or clip) comes
from the alternating trainer and its checkpoint (`<ckpt>`, else
`<work_dir>/ckpt_gnn`): the seg state with its bipartite graphs. The
contrast family (`train.mode` contrast) comes from the contrast trainer
and its checkpoint (`<ckpt>`, else `<work_dir>/ckpt_contrast`), with the
memory bank's class means as the `emb` mode's prototypes. The eval mode
dsg scores the stage-2 train lists (`get_data_loader(..., stage=2)`) under
the contrast protocol.

The audit asks which unified slots each dataset's classes use: the
(n_cats, M) counts of label class × the argmax of the unified logits
(`uni_eval_logits`, align-corners resized to the label), accumulated on
the model's device and read back once a dataset.

Under a process group (parallel/mesh.py) every loader here reads this
rank's share (mds_tpu/evaluation/drivers.py:101-103, 149-152): the eval
hist and the audit's counts are summed over the ranks (JAX's audit keeps
each process's own counts); precise BN reads this rank's train shard and,
as in JAX, is not averaged over the ranks.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mds_tpu_torch.evaluation.evaluator import (
    _psum_hist,
    _to_device,
    confusion_hist,
    eval_model,
    make_logits_fn,
)
from mds_tpu_torch.models.layers import resize_bilinear_ac
from mds_tpu_torch.parallel import mesh


def is_alternating(configer) -> bool:
    """Whether the config trains through the alternating trainer."""
    from mds_tpu_torch.engine.gnn_trainer import MODES

    return (configer.get("train", "mode", default=None) in MODES
            or configer.get("model_name", default=None) in ("snp_rn18", "snp_rn18_mulbn"))


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

    loader = get_data_loader(configer, "train", rank=mesh.rank(), world=mesh.world())
    try:
        return update_bn_stats(model, batches(), forward)
    finally:
        loader.close()


def run_evaluation(configer, mode: str = "ss", ckpt: Optional[str] = None,
                   work_dir: str = "./res", precise_bn: int = 0,
                   device="cuda") -> List[float]:
    """Config → per-dataset mIoU for an eval mode (the eval CLI's body).
    precise_bn > 0 first recomputes the BN running stats over that many
    train batches. dsg scores the stage-2 train lists."""
    from mds_tpu_torch.data.loader import get_data_loader

    model = build_eval_bundle(configer, ckpt=ckpt, work_dir=work_dir, device=device)
    if precise_bn > 0:
        recompute_bn_stats(configer, model, precise_bn, compute_dtype=model.dtype)
    loaders = get_data_loader(configer, "eval", rank=mesh.rank(), world=mesh.world(),
                              stage=2 if mode == "dsg" else None)
    return eval_model(configer, model, loaders, mode=mode)


# ---------------------------------------------------------------------------
# the label-usage audit: which unified slots does each dataset class use?
# ---------------------------------------------------------------------------

@torch.inference_mode()
def _unified_hist(model, loader, n_cats: int, M: int, dataset_id: int, mean, std,
                  ignore: int = 255) -> np.ndarray:
    """(n_cats, M) int64 counts of label class × argmax unified slot over
    the loader's batches (mds_tpu/evaluation/drivers.py:169)."""
    device = next(model.parameters()).device
    logits_fn = make_logits_fn(model, mean, std, method="uni_eval_logits")
    hist = torch.zeros((n_cats, M), dtype=torch.int64, device=device)
    for batch in loader:
        im, lb = _to_device(batch, device)
        logits = resize_bilinear_ac(logits_fn(im, dataset_id), tuple(lb.shape[-2:]))
        hist += confusion_hist(lb, logits.argmax(dim=1), n_cats, ignore, n_pred=M)
    return _psum_hist(hist.cpu().numpy())


def _slot_buckets(bi_graph) -> Dict[int, List[int]]:
    """Unified slot → the class owning it by the graph's column argmax; a
    column of zeros belongs to none; every class has a bucket."""
    bi_graph = np.asarray(bi_graph)
    max_value, max_index = bi_graph.max(axis=0), bi_graph.argmax(axis=0)
    buckets: Dict[int, List[int]] = {}
    for slot, cls in enumerate(max_index):
        if max_value[slot] != 0:
            buckets.setdefault(int(cls), []).append(slot)
    for cls in range(bi_graph.shape[0]):
        buckets.setdefault(cls, [])
    return buckets


def _graph(model, dataset_id: int) -> np.ndarray:
    return model.bipartite_graphs[dataset_id].detach().float().cpu().numpy()


def find_unuse_label(configer, model, loader, n_classes: int, dataset_id: int,
                     mean=None, std=None) -> Dict[int, List[int]]:
    """Per class of dataset `dataset_id`, the unified slots it owns in the
    model's graph and uses: more than a tenth of its predictions over its
    owned slots (all of them when it predicts none)."""
    bi_graph = _graph(model, dataset_id)
    mean = np.zeros(3, np.float32) if mean is None else mean
    std = np.ones(3, np.float32) if std is None else std
    hist = _unified_hist(model, loader, n_classes, bi_graph.shape[1], dataset_id,
                         mean, std)
    out: Dict[int, List[int]] = {}
    for cls, slots in _slot_buckets(bi_graph).items():
        total = sum(int(hist[cls][s]) for s in slots)
        out[cls] = list(slots) if total == 0 else [
            s for s in slots if hist[cls][s] / total > 0.1]
    return out


def eval_find_use_and_unuse_label(configer, model, loaders, means=None, stds=None):
    """The use/unuse audit over every dataset → (["single_scale"], [],
    target_bipart): target_bipart[i] (n_cats_i, M) f32 holds
    loss.ignore_index, 0 at an owned slot that a class or the slot's column
    barely uses (a share < 0.1), 1 at one it mostly uses (> 0.5)."""
    ignore_index = int(configer.get("loss", "ignore_index", default=255))
    target_bipart: List[np.ndarray] = []
    for i in range(configer.n_datasets):
        bi_graph = _graph(model, i)
        mean = means[i] if means is not None else np.zeros(3, np.float32)
        std = stds[i] if stds is not None else np.ones(3, np.float32)
        hist = _unified_hist(model, loaders[i], configer.n_cats(i), bi_graph.shape[1],
                             i, mean, std)
        bipart = np.full(bi_graph.shape, float(ignore_index), np.float32)
        col_sums = hist.sum(axis=0)
        for cls, slots in _slot_buckets(bi_graph).items():
            total = sum(int(hist[cls][s]) for s in slots)
            if total == 0:
                continue
            for s in slots:
                rate = hist[cls][s] / total
                col_share = hist[cls][s] / col_sums[s] if col_sums[s] else 0.0
                if rate < 0.1 or col_share < 0.1:
                    bipart[cls][s] = 0.0
                elif rate > 0.5:
                    bipart[cls][s] = 1.0
        target_bipart.append(bipart)
    return ["single_scale"], [], target_bipart


def find_label_relation(configer, datasets_remaps) -> List[np.ndarray]:
    """For each dataset pair (i < j), a bool (|map_ij| + |map_ji|)² matrix
    linking each of i's classes to the j class `datasets_remaps[i][j]`
    points at, and each of j's to its i class."""
    n = configer.n_datasets
    out: List[np.ndarray] = []
    for i in range(n):
        for j in range(i + 1, n):
            this_map, other_map = datasets_remaps[i][j], datasets_remaps[j][i]
            size = len(this_map) + len(other_map)
            rel = np.zeros((size, size), bool)
            for idx, val in enumerate(this_map):
                rel[idx][len(this_map) + int(val)] = True
            for idx, val in enumerate(other_map):
                rel[len(this_map) + idx][int(val)] = True
            out.append(rel)
    return out
