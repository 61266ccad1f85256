"""The multi-dataset segmentation train step — counterpart of
mds_tpu/engine/train_step.py (`normalize_images` :28, `make_seg_loss_fn`
:51, `make_seg_train_step` :108).

One step: uint8 NHWC images → normalize → the model's train forward (main
head and aux heads, train-mode BN, dropout) → OHEM CE of every head, summed
over heads and datasets (tools/train_amp.py:253-263 of the reference) →
backward → the optimizer's step at lr = schedule(count). Nothing in it waits
for the device: the metrics come back as tensors. The dropout seed words of
each step come from the CPU `torch.Generator` the caller passes in.

With `fused_up_loss` the model runs with up=False, every head stays at its
own resolution, and each head's OHEM CE is taken through the phase
decomposition of its bilinear upsample (`OhemCELoss.upsampled`,
mds_tpu/engine/train_step.py:51-93): the same loss, without the full-size
class volumes in the compute dtype.

Under a process group (parallel/mesh.py) each rank steps on its rows of
the global batch (mds_tpu/engine/train_step.py:108-180). SyncBN, the
default: the train norms and the OHEM pool reduce over the ranks, each
rank's loss is its share of the global loss, the gradients are summed and
the metrics summed: the step of one process on the whole batch. `local_bn`
(the reference's per-GPU BN, `use_sync_bn: false`): each rank normalizes
with its own moments and runs its own OHEM; the gradients, the BN running
stats after each rank's own update, and the metrics are averaged, as JAX's
shard_mapped `local_bn` step pmeans them. Without a group the step is the
one process's.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mds_tpu_torch.losses.ohem_ce import OhemCELoss
from mds_tpu_torch.parallel import mesh

Images = Sequence[Optional[torch.Tensor]]


def normalize_images(ims: Images, means: Sequence, stds: Sequence,
                     dtype: torch.dtype = torch.float32) -> List[Optional[torch.Tensor]]:
    """uint8 (B, H, W, 3) per dataset → ÷255 → (x − mean)/std in f32 →
    `dtype`, as NCHW views of the NHWC memory (channels_last)."""
    out: List[Optional[torch.Tensor]] = []
    for x, m, s in zip(ims, means, stds):
        if x is None:
            out.append(None)
            continue
        m = torch.as_tensor(np.asarray(m, np.float32), device=x.device)
        s = torch.as_tensor(np.asarray(s, np.float32), device=x.device)
        xf = (x.float() / 255.0 - m) / s
        out.append(xf.to(dtype).permute(0, 3, 1, 2))
    return out


def make_seg_loss_fn(model: nn.Module, means: Sequence, stds: Sequence,
                     ohem_thresh: float = 0.7,
                     compute_dtype: torch.dtype = torch.bfloat16,
                     fused_up_loss: bool = False) -> Callable:
    """loss_fn(ims, lbs, generator) -> (loss, metrics): the model's forward
    in its current mode and, per present dataset, OHEM CE of the main
    logits plus that of each aux head's."""
    criterion = OhemCELoss(ohem_thresh)

    def loss_fn(ims: Images, lbs: Images,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        xs = normalize_images(ims, means, stds, compute_dtype)
        out = model(xs, up=not fused_up_loss, generator=generator)
        main_f, aux_fs = out.get("up_factors", (1, [1] * len(out.get("aux", []))))
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        for i, (logits, lb) in enumerate(zip(out["logits"], lbs)):
            if logits is None:
                continue
            lb = lb.long()
            l_main = criterion.upsampled(logits, lb, main_f)
            l_aux = sum(criterion.upsampled(aux[i], lb, f)
                        for f, aux in zip(aux_fs, out.get("aux", []))
                        if aux[i] is not None)
            total = total + l_main + l_aux
            metrics[f"loss_pre_{i}"] = l_main.detach()
        metrics["loss"] = total.detach()
        return total, metrics

    return loss_fn


def make_seg_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                        means: Sequence, stds: Sequence,
                        ohem_thresh: float = 0.7,
                        compute_dtype: torch.dtype = torch.bfloat16,
                        fused_up_loss: bool = False,
                        local_bn: bool = False) -> Callable:
    """step(ims, lbs, generator) -> metrics. `optimizer` takes its learning
    rate from its own schedule and step count (engine/optim.py). Under a
    process group `ims` and `lbs` are this rank's rows and `local_bn`
    selects the BN mode (module docstring)."""
    loss_fn = make_seg_loss_fn(model, means, stds, ohem_thresh, compute_dtype,
                               fused_up_loss)

    def step(ims: Images, lbs: Images,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        model.train()
        with mesh.data_parallel(sync_bn=not local_bn):
            loss, metrics = loss_fn(ims, lbs, generator)
            loss.backward()
        if mesh.initialized():
            mesh.all_reduce_grads(model.parameters(), mean=local_bn)
            if local_bn:
                mesh.average_buffers([b for n, b in model.named_buffers()
                                      if "running" in n])
            metrics = mesh.reduce_metrics(metrics, mean=local_bn)
        optimizer.step()
        return metrics

    return step
