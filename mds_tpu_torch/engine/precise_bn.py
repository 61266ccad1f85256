"""Precise BN: recompute the BN running statistics from data.

Counterpart of mds_tpu/engine/precise_bn.py (`update_bn_stats` :20): the
running stats become the mean of the true per-batch moments over N train
batches, in place of the EMA that training left.

Each batch runs one train-mode forward under no_grad from the same
original running stats, as JAX applies every batch to the unchanged
variables. The port's train BN moves its buffers in place (momentum 0.1,
the variance's unbiased), so the stats are snapshotted first, each batch's
moments are recovered from the update as JAX does, (new − 0.9·old)/0.1,
and the snapshot is put back before the next batch. At the end the
buffers take the mean of the recovered moments, written in place (`copy_`,
so every route's folds and packs rebuild: `models/layers.py PackCache`),
and the model is left in eval mode.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn


def update_bn_stats(model: nn.Module, batches: Iterable, forward: Callable) -> nn.Module:
    """forward(model, batch) runs one train-mode forward of `model` on a
    batch; the BN running means and variances of `model` become the mean
    of the moments of every batch of `batches`. With no batch the stats
    stay as they were."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    bufs = [t for bn in bns for t in (bn.running_mean, bn.running_var)]
    old = [t.detach().clone() for t in bufs]
    acc = [torch.zeros_like(t) for t in bufs]
    count = 0
    model.train()
    try:
        with torch.no_grad():
            for batch in batches:
                forward(model, batch)
                for t, o, a in zip(bufs, old, acc):
                    # new = 0.9·old + 0.1·batch  →  batch = (new − 0.9·old)/0.1
                    a += (t - 0.9 * o) / 0.1
                    t.copy_(o)
                count += 1
            if count:
                for t, a in zip(bufs, acc):
                    t.copy_(a / count)
    except BaseException:
        with torch.no_grad():
            for t, o in zip(bufs, old):
                t.copy_(o)
        raise
    finally:
        model.eval()
    return model
