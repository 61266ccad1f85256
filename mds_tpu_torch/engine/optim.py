"""SGD over the reference's 4 param groups — counterpart of
mds_tpu/engine/optim.py (`sgd_param_groups` :63-109, `build_optimizer` :122).

Groups (tools/train_amp.py:138-166 of the reference): weight decay on conv
and linear weights (ndim ≥ 2), none on 1-d params (BN affine, biases); lr ×
`lr_mul` for everything under a head (`head.`, `aux2.`, `aux3.`, `aux4.`,
`aux5_4.`). The update is torch SGD's, v ← m·v + (g + wd·p), p ← p − lr·v,
at lr = schedule(count) × the group's multiplier, count starting at 0. As in
the JAX optimizer, a parameter whose gradient is None or identically zero
was unused this step: its momentum is kept, it gets no weight decay and does
not move. The zero test runs on the device (`torch.where`), with no host
sync per parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

HEAD_PREFIXES = ("head", "aux2", "aux3", "aux4", "aux5_4")


def param_groups(model: nn.Module, weight_decay: float,
                 lr_mul: float) -> List[Dict]:
    """The 4 groups (empty ones left out), each with `weight_decay`,
    `lr_mul` and a `name`: wd, nowd, head_wd, head_nowd."""
    groups: Dict[str, List[nn.Parameter]] = {
        "wd": [], "nowd": [], "head_wd": [], "head_nowd": []}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        head = name.split(".")[0] in HEAD_PREFIXES
        decay = p.ndim >= 2
        groups[("head_" if head else "") + ("wd" if decay else "nowd")].append(p)
    return [{"name": k, "params": ps,
             "weight_decay": weight_decay if k in ("wd", "head_wd") else 0.0,
             "lr_mul": lr_mul if k.startswith("head") else 1.0}
            for k, ps in groups.items() if ps]


class GroupSGD(torch.optim.Optimizer):
    """SGD with momentum over param groups that carry `weight_decay` and
    `lr_mul`; the learning rate comes from `schedule(self.count)`."""

    def __init__(self, groups: List[Dict], schedule: Callable[[int], float],
                 momentum: float = 0.9):
        super().__init__(groups, {"lr": 0.0, "weight_decay": 0.0, "lr_mul": 1.0})
        self.schedule = schedule
        self.momentum = momentum
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("GroupSGD takes no closure")
        lr = self.schedule(self.count)
        m = self.momentum
        for group in self.param_groups:
            group["lr"] = group_lr = lr * group["lr_mul"]
            wd = group["weight_decay"]
            for p in group["params"]:
                g = p.grad
                if g is None:
                    continue
                used = g.ne(0).any()
                d = g.add(p, alpha=wd) if wd else g
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                v = state["momentum_buffer"]
                v.copy_(torch.where(used, v * m + d, v))
                p.sub_(torch.where(used, v * group_lr, 0.0))
        self.count += 1


def sgd_param_groups(model: nn.Module, schedule: Callable[[int], float],
                     momentum: float = 0.9, weight_decay: float = 5e-4,
                     lr_mul: float = 10.0) -> GroupSGD:
    """The JAX package's `sgd_param_groups` for `model`'s parameters (its
    default, plain momentum: no config asks for Nesterov's)."""
    return GroupSGD(param_groups(model, weight_decay, lr_mul), schedule,
                    momentum=momentum)


def build_optimizer(configer, model: nn.Module,
                    schedule: Callable[[int], float]) -> GroupSGD:
    """From the config's `lr` section; SGD only (AdamW comes with the GNN
    trainer)."""
    name = (configer.get("lr", "optim", default="sgd") or "sgd").lower()
    if name != "sgd":
        raise ValueError(f"optimizer {name!r} is not in the port yet")
    if configer.get("lr", "nesterov", default=False):
        raise ValueError("Nesterov momentum is not in the port")
    return sgd_param_groups(
        model, schedule,
        momentum=float(configer.get("lr", "momentum", default=0.9)),
        weight_decay=float(configer.get("lr", "weight_decay", default=5e-4)),
        lr_mul=float(configer.get("lr", "lr_mul", default=10.0)))
