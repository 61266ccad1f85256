"""The optimizers — counterparts of mds_tpu/engine/optim.py
(`sgd_param_groups` :63-109, `adamw` :112, `build_optimizer` :121) — and
their state by parameter name, as checkpoints hold it.

SGD runs over the reference's 4 param groups.

Groups (tools/train_amp.py:138-166 of the reference): weight decay on conv
and linear weights (ndim ≥ 2), none on 1-d params (BN affine, biases); lr ×
`lr_mul` for a parameter any of whose name's parts starts with `head`,
`aux2`, `aux3`, `aux4`, `aux5_4`, `classifier` or `projHead` (JAX's
`proj_head`; mds_tpu/engine/optim.py:28-41): BiSeNetV2's heads, the
contrast model's heads and projection, not BiSeNetV1's `conv_out*`. The
update is torch SGD's, v ← m·v + (g + wd·p), p ← p − lr·v, at lr =
schedule(count) × the group's multiplier, count starting at 0. As in
the JAX optimizer, a parameter whose gradient is None or identically zero
was unused this step: its momentum is kept, it gets no weight decay and does
not move. The zero test runs on the device (`torch.where`), with no host
sync per parameter.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

HEAD_PREFIXES = ("head", "aux2", "aux3", "aux4", "aux5_4", "classifier", "projHead")


def is_head(name: str) -> bool:
    """Whether parameter `name` takes the head learning rate."""
    return any(part.startswith(HEAD_PREFIXES) for part in name.split("."))


def param_groups(model: nn.Module, weight_decay: float,
                 lr_mul: float) -> List[Dict]:
    """The 4 groups (empty ones left out), each with `weight_decay`,
    `lr_mul` and a `name`: wd, nowd, head_wd, head_nowd."""
    groups: Dict[str, List[nn.Parameter]] = {
        "wd": [], "nowd": [], "head_wd": [], "head_nowd": []}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        head = is_head(name)
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


class AdamW(torch.optim.Optimizer):
    """optax.adamw (mds_tpu/engine/optim.py:112): per parameter, mu ← b1·mu
    + (1 − b1)·g, nu ← b2·nu + (1 − b2)·g², t = count + 1, update = mu/(1 −
    b1^t) / (sqrt(nu/(1 − b2^t)) + eps) + wd·p, p ← p − schedule(count) ·
    update: eps outside the root, decay decoupled from the moments and on
    every parameter, no per-group multiplier. The bias corrections are
    rounded to f32 as optax computes them. A parameter without a gradient
    takes a zero one, as JAX's gradient of an unused parameter is.
    `update_scale` multiplies each final update, as the flagship's GNN step
    scales its optax updates at a decayed re-entry (1.0: no multiply). A
    param group may carry its own `schedule` and `weight_decay`, as an
    optax.multi_transform of two adamw does (the adversarial GNN's
    discriminators); the step count is shared."""

    def __init__(self, params, schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4):
        super().__init__(params, {"lr": 0.0})
        self.schedule = schedule
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        self.update_scale = 1.0

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW takes no closure")
        t = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        for group in self.param_groups:
            group["lr"] = lr = group.get("schedule", self.schedule)(self.count)
            wd = group.get("weight_decay", self.weight_decay)
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p)
                    state["nu"] = torch.zeros_like(p)
                mu, nu = state["mu"], state["nu"]
                mu.copy_(g * (1 - self.b1) + mu * self.b1)
                nu.copy_(g * g * (1 - self.b2) + nu * self.b2)
                upd = (mu / bc1) / ((nu / bc2).sqrt() + self.eps)
                upd = (upd + p * wd) * lr
                p.sub_(upd if self.update_scale == 1.0 else upd * self.update_scale)
        self.count += 1


def optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> Dict:
    """The optimizer's step count and per-parameter state (momentum
    buffers, or AdamW's moments) keyed by parameter name, on the CPU."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {"count": int(optimizer.count),
            "state": {names[id(p)]: {k: v.detach().cpu().clone() for k, v in s.items()}
                      for p, s in optimizer.state.items()}}


def load_optimizer_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                         state: Dict) -> None:
    """The inverse of `optimizer_state`; raises on a name the model lacks."""
    params = dict(model.named_parameters())
    unknown = set(state["state"]) - set(params)
    if unknown:
        raise KeyError(f"optimizer state for unknown parameters {sorted(unknown)[:5]}")
    optimizer.state.clear()
    for name, s in state["state"].items():
        p = params[name]
        optimizer.state[p] = {k: v.to(device=p.device, dtype=p.dtype) for k, v in s.items()}
    optimizer.count = int(state["count"])


def build_optimizer(configer, model: nn.Module,
                    schedule: Callable[[int], float]) -> torch.optim.Optimizer:
    """From the config's `lr` section: `optim` sgd (the 4 groups) or
    adamw."""
    name = (configer.get("lr", "optim", default="sgd") or "sgd").lower()
    wd = float(configer.get("lr", "weight_decay", default=5e-4))
    if name == "adamw":
        return AdamW([p for p in model.parameters() if p.requires_grad], schedule,
                     weight_decay=wd)
    if name != "sgd":
        raise ValueError(f"unknown optimizer {name}")
    if configer.get("lr", "nesterov", default=False):
        raise ValueError("Nesterov momentum is not in the port")
    return sgd_param_groups(
        model, schedule,
        momentum=float(configer.get("lr", "momentum", default=0.9)),
        weight_decay=wd,
        lr_mul=float(configer.get("lr", "lr_mul", default=10.0)))
