"""Checkpoints of a training run — counterpart of
mds_tpu/engine/checkpoints.py (`CheckpointManager` :25), with `torch.save`
in place of orbax and the same API and rules.

A checkpoint is one file, `<directory>/<step>.pt`, written under a
temporary name and moved into place with `os.replace`, so a file with a
step's name is always whole. It holds one payload dict: "state", the train
state (`train_state`: the model's state_dict with its BN statistics, the
optimizer's state by parameter name with its step count, and the step),
and "extras" when there are any. It is read with `torch.load(...,
weights_only=True)`: tensors, numbers, strings and containers only.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from mds_tpu_torch.engine.optim import load_optimizer_state, optimizer_state
from mds_tpu_torch.parallel import mesh

_NAME = re.compile(r"^(\d+)\.pt$")


def train_state(model: nn.Module, optimizer: torch.optim.Optimizer, step: int) -> Dict:
    """The checkpoint payload's "state", on the CPU."""
    return {"model": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
            "optimizer": optimizer_state(model, optimizer), "step": int(step)}


def load_train_state(model: nn.Module, optimizer: Optional[torch.optim.Optimizer],
                     state: Dict) -> int:
    """Load a `train_state` into `model` (strictly) and, unless None,
    `optimizer`; returns its step."""
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None:
        load_optimizer_state(model, optimizer, state["optimizer"])
    return int(state["step"])


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, save_interval: int = 1000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def due(self, step: int, force: bool = False) -> bool:
        """Whether step `step` is a save point: a positive multiple of
        `save_interval`, or `force`. It reads no file, so every rank of a
        group decides alike."""
        return force or (step > 0 and step % self.save_interval == 0)

    def should_save(self, step: int, force: bool = False) -> bool:
        """Whether `maybe_save` would write checkpoint id `step`: `due`, and
        no checkpoint has that id yet."""
        return self.due(step, force) and step not in self.all_steps()

    def maybe_save(self, state: Dict, extras: Optional[Dict] = None,
                   force: bool = False, step: Optional[int] = None) -> bool:
        """Save `state` (a `train_state`) at its step, or at `step` where
        given, when `should_save` says so. Keeps the newest `max_to_keep`."""
        step = int(state["step"]) if step is None else int(step)
        if not self.should_save(step, force):
            return False
        payload = {"state": state}
        if extras:
            payload["extras"] = extras
        tmp = os.path.join(self.directory, f".{step}.pt.{os.getpid()}.tmp")
        try:
            torch.save(payload, tmp)
            os.replace(tmp, self.path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return True

    def wait(self) -> None:
        """Saves are synchronous: every saved file is whole on return."""

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Tuple[Dict, Optional[Dict]]:
        """(state, extras) of checkpoint `step`, the latest by default, on
        the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        payload = torch.load(self.path(step), map_location="cpu", weights_only=True)
        return payload["state"], payload.get("extras")


def read_latest(directory: str) -> Optional[Tuple[Dict, Optional[Dict]]]:
    """(state, extras) of the latest checkpoint in `directory`, or None
    where there is none. Under a process group rank 0 reads it and
    broadcasts it (parallel/mesh.py `broadcast_state`): every rank gets rank
    0's answer, whatever its own directory holds."""
    got = None
    if mesh.rank() == 0 and os.path.isdir(directory):
        manager = CheckpointManager(directory)
        if manager.latest_step() is not None:
            got = manager.restore()
    return mesh.broadcast_state(got)
