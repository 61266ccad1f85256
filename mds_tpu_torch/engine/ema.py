"""The EMA teacher's update — counterpart of mds_tpu/engine/ema.py
(`ema_update` :14): teacher ← m·teacher + (1 − m)·student over the
parameters and the BN running statistics, in place.

BatchNorm2d's `num_batches_tracked`, which JAX's variables lack, is left
as it is.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(teacher: nn.Module, student: nn.Module, momentum: float = 0.999) -> None:
    """Move `teacher`'s floating-point state (parameters and buffers) toward
    `student`'s, which has the same names."""
    s = student.state_dict()
    ts, ss = [], []
    for k, t in teacher.state_dict().items():
        if t.is_floating_point():
            ts.append(t)
            ss.append(s[k].to(t.dtype))
    torch._foreach_mul_(ts, momentum)
    torch._foreach_add_(ts, torch._foreach_mul(ss, 1.0 - momentum))
