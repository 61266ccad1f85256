"""LR schedules as plain functions of the step — counterparts of
mds_tpu/engine/lr_schedule.py (the reference's lib/lr_scheduler.py
WarmupPoly/Exp/Cosine/Step). Each function below returns `schedule(step) ->
lr`, a Python float, so the train step sets it on the optimizer without touching
the device."""

from __future__ import annotations

import math
from typing import Callable, Sequence


def _warmup_ratio(step: float, warmup_iter: int, warmup_ratio: float,
                  warmup: str) -> float:
    alpha = step / max(warmup_iter, 1)
    if warmup == "linear":
        return warmup_ratio + (1.0 - warmup_ratio) * alpha
    if warmup == "exp":
        return warmup_ratio ** (1.0 - alpha)
    raise ValueError(f"unknown warmup mode {warmup}")


def _warmup(main: Callable[[float], float], lr_start: float, warmup_iter: int,
            warmup_ratio: float, warmup: str) -> Callable[[int], float]:
    _warmup_ratio(0.0, warmup_iter, warmup_ratio, warmup)  # check the mode

    def schedule(step: int) -> float:
        step = float(step)
        if step < warmup_iter:
            return lr_start * _warmup_ratio(step, warmup_iter, warmup_ratio, warmup)
        return lr_start * main(step - warmup_iter)

    return schedule


def warmup_poly_lr(lr_start: float, power: float, max_iter: int,
                   warmup_iter: int = 500, warmup_ratio: float = 5e-4,
                   warmup: str = "exp") -> Callable[[int], float]:
    """mds_tpu/engine/lr_schedule.py:26 — (1 − t/T)^power after warmup."""
    real_max = max(max_iter - warmup_iter, 1)
    return _warmup(lambda t: max(1.0 - t / real_max, 0.0) ** power,
                   lr_start, warmup_iter, warmup_ratio, warmup)


def warmup_exp_lr(lr_start: float, gamma: float, interval: int = 1,
                  warmup_iter: int = 500, warmup_ratio: float = 5e-4,
                  warmup: str = "exp") -> Callable[[int], float]:
    """mds_tpu/engine/lr_schedule.py:49 — gamma^floor(t/interval)."""
    return _warmup(lambda t: gamma ** math.floor(t / interval),
                   lr_start, warmup_iter, warmup_ratio, warmup)


def warmup_cosine_lr(lr_start: float, max_iter: int, eta_ratio: float = 0.0,
                     warmup_iter: int = 500, warmup_ratio: float = 5e-4,
                     warmup: str = "exp") -> Callable[[int], float]:
    """mds_tpu/engine/lr_schedule.py:70 — half-cosine down to eta_ratio."""
    real_max = max(max_iter - warmup_iter, 1)
    return _warmup(
        lambda t: eta_ratio + (1.0 - eta_ratio) * 0.5 * (1.0 + math.cos(math.pi * t / real_max)),
        lr_start, warmup_iter, warmup_ratio, warmup)


def warmup_step_lr(lr_start: float, milestones: Sequence[int], gamma: float = 0.1,
                   warmup_iter: int = 500, warmup_ratio: float = 5e-4,
                   warmup: str = "exp") -> Callable[[int], float]:
    """mds_tpu/engine/lr_schedule.py:94 — ×gamma at each milestone passed."""
    ms = sorted(milestones)
    return _warmup(lambda t: gamma ** sum(1 for m in ms if m <= t),
                   lr_start, warmup_iter, warmup_ratio, warmup)
