"""Profiling hooks — counterpart of mds_tpu/utils/profiling.py (`trace`
:24, `StepTimer` :32).

- `trace(logdir)`: torch.profiler around the block (the CPU, and the card
  when there is one), its Chrome trace written into `logdir` as
  `trace_<pid>_<n>.json` (open it in Perfetto or chrome://tracing).
- `StepTimer`: wall-clock seconds per step, synchronized on the CUDA
  device of the step's result (nothing to wait for on the CPU).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Optional

import torch

_TRACES = itertools.count()


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{next(_TRACES)}.json"))


def _sync(result) -> None:
    """Wait for the CUDA devices of the tensors in `result` (a tensor, or a
    list, tuple or dict of them)."""
    if torch.is_tensor(result):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _sync(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _sync(v)


class StepTimer:
    def __init__(self):
        self._t0: Optional[float] = None
        self._n = 0
        self.total = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Wait for `result`'s device and return the seconds since start."""
        if result is not None:
            _sync(result)
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        self._n += 1
        self.total += dt
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self._n, 1)
