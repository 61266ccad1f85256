"""Progress meters — counterparts of mds_tpu/utils/meters.py (`TimeMeter`
:9, `AvgMeter` :30)."""

from __future__ import annotations

import datetime
import time

import torch


class TimeMeter:
    """Seconds since the last `get` and the ETA of `max_iter` iterations."""

    def __init__(self, max_iter: int):
        self.iter = 0
        self.max_iter = max_iter
        self.st = time.time()
        self.global_st = self.st

    def update(self) -> None:
        self.iter += 1

    def get(self):
        curr = time.time()
        interval = curr - self.st
        global_interval = curr - self.global_st
        eta_sec = (self.max_iter - self.iter) * global_interval / max(self.iter, 1)
        self.st = curr
        return interval, str(datetime.timedelta(seconds=round(eta_sec)))


class AvgMeter:
    """Buffers values — Python numbers or 0-d tensors on any device — and
    resolves them only at `get()`, in one stack and one copy to the host:
    reading a device scalar every step would wait for the device every
    step. The running (global) statistics are Python floats."""

    def __init__(self):
        self.seq = []
        self._gsum = 0.0
        self._gcount = 0

    def update(self, val) -> None:
        self.seq.append(val.detach() if torch.is_tensor(val) else val)

    def _resolve(self):
        vals, self.seq = self.seq, []
        if not vals or not torch.is_tensor(vals[0]):
            return [float(v) for v in vals]
        return torch.stack(vals).double().cpu().tolist()

    def get(self):
        """(mean since the last get, mean over every value)."""
        vals = self._resolve()
        self._gsum += sum(vals)
        self._gcount += len(vals)
        return sum(vals) / max(len(vals), 1), self._gsum / max(self._gcount, 1)
