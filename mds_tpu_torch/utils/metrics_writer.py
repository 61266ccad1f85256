"""Training-metric sinks: JSONL scalars and, where it imports, TensorBoard —
counterparts of mds_tpu/utils/metrics_writer.py (`MetricsWriter` :20,
`read_metrics` :51), with the same `metrics.jsonl` schema: one object a
line, `{"step": int, "time": float, <scalar>: float, ..., "group": str}`.
"""

from __future__ import annotations

import json
import os
import sys
import time
import types
from typing import Dict


def _summary_writer(logdir: str):
    """A TensorBoard SummaryWriter, or None where tensorboard is not
    installed. TensorFlow, where it is installed, imports JAX, which the
    port never imports: tensorboard's own `notf` switch makes it use its
    TensorFlow stub instead. The switch is in `sys.modules` only while the
    writer is made, and only if no one had set it. tensorboard binds its
    `tf` once per process, when a writer first needs it: a writer made
    later in the same process, by any package, uses the same stub."""
    key = "tensorboard.compat.notf"
    added = key not in sys.modules
    if added:
        sys.modules[key] = types.ModuleType(key)
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logdir)
    except ImportError:
        return None
    finally:
        if added:
            del sys.modules[key]


class MetricsWriter:
    def __init__(self, logdir: str, tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = _summary_writer(logdir) if tensorboard else None

    def write(self, step: int, scalars: Dict[str, float], group: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        if group:
            rec["group"] = group
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{group}/{k}" if group else k, float(v), step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def read_metrics(logdir: str):
    """metrics.jsonl → list of records."""
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]
