"""File and stream logger, and the iteration log line — counterparts of
mds_tpu/utils/logger.py (`setup_logger` :18, `print_log_msg` :44).

The logger logs at INFO unless the caller gives a level; under a process
group the trainer gives ranks other than 0 no log file
(engine/trainer.py). The iteration line has the
JAX package's format, which log scrapers read:
`iter: 6/6, lr: 0.004987, eta: 0:00:00, time: 0.41, loss: 3.1234`.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, Optional


def setup_logger(name: str, logpth: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    """A logger writing to stderr and, with `logpth`, to
    `<logpth>/<name>-<time>.log`."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logpth:
        os.makedirs(logpth, exist_ok=True)
        logfile = os.path.join(
            logpth, "{}-{}.log".format(name, time.strftime("%Y-%m-%d-%H-%M-%S")))
        fh = logging.FileHandler(logfile)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger


def print_log_msg(logger: logging.Logger, it: int, max_iter: int, lr: float,
                  time_meter, loss_meters: Dict[str, "AvgMeter"]) -> None:  # noqa: F821
    """The fixed-format iteration line (mds_tpu/utils/logger.py:44)."""
    t_intv, eta = time_meter.get()
    loss_txt = ", ".join(
        "{}: {:.4f}".format(k, v.get()[0]) for k, v in loss_meters.items())
    logger.info("iter: {it}/{mx}, lr: {lr:.6f}, eta: {eta}, time: {t:.2f}, {loss}".format(
        it=it + 1, mx=max_iter, lr=lr, eta=eta, t=t_intv, loss=loss_txt))
