"""chip_smoke.py's EMA check of the contrast phase, on the CPU.

The card-against-CPU contrast step gates each side's EMA residual: per
param group, max |teacher − (m·teacher_before + (1 − m)·student)| over the
group's largest teacher magnitude, at m = chip_smoke.CARD_VS_CPU_EMA. Here
the same step runs on the CPU (configs/bisenetv2_contrast_3ds.json at full
width, 4 crops of 64×128 a dataset) with the EMA as written, which must
pass EMA_RESIDUAL_GATE, and with EMAs the gate must refuse: none at all,
the parameters' left out, and a momentum a tenth off.
"""

import tempfile

import pytest
import torch

import chip_smoke
from mds_tpu_torch.engine import contrast_trainer
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread

REAL = contrast_trainer.ema_update


def _ema(weight, params_only=False):
    """The EMA with the student's weight scaled by `weight`, on every
    float tensor or on the parameters alone."""
    def update(teacher, student, momentum):
        names = {k for k, _ in teacher.named_parameters()}
        s = student.state_dict()
        with torch.no_grad():
            for k, t in teacher.state_dict().items():
                if t.is_floating_point():
                    m = momentum if params_only and k not in names else (
                        1 - (1 - momentum) * weight)
                    t.mul_(m).add_(s[k].to(t.dtype), alpha=1 - m)
    return update


@pytest.fixture(scope="module")
def batch():
    return chip_smoke.contrast_parity_batch()


@pytest.mark.parametrize("name,ema,passes", [
    ("as written", REAL, True),
    ("skipped", lambda t, s, m: None, False),
    ("parameters left out", _ema(0.0, params_only=True), False),
    ("momentum a tenth off", _ema(0.9), False),
])
def test_ema_residual_gate(batch, monkeypatch, name, ema, passes):
    monkeypatch.setattr(contrast_trainer, "ema_update", ema)
    with tempfile.TemporaryDirectory() as work:
        rec = chip_smoke.contrast_step_record("cpu", batch, work)
    worst = max(rec["ema_residual"].values())
    assert (worst < chip_smoke.EMA_RESIDUAL_GATE) == passes, (name, rec["ema_residual"])
    if passes:
        assert worst < 2e-7  # one or two f32 roundings of the teacher
