"""The evaluation slice's multi-scale modes: `eval_model` of the port
against the JAX package's in msf (eval.eval_scales [0.5, 1.0], with flips)
and mscf (those scales, eval.eval_crop [32, 32], 2/3-stride windows, with
flips), on BiSeNetV2 from configs/test_synthetic.json at f32 with the same
weights in both packages. The gates and the helpers are
tests/test_torch_eval_drivers.py's (tests/torch_eval_parity.py): each
dataset's mIoU within 2e-3, each batch's predictions agreeing on >= 99.9%
of pixels (measured: every pixel)."""

import pytest

from torch_eval_parity import (  # noqa: F401 — one_torch_thread: autouse
    N_CLASSES,
    WEIGHT_SEED,
    check_against_jax,
    make_variables,
    one_torch_thread,
)


@pytest.fixture(scope="module")
def weights():
    return make_variables(N_CLASSES, 2, WEIGHT_SEED)


@pytest.mark.parametrize("mode", ["msf", "mscf"])
def test_eval_model_matches_jax(weights, mode):
    check_against_jax(weights, mode)
