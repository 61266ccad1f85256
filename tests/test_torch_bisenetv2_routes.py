"""BiSeNetV2 on the depthwise and fused-pred routes, port against JAX, at
(1, 64, 128, 3) on the CPU.

The port's `set_depthwise_impl("kernel")` and `set_pred_impl("fused")`
(the kernels' plain versions here) against JAX's
`set_depthwise_impl("pallas")` and `set_pred_impl("fused")` (Pallas in
interpret mode): f32 `pred` labels agree ≥ 0.999 and f32 `eval_logits` on
the depthwise route lie within rel ≤ 1e-4 (the gate of the plain-route test
in tests/test_torch_bisenetv2.py); bf16 through `E2EModel` and JAX's
`make_e2e_fn` with all four deploy routes on (stem kernel, detail fusion,
depthwise kernel, fused pred) meet the bench.py:296-297 gates, argmax
agreement > 0.995 and logits rel < 2e-2. No kernel launches on the CPU."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.deploy.export import make_e2e_fn
from mds_tpu.models import layers as jl
from mds_tpu_torch.deploy.e2e import E2EModel
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import depthwise as tdw
from mds_tpu_torch.ops import stem as tstem
from mds_tpu_torch.ops import upsample_argmax as tua
from torch_parity import (
    ARGMAX_GATE,
    LOGITS_GATE,
    bisenetv2_pair,
    interpret_pallas,
    nchw,
    rel_err,
)

H, W = 64, 128
MEAN = np.asarray([0.3038, 0.3383, 0.3034], np.float32)
STD = np.asarray([0.2071, 0.2088, 0.209], np.float32)
KERNELS = tstem.KERNELS + tdw.KERNELS + tua.KERNELS


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


@contextlib.contextmanager
def routes(stem=False):
    """Both packages' depthwise and fused-pred routes on (and with `stem`
    the stem kernel and detail fusion too); every switch back to its default
    after, and no kernel launched meanwhile."""
    counts = [k.launches for k in KERNELS]
    jl.set_depthwise_impl("pallas")
    jl.set_pred_impl("fused")
    tl.set_depthwise_impl("kernel")
    tl.set_pred_impl("fused")
    if stem:
        jl.set_stem_impl("pallas")
        jl.set_detail_fuse(True)
        tl.set_stem_impl("kernel")
        tl.set_detail_fuse(True)
    try:
        yield
    finally:
        jl.set_depthwise_impl("xla")
        jl.set_pred_impl("xla")
        jl.set_stem_impl("plain")
        jl.set_detail_fuse(False)
        tl.set_depthwise_impl("plain")
        tl.set_pred_impl("plain")
        tl.set_stem_impl("plain")
        tl.set_detail_fuse(False)
    assert [k.launches for k in KERNELS] == counts  # CPU: plain versions


def test_pred_and_logits_f32():
    jm, v, tm = bisenetv2_pair((19,), 1, False, jnp.float32, torch.float32, 5,
                               (H, W))
    x = np.random.default_rng(6).normal(0, 1, (1, H, W, 3)).astype(np.float32)
    with routes():
        want_labels = np.asarray(jax.jit(lambda v, x: jm.apply(
            v, x, method=jm.pred))(v, jnp.asarray(x)))
        want_logits = jax.jit(lambda v, x: jm.apply(
            v, x, method=jm.eval_logits))(v, jnp.asarray(x))
        with torch.no_grad():
            got_labels = tm.pred(nchw(x)).numpy()
            got_logits = tm.eval_logits(nchw(x))
    assert got_labels.dtype == np.int32 and got_labels.shape == (1, H, W)
    assert np.unique(got_labels).size > 1  # a constant map agrees with anything
    assert (got_labels == want_labels).mean() >= 0.999
    assert rel_err(got_logits.permute(0, 2, 3, 1).numpy(), want_logits) <= 1e-4


def test_e2e_all_routes_bf16():
    jm, v, tm = bisenetv2_pair((19,), 1, False, jnp.bfloat16, torch.bfloat16, 7,
                               (H, W))
    frame = np.random.default_rng(3).integers(0, 256, (1, H, W, 3)).astype(np.uint8)
    x = (frame.astype(np.float32) / 255.0 - MEAN) / STD
    e2e = E2EModel(tm, MEAN, STD, device="cpu")
    with routes(stem=True):
        want_labels = np.asarray(jax.jit(make_e2e_fn(jm, v, MEAN, STD))(frame))
        want_logits = np.asarray(jax.jit(lambda v, x: jm.apply(
            v, x, method=jm.eval_logits))(v, jnp.asarray(x)), np.float32)
        got_labels = e2e.infer(frame)
        with torch.no_grad():
            got_logits = tm.eval_logits(nchw(x)).float().permute(0, 2, 3, 1).numpy()
    assert got_labels.dtype == np.int32 and got_labels.shape == (1, H, W)
    assert np.unique(got_labels).size > 1
    assert (got_labels == want_labels).mean() > ARGMAX_GATE
    assert rel_err(got_logits, want_logits) < LOGITS_GATE


def test_pred_route_names():
    with pytest.raises(ValueError):
        tl.set_pred_impl("xla")
    assert tl.get_pred_impl() == "plain"
