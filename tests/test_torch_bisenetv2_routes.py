"""BiSeNetV2 on the deploy routes, port against JAX, at (1, 64, 128, 3) on
the CPU.

The port's `set_depthwise_impl("kernel")` and `set_pred_impl("fused")`
(the kernels' plain versions here) against JAX's
`set_depthwise_impl("pallas")` and `set_pred_impl("fused")` (Pallas in
interpret mode): f32 `pred` labels agree ≥ 0.999 and f32 `eval_logits` on
the depthwise route lie within rel ≤ 1e-4 (the gate of the plain-route test
in tests/test_torch_bisenetv2.py); bf16 through `E2EModel` and JAX's
`make_e2e_fn` with all four deploy routes on (stem kernel, detail fusion,
depthwise kernel, fused pred) meet the bench.py:296-297 gates, argmax
agreement > 0.995 and logits rel < 2e-2. The same gates hold with the
detail tail on too (`set_detail_tail(True)`, tools/serve_torch.py's route),
in f32 and in bf16, and on the segment.py route (stem kernel without the
detail fusion) with the conv3 kernel and the window stem (JAX:
`set_conv3_eval_impl("pallas")`, `set_stem_variant("dma")`; at H = 64 the
port's conv3 route stays off, H < 512, while JAX's CPU fallback folds the BN
of every C_in <= 64 3×3 conv, so the two differ in rounding only). None of
the routes adds a parameter: JAX's variables with every route on convert to
the same state dict as with none. No kernel launches on the CPU."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.deploy.export import make_e2e_fn
from mds_tpu.models import bisenetv2 as jb
from mds_tpu.models import layers as jl
from mds_tpu.ops.pallas import stem as jstem
from mds_tpu_torch import MODELS
from mds_tpu_torch.deploy.e2e import E2EModel
from mds_tpu_torch.deploy.weights import (
    bisenetv2_state_dict_from_jax,
    load_reference_weights,
)
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import conv3x3 as tc3
from mds_tpu_torch.ops import depthwise as tdw
from mds_tpu_torch.ops import stem as tstem
from mds_tpu_torch.ops import upsample_argmax as tua
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
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
KERNELS = tstem.KERNELS + tdw.KERNELS + tua.KERNELS + tc3.KERNELS


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


@contextlib.contextmanager
def routes(stem=False, fuse=None, tail=False, conv3=False, dma=False):
    """Both packages' depthwise and fused-pred routes on, and with `stem`
    the stem kernel, with `fuse` (default: `stem`) the detail fusion, with
    `tail` the detail tail, with `conv3` the conv3 kernel, with `dma` the
    window stem; every switch back to its default after, and no kernel
    launched meanwhile."""
    fuse = stem if fuse is None else fuse
    counts = [k.launches for k in KERNELS]
    jl.set_depthwise_impl("pallas")
    jl.set_pred_impl("fused")
    tl.set_depthwise_impl("kernel")
    tl.set_pred_impl("fused")
    if stem:
        jl.set_stem_impl("pallas")
        tl.set_stem_impl("kernel")
    jl.set_detail_fuse(fuse)
    tl.set_detail_fuse(fuse)
    jl.set_detail_tail(tail)
    tl.set_detail_tail(tail)
    if conv3:
        jl.set_conv3_eval_impl("pallas")
        tl.set_conv3_eval_impl("kernel")
    if dma:
        jstem.set_stem_variant("dma")
        tstem.set_stem_variant("dma")
    try:
        yield
    finally:
        jl.set_depthwise_impl("xla")
        jl.set_pred_impl("xla")
        jl.set_stem_impl("plain")
        jl.set_detail_fuse(False)
        jl.set_detail_tail(False)
        jl.set_conv3_eval_impl("xla")
        jstem.set_stem_variant("tiles")
        tl.set_depthwise_impl("plain")
        tl.set_pred_impl("plain")
        tl.set_stem_impl("plain")
        tl.set_detail_fuse(False)
        tl.set_detail_tail(False)
        tl.set_conv3_eval_impl("plain")
        tstem.set_stem_variant("tiles")
    assert [k.launches for k in KERNELS] == counts  # CPU: plain versions


def _pred_and_logits_f32(**route_kw):
    jm, v, tm = bisenetv2_pair((19,), 1, False, jnp.float32, torch.float32, 5,
                               (H, W))
    x = np.random.default_rng(6).normal(0, 1, (1, H, W, 3)).astype(np.float32)
    with routes(**route_kw):
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


def test_pred_and_logits_f32():
    _pred_and_logits_f32()


def test_pred_and_logits_f32_every_route():
    """The fused stem, detail and tail routes run in bf16 only in both
    packages; in f32 the stem and conv3 routes fold the BN (both packages)."""
    _pred_and_logits_f32(stem=True, tail=True, conv3=True, dma=True)


def _e2e_bf16(**route_kw):
    jm, v, tm = bisenetv2_pair((19,), 1, False, jnp.bfloat16, torch.bfloat16, 7,
                               (H, W))
    frame = np.random.default_rng(3).integers(0, 256, (1, H, W, 3)).astype(np.uint8)
    x = (frame.astype(np.float32) / 255.0 - MEAN) / STD
    e2e = E2EModel(tm, MEAN, STD, device="cpu")
    with routes(**route_kw):
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


def test_e2e_all_routes_bf16():
    _e2e_bf16(stem=True)


def test_e2e_all_routes_with_tail_bf16():
    """tools/serve_torch.py's route: every deploy kernel, the tail too."""
    _e2e_bf16(stem=True, tail=True)


def test_e2e_segment_route_conv3_window_stem_bf16():
    _e2e_bf16(stem=True, fuse=False, conv3=True, dma=True)


def test_routes_add_no_parameters():
    x = [jnp.zeros((1, H, W, 3), jnp.bfloat16)]

    def state_dict():
        jm = jb.BiSeNetV2(n_classes=(19,), n_bn=1, aux=False, dtype=jnp.bfloat16)
        v = jax.eval_shape(lambda k: jm.init(k, x, train=False),
                           jax.random.PRNGKey(0))
        v = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), dict(v))
        return bisenetv2_state_dict_from_jax(v["params"], v["batch_stats"])

    none = state_dict()
    with routes(stem=True, tail=True, conv3=True, dma=True):
        every = state_dict()
    assert {k: np.shape(a) for k, a in every.items()} == {
        k: np.shape(a) for k, a in none.items()}
    tm = MODELS["bisenetv2"](n_classes=(19,), aux=False, dtype=torch.bfloat16)
    load_reference_weights(tm, every)  # strict


def test_pred_route_names():
    with pytest.raises(ValueError):
        tl.set_pred_impl("xla")
    assert tl.get_pred_impl() == "plain"
