"""The BiSeNetV1 serving slice, port against JAX on the CPU.

Inputs come from a numpy seed and go through the JAX function and its port
counterpart:

- the 7×7 stem: JAX's Pallas kernel in interpret mode against the port's
  plain version (what the CUDA kernel computes), rel < 1e-2 as
  tests/test_space_to_depth.py:288-309, and > 99% of the outputs bit-equal;
- the single-BN fold and eval against flax;
- Resnet18 and BiSeNetV1 in f32 (rel ≤ 1e-4), from JAX variables with
  randomized BN carried over by deploy/weights.py and loaded strictly;
- BiSeNetV1 in bf16 with the 7×7 stems on their kernel route in both
  packages, at 32×512 (the width from which JAX's ResNet conv1 takes its
  kernel too): logits rel < 2e-2 and argmax agreement > 0.97, JAX's own gate
  for this comparison (tests/test_space_to_depth.py:344-372);
- the whole slice through build_e2e on a uint8 frame.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.deploy.torch_import import bisenetv1_from_torch
from mds_tpu.models import bisenetv1 as jv1
from mds_tpu.models import layers as jl
from mds_tpu.models.resnet import Resnet18 as JResnet18
from mds_tpu.ops.pallas import stem as jstem
from mds_tpu_torch import MODELS
from mds_tpu_torch.deploy.weights import (
    bisenetv1_state_dict_from_jax,
    bisenetv1_to_torch,
    load_reference_weights,
    resnet18_to_torch,
)
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.models.resnet import Resnet18
from mds_tpu_torch.ops import stem as tstem
from torch_parity import (
    LOGITS_GATE,
    folded_bn,
    nchw,
    nhwc,
    oihw,
    rel_err,
    seeded_variables,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 128           # the f32 comparisons
BH, BW = 32, 512         # the bf16 kernel-route comparisons
KERNEL_ROUTE_AGREE = 0.97
CITY_MEAN = np.asarray([0.3038, 0.3383, 0.3034], np.float32)  # cityscapes spec
CITY_STD = np.asarray([0.2071, 0.2088, 0.209], np.float32)


def _f32(t):
    return np.asarray(t, np.float32)


# ---------------------------------------------------------------- the kernel

@pytest.mark.parametrize("o,relu", [(64, True), (64, False), (32, True)])
def test_stem7_plain_matches_jax_kernel(o, relu):
    rng = np.random.default_rng(17 + o)
    x = rng.normal(0, 1, (2, 36, 44, 3)).astype(np.float32)
    k = rng.normal(0, 0.15, (7, 7, 3, o)).astype(np.float32)
    s, b = folded_bn(rng, o)
    want = jstem.stem7_conv_bn_relu_s2(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(k), jnp.asarray(s), jnp.asarray(b),
        th=4, relu=relu, interpret=True)
    got = tstem.stem7_conv_bn_relu_s2(nchw(x, torch.bfloat16), oihw(k),
                                      torch.from_numpy(s), torch.from_numpy(b), relu=relu)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    got, want = nhwc(got), _f32(want)
    assert got.shape == want.shape == (2, 18, 22, o)
    assert rel_err(got, want) < 1e-2
    # the same rounding points: all but a few of the outputs are bit-equal
    assert (got == want).mean() > 0.99
    if not relu:
        assert (want < 0).any()


def test_stem7_wrapper_rejects_other_devices():
    x = torch.empty((1, 3, 8, 8), dtype=torch.bfloat16, device="meta")
    k, s = torch.empty((64, 3, 7, 7), device="meta"), torch.empty(64, device="meta")
    before = tstem.stem7_conv_bn_relu_s2.launches
    with pytest.raises(ValueError):
        tstem.stem7_conv_bn_relu_s2(x, k, s, s)
    assert tstem.stem7_conv_bn_relu_s2.launches == before


# ------------------------------------------------------- the single-BN layer

def test_bn_fold_and_eval_match_flax():
    from flax import linen as fnn

    rng = np.random.default_rng(1)
    n = 48
    var = {"params": {"scale": rng.normal(1, 0.1, n).astype(np.float32),
                      "bias": rng.normal(0, 0.1, n).astype(np.float32)},
           "batch_stats": {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}}
    bn = torch.nn.BatchNorm2d(n).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(var["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(var["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(var["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(var["batch_stats"]["var"]))
    want_s, want_b = jl.BNFold(n).apply(var)
    got_s, got_b = tl.bn_fold(bn)
    assert rel_err(got_s.detach().numpy(), want_s) <= 1e-6
    assert rel_err(got_b.detach().numpy(), want_b) <= 1e-6

    x = rng.normal(0, 2, (2, 5, 7, n)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = fnn.BatchNorm(use_running_average=True, dtype=jdt).apply(
            var, jnp.asarray(x, jdt))
        with torch.no_grad():
            got = tl.bn_eval(bn, nchw(x, tdt), tdt)
        assert got.dtype == tdt
        if tdt == torch.float32:
            assert rel_err(nhwc(got), want) <= 1e-6
        else:  # one rounding of the same f32 value
            assert (nhwc(got) == _f32(want)).mean() > 0.999
    bn.train()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl.bn_eval(bn, nchw(x), torch.float32)


# ---------------------------------------------------- Resnet18 and BiSeNetV1

@pytest.fixture(scope="module")
def v1_f32():
    """A JAX BiSeNetV1 with aux heads (its variable tree from an init in
    train mode, which creates them) and seeded weights and BN, its f32 eval
    outputs at (1, 64, 128), and the input."""
    jm = jv1.BiSeNetV1(n_classes=(19,), aux=True)
    v = seeded_variables(jm, 0, [jnp.zeros((1, H, W, 3), jnp.float32)], train=True)
    x = np.random.default_rng(2).normal(0, 1, (1, H, W, 3)).astype(np.float32)
    low = jax.jit(lambda v, x: jm.apply(v, [x], train=False, up=False))(v, x)
    # eval_logits is the same head with its ×8 resize (bisenetv1.py:173-177):
    # one model compile serves both
    (lg,) = low["logits"]
    logits = jax.image.resize(lg.astype(jnp.float32), (1, H, W, lg.shape[-1]), "linear")
    return jm, v, x, _f32(logits), low


def test_resnet18_f32_matches_jax(v1_f32):
    _, v, x, _, _ = v1_f32
    p, s = v["params"]["cp"]["resnet"], v["batch_stats"]["cp"]["resnet"]
    want = jax.jit(lambda p, s, x: JResnet18().apply(
        {"params": p, "batch_stats": s}, x, train=False))(p, s, x)
    tm = load_reference_weights(Resnet18(), resnet18_to_torch(p, s)).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    for g, w, stride in zip(got, want, (8, 16, 32)):
        assert g.shape[2:] == (H // stride, W // stride)
        assert rel_err(nhwc(g), w) <= 1e-4


@pytest.mark.parametrize("aux", [True, False])
def test_bisenetv1_eval_logits_f32(v1_f32, aux):
    _, v, x, want, _ = v1_f32
    tm = MODELS["bisenetv1"](n_classes=(19,), aux=aux)
    load_reference_weights(tm, bisenetv1_to_torch(v["params"], v["batch_stats"])).eval()
    with torch.no_grad():
        got = tm.eval_logits(nchw(x))
    assert got.shape == (1, 19, H, W) and got.dtype == torch.float32
    assert rel_err(nhwc(got), want) <= 1e-4


def test_bisenetv1_forward_up_false(v1_f32):
    _, v, x, _, want = v1_f32
    tm = MODELS["bisenetv1"](n_classes=(19,), aux=True)
    load_reference_weights(tm, bisenetv1_state_dict_from_jax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = tm.eval()([nchw(x)], up=False)
    assert set(got) == set(want) == {"logits", "up_factors"}
    assert got["up_factors"] == (8, [8, 16]) == (want["up_factors"][0],
                                                 list(want["up_factors"][1]))
    (g,), (w,) = got["logits"], want["logits"]
    assert g.shape == (1, 19, H // 8, W // 8)
    assert rel_err(nhwc(g), w) <= 1e-4


def test_weights_round_trip_and_strict_load(v1_f32):
    """JAX → the port's state_dict → JAX's own importer gives back every
    variable exactly; the port's models take it strictly, the aux-less one
    after load_reference_weights drops the aux heads."""
    _, v, _, _, _ = v1_f32
    sd = bisenetv1_state_dict_from_jax(v["params"], v["batch_stats"])
    p, s = bisenetv1_from_torch({k: t.numpy() for k, t in sd.items()}, aux=True)
    for got, want in ((p, v["params"]), (s, v["batch_stats"])):
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [k for k, _ in flat_g] == [k for k, _ in flat_w]
        for (_, a), (_, b) in zip(flat_g, flat_w):
            np.testing.assert_array_equal(a, b)
    tm = MODELS["bisenetv1"](n_classes=(19,), aux=True)
    assert set(sd) == {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    assert "cp.arm16.conv.conv.weight" in sd and "sp.conv1.bn.running_var" in sd
    assert "conv_out.conv_out.bias" in sd and "cp.resnet.layer2.0.downsample.1.weight" in sd
    tm.load_state_dict(sd, strict=True)
    load_reference_weights(MODELS["bisenetv1"](n_classes=(19,), aux=False), sd)


def test_train_mode_raises():
    tm = MODELS["bisenetv1"](n_classes=(19,), aux=True).train()
    x = torch.zeros(1, 3, 32, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 5"):
        tm([x])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Resnet18().train()(x)
    with pytest.raises(ValueError):
        MODELS["bisenetv1"](n_classes=(19, 7), n_bn=2)


# ------------------------------------------------- bf16, the stem kernels on

@pytest.fixture(scope="module")
def v1_bf16(v1_f32):
    """JAX's bf16 BiSeNetV1 (aux-less, the f32 model's variables) on one
    uint8 frame normalized as mds_tpu/deploy/export.py make_e2e_fn does,
    with both 7×7 stems on the Pallas kernel (interpret mode): its logits
    and its labels (pred is argmax of eval_logits, bisenetv1.py:238-239)."""
    _, v, _, _, _ = v1_f32
    v = {c: {k: t for k, t in v[c].items() if k not in ("conv_out16", "conv_out32")}
         for c in v}
    jm = jv1.BiSeNetV1(n_classes=(19,), aux=False, dtype=jnp.bfloat16)
    frame = np.random.default_rng(3).integers(0, 256, (1, BH, BW, 3)).astype(np.uint8)
    x = (frame.astype(np.float32) / 255.0 - CITY_MEAN) / CITY_STD
    jl.set_stem_impl("pallas")
    try:
        logits = _f32(jax.jit(lambda v, x: jm.apply(v, x, method=jm.eval_logits))(v, x))
    finally:
        jl.set_stem_impl("plain")
    return v, frame, x, logits, logits.argmax(-1)


def test_bisenetv1_bf16_kernel_route_matches_jax(v1_bf16, monkeypatch):
    v, _, x, want_logits, want_labels = v1_bf16
    tm = MODELS["bisenetv1"](n_classes=(19,), aux=False, dtype=torch.bfloat16)
    load_reference_weights(tm, bisenetv1_to_torch(v["params"], v["batch_stats"])).eval()
    calls = []
    plain = tstem.stem7_conv_bn_relu_s2_plain
    monkeypatch.setattr(tstem, "stem7_conv_bn_relu_s2_plain",
                        lambda *a, **k: calls.append(a[0].shape) or plain(*a, **k))
    counts = [k.launches for k in tstem.KERNELS]
    tl.set_stem_impl("kernel")
    try:
        with torch.no_grad():
            got = tm.eval_logits(nchw(x))
    finally:
        tl.set_stem_impl("plain")
    # both 7×7 stems took the kernel route; on the CPU it runs the plain version
    assert calls == [(1, 3, BH, BW)] * 2
    assert [k.launches for k in tstem.KERNELS] == counts
    got = nhwc(got)
    assert got.shape == want_logits.shape == (1, BH, BW, 19)
    assert rel_err(got, want_logits) < LOGITS_GATE
    assert (got.argmax(-1) == want_labels).mean() > KERNEL_ROUTE_AGREE


def test_e2e_slice_matches_jax(v1_bf16, monkeypatch):
    """build_e2e on configs/bisenetv1_city.json on the CPU: uint8 frame →
    normalize → bf16 BiSeNetV1 (stem kernel route) → int32 labels."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import serve_torch

    v, frame, _, _, want_labels = v1_bf16
    e2e = serve_torch.build_e2e(os.path.join(ROOT, "configs", "bisenetv1_city.json"),
                                device="cpu")
    assert type(e2e.model).__name__ == "BiSeNetV1" and e2e.model.dtype == torch.bfloat16
    np.testing.assert_allclose(e2e.mean.numpy(), CITY_MEAN)
    load_reference_weights(e2e.model, bisenetv1_to_torch(v["params"], v["batch_stats"]))
    tl.set_stem_impl("kernel")
    try:
        got = e2e.infer(frame)
    finally:
        tl.set_stem_impl("plain")
    assert got.dtype == np.int32 and got.shape == (1, BH, BW)
    assert (got == want_labels).mean() > KERNEL_ROUTE_AGREE
