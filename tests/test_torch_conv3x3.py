"""TPU kernel 8, the fused eval 3×3 conv, port against JAX on the CPU.

`conv3x3_bn_relu_plain` (mds_tpu_torch/ops/conv3x3.py, which defines what
csrc/conv3x3.cu computes; chip_smoke.py holds the kernel to it on the card)
against JAX's `conv3x3_bn_relu_pallas` in interpret mode:

- f32: rel ≤ 1e-5, both sum the same exact products in f32 in other orders;
- bf16: rel < 1e-2 and ≥ 99% of the outputs bit-equal, one rounding of
  nearly the same f32 value to bf16.

The route: the port's `ConvBNReLU` under `set_conv3_eval_impl("kernel")`
against JAX's under `set_conv3_eval_impl("pallas")` at (B, C, H, W) =
(1, 16, 512, 16). On the CPU JAX's `Conv3x3S1Fusable` takes its XLA
fallback (mds_tpu/models/layers.py:405-423), which rounds the conv to bf16
before the folded affine where the kernel's plain version does not, so the
gate is the bf16 one of bench.py:296-297: rel < 2e-2, and the per-pixel
argmax over the 16 output channels agrees on ≥ 0.99 of the pixels (ties
between channels flip on a bf16 rounding). The route is off in train(),
below H = 512, and launches nothing on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.models import layers as jl
from mds_tpu.ops.pallas import conv3x3 as jc3
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import conv3x3 as tc3
from torch_parity import (
    LOGITS_GATE,
    convbn_state,
    folded_bn,
    interpret_pallas,
    load,
    nchw,
    nhwc,
    oihw,
    randomize_variables,
    rel_err,
)

SHAPES = [(1, 16, 24, 64, 64), (2, 10, 16, 32, 16)]  # B, H, W, Cin, Cout
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas(shape, relu, dtype):
    b, h, w, ci, co = shape
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (b, h, w, ci)).astype(np.float32)
    k = rng.normal(0, np.sqrt(2.0 / (9 * co)), (3, 3, ci, co)).astype(np.float32)
    s, c = folded_bn(rng, co)
    want = np.asarray(jc3.conv3x3_bn_relu_pallas(
        jnp.asarray(x, jd), jnp.asarray(k), jnp.asarray(s), jnp.asarray(c),
        relu=relu), np.float32)
    got = tc3.conv3x3_bn_relu(nchw(x, td), oihw(k), torch.from_numpy(s),
                              torch.from_numpy(c), relu)
    assert got.dtype == td and got.shape == (b, co, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    g = nhwc(got)
    if dtype == "f32":
        assert rel_err(g, want) <= 1e-5
    else:
        assert rel_err(g, want) < 1e-2
        assert (g == want).mean() >= 0.99
    assert tc3.conv3x3_bn_relu.launches == 0  # CPU: the plain version


def _route_pair(c, h, w, relu, seed):
    """JAX's and the port's ConvBNReLU(c → c, 3×3) in bf16 with the same
    weights and random BN statistics, and an input (1, h, w, c)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, h, w, c)).astype(np.float32)
    jm = jl.ConvBNReLU(c, 3, relu=relu, dtype=jnp.bfloat16)
    v = jax.jit(lambda k: jm.init(k, [jnp.asarray(x)], train=False))(
        jax.random.PRNGKey(0))
    v = randomize_variables(jax.tree_util.tree_map(np.asarray, dict(v)), rng)
    tm = tl.ConvBNReLU(c, c, 3, relu=relu, dtype=torch.bfloat16)
    load(tm, convbn_state(v["params"], v["batch_stats"]))
    return jm, v, tm, x


@pytest.mark.parametrize("relu", [True, False])
def test_route_matches_jax(relu):
    jm, v, tm, x = _route_pair(16, 512, 16, relu, 1)
    jl.set_conv3_eval_impl("pallas")
    tl.set_conv3_eval_impl("kernel")
    try:
        (want,) = jm.apply(v, [jnp.asarray(x, jnp.bfloat16)], train=False)
        with torch.no_grad():
            (got,) = tm([nchw(x, torch.bfloat16)])
    finally:
        jl.set_conv3_eval_impl("xla")
        tl.set_conv3_eval_impl("plain")
    assert got.dtype == torch.bfloat16
    g, want = nhwc(got), np.asarray(want, np.float32)
    assert rel_err(g, want) < LOGITS_GATE
    assert (g.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    assert tc3.conv3x3_bn_relu.launches == 0


def _route_calls(monkeypatch, tm, x):
    """The conv3 kernel's calls while `tm` runs on x under the kernel
    route."""
    calls = []
    real = tc3.conv3x3_bn_relu

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(tc3, "conv3x3_bn_relu", spy)
    tl.set_conv3_eval_impl("kernel")
    try:
        with torch.no_grad():
            tm([x])
    finally:
        tl.set_conv3_eval_impl("plain")
    return calls


def test_route_taken_in_eval_at_h512_only(monkeypatch):
    tm = tl.ConvBNReLU(16, 16, 3, dtype=torch.bfloat16).eval()
    x512 = torch.zeros((1, 16, 512, 8), dtype=torch.bfloat16)
    assert _route_calls(monkeypatch, tm, x512) == [x512.shape]
    assert _route_calls(monkeypatch, tm, torch.zeros((1, 16, 256, 8))) == []
    tm.train()
    assert _route_calls(monkeypatch, tm, x512) == []
    # f32 compute, a stride-2 conv and C_in > 64 keep the library path
    for m in (tl.ConvBNReLU(16, 16, 3), tl.ConvBNReLU(16, 16, 3, stride=2,
                                                       dtype=torch.bfloat16),
              tl.ConvBNReLU(128, 16, 3, dtype=torch.bfloat16)):
        xi = torch.zeros((1, m.conv.in_channels, 512, 8), dtype=torch.bfloat16)
        assert _route_calls(monkeypatch, m.eval(), xi) == []


def test_route_names():
    with pytest.raises(ValueError):
        tl.set_conv3_eval_impl("pallas")
    assert tl.get_conv3_eval_impl() == "plain"
