"""Kernel 1's training form, port against JAX on the CPU.

`stem_conv3x3_s2` (mds_tpu_torch/ops/stem.py: an autograd Function, kernel
1 forward with unit scale, zero bias and no ReLU, the library conv's
gradients backward; its plain version on a CPU tensor) against JAX's
`stem_conv3x3_s2` (mds_tpu/ops/pallas/stem.py:1235-1299, a custom_vjp over
the Pallas stem kernel, run in interpret mode here) from the same
numpy-seeded bf16 inputs and output gradient:

- the output: the f32 sum on both sides (JAX's `_stem_fwd` without a BN
  writes f32, and so does kernel 1's training form): rel ≤ 1e-4, the
  round's f32 gate (the two sum the same exact products of bf16 values in
  another order);
- dx and dk: the library conv's bf16 gradients on both sides (XLA's and
  PyTorch's CPU convs), rel < 1e-2.

Then the layer: a train-mode `StemConv3x3S2` under
`set_stem_impl("kernel")` against JAX's under `set_stem_impl("pallas")` at
64×64, its f32 output to the f32 gate and its gradients to 1e-2, through
the route (the Function is called); on the plain switch both sides keep
the library conv's bf16 (rel < 1e-2, ≥ 99% of the outputs equal JAX's
rounded to bf16) and the Function is not called. And the whole train-mode
ConvBNReLU stem (conv → batch-statistics BN of each dataset → shared
affine → ReLU, bf16 out) on both switches: its output and the gradients of
its inputs and conv weight against JAX's, rel < 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.models import layers as jl
from mds_tpu.ops.pallas import stem as jstem
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import stem as tstem
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import (
    convbn_state,
    interpret_pallas,
    load,
    nchw,
    nhwc,
    oihw,
    randomize_variables,
    rel_err,
)

TOL = 1e-2
F32_TOL = 1e-4  # the round's f32 gate


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _inputs(b, h, w, o, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
    k = rng.normal(0, np.sqrt(2.0 / (9 * o)), (3, 3, 3, o)).astype(np.float32)
    g = rng.normal(0, 1, (b, h // 2, w // 2, o)).astype(np.float32)
    return x, k, g


def _jax_grads(fn, x, k, g):
    """fn's output and its VJP at (x, k) for the output gradient g, all
    bf16 in, as f32 numpy."""
    xj, kj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    y, vjp = jax.vjp(fn, xj, kj)
    dx, dk = vjp(jnp.asarray(g, jnp.bfloat16).astype(y.dtype))
    return [np.asarray(t, np.float32) for t in (y, dx, dk)]


def _torch_grads(fn, x, k, g):
    """The same for a port function of (x NCHW, k OIHW), bf16."""
    xt = nchw(x, torch.bfloat16).requires_grad_(True)
    kt = oihw(k).to(torch.bfloat16).requires_grad_(True)
    y = fn(xt, kt)
    y.backward(nchw(g, torch.bfloat16))
    return nhwc(y), nhwc(xt.grad), kt.grad.float().permute(2, 3, 1, 0).numpy()


def _check(got, want, f32):
    """f32: both outputs are the f32 sum (the f32 gate); else both are the
    library conv's bf16."""
    (y, dx, dk), (wy, wdx, wdk) = got, want
    assert y.shape == wy.shape and dx.shape == wdx.shape and dk.shape == wdk.shape
    if f32:
        assert rel_err(y, wy) <= F32_TOL
    else:
        wy16 = np.asarray(jnp.asarray(wy, jnp.bfloat16), np.float32)
        assert rel_err(y, wy) < TOL and (y == wy16).mean() >= 0.99
    assert rel_err(dx, wdx) < TOL
    assert rel_err(dk, wdk) < TOL


@pytest.mark.parametrize("b,h,w,o", [(2, 16, 24, 64), (1, 32, 10, 16)])
def test_function_matches_jax(b, h, w, o):
    x, k, g = _inputs(b, h, w, o, o + h)
    before = tstem.stem_conv3x3_s2.launches
    got = _torch_grads(tstem.stem_conv3x3_s2, x, k, g)
    _check(got, _jax_grads(jstem.stem_conv3x3_s2, x, k, g), f32=True)
    assert tstem.stem_conv3x3_s2.launches == before  # CPU: the plain version
    y = tstem.stem_conv3x3_s2(nchw(x, torch.bfloat16), oihw(k).to(torch.bfloat16))
    assert y.dtype == torch.float32 and y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_train_layer_matches_jax(monkeypatch, impl):
    """The train-mode layer at 64×64: the port's conv of a StemConv3x3S2 in
    bf16 against JAX's module under the matching switch ("pallas" for the
    kernel route, "plain" for the library conv)."""
    x, k, g = _inputs(2, 64, 64, 16, 5)
    calls = []
    real = tstem.stem_conv3x3_s2

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(tstem, "stem_conv3x3_s2", spy)
    jm = jl.StemConv3x3S2(16, jnp.bfloat16)
    tm = tl.StemConv3x3S2(3, 16).train()

    def jax_fn(xj, kj):
        return jm.apply({"params": {"kernel": kj.astype(jnp.float32)}}, xj)

    jl.set_stem_impl("pallas" if impl == "kernel" else "plain")
    tl.set_stem_impl(impl)
    try:
        want = _jax_grads(jax_fn, x, k, g)
        with torch.no_grad():
            tm.weight.copy_(oihw(k).to(torch.bfloat16).float())
        xt = nchw(x, torch.bfloat16).requires_grad_(True)
        y = tm.conv(xt, torch.bfloat16)
        y.backward(nchw(g, torch.bfloat16))  # dk reaches the f32 parameter
        got = (nhwc(y), nhwc(xt.grad), tm.weight.grad.permute(2, 3, 1, 0).numpy())
    finally:
        jl.set_stem_impl("plain")
        tl.set_stem_impl("plain")
    assert y.dtype == (torch.float32 if impl == "kernel" else torch.bfloat16)
    _check(got, want, f32=impl == "kernel")
    assert calls == ([(2, 3, 64, 64)] if impl == "kernel" else [])


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_train_conv_bn_relu_matches_jax(impl):
    """A train-mode ConvBNReLU stem of two datasets (3 → 16, s2, bf16): the
    conv (the f32 sum on the kernel route), each dataset's batch-statistics
    BN, the shared affine and the ReLU, against JAX's module under the
    matching switch; output and the gradients of both inputs and of the
    conv weight, rel < 1e-2."""
    rng = np.random.default_rng(8)
    xs = [rng.normal(0, 1, (b, 32, 48, 3)).astype(np.float32) for b in (2, 1)]
    gs = [rng.normal(0, 1, (b, 16, 24, 16)).astype(np.float32) for b in (2, 1)]
    jm = jl.ConvBNReLU(16, 3, stride=2, n_bn=2, dtype=jnp.bfloat16)
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(0), [jnp.asarray(x) for x in xs], train=False)))
    v = randomize_variables(v, rng)
    tm = tl.ConvBNReLU(3, 16, 3, stride=2, n_bn=2, dtype=torch.bfloat16)
    load(tm, convbn_state(v["params"], v["batch_stats"])).train()

    stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])

    def jax_fn(x0, x1, kern):
        params = {**v["params"], "conv": {"kernel": kern}}
        ys, _ = jm.apply({"params": params, "batch_stats": stats},
                         [x0, x1], train=True, mutable=["batch_stats"])
        return ys

    jl.set_stem_impl("pallas" if impl == "kernel" else "plain")
    tl.set_stem_impl(impl)
    try:
        args = [jnp.asarray(x, jnp.bfloat16) for x in xs]
        ys, vjp = jax.vjp(jax_fn, *args, jnp.asarray(v["params"]["conv"]["kernel"]))
        wdx0, wdx1, wdk = vjp([jnp.asarray(g, jnp.bfloat16) for g in gs])
        xts = [nchw(x, torch.bfloat16).requires_grad_(True) for x in xs]
        outs = tm(xts)
        torch.autograd.backward(outs, [nchw(g, torch.bfloat16) for g in gs])
    finally:
        jl.set_stem_impl("plain")
        tl.set_stem_impl("plain")
    for got, want in zip(outs, ys):
        assert got.dtype == torch.bfloat16
        assert rel_err(nhwc(got), np.asarray(want, np.float32)) < TOL
    for xt, want in zip(xts, (wdx0, wdx1)):
        assert rel_err(nhwc(xt.grad), np.asarray(want, np.float32)) < TOL
    assert rel_err(tm.conv.weight.grad.permute(2, 3, 1, 0).numpy(),
                   np.asarray(wdk, np.float32)) < TOL
