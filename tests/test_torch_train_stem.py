"""Kernel 1's training form, port against JAX on the CPU.

`stem_conv3x3_s2` (mds_tpu_torch/ops/stem.py: an autograd Function, kernel
1 forward with unit scale, zero bias and no ReLU, the library conv's
gradients backward; its plain version on a CPU tensor) against JAX's
`stem_conv3x3_s2` (mds_tpu/ops/pallas/stem.py:1235-1299, a custom_vjp over
the Pallas stem kernel, run in interpret mode here) from the same
numpy-seeded bf16 inputs and output gradient:

- the output: JAX's is the f32 sum (its `_stem_fwd` without a BN writes
  f32), the port's that sum rounded once to bf16 (kernel 1 writes bf16):
  rel < 1e-2, and ≥ 99% of the outputs equal JAX's rounded to bf16;
- dx and dk: the library conv's bf16 gradients on both sides (XLA's and
  PyTorch's CPU convs), rel < 1e-2.

Then the layer: a train-mode `StemConv3x3S2` under
`set_stem_impl("kernel")` against JAX's under `set_stem_impl("pallas")` at
64×64, output and gradients to the same bounds, through the route (the
Function is called) and not past it on the plain switch.
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
from torch_parity import interpret_pallas, nchw, nhwc, oihw, rel_err

TOL = 1e-2


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


def _check(got, want):
    (y, dx, dk), (wy, wdx, wdk) = got, want
    assert y.shape == wy.shape and dx.shape == wdx.shape and dk.shape == wdk.shape
    wy16 = np.asarray(jnp.asarray(wy, jnp.bfloat16), np.float32)
    assert rel_err(y, wy) < TOL and (y == wy16).mean() >= 0.99
    assert rel_err(dx, wdx) < TOL
    assert rel_err(dk, wdk) < TOL


@pytest.mark.parametrize("b,h,w,o", [(2, 16, 24, 64), (1, 32, 10, 16)])
def test_function_matches_jax(b, h, w, o):
    x, k, g = _inputs(b, h, w, o, o + h)
    before = tstem.stem_conv3x3_s2.launches
    got = _torch_grads(tstem.stem_conv3x3_s2, x, k, g)
    _check(got, _jax_grads(jstem.stem_conv3x3_s2, x, k, g))
    assert tstem.stem_conv3x3_s2.launches == before  # CPU: the plain version


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
    _check(got, want)
    assert calls == ([(2, 3, 64, 64)] if impl == "kernel" else [])
