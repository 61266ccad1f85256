"""The port's SwiftNet pyramid (mds_tpu_torch/models/swiftnet.py) against
JAX's (mds_tpu/models/swiftnet.py) on the CPU.

Gates: f32 rel ≤ 1e-4 (max-diff over the reference's largest magnitude)
for the train and eval forwards and the BN stats; the gradient of a train
loss (in tests/test_torch_swiftnet_grad.py); `bicubic_downsample` ≤
1e-6. The kernel-6 route is held in tests/test_torch_swiftnet_stem7.py.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    KW, jax_pyramid, nchw, nhwc, one_torch_thread, randomize, rel)
from mds_tpu_torch.deploy.weights import swiftnet_to_torch
from mds_tpu_torch.models import swiftnet as ts

F32 = 1e-4


def test_shared_list_bn_matches_jax():
    """Train: the joint moments over [x0, None, x2] normalize both entries
    and move only the slot's stats (unbiased variance); eval: the slot's
    running stats."""
    from mds_tpu.models.swiftnet import SharedListBN as JBN

    rng = np.random.default_rng(0)
    xs = [rng.normal(0.3, 2.0, (2, 5, 6, 8)).astype(np.float32), None,
          rng.normal(-0.2, 1.0, (1, 7, 3, 8)).astype(np.float32)]
    jm = JBN(8, n_slots=3)
    v = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(0), [jnp.asarray(xs[0])], slot=0, train=True)))
    v = randomize(v, rng)
    vj = jax.tree_util.tree_map(jnp.asarray, v)
    bns = [ts.SharedListBN(8) for _ in range(3)]
    for i, bn in enumerate(bns):
        bn.load_state_dict({"weight": torch.tensor(v["params"]["scale"][i]),
                            "bias": torch.tensor(v["params"]["bias"][i]),
                            "running_mean": torch.tensor(v["batch_stats"]["mean"][i]),
                            "running_var": torch.tensor(v["batch_stats"]["var"][i])},
                           strict=False)
    jxs = [None if x is None else jnp.asarray(x) for x in xs]
    want, mut = jm.apply(vj, jxs, slot=1, train=True, mutable=["batch_stats"])
    got = bns[1].train()([None if x is None else nchw(x) for x in xs])
    assert got[1] is None and want[1] is None
    for g, w in zip(got[::2], want[::2]):
        assert rel(nhwc(g), w) <= 1e-6
    for i in range(3):
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            w = np.asarray(mut["batch_stats"][key][i])
            assert rel(getattr(bns[i], name).numpy(), w) <= 1e-6, (i, name)
    want = jm.apply(vj, jxs, slot=2, train=False)
    got = bns[2].eval()([None if x is None else nchw(x) for x in xs])
    for g, w in zip(got[::2], want[::2]):
        assert rel(nhwc(g), w) <= 1e-6


@pytest.mark.parametrize("hw,factor", [((64, 96), 2), ((64, 96), 4), ((70, 54), 4),
                                       ((9, 14), 2)])
def test_bicubic_downsample_matches_jax(hw, factor):
    from mds_tpu.models.swiftnet import bicubic_downsample as jbd

    x = np.random.default_rng(1).normal(0, 1, (2, *hw, 3)).astype(np.float32)
    want = np.asarray(jbd(jnp.asarray(x), factor))
    got = nhwc(ts.bicubic_downsample(nchw(x), factor))
    assert got.shape == want.shape
    assert rel(got, want) <= 1e-6


@pytest.fixture(scope="module")
def pyramid():
    return jax_pyramid()


@pytest.mark.parametrize("hw", [(72, 72), (96, 160)])
def test_pyramid_forwards_match_jax(pyramid, hw):
    """Eval and train forwards over two datasets of different batch and the
    BN stats after the train forward (odd deep-level sizes at 72×72 and
    96×160 exercise the blends' half-pixel resize)."""
    jm, v, tm = pyramid
    tm = copy.deepcopy(tm)
    rng = np.random.default_rng(2)
    xs = [rng.normal(0, 1, (2, *hw, 3)).astype(np.float32),
          rng.normal(0, 1, (1, *hw, 3)).astype(np.float32)]
    vj = jax.tree_util.tree_map(jnp.asarray, v)
    jx = [jnp.asarray(x) for x in xs]
    want, (jout, mut) = jax.jit(lambda v, x: (
        jm.apply(v, x, train=False),
        jm.apply(v, x, train=True, mutable=["batch_stats"])))(vj, jx)
    with torch.no_grad():
        got = tm.eval()([nchw(x) for x in xs])
        out = tm.train()([nchw(x) for x in xs])
    for g, w in zip(got + out, list(want) + list(jout)):
        assert rel(nhwc(g), w) <= F32
    want_sd = swiftnet_to_torch(v["params"], jax.tree_util.tree_map(
        np.asarray, mut["batch_stats"]), prefix="")
    sd = tm.state_dict()
    for k, w in want_sd.items():
        if "running" in k:
            assert rel(sd[k].numpy(), w) <= F32, k


def test_remat_recomputes_without_moving_the_stats_twice():
    """network.efficient: the same output, gradients and BN stats as
    without remat."""
    plain = ts.SwiftNetPyramid(**KW).init_weights(torch.Generator().manual_seed(0))
    remat = ts.SwiftNetPyramid(**KW, remat=True)
    remat.load_state_dict(plain.state_dict())
    x = [torch.randn(2, 3, 64, 64), torch.randn(1, 3, 64, 64)]
    outs = []
    for m in (plain, remat):
        m.train()
        out = m(x)
        sum(o.square().sum() for o in out).backward()
        outs.append((out, {n: p.grad for n, p in m.named_parameters()}, m.state_dict()))
    (o1, g1, s1), (o2, g2, s2) = outs
    assert all(torch.equal(a, b) for a, b in zip(o1, o2))
    assert all(torch.allclose(g1[k], g2[k], rtol=1e-5, atol=1e-7) for k in g1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
