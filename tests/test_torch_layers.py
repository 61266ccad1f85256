"""Parity of the port's layers (mds_tpu_torch/models/layers.py) with the JAX
layers (mds_tpu/models/layers.py) in f32 on the CPU: the same numpy inputs
and the same (randomized) variables go through both; rel ≤ 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.models import layers as jl
from mds_tpu_torch.models import layers as tl
from torch_parity import convbn_state, load, nchw, nhwc, oihw, randomize_variables, rel_err

TOL = 1e-4  # f32 on both sides; only the summation order differs


def _init(module, *args, **kw):
    v = module.init(jax.random.PRNGKey(0), *args, **kw)
    return jax.tree_util.tree_map(np.asarray, dict(v))


@pytest.mark.parametrize("shared_affine", [True, False])
def test_dataset_norm_eval_and_fold(shared_affine):
    rng = np.random.default_rng(0)
    c = 16
    xs = [rng.normal(0, 1, (2, 6, 5, c)).astype(np.float32), None]
    jm = jl.DatasetNorm(c, n_bn=2, shared_affine=shared_affine)
    v = randomize_variables(_init(jm, [xs[0], xs[0]], train=False), rng)
    want = jm.apply(v, [jnp.asarray(xs[0]), None], train=False)
    want_fold = jm.apply(v, [None, jnp.asarray(xs[0])], train=False, fold=True)

    tm = tl.DatasetNorm(c, n_bn=2, affine=not shared_affine)
    p, s = v["params"], v["batch_stats"]
    sd = {}
    for i in range(2):
        sd[f"{i}.running_mean"] = s["mean"][i]
        sd[f"{i}.running_var"] = s["var"][i]
        if not shared_affine:
            sd[f"{i}.weight"] = p["scale"][i]
            sd[f"{i}.bias"] = p["bias"][i]
    load(tm, sd)
    shared = ((torch.from_numpy(p["scale"]), torch.from_numpy(p["bias"]))
              if shared_affine else None)
    got = tm([nchw(xs[0]), None], shared)
    got_fold = tm.fold([None, nchw(xs[0])], shared)

    assert got[1] is None and want[1] is None
    assert rel_err(nhwc(got[0]), want[0]) <= TOL
    assert got_fold[0] is None and want_fold[0] is None
    for g, w in zip(got_fold[1], want_fold[1]):
        assert rel_err(g.detach().numpy(), w) <= TOL


@pytest.mark.parametrize("c_in,c_out,ks,stride,groups", [
    (16, 32, 3, 1, 1),   # plain 3×3
    (16, 32, 3, 2, 1),   # strided 3×3
    (32, 16, 1, 1, 1),   # 1×1
    (3, 16, 3, 2, 1),    # RGB stem (StemConv3x3S2 in the port)
    (8, 48, 3, 1, 8),    # depthwise, channel multiplier 6
    (8, 48, 3, 2, 8),    # depthwise s2, channel multiplier 6
    (24, 24, 3, 1, 24),  # depthwise, multiplier 1
])
def test_conv_bn_relu(c_in, c_out, ks, stride, groups):
    rng = np.random.default_rng(1)
    x0 = rng.normal(0, 1, (1, 12, 10, c_in)).astype(np.float32)
    x1 = rng.normal(0, 1, (2, 12, 10, c_in)).astype(np.float32)
    jm = jl.ConvBNReLU(c_out, ks, stride=stride, groups=groups, n_bn=2)
    v = randomize_variables(_init(jm, [x0, x1], train=False), rng)
    want = jm.apply(v, [jnp.asarray(x0), jnp.asarray(x1)], train=False)

    tm = tl.ConvBNReLU(c_in, c_out, ks, stride=stride, groups=groups, n_bn=2)
    load(tm, convbn_state(v["params"], v["batch_stats"]))
    got = tm([nchw(x0), nchw(x1)])
    for g, w in zip(got, want):
        assert g.shape == nchw(w).shape
        assert rel_err(nhwc(g), w) <= TOL


def test_conv_bn_fused_stem_route_matches_jax():
    """The stem route in f32 (no kernel: the folded conv→affine→ReLU on
    library ops) against JAX's set_stem_impl('pallas') fallback."""
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 16, 12, 3)).astype(np.float32)
    jm = jl.ConvBNReLU(16, 3, stride=2)
    v = randomize_variables(_init(jm, [x], train=False), rng)
    tm = tl.ConvBNReLU(3, 16, 3, stride=2)
    load(tm, convbn_state(v["params"], v["batch_stats"]))
    before = stem.stem_conv_bn_relu_s2.launches
    jl.set_stem_impl("pallas")
    tl.set_stem_impl("kernel")
    try:
        (want,) = jm.apply(v, [jnp.asarray(x)], train=False)
        (got,) = tm([nchw(x)])
    finally:
        jl.set_stem_impl("plain")
        tl.set_stem_impl("plain")
    assert rel_err(nhwc(got), want) <= TOL
    assert stem.stem_conv_bn_relu_s2.launches == before  # CPU: no launch


def test_stem_impl_switch_rejects_unknown():
    with pytest.raises(ValueError):
        tl.set_stem_impl("pallas")
    assert tl.get_stem_impl() == "plain"


def test_conv_bn_folded_matches_fold():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (1, 8, 8, 64)).astype(np.float32)
    jm = jl.ConvBNReLU(64, 3, n_bn=2)
    v = randomize_variables(_init(jm, [x, x], train=False), rng)
    k, cf = jm.apply(v, [None, jnp.asarray(x)], train=False, emit="folded")
    tm = tl.ConvBNReLU(64, 64, 3, n_bn=2)
    load(tm, convbn_state(v["params"], v["batch_stats"]))
    tk, tcf = tm.folded([None, nchw(x)])
    np.testing.assert_array_equal(tk.detach().numpy(), oihw(k).numpy())
    assert tcf[0] is None and cf[0] is None
    for g, w in zip(tcf[1], cf[1]):
        assert rel_err(g.detach().numpy(), w) <= TOL


@pytest.mark.parametrize("aux,up", [(False, 8), (True, 4), (True, 16)])
def test_segment_head(aux, up):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (1, 6, 8, 24)).astype(np.float32)
    jm = jl.SegmentHead(32, 5, up_factor=up, aux=aux)
    v = randomize_variables(_init(jm, jnp.asarray(x), train=False), rng)
    p, s = v["params"], v["batch_stats"]
    sd = convbn_state(p["conv"], s["conv"], "conv.")
    if aux:
        sd.update(convbn_state(p["conv1"], s["conv1"], "conv1."))
    sd["conv2.weight"] = oihw(p["conv_out"]["kernel"])
    sd["conv2.bias"] = p["conv_out"]["bias"]
    tm = tl.SegmentHead(24, 32, 5, up_factor=up, aux=aux)
    load(tm, sd)
    assert tm.residual_factor == jm.residual_factor
    for up_ in (True, False):
        want = jm.apply(v, jnp.asarray(x), train=False, up=up_)
        got = tm(nchw(x), up=up_)
        assert got.shape == nchw(want).shape
        assert rel_err(nhwc(got), want) <= TOL


@pytest.mark.parametrize("name,args", [
    ("upsample", (2, "nearest")),
    ("upsample", (4, "bilinear")),
    ("resize_bilinear", ((20, 36),)),
    ("resize_bilinear", ((5, 6),)),
    ("max_pool_3x3_s2", ()),
    ("avg_pool_3x3_s2", ()),
])
def test_resize_and_pool(name, args):
    x = np.random.default_rng(5).normal(0, 1, (2, 10, 12, 3)).astype(np.float32)
    want = getattr(jl, name)(jnp.asarray(x), *args)
    got = getattr(tl, name)(nchw(x), *args)
    assert got.shape == nchw(want).shape
    assert rel_err(nhwc(got), want) <= TOL


def test_lists():
    a, b = torch.ones(1), torch.zeros(1)
    assert tl.as_multi(a, 1, 3) == [None, a, None]
    assert tl.lmap(lambda t: t + 1, [None, a])[0] is None
    out = tl.lmap2(lambda s, t: s + t, [a, None, a], [b, b, None])
    assert out[1] is None and out[2] is None and torch.equal(out[0], a)
