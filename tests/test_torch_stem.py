"""The port's stem kernels (mds_tpu_torch/ops/stem.py) against the JAX
Pallas kernels (mds_tpu/ops/pallas/stem.py) in interpret mode on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version, so these tests
hold the plain versions, which define what the CUDA kernels compute (the
card-side comparison lives in chip_smoke.py), to the JAX kernels. Bounds as
in tests/test_space_to_depth.py: abs < 0.1 (one bf16 rounding apart) and
rel < 2e-2.

The window variant of the stem (set_stem_variant("dma"), TPU kernel 2) is
held to JAX's `_stem_fwd_dma(interpret=True)` itself: interpret mode runs
its manual window copies and semaphores on the CPU. The S1 pair (TPU kernel
3) is held to JAX's `stem_s1_pair_fused(interpret=True)`, with and without
its second ReLU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.models import bisenetv2 as jb
from mds_tpu.models import layers as jl
from mds_tpu.ops.pallas import stem as jstem
from mds_tpu_torch.models import bisenetv2 as tb
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import build
from mds_tpu_torch.ops import stem as tstem
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import (
    convbn_state,
    folded_bn,
    load,
    nchw,
    nhwc,
    oihw,
    randomize_variables,
    rel_err,
)

SHAPES = [(2, 32, 48), (1, 64, 64)]


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 0.1
    assert rel_err(got, want) < 2e-2


def _conv(rng, shape):
    kh, kw, ci, co = shape
    return rng.normal(0, np.sqrt(2.0 / (co * kh * kw)), shape).astype(np.float32)


def _image(rng, b, h, w):
    x = rng.normal(0, 1, (b, h, w, 3)).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), nchw(x, torch.bfloat16)


def _both(args):
    """Kernel/scale/bias numpy triples → (JAX args, port args)."""
    ja, ta = [], []
    for k, s, b in args:
        ja += [jnp.asarray(k), jnp.asarray(s), jnp.asarray(b)]
        ta += [oihw(k), torch.from_numpy(s), torch.from_numpy(b)]
    return ja, ta


@pytest.mark.parametrize("shape,o,relu", [(SHAPES[0], 64, True),
                                          (SHAPES[1], 16, False)])
def test_stem_conv_bn_relu_s2(shape, o, relu):
    rng = np.random.default_rng(0)
    xj, xt = _image(rng, *shape)
    ja, ta = _both([(_conv(rng, (3, 3, 3, o)), *folded_bn(rng, o))])
    want = jstem.stem_conv_bn_relu_s2(xj, *ja, relu=relu)
    got = tstem.stem_conv_bn_relu_s2(xt, *ta, relu=relu)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(nhwc(got), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_detail_s1s2_fused(shape):
    rng = np.random.default_rng(1)
    xj, xt = _image(rng, *shape)
    ja, ta = _both([(_conv(rng, (3, 3, 3, 64)), *folded_bn(rng, 64)),
                    (_conv(rng, (3, 3, 64, 64)), *folded_bn(rng, 64)),
                    (_conv(rng, (3, 3, 64, 64)), *folded_bn(rng, 64))])
    want = jstem.detail_s1s2_fused(xj, *ja, interpret=True)
    got = tstem.detail_s1s2_fused(xt, *ta)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(nhwc(got), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_stemblock_fused(shape):
    rng = np.random.default_rng(2)
    xj, xt = _image(rng, *shape)
    ja, ta = _both([(_conv(rng, (3, 3, 3, 16)), *folded_bn(rng, 16)),
                    (_conv(rng, (1, 1, 16, 8)), *folded_bn(rng, 8)),
                    (_conv(rng, (3, 3, 8, 16)), *folded_bn(rng, 16)),
                    (_conv(rng, (3, 3, 32, 16)), *folded_bn(rng, 16))])
    want = jstem.stemblock_fused(xj, *ja, interpret=True)
    got = tstem.stemblock_fused(xt, *ta)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(nhwc(got), want)


@pytest.mark.parametrize("shape,o,relu", [(SHAPES[0], 64, True),
                                          (SHAPES[1], 16, False)])
def test_stem_window_variant_matches_jax_dma(shape, o, relu):
    rng = np.random.default_rng(5)
    xj, xt = _image(rng, *shape)
    ja, ta = _both([(_conv(rng, (3, 3, 3, o)), *folded_bn(rng, o))])
    want = jstem._stem_fwd_dma(xj, ja[0], th=jstem.get_stem_th(),
                               interpret=True, scale=ja[1], bias=ja[2],
                               relu=relu)
    tstem.set_stem_variant("dma")
    try:
        assert tstem.get_stem_variant() == "dma"
        got = tstem.stem_conv_bn_relu_s2(xt, *ta, relu=relu)
    finally:
        tstem.set_stem_variant("tiles")
    window = tstem.stem_conv_bn_relu_s2_window(xt, *ta, relu=relu)
    assert torch.equal(got, window)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(nhwc(got), want)
    assert tstem.stem_conv_bn_relu_s2_window.launches == 0


def test_stem_variant_names():
    with pytest.raises(ValueError):
        tstem.set_stem_variant("tma")
    assert tstem.get_stem_variant() == "tiles"


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("relu2", [True, False])
def test_stem_s1_pair_fused(relu2, packed):
    rng = np.random.default_rng(6)
    xj, xt = _image(rng, 2, 32, 48)
    ja, ta = _both([(_conv(rng, (3, 3, 3, 64)), *folded_bn(rng, 64)),
                    (_conv(rng, (3, 3, 64, 64)), *folded_bn(rng, 64))])
    want = jstem.stem_s1_pair_fused(xj, *ja, interpret=True, relu2=relu2)
    kw = {"packed": tstem.pack_s1_pair(*ta)} if packed else {}
    got = tstem.stem_s1_pair_fused(xt, *ta, relu2=relu2, **kw)
    assert got.shape == (2, 64, 16, 24)
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(nhwc(got), want)
    assert tstem.stem_s1_pair_fused.launches == 0


def _fused_module(jcls, tcls, names, rng):
    x = rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    jm = jcls(n_bn=1, dtype=jnp.bfloat16)
    v = jm.init(jax.random.PRNGKey(0), [jnp.asarray(x, jnp.bfloat16)], train=False)
    v = randomize_variables(jax.tree_util.tree_map(np.asarray, dict(v)), rng)
    tm = tcls(n_bn=1, dtype=torch.bfloat16)
    sd = {}
    for n in names:
        sd.update(convbn_state(v["params"][n], v["batch_stats"][n], f"{n}."))
    load(tm, sd)
    counts = [k.launches for k in tstem.KERNELS]
    jl.set_stem_impl("pallas")
    jl.set_detail_fuse(True)
    tl.set_stem_impl("kernel")
    tl.set_detail_fuse(True)
    try:
        (want,) = jm.apply(v, [jnp.asarray(x, jnp.bfloat16)], train=False)
        (got,) = tm([nchw(x, torch.bfloat16)])
    finally:
        jl.set_stem_impl("plain")
        jl.set_detail_fuse(False)
        tl.set_stem_impl("plain")
        tl.set_detail_fuse(False)
    assert [k.launches for k in tstem.KERNELS] == counts  # CPU: plain path
    _close(nhwc(got), want)


def test_detail_branch_fused_matches_jax():
    _fused_module(jb.DetailBranch, tb.DetailBranch,
                  ["S1_1", "S1_2", "S2_1", "S2_2", "S2_3", "S3_1", "S3_2", "S3_3"],
                  np.random.default_rng(3))


def test_stem_block_fused_matches_jax():
    _fused_module(jb.StemBlock, tb.StemBlock, ["conv", "left_1", "left_2", "fuse"],
                  np.random.default_rng(4))


def test_wrappers_reject_other_devices():
    x = torch.empty((1, 3, 8, 8), dtype=torch.bfloat16, device="meta")
    k, s = torch.empty((16, 3, 3, 3), device="meta"), torch.empty(16, device="meta")
    with pytest.raises(ValueError):
        tstem.stem_conv_bn_relu_s2(x, k, s, s)
    assert tstem.stem_conv_bn_relu_s2.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
