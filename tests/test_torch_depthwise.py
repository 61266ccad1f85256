"""The port's depthwise 3×3 (mds_tpu_torch/ops/depthwise.py) against the JAX
Pallas kernels mds_tpu/ops/pallas/depthwise.py (depthwise3x3_pallas) and
depthwise_dma.py (depthwise3x3_dma) in interpret mode on the CPU.

On a CPU tensor each wrapper runs its plain version, which defines what the
CUDA kernels compute (the card-side comparison, bit for bit, lives in
chip_smoke.py; `test_window_kernel_rehearsal` runs the kernels' source on
the CPU through tools/cuda_shim/rehearse.py). Tolerances: f32 rel ≤ 1e-5 (the same products and sums in
the same order; XLA may contract a product into an FMA); bf16 rel < 1e-2,
one bf16 rounding, with ≥ 99% of the outputs bit-equal."""

import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.models import layers as jl
from mds_tpu.ops.depthwise import depthwise_conv3x3, kernel_from_hwio
from mds_tpu.ops.pallas.depthwise import depthwise3x3_pallas
from mds_tpu.ops.pallas.depthwise_dma import depthwise3x3_dma as j_dma
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import depthwise as tdw
from torch_parity import (
    convbn_state,
    interpret_pallas,
    load,
    nchw,
    nhwc,
    randomize_variables,
    rel_err,
)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _inputs(rng, b, h, w, c, m, dtype):
    """x (B, H, W, C) with some exact zeros (as after a ReLU) and a grouped
    HWIO kernel (3, 3, 1, C·m), both rounded to `dtype` as numpy f32."""
    x = rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
    x[x < -0.8] = 0.0
    k = rng.normal(0, 0.3, (3, 3, 1, c * m)).astype(np.float32)
    rnd = (lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
           ) if dtype == "bf16" else (lambda a: a)
    return rnd(x), rnd(k)


def _port(x, k, dtype):
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    w = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1))).to(tdt)
    return nchw(x, tdt), w


def _jax(x, k, c, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return jnp.asarray(x, jdt), kernel_from_hwio(jnp.asarray(k, jdt), c)


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "f32":
        assert rel_err(got, want) <= 1e-5
    else:
        assert rel_err(got, want) < 1e-2
        assert (got == want).mean() >= 0.99


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("stride,m", [(1, 1), (1, 6), (2, 1), (2, 6)])
def test_plain_matches_pallas(stride, m, dtype):
    rng = np.random.default_rng(10 * stride + m)
    b, h, w, c = 2, 17, 25, 16
    x, k = _inputs(rng, b, h, w, c, m, dtype)
    want = depthwise3x3_pallas(*_jax(x, k, c, dtype), stride)
    got = tdw.depthwise3x3(*_port(x, k, dtype), stride)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert got.shape == (b, c * m, -(-h // stride), -(-w // stride))
    _close(nhwc(got), want, dtype)


# (seed, B, H, W, C, m) of depthwise3x3_dma's cases: the first two from the
# start; then the card's TMA form at its narrowest channel run (C = 8) and
# its masked form (C = 12, C % 8 != 0 in bf16), m = 1, 2 and 6, B = 2, H and
# W off the form's tiles (4 or 1 rows of 32 columns at these widths)
_DMA_CASES = [(21, 2, 15, 19, 8, 1), (26, 2, 15, 19, 8, 6),
              (31, 2, 9, 37, 8, 2), (32, 1, 13, 70, 12, 1), (33, 2, 6, 33, 12, 6),
              (34, 1, 11, 35, 8, 6), (35, 2, 7, 45, 12, 2)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", _DMA_CASES,
                         ids=["1", "6"] + ["b{1}-h{2}-w{3}-c{4}-m{5}".format(*c)
                                           for c in _DMA_CASES[2:]])
def test_dma_plain_matches_pallas_dma(case, dtype):
    seed, b, h, w, c, m = case
    rng = np.random.default_rng(seed)
    x, k = _inputs(rng, b, h, w, c, m, dtype)
    want = j_dma(*_jax(x, k, c, dtype))
    got = tdw.depthwise3x3_dma(*_port(x, k, dtype))
    assert got.shape == (b, c * m, h, w)
    _close(nhwc(got), want, dtype)
    # the DMA variant computes kernel 9's function at stride 1
    assert torch.equal(got, tdw.depthwise3x3(*_port(x, k, dtype), 1))


def test_window_kernel_rehearsal():
    """csrc/depthwise.cu compiled for the CPU against tools/cuda_shim's
    stand-ins (a thread per CUDA thread; the TMA box copy with zero fill,
    mbarriers with transfer counts) and run through the wrappers: kernels 9
    and 10 bit for bit against the plain version, kernel 10 on its TMA form
    (ragged tiles, more tiles than one pass of the persistent blocks, B = 2,
    f32) and its masked form (C % 8 != 0)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the rehearsal compiles csrc/ with it")
    root = Path(__file__).resolve().parent.parent
    res = subprocess.run([sys.executable, str(root / "tools" / "cuda_shim" / "rehearse.py"),
                          "depthwise"], cwd=root, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    assert res.stdout.rstrip().endswith("all ok")
    assert res.stdout.count("ok  depthwise_dma") >= 17


def test_oihw_weight_mapping():
    """Output channel c·m + j of the port's OIHW (C·m, 1, 3, 3) weight is
    JAX's (3, 3, C, m)[dy, dx, c, j], both read from one grouped HWIO
    kernel (3, 3, 1, C·m); the two depthwise functions agree on it in f32."""
    rng = np.random.default_rng(3)
    c, m = 5, 3
    x, k = _inputs(rng, 1, 9, 11, c, m, "f32")
    xt, wt = _port(x, k, "f32")
    wj = np.asarray(kernel_from_hwio(jnp.asarray(k), c))
    for cc in range(c):
        for j in range(m):
            np.testing.assert_array_equal(wt[cc * m + j, 0].numpy(), wj[:, :, cc, j])
    want = depthwise_conv3x3(*_jax(x, k, c, "f32"), 2)
    assert rel_err(nhwc(tdw.depthwise3x3_plain(xt, wt, 2)), want) <= 1e-5


def _convbn_pair(rng, c_in, c_out, stride):
    """A JAX ConvBNReLU with groups == c_in and the port's holding its
    randomized variables, in eval."""
    x = rng.normal(0, 1, (1, 12, 20, c_in)).astype(np.float32)
    jm = jl.ConvBNReLU(c_out, ks=3, stride=stride, groups=c_in, n_bn=1)
    v = jm.init(jax.random.PRNGKey(0), [jnp.asarray(x)], train=False)
    v = randomize_variables(jax.tree_util.tree_map(np.asarray, dict(v)), rng)
    tm = tl.ConvBNReLU(c_in, c_out, 3, stride=stride, groups=c_in, n_bn=1)
    load(tm, convbn_state(v["params"], v["batch_stats"]))
    return x, jm, v, tm


@pytest.mark.parametrize("c_in,c_out,stride", [(8, 48, 2), (16, 16, 1)])
def test_convbnrelu_depthwise_route(monkeypatch, c_in, c_out, stride):
    """set_depthwise_impl("kernel") sends the grouped conv through
    ops/depthwise.depthwise3x3 (BN and ReLU stay in the module) and matches
    JAX's ConvBNReLU under set_depthwise_impl("pallas")."""
    x, jm, v, tm = _convbn_pair(np.random.default_rng(c_out), c_in, c_out, stride)
    calls = []
    real = tdw.depthwise3x3
    monkeypatch.setattr(tdw, "depthwise3x3",
                        lambda *a: calls.append(a[2]) or real(*a))
    jl.set_depthwise_impl("pallas")
    tl.set_depthwise_impl("kernel")
    try:
        (want,) = jm.apply(v, [jnp.asarray(x)], train=False)
        with torch.no_grad():
            (got,) = tm([nchw(x)])
    finally:
        jl.set_depthwise_impl("xla")
        tl.set_depthwise_impl("plain")
    assert calls == [stride]
    assert real.launches == 0  # CPU: the plain version
    assert rel_err(nhwc(got), want) <= 1e-5
    with torch.no_grad():
        (plain,) = tm([nchw(x)])  # the library route, same function
    assert rel_err(nhwc(plain), want) <= 1e-5
    assert not calls[1:]


def test_route_refuses_grad_and_bad_names():
    x, _, _, tm = _convbn_pair(np.random.default_rng(0), 8, 48, 2)
    tl.set_depthwise_impl("kernel")
    try:
        with pytest.raises(RuntimeError, match="no backward"):
            tm([nchw(x)])  # the weight requires grad
        with pytest.raises(RuntimeError, match="no backward"):
            tdw.depthwise3x3(nchw(x).requires_grad_(True),
                             torch.zeros(48, 1, 3, 3), 2)
    finally:
        tl.set_depthwise_impl("plain")
    tm([nchw(x)])  # the library route takes grad
    with pytest.raises(ValueError):
        tl.set_depthwise_impl("pallas")


def test_wrappers_reject_other_devices_and_shapes():
    x = torch.empty((1, 8, 6, 6), device="meta")
    w = torch.empty((16, 1, 3, 3), device="meta")
    with pytest.raises(ValueError):
        tdw.depthwise3x3(x, w, 1)
    with pytest.raises(ValueError):
        tdw.depthwise3x3_dma(x, w)
    xc, wc = torch.zeros(1, 8, 6, 6), torch.zeros(12, 1, 3, 3)
    with pytest.raises(ValueError, match="C·m"):
        tdw.depthwise3x3(xc, wc, 1)
    with pytest.raises(ValueError, match="stride"):
        tdw.depthwise3x3(xc, torch.zeros(16, 1, 3, 3), 3)
    with pytest.raises(ValueError):
        tdw.depthwise3x3(xc, torch.zeros(16, 1, 3, 3, dtype=torch.bfloat16), 1)
    assert [k.launches for k in tdw.KERNELS] == [0, 0]
