"""TPU kernel 7, the DetailBranch tail (S2_2 → S2_3 → S3_1 → S3_2 → S3_3),
port against JAX on the CPU.

`detail_tail_fused_plain` (mds_tpu_torch/ops/stem.py, which defines what
csrc/detail_tail.cu computes; chip_smoke.py holds the kernel to it on the
card) against JAX's `detail_tail_fused(interpret=True)` at (B, C, H4, W4) =
(1, 64, 32, 32) and (2, 64, 16, 48) (JAX needs H4 % 16 == 0), and against
JAX's chain of five XLA convs with the kernel's rounding points (bf16(k·s),
f32 sums, + bias, ReLU, bf16 after each). Five convs, each rounded to bf16
at the same points, sums in other orders: rel < 1e-2 against the kernel,
and bit-equal on ≥ 99% of the outputs against the chain and on ≥ 98%
against the kernel, which itself matches its own chain on only 98.6% at
(2, 64, 16, 48) (its mismatches sit in one patch of the output; the port's
plain version matches the chain on 99.996% there).

Then the port's `DetailBranch` with `set_detail_fuse(True)` and
`set_detail_tail(True)` (the plain versions of kernels 4 and 7 here) against
JAX's with the same switches at (1, 64, 64, 3), BN statistics random: abs
< 0.1 and rel < 2e-2, the bounds of tests/test_torch_stem.py (eight chained
bf16 convs leave about 84% of the outputs bit-equal, as on the branch's
plain path, 81%). The tail route needs the detail fusion, is off in train()
and for H or W not divisible by 8, and launches nothing on the CPU.
"""

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
from mds_tpu_torch.ops import stem as tstem
from torch_parity import (
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

TAIL = ["S2_2", "S2_3", "S3_1", "S3_2", "S3_3"]
BRANCH = ["S1_1", "S1_2", "S2_1"] + TAIL


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


@pytest.mark.parametrize("shape", [(1, 64, 32, 32), (2, 64, 16, 48)])
def test_plain_matches_pallas(shape):
    b, c, h4, w4 = shape
    rng = np.random.default_rng(0)
    y = np.maximum(rng.normal(0, 1, (b, h4, w4, c)), 0).astype(np.float32)
    ja, ta = [], []
    for o, i in tstem._TAIL_SHAPES:
        k = rng.normal(0, np.sqrt(2.0 / (9 * o)), (3, 3, i, o)).astype(np.float32)
        s, bias = folded_bn(rng, o)
        ja += [jnp.asarray(k), jnp.asarray(s), jnp.asarray(bias)]
        ta += [oihw(k), torch.from_numpy(s), torch.from_numpy(bias)]
    yj = jnp.asarray(y, jnp.bfloat16)
    want = np.asarray(jstem.detail_tail_fused(yj, *ja, interpret=True), np.float32)
    chain = yj
    for (k, s, bias), st in zip(zip(*[iter(ja)] * 3), (1, 1, 2, 1, 1)):
        z = jax.lax.conv_general_dilated(
            chain, (k * s).astype(jnp.bfloat16), (st, st), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)
        chain = jnp.maximum(z + bias, 0.0).astype(jnp.bfloat16)
    got = tstem.detail_tail_fused(nchw(y, torch.bfloat16), *ta)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 128, h4 // 2, w4 // 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    g = nhwc(got)
    assert rel_err(g, want) < 1e-2
    assert (g == want).mean() >= 0.98
    assert (g == np.asarray(chain, np.float32)).mean() >= 0.99
    assert tstem.detail_tail_fused.launches == 0  # CPU: the plain version


def _branch_pair(h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, h, w, 3)).astype(np.float32)
    jm = jb.DetailBranch(n_bn=1, dtype=jnp.bfloat16)
    v = jax.jit(lambda k: jm.init(k, [jnp.asarray(x, jnp.bfloat16)], train=False))(
        jax.random.PRNGKey(0))
    v = randomize_variables(jax.tree_util.tree_map(np.asarray, dict(v)), rng)
    tm = tb.DetailBranch(n_bn=1, dtype=torch.bfloat16)
    sd = {}
    for n in BRANCH:
        sd.update(convbn_state(v["params"][n], v["batch_stats"][n], f"{n}."))
    load(tm, sd)
    return jm, v, tm, x


def test_detail_branch_with_tail_matches_jax():
    jm, v, tm, x = _branch_pair(64, 64, 3)
    jl.set_detail_fuse(True)
    jl.set_detail_tail(True)
    tl.set_detail_fuse(True)
    tl.set_detail_tail(True)
    try:
        (want,) = jm.apply(v, [jnp.asarray(x, jnp.bfloat16)], train=False)
        with torch.no_grad():
            (got,) = tm([nchw(x, torch.bfloat16)])
    finally:
        jl.set_detail_fuse(False)
        jl.set_detail_tail(False)
        tl.set_detail_fuse(False)
        tl.set_detail_tail(False)
    assert got.shape == (1, 128, 8, 8)
    g, want = nhwc(got), np.asarray(want, np.float32)
    assert np.abs(g - want).max() < 0.1
    assert rel_err(g, want) < 2e-2
    assert [k.launches for k in tstem.KERNELS] == [0] * len(tstem.KERNELS)


def _tail_calls(monkeypatch, tm, x, fuse=True):
    calls = []
    real = tstem.detail_tail_fused

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(tstem, "detail_tail_fused", spy)
    tl.set_detail_fuse(fuse)
    tl.set_detail_tail(True)
    try:
        with torch.no_grad():
            tm([x])
    finally:
        tl.set_detail_fuse(False)
        tl.set_detail_tail(False)
    return calls


def test_tail_route_guards(monkeypatch):
    tm = tb.DetailBranch(n_bn=1, dtype=torch.bfloat16).eval()
    x = torch.zeros((1, 3, 40, 24), dtype=torch.bfloat16)  # H4, W4 = 10, 6
    assert _tail_calls(monkeypatch, tm, x) == [(1, 64, 10, 6)]
    assert _tail_calls(monkeypatch, tm, x, fuse=False) == []
    # H = 36: divisible by 4 (the fusion runs), not by 8 (H4 = 9 is odd)
    assert _tail_calls(monkeypatch, tm, torch.zeros((1, 3, 36, 24),
                                                    dtype=torch.bfloat16)) == []
    tm.train()
    assert _tail_calls(monkeypatch, tm, x) == []
