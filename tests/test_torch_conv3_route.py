"""The conv3 route decides per dataset, as JAX's does, on the CPU.

JAX's `Conv3x3S1Fusable` (mds_tpu/models/layers.py:384-423) folds the eval
BN of every 3×3 s1 conv with C_in <= 64 under set_conv3_eval_impl("pallas")
and sends each dataset's input to the kernel on its own: bf16 and H >= 512
(on a TPU; on the CPU every input takes its fallback, the library conv in
bf16 then ·scale + bias in f32). The port's ConvBNReLU under
set_conv3_eval_impl("kernel") with two datasets, one at H = 512 and one at
H = 64: the first goes to conv3x3_bn_relu (its plain version here, which
does not round the conv before the affine: the bf16 gate of bench.py, rel
< 2e-2 and the per-pixel argmax over channels on >= 99% of the pixels),
the second takes JAX's fallback (rel < 1e-2, >= 99% bit-equal: the same
roundings, sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mds_tpu.models import layers as jl
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import conv3x3 as tc3
from torch_parity import (
    LOGITS_GATE,
    convbn_state,
    load,
    nchw,
    nhwc,
    randomize_variables,
    rel_err,
)


def test_route_decides_per_dataset(monkeypatch):
    c = 16
    rng = np.random.default_rng(4)
    xs = [rng.normal(0, 1, (1, 512, 8, c)).astype(np.float32),
          rng.normal(0, 1, (1, 64, 8, c)).astype(np.float32)]
    jm = jl.ConvBNReLU(c, 3, n_bn=2, dtype=jnp.bfloat16)
    v = jax.jit(lambda k: jm.init(k, [jnp.asarray(x) for x in xs], train=False))(
        jax.random.PRNGKey(0))
    v = randomize_variables(jax.tree_util.tree_map(np.asarray, dict(v)), rng)
    tm = tl.ConvBNReLU(c, c, 3, n_bn=2, dtype=torch.bfloat16)
    load(tm, convbn_state(v["params"], v["batch_stats"]))

    calls = []
    real = tc3.conv3x3_bn_relu

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)

    monkeypatch.setattr(tc3, "conv3x3_bn_relu", spy)
    jl.set_conv3_eval_impl("pallas")
    tl.set_conv3_eval_impl("kernel")
    try:
        want = jm.apply(v, [jnp.asarray(x, jnp.bfloat16) for x in xs], train=False)
        with torch.no_grad():
            got = tm([nchw(x, torch.bfloat16) for x in xs])
    finally:
        jl.set_conv3_eval_impl("xla")
        tl.set_conv3_eval_impl("plain")
    assert calls == [(1, c, 512, 8)]  # the H = 512 dataset alone
    g0, w0 = nhwc(got[0]), np.asarray(want[0], np.float32)
    assert rel_err(g0, w0) < LOGITS_GATE
    assert (g0.argmax(-1) == w0.argmax(-1)).mean() >= 0.99
    g1, w1 = nhwc(got[1]), np.asarray(want[1], np.float32)
    assert got[1].dtype == torch.bfloat16
    assert rel_err(g1, w1) < 1e-2 and (g1 == w1).mean() >= 0.99
