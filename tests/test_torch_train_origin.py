"""`bisenetv2_origin` (per-dataset BN affine): the port's train step
against JAX's, one f32 step on the CPU, with the gates of
tests/test_torch_train.py (see there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.models import bisenetv2 as jb
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import (
    LR,
    compare_step,
    jax_steps,
    no_jax_dropout,
    np_tree,
    port_steps,
    randomize_variables,
    seg_batch,
)

B, H, W = 4, 64, 128


def test_bisenetv2_origin_one_step():
    x0 = jnp.zeros((1, H, W, 3), jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        model = jb.bisenetv2_origin(n_classes=(19,), n_bn=1)
        v = jax.jit(lambda k: model.init(k, [x0], train=True))(jax.random.PRNGKey(0))
        v = randomize_variables(np_tree(dict(v)), np.random.default_rng(8))
        im, lb = seg_batch(np.random.default_rng(9), B, H, W, 19)
        ((j,),) = jax_steps(model, jnp.float32, [im], [lb], v["params"],
                            v["batch_stats"], [(lambda _: LR, 1)])
    tm, opt, (t,) = port_steps("bisenetv2_origin", (19,), 1, torch.float32, [im],
                               [lb], v["params"], v["batch_stats"], lambda _: LR, 1)
    assert "detail.S1_1.bn.0.weight" in t["grads"]  # per-dataset affine
    compare_step(tm, opt, t, j)
