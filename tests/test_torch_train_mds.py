"""The port's train step against JAX's with two datasets (n_bn=2, 19 and 7
classes), f32 on the CPU, with the gates of tests/test_torch_train.py (see
there): once with both present and once with dataset 1 absent, whose heads
and BN statistics must not move."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.models import bisenetv2 as jb
from mds_tpu_torch.deploy.weights import bisenetv2_state_dict_from_jax
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import (
    LR,
    compare_step,
    jax_steps,
    make_variables,
    no_jax_dropout,
    port_steps,
    seg_batch,
)

B, H, W = 4, 64, 128


@pytest.mark.parametrize("absent", [False, True])
def test_two_datasets(absent):
    params, stats = make_variables((19, 7), 2, 5)
    rng = np.random.default_rng(6)
    (im0, lb0), (im1, lb1) = seg_batch(rng, B, H, W, 19), seg_batch(rng, B, H, W, 7)
    ims = [im0, None if absent else im1]
    lbs = [lb0, None if absent else lb1]
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        model = jb.BiSeNetV2(n_classes=(19, 7), n_bn=2)
        ((j,),) = jax_steps(model, jnp.float32, ims, lbs, params, stats,
                            [(lambda _: LR, 1)])
    tm, opt, (t,) = port_steps("bisenetv2", (19, 7), 2, torch.float32, ims, lbs,
                               params, stats, lambda _: LR, 1)
    compare_step(tm, opt, t, j)
    heads1 = [k for k in t["before"] if k.split(".")[1:2] == ["1"]
              and k.split(".")[0] in ("head", "aux2", "aux3", "aux4", "aux5_4")]
    assert heads1
    moved = [k for k in heads1 if not torch.equal(t["before"][k], t["params"][k])]
    bn1 = [k for k in t["stats"] if ".bn.1." in k]
    assert bn1
    if absent:
        assert moved == [] and not any(k in t["grads"] for k in heads1)
        loaded = bisenetv2_state_dict_from_jax(params, stats)
        for k in bn1:  # every dataset-1 running stat is still the loaded one
            assert torch.equal(t["stats"][k], loaded[k]), k
    else:
        assert sorted(moved) == sorted(heads1)
