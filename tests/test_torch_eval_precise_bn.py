"""Precise BN of the port against JAX's, on the CPU.

- `recompute_bn_stats` against JAX's on the same variables and the same 2
  train batches (one loader thread: the two packages' loaders give them
  bit for bit), dropout off on both sides (JAX's masks cannot be
  reproduced). Every running mean and variance is held to JAX's as
  max-diff over the larger of the tensor's largest magnitude and that of
  the stats it started from, in two cases:
  - f32, on 4 images a dataset of 64×64 crops: within 1e-4 (measured:
    3.4e-5 at most, the CEBlock's pooled BN). The recovery
    (new − 0.9·old)/0.1 is exact only to f32 rounding of `old`: a batch
    variance of 0.003 recovered from an old one of 1.5 carries ~6e-7 of
    rounding on either side (plain rel up to 3.2e-4 on those tensors).
  - f64 end to end (the normalization, the convs and the BN moments), on
    the config's own batches (2 and 1 images of 32×32 crops): within 1e-6
    (measured: 4.7e-9). At f32 these batches cannot be compared: the /32
    maps are 1×1, each BN of that stage sees 2 values a channel and
    amplifies their difference, so rounding decides the stats. Measured
    there: the port's f32 stats against JAX's f32 part by 0.637; against
    the f64 result the port's f32 lies 0.596 off and JAX's 0.657, so f64
    supports neither; and f32 rounding of the normalized input alone
    (f32 normalization, the rest at f64) moves the f64 result by 0.657.
    At f64, a random 1e-14 relative change of the weights moves the
    port's stats by 2.2e-8 and JAX's by 1.3e-6.
- After the recompute the routes read folds of the new stats. At f32 the
  conv3 route (`set_conv3_eval_impl("kernel")`, whose convs ·scale + bias
  through `ConvBNReLU.fold_cached`) matches the plain route at rel <=
  1e-4 (measured: 2.6e-6), where its folds of the old stats miss by ~1.
  In bf16 the deploy routes' logits equal bit for bit those of a fresh
  model that holds the new stats. (Routed against plain in bf16 they part
  by 4-7% rel after 2 recompute batches, argmax 0.94-0.97: with its stats
  recomputed the random net amplifies bf16 rounding, and against an f64
  run on the same bf16 weights each path lies 3-6% off, the plain one no
  closer.)

The eval bundle and the CLI: tests/test_torch_eval_cli.py.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.engine.train_step as jts
import mds_tpu.models.layers as jl
import mds_tpu_torch.engine.train_step as tts
from mds_tpu.config import Configer as JConfiger
from mds_tpu.evaluation.drivers import recompute_bn_stats as j_recompute_bn_stats
from mds_tpu.models import bisenetv2 as jb
from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.loader import get_data_loader
from mds_tpu_torch.deploy.weights import bisenetv2_to_torch
from mds_tpu_torch.evaluation.drivers import recompute_bn_stats
from mds_tpu_torch.models.layers import ConvBNReLU, set_conv3_eval_impl
from torch_eval_parity import (  # noqa: F401 — one_torch_thread: autouse
    CFG,
    N_CLASSES,
    WEIGHT_SEED,
    deploy_routes,
    one_torch_thread,
    port_model,
)
from torch_parity import (
    as_port,
    make_variables,
    no_jax_dropout,
    no_port_dropout,
    rel_err,
)

ONE_THREAD = ["train.num_workers", "1"]
TRAIN = ONE_THREAD + ["train.cropsize", "[64, 64]", "dataset1.ims_per_gpu", "4",
                      "dataset2.ims_per_gpu", "4"]
STATS_GATE = 1e-4
F64_STATS_GATE = 1e-6


def running(sd):
    return {k: np.asarray(v, np.float64) for k, v in sd.items() if "running" in k}


def j_normalize_f64(ims, means, stds, dtype=jnp.float32):
    return [None if x is None else
            ((jnp.asarray(x, jnp.float64) / 255.0 - jnp.asarray(m, jnp.float64))
             / jnp.asarray(s, jnp.float64)).astype(dtype)
            for x, m, s in zip(ims, means, stds)]


def t_normalize_f64(ims, means, stds, dtype=torch.float32):
    return [None if x is None else
            ((x.double() / 255.0 - torch.as_tensor(np.asarray(m, np.float64)))
             / torch.as_tensor(np.asarray(s, np.float64))).to(dtype).permute(0, 3, 1, 2)
            for x, m, s in zip(ims, means, stds)]


@contextlib.contextmanager
def at_f64(monkeypatch):
    """Both packages' train forward in f64 end to end: x64 in JAX, whose BN
    reads jnp.float32 for its moments' dtype; the port's `.float()` of an
    f64 tensor left f64; the uint8 frames normalized in f64 on both sides."""
    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.float32 = jnp.float64
    monkeypatch.setattr(jl, "jnp", proxy)
    real = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float", lambda self, *a, **k: (
        self if self.dtype == torch.float64 else real(self, *a, **k)))
    monkeypatch.setattr(jts, "normalize_images", j_normalize_f64)
    monkeypatch.setattr(tts, "normalize_images", t_normalize_f64)
    with jax.enable_x64(True):
        yield


@pytest.mark.parametrize("dtype,args,gate", [
    ("f32", TRAIN, STATS_GATE),
    ("f64", ONE_THREAD, F64_STATS_GATE),  # the config's own batches
], ids=["f32-64x64-crops", "f64-config-batches"])
def test_recompute_bn_stats_matches_jax(monkeypatch, dtype, args, gate):
    params, stats = make_variables(N_CLASSES, 2, WEIGHT_SEED)
    before = running(as_port(params, stats))
    no_jax_dropout(monkeypatch)
    jdt, tdt = jnp.float32, torch.float32
    ctx = contextlib.nullcontext()
    if dtype == "f64":
        jdt, tdt = jnp.float64, torch.float64
        ctx = at_f64(monkeypatch)
    with ctx:
        jv = {"params": params, "batch_stats": stats}
        if dtype == "f64":
            jv = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jv)
        jm = jb.BiSeNetV2(n_classes=N_CLASSES, n_bn=2, aux=True, dtype=jdt)
        out = j_recompute_bn_stats(JConfiger(config_file=CFG, args_parser=args), jm, jv,
                                   2, compute_dtype=jdt)
        want = running(bisenetv2_to_torch(
            params, jax.tree_util.tree_map(np.asarray, out["batch_stats"])))

        tm = no_port_dropout(port_model((params, stats), tdt)).to(tdt)
        recompute_bn_stats(Configer(config_file=CFG, args_parser=args), tm, 2,
                           compute_dtype=tdt)
    assert not tm.training
    got = running({k: v.numpy() for k, v in tm.state_dict().items()})
    assert set(got) == set(want) and len(got) > 100
    errs = {k: np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(),
                                                     np.abs(before[k]).max())
            for k in want}
    assert max(errs.values()) <= gate, max(errs.items(), key=lambda kv: kv[1])
    assert all(np.isfinite(v).all() for v in got.values())
    # every tensor moved from the randomized stats
    assert all(rel_err(got[k], before[k]) > 1e-2 for k in got), [
        k for k in got if rel_err(got[k], before[k]) <= 1e-2]


def eval_frames():
    cfg = Configer(config_file=CFG)
    return [torch.from_numpy(next(iter(loader))["im"]).float().permute(0, 3, 1, 2)
            for loader in get_data_loader(cfg, "eval")]


def routed_logits(model, xs, routes):
    with routes(), torch.no_grad():
        return [model.eval_logits((x / 255.0 - 0.5) / 0.25, i).float()
                for i, x in enumerate(xs)]


@contextlib.contextmanager
def conv3_route():
    set_conv3_eval_impl("kernel")
    try:
        yield
    finally:
        set_conv3_eval_impl("plain")


def test_precise_bn_rebuilds_the_routes_folds():
    xs = eval_frames()
    weights = make_variables(N_CLASSES, 2, 1)
    # f32: the conv3 route against the plain one, before and after
    tm = port_model(weights)
    stale = routed_logits(tm, xs, conv3_route)
    builds = sum(m._packs.builds for m in tm.modules() if isinstance(m, ConvBNReLU))
    recompute_bn_stats(Configer(config_file=CFG, args_parser=TRAIN), tm, 1,
                       compute_dtype=torch.float32)
    plain = routed_logits(tm, xs, contextlib.nullcontext)
    routed = routed_logits(tm, xs, conv3_route)
    assert sum(m._packs.builds for m in tm.modules()
               if isinstance(m, ConvBNReLU)) == 2 * builds > 0
    for r, p, s in zip(routed, plain, stale):
        assert rel_err(r, p) <= STATS_GATE, rel_err(r, p)
        assert rel_err(s, p) > 0.5, rel_err(s, p)
    # bf16: the deploy routes after the recompute are those of a fresh model
    tm = port_model(weights, torch.bfloat16)
    stale = routed_logits(tm, xs, deploy_routes)
    recompute_bn_stats(Configer(config_file=CFG, args_parser=TRAIN), tm, 1,
                       compute_dtype=torch.bfloat16)
    fresh = port_model(weights, torch.bfloat16)
    fresh.load_state_dict(tm.state_dict())
    for r, f, s in zip(routed_logits(tm, xs, deploy_routes),
                       routed_logits(fresh, xs, deploy_routes), stale):
        assert torch.equal(r, f)
        assert rel_err(s, f) > 0.5, rel_err(s, f)
