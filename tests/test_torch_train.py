"""The port's BiSeNetV2 train step against the JAX package's, on the CPU.

Same weights (a seeded port init, converted to JAX variables and randomized
as in the serving tests), the same uint8 batch at (4, 64, 128), 19 classes,
aux heads on; dropout off on both sides (JAX FastDropout stubbed to the
identity, the port's `rate` set to 0) because the two draw different masks
by design. JAX runs `make_seg_loss_fn` + `sgd_param_groups`; the port runs
`make_seg_loss_fn` + `sgd_param_groups` of mds_tpu_torch.engine.

Tolerances. A random BiSeNetV2's gradients at this size are ill-conditioned
in f32: ReLU kinks, BN over few values and sums that cancel amplify rounding.
`PYTHONPATH=. python tests/torch_parity.py` measures how far each side's f32
step lies from the exact step (the port's, run in f64 through
`f64_islands`), worst tensor, CPU:
                     JAX vs exact     port vs exact    port vs JAX
  gradient rel L2    5.4e-3 / 1.1e-2  1.6e-3 / 5.8e-3  5.5e-3 / 1.1e-2
  stats rel max      8.6e-6 / 9.8e-6  2.9e-6 / 5.6e-6  8.3e-6 / 1.1e-5
  params rel max     5.0e-4 / 4.1e-4  1.7e-4 / 1.4e-4  5.0e-4 / 4.3e-4
(one dataset / two datasets, one step). The port-vs-JAX gap is JAX's own
f32 error: the port lies closer to the exact step than JAX does. A rel
max-diff per gradient tensor cannot be gated: one ReLU that flips at one
pixel in JAX's f32 forward (a pre-activation of 6e-6 in a head's BN) moves
single weights of that channel by 2-7% (max-diff) and the L2 norm by less.
So each gate against JAX is about twice JAX's own worst error:
  f32, one step: loss rel ≤ 1e-4; per-group gradient cosine ≥ 0.9999;
    per-tensor gradient rel L2 ≤ 2e-2; BN running stats rel ≤ 2e-5;
    parameters after the step rel ≤ 1e-3;
  f32, three warmup-poly steps: every loss rel ≤ 1e-4 (JAX vs exact 8.0e-5
    at step 3, port 8.7e-6); parameters rel ≤ 2e-2 (JAX vs exact 9.3e-3);
    the total update's direction per group, cosine ≥ 0.98 (an off-by-one
    schedule or a momentum slip moves parameters by ~10%);
and the port's f32 step is held to the exact one at about twice its own
measured error, which a step computed in a lower precision fails:
    gradient rel L2 ≤ 4e-3, stats ≤ 1e-5, parameters ≤ 5e-4, loss ≤ 1e-6.
bf16, one step: loss rel ≤ 1e-3 (measured 6e-5); per head, the port's bf16
  logits lie closer to JAX's bf16 logits than JAX's lie to its f32 ones
  (rel L2 ratio ≤ 0.75, measured 0.30-0.50; with the port's f32 islands
  computed in bf16 instead, 1.19-1.31), JAX compiled without XLA's excess
  precision so that it rounds where its program says; per group, the cosine of the port's bf16
  gradient with JAX's f32 gradient at most 0.2 below that of JAX's own bf16
  gradient (JAX's own is 0.79 in the backbone groups: bf16 backward through
  this model is chaotic, so the gradient cannot be held closer).
The optimizer alone is held to JAX exactly in test_torch_losses.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mds_tpu.engine.lr_schedule import warmup_poly_lr as j_warmup_poly_lr
from mds_tpu.models import bisenetv2 as jb
from mds_tpu.models import layers as jl
from mds_tpu_torch import MODELS
from mds_tpu_torch.deploy.weights import load_reference_weights
from mds_tpu_torch.engine.lr_schedule import warmup_poly_lr
from mds_tpu_torch.engine.optim import sgd_param_groups
from mds_tpu_torch.engine.train_step import make_seg_train_step
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import stem as tstem
from torch_parity import (
    CITY_MEAN,
    CITY_STD,
    LR,
    as_numpy,
    as_port,
    compare_step,
    cosine,
    group_names,
    jax_steps,
    jax_train_logits,
    make_variables,
    nchw,
    nhwc,
    no_jax_dropout,
    np_tree,
    port_steps,
    port_train_logits,
    randomize_variables,
    rel_err,
    seg_batch,
    step_errors,
)

B, H, W = 4, 64, 128
WARM = dict(power=0.9, max_iter=100, warmup_iter=2, warmup_ratio=0.1)


@pytest.fixture
def one_thread():
    """The test's own PyTorch work in one thread: the tier-1 run's xdist
    workers share the cores, and PyTorch's thread pools in several
    processes at once wait on each other far longer than one thread
    computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def batch():
    params, stats = make_variables((19,), 1, 0)
    im, lb = seg_batch(np.random.default_rng(1), B, H, W, 19)
    return params, stats, im, lb


@pytest.fixture(scope="module")
def f32_runs(batch):
    params, stats, im, lb = batch
    j_warm = j_warmup_poly_lr(LR, **WARM)
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        model = jb.BiSeNetV2(n_classes=(19,), n_bn=1)
        j_one, j_three = jax_steps(model, jnp.float32, [im], [lb], params, stats,
                                   [(lambda _: LR, 1), (j_warm, 3)])
    one = port_steps("bisenetv2", (19,), 1, torch.float32, [im], [lb], params,
                     stats, lambda _: LR, 1)
    three = port_steps("bisenetv2", (19,), 1, torch.float32, [im], [lb], params,
                       stats, warmup_poly_lr(LR, **WARM), 3)
    return j_one, one, j_three, three


def test_one_step_f32(f32_runs):
    j_one, (tm, opt, rec), _, _ = f32_runs
    compare_step(tm, opt, rec[0], j_one[0])


def test_one_step_f32_near_exact(batch, f32_runs, one_thread):
    """The port's f32 step against the same step in f64."""
    params, stats, im, lb = batch
    _, _, (x,) = port_steps("bisenetv2", (19,), 1, torch.float64, [im], [lb], params,
                            stats, lambda _: LR, 1)
    (t,) = f32_runs[1][2]
    assert x["grads"]["head.0.conv.conv.weight"].dtype == torch.float32  # f32 params
    assert abs(t["loss"] - x["loss"]) <= 1e-6 * abs(x["loss"]), (t["loss"], x["loss"])
    err = step_errors(as_numpy(t), as_numpy(x))
    assert err["grads"] <= 4e-3 and err["stats"] <= 1e-5 and err["params"] <= 5e-4, err


def test_three_steps_warmup_poly_f32(f32_runs):
    _, _, j_three, (tm, opt, rec) = f32_runs
    assert opt.count == 3
    for t, j in zip(rec, j_three):
        assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"])
    js = as_port(j_three[-1]["params"], j_three[-1]["stats"])
    groups = group_names(tm, opt)
    start = rec[0]["before"]
    by_group = {}
    for k, v in rec[-1]["params"].items():
        assert rel_err(v.numpy(), js[k]) <= 2e-2, (k, rel_err(v.numpy(), js[k]))
        by_group.setdefault(groups[k], ([], []))
        by_group[groups[k]][0].append((v - start[k]).numpy())
        by_group[groups[k]][1].append(js[k] - start[k].numpy())
    for name, (a, b) in by_group.items():  # the total update's direction
        assert cosine(a, b) >= 0.98, (name, cosine(a, b))
    # the schedule really changed the step size: warmup, then poly
    lrs = [warmup_poly_lr(LR, **WARM)(i) for i in range(3)]
    assert lrs[0] < lrs[1] < lrs[2]


def test_one_step_bf16(batch, f32_runs):
    """bf16 on both sides, each held to the JAX f32 gradient: per group, the
    port's bf16 gradient is as close to it as JAX's bf16 gradient is."""
    params, stats, im, lb = batch
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        model = jb.BiSeNetV2(n_classes=(19,), n_bn=1, dtype=jnp.bfloat16)
        ((j,),) = jax_steps(model, jnp.bfloat16, [im], [lb], params, stats,
                            [(lambda _: LR, 1)])
    tm, opt, (t,) = port_steps("bisenetv2", (19,), 1, torch.bfloat16, [im], [lb],
                               params, stats, lambda _: LR, 1)
    assert abs(t["loss"] - j["loss"]) <= 1e-3 * abs(j["loss"]), (t["loss"], j["loss"])
    jg = as_port(j["grads"], j["stats"])
    ref = as_port(f32_runs[0][0]["grads"], f32_runs[0][0]["stats"])
    groups = group_names(tm, opt)
    for name in ("wd", "nowd", "head_wd", "head_nowd"):
        ks = [k for k in t["grads"] if groups[k] == name]
        c_port = cosine([t["grads"][k].numpy() for k in ks], [ref[k] for k in ks])
        c_jax = cosine([jg[k] for k in ks], [ref[k] for k in ks])
        assert c_port >= c_jax - 0.2, (name, c_port, c_jax)


def test_bf16_logits_round_like_jax(batch):
    """Train-mode forward in bf16: per head, the port's logits against JAX's
    bf16 logits, relative L2, at most 0.75 of JAX's bf16 logits against its
    f32 ones: the port rounds where JAX does (f32 BN, pool, upsample)."""
    params, stats, im, _ = batch
    x = ((im.astype(np.float32) / 255.0 - CITY_MEAN) / CITY_STD).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        j32, j16 = (jax_train_logits(jb.BiSeNetV2(n_classes=(19,), n_bn=1, dtype=dt),
                                     params, stats, x)
                    for dt in (jnp.float32, jnp.bfloat16))
    t16 = port_train_logits((19,), torch.bfloat16, params, stats, x)
    for name, t, j, ref in zip(("main", "aux2", "aux3", "aux4", "aux5_4"), t16, j16, j32):
        port_gap = np.linalg.norm(t - j) / np.linalg.norm(j)
        jax_err = np.linalg.norm(j - ref) / np.linalg.norm(ref)
        assert port_gap <= 0.75 * jax_err, (name, port_gap, jax_err)


# ------------------------------------------------------------- the layers


@pytest.mark.parametrize("shape", [(2, 6, 5, 16), (1, 1, 1, 16)])
def test_dataset_norm_train_matches_jax(shape):
    """Batch moments, biased normalizing variance, running stats by
    momentum 0.1 with the unbiased factor cnt/max(cnt−1, 1) — one image of
    1×1 (the CEBlock's GAP BN) included — and the input gradient."""
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = rng.normal(0.5, 2.0, shape).astype(np.float32)
    r = rng.normal(0, 1, shape).astype(np.float32)
    jm = jl.DatasetNorm(c, n_bn=2, shared_affine=False)
    v = jm.init(jax.random.PRNGKey(0), [x, x], train=False)
    v = randomize_variables(np_tree(dict(v)), rng)
    jv = jax.tree_util.tree_map(jnp.asarray, v)

    def f(x):
        y, mut = jm.apply(jv, [None, x], train=True, mutable=["batch_stats"])
        return jnp.sum(y[1] * r), mut["batch_stats"]

    (_, new), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))

    tm = tl.DatasetNorm(c, n_bn=2, affine=True)
    sd = {}
    for i in range(2):
        sd[f"{i}.running_mean"] = v["batch_stats"]["mean"][i]
        sd[f"{i}.running_var"] = v["batch_stats"]["var"][i]
        sd[f"{i}.weight"] = v["params"]["scale"][i]
        sd[f"{i}.bias"] = v["params"]["bias"][i]
    load_reference_weights(tm, sd)
    tm.train()
    tx = nchw(x).requires_grad_(True)
    (none, y) = tm([None, tx])
    (y * nchw(r)).sum().backward()
    assert none is None
    for i in range(2):  # dataset 0 was absent: its stats do not move
        assert rel_err(tm[i].running_mean.numpy(), new["mean"][i]) <= 1e-5
        assert rel_err(tm[i].running_var.numpy(), new["var"][i]) <= 1e-5
    assert rel_err(nhwc(tx.grad), gx) <= 1e-4


def test_channel_multiplier_conv_equals_grouped_conv():
    """ConvBNReLU runs groups == in_chan < out_chan as repeat_interleave +
    depthwise conv: output, weight and input gradients equal the grouped
    F.conv2d's (f32)."""
    rng = np.random.default_rng(0)
    for stride in (1, 2):
        m = tl.ConvBNReLU(16, 96, 3, stride=stride, groups=16)
        x = torch.from_numpy(rng.normal(0, 1, (2, 16, 12, 10)).astype(np.float32))
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
        r = torch.from_numpy(rng.normal(0, 1, (2, 96, 12 // stride, 10 // stride))
                             .astype(np.float32))
        got = m._conv(x)
        (got * r).sum().backward()
        gx, gw = x.grad.clone(), m.conv.weight.grad.clone()
        x.grad, m.conv.weight.grad = None, None
        want = F.conv2d(x, m.conv.weight, None, stride, 1, 1, 16)
        (want * r).sum().backward()
        torch.testing.assert_close(got, want)
        torch.testing.assert_close(gx, x.grad)
        torch.testing.assert_close(gw, m.conv.weight.grad)
        assert got.is_contiguous(memory_format=torch.channels_last)
    assert {k for k, _ in m.named_parameters()} == {
        "conv.weight", "affine_weight", "affine_bias"}


def test_fused_routes_off_in_train(monkeypatch):
    """With set_stem_impl("kernel") and set_detail_fuse(True), train() takes
    the plain convs with batch-moment BN; eval() takes the fused routes."""
    calls = []
    for name in ("stem_conv_bn_relu_s2", "detail_s1s2_fused", "stemblock_fused"):
        real = getattr(tstem, name)
        monkeypatch.setattr(tstem, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    tm = MODELS["bisenetv2"](n_classes=(5,), aux=True, dtype=torch.bfloat16)
    tm.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 32, 64).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    tl.set_stem_impl("kernel")
    tl.set_detail_fuse(True)
    try:
        tm.train()
        out = tm([x], generator=torch.Generator().manual_seed(0))
        assert calls == []
        assert len(out["aux"]) == 4 and out["logits"][0].shape == (2, 5, 32, 64)
        bn = tm.detail.S1_1.bn[0]
        assert not torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
        tm.eval()
        with torch.no_grad():
            out = tm([x])
        assert set(calls) == {"detail_s1s2_fused", "stemblock_fused"}
        assert "aux" not in out
        tl.set_detail_fuse(False)
        with torch.no_grad():
            tm.eval_logits(x)
        assert "stem_conv_bn_relu_s2" in calls
    finally:
        tl.set_stem_impl("plain")
        tl.set_detail_fuse(False)


def test_train_step_runs_with_dropout(one_thread):
    """The step with dropout on (plain version on the CPU): finite loss,
    parameters and BN stats move, and the generator decides the masks: the
    same seed gives the same losses (to the CPU's run-to-run rounding),
    another seed other ones."""
    im, lb = seg_batch(np.random.default_rng(5), B, H, W, 19)
    losses = []
    for seed in (7, 7, 8):
        tm = MODELS["bisenetv2"](n_classes=(19,), aux=True)
        tm.init_weights(torch.Generator().manual_seed(0))
        opt = sgd_param_groups(tm, warmup_poly_lr(LR, **WARM))
        step = make_seg_train_step(tm, opt, [CITY_MEAN], [CITY_STD],
                                   compute_dtype=torch.float32)
        w0 = tm.head[0].conv.conv.weight.detach().clone()
        m0 = tm.head[0].conv.bn[0].running_mean.clone()
        gen = torch.Generator().manual_seed(seed)
        metrics = [step([torch.from_numpy(im)], [torch.from_numpy(lb)], gen)
                   for _ in range(2)]
        assert all(torch.isfinite(m["loss"]) for m in metrics)
        assert not torch.equal(w0, tm.head[0].conv.conv.weight)
        assert not torch.equal(m0, tm.head[0].conv.bn[0].running_mean)
        losses.append([float(m["loss"]) for m in metrics])
    same, other = np.asarray(losses[1]), np.asarray(losses[2])
    np.testing.assert_allclose(losses[0], same, rtol=1e-6)
    assert np.abs(other - same).min() > 1e-4 * same.max()
