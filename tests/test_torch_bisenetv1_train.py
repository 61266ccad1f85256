"""BiSeNetV1's train step, port against JAX on the CPU.

- The single-BN train norm (`layers.bn_eval` in train mode) against
  `flax.linen.BatchNorm(use_running_average=False, momentum=0.9)`: the
  output and the running mean and variance after 3 updates, rel <= 1e-5;
  its gradient against JAX's, rel <= 1e-5.
- BiSeNetV1 (aux heads, f32, seeded weights and BN) in train mode: the main
  and both aux heads' logits, at full size and with up=False, and the
  updated BN stats against JAX's train-mode apply (rel <= 1e-4).
- One SGD step at (4, 64, 128), 19 classes, plain and `fused_up_loss`:
  loss, per-group gradients and parameters against JAX's
  `make_seg_loss_fn` + `sgd_param_groups`, at the gates of
  tests/test_torch_train.py (loss rel <= 1e-4, per-group gradient cosine
  >= 0.9999, per-tensor gradient rel L2 <= 2e-2, running stats <= 2e-5,
  parameters <= 1e-3). V1 has no dropout. Both JAX steps and the forward
  compile in one jit, shared by the module. The port's f32 gradient is
  also held to the exact one (the port's step in f64) at rel L2 <= 1e-2.
  Conditioning: at weight seed 1 (the case here) JAX's f32 gradient lies
  1.4e-3 from the exact one, the port's 4.2e-3; at weight seed 5 a random
  V1 of this size is ill-conditioned in f32 (JAX 4.0e-2 off the exact
  step, the port 1.1e-2), where no f32 gate against JAX holds.
- Every parameter's optimizer group against JAX's `_path_has_head` and
  `_is_wd_kernel`: V1's `conv_out*` heads are not in the lr×10 group.
- Precise BN (`engine/precise_bn.py`) on V1 against JAX's
  `update_bn_stats` over 2 batches: max-diff over the larger of the
  tensor's and its starting stats' largest magnitude <= 1e-4, as
  tests/test_torch_eval_precise_bn.py gates V2.
- `tools/train_torch.py --device cpu` on a tiny V1 config (Synthetic
  frames, 128×128 crops) for 2 steps, checkpointed and resumed, in a
  subprocess that must not import jax; `finetune_from` a V1 state_dict
  and a torchvision ResNet18 trunk.
"""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mds_tpu.engine.optim import _is_wd_kernel, _path_has_head
from mds_tpu.engine.optim import sgd_param_groups as j_sgd
from mds_tpu.engine.precise_bn import update_bn_stats as j_update_bn_stats
from mds_tpu.engine.train_step import make_seg_loss_fn as j_make_seg_loss_fn
from mds_tpu.engine.train_step import normalize_images as j_normalize_images
from mds_tpu.models import bisenetv1 as jv1
from mds_tpu_torch import MODELS
from mds_tpu_torch.deploy.weights import bisenetv1_state_dict_from_jax, load_reference_weights
from mds_tpu_torch.engine.optim import sgd_param_groups
from mds_tpu_torch.engine.precise_bn import update_bn_stats
from mds_tpu_torch.engine.train_step import make_seg_loss_fn, normalize_images
from mds_tpu_torch.models import layers as tl
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import (
    CITY_MEAN,
    CITY_STD,
    LR,
    MOM,
    WD,
    cosine,
    f64_islands,
    group_names,
    nchw,
    nhwc,
    np_tree,
    rel_err,
    seeded_variables,
    seg_batch,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, H, W = 4, 64, 128


# ---------------------------------------------------- the single-BN train norm

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flax_bn_train_norm_matches_flax(dtype):
    from flax import linen as fnn

    rng = np.random.default_rng(3)
    n = 24
    var = {"params": {"scale": rng.normal(1, 0.1, n).astype(np.float32),
                      "bias": rng.normal(0, 0.1, n).astype(np.float32)},
           "batch_stats": {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                           "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bn_j = fnn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jdt)
    bn = torch.nn.BatchNorm2d(n).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(var["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(var["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(var["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(var["batch_stats"]["var"]))
    stats = var["batch_stats"]
    for k in range(3):
        x = (rng.normal(0.3 * k, 1.0 + k, (2, 6, 10, n))).astype(np.float32)
        want, mut = bn_j.apply({"params": var["params"], "batch_stats": stats},
                               jnp.asarray(x, jdt), mutable=["batch_stats"])
        stats = mut["batch_stats"]
        with torch.no_grad():
            got = tl.bn_eval(bn, nchw(x, tdt), tdt)
        assert got.dtype == tdt
        if dtype == "float32":
            assert rel_err(nhwc(got), want) <= 1e-5
        else:  # the same f32 value rounded once: all but a few bit-equal
            assert (nhwc(got) == np.asarray(want, np.float32)).mean() > 0.99
    assert rel_err(bn.running_mean.numpy(), stats["mean"]) <= 1e-5
    assert rel_err(bn.running_var.numpy(), stats["var"]) <= 1e-5
    assert int(bn.num_batches_tracked) == 0  # BatchNorm2d's own train mode never ran

    if dtype == "float32":  # the gradient flows through the batch moments
        r = rng.normal(0, 1, x.shape).astype(np.float32)

        def j_loss(p, x):
            y, _ = bn_j.apply({"params": p, "batch_stats": stats}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * r)

        gp, gx = jax.grad(j_loss, argnums=(0, 1))(var["params"], jnp.asarray(x))
        xt = nchw(x).requires_grad_(True)
        (tl.bn_eval(bn, xt, torch.float32) * nchw(r)).sum().backward()
        assert rel_err(nhwc(xt.grad), gx) <= 1e-5
        assert rel_err(bn.weight.grad.numpy(), gp["scale"]) <= 1e-5
        assert rel_err(bn.bias.grad.numpy(), gp["bias"]) <= 1e-5


# ------------------------------------------------------------ the train step

def _schedule(_):
    return LR


@pytest.fixture(scope="module")
def case():
    """JAX BiSeNetV1 (aux, f32) with seeded weights and BN, a batch, and in
    one jit: the train-mode forward (full size and up=False) with its
    updated stats, and one SGD step of the plain and of the fused-upsample
    loss."""
    jm = jv1.BiSeNetV1(n_classes=(19,), aux=True)
    v = seeded_variables(jm, 1, [jnp.zeros((1, H, W, 3), jnp.float32)], train=True)
    im, lb = seg_batch(np.random.default_rng(6), B, H, W, 19)
    tx = j_sgd(_schedule, momentum=MOM, weight_decay=WD)

    def run(v, ims, lbs):
        xs = j_normalize_images(ims, [jnp.asarray(CITY_MEAN)], [jnp.asarray(CITY_STD)])
        fwd = {}
        for up in (True, False):
            fwd[up] = jm.apply(v, xs, train=True, up=up, mutable=["batch_stats"])
        steps = []
        for fused in (False, True):
            loss_fn = j_make_seg_loss_fn(jm, [CITY_MEAN], [CITY_STD],
                                         compute_dtype=jnp.float32, fused_up_loss=fused)
            (loss, (stats, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                v["params"], v["batch_stats"], ims, lbs, jax.random.PRNGKey(0))
            upd, _ = tx.update(grads, tx.init(v["params"]), v["params"])
            steps.append({"loss": loss, "grads": grads, "stats": stats,
                          "params": optax.apply_updates(v["params"], upd)})
        return fwd, steps

    fwd, steps = jax.jit(run)(v, [jnp.asarray(im)], [jnp.asarray(lb)])
    return v, im, lb, np_tree(fwd), np_tree(steps)


def port_model(v, dtype=torch.float32):
    tm = MODELS["bisenetv1"](n_classes=(19,), aux=True, dtype=dtype)
    return load_reference_weights(tm, bisenetv1_state_dict_from_jax(v["params"],
                                                                    v["batch_stats"]))


def test_train_outputs_match_jax(case):
    v, im, _, fwd, _ = case
    xs = normalize_images([torch.from_numpy(im)], [CITY_MEAN], [CITY_STD])
    for up in (True, False):
        tm = port_model(v).train()
        with torch.no_grad():
            out = tm(xs, up=up)
        want, mut = fwd[up]
        assert set(out) == set(want)
        got = [out["logits"][0]] + [a[0] for a in out["aux"]]
        ref = [want["logits"][0]] + [a[0] for a in want["aux"]]
        shapes = [(B, 19, H, W)] * 3 if up else [(B, 19, H // 8, W // 8),
                                                  (B, 19, H // 8, W // 8),
                                                  (B, 19, H // 16, W // 16)]
        for g, r, shape in zip(got, ref, shapes):
            assert tuple(g.shape) == shape
            assert rel_err(nhwc(g), r) <= 1e-4
        if not up:
            assert out["up_factors"] == (8, [8, 16])
        stats = bisenetv1_state_dict_from_jax(v["params"], mut["batch_stats"])
        for k, b in tm.state_dict().items():
            if "running" in k:
                assert rel_err(b.numpy(), stats[k].numpy()) <= 1e-4, k


def _port_step(v, im, lb, fused, dtype=torch.float32):
    tm = port_model(v, dtype)
    if dtype == torch.float64:
        tm.double()
    opt = sgd_param_groups(tm, _schedule, momentum=MOM, weight_decay=WD)
    loss_fn = make_seg_loss_fn(tm, [CITY_MEAN], [CITY_STD], compute_dtype=dtype,
                               fused_up_loss=fused)
    tm.train()
    with f64_islands() if dtype == torch.float64 else contextlib.nullcontext():
        loss, _ = loss_fn([torch.from_numpy(im)], [torch.from_numpy(lb)])
        loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    opt.step()
    return tm, opt, loss.item(), grads


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_up_loss"])
def test_sgd_step_matches_jax(case, fused):
    v, im, lb, _, steps = case
    j = steps[int(fused)]
    tm, opt, loss, grads = _port_step(v, im, lb, fused)
    assert abs(loss - float(j["loss"])) <= 1e-4 * abs(float(j["loss"])), (loss, j["loss"])
    jg = bisenetv1_state_dict_from_jax(j["grads"], j["stats"])
    groups = group_names(tm, opt)
    by_group = {}
    floor = 1e-3 * max(np.linalg.norm(jg[k].numpy()) for k in grads)
    for k, g in grads.items():
        a, b = g.double().numpy(), jg[k].double().numpy()
        by_group.setdefault(groups[k], ([], []))
        by_group[groups[k]][0].append(a)
        by_group[groups[k]][1].append(b)
        assert np.linalg.norm(a - b) / max(np.linalg.norm(b), floor) <= 2e-2, k
    assert set(by_group) == {"wd", "nowd"}  # no head group in V1
    for name, (a, b) in by_group.items():
        assert cosine(a, b) >= 0.9999, (name, cosine(a, b))
    want = bisenetv1_state_dict_from_jax(j["params"], j["stats"])
    for k, t in tm.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        gate = 2e-5 if "running" in k else 1e-3
        assert rel_err(t.numpy(), want[k].numpy()) <= gate, k


def test_sgd_step_near_exact(case):
    """The port's f32 gradient against its f64 one (the exact step)."""
    v, im, lb, _, _ = case
    _, _, loss, grads = _port_step(v, im, lb, False)
    _, _, loss64, exact = _port_step(v, im, lb, False, torch.float64)
    assert abs(loss - loss64) <= 1e-6 * abs(loss64)
    floor = 1e-3 * max(np.linalg.norm(g.numpy()) for g in exact.values())
    for k, g in grads.items():
        x = exact[k].numpy()
        assert np.linalg.norm(g.double().numpy() - x) / max(np.linalg.norm(x), floor) <= 1e-2, k


def test_param_groups_match_jax(case):
    """Each parameter's group: lr×10 by JAX's _path_has_head, weight decay
    by its _is_wd_kernel, on JAX's tree mapped to the port's names."""
    v = case[0]
    tm = port_model(v)
    opt = sgd_param_groups(tm, _schedule)
    groups = group_names(tm, opt)

    def leaf_group(path, leaf):
        return ("head_" if _path_has_head(path) else "") + (
            "wd" if _is_wd_kernel(path, leaf) else "nowd")

    jg = jax.tree_util.tree_map_with_path(leaf_group, v["params"])
    # the group names through the weights' own mapping: encode each leaf's
    # group as a number and carry the tree across
    codes = {"wd": 0.0, "nowd": 1.0, "head_wd": 2.0, "head_nowd": 3.0}
    coded = jax.tree_util.tree_map(lambda g, x: np.full(np.shape(x), codes[g], np.float32),
                                   jg, v["params"])
    mapped = bisenetv1_state_dict_from_jax(coded, v["batch_stats"])
    names = {c: n for n, c in codes.items()}
    want = {k: names[float(t.flatten()[0])] for k, t in mapped.items() if k in groups}
    assert want == groups
    assert not any(g.startswith("head") for g in groups.values())


def test_precise_bn_matches_jax(case):
    v = case[0]
    jm = jv1.BiSeNetV1(n_classes=(19,), aux=True)
    rng = np.random.default_rng(9)
    batches = [seg_batch(rng, B, H, W, 19)[0] for _ in range(2)]
    xs = [np.asarray(j_normalize_images([jnp.asarray(b)], [jnp.asarray(CITY_MEAN)],
                                        [jnp.asarray(CITY_STD)])[0]) for b in batches]
    fwd = jax.jit(lambda v, x: jm.apply(v, [x], train=True, mutable=["batch_stats"])[1][
        "batch_stats"])
    want = j_update_bn_stats(lambda v, x: fwd(v, x), v, xs)["batch_stats"]
    want = bisenetv1_state_dict_from_jax(v["params"], np_tree(want))
    tm = port_model(v)
    before = {k: b.clone() for k, b in tm.state_dict().items() if "running" in k}
    update_bn_stats(tm, [nchw(x) for x in xs], lambda m, x: m([x]))
    assert not tm.training
    for k, old in before.items():
        got, ref = tm.state_dict()[k], want[k]
        scale = max(ref.abs().max().item(), old.abs().max().item())
        assert (got - ref).abs().max().item() / scale <= 1e-4, k
        assert not torch.equal(got, old), k


def test_train_torch_cli_v1_on_cpu(tmp_path):
    """`tools/train_torch.py --device cpu` on BiSeNetV1 with Synthetic
    frames: 2 steps, checkpoints, a resume to 3; no jax imported."""
    work = str(tmp_path)
    over = ["dataset1.data_reader", "Synthetic", "dataset1.reader_kwargs",
            "{'n_cats': 19, 'size': [128, 256], 'length': 4}", "dataset1.ims_per_gpu", "2",
            "train.cropsize", "[128, 128]", "train.num_workers", "1",
            "train.ckpt_interval", "2", "train.log_interval", "1", "lr.max_iter", "2"]
    code = ("import sys, runpy; sys.argv = ['train_torch.py'] + sys.argv[1:]; "
            "sys.path.insert(0, 'tools'); import train_torch; "
            "t = train_torch.main(sys.argv[1:]); "
            "assert t.step == 2 and t.ckpt.all_steps() == [2], t.ckpt.all_steps(); "
            "t = train_torch.main(sys.argv[1:] + ['--max-iter', '3']); "
            "assert t.step == 3 and t.ckpt.all_steps() == [2, 3]; "
            "bad = {'jax', 'jaxlib', 'flax', 'mds_tpu'} & set(sys.modules); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"
    res = subprocess.run(
        [sys.executable, "-c", code, "--config", "configs/bisenetv1_city.json",
         "--device", "cpu", "--work-dir", work] + over,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "iter: 2/2" in res.stderr and "iter: 3/3" in res.stderr


def test_finetune_from_v1_and_a_resnet18_trunk(tmp_path):
    """The supervised trainer on V1 loads a V1 state_dict in the reference
    layout strictly, and a torchvision ResNet18 into its ContextPath's
    trunk (its fc left out, every other key untouched), as JAX's
    Trainer.finetune_from does (mds_tpu/engine/trainer.py:214-255)."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.trainer import Trainer

    cfg = Configer(config_file=os.path.join(ROOT, "configs", "bisenetv1_city.json"))
    t = Trainer(cfg, work_dir=str(tmp_path), device="cpu")
    src = MODELS["bisenetv1"](n_classes=(19,), aux=True)
    src.init_weights(torch.Generator().manual_seed(11))
    torch.save(src.state_dict(), tmp_path / "v1.pth")
    t.finetune_from(str(tmp_path / "v1.pth"))
    assert all(torch.equal(t.model.state_dict()[k], v) for k, v in src.state_dict().items())
    trunk = MODELS["bisenetv1"](n_classes=(19,), aux=True)
    trunk.init_weights(torch.Generator().manual_seed(12))
    sd = {k[len("cp.resnet."):]: v for k, v in trunk.state_dict().items()
          if k.startswith("cp.resnet.")}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 512), torch.zeros(1000)
    torch.save(sd, tmp_path / "r18.pth")
    t.finetune_from(str(tmp_path / "r18.pth"))
    for k, v in t.model.state_dict().items():
        want = trunk.state_dict()[k] if k.startswith("cp.resnet.") else src.state_dict()[k]
        assert torch.equal(v, want), k
    assert t.step == 0 and t.optimizer.count == 0
