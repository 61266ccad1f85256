"""Shared helpers of the tests/test_torch_*.py parity tests: JAX variables
made non-trivial from a numpy seed, converted to the port, and compared;
the train-step runs of both packages.

  PYTHONPATH=. python tests/torch_parity.py

prints, for the train-step parity cases of tests/test_torch_train*.py, how
far JAX's f32 step and the port's f32 step each lie from the exact step
(the port's, run in f64), next to the port-vs-JAX gap the tests gate: one
JSON line per case and step."""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mds_tpu.deploy.torch_import import bisenetv2_from_torch
from mds_tpu.engine.optim import sgd_param_groups as j_sgd
from mds_tpu.engine.train_step import make_seg_loss_fn as j_make_seg_loss_fn
from mds_tpu_torch import MODELS
from mds_tpu_torch.deploy.weights import (
    bisenetv2_state_dict_from_jax,
    load_reference_weights,
)
from mds_tpu_torch.engine.checkpoints import load_train_state
from mds_tpu_torch.engine.optim import sgd_param_groups
from mds_tpu_torch.engine.train_step import make_seg_loss_fn


# the bf16 gates of bench.py:296-297, a kernel route against the plain path
ARGMAX_GATE, LOGITS_GATE = 0.995, 2e-2


def init_variables(jm, seed, *args, **kw):
    """A JAX model's variables, initialized at `args` (jit, PRNGKey(0)),
    as numpy, with non-trivial BN from numpy seed `seed`
    (randomize_variables). The BiSeNetV2 tests need JAX's own init: under
    seeded_variables' kaiming fill of every kernel their bf16 E2E frame
    maps to a single class, and a constant label map agrees with anything."""
    v = jax.jit(lambda k: jm.init(k, *args, **kw))(jax.random.PRNGKey(0))
    return randomize_variables(jax.tree_util.tree_map(np.asarray, dict(v)),
                               np.random.default_rng(seed))


def bisenetv2_pair(n_classes, n_bn, origin, jdtype, tdtype, seed, hw):
    """A JAX BiSeNetV2 without aux heads, its variables (JAX's init at a
    (1, *hw, 3) input, randomized BN from `seed`) and the port model holding
    the same weights (strict load), in eval mode."""
    from mds_tpu.models import bisenetv2 as jb

    jm = (jb.bisenetv2_origin if origin else jb.BiSeNetV2)(
        n_classes=n_classes, n_bn=n_bn, aux=False, dtype=jdtype)
    v = init_variables(jm, seed, [jnp.zeros((1, *hw, 3), jnp.float32)] * n_bn,
                       train=False)
    name = "bisenetv2_origin" if origin else "bisenetv2"
    tm = MODELS[name](n_classes=n_classes, n_bn=n_bn, aux=False, dtype=tdtype)
    load_reference_weights(tm, bisenetv2_state_dict_from_jax(v["params"],
                                                             v["batch_stats"]))
    return jm, v, tm.eval()


def interpret_pallas(monkeypatch):
    """Run every Pallas kernel that JAX traces from here on in interpret
    mode (the CPU has no Mosaic), as tests/test_pallas_depthwise.py does."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


def seeded_variables(jm, seed, *args, **kw):
    """A JAX model's variables with the tree and shapes of its own init at
    `args` (jax.eval_shape, no compile) and values from numpy seed `seed`:
    every conv kernel kaiming normal, fan-out (mds_tpu/models/layers.py
    conv_init), then non-trivial BN and biases (randomize_variables)."""
    shapes = jax.eval_shape(lambda k: jm.init(k, *args, **kw), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            kh, kw_, _, co = leaf.shape
            return rng.normal(0, np.sqrt(2.0 / (kh * kw_ * co)), leaf.shape).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)

    v = jax.tree_util.tree_map_with_path(fill, dict(shapes))
    return randomize_variables(v, rng)


def folded_bn(rng, n):
    """Folded eval-BN (scale, bias), f32 numpy, from non-trivial stats:
    gamma ~N(1, .1), beta ~N(0, .1), mean ~N(0, .1), var ~U(.5, 1.5)."""
    g, b = rng.normal(1, 0.1, n), rng.normal(0, 0.1, n)
    m, v = rng.normal(0, 0.1, n), rng.uniform(0.5, 1.5, n)
    s = g / np.sqrt(v + 1e-5)
    return s.astype(np.float32), (b - m * s).astype(np.float32)


def randomize_variables(v, rng):
    """Copy of a JAX variables tree (as numpy) with non-trivial BN: running
    mean ~N(0, 0.1), var ~U(0.5, 1.5), BN scale ~N(1, 0.1), every bias
    ~N(0, 0.1)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(x, path + (k,)) for k, x in node.items()}
        a = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf == "mean":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1, 0.1, a.shape).astype(np.float32)
        if leaf == "bias":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return walk({k: v[k] for k in v}, ())


def randomize_bn(model, seed):
    """Non-trivial running stats in every BatchNorm2d of a port model, from
    torch seed `seed`; the model in eval mode."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model.eval()


def oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def convbn_state(p, s, prefix=""):
    """One JAX ConvBNReLU's variables (shared affine) → the port's
    reference-layout keys."""
    sd = {f"{prefix}conv.weight": oihw(p["conv"]["kernel"]),
          f"{prefix}affine_weight": p["bn"]["scale"],
          f"{prefix}affine_bias": p["bn"]["bias"]}
    for i in range(np.asarray(s["bn"]["mean"]).shape[0]):
        sd[f"{prefix}bn.{i}.running_mean"] = s["bn"]["mean"][i]
        sd[f"{prefix}bn.{i}.running_var"] = s["bn"]["var"][i]
    return sd


def load(module, state):
    return load_reference_weights(module, state).eval()


def nchw(x_nhwc, dtype=torch.float32):
    """numpy NHWC → torch NCHW stored channels_last."""
    return torch.from_numpy(np.array(x_nhwc, np.float32)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t):
    """torch NCHW → numpy NHWC f32."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


# ------------------------------------------------- train-step parity helpers

LR, WD, MOM = 5e-3, 5e-4, 0.9  # configs/bisenetv2_city.json
CITY_MEAN = np.asarray([0.3257, 0.3690, 0.3223], np.float32)
CITY_STD = np.asarray([0.2112, 0.2148, 0.2115], np.float32)


def no_jax_dropout(monkeypatch):
    """Stub the JAX FastDropout to the identity (the port sets rate = 0)."""
    import mds_tpu.models.layers as jl

    monkeypatch.setattr(jl, "FastDropout",
                        lambda rate: (lambda x, deterministic=True: x))


def no_port_dropout(model):
    from mds_tpu_torch.models.layers import FastDropout

    for m in model.modules():
        if isinstance(m, FastDropout):
            m.rate = 0.0
    return model


def seg_batch(rng, b, h, w, n_classes, ignore_frac=0.05):
    """uint8 (b, h, w, 3) images and uint8 labels made as bench.py:186-189
    (classes drawn at 1/8 resolution, repeated ×8), a few pixels ignored.
    Each image gets its own brightness and contrast: images of equal global
    statistics make the CEBlock's global-pool BN (moments over the batch
    alone) divide by a near-zero spread, which amplifies rounding in its
    backward far past any tolerance."""
    gain = rng.uniform(0.2, 1.0, (b, 1, 1, 1))
    offset = rng.uniform(0, 255, (b, 1, 1, 1)) * (1 - gain)
    im = (rng.integers(0, 256, (b, h, w, 3)) * gain + offset).astype(np.uint8)
    lb8 = rng.integers(0, n_classes, (b, h // 8, w // 8))
    lb = np.repeat(np.repeat(lb8, 8, 1), 8, 2).astype(np.uint8)
    lb[rng.random(lb.shape) < ignore_frac] = 255
    return im, lb


def group_names(model, optimizer):
    """parameter name → its optimizer group's name."""
    by_id = {id(p): g["name"] for g in optimizer.param_groups for p in g["params"]}
    return {n: by_id[id(p)] for n, p in model.named_parameters()}


def cosine(a, b):
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in a])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in b])
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def make_variables(n_classes, n_bn, seed):
    """JAX (params, batch_stats) of a seeded port init, randomized."""
    tm = MODELS["bisenetv2"](n_classes=n_classes, n_bn=n_bn, aux=True)
    tm.init_weights(torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = bisenetv2_from_torch(sd, n_bn=n_bn, aux=True)
    v = randomize_variables({"params": params, "batch_stats": stats},
                            np.random.default_rng(seed + 100))
    return v["params"], v["batch_stats"]


def jax_steps(model, jdtype, ims, lbs, params, stats, schedules, fused_up_loss=False):
    """Per schedule, the JAX step records [{loss, grads, stats, params,
    opt}] (one record per schedule entry's step; `opt` the optimizer state
    after it), sharing one compile."""
    n = len(ims)
    loss_fn = j_make_seg_loss_fn(model, [CITY_MEAN] * n, [CITY_STD] * n,
                                 compute_dtype=jdtype, fused_up_loss=fused_up_loss)
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    ims = [None if x is None else jnp.asarray(x) for x in ims]
    lbs = [None if x is None else jnp.asarray(x) for x in lbs]
    out = []
    for schedule, n_steps in schedules:
        tx = j_sgd(schedule, momentum=MOM, weight_decay=WD)
        upd = jax.jit(tx.update)
        p, s, opt, rec = params, stats, tx.init(params), []
        for _ in range(n_steps):
            (loss, (s, _)), grads = vg(p, s, ims, lbs, jax.random.PRNGKey(0))
            updates, opt = upd(grads, opt, p)
            p = optax.apply_updates(p, updates)
            rec.append({"loss": float(loss), "grads": np_tree(grads),
                        "stats": np_tree(s), "params": np_tree(p), "opt": np_tree(opt)})
        out.append(rec)
    return out


@contextlib.contextmanager
def f64_islands():
    """Let `Tensor.float()` keep an f64 tensor f64, so that a port model run
    with compute_dtype=torch.float64 computes its f32 islands (train BN,
    global pool, upsample, loss) in f64 as well."""
    f = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else f(self, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = f


def port_steps(name, n_classes, n_bn, tdtype, ims, lbs, params, stats,
               schedule, n_steps, fused_up_loss=False, start=None):
    """The port's step records, from the same JAX variables, or from the
    train state `start` (engine/checkpoints.py) where given; in f64 with
    tdtype=torch.float64 (the exact step an f32 one is held to)."""
    tm = MODELS[name](n_classes=n_classes, n_bn=n_bn, aux=True, dtype=tdtype)
    no_port_dropout(tm)
    opt = sgd_param_groups(tm, schedule, momentum=MOM, weight_decay=WD)
    if start is None:
        load_reference_weights(tm, bisenetv2_state_dict_from_jax(params, stats))
    else:
        load_train_state(tm, opt, start)
    loss_fn = make_seg_loss_fn(tm, [CITY_MEAN] * n_bn, [CITY_STD] * n_bn,
                               compute_dtype=tdtype, fused_up_loss=fused_up_loss)
    t_ims = [None if x is None else torch.from_numpy(x) for x in ims]
    t_lbs = [None if x is None else torch.from_numpy(x) for x in lbs]
    rec = []
    for _ in range(n_steps):
        before = {k: p.detach().clone() for k, p in tm.named_parameters()}
        opt.zero_grad(set_to_none=True)
        tm.train()
        with f64_islands() if tdtype == torch.float64 else contextlib.nullcontext():
            loss, _ = loss_fn(t_ims, t_lbs)
            loss.backward()
        grads = {k: p.grad.clone() for k, p in tm.named_parameters()
                 if p.grad is not None}
        st = {k: b.clone() for k, b in tm.named_buffers() if "running" in k}
        opt.step()
        rec.append({"loss": loss.item(), "grads": grads, "stats": st,
                    "before": before,
                    "params": {k: p.detach().clone()
                               for k, p in tm.named_parameters()}})
    return tm, opt, rec


def jax_train_logits(model, params, stats, x):
    """JAX train-mode forward of normalized NHWC images x: the main logits
    and the 4 aux logits of dataset 0, f64 numpy NHWC. Compiled without
    XLA's excess precision, so that every op rounds to its dtype as the
    program says (by default XLA keeps fused bf16 intermediates in f32)."""
    v = jax.tree_util.tree_map(jnp.asarray, {"params": params, "batch_stats": stats})
    x = jnp.asarray(x)
    fwd = jax.jit(lambda v, x: model.apply(v, [x], train=True, mutable=["batch_stats"])[0])
    out = fwd.lower(v, x).compile(
        compiler_options={"xla_allow_excess_precision": False})(v, x)
    return [np.asarray(t, np.float64)
            for t in [out["logits"][0]] + [a[0] for a in out["aux"]]]


def port_train_logits(n_classes, dtype, params, stats, x):
    """The port's counterpart of jax_train_logits (dropout off)."""
    tm = MODELS["bisenetv2"](n_classes=n_classes, aux=True, dtype=dtype)
    load_reference_weights(tm, bisenetv2_state_dict_from_jax(params, stats))
    no_port_dropout(tm).train()
    with torch.no_grad():
        out = tm([torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2).to(dtype)])
    return [t.double().permute(0, 2, 3, 1).numpy()
            for t in [out["logits"][0]] + [a[0] for a in out["aux"]]]


def as_port(params, stats):
    """JAX trees → the port's names (numpy)."""
    return {k: v.numpy() for k, v in bisenetv2_state_dict_from_jax(params, stats).items()}


def as_numpy(rec):
    """A port step record's gradients, running stats and parameters (numpy)."""
    return {w: {k: v.double().numpy() for k, v in rec[w].items()}
            for w in ("grads", "stats", "params")}


def as_numpy_jax(rec):
    """The same of a JAX step record, under the port's names."""
    sd, g = as_port(rec["params"], rec["stats"]), as_port(rec["grads"], rec["stats"])
    return {"grads": {k: v for k, v in g.items() if "running" not in k},
            "stats": {k: v for k, v in sd.items() if "running" in k},
            "params": {k: v for k, v in sd.items() if "running" not in k}}


def step_errors(got, want):
    """Worst tensor of each kind, `got` against `want` (as_numpy layout):
    gradients as relative L2, where a tensor whose own norm is below 1e-3 of
    the largest is measured against that floor (a bias that a train-mode BN
    cancels has an exact gradient of 0); running stats and parameters as
    rel max-diff (rel_err). A gradient the other side lacks (an absent
    dataset's tensor: None on the port, zero in JAX) is skipped."""
    floor = 1e-3 * max(np.linalg.norm(v) for v in want["grads"].values())
    out = {"grads": max(
        np.linalg.norm(np.asarray(g, np.float64) - want["grads"][k])
        / max(np.linalg.norm(want["grads"][k]), floor)
        for k, g in got["grads"].items() if k in want["grads"])}
    for w in ("stats", "params"):
        out[w] = max(rel_err(v, want[w][k]) for k, v in got[w].items())
    return out


def compare_step(tm, opt, t, j):
    """The f32 gates of one step, port record t against JAX record j (see
    tests/test_torch_train.py for the reasons of each)."""
    assert abs(t["loss"] - j["loss"]) <= 1e-4 * abs(j["loss"]), (t["loss"], j["loss"])
    jg = as_port(j["grads"], j["stats"])
    groups = group_names(tm, opt)
    by_group = {}
    for k, g in t["grads"].items():
        by_group.setdefault(groups[k], ([], []))
        by_group[groups[k]][0].append(g.numpy())
        by_group[groups[k]][1].append(jg[k])
    assert set(by_group) == {"wd", "nowd", "head_wd", "head_nowd"}
    for name, (a, b) in by_group.items():
        assert cosine(a, b) >= 0.9999, (name, cosine(a, b))
    err = step_errors(as_numpy(t), as_numpy_jax(j))
    assert err["grads"] <= 2e-2, err
    assert err["stats"] <= 2e-5, err
    assert err["params"] <= 1e-3, err


def _floor_cases():
    """(name, n_classes, n_bn, ims, lbs, params, stats, n_steps) of the
    train parity tests."""
    params, stats = make_variables((19,), 1, 0)
    im, lb = seg_batch(np.random.default_rng(1), 4, 64, 128, 19)
    yield "one dataset", (19,), 1, [im], [lb], params, stats, 1
    yield "one dataset, 3 warmup-poly steps", (19,), 1, [im], [lb], params, stats, 3
    params, stats = make_variables((19, 7), 2, 5)
    rng = np.random.default_rng(6)
    (im0, lb0), (im1, lb1) = seg_batch(rng, 4, 64, 128, 19), seg_batch(rng, 4, 64, 128, 7)
    yield "two datasets", (19, 7), 2, [im0, im1], [lb0, lb1], params, stats, 1
    yield "dataset 1 absent", (19, 7), 2, [im0, None], [lb0, None], params, stats, 1


def main():
    """Each case's worst tensor per gate: port vs JAX (what the tests gate),
    JAX vs exact and port vs exact, where exact is the port's step in f64."""
    from mds_tpu.engine.lr_schedule import warmup_poly_lr as j_warm
    from mds_tpu.models import bisenetv2 as jb
    from mds_tpu_torch.engine.lr_schedule import warmup_poly_lr as t_warm

    warm = dict(power=0.9, max_iter=100, warmup_iter=2, warmup_ratio=0.1)
    for name, nc, nbn, ims, lbs, params, stats, n in _floor_cases():
        j_sched, t_sched = ((lambda _: LR), (lambda _: LR)) if n == 1 else (
            j_warm(LR, **warm), t_warm(LR, **warm))
        with pytest.MonkeyPatch.context() as mp:
            no_jax_dropout(mp)
            (jr,) = jax_steps(jb.BiSeNetV2(n_classes=nc, n_bn=nbn), jnp.float32, ims,
                              lbs, params, stats, [(j_sched, n)])
        runs = {dt: port_steps("bisenetv2", nc, nbn, dt, ims, lbs, params, stats,
                               t_sched, n)[2]
                for dt in (torch.float32, torch.float64)}
        for i in range(n):
            t, x = as_numpy(runs[torch.float32][i]), as_numpy(runs[torch.float64][i])
            j = as_numpy_jax(jr[i])
            exact = runs[torch.float64][i]["loss"]
            print(json.dumps({
                "case": name, "step": i + 1, "device": "cpu",
                "loss_rel": {"port_vs_jax": abs(runs[torch.float32][i]["loss"] - jr[i]["loss"])
                             / abs(jr[i]["loss"]),
                             "jax_vs_exact": abs(jr[i]["loss"] - exact) / abs(exact),
                             "port_vs_exact": abs(runs[torch.float32][i]["loss"] - exact)
                             / abs(exact)},
                "port_vs_jax": step_errors(t, j), "jax_vs_exact": step_errors(j, x),
                "port_vs_exact": step_errors(t, x)}), flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
