"""The port's losses, LR schedules and optimizer against the JAX package's,
on the CPU, each alone (no model, so no rounding chaos):

- OhemCELoss / MdsOhemCELoss on NCHW logits against JAX's on NHWC: against
  `exact=True` rel ≤ 1e-6 (same rule, f32 on both sides), against the
  default 8-way bisection rel ≤ 1e-5 (its cutoff is within 2.4e-7 nat of the
  exact one); the n_min branch is covered by a batch where few pixels exceed
  the threshold; the gradient wrt the logits rel ≤ 1e-5;
- the four LR schedules over steps 0-2000, within 1e-5 of the value or 1e-6
  of lr_start: JAX computes in f32, so its gamma**k carries k times gamma's
  f32 rounding (8.6e-6 at k = 666) and a poly tail near 0 its cancellation;
- GroupSGD against `sgd_param_groups` with the same gradients over three
  warmup-poly steps, including an unused (all-zero) gradient and a None
  one: parameters rel ≤ 1e-6;
- `cross_entropy_upsampled` against JAX's at f = 1-8, odd head sizes and
  ignored pixels: the phase-major CE as a sorted multiset of the valid
  pixels, f32 rel ≤ 1e-5 (measured ≤ 1e-7: the same blends in the same
  order), and the full-size bilinear upsample's CE likewise;
  `OhemCELoss.upsampled` and its gradient wrt the logits against
  `jax.grad` of JAX's, rel ≤ 1e-4, equal to `OhemCELoss` at f = 1;
- AdamW against `optax.adamw` (JAX's `build_optimizer` for `optim` adamw)
  over three warmup-poly steps: parameters rel ≤ 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mds_tpu.deploy.torch_import import bisenetv2_from_torch
from mds_tpu.engine import lr_schedule as jsched
from mds_tpu.engine.optim import sgd_param_groups as j_sgd
from mds_tpu.losses.ohem_ce import MdsOhemCELoss as JMds
from mds_tpu.losses.ohem_ce import OhemCELoss as JOhem
from mds_tpu_torch import MODELS
from mds_tpu_torch.engine import lr_schedule as tsched
from mds_tpu_torch.engine.optim import AdamW, param_groups, sgd_param_groups
from mds_tpu_torch.losses.ohem_ce import MdsOhemCELoss, OhemCELoss, cross_entropy_upsampled
from torch_parity import as_port, make_variables, rel_err


def _case(seed, shape, n_classes, easy):
    """Logits (NHWC numpy) and uint8 labels; `easy` makes most pixels
    confident and right, so fewer than n_min exceed −log(0.7)."""
    rng = np.random.default_rng(seed)
    lb = rng.integers(0, n_classes, shape).astype(np.uint8)
    lg = rng.normal(0, 1, shape + (n_classes,)).astype(np.float32)
    if easy:
        lg += 8.0 * np.eye(n_classes, dtype=np.float32)[lb]
        hard = rng.random(shape) < 0.01
        lg[hard] = rng.normal(0, 1, (hard.sum(), n_classes))
    lb[rng.random(shape) < 0.05] = 255
    return lg, lb


def _port(lg):
    return torch.from_numpy(lg).permute(0, 3, 1, 2).requires_grad_(True)


@pytest.mark.parametrize("easy", [False, True])
def test_ohem_ce_matches_jax(easy):
    lg, lb = _case(0, (2, 40, 48), 19, easy)
    thresh = -np.log(0.7)
    ce = None
    for exact, tol in ((True, 1e-6), (False, 1e-5)):
        f = lambda x: JOhem(0.7, exact=exact)(x, jnp.asarray(lb).astype(jnp.int32))  # noqa: E731
        want, gwant = jax.value_and_grad(f)(jnp.asarray(lg))
        x = _port(lg)
        got = OhemCELoss(0.7)(x, torch.from_numpy(lb))
        got.backward()
        assert rel_err(got.detach().numpy(), want) <= tol, (exact, float(got), float(want))
        assert rel_err(x.grad.permute(0, 2, 3, 1).numpy(), gwant) <= 1e-5
        if ce is None:
            from mds_tpu_torch.losses.ohem_ce import cross_entropy_per_pixel

            ce, valid = cross_entropy_per_pixel(x.detach(), torch.from_numpy(lb))
    n_above = int(((ce > thresh) & valid).sum())
    n_min = int(valid.sum()) // 16
    assert (n_above < n_min) == easy  # both branches of the rule are taken


@pytest.mark.parametrize("easy", [False, True])
def test_mds_ohem_ce_matches_jax(easy):
    (lg0, lb0), (lg1, lb1) = _case(1, (2, 16, 24), 19, easy), _case(2, (1, 16, 24), 7, False)
    lbs = [jnp.asarray(lb0).astype(jnp.int32), None, jnp.asarray(lb1).astype(jnp.int32)]
    want = JMds(0.7, exact=True)([jnp.asarray(lg0), None, jnp.asarray(lg1)], lbs)
    got = MdsOhemCELoss(0.7)([_port(lg0), None, _port(lg1)],
                             [torch.from_numpy(lb0), None, torch.from_numpy(lb1)])
    assert rel_err(got.detach().numpy(), want) <= 1e-6


@pytest.mark.parametrize("name,args", [
    ("warmup_poly_lr", dict(lr_start=5e-3, power=0.9, max_iter=1500,
                            warmup_iter=1000, warmup_ratio=0.1)),
    ("warmup_poly_lr", dict(lr_start=1e-2, power=1.2, max_iter=3000,
                            warmup_iter=100, warmup_ratio=5e-4, warmup="linear")),
    ("warmup_exp_lr", dict(lr_start=1e-2, gamma=0.999, interval=3,
                           warmup_iter=200)),
    ("warmup_cosine_lr", dict(lr_start=1e-2, max_iter=1800, eta_ratio=0.05,
                              warmup_iter=300, warmup_ratio=0.01)),
    ("warmup_step_lr", dict(lr_start=1e-2, milestones=[700, 300, 1200],
                            gamma=0.5, warmup_iter=100)),
])
def test_lr_schedules_match_jax(name, args):
    steps = np.arange(0, 2001)
    want = np.asarray(jax.jit(jax.vmap(getattr(jsched, name)(**args)))(steps))
    fn = getattr(tsched, name)(**args)
    got = np.asarray([fn(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * args["lr_start"])


def test_unknown_warmup_mode_raises():
    with pytest.raises(ValueError, match="warmup"):
        tsched.warmup_poly_lr(1e-2, 0.9, 100, warmup="cubic")


def test_group_sgd_matches_jax():
    """Three steps at warmup-poly LR from the same gradients, with an
    all-zero gradient on aux2's conv2 in steps 1-2 and a None one on aux3's
    in step 2 (unused: momentum kept, no decay, no move); the 4 groups split
    as JAX's masks do."""
    params, stats = make_variables((19,), 1, 2)
    tm = MODELS["bisenetv2"](n_classes=(19,), aux=True)
    names = [k for k, _ in tm.named_parameters()]
    sd = as_port(params, stats)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=False)
    rng = np.random.default_rng(3)
    grads = [{k: rng.normal(0, 1, sd[k].shape).astype(np.float32) for k in names}
             for _ in range(3)]
    for g in grads[1:]:
        g["aux2.0.conv2.weight"][:] = 0.0
    j_sched = jsched.warmup_poly_lr(5e-3, 0.9, 100, warmup_iter=2, warmup_ratio=0.1)
    tx = j_sgd(j_sched, momentum=0.9, weight_decay=5e-4)
    opt = sgd_param_groups(tm, tsched.warmup_poly_lr(5e-3, 0.9, 100, warmup_iter=2,
                                                     warmup_ratio=0.1))
    p, st = jax.tree_util.tree_map(jnp.asarray, params), tx.init(params)
    for step, g in enumerate(grads):
        jg, _ = bisenetv2_from_torch({**sd, **g}, n_bn=1, aux=True)
        if step == 2:  # None on the port ⇔ zero in JAX
            jg["aux3_0"]["conv_out"]["kernel"] = np.zeros_like(
                jg["aux3_0"]["conv_out"]["kernel"])
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, jg), st, p)
        p = optax.apply_updates(p, upd)
        for k, v in tm.named_parameters():
            v.grad = None if (step == 2 and k == "aux3.0.conv2.weight") \
                else torch.from_numpy(g[k])
        opt.step()
        if step == 0:
            after0 = tm.aux2[0].conv2.weight.detach().clone()
    assert opt.count == 3
    want = as_port(jax.tree_util.tree_map(np.asarray, p), stats)
    for k, v in tm.named_parameters():
        assert rel_err(v.detach().numpy(), want[k]) <= 1e-6, k
    # unused steps leave the parameter where the last used step put it
    assert torch.equal(after0, tm.aux2[0].conv2.weight)
    groups = {g["name"]: g for g in param_groups(tm, 5e-4, 10.0)}
    assert groups["head_wd"]["lr_mul"] == 10.0 and groups["wd"]["weight_decay"] == 5e-4
    assert groups["nowd"]["weight_decay"] == 0.0 == groups["head_nowd"]["weight_decay"]
    assert all(p.ndim == 4 for p in groups["wd"]["params"] + groups["head_wd"]["params"])


@pytest.mark.parametrize("lr, error", [
    ({"optim": "rmsprop"}, "rmsprop"),
    ({"nesterov": True}, "Nesterov"),
])
def test_build_optimizer_refuses_what_the_port_lacks(lr, error):
    """The config's SGD settings reach the groups; an unknown optimizer and
    Nesterov momentum are not in the port and raise instead of training
    otherwise."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.optim import build_optimizer

    tm = MODELS["bisenetv2"](n_classes=(19,), aux=True)
    base = {"momentum": 0.8, "weight_decay": 1e-4, "lr_mul": 5.0}
    opt = build_optimizer(Configer(configs={"lr": base}), tm, lambda _: 1e-2)
    assert opt.momentum == 0.8
    assert {g["name"]: (g["weight_decay"], g["lr_mul"]) for g in opt.param_groups} == {
        "wd": (1e-4, 1.0), "nowd": (0.0, 1.0), "head_wd": (1e-4, 5.0),
        "head_nowd": (0.0, 5.0)}
    with pytest.raises(ValueError, match=error):
        build_optimizer(Configer(configs={"lr": {**base, **lr}}), tm, lambda _: 1e-2)


@pytest.mark.parametrize("f", range(1, 9))
def test_cross_entropy_upsampled_matches_jax(f):
    from mds_tpu.losses.ohem_ce import cross_entropy_per_pixel as j_ce
    from mds_tpu.losses.ohem_ce import cross_entropy_upsampled as j_ce_up

    rng = np.random.default_rng(f)
    b, hs, ws, c = 2, 3 + f % 2, 5, 7
    lg = rng.normal(0, 2, (b, hs, ws, c)).astype(np.float32)
    lb = rng.integers(0, c, (b, hs * f, ws * f)).astype(np.uint8)
    lb[rng.random(lb.shape) < 0.1] = 255
    ce, valid = cross_entropy_upsampled(_port(lg).detach(), torch.from_numpy(lb), f)
    assert ce.shape == valid.shape == (f * f, b, hs, ws)
    jce, jvalid = j_ce_up(jnp.asarray(lg), jnp.asarray(lb).astype(jnp.int32), f)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    got = np.sort(ce[valid].numpy())
    assert rel_err(got, np.sort(np.asarray(jce)[np.asarray(jvalid)])) <= 1e-5
    # the multiset of the full-size volume's CE
    up = jax.image.resize(jnp.asarray(lg), (b, hs * f, ws * f, c), "linear")
    fce, fvalid = j_ce(up, jnp.asarray(lb).astype(jnp.int32))
    assert rel_err(got, np.sort(np.asarray(fce)[np.asarray(fvalid)])) <= 1e-5
    with pytest.raises(ValueError, match="labels"):
        cross_entropy_upsampled(_port(lg).detach(), torch.from_numpy(lb[:, 1:]), f)


@pytest.mark.parametrize("f, easy", [(1, False), (2, True), (4, False), (8, False), (8, True)])
def test_ohem_upsampled_and_its_gradient_match_jax(f, easy):
    lg, lb = _case(10 + f, (2, 6, 5), 19, easy)  # `easy`: logits right, confident
    lb = np.repeat(np.repeat(lb, f, 1), f, 2)
    lb[np.random.default_rng(f).random(lb.shape) < 0.05] = 255
    fn = lambda x: JOhem(0.7, exact=True).upsampled(  # noqa: E731
        x, jnp.asarray(lb).astype(jnp.int32), f)
    want, gwant = jax.value_and_grad(fn)(jnp.asarray(lg))
    x = _port(lg)
    got = OhemCELoss(0.7).upsampled(x, torch.from_numpy(lb), f)
    got.backward()
    assert rel_err(got.detach().numpy(), want) <= 1e-4, (float(got), float(want))
    assert rel_err(x.grad.permute(0, 2, 3, 1).numpy(), gwant) <= 1e-4
    if f == 1:
        assert torch.equal(got, OhemCELoss(0.7)(x, torch.from_numpy(lb)))


def test_adamw_matches_optax():
    from mds_tpu.config import Configer as JConfiger
    from mds_tpu.engine.optim import build_optimizer as j_build
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.optim import build_optimizer

    rng = np.random.default_rng(0)
    shapes = {"conv": (8, 4, 3, 3), "bias": (8,), "fc": (5, 8)}
    p0 = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 1e-2 * (i + 1), s).astype(np.float32)
              for k, s in shapes.items()} for i in range(3)]
    grads[1]["bias"][:] = 0.0  # a zero gradient still decays and moves
    warm = dict(power=0.9, max_iter=10, warmup_iter=2, warmup_ratio=0.1)
    cfg = {"lr": {"optim": "adamw", "weight_decay": 1e-2}}
    tx = j_build(JConfiger(configs=cfg), jsched.warmup_poly_lr(1e-3, **warm))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)

    class Params(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in p0.items():
                self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    tm = Params()
    opt = build_optimizer(Configer(configs=cfg), tm, tsched.warmup_poly_lr(1e-3, **warm))
    assert isinstance(opt, AdamW) and opt.weight_decay == 1e-2
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tm.named_parameters():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tm.named_parameters():
            assert rel_err(p.detach().numpy(), jp[k]) <= 1e-6, k
            # the update itself, not only the parameter it lands on
            assert rel_err(p.detach().numpy() - p0[k], np.asarray(jp[k]) - p0[k]) <= 1e-5, k
    assert opt.count == 3
