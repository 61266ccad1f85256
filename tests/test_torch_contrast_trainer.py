"""The port's ContrastTrainer against the JAX package's, on the CPU.

The tiny contrast config (tests/torch_contrast_parity.py: 2 datasets of 5
and 7 classes, 8 unified classes with single and multiple mappings,
proj_dim 16, a bank of 8 × 4 × 16, the EMA teacher at momentum 0.9, the
contrast term off at step 0 and on from step 1), f32, dropout off on both
sides. Both start from the port's seeded init carried into JAX by its own
importer, BN randomized, the teacher a copy. JAX's trainer runs 3 steps on
batches of 4 crops of 64×64 a dataset, each image of its own brightness
and contrast, and records its state before and after each. The port's trainer takes
JAX's state before each step (`contrast_state_from_jax`: the student, its
SGD momentum and count, the teacher, the bank) and JAX's own anchor noise
for that step (`jax_step_noise`), then steps. Per step: the losses (total,
seg, contrast), every parameter group's update, the BN stats, the
teacher's state and the bank, against JAX's after the step.

Measured against the exact step (the port's in f64 from the same state;
`PYTHONPATH=.:tests python tests/test_torch_contrast_trainer.py` prints
them), worst over the 3 steps (JAX's f32 / the port's f32 against exact;
the port against JAX beside):
  losses rel: total and seg 9.4e-8 / 2.5e-8 (8.7e-8), contrast 1.4e-6 /
    2.7e-7 (1.3e-6);
  the update of each param group, rel L2 (cosine): wd 1.2e-2 (0.99993) /
    3.6e-3 (1.2e-2), nowd 3.6e-2 (0.99934) / 3.6e-2 (1.3e-2; step 0,
    where BN over each image's few /32 pixels leaves both far from the
    exact step), head_wd 1.4e-3 / 3.3e-4 (1.4e-3), head_nowd 2.5e-3 /
    2.5e-3 (4.0e-4);
  running stats, teacher (max-diff over the group's largest magnitude:
    the running means, the running variances, each param group) 1.7e-5 /
    5.6e-6 (1.8e-5) and 7.1e-6 / 1.2e-6 (7.1e-6); bank 7.0e-7 / 1.7e-7
    (7.2e-7).
Each gate sits at about twice the larger of the two: losses rel <= 2e-7
(contrast <= 3e-6); updates rel L2 <= 2.4e-2 wd, 8e-2 nowd, 3e-3 head_wd,
6e-3 head_nowd (cosine >= 0.9998, 0.998, 0.99999, 0.99999); stats <=
4e-5, teacher <= 2e-5, bank <= 1.5e-6; ptr and count exact.

Save, restore, resume and the CLI: tests/test_torch_contrast_cli.py.
`contrast.num_prototype > 1` builds and steps here; its steps against
JAX's: tests/test_torch_contrast_multiproto.py.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.engine.contrast_trainer as jct
from mds_tpu.config import Configer as JConfiger
from mds_tpu.deploy.torch_import import bisenetv2_contrast_from_torch
from mds_tpu.engine.train_state import TrainState
from mds_tpu.parallel.mesh import make_mesh
from mds_tpu_torch.config import Configer
from mds_tpu_torch.deploy.weights import (
    bisenetv2_contrast_state_dict_from_jax,
    contrast_state_from_jax,
)
from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
from torch_contrast_parity import jax_step_noise, no_jax_contrast_dropout, tiny_contrast_config
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import f64_islands, no_port_dropout, randomize_variables, seg_batch

B, HW, U = 4, 64, 8
GROUPS = ("wd", "nowd", "head_wd", "head_nowd")
# (rel L2, cosine) gates of each group's update
UPDATE_GATES = {"wd": (2.4e-2, 0.9998), "nowd": (8e-2, 0.998), "head_wd": (3e-3, 0.99999),
                "head_nowd": (6e-3, 0.99999)}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def snapshot(jt):
    """A JAX ContrastTrainer's state as numpy copies (its step donates the
    buffers)."""
    s = jt.state
    return {"params": _np(s.params), "batch_stats": _np(s.batch_stats),
            "opt_state": _np(s.opt_state), "step": int(s.step),
            "teacher": _np(jt.teacher), "bank": _np(jt.bank)}


def batch(rng):
    ims, lbs = [], []
    for n in (5, 7):
        im, lb = seg_batch(rng, B, HW, HW, n)
        ims.append(im)
        lbs.append(lb)
    return {"ims": ims, "lbs": lbs}


def start_state(cfg):
    """The variables both trainers start from: the port's seeded init
    through JAX's own importer (`bisenetv2_contrast_from_torch`), BN
    randomized. JAX's trainer would otherwise initialize its model itself,
    a compile of its own."""
    tm = ContrastTrainer(Configer(configs=cfg), work_dir="/nonexistent-unused",
                         compute_dtype=torch.float32, device="cpu").model
    sd = {k: v.numpy() for k, v in tm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats, _ = bisenetv2_contrast_from_torch(sd, n_bn=2)
    return randomize_variables({"params": params, "batch_stats": stats},
                               np.random.default_rng(0))


@pytest.fixture(scope="module")
def jax_run():
    cfg = tiny_contrast_config(cropsize=[HW, HW])
    v = start_state(cfg)
    mp = pytest.MonkeyPatch()
    no_jax_contrast_dropout(mp)
    mp.setattr(jct, "init_train_state", lambda model, tx, sample: TrainState(
        params=v["params"], batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        step=jnp.asarray(0, jnp.int32)))
    try:
        jt = jct.ContrastTrainer(JConfiger(configs=cfg), work_dir="/nonexistent-unused",
                                 compute_dtype=jnp.float32, mesh=make_mesh(1))
        rng = np.random.default_rng(1)
        runs = []
        for _ in range(3):
            pre, b = snapshot(jt), batch(rng)
            m = jt.step(b)
            runs.append((pre, b, {k: float(x) for k, x in m.items()}, snapshot(jt)))
    finally:
        mp.undo()
    return cfg, runs


def port_from(cfg, snap, work_dir, dtype=torch.float32):
    tt = ContrastTrainer(Configer(configs=cfg), work_dir=work_dir, compute_dtype=dtype,
                         device="cpu")
    state, extras = contrast_state_from_jax(
        snap["params"], snap["batch_stats"], snap["opt_state"], snap["step"],
        snap["bank"], snap["teacher"])
    if dtype == torch.float64:
        tt.model.double()
        tt.teacher.double()
    tt.load(state, extras)
    tt.bank.feats = tt.bank.feats.to(dtype)
    no_port_dropout(tt.model)
    return tt


def port_step(cfg, pre, b, work_dir, dtype=torch.float32):
    tt = port_from(cfg, pre, work_dir, dtype)
    noise = jax_step_noise(pre["step"], 2, U, [B * (HW // 8) ** 2] * 2)
    with f64_islands() if dtype == torch.float64 else contextlib.nullcontext():
        m = tt.step(b, noise=[torch.from_numpy(n).to(dtype) for n in noise])
    return tt, {k: float(x) for k, x in m.items()}


def as_numpy(tt):
    return {"model": {k: v.double().numpy() for k, v in tt.model.state_dict().items()
                      if not k.endswith("num_batches_tracked")},
            "teacher": {k: v.double().numpy() for k, v in tt.teacher.state_dict().items()
                        if not k.endswith("num_batches_tracked")},
            "bank": tt.bank.feats.double().numpy(), "ptr": tt.bank.ptr.numpy(),
            "count": tt.bank.count.numpy(), "step": tt.step_count}


def as_numpy_jax(snap):
    sd = lambda p, s: {k: v.double().numpy() for k, v in  # noqa: E731
                       bisenetv2_contrast_state_dict_from_jax(p, s).items()}
    return {"model": sd(snap["params"], snap["batch_stats"]),
            "teacher": sd(snap["teacher"]["params"], snap["teacher"]["batch_stats"]),
            "bank": np.asarray(snap["bank"].feats, np.float64), "ptr": snap["bank"].ptr,
            "count": snap["bank"].count, "step": snap["step"]}


def _group_rel(got, want, keys_by_group):
    """The worst group's max-diff over the group's largest magnitude: no
    tensor stands alone (the running mean of a 1×1 conv over BN-centred
    inputs, like a bias a train-mode BN cancels, is rounding noise)."""
    return max(max(float(np.abs(got[k] - want[k]).max()) for k in ks)
               / max(float(np.abs(want[k]).max()) for k in ks)
               for ks in keys_by_group.values())


def errors(got, want, before, groups):
    """Per param group the update's rel L2 and cosine; the running means
    and variances (two groups) and the teacher (by the same groups) as
    `_group_rel`; the bank's rel max-diff."""
    out = {}
    for g in GROUPS:
        ks = [k for k in groups if groups[k] == g]
        du = np.concatenate([(got["model"][k] - before[k]).ravel() for k in ks])
        dw = np.concatenate([(want["model"][k] - before[k]).ravel() for k in ks])
        out[g] = (float(np.linalg.norm(du - dw) / np.linalg.norm(dw)),
                  float(du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))))
    by_group = {}
    for k in want["model"]:
        by_group.setdefault(groups.get(k, k.rsplit(".", 1)[-1]), []).append(k)
    stats = {g: ks for g, ks in by_group.items() if g.startswith("running")}
    out["stats"] = _group_rel(got["model"], want["model"], stats)
    out["teacher"] = _group_rel(got["teacher"], want["teacher"], by_group)
    out["bank"] = float(np.abs(got["bank"] - want["bank"]).max() / np.abs(want["bank"]).max())
    return out


def test_steps_match_jax(jax_run, tmp_path):
    cfg, runs = jax_run
    for k, (pre, b, jm, post) in enumerate(runs):
        tt, m = port_step(cfg, pre, b, str(tmp_path))
        groups = {n: g["name"] for g in tt.optimizer.param_groups
                  for n, p in tt.model.named_parameters() if any(p is q for q in g["params"])}
        assert set(groups.values()) == set(GROUPS)
        if k == 0:  # warmup: the contrast term computed, not added
            assert m["loss"] == m["seg_loss"] and m["contrast_loss"] > 0
        else:
            assert abs(m["loss"] - m["seg_loss"] - 0.1 * m["contrast_loss"]) <= 1e-5 * m["loss"]
        for key, gate in (("loss", 2e-7), ("seg_loss", 2e-7), ("contrast_loss", 3e-6)):
            assert abs(m[key] - jm[key]) <= gate * abs(jm[key]), (k, key, m[key], jm[key])
        got, want = as_numpy(tt), as_numpy_jax(post)
        before = as_numpy_jax(pre)["model"]
        err = errors(got, want, before, groups)
        for g, (l2, cos) in UPDATE_GATES.items():
            assert err[g][0] <= l2 and err[g][1] >= cos, (k, g, err)
        assert err["stats"] <= 4e-5 and err["teacher"] <= 2e-5 and err["bank"] <= 1.5e-6, (k, err)
        np.testing.assert_array_equal(got["ptr"], want["ptr"])
        np.testing.assert_array_equal(got["count"], want["count"])
        assert got["step"] == want["step"] == k + 1
        assert tt.optimizer.count == k + 1


def test_multi_prototype_waits():
    """`contrast.num_prototype` > 1, which waited, builds and steps: the
    (U, P, D) unit slots, the remap, seg_mul_loss beside the losses (its
    steps against JAX's: tests/test_torch_contrast_multiproto.py)."""
    cfg = tiny_contrast_config()
    cfg["contrast"]["num_prototype"] = 3
    tt = ContrastTrainer(Configer(configs=cfg), work_dir="/nonexistent-unused",
                         compute_dtype=torch.float32, device="cpu")
    assert tt.P == 3 and tuple(tt.prototypes.shape) == (U, 3, 16)
    before = tt.prototypes.clone()
    m = tt.step(batch(np.random.default_rng(0)))
    assert set(m) == {"loss", "seg_loss", "seg_mul_loss", "contrast_loss"}
    assert all(np.isfinite(float(v)) for v in m.values())
    assert not torch.equal(tt.prototypes, before)


if __name__ == "__main__":
    # per step: each error of the port against JAX, of JAX against the exact
    # step and of the port against it (the measurements behind the gates)
    import tempfile

    import conftest  # noqa: F401 — JAX on the CPU

    cfg, runs = jax_run.__wrapped__()
    for k, (pre, b, jm, post) in enumerate(runs):
        tt, m = port_step(cfg, pre, b, tempfile.mkdtemp())
        t64, m64 = port_step(cfg, pre, b, tempfile.mkdtemp(), torch.float64)
        groups = {n: g["name"] for g in tt.optimizer.param_groups
                  for n, p in tt.model.named_parameters() if any(p is q for q in g["params"])}
        before = as_numpy_jax(pre)["model"]
        got, want, exact = as_numpy(tt), as_numpy_jax(post), as_numpy(t64)
        for name, (a, am), (b_, bm) in (("port vs JAX", (got, m), (want, jm)),
                                        ("JAX vs exact", (want, jm), (exact, m64)),
                                        ("port vs exact", (got, m), (exact, m64))):
            print(k, name, {key: abs(am[key] - bm[key]) / abs(bm[key]) for key in bm},
                  errors(a, b_, before, groups))
