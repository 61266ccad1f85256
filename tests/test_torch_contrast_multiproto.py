"""The contrast trainer's multi-prototype path (`contrast.num_prototype` P >
1; mds_tpu_torch/engine/contrast_trainer.py) against JAX's
(mds_tpu/engine/contrast_trainer.py:67-85, 179-240) on the CPU.

tests/test_torch_contrast_trainer.py's tiny config and start state with P
= 3 and `contrast.update_sim_thresh` 0 (so that the remap sharpens
multi-mapped pixels); the EMA teacher at momentum 0.9, f32, dropout off on
both sides. JAX's trainer runs 2 steps: step 0 inside the warmup (the seg
loss is the OHEM CE, `seg_mul_loss` computed beside it), step 1 after it
(`seg_mul_loss` takes over, the multi-label contrast term is added). Each
port step starts from JAX's state before it, its prototypes included
(`contrast_state_from_jax`), with JAX's Gumbel draw of that step as the
slot assignment's noise. Gates, at about twice the larger of JAX's and the
port's f32 distance from the port's f64 step (`PYTHONPATH=.:tests python
tests/test_torch_contrast_multiproto.py` prints them):
- losses (loss, seg_loss, seg_mul_loss, contrast_loss) rel ≤ 6e-7 (JAX's
  contrast loss lies 2.5e-7 from the exact one, the port's 3.0e-8);
- each param group's update: the gates of test_torch_contrast_trainer.py;
- the running stats ≤ 4e-5, the teacher ≤ 2e-5 (JAX's 1.7e-5 and 7.2e-6
  from exact), the bank ≤ 5e-6 (JAX's 2.3e-6 after step 1);
- the prototypes rel ≤ 2e-7 (JAX's 4.4e-8, the port's 7.4e-8).
Then the checkpoint round trip: the prototypes come back from the extras.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.engine.contrast_trainer as jct
from mds_tpu.config import Configer as JConfiger
from mds_tpu.engine.train_state import TrainState
from mds_tpu.parallel.mesh import make_mesh
from mds_tpu_torch.config import Configer
from mds_tpu_torch.deploy.weights import contrast_state_from_jax
from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
from test_torch_contrast_trainer import (
    GROUPS, HW, UPDATE_GATES, as_numpy, as_numpy_jax, batch, errors, start_state)
from test_torch_contrast_trainer import snapshot as base_snapshot
from torch_contrast_parity import no_jax_contrast_dropout, tiny_contrast_config
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import f64_islands, no_port_dropout

P = 3
LOSS_GATE = 6e-7
PROTO_GATE = 2e-7


def config():
    cfg = tiny_contrast_config(cropsize=[HW, HW])
    cfg["contrast"].update({"num_prototype": P, "update_sim_thresh": 0.0})
    return cfg


def snapshot(jt):
    snap = base_snapshot(jt)
    snap["prototypes"] = np.array(jt.prototypes)
    return snap


def jax_proto_noise(step, n_pixels):
    """The Gumbel noise of JAX's step `step`: fold_in(fold_in(PRNGKey(0),
    step), 17), uniform on [1e-20, 1)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), step), 17)
    u = jax.random.uniform(key, (n_pixels, P), jnp.float32, 1e-20, 1.0)
    return np.array(-jnp.log(-jnp.log(u) + 1e-20))


@pytest.fixture(scope="module")
def jax_run():
    cfg = config()
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
        for _ in range(2):
            pre, b = snapshot(jt), batch(rng)
            m = jt.step(b)
            runs.append((pre, b, {k: float(x) for k, x in m.items()}, snapshot(jt)))
    finally:
        mp.undo()
    return cfg, runs


def port_step(cfg, pre, b, work_dir, dtype=torch.float32):
    tt = ContrastTrainer(Configer(configs=cfg), work_dir=work_dir, compute_dtype=dtype,
                         device="cpu")
    state, extras = contrast_state_from_jax(
        pre["params"], pre["batch_stats"], pre["opt_state"], pre["step"], pre["bank"],
        pre["teacher"], pre["prototypes"])
    if dtype == torch.float64:
        tt.model.double()
        tt.teacher.double()
    tt.load(state, extras)
    tt.bank.feats = tt.bank.feats.to(dtype)
    tt.prototypes = tt.prototypes.to(dtype)
    no_port_dropout(tt.model)
    n = sum(x.shape[0] for x in b["ims"]) * (HW // 8) ** 2
    noise = torch.from_numpy(jax_proto_noise(pre["step"], n)).to(dtype)
    with f64_islands() if dtype == torch.float64 else contextlib.nullcontext():
        m = tt.step(b, proto_noise=noise)
    return tt, {k: float(x) for k, x in m.items()}


def _groups(tt):
    return {n: g["name"] for g in tt.optimizer.param_groups
            for n, p in tt.model.named_parameters() if any(p is q for q in g["params"])}


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    """Each port step from JAX's state before it: [(trainer, metrics)]."""
    cfg, runs = jax_run
    return [port_step(cfg, pre, b, str(tmp_path_factory.mktemp(f"step{k}")))
            for k, (pre, b, _, _) in enumerate(runs)]


@pytest.mark.parametrize("k", [0, 1])
def test_multi_prototype_step_matches_jax(jax_run, port_runs, k):
    cfg, runs = jax_run
    pre, b, jm, post = runs[k]
    tt, m = port_runs[k]
    assert set(m) == set(jm) == {"loss", "seg_loss", "seg_mul_loss", "contrast_loss"}
    if k == 0:  # the warmup: the OHEM seg loss, the contrast term not added
        assert m["loss"] == m["seg_loss"] != m["seg_mul_loss"]
    else:
        assert m["seg_loss"] == m["seg_mul_loss"]
        assert abs(m["loss"] - m["seg_loss"] - 0.1 * m["contrast_loss"]) <= 1e-5 * m["loss"]
    for key in jm:
        assert abs(m[key] - jm[key]) <= LOSS_GATE * abs(jm[key]), (k, key, m[key], jm[key])
    got, want = as_numpy(tt), as_numpy_jax(post)
    err = errors(got, want, as_numpy_jax(pre)["model"], _groups(tt))
    for g, (l2, cos) in UPDATE_GATES.items():
        assert err[g][0] <= l2 and err[g][1] >= cos, (k, g, err)
    assert err["stats"] <= 4e-5 and err["teacher"] <= 2e-5 and err["bank"] <= 5e-6, (k, err)
    protos = tt.prototypes.numpy()
    d = np.abs(protos - post["prototypes"]).max() / np.abs(post["prototypes"]).max()
    assert d <= PROTO_GATE
    assert not np.array_equal(post["prototypes"], pre["prototypes"])
    assert tt.step_count == k + 1


def test_checkpoint_round_trip_keeps_prototypes(jax_run, port_runs):
    cfg, _ = jax_run
    tt, _ = port_runs[1]
    assert tt.maybe_save(force=True)
    fresh = ContrastTrainer(Configer(configs=cfg), work_dir=tt.work_dir,
                            compute_dtype=torch.float32, device="cpu")
    assert fresh.prototypes.shape == (8, P, 16)
    np.testing.assert_allclose(torch.linalg.norm(fresh.prototypes, dim=-1).numpy(), 1.0,
                               rtol=1e-6)
    assert not torch.equal(fresh.prototypes, tt.prototypes)
    fresh.restore()
    assert torch.equal(fresh.prototypes, tt.prototypes)
    assert fresh.step_count == tt.step_count == 2
    assert all(torch.equal(fresh.model.state_dict()[k], v)
               for k, v in tt.model.state_dict().items())


if __name__ == "__main__":
    # per step: the port against JAX, JAX against the exact step and the
    # port against it (the measurements behind the gates)
    import tempfile

    import conftest  # noqa: F401 — JAX on the CPU

    cfg, runs = jax_run.__wrapped__()
    for k, (pre, b, jm, post) in enumerate(runs):
        tt, m = port_step(cfg, pre, b, tempfile.mkdtemp())
        t64, m64 = port_step(cfg, pre, b, tempfile.mkdtemp(), torch.float64)
        before = as_numpy_jax(pre)["model"]
        got, want, exact = as_numpy(tt), as_numpy_jax(post), as_numpy(t64)
        p32, pj, p64 = tt.prototypes.numpy(), post["prototypes"], t64.prototypes.numpy()
        for name, (a, am, ap), (b_, bm, bp) in (
                ("port vs JAX", (got, m, p32), (want, jm, pj)),
                ("JAX vs exact", (want, jm, pj), (exact, m64, p64)),
                ("port vs exact", (got, m, p32), (exact, m64, p64))):
            print(k, name, {key: abs(am[key] - bm[key]) / abs(bm[key]) for key in bm},
                  "protos", float(np.abs(ap - bp).max() / np.abs(bp).max()),
                  errors(a, b_, before, _groups(tt)))
