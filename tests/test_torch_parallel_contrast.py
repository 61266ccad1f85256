"""The pixel-contrast trainer (mds_tpu_torch/engine/contrast_trainer.py) and
its global pieces at world size 2 on the CPU.

Two gloo ranks run as subprocesses that import only the port
(tests/torch_parallel_trainers.py), in one launch for the file, while the
parent runs the same functions without a group (the world-1 side) and, in
a thread, JAX's `ContrastTrainer(mesh=make_mesh(2))` (tests/conftest.py
gives JAX 8 CPU devices).

The trainer: tests/torch_contrast_parity.py's tiny contrast config (2
datasets of 5 and 7 classes, 8 unified classes, proj_dim 16, a bank of
8 × 4 × 16, the EMA teacher at momentum 0.9) at `contrast.num_prototype`
1 and 2 (`update_sim_thresh` 0, so that the remap sharpens multi-mapped
pixels), from its seeded init, dropout on, 2 steps: step 0 inside the
warmup, step 1 after it. 4 crops of 64×64 a dataset, rows 0-1 on rank 0,
2-3 on rank 1, the halves' pixel values apart. Gates:
- f64 world 2 against world 1 on the concatenated batch: every loss,
  parameter, running stat, SGD momentum and teacher tensor rel ≤ 1e-10,
  over the larger of its own magnitude and 1e-3 of the largest of its
  kind (`torch_parallel_trainers.scaled_rels`: from the seeded init, the
  biases that only a train-mode BN reads and the running means of exactly
  centred inputs hold rounding noise alone); the bank's `feats` and the
  prototypes rel ≤ 1e-10; the bank's `ptr` and `count` equal; both ranks
  bit-equal;
- f32 world 2 against the f64 world-1 run (the exact one) at
  tests/test_torch_contrast_trainer.py's gates and, at P = 2,
  tests/test_torch_contrast_multiproto.py's (losses ≤ 2e-7, contrast 3e-6,
  at P = 2 6e-7; each param group's update; running stats ≤ 4e-5, teacher
  ≤ 2e-5, bank ≤ 1.5e-6, at P = 2 5e-6; prototypes ≤ 2e-7), or within
  twice the f32 world-1 run's own distance, where the two carried steps
  put it further (measured: P = 2's bank 1.9e-5 at world 2, 2.6e-5 at
  world 1; its step-1 contrast loss 1.0e-6 and 8.2e-7).

Against JAX: its trainer at P = 1 and 2 from
tests/test_torch_contrast_trainer.py's start state (the port's seeded
init carried across, BN randomized), dropout stubbed, two steps on the
same rank-major global batches. Each world-2 step starts from JAX's state
before it (deploy/weights.py `contrast_state_from_jax`) with JAX's anchor
or Gumbel noise of that step, each rank its columns and rows, and is held
to JAX's after it at the one-process gates of
tests/test_torch_contrast_trainer.py and, at P = 2,
tests/test_torch_contrast_multiproto.py; ptr and count equal, the ranks
bit-equal.

Unit cases, each world 2 against world 1, f64: the row gather and its
gradient; `hard_anchor_sample` with a class present only on rank 1, a
class of fewer than n_view pixels whose fill comes partly from rank 1, and
a class whose hard pixels are all on rank 1 (anchors, valid, the picks'
global indices exactly equal; the features' gradient); `ContrastRemapping`
with the slots' pixels split unevenly between the ranks (both masks
exactly equal); `grouped_sinkhorn` and `prototype_learning` on two
datasets' rows in the trainer's layout (plans, prototypes and gradients
rel ≤ 1e-10, slots and targets equal); two `memory_bank_push`es.
"""

import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_trainers as t
import torch_parallel_worker as w
from test_torch_contrast_trainer import (
    GROUPS, UPDATE_GATES, as_numpy_jax, errors, snapshot, start_state)
from torch_contrast_parity import jax_step_noise, no_jax_contrast_dropout, tiny_contrast_config
from torch_eval_parity import one_torch_thread  # noqa: F401 (autouse)
from torch_parity import seg_batch

F64_GATE = 1e-10
B, HW, U = 4, 64, 8
TASKS = ["contrast:1:f64", "contrast:2:f64", "contrast:1:f32", "contrast:2:f32", "units",
         "contrast_from_jax"]
# the port's step against JAX's at tests/test_torch_contrast_trainer.py's gates
# (P = 1) and tests/test_torch_contrast_multiproto.py's (P > 1)
JAX_LOSS_GATES = {1: {"loss": 2e-7, "seg_loss": 2e-7, "contrast_loss": 3e-6},
                  2: {"loss": 6e-7, "seg_loss": 6e-7, "seg_mul_loss": 6e-7,
                      "contrast_loss": 6e-7}}
JAX_BANK_GATE = {1: 1.5e-6, 2: 5e-6}
JAX_PROTO_GATE = 2e-7


def _contrast_config():
    cfg = tiny_contrast_config()
    cfg["contrast"]["update_sim_thresh"] = 0.0
    return cfg


def _remap_config():
    cfg = tiny_contrast_config()
    cfg["contrast"].update(num_prototype=2, update_sim_thresh=0.3)
    cfg["lr"]["max_iter"] = 8
    return cfg


def _units(rng):
    """The unit cases' inputs (module docstring)."""
    inp = {"g_x": rng.normal(size=(4, 3, 5)), "g_w": rng.normal(size=(4, 3, 5))}
    # anchors, n_view 4. "spread": 16 pixels, 8 a rank; class 0 on both
    # ranks with its hard pixels all on rank 1, class 1 only on rank 1,
    # class 2 of 2 pixels, class 3 absent. "few": 6 pixels, 3 a rank;
    # class 2 of 2 pixels, whose fill is global index 1 (rank 0) and 3
    # (rank 1)
    spread_lb = np.array([0, 0, 2, 0, 255, 0, 0, 2, 0, 1, 0, 1, 1, 0, 1, 1])
    spread_pr = spread_lb.copy()
    spread_pr[[8, 10, 13]] = 3
    spread_pr[4] = 0
    few_lb = np.array([2, 0, 2, 1, 1, 0])
    for c, lb, pr, C in (("spread", spread_lb, spread_pr, 4), ("few", few_lb, few_lb, 3)):
        n = len(lb)
        inp.update({f"anc_{c}_feats": rng.normal(size=(n, 5)), f"anc_{c}_labels": lb,
                    f"anc_{c}_preds": pr, f"anc_{c}_noise": rng.random((C, n)).astype(np.float32),
                    f"anc_{c}_weight": rng.normal(size=(C, 4, 5))})
    # the remap: dataset 1 (7 classes; class 3 → unified 1 and 2), P = 2;
    # rank 0's multi-mapped pixels lean to slot 2, rank 1's to slot 5
    lb = rng.integers(0, 7, (4, 64, 64))
    lb[:, :32] = 3
    sim = rng.uniform(0.0, 0.6, (4, 8, 8, 16))
    sim[:2, ..., 2] += 0.5
    sim[2:, ..., 5] += 0.5
    inp.update(rm_labels=lb.astype(np.uint8), rm_sim=sim, cfg_remap=json.dumps(_remap_config()))
    # prototype learning: K = 3 classes, P = 2 slots, D = 4; two datasets of
    # 12 and 8 rows (6 and 4 a rank), some ignored (3 and 255)
    for i, n in enumerate((12, 8)):
        e = rng.normal(size=(n, 4))
        inp[f"pl{i}_emb"] = e / np.linalg.norm(e, axis=1, keepdims=True)
        gt = rng.integers(0, 3, n)
        gt[[1, n - 2]] = (3, 255)
        inp[f"pl{i}_gt"], inp[f"pl{i}_correct"] = gt, rng.random(n) < 0.7
    p = rng.normal(size=(3, 2, 4))
    inp["pl_protos"] = p / np.linalg.norm(p, axis=-1, keepdims=True)
    inp["pl_scores"] = rng.normal(size=(20, 2))
    inp["pl_noise"] = -np.log(-np.log(rng.uniform(1e-20, 1.0, (20, 2))))
    inp["pl_weight"] = rng.normal(size=(20, 6))
    # the bank: two pushes of 8 rows, 5 classes (class 4 never present)
    inp["bk_feats"] = rng.normal(size=(2, 8, 6))
    bl = rng.integers(0, 4, (2, 8))
    bl[0, 5], bl[1, 2] = 255, 255
    inp["bk_labels"] = bl
    return inp


def _shifted(rng, n):
    im, lb = seg_batch(rng, B, HW, HW, n)
    im = im.astype(np.int32) // 2
    im[B // 2:] += 128
    return im.astype(np.uint8), lb


def _jax_proto_noise(step, n_pixels, P):
    """The Gumbel noise of JAX's step `step` (tests/test_torch_contrast_
    multiproto.py `jax_proto_noise` at P slots)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), step), 17)
    u = jax.random.uniform(key, (n_pixels, P), jnp.float32, 1e-20, 1.0)
    return np.array(-jnp.log(-jnp.log(u) + 1e-20))


def _jax_run(d, inp):
    """JAX's ContrastTrainer on make_mesh(2) at P = 1 and 2 from
    test_torch_contrast_trainer.py's start state, dropout stubbed, two steps
    on the rank-major global batches `ct0_`, `ct1_`: before each, its state
    in the port's terms and its noise of that step go to `jax_c{P}_{k}.pt`
    for the ranks. → {P: [(state before, metrics, state after)]}."""
    import mds_tpu.engine.contrast_trainer as jct
    from mds_tpu.config import Configer as JConfiger
    from mds_tpu.engine.train_state import TrainState
    from mds_tpu.parallel.mesh import make_mesh
    from mds_tpu_torch.deploy.weights import contrast_state_from_jax

    sizes = [B * (HW // 8) ** 2] * 2

    def run(P):
        cfg = _contrast_config()
        cfg["contrast"]["num_prototype"] = P
        jt = jct.ContrastTrainer(JConfiger(configs=cfg), work_dir=os.path.join(d, "jax"),
                                 compute_dtype=jnp.float32, mesh=make_mesh(2))
        steps = []
        for k in range(2):
            pre = snapshot(jt)
            pre["prototypes"] = None if P == 1 else np.array(jt.prototypes)
            state, extras = contrast_state_from_jax(
                pre["params"], pre["batch_stats"], pre["opt_state"], pre["step"],
                pre["bank"], pre["teacher"], pre["prototypes"])
            t.write_atomic({"state": state, "extras": extras, "sizes": sizes,
                            "anchor_noise": jax_step_noise(pre["step"], 2, U, sizes),
                            "proto_noise": _jax_proto_noise(pre["step"], sum(sizes), P)},
                           os.path.join(d, f"jax_c{P}_{k}.pt"))
            m = jt.step({"ims": [inp[f"ct{k}_im{i}"] for i in range(2)],
                         "lbs": [inp[f"ct{k}_lb{i}"] for i in range(2)]})
            post = snapshot(jt)
            post["prototypes"] = None if P == 1 else np.array(jt.prototypes)
            steps.append((pre, {key: float(x) for key, x in m.items()}, post))
        return steps

    # one start state (the slots live outside the model); the two compiles
    # side by side
    v = start_state(_contrast_config())
    mp = pytest.MonkeyPatch()
    no_jax_contrast_dropout(mp)
    mp.setattr(jct, "init_train_state", lambda model, tx, sample: TrainState(
        params=v["params"], batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]),
        step=jnp.asarray(0, jnp.int32)))
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            jobs = {P: pool.submit(run, P) for P in (1, 2)}
            return {P: job.result() for P, job in jobs.items()}
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, rank 1's, world 1's, JAX's steps on its 2-device
    mesh): the launch and JAX's trainer (in a thread) run while the parent
    computes world 1."""
    d = tmp_path_factory.mktemp("parallel_contrast")
    rng = np.random.default_rng(30)
    inp = {"cfg_contrast": json.dumps(_contrast_config())}
    for k in range(2):
        for i, n in enumerate((5, 7)):
            inp[f"ct{k}_im{i}"], inp[f"ct{k}_lb{i}"] = _shifted(rng, n)
    inp.update(_units(rng))
    np.savez(d / "inputs.npz", **inp)
    inp = np.load(d / "inputs.npz")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        job = pool.submit(w.launch, 2, str(d), TASKS, 240, t.WORKER)
        jax_job = pool.submit(_jax_run, str(d), inp)
        one = {}
        for task in TASKS[:4]:
            _, P, dt = task.split(":")
            one[f"contrast{P}_{dt}"] = t.contrast_run(
                inp, int(P), torch.float64 if dt == "f64" else torch.float32,
                str(d / f"w1_{P}_{dt}"))
        one["units"] = t.units(inp)
        jx = jax_job.result()
        exact = t.contrast_from_jax(inp, str(d), dtype=torch.float64)
        job.result()
    r0, r1 = (torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2))
    return r0, r1, one, (jx, exact)


def _rel(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    mag = want.abs().max().item()
    diff = (got - want).abs().max().item()
    return diff / mag if mag else diff


@pytest.mark.parametrize("P", [1, 2])
def test_contrast_world2_equals_world1_f64(runs, P):
    r0, r1, one, _ = runs
    a, b = r0[f"contrast{P}_f64"], one[f"contrast{P}_f64"]
    for got, want in zip(a["steps"], b["steps"]):
        assert set(got) == set(want) == ({"loss", "seg_loss", "contrast_loss"}
                                          | ({"seg_mul_loss"} if P > 1 else set()))
        for k in want:
            assert abs(got[k] - want[k]) <= F64_GATE * abs(want[k]), (k, got[k], want[k])
    assert b["steps"][0]["contrast_loss"] > 0 and b["steps"][1]["contrast_loss"] > 0
    rels = t.scaled_rels({f"{part}:{k}": (a[part][k], v) for part in ("model", "teacher",
                                                                      "momenta")
                          for k, v in b[part].items()})
    bad = {k: r for k, r in rels.items() if not r <= F64_GATE}
    assert not bad, bad
    assert len(a["momenta"]) > 50
    assert _rel(a["bank"], b["bank"]) <= F64_GATE
    assert torch.equal(a["ptr"], b["ptr"]) and torch.equal(a["count"], b["count"])
    assert int(b["count"].sum()) > 0
    if P > 1:
        assert _rel(a["prototypes"], b["prototypes"]) <= F64_GATE
    for part in ("model", "teacher", "momenta"):
        for k, v in a[part].items():
            assert torch.equal(v, r1[f"contrast{P}_f64"][part][k]), (part, k)
    assert torch.equal(a["bank"], r1[f"contrast{P}_f64"]["bank"])


def _f32_errors(run, ex):
    """A f32 run's distances from the exact one (f64 world 1): each step's
    losses rel; each param group's update rel L2 and 1 − cosine; the
    running stats, the teacher (by group: tests/test_torch_contrast_trainer.py
    `_group_rel`), the bank and the prototypes."""
    out = {f"{k}/{key}": abs(got[key] - want[key]) / abs(want[key])
           for k, (got, want) in enumerate(zip(run["steps"], ex["steps"])) for key in want}
    groups = run["groups"]
    for g in GROUPS:
        ks = [k for k in groups if groups[k] == g]
        du = torch.cat([(run["model"][k] - run["init"][k]).ravel() for k in ks])
        dw = torch.cat([(ex["model"][k] - ex["init"][k]).ravel() for k in ks])
        out[g] = (du - dw).norm().item() / dw.norm().item()
        out[g + "/1-cos"] = 1.0 - (du @ dw).item() / (du.norm() * dw.norm()).item()
    by_group = {}
    for k in ex["model"]:
        by_group.setdefault(groups.get(k, k.rsplit(".", 1)[-1]), []).append(k)

    def group_rel(got, want, keys):
        return max(max((got[k] - want[k]).abs().max().item() for k in ks)
                   / max(want[k].abs().max().item() for k in ks) for ks in keys.values())

    out["stats"] = group_rel(run["model"], ex["model"],
                             {g: ks for g, ks in by_group.items() if g.startswith("running")})
    out["teacher"] = group_rel(run["teacher"], ex["teacher"], by_group)
    out["bank"] = _rel(run["bank"], ex["bank"])
    if run["prototypes"] is not None:
        out["prototypes"] = _rel(run["prototypes"], ex["prototypes"])
    return out


@pytest.mark.parametrize("P", [1, 2])
def test_contrast_world2_f32_gates(runs, P):
    """The f32 world-2 run against the exact one (f64 world 1): each
    distance within its gate, or within twice the f32 world-1 run's own
    distance (the repo's rule where f32 is ill-conditioned: two steps
    carry step 0's rounding into step 1)."""
    r0, _, one, _ = runs
    ex = one[f"contrast{P}_f64"]
    assert set(r0[f"contrast{P}_f32"]["groups"].values()) == set(GROUPS)
    got, w1 = _f32_errors(r0[f"contrast{P}_f32"], ex), _f32_errors(one[f"contrast{P}_f32"], ex)
    loss_gates = ({"loss": 6e-7, "seg_loss": 6e-7, "seg_mul_loss": 6e-7, "contrast_loss": 6e-7}
                  if P > 1 else {"loss": 2e-7, "seg_loss": 2e-7, "contrast_loss": 3e-6})
    gates = {f"{k}/{key}": g for k in range(2) for key, g in loss_gates.items()}
    for g, (l2, cos) in UPDATE_GATES.items():
        gates[g], gates[g + "/1-cos"] = l2, 1.0 - cos
    gates.update(stats=4e-5, teacher=2e-5, bank=5e-6 if P > 1 else 1.5e-6)
    if P > 1:
        gates["prototypes"] = 2e-7
    assert set(got) == set(gates)
    bad = {k: (got[k], gate, w1[k]) for k, gate in gates.items()
           if not got[k] <= max(gate, 2 * w1[k])}
    assert not bad, bad
    a = r0[f"contrast{P}_f32"]
    assert torch.equal(a["ptr"], ex["ptr"]) and torch.equal(a["count"], ex["count"])


def test_gather_rows_world2(runs):
    r0, r1, one, _ = runs
    u0, u1, u = r0["units"]["gather"], r1["units"]["gather"], one["units"]["gather"]
    for r in (u0, u1):
        assert torch.equal(r["gathered"], u["gathered"])
    assert torch.equal(torch.cat([u0["grad"], u1["grad"]]), u["grad"])


def _picks(runs_of_ranks):
    """The picks' global pixel indices (C, n_view): each rank's `pos`
    indexes every rank's candidates, rank-major (`anchor_picks`)."""
    cand = torch.cat([r["cand"] for r in runs_of_ranks], dim=1)
    return [cand.gather(1, r["pos"]) for r in runs_of_ranks]


@pytest.mark.parametrize("case", ["spread", "few"])
def test_hard_anchor_sample_world2(runs, case):
    r0, r1, one, _ = runs
    u0, u1, u = (r["units"]["anchors"][case] for r in (r0, r1, one))
    (picks,) = _picks([u])
    for r, got in zip((u0, u1), _picks([u0, u1])):
        assert torch.equal(got, picks)
        assert torch.equal(r["valid"], u["valid"])
        assert torch.equal(r["anchors"], u["anchors"])
    assert _rel(torch.cat([u0["grad"], u1["grad"]]), u["grad"]) <= F64_GATE
    if case == "spread":
        # class 0's hard pixels (8, 10, 13) lead, all on rank 1; class 1
        # only on rank 1; class 2's two pixels, then the lowest others
        assert picks[0, :3].sort().values.tolist() == [8, 10, 13]
        assert set(picks[1].tolist()) <= {9, 11, 12, 14, 15}
        assert picks[2, :2].sort().values.tolist() == [2, 7]
        assert picks[2, 2:].tolist() == [0, 1]
        assert u["valid"].tolist() == [True, True, False, False]
    else:
        assert picks[2].tolist()[2:] == [1, 3]


def test_contrast_remapping_world2(runs):
    r0, r1, one, _ = runs
    u0, u1, u = (r["units"]["remap"] for r in (r0, r1, one))
    for k in ("contrast_mask", "seg_mask"):
        assert torch.equal(torch.cat([u0[k], u1[k]]), u[k]), k
    cm = u["contrast_mask"].reshape(4, 8, 8, 8, 2)
    # sharpened pixels of both leaning slots exist, on their own ranks
    assert cm[:2, ..., 1, 0].sum() > 0 and cm[2:, ..., 2, 1].sum() > 0


def test_prototype_learning_world2(runs):
    r0, r1, one, _ = runs
    u0, u1, u = (r["units"]["proto"] for r in (r0, r1, one))
    # world 1's rows in rank order: dataset 0's 6 + 6, dataset 1's 4 + 4
    order = torch.tensor([*range(0, 6), *range(12, 16), *range(6, 12), *range(16, 20)])
    for k in ("plan", "grad"):
        assert _rel(torch.cat([u0[k], u1[k]]), u[k][order]) <= F64_GATE, k
    for k in ("slot", "target"):
        assert torch.equal(torch.cat([u0[k], u1[k]]), u[k][order]), k
    for r in (u0, u1):
        assert _rel(r["prototypes"], u["prototypes"]) <= F64_GATE
    assert (u["prototypes"] - u["prototypes_in"]).abs().max() > 1e-3  # slots moved


def test_memory_bank_push_world2(runs):
    r0, r1, one, _ = runs
    u = one["units"]["bank"]
    for r in (r0, r1):
        b = r["units"]["bank"]
        assert _rel(b["feats"], u["feats"]) <= F64_GATE
        assert torch.equal(b["ptr"], u["ptr"]) and torch.equal(b["count"], u["count"])
    assert u["count"].tolist()[4] == 0 and min(u["count"].tolist()[:4]) >= 1


@pytest.mark.parametrize("P", [1, 2])
def test_contrast_world2_matches_jax(runs, P):
    """Each world-2 step from JAX's state before it, with JAX's noise,
    against JAX's ContrastTrainer on its 2-device mesh after the step:
    losses, each param group's update, the running stats, the teacher, the
    bank and the prototypes at the one-process gates, or where a reading
    misses its gate, the port's distance from the exact step (the port's
    f64 step at world 1 from the same state) within twice JAX's own, the
    rule of tests/test_torch_parallel_gnn.py; ptr and count equal, the
    ranks bit-equal."""
    r0, r1, _, (jx, exact) = runs
    for k, (pre, jm, post) in enumerate(jx[P]):
        got, other = r0["contrast_from_jax"][f"{P}_{k}"], r1["contrast_from_jax"][f"{P}_{k}"]
        ex = exact[f"{P}_{k}"]
        before = as_numpy_jax(pre)["model"]
        want = as_numpy_jax(post)
        want["prototypes"] = post["prototypes"]
        e_pj, e_port, e_jax = (_jax_errors(a, am, b, bm, before, got["groups"])
                               for a, am, b, bm in ((got, got["metrics"], want, jm),
                                                    (got, got["metrics"], ex, ex["metrics"]),
                                                    (want, jm, ex, ex["metrics"])))
        gates = dict(JAX_LOSS_GATES[P], stats=4e-5, teacher=2e-5, bank=JAX_BANK_GATE[P])
        for g, (l2, cos) in UPDATE_GATES.items():
            gates[g], gates[g + "/1-cos"] = l2, 1.0 - cos
        if P > 1:
            gates["prototypes"] = JAX_PROTO_GATE
        assert set(e_pj) == set(gates)
        bad = {key: (e_pj[key], gate, e_port[key], e_jax[key]) for key, gate in gates.items()
               if not (e_pj[key] <= gate or e_port[key] <= 2 * e_jax[key])}
        assert not bad, (k, bad)
        np.testing.assert_array_equal(got["ptr"], want["ptr"])
        np.testing.assert_array_equal(got["count"], want["count"])
        assert got["step"] == want["step"] == k + 1
        if P > 1:
            assert not np.array_equal(post["prototypes"], pre["prototypes"])
        for part in ("model", "teacher"):
            for key, v in got[part].items():
                assert np.array_equal(v, other[part][key]), (k, part, key)


def _jax_errors(a, am, b, bm, before, groups):
    """The distances of one step's result `a` (metrics `am`) from `b`'s:
    each loss rel; test_torch_contrast_trainer.py `errors` (each param
    group's update rel L2 and 1 − cosine, stats, teacher, bank); the
    prototypes' max-diff over their largest."""
    out = {key: abs(am[key] - bm[key]) / abs(bm[key]) for key in bm}
    for key, v in errors(a, b, before, groups).items():
        if isinstance(v, tuple):
            out[key], out[key + "/1-cos"] = v[0], 1.0 - v[1]
        else:
            out[key] = v
    if b.get("prototypes") is not None:
        out["prototypes"] = (np.abs(a["prototypes"] - b["prototypes"]).max()
                             / np.abs(b["prototypes"]).max())
    return out
