"""The port's trainer slice against the JAX package's, on the CPU.

The slice (`Trainer` on configs/test_synthetic.json: 2 datasets, 6 steps,
f32, dropout off on both sides, one loader thread): JAX's `Trainer` runs
once (module fixture; its compile is most of this file's time), and every
step records its state, batch and loss. The port's `Trainer` runs the same
config from JAX's initial state carried across (`train_state_from_jax`),
and each of its steps starts from JAX's state before that step: the
free-running trajectory of this config is chaotic in f32, in JAX itself.
Measured against the exact step (the port's, in f64, from the same JAX
state: `f64_islands`), per step, worst over the 6 steps (JAX's f32 step /
the port's f32 step against exact):
  loss rel 1.8e-3 / 2.2e-4 (step 3, after the loss has doubled);
  the heads' 1-d parameters' update (head_nowd) rel L2 0.032 / 0.015;
  BN running variances rel max 0.035 / 4.4e-3, running means (max-diff
    over their largest magnitude) 1.2e-3 / 2.0e-3;
  the other groups' updates at steps 1, 3 and 6: rel L2 0.016-3.3 /
    0.15-2.2, cosine down to −0.69 / 0.61: BN over one or a few values
    (the /32 maps of 32×32 crops, one image of dataset 2) makes their
    gradients rounding noise on both sides; at steps 2, 4 and 5 every
    group's update is defined to 2e-3 / 8e-3.
Each gate sits at about twice the larger of the two: every step's loss rel
≤ 4e-3 and its learning rate JAX's (rel 1e-6); the head_nowd update rel
L2 ≤ 0.07 (cosine ≥ 0.99); running variances rel ≤ 0.07 and running means
≤ 4e-3; at steps 2, 4 and 5 every group's update rel L2 ≤ 0.02 (cosine
≥ 0.9999); after step 6 the head_nowd parameters, max-diff over their
largest magnitude, ≤ 5e-4 (7.2e-5 / 2.5e-4). The loader's batches are held
bit for bit at every step.

The fused-upsample step: one f32 step of `make_seg_loss_fn(...,
fused_up_loss=True)` against JAX's, at the gates of test_torch_train.py;
and JAX's state after 2 such steps, carried across with its momentum and
step count, takes a third step in the port that matches JAX's third.
Checkpoints: the cadence, `force`, a duplicate id, `max_to_keep`, an exact
round trip; restore and resume through `tools/train_torch.py`.
"""

import contextlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.config import Configer as JConfiger
from mds_tpu.engine.lr_schedule import warmup_poly_lr as j_warmup_poly_lr
from mds_tpu.engine.trainer import Trainer as JTrainer
from mds_tpu.models import bisenetv2 as jb
from mds_tpu.parallel.mesh import make_mesh
from mds_tpu_torch.config import Configer
from mds_tpu_torch.deploy.weights import train_state_from_jax
from mds_tpu_torch.engine.checkpoints import CheckpointManager, load_train_state
from mds_tpu_torch.engine.lr_schedule import warmup_poly_lr
from mds_tpu_torch.engine.trainer import Trainer, step_generator, train_from_config
from mds_tpu_torch.engine.train_step import make_seg_loss_fn
from mds_tpu_torch.utils.metrics_writer import read_metrics
from torch_parity import (
    CITY_MEAN,
    CITY_STD,
    LR,
    as_port,
    compare_step,
    jax_steps,
    make_variables,
    no_jax_dropout,
    no_port_dropout,
    np_tree,
    port_steps,
    seg_batch,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "test_synthetic.json")
OVERRIDES = ["train.num_workers", "1", "train.hw_dropout", "False"]
GROUPS = ("wd", "nowd", "head_wd", "head_nowd")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's Trainer: the state before each step, each step's batch and
    loss, the final state."""
    states, batches, losses = [], [], []
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        jt = JTrainer(JConfiger(config_file=CFG, args_parser=OVERRIDES),
                      work_dir=str(tmp_path_factory.mktemp("jax")),
                      compute_dtype=jnp.float32, mesh=make_mesh(1))
        step_fn = jt.step_fn

        def recorded(state, ims, lbs, rng):
            states.append(np_tree((state.params, state.batch_stats, state.opt_state,
                                   state.step)))
            batches.append(np_tree((list(ims), list(lbs))))
            state, metrics = step_fn(state, ims, lbs, rng)
            losses.append(float(metrics["loss"]))
            return state, metrics

        jt.step_fn = recorded
        jt.train(log_interval=1)
    states.append(np_tree((jt.state.params, jt.state.batch_stats, jt.state.opt_state,
                           jt.state.step)))
    return {"states": states, "batches": batches, "losses": losses,
            "lrs": [float(jt.schedule(k)) for k in range(len(losses))]}


def forced_port_run(jax_run, work_dir, dtype=torch.float32, wrap=None):
    """The port's Trainer on the same config, each step from JAX's state
    before it: per step the loss, the 'nowd' group's learning rate, the
    state_dict after the step. `wrap` runs around each step (f64_islands)."""
    t = Trainer(Configer(config_file=CFG, args_parser=OVERRIDES), work_dir=work_dir,
                compute_dtype=dtype, device="cpu")
    no_port_dropout(t.model)
    step_fn, out = t.step_fn, []

    def forced(ims, lbs, generator):
        k = len(out)
        j_ims, j_lbs = jax_run["batches"][k]
        for a, b in zip(ims + lbs, j_ims + j_lbs):
            np.testing.assert_array_equal(a.numpy(), b)
        load_train_state(t.model, t.optimizer, train_state_from_jax(*jax_run["states"][k]))
        with wrap() if wrap else contextlib.nullcontext():
            metrics = step_fn(ims, lbs, generator)
        lr = {g["name"]: g["lr"] for g in t.optimizer.param_groups}["nowd"]
        out.append({"loss": float(metrics["loss"]), "lr": lr,
                    "state": {k_: v.detach().double().numpy().copy()
                              for k_, v in t.model.state_dict().items()
                              if not k_.endswith("num_batches_tracked")}})
        return metrics

    t.step_fn = forced
    t.train(log_interval=1)
    groups = {n: g["name"] for g in t.optimizer.param_groups
              for n, p in t.model.named_parameters() if any(p is q for q in g["params"])}
    return t, out, groups


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    work_dir = str(tmp_path_factory.mktemp("port"))
    t, out, groups = forced_port_run(jax_run, work_dir)
    return t, out, groups, work_dir


def step_errors(got, want, before, groups):
    """Per group the update's (rel L2, cosine) and the parameters' max-diff
    over the group's largest magnitude; the running variances' worst rel
    max-diff; the running means' max-diff over their largest magnitude."""
    out = {}
    for g in GROUPS:
        ks = [k for k in want if groups.get(k) == g]
        du = np.concatenate([(got[k] - before[k]).ravel() for k in ks])
        dw = np.concatenate([(np.asarray(want[k], np.float64) - before[k]).ravel() for k in ks])
        out[g] = {"update_rel_l2": float(np.linalg.norm(du - dw) / np.linalg.norm(dw)),
                  "update_cos": float(du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw))),
                  "param_rel": max(float(np.abs(got[k] - want[k]).max()) for k in ks)
                  / max(float(np.abs(want[k]).max()) for k in ks)}
    var = [k for k in want if k.endswith("running_var")]
    mean = [k for k in want if k.endswith("running_mean")]
    out["running_var"] = max(float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
                             for k in var)
    out["running_mean"] = max(float(np.abs(got[k] - want[k]).max()) for k in mean) / max(
        float(np.abs(want[k]).max()) for k in mean)
    return out


def test_trainer_matches_jax(jax_run, port_run):
    t, out, groups, work_dir = port_run
    assert len(out) == len(jax_run["losses"]) == 6 and t.step == 6
    for k, rec in enumerate(out):
        want = as_port(*jax_run["states"][k + 1][:2])
        before = as_port(*jax_run["states"][k][:2])
        err = step_errors(rec["state"], want, before, groups)
        j_loss = jax_run["losses"][k]
        assert abs(rec["loss"] - j_loss) <= 4e-3 * abs(j_loss), (k, rec["loss"], j_loss)
        assert abs(rec["lr"] - jax_run["lrs"][k]) <= 1e-6 * jax_run["lrs"][k], k
        assert err["head_nowd"]["update_rel_l2"] <= 0.07, (k, err)
        assert err["head_nowd"]["update_cos"] >= 0.99, (k, err)
        assert err["running_var"] <= 0.07 and err["running_mean"] <= 4e-3, (k, err)
        if k + 1 in (2, 4, 5):
            for g in GROUPS:
                assert err[g]["update_rel_l2"] <= 0.02, (k, g, err)
                assert err[g]["update_cos"] >= 0.9999, (k, g, err)
    assert err["head_nowd"]["param_rel"] <= 5e-4, err
    # the run's own records: one log line a step, a checkpoint at the end
    assert [r["step"] for r in read_metrics(os.path.join(work_dir, "runs"))] == list(range(1, 7))
    assert t.ckpt.all_steps() == [6]
    assert all(r["loader_ms"] >= 0 and r["step_ms"] > 0 for r in t.timings)


def test_trainer_restores_and_resumes(port_run, monkeypatch):
    """A fresh Trainer restores the run's last checkpoint exactly
    (parameters, BN statistics, momentum, step count); the CLI's main
    resumes it to a larger --max-iter."""
    t, _, _, work_dir = port_run
    t2 = Trainer(Configer(config_file=CFG, args_parser=OVERRIDES), work_dir=work_dir,
                 compute_dtype=torch.float32, device="cpu")
    t2.restore_if_available()
    assert t2.step == 6 and t2.optimizer.count == t.optimizer.count == 6
    for k, v in t.model.state_dict().items():
        assert torch.equal(t2.model.state_dict()[k], v), k
    names = dict(t.model.named_parameters())
    named2 = dict(t2.model.named_parameters())
    assert len(t.optimizer.state) > 0
    for p, s in t.optimizer.state.items():
        name = next(n for n, q in names.items() if q is p)
        assert torch.equal(t2.optimizer.state[named2[name]]["momentum_buffer"],
                           s["momentum_buffer"]), name
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import train_torch

    resumed = train_torch.main(["--config", CFG, "--work-dir", work_dir, "--device", "cpu",
                                "--max-iter", "8", *OVERRIDES])
    assert [r["step"] for r in resumed.timings] == [7, 8]
    assert CheckpointManager(os.path.join(work_dir, "ckpt")).all_steps() == [6, 8]
    state, _ = CheckpointManager(os.path.join(work_dir, "ckpt")).restore()
    assert state["step"] == 8 and state["optimizer"]["count"] == 8


def test_train_torch_cli_runs_on_the_cpu_and_refuses_without_cuda(tmp_path):
    """`tools/train_torch.py --device cpu` trains 2 steps in a process that
    imports neither jax nor mds_tpu; without CUDA and without --device cpu
    it exits non-zero."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys, runpy; sys.argv = ['train_torch.py'] + sys.argv[1:]; "
            "runpy.run_path('tools/train_torch.py', run_name='__main__'); "
            "bad = {'jax', 'jaxlib', 'flax', 'mds_tpu'} & set(sys.modules); "
            "assert not bad, bad")
    res = subprocess.run(
        [sys.executable, "-c", code, "--config", CFG, "--work-dir", str(tmp_path),
         "--device", "cpu", "lr.max_iter", "2", "train.log_interval", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "iter: 2/2" in res.stderr and "augment pipeline" in res.stderr
    recs = read_metrics(str(tmp_path / "runs"))
    assert [r["step"] for r in recs] == [1, 2] and all(np.isfinite(r["seg"]) for r in recs)
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [2]
    # the same run from Python resumes it one step further
    t = train_from_config(CFG, ["train.log_interval", "1"], work_dir=str(tmp_path),
                          max_iter=3, device="cpu")
    assert t.step == 3 and [r["step"] for r in t.timings] == [3]
    assert [r["step"] for r in read_metrics(str(tmp_path / "runs"))] == [1, 2, 3]
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    res = subprocess.run([sys.executable, "tools/train_torch.py", "--config", CFG,
                          "--work-dir", str(tmp_path / "cuda")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr


def test_metrics_writer_sets_the_tensorboard_switch_only_while_it_builds(tmp_path):
    """The port's MetricsWriter puts tensorboard's `notf` switch in
    sys.modules only while it makes its SummaryWriter, and leaves one set
    by someone else in place; the JAX package's MetricsWriter, made after
    it in the same process, still writes its metrics.jsonl and, where the
    port's writer had TensorBoard, its event file."""
    code = (
        "import glob, sys, types\n"
        "from mds_tpu_torch.utils.metrics_writer import MetricsWriter, read_metrics\n"
        "from mds_tpu.utils.metrics_writer import MetricsWriter as JMetricsWriter\n"
        "key = 'tensorboard.compat.notf'\n"
        "a, b, c = sys.argv[1:4]\n"
        "w = MetricsWriter(a)\n"
        "tb = w._tb is not None\n"
        "w.write(1, {'seg': 1.0}); w.close()\n"
        "assert key not in sys.modules\n"
        "j = JMetricsWriter(b)\n"
        "assert (j._tb is not None) == tb\n"
        "j.write(1, {'seg': 2.0}); j.close()\n"
        "assert [r['seg'] for r in read_metrics(a)] == [1.0]\n"
        "assert [r['seg'] for r in read_metrics(b)] == [2.0]\n"
        "assert not tb or (glob.glob(a + '/events.*') and glob.glob(b + '/events.*'))\n"
        "mine = sys.modules[key] = types.ModuleType(key)\n"
        "MetricsWriter(c).close()\n"
        "assert sys.modules[key] is mine\n"
        "print('tensorboard', tb)\n")
    dirs = [str(tmp_path / d) for d in "abc"]
    res = subprocess.run([sys.executable, "-c", code] + dirs, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "tensorboard" in res.stdout


def test_trainer_refusals(tmp_path, monkeypatch):
    """No CUDA device and no device='cpu'; a model the supervised trainer
    does not train (snp_rn18: --gnn, tests/test_torch_gnn_trainer.py); a
    mode the supervised trainer does not run (clip runs the alternating
    trainer; --gnn and train.mode alternate run it too, contrast the
    contrast trainer, tests/test_torch_contrast_trainer.py); finetune_from
    a layout another trainer takes or the port lacks, and one that does
    not fit the model (BiSeNetV1's on BiSeNetV2)."""
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    import train_torch

    cfg = Configer(config_file=CFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, work_dir=str(tmp_path))
    snp = Configer(config_file=os.path.join(ROOT, "configs", "ltbgnn_3_datasets_snp.json"))
    with pytest.raises(NotImplementedError, match="--gnn"):
        Trainer(snp, work_dir=str(tmp_path), device="cpu")
    # train.mode clip runs the alternating trainer in its clip mode
    # (tests/test_torch_clip_trainer.py), as tools/train.py:81 routes it
    clip = train_torch.main([
        "--config", os.path.join(ROOT, "configs", "test_synthetic_gnn.json"), "--device", "cpu",
        "--work-dir", str(tmp_path / "clip"), "--max-iter", "1", "train.mode", "clip",
        "backbone.layers", "[1, 1, 1, 1]", "backbone.planes", "[64, 16, 24, 32]",
        "backbone.num_features", "16", "train.eval_at_switch", "False"])
    assert type(clip).__name__ == "AlternatingTrainer" and clip.mode == "clip"
    assert [r["stage"] for r in clip.timings] == ["SEG"]
    t = Trainer(cfg, work_dir=str(tmp_path), device="cpu")
    for sd, item in (({"backbone.conv1.weight": torch.zeros(1), "unify_prototype": torch.zeros(1)},
                      "--gnn"),
                     ({"transition1.0.0.weight": torch.zeros(1)}, "neither package"),
                     ({"projHead.conv_last.weight": torch.zeros(1)}, "contrast")):
        torch.save(sd, tmp_path / "w.pth")
        with pytest.raises(NotImplementedError, match=item):
            t.finetune_from(str(tmp_path / "w.pth"))
    torch.save({"cp.resnet.conv1.weight": torch.zeros(1)}, tmp_path / "w.pth")
    with pytest.raises(ValueError, match="does not fit"):
        t.finetune_from(str(tmp_path / "w.pth"))


def test_finetune_from_reference_weights_and_a_checkpoint(tmp_path, monkeypatch):
    """A BiSeNetV2 .pth in the reference layout and a checkpoint directory
    of the port's own load the weights and leave step and optimizer alone;
    `tools/train_torch.py --finetune-from` loads them before it trains."""
    cfg = Configer(config_file=CFG)
    src = Trainer(cfg, work_dir=str(tmp_path / "a"), device="cpu")
    with torch.no_grad():
        for p in src.model.parameters():
            p.add_(0.5)
    torch.save({"model_state_dict": src.model.state_dict()}, tmp_path / "w.pth")
    src.step = 4
    src.ckpt.maybe_save(src.state(), force=True)
    for path in (str(tmp_path / "w.pth"), src.ckpt.directory):
        t = Trainer(cfg, work_dir=str(tmp_path / "b"), device="cpu")
        t.finetune_from(path)
        assert t.step == 0 and t.optimizer.count == 0
        for k, v in src.model.state_dict().items():
            assert torch.equal(t.model.state_dict()[k], v), k
    monkeypatch.syspath_prepend(os.path.join(ROOT, "tools"))
    monkeypatch.setattr(Trainer, "train", lambda self: self)
    import train_torch

    t = train_torch.main(["--config", CFG, "--device", "cpu", "--work-dir",
                          str(tmp_path / "c"), "--finetune-from", str(tmp_path / "w.pth")])
    assert t.step == 0
    for k, v in src.model.state_dict().items():
        assert torch.equal(t.model.state_dict()[k], v), k


def test_step_generator_depends_on_seed_and_step_alone():
    draw = lambda g: torch.randint(0, 1 << 30, (4,), generator=g).tolist()  # noqa: E731
    assert draw(step_generator(0, 5)) == draw(step_generator(0, 5))
    assert draw(step_generator(0, 5)) != draw(step_generator(0, 6))
    assert draw(step_generator(0, 5)) != draw(step_generator(1, 5))


def _payload(seed):
    g = torch.Generator().manual_seed(seed)
    return {"model": {"w": torch.randn(3, 4, generator=g),
                      "running_var": torch.rand(4, generator=g)},
            "optimizer": {"count": seed, "state": {
                "w": {"momentum_buffer": torch.randn(3, 4, generator=g)}}},
            "step": seed}


def test_checkpoint_manager_rules(tmp_path):
    m = CheckpointManager(str(tmp_path / "ckpt"), save_interval=2)
    assert m.latest_step() is None
    with pytest.raises(FileNotFoundError):
        m.restore()
    assert not m.maybe_save(_payload(0))  # step 0 is never due
    assert not m.maybe_save(_payload(1))  # off the cadence
    assert m.maybe_save(_payload(2)) and not m.maybe_save(_payload(2))  # a duplicate id
    assert m.maybe_save(_payload(3), force=True)
    assert m.maybe_save(_payload(5), step=4, extras={"note": torch.ones(2)})
    assert m.maybe_save(_payload(6))
    assert m.all_steps() == [3, 4, 6] and m.latest_step() == 6  # max_to_keep 3
    assert sorted(os.listdir(m.directory)) == ["3.pt", "4.pt", "6.pt"]  # no temp files
    state, extras = m.restore(4)
    assert extras is not None and torch.equal(extras["note"], torch.ones(2))
    want = _payload(5)
    assert state["step"] == 5 and state["optimizer"]["count"] == 5
    for k, v in want["model"].items():
        assert state["model"][k].dtype == v.dtype and torch.equal(state["model"][k], v)
    assert torch.equal(state["optimizer"]["state"]["w"]["momentum_buffer"],
                       want["optimizer"]["state"]["w"]["momentum_buffer"])
    assert m.restore()[1] is None and m.restore()[0]["step"] == 6


WARM = dict(power=0.9, max_iter=100, warmup_iter=2, warmup_ratio=0.1)


def test_fused_up_loss_step_and_carried_state_match_jax():
    params, stats = make_variables((19,), 1, 0)
    im, lb = seg_batch(np.random.default_rng(1), 4, 64, 128, 19)
    with pytest.MonkeyPatch.context() as mp:
        no_jax_dropout(mp)
        (j,) = jax_steps(jb.BiSeNetV2(n_classes=(19,), n_bn=1), jnp.float32, [im], [lb],
                         params, stats, [(j_warmup_poly_lr(LR, **WARM), 3)],
                         fused_up_loss=True)
    sched = warmup_poly_lr(LR, **WARM)
    tm, opt, (t1,) = port_steps("bisenetv2", (19,), 1, torch.float32, [im], [lb], params,
                                stats, sched, 1, fused_up_loss=True)
    compare_step(tm, opt, t1, j[0])
    # the fused loss is the plain loss
    plain = make_seg_loss_fn(no_port_dropout(tm), [CITY_MEAN], [CITY_STD],
                             compute_dtype=torch.float32)
    fused = make_seg_loss_fn(tm, [CITY_MEAN], [CITY_STD], compute_dtype=torch.float32,
                             fused_up_loss=True)
    with torch.no_grad():
        tm.train()
        a, _ = plain([torch.from_numpy(im)], [torch.from_numpy(lb)])
        b, _ = fused([torch.from_numpy(im)], [torch.from_numpy(lb)])
    assert abs(a.item() - b.item()) <= 1e-5 * abs(a.item())
    # JAX's state after 2 steps, momentum and count included, steps on here
    start = train_state_from_jax(j[1]["params"], j[1]["stats"], j[1]["opt"], 2)
    assert start["optimizer"]["count"] == 2
    tm, opt, (t3,) = port_steps("bisenetv2", (19,), 1, torch.float32, [im], [lb], None, None,
                                sched, 1, fused_up_loss=True, start=start)
    assert opt.count == 3
    compare_step(tm, opt, t3, j[2])
