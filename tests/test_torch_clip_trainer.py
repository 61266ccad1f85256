"""`train.mode` clip in the port (mds_tpu_torch/engine/gnn_trainer.py)
against JAX's (mds_tpu/engine/gnn_trainer.py) on the CPU, at f32 on the
tiny flagship config of tests/torch_flagship_parity.py in clip mode, at
weight decay 0.1 and no warmup, so that the frozen prototypes' decoupled
decay shows (a shrink of 1e-4 a step).

- `set_clip_prototypes`: every unified slot and aux row as JAX's, bit for
  bit (copies of the node features' text half);
- 2 SEG steps, each from JAX's state before it, held as
  tests/test_torch_gnn_trainer.py holds the SEG step (each tensor rel ≤
  1e-4 of JAX's, or within twice JAX's own distance from the port's f64
  step); the prototypes take no gradient and shrink by exactly (1 −
  lr·wd), rel ≤ 1e-6 of JAX's, and they moved; the graphs stay the
  identity graphs; the stage stays SEG;
- tools/train_torch.py on configs/test_synthetic_gnn.json in clip mode:
  SEG steps only, then tools/evaluate_torch.py --mode clip on its
  checkpoint, with build_eval_bundle's model holding the checkpoint's
  prototypes.
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    batch, configers, jax_trainer, one_torch_thread, seg_step_check, snapshot, tiny)
from mds_tpu_torch.data.node_features import gen_graph_node_features
from mds_tpu_torch.engine.gnn_trainer import SEG, AlternatingTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "test_synthetic_gnn.json")
SMALL = ["backbone.layers", "[1, 1, 1, 1]", "backbone.planes", "[64, 16, 24, 32]",
         "backbone.num_features", "16", "network.efficient", "True",
         "train.num_workers", "1", "train.log_interval", "1", "train.mode", "clip"]
WD = 0.1
PROTOS = ("unify_prototype", "aux_prototype.0", "aux_prototype.1")


def clip_cfg():
    return tiny(train={"mode": "clip"}, lr={"weight_decay": WD, "warmup_iters": 0})


@pytest.fixture(scope="module")
def jax_run():
    """JAX's clip trainer: its prototypes at init and 2 SEG steps as
    (state before, batch, state after)."""
    cfg = clip_cfg()
    nf = gen_graph_node_features(configers(cfg)[1], nfeat=cfg["GNN"]["nfeat"])
    jt = jax_trainer(cfg, nf)
    init = snapshot(jt)
    rng = np.random.default_rng(0)
    runs = []
    for _ in range(2):
        pre, b = snapshot(jt), batch(rng)
        jt.step(b)
        runs.append((pre, b, snapshot(jt)))
    return nf, cfg, init, runs


def test_set_clip_prototypes_matches_jax(jax_run):
    nf, cfg, init, _ = jax_run
    tt = AlternatingTrainer(configers(cfg)[1], node_features=nf, device="cpu")
    assert tt.mode == "clip"
    sd = tt.seg_model.state_dict()
    for k in PROTOS:
        assert torch.equal(sd[k], init["states"]["seg"][k]), k
    # slot j is class j's text embedding, the aux rows every class's
    text = torch.from_numpy(nf[:, :16])
    assert torch.equal(sd["unify_prototype"], text[:5])
    assert torch.equal(torch.cat([sd["aux_prototype.0"], sd["aux_prototype.1"]]), text)


@pytest.mark.parametrize("which", [0, 1])
def test_clip_seg_step_matches_jax(jax_run, which):
    nf, cfg, _, runs = jax_run
    pre, b, post = runs[which]
    tt, before = seg_step_check(nf, cfg, pre, b, post)
    after = tt.seg_model.state_dict()
    lr = tt.seg_schedule(tt.seg_opt.count - 1)
    assert tt.stage == SEG and tt.seg_steps == which + 1 and tt.gnn_steps == 0
    for k in PROTOS:
        assert not torch.equal(after[k], before[k]), k
        np.testing.assert_allclose(after[k].numpy(), (before[k] * (1 - lr * WD)).numpy(),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(after[k].numpy(), post["states"]["seg"][k].numpy(),
                                   rtol=1e-6, atol=0)
        assert not tt.seg_opt.state[dict(tt.seg_model.named_parameters())[k]]["mu"].any()
    for i in range(2):
        assert torch.equal(after[f"bipartite_graphs.{i}"], before[f"bipartite_graphs.{i}"])
    moved = {k for k, v in before.items() if not torch.equal(after[k], v)}
    assert "backbone.conv1.weight" in moved and "logits.conv.weight" in moved


def test_clip_cli_and_eval(tmp_path):
    """tools/train_torch.py in clip mode takes SEG steps alone; its
    checkpoint evaluates in clip mode through tools/evaluate_torch.py."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import evaluate_torch
    import train_torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.evaluation.drivers import build_eval_bundle

    t = train_torch.main(["--config", CFG, "--device", "cpu", "--work-dir", str(tmp_path),
                          "lr.max_iter", "3"] + SMALL)
    assert [r["stage"] for r in t.timings] == ["SEG"] * 3
    assert (t.seg_steps, t.gnn_steps, t.total_iter) == (3, 0, 3)
    assert all(np.isfinite(r["loss"]) for r in t.timings)
    fresh = AlternatingTrainer(Configer(config_file=CFG, args_parser=SMALL), device="cpu")
    lrs = [t.seg_schedule(i) for i in range(3)]
    want = fresh.seg_model.unify_prototype.detach().double() * float(
        np.prod([1 - lr * 1e-5 for lr in lrs]))
    np.testing.assert_allclose(t.seg_model.unify_prototype.detach().double().numpy(),
                               want.numpy(), rtol=1e-6, atol=0)
    ckpt = str(tmp_path / "ckpt_gnn")
    model = build_eval_bundle(Configer(config_file=CFG, args_parser=SMALL), ckpt=ckpt,
                              device="cpu")
    assert torch.equal(model.unify_prototype, t.seg_model.unify_prototype)
    mious = evaluate_torch.main(["--config", CFG, "--ckpt", ckpt, "--mode", "clip",
                                 "--device", "cpu"] + SMALL)
    assert len(mious) == 2 and all(0.0 <= m <= 1.0 for m in mious)
