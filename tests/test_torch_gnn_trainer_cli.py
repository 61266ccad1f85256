"""The flagship's entry points in the port on the CPU (no JAX needed):
tools/train_torch.py --gnn on configs/test_synthetic_gnn.json, shrunk by
overrides (ResNet layers [1, 1, 1, 1], planes [64, 16, 24, 32], 16
features, network.efficient on), f32 as JAX's CLI trains; its checkpoints,
resume and a fresh trainer's exact restore; train.mode seg and gnn; the
stage-switch eval; tools/evaluate_torch.py and build_eval_bundle on its
checkpoint in the modes contrast, ss, uni, unseen and clip;
tools/serve_torch.py's build_e2e for snp_rn18 with and without weights;
`finetune_from` a reference-layout .pth; the options this slice ported
(clip, Gumbel graphs, KM, adv, BGAT) through the CLI; and the features
that waited until snp_rn18_mulbn came (the model through the CLI, the eval
mode dsg, the loader's stage).
The step against JAX's is tests/test_torch_gnn_trainer.py (and
test_torch_mulbn.py for snp_rn18_mulbn).
"""

import os
import sys

import numpy as np
import pytest
import torch

from torch_flagship_parity import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "test_synthetic_gnn.json")
SMALL = ["backbone.layers", "[1, 1, 1, 1]", "backbone.planes", "[64, 16, 24, 32]",
         "backbone.num_features", "16", "network.efficient", "True",
         "train.num_workers", "1", "train.log_interval", "1"]
STAGES = ["GNN", "GNN", "SEG", "SEG", "GNN", "GNN"]


def _train(work, *extra):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_torch

    return train_torch.main(["--config", CFG, "--device", "cpu", "--work-dir", str(work),
                             "--gnn"] + SMALL + list(extra))


def _configer(*extra):
    from mds_tpu_torch.config import Configer

    return Configer(config_file=CFG, args_parser=SMALL + list(extra))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """6 alternating steps (2 GNN, the switch, 2 SEG, the re-entry, 2 GNN),
    checkpoints every 2, the contrast eval at each switch."""
    work = tmp_path_factory.mktemp("gnn")
    return work, _train(work)


def test_train_cli_runs_the_stage_machine(trained):
    work, t = trained
    assert [r["stage"] for r in t.timings] == STAGES
    assert all(np.isfinite(r["loss"]) and r["step_ms"] > 0 for r in t.timings)
    assert [s for s in (2, 4, 6) if os.path.exists(work / "ckpt_gnn" / f"{s}.pt")] == [2, 4, 6]
    assert t.total_iter == 6 and t.seg_steps == 2 and t.gnn_steps == 4
    assert t.gnn_lr_scale == max(0.1, 1 - 2 / 6)
    assert [r for r in t.timings if "switch_ms" in r][0]["step"] == 3
    for g, c in zip(t.uot_bi, (3, 4)):
        assert g.shape == (c, 7) and (g.sum(0) == 1).all() and (g.sum(1) >= 1).all()
        assert t.seg_model.dtype == torch.float32
    for i, g in enumerate(t.uot_bi):
        assert torch.equal(t.seg_model.bipartite_graphs[i], torch.from_numpy(g))
    (log,) = [f for f in os.listdir(work) if f.startswith("mds_tpu_torch_gnn-")]
    log = open(work / log).read()
    assert "[eval @iter3:GNN->SEG] mIoUs:" in log and "[eval @iter5:SEG->GNN] mIoUs:" in log
    assert "iter 6/6 stage=GNN loss=" in log


def test_restore_and_resume(trained, tmp_path):
    """A fresh trainer restores step 6 exactly; --max-iter 8 resumes there."""
    import shutil

    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
    from mds_tpu_torch.engine.optim import optimizer_state

    work, t = trained
    fresh = AlternatingTrainer(_configer(), device="cpu")
    fresh.restore(str(work / "ckpt_gnn"))
    for a, b in ((t.seg_model, fresh.seg_model), (t.gnn_model, fresh.gnn_model)):
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    for (ma, oa), (mb, ob) in (((t.seg_model, t.seg_opt), (fresh.seg_model, fresh.seg_opt)),
                               ((t.gnn_model, t.gnn_opt), (fresh.gnn_model, fresh.gnn_opt))):
        sa, sb = optimizer_state(ma, oa), optimizer_state(mb, ob)
        assert sa["count"] == sb["count"] > 0
        assert all(torch.equal(sa["state"][n][k], sb["state"][n][k])
                   for n in sa["state"] for k in ("mu", "nu"))
    assert all(np.array_equal(a, b) for a, b in zip(t.betas, fresh.betas))
    assert all(np.array_equal(a, b) for a, b in zip(t.uot_bi, fresh.uot_bi))
    for k in ("stage", "alter_iter", "total_iter", "gnn_lr_scale", "seg_steps", "gnn_steps"):
        assert getattr(t, k) == getattr(fresh, k), k
    shutil.copytree(work / "ckpt_gnn", tmp_path / "ckpt_gnn")
    resumed = _train(tmp_path, "--max-iter", "8")
    # steps 7 and 8: the second GNN stage ended at 6, so 7 switches to SEG
    assert [r["stage"] for r in resumed.timings] == ["SEG", "SEG"]
    assert "switch_ms" in resumed.timings[0]
    assert resumed.total_iter == 8 and os.path.exists(tmp_path / "ckpt_gnn" / "8.pt")


@pytest.mark.parametrize("mode", ["seg", "gnn"])
def test_single_stage_modes(tmp_path, mode):
    t = _train(tmp_path, "train.mode", mode, "lr.max_iter", "3")
    assert [r["stage"] for r in t.timings] == [mode.upper()] * 3
    assert (t.seg_steps, t.gnn_steps) == ((3, 0) if mode == "seg" else (0, 3))


def test_eval_on_the_alternating_checkpoint(trained):
    """build_eval_bundle restores the trained seg model (its UOT graphs);
    tools/evaluate_torch.py runs contrast, ss, uni, unseen and clip on it."""
    from mds_tpu_torch.evaluation.drivers import build_eval_bundle

    work, t = trained
    model = build_eval_bundle(_configer(), ckpt=str(work / "ckpt_gnn"), device="cpu")
    assert not model.training and model.dtype == torch.bfloat16
    for k, v in t.seg_model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    same = build_eval_bundle(_configer(), work_dir=str(work), device="cpu")
    assert torch.equal(same.bipartite_graphs[1], model.bipartite_graphs[1])
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import evaluate_torch

    for mode in ("contrast", "ss", "uni", "unseen", "clip"):
        mious = evaluate_torch.main(["--config", CFG, "--ckpt", str(work / "ckpt_gnn"),
                                     "--mode", mode, "--device", "cpu"] + SMALL)
        assert len(mious) == 2 and all(0.0 <= m <= 1.0 for m in mious), mode


def test_build_e2e_serves_snp_rn18(trained, tmp_path):
    """The flagship config at full width: identity graphs without weights
    (labels not all zero), the trained graphs from a state dict."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from serve_torch import build_e2e

    cfg = os.path.join(ROOT, "configs", "ltbgnn_3_datasets_snp.json")
    e2e = build_e2e(cfg, device="cpu")
    m = e2e.model
    assert type(m).__name__ == "SemsegModel" and m.dtype == torch.bfloat16
    assert [int(m.bipartite_graphs[i].sum()) for i in range(3)] == [11, 19, 36]
    frame = np.random.default_rng(0).integers(0, 256, (1, 64, 128, 3)).astype(np.uint8)
    labels = e2e.infer(frame)
    assert labels.shape == (1, 64, 128) and labels.dtype == np.int32
    assert labels.min() >= 0 and labels.max() < 11
    # a small snp_rn18 from a state dict: its own graphs
    work, t = trained
    torch.save(t.seg_model.state_dict(), tmp_path / "w.pt")
    small = os.path.join(tmp_path, "small.json")
    import json

    from mds_tpu_torch.config import Configer

    json.dump(_configer().params_root, open(small, "w"))
    e2e = build_e2e(small, weights=str(tmp_path / "w.pt"), device="cpu")
    assert torch.equal(e2e.model.bipartite_graphs[0], torch.from_numpy(t.uot_bi[0]))
    assert e2e.infer(frame).shape == (1, 64, 128)
    assert Configer(config_file=small).get("model_name") == "snp_rn18"


def test_finetune_from_a_reference_pth(trained, tmp_path):
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    _, t = trained
    sd = {k: v.clone() for k, v in t.seg_model.state_dict().items()}
    torch.save({"model_state_dict": sd}, tmp_path / "ref.pth")
    fresh = AlternatingTrainer(_configer(), device="cpu")
    fresh.finetune_from(str(tmp_path / "ref.pth"))
    assert all(torch.equal(fresh.seg_model.state_dict()[k], v) for k, v in sd.items())
    torch.save({"conv1.weight": torch.zeros(1)}, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="semseg"):
        fresh.finetune_from(str(tmp_path / "bad.pth"))


def test_init_phase_and_the_device_default():
    """lr.init_iter 2: two distillation steps on the GNN, then the GNN
    stage; the trainer refuses to start without CUDA unless asked for the
    CPU."""
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    t = AlternatingTrainer(_configer("lr.init_iter", "2"), device="cpu")
    before = {k: v.clone() for k, v in t.gnn_model.state_dict().items()}
    seg_before = {k: v.clone() for k, v in t.seg_model.state_dict().items()}
    for _ in range(2):
        m = t.step(None)
        assert set(m) == {"graph_loss", "init_proto_mse", "loss"}
        assert np.isfinite(float(m["loss"]))
    assert [r["stage"] for r in t.timings] == ["init", "init"]
    assert t.init_iters == 0 and t.stage == "GNN" and t.gnn_steps == 2
    assert any(not torch.equal(v, t.gnn_model.state_dict()[k]) for k, v in before.items())
    assert all(torch.equal(v, t.seg_model.state_dict()[k]) for k, v in seg_before.items())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            AlternatingTrainer(_configer())


@pytest.mark.parametrize("extra,where", [
    (["train.mode", "clip"], "trainer"),
    (["GNN.GumbelSoftmax", "True"], "trainer"),
    (["GNN.use_km", "True"], "trainer"),
    (["GNN.mse_or_adv", "adv"], "trainer"),
    (["GNN.model_name", "learnable_topology_BGAT"], "trainer"),
    (["model_name", "snp_rn18_mulbn"], "model"),
    ([], "dsg"),
    ([], "loader"),
])
def test_waiting_features_raise(extra, where, tmp_path):
    """The features that waited now run: the trainer's options (clip,
    Gumbel graphs, KM matching, the adversarial GNN, the BGAT) train
    through the CLI (their steps against JAX's: tests/test_torch_gnn_forks.py,
    test_torch_gnn_options.py, test_torch_clip_trainer.py); snp_rn18_mulbn
    builds and trains through the CLI with a BN set a dataset; dsg
    evaluates the stage-2 lists; the train loader takes `stage`. None
    raises NotImplementedError any more."""
    from mds_tpu_torch.data.loader import get_data_loader
    from mds_tpu_torch.engine.trainer import build_model
    from mds_tpu_torch.evaluation.drivers import run_evaluation

    if where == "trainer":
        t = _train(tmp_path, "lr.max_iter", "3", "train.eval_at_switch", "False", *extra)
        clip = extra == ["train.mode", "clip"]
        assert [r["stage"] for r in t.timings] == (["SEG"] * 3 if clip else STAGES[:3])
        assert all(np.isfinite(r["loss"]) for r in t.timings)
        assert (t.gumbel, t.use_km, t.gnn_model.mse_or_adv, t.gnn_model.gnn_type) == (
            extra[0] == "GNN.GumbelSoftmax", extra[0] == "GNN.use_km",
            "adv" if extra[1:] == ["adv"] else "None",
            "GAT" if extra[1:] == ["learnable_topology_BGAT"] else "GSAGE")
        if not clip:
            for g, c in zip(t.uot_bi, (3, 4)):
                assert g.shape == (c, 7) and (g.sum(0) == 1).all() and (g.sum(1) >= 1).all()
        return
    if where == "model":
        m = build_model(_configer(*extra))
        assert m.mulbn and len(m.backbone.bn1[0]) == 2 and len(m.logits.norm) == 2
        t = _train(tmp_path, "lr.max_iter", "3", "train.eval_at_switch", "False", *extra)
        assert t.mulbn and t.seg_model.mulbn
        assert [r["stage"] for r in t.timings] == STAGES[:3]
        assert all(np.isfinite(r["loss"]) for r in t.timings)
    elif where == "dsg":
        mious = run_evaluation(_configer(), mode="dsg", device="cpu",
                               work_dir=str(tmp_path))
        assert len(mious) == 2 and all(0.0 <= m <= 1.0 for m in mious)
    else:
        loader = get_data_loader(_configer(), "train", stage=2, batch_multiplier=2)
        try:
            assert [x.shape[0] for x in next(loader)["ims"]] == [2, 2]
        finally:
            loader.close()
