"""The eval bundle and the eval CLI of the port, on the CPU.

- `build_eval_bundle` restores the port's Trainer checkpoint exactly, takes
  the work dir's checkpoints without `--ckpt` and the seeded init without
  any, and refuses the trainers the port lacks.
- `tools/evaluate_torch.py --device cpu --ckpt` on that checkpoint, in a
  process that never imports jax: JAX's mIoU lines, each equal to
  `eval_model` on the restored model, with and without `--precise-bn 1`;
  without CUDA and without `--device cpu` it exits non-zero.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.loader import get_data_loader
from mds_tpu_torch.engine.trainer import Trainer
from mds_tpu_torch.evaluation.drivers import build_eval_bundle, recompute_bn_stats
from mds_tpu_torch.evaluation.evaluator import eval_model
from torch_eval_parity import CFG, one_torch_thread  # noqa: F401 — autouse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_THREAD = ["train.num_workers", "1"]
# the CLI's runs: 2 frames a dataset
TWO_FRAMES = ONE_THREAD + ["dataset1.reader_kwargs.length", "2",
                           "dataset2.reader_kwargs.length", "2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One step of the port's Trainer on the config, checkpointed."""
    work = str(tmp_path_factory.mktemp("train"))
    cfg = Configer(config_file=CFG, args_parser=ONE_THREAD + ["lr.max_iter", "1"])
    t = Trainer(cfg, work_dir=work, device="cpu").train()
    return work, {k: v.clone() for k, v in t.model.state_dict().items()}


def test_build_eval_bundle_restores_and_refuses(trained, tmp_path):
    work, state = trained
    cfg = Configer(config_file=CFG)
    model = build_eval_bundle(cfg, ckpt=os.path.join(work, "ckpt"), device="cpu")
    assert not model.training
    assert model.dtype == torch.bfloat16
    assert all(torch.equal(model.state_dict()[k], v) for k, v in state.items())
    # the work dir's checkpoints when no --ckpt; the seeded init without any
    same = build_eval_bundle(cfg, work_dir=work, device="cpu")
    assert all(torch.equal(same.state_dict()[k], v) for k, v in state.items())
    fresh = build_eval_bundle(cfg, work_dir=str(tmp_path), device="cpu")
    again = build_eval_bundle(cfg, work_dir=str(tmp_path), device="cpu")
    assert not os.path.exists(tmp_path / "ckpt")
    assert all(torch.equal(again.state_dict()[k], v) for k, v in fresh.state_dict().items())
    # alternate/gnn/seg checkpoints: tests/test_torch_gnn_trainer.py;
    # contrast ones: tests/test_torch_contrast_trainer.py; a clip one (its
    # training: tests/test_torch_clip_trainer.py) is the alternating
    # trainer's snp_rn18 with the node features' text prototypes
    clip = Configer(config_file="configs/test_synthetic_gnn.json", args_parser=[
        "backbone.layers", "[1, 1, 1, 1]", "backbone.planes", "[64, 16, 24, 32]",
        "backbone.num_features", "16", "train.mode", "clip"])
    model = build_eval_bundle(clip, work_dir=str(tmp_path), device="cpu")
    assert type(model).__name__ == "SemsegModel" and not model.training
    from mds_tpu_torch.data.node_features import gen_graph_node_features

    text = torch.from_numpy(gen_graph_node_features(clip, nfeat=32)[:, :16])
    assert torch.equal(model.unify_prototype, text[:7])


LINE = re.compile(r"^dataset(\d) mIoU \((\w+)\): (\d\.\d{4})$")


def test_evaluate_torch_cli_on_a_trainer_checkpoint(trained):
    work, _ = trained
    ckpt = os.path.join(work, "ckpt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # as this module's own work (one_torch_thread)
    code = ("import sys, runpy; argv = sys.argv[1:]; "
            "sys.argv = ['evaluate_torch.py'] + argv; "
            "runpy.run_path('tools/evaluate_torch.py', run_name='__main__'); "
            "sys.path.insert(0, 'tools'); import evaluate_torch; "
            "evaluate_torch.main(['--precise-bn', '1'] + argv); "
            "bad = {'jax', 'jaxlib', 'flax', 'mds_tpu'} & set(sys.modules); "
            "assert not bad, bad")
    res = subprocess.run(
        [sys.executable, "-c", code, "--config", CFG, "--device", "cpu", "--ckpt", ckpt,
         "--work-dir", os.path.join(work, "eval"), "--mode", "ss"] + TWO_FRAMES,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if LINE.match(ln)]
    assert len(lines) == 4, res.stdout

    cfg = Configer(config_file=CFG, args_parser=TWO_FRAMES)
    model = build_eval_bundle(cfg, ckpt=ckpt, device="cpu")
    want = [f"dataset{i + 1} mIoU (ss): {m:.4f}"
            for i, m in enumerate(eval_model(cfg, model, get_data_loader(cfg, "eval")))]
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    recompute_bn_stats(cfg, model, 1)
    assert any(not torch.equal(model.state_dict()[k], v) for k, v in stats.items())
    want += [f"dataset{i + 1} mIoU (ss): {m:.4f}"
             for i, m in enumerate(eval_model(cfg, model, get_data_loader(cfg, "eval")))]
    assert lines == want, (lines, want)

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    res = subprocess.run([sys.executable, "tools/evaluate_torch.py", "--config", CFG],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr

