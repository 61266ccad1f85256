"""The contrast trainer's checkpoints, its CLI and its evaluation, on the
CPU.

- Save, restore and resume: `train_contrast` for 2 steps on the tiny
  contrast config (tests/torch_contrast_parity.py) saves each step; a fresh
  trainer restores the last exactly (student, SGD state, teacher, bank,
  step); a second call resumes to step 3.
- `tools/train_torch.py` in mode contrast, `--device cpu`, 2 steps and a
  resume to 3, then `tools/evaluate_torch.py --mode emb` on its checkpoint,
  in a process that never imports jax; without CUDA and without `--device
  cpu` the train CLI refuses.
- `build_eval_bundle` on a contrast checkpoint (JAX's variables with
  randomized BN and a bank JAX pushed, saved by the port's trainer): the
  model restored exactly, its prototypes the bank's class means
  (`feats.mean(axis=1, keepdims=True)`); then `eval_model` in modes
  contrast and emb, f32, against JAX's `eval_model` on the same variables
  and prototypes: every batch's labels equal, the predictions agreeing on
  >= 99.9% of each batch's pixels, each dataset's mIoU within 2e-3
  (tests/torch_eval_parity.py's gates).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.evaluation.evaluator as jev
from mds_tpu.config import Configer as JConfiger
from mds_tpu.data.loader import get_data_loader as j_loader
from mds_tpu.losses import contrast as jc
from mds_tpu.models.bisenetv2_contrast import BiSeNetV2Contrast as JModel
from mds_tpu_torch.config import Configer
from mds_tpu_torch.deploy.weights import bisenetv2_contrast_state_dict_from_jax
from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer, train_contrast
from mds_tpu_torch.engine.optim import optimizer_state
from mds_tpu_torch.evaluation.drivers import build_eval_bundle
from mds_tpu_torch.losses.contrast import MemoryBank
from mds_tpu_torch.models.bisenetv2_contrast import BiSeNetV2Contrast
from mds_tpu_torch.utils.metrics_writer import read_metrics
from torch_contrast_parity import ROOT, contrast_variables, tiny_contrast_config, write_config
from torch_eval_parity import (  # noqa: F401 — one_torch_thread: autouse
    MIOU_GATE,
    PRED_GATE,
    agreement,
    one_torch_thread,
    port_eval,
)


def _state(tt):
    return {"model": tt.model.state_dict(), "teacher": tt.teacher.state_dict(),
            "opt": optimizer_state(tt.model, tt.optimizer),
            "bank": (tt.bank.feats, tt.bank.ptr, tt.bank.count), "step": tt.step_count}


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def test_save_restore_and_resume(tmp_path):
    cfg = tiny_contrast_config(ckpt_interval=1, log_interval=1)
    cfg["lr"]["max_iter"] = 2
    work = str(tmp_path)
    run = train_contrast(Configer(configs=cfg), work_dir=work, device="cpu")
    assert run.step_count == 2 and run.ckpt.all_steps() == [1, 2]
    assert [r["step"] for r in read_metrics(os.path.join(work, "runs"))] == [1, 2]
    assert all(r["step_ms"] > 0 and r["teacher_ms"] > 0 and r["push_ms"] > 0
               for r in run.timings)
    assert int(run.bank.count.sum()) > 0
    fresh = ContrastTrainer(Configer(configs=cfg), work_dir=work, device="cpu")
    assert not _same(_state(fresh), _state(run))
    fresh.restore()
    assert _same(_state(fresh), _state(run))
    cfg["lr"]["max_iter"] = 3
    resumed = train_contrast(Configer(configs=cfg), work_dir=work, device="cpu")
    assert resumed.step_count == 3 and resumed.ckpt.all_steps() == [1, 2, 3]
    assert [r["step"] for r in resumed.timings] == [3]


def test_train_torch_cli_contrast_on_cpu(tmp_path):
    """tools/train_torch.py in mode contrast, --device cpu, 2 steps and a
    resume to 3, then tools/evaluate_torch.py --mode emb on the checkpoint,
    in a process that never imports jax; without CUDA and without --device
    cpu the train CLI refuses."""
    cfg = tiny_contrast_config(log_interval=1)
    for i in (1, 2):
        cfg[f"dataset{i}"]["reader_kwargs"]["length"] = 2
    path = write_config(cfg, tmp_path / "contrast.json")
    work = str(tmp_path / "work")
    code = ("import sys; sys.path.insert(0, 'tools'); import train_torch, evaluate_torch; "
            "t = train_torch.main(sys.argv[1:] + ['--max-iter', '2']); "
            "assert type(t).__name__ == 'ContrastTrainer' and t.step_count == 2; "
            "t = train_torch.main(sys.argv[1:] + ['--max-iter', '3']); "
            "assert t.step_count == 3 and t.ckpt.all_steps() == [2, 3], t.ckpt.all_steps(); "
            "m = evaluate_torch.main(sys.argv[1:] + ['--mode', 'emb']); "
            "assert len(m) == 2 and all(0 <= x <= 1 for x in m), m; "
            "bad = {'jax', 'jaxlib', 'flax', 'mds_tpu'} & set(sys.modules); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-c", code, "--config", path, "--device", "cpu", "--work-dir", work],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "iter 2/2" in res.stderr and "contrast=" in res.stderr and "iter 3/3" in res.stderr
    assert "dataset2 mIoU (emb)" in res.stdout
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    res = subprocess.run([sys.executable, "tools/train_torch.py", "--config", path],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "CUDA" in res.stderr


# ------------------------------------------------------------ evaluation

def _eval_config(cls):
    cfg = cls(configs=tiny_contrast_config())
    for i in (1, 2):  # 4 frames a dataset
        cfg.update([f"dataset{i}", "reader_kwargs", "length"], 4)
    return cfg


@pytest.fixture(scope="module")
def contrast_checkpoint(tmp_path_factory):
    """A port contrast checkpoint holding the JAX side's variables (the
    port's init through JAX's importer, BN randomized) and a bank JAX pushed
    3 times; with the JAX side's model, variables and bank."""
    cfg = tiny_contrast_config()
    jm = JModel.from_configer(JConfiger(configs=cfg), dtype=jnp.float32)
    v = contrast_variables(7, num_unify_classes=8, datasets_cats=(5, 7), n_bn=2, proj_dim=16)
    rng = np.random.default_rng(8)
    bank = jc.MemoryBank.create(8, 4, 16)
    for _ in range(3):
        f = rng.normal(0, 1, (64, 16)).astype(np.float32)
        bank = jc.memory_bank_push(bank, jnp.asarray(f), jnp.asarray(rng.integers(0, 8, 64)),
                                   None)
    bank = jax.tree_util.tree_map(np.array, bank)
    work = str(tmp_path_factory.mktemp("contrast_eval"))
    tt = ContrastTrainer(Configer(configs=cfg), work_dir=work, device="cpu")
    tt.model.load_state_dict(bisenetv2_contrast_state_dict_from_jax(v["params"],
                                                                    v["batch_stats"]))
    tt.teacher.load_state_dict(tt.model.state_dict())
    tt.bank = MemoryBank(*(torch.from_numpy(np.array(t)) for t in bank))
    assert tt.maybe_save(force=True)
    return jm, v, bank, tt.ckpt.directory


def test_build_eval_bundle_restores_the_contrast_checkpoint(contrast_checkpoint):
    _, v, bank, ckpt = contrast_checkpoint
    model = build_eval_bundle(Configer(configs=tiny_contrast_config()), ckpt=ckpt,
                              device="cpu")
    assert isinstance(model, BiSeNetV2Contrast) and not model.training
    assert model.dtype == torch.bfloat16
    want = bisenetv2_contrast_state_dict_from_jax(v["params"], v["batch_stats"])
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, want[k]), k
    protos = np.asarray(bank.feats).mean(axis=1, keepdims=True)
    assert model.prototypes.shape == (8, 1, 16)
    np.testing.assert_allclose(model.prototypes.numpy(), protos, rtol=1e-6, atol=1e-7)


def _jax_eval(jm, variables, mode, method_kwargs):
    seen = []
    real = jev.confusion_hist

    def recording(label, pred, *a, **k):
        jax.debug.callback(lambda p, lb: seen.append((np.asarray(p), np.asarray(lb))),
                           pred, label)
        return real(label, pred, *a, **k)

    cfg = _eval_config(JConfiger)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "confusion_hist", recording)
        mious = jev.eval_model(cfg, jm, variables, j_loader(cfg, "eval"), mode=mode,
                               method_kwargs=method_kwargs)
    return mious, seen


@pytest.mark.parametrize("mode", ["contrast", "emb"])
def test_eval_model_matches_jax(contrast_checkpoint, mode):
    jm, v, bank, ckpt = contrast_checkpoint
    bundle = build_eval_bundle(Configer(configs=tiny_contrast_config()), ckpt=ckpt,
                               device="cpu")
    # the f32 comparison: the bundle's weights and prototypes in an f32 model
    tm = BiSeNetV2Contrast.from_configer(Configer(configs=tiny_contrast_config()))
    tm.load_state_dict(bundle.state_dict())
    tm.prototypes = bundle.prototypes
    protos = np.asarray(bank.feats).mean(axis=1, keepdims=True)
    jm_, jseen = _jax_eval(jm, {"params": v["params"], "batch_stats": v["batch_stats"]},
                           mode, {"prototypes": protos} if mode == "emb" else None)
    got, tseen = port_eval(tm.eval(), mode, _eval_config(Configer))
    assert len(tseen) == len(jseen) == 8
    for (_, a), (_, b) in zip(tseen, jseen):
        np.testing.assert_array_equal(a, b)
    assert agreement(tseen, jseen) >= PRED_GATE, agreement(tseen, jseen)
    assert len({int(c) for p, _ in tseen for c in np.unique(p)}) > 1
    assert np.allclose(got, jm_, rtol=0, atol=MIOU_GATE), (got, jm_)
