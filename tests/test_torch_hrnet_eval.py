"""HRNet through the port's eval CLI: `tools/evaluate_torch.py --device cpu`
on configs/hrnet_w48_city.json, shrunk by overrides (tests/test_hrnet.py's
TINY_STAGES through `model_kwargs`, 16 features, dataset1 on the Synthetic
reader at 64×64), on a checkpoint holding JAX's weights with random BN
statistics and a random bipartite graph, against JAX's `eval_model` on
the same weights and frames, in ss mode.

Both sides evaluate in f32: both bundles build the model in bf16, and two
bf16 implementations of the same forward (XLA's convs and oneDNN's round
their f32 sums differently) label 0.6% of these pixels apart, so the
test hands the CLI's `build_model` f32 (a monkeypatch of its dtype) and
evaluates JAX's model in f32. The gate is the confusion histogram, equal
entry by entry, each batch's predictions equal and the mIoU. The
CLI builds HRNet through `build_model` → MODELS["hrnet_w48"](configer=…);
`is_alternating` is false for it, as JAX's bundle takes the plain Trainer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_hrnet import TINY_STAGES
from torch_eval_parity import port_recording
from torch_flagship_parity import one_torch_thread, randomize  # noqa: F401
from mds_tpu_torch.deploy.weights import hrnet_state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "hrnet_w48_city.json")
N = 19
OVERRIDES = ["model_kwargs", repr({"stages": TINY_STAGES}), "GNN.output_feat_dim", "16",
             "dataset1.data_reader", "Synthetic", "dataset1.eval_ims_per_gpu", "1",
             "dataset1.reader_kwargs", f"{{'n_cats': {N}, 'size': [64, 64], 'length': 3}}",
             "train.num_workers", "1"]


def jax_eval(jcfg, variables):
    """JAX's eval_model (ss) on the config's model in f32: mIoU and each
    batch's (pred, label), read at its confusion_hist."""
    from mds_tpu.data.loader import get_data_loader as j_loader
    from mds_tpu.engine.trainer import build_model
    from mds_tpu.evaluation import evaluator as jev

    seen = []
    real = jev.confusion_hist

    def recording(label, pred, *a, **k):
        jax.debug.callback(lambda p, lb: seen.append((np.asarray(p), np.asarray(lb))),
                           pred, label)
        return real(label, pred, *a, **k)

    jm = build_model(jcfg, dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "confusion_hist", recording)
        mious = jev.eval_model(jcfg, jm, jax.tree_util.tree_map(jnp.asarray, variables),
                               j_loader(jcfg, "eval"), mode="ss")
    return mious, seen


def hist(seen):
    h = np.zeros((N, N), np.int64)
    for pred, lb in seen:
        keep = lb != 255
        h += np.bincount(lb[keep].astype(np.int64) * N + pred[keep],
                         minlength=N * N).reshape(N, N)
    return h


def test_evaluate_torch_on_hrnet_matches_jax(tmp_path, monkeypatch):
    import sys

    from mds_tpu.config import Configer as JConfiger
    from mds_tpu.engine.trainer import build_model
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine import trainer
    from mds_tpu_torch.engine.checkpoints import CheckpointManager
    from mds_tpu_torch.evaluation.drivers import is_alternating

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import evaluate_torch

    jcfg = JConfiger(config_file=CONFIG, args_parser=list(OVERRIDES))
    assert not is_alternating(Configer(config_file=CONFIG, args_parser=list(OVERRIDES)))
    jm = build_model(jcfg, dtype=jnp.float32)
    v = jax.jit(lambda k: jm.init(k, [jnp.zeros((1, 64, 64, 3))], train=True))(
        jax.random.PRNGKey(0))
    v = randomize(jax.tree_util.tree_map(np.asarray, dict(v)), np.random.default_rng(3))
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).maybe_save(
        {"model": hrnet_state_dict_from_jax(v["params"], v["batch_stats"], v["buffers"]),
         "step": 0}, force=True)

    want_miou, want = jax_eval(jcfg, v)
    real_build = trainer.build_model
    monkeypatch.setattr(trainer, "build_model",
                        lambda cfg, dtype=None, aux=None: real_build(cfg, torch.float32, aux))
    seen = []
    with port_recording(seen):
        got_miou = evaluate_torch.main(["--config", CONFIG, "--device", "cpu", "--ckpt", ckpt,
                                        "--work-dir", str(tmp_path), "--mode", "ss"]
                                       + OVERRIDES)
    assert len(seen) == len(want) == 3
    for (p, lb), (wp, wlb) in zip(seen, want):
        assert p.shape == wp.shape == (1, 64, 64) and np.array_equal(lb, wlb)
        assert np.array_equal(p, wp)
    assert len(np.unique(np.concatenate([p.ravel() for p, _ in seen]))) > 1
    assert np.array_equal(hist(seen), hist(want))
    assert np.allclose(got_miou, want_miou, atol=1e-6)
