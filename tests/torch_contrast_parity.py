"""Shared helpers of the contrast family's parity tests
(tests/test_torch_contrast_*.py): the tiny contrast config, JAX's anchor
noise for a key, the dropout stubs, and the JAX model with its variables
next to the port's."""

import copy
import json
import os

import jax
import numpy as np

from torch_parity import randomize_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRAST_3DS = os.path.join(ROOT, "configs", "bisenetv2_contrast_3ds.json")

# configs/test_synthetic.json (2 datasets of 5 and 7 classes, Synthetic
# 64×64 frames, 32×32 crops) plus a unified space of 8 classes with single
# and multiple mappings, the contrast block and the EMA teacher
TINY_REMAP = {
    "num_unify_classes": 8,
    "class_remap1": {"0": [0], "1": [1], "2": [2, 3], "3": [4], "4": [5]},
    "class_remap2": {"0": [0], "1": [6], "2": [7], "3": [1, 2], "4": [3], "5": [4],
                     "6": [5]},
    "contrast": {"proj_dim": 16, "temperature": 0.07, "base_temperature": 0.07,
                 "max_views": 2, "loss_weight": 0.1, "memory_bank_size": 4,
                 "ema_momentum": 0.9},
    "use_ema": True,
}


def tiny_contrast_config(**train):
    """The tiny contrast config as a dict: train.mode contrast, warmup of 1
    step (the contrast term off at step 0, on from step 1)."""
    with open(os.path.join(ROOT, "configs", "test_synthetic.json")) as f:
        cfg = json.load(f)
    cfg.update(copy.deepcopy(TINY_REMAP))
    cfg["model_name"] = "bisenetv2_contrast"
    cfg["train"].update({"mode": "contrast", "num_workers": 1, **train})
    cfg["lr"]["warmup_iters"] = 1
    return cfg


def write_config(cfg, path):
    with open(path, "w") as f:
        json.dump(cfg, f)
    return str(path)


def jax_noise(key, n_classes, n_pixels):
    """The uniform draws JAX's hard_anchor_sample makes from `key`
    (mds_tpu/losses/contrast.py:44-47), as the port's (C, P) noise."""
    keys = jax.random.split(key, n_classes)
    return np.stack([np.asarray(jax.random.uniform(k, (n_pixels,))) for k in keys])


def jax_step_noise(step, n_datasets, n_classes, n_pixels):
    """Each dataset's anchor noise of JAX's ContrastTrainer step `step`
    (mds_tpu/engine/contrast_trainer.py: fold_in(PRNGKey(0), step), split
    per dataset); `n_pixels` per dataset."""
    rngs = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), step), n_datasets)
    return [jax_noise(r, n_classes, p) for r, p in zip(rngs, n_pixels)]


def no_jax_contrast_dropout(monkeypatch):
    """JAX's FastDropout in the contrast model stubbed to the identity."""
    import mds_tpu.models.bisenetv2_contrast as jbc

    monkeypatch.setattr(jbc, "FastDropout", lambda rate: (lambda x, deterministic=True: x))


def contrast_variables(seed, **model_kw):
    """JAX variables (numpy trees) of a BiSeNetV2Contrast built with
    `model_kw`: the port's seeded init carried into JAX by JAX's own
    importer (`bisenetv2_contrast_from_torch`), BN randomized from numpy
    seed `seed + 100`. No JAX compile: flax's init of this model is one."""
    import torch

    from mds_tpu.deploy.torch_import import bisenetv2_contrast_from_torch
    from mds_tpu_torch.models.bisenetv2_contrast import BiSeNetV2Contrast

    tm = BiSeNetV2Contrast(**model_kw)
    tm.init_weights(torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats, _ = bisenetv2_contrast_from_torch(sd, n_bn=tm.n_bn)
    return randomize_variables({"params": params, "batch_stats": stats},
                               np.random.default_rng(seed + 100))
