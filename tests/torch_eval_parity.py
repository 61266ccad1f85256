"""Helpers of the evaluation slice's tests (tests/test_torch_eval_*.py):
the config, the weights of both packages, each package's `eval_model`
with its per-batch predictions recorded, and the agreement of two runs."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.evaluation.evaluator as jev
import mds_tpu_torch.evaluation.evaluator as tev
from mds_tpu.config import Configer as JConfiger
from mds_tpu.data.loader import get_data_loader as j_loader
from mds_tpu.models import bisenetv2 as jb
from mds_tpu_torch import MODELS
from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.loader import get_data_loader
from mds_tpu_torch.deploy.weights import (
    bisenetv2_state_dict_from_jax,
    load_reference_weights,
)
from torch_parity import make_variables  # noqa: F401 — the tests' weights

CFG = "configs/test_synthetic.json"
N_CLASSES = (5, 7)
PRED_GATE = 0.999
MIOU_GATE = 2e-3


def configs(cls):
    cfg = cls(config_file=CFG)
    cfg.update(["eval", "eval_scales"], [0.5, 1.0])
    cfg.update(["eval", "eval_crop"], [32, 32])
    return cfg


def port_model(weights, dtype=torch.float32):
    tm = MODELS["bisenetv2"](n_classes=N_CLASSES, n_bn=2, aux=True, dtype=dtype)
    load_reference_weights(tm, bisenetv2_state_dict_from_jax(*weights))
    return tm.eval()


def recording_crop_call(seen):
    """JAX's MscEvalCrop.__call__ (mds_tpu/evaluation/evaluator.py:253-277)
    with one added line that records each batch's predictions."""
    def call(self, logits_fn, loader, n_classes, dataset_id=0, preprocess=None):
        hist = np.zeros((n_classes, n_classes), np.int64)
        for batch in loader:
            im = np.asarray(batch["im"], np.float32)
            if preprocess is not None:
                im = preprocess(im)
            lb = np.asarray(batch["lb"]).astype(np.int64)
            N, H, W = lb.shape
            probs = np.zeros((N, H, W, n_classes), np.float32)
            for sc in self.scales:
                sH, sW = int(H * sc), int(W * sc)
                im_sc = np.asarray(jev.resize_bilinear_ac(jnp.asarray(im), (sH, sW)))
                prob = self._crop_eval(logits_fn, im_sc, n_classes, dataset_id)
                probs += np.asarray(jev.resize_bilinear_ac(jnp.asarray(prob), (H, W)))
            preds = probs.argmax(-1)
            seen.append((preds, lb))  # the added line
            keep = lb != self.ignore_label
            hist += np.bincount(lb[keep] * n_classes + preds[keep],
                                minlength=n_classes**2).reshape(n_classes, n_classes)
        return jev.compute_ious(jev._psum_hist(hist))[1]

    return call


def jax_eval(weights, mode):
    """JAX's eval_model on the config: (mIoU per dataset, per-batch
    (preds, labels))."""
    seen = []
    real = jev.confusion_hist

    def recording(label, pred, *a, **k):
        jax.debug.callback(lambda p, lb: seen.append((np.asarray(p), np.asarray(lb))),
                           pred, label)
        return real(label, pred, *a, **k)

    cfg = configs(JConfiger)
    jm = jb.BiSeNetV2(n_classes=N_CLASSES, n_bn=2, aux=True, dtype=jnp.float32)
    params, stats = weights
    variables = {"params": params, "batch_stats": stats}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jev, "confusion_hist", recording)
        mp.setattr(jev.MscEvalCrop, "__call__", recording_crop_call(seen))
        mious = jev.eval_model(cfg, jm, variables, j_loader(cfg, "eval"), mode=mode)
    return mious, seen


@contextlib.contextmanager
def port_recording(seen):
    real = tev.confusion_hist

    def recording(label, pred, *a, **k):
        seen.append((pred.cpu().numpy(), label.cpu().numpy()))
        return real(label, pred, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tev, "confusion_hist", recording)
        yield


def port_eval(model, mode, cfg=None):
    cfg = configs(Configer) if cfg is None else cfg
    seen = []
    with port_recording(seen):
        mious = tev.eval_model(cfg, model, get_data_loader(cfg, "eval"), mode=mode)
    return mious, seen


def agreement(a, b):
    assert len(a) == len(b) and all(pa.shape == pb.shape for (pa, _), (pb, _) in zip(a, b))
    return min(float((pa == pb).mean()) for (pa, _), (pb, _) in zip(a, b))


@contextlib.contextmanager
def deploy_routes():
    """The served routes but the pred tail, as the evaluated forward runs
    them (the caller's switches, bench.py:66-98)."""
    from mds_tpu_torch.models import layers

    layers.set_stem_impl("kernel")
    layers.set_detail_fuse(True)
    layers.set_detail_tail(True)
    layers.set_depthwise_impl("kernel")
    try:
        yield
    finally:
        layers.set_stem_impl("plain")
        layers.set_detail_fuse(False)
        layers.set_detail_tail(False)
        layers.set_depthwise_impl("plain")


# the f32 comparison's weights: the port's seeded init, BN randomized (seeds
# 0-2 give one class everywhere in some mode; 3 does not)
WEIGHT_SEED = 3


def class_shares(seen):
    """Per dataset (8 batches each), the share of pixels of the second most
    predicted class."""
    shares = []
    for k in (0, 8):
        counts = np.bincount(np.concatenate([p.ravel() for p, _ in seen[k:k + 8]]),
                             minlength=2)
        shares.append(np.sort(counts)[-2] / counts.sum())
    return shares


def check_against_jax(weights, mode):
    """The slice's gates in one mode: the same labels batch by batch, the
    predictions agreeing on >= 99.9% of every batch's pixels, not one class
    everywhere, each dataset's mIoU within 2e-3 of JAX's."""
    jm, jseen = jax_eval(weights, mode)
    tm, tseen = port_eval(port_model(weights), mode)
    assert len(tseen) == len(jseen) == 16  # 8 frames of each dataset, one a batch
    for (_, tl), (_, jl) in zip(tseen, jseen):
        np.testing.assert_array_equal(tl, jl)
    assert agreement(tseen, jseen) >= PRED_GATE, agreement(tseen, jseen)
    # in one dataset at least the second class covers >= 5% of the pixels
    # (measured: 6.0, 7.5, 8.3, 6.0 and 10.5% in ss, msf, mscf, uni, contrast)
    assert max(class_shares(tseen)) >= 0.05, class_shares(tseen)
    assert np.allclose(tm, jm, rtol=0, atol=MIOU_GATE), (tm, jm)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work in one thread while the module runs: the tier-1
    run's xdist workers share the cores, and PyTorch's thread pools in
    several processes at once wait on each other far longer than one
    thread computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
