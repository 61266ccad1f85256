"""The port's evaluator (mds_tpu_torch/evaluation/evaluator.py) against the
JAX package's, on the CPU at f32, and the port's profiling hooks.

- The pieces: `get_round_size`, `confusion_hist` (square and rectangular,
  with ignored pixels) and `compute_ious` exactly equal; `resize_bilinear_ac`
  at rel <= 1e-6 (measured: 0 at every size here); `_make_evaluator` the
  same protocol for every mode, from the nested `eval` block and from the
  top-level keys.
- The three evaluators with JAX's oracle logits function
  (tests/test_eval.py:92-117, written once for each package): confusion
  hists exactly equal. With a smooth random logits function (one fixed
  numpy 1×1 map of the normalized image, the same in both packages) the
  per-batch predictions agree on >= 99.9% of pixels (measured: all of
  them). JAX's predictions are read inside its jitted batch function by a
  host callback on its `confusion_hist`; its crop evaluator argmaxes on the
  host, and `jax_crop_preds` runs that loop over its own `_crop_eval`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.evaluation.evaluator as jev
import mds_tpu_torch.evaluation.evaluator as tev
from mds_tpu.config import Configer as JConfiger
from mds_tpu_torch.config import Configer
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse

PRED_GATE = 0.999


class OracleLoader:
    """tests/test_eval.py's loader: channel 0 of the image encodes the label
    (class·20), 8×8 blocks, some ignored pixels with `flaw`."""

    def __init__(self, n_classes=4, n_batches=2, hw=(64, 96), flaw=False):
        rng = np.random.default_rng(0)
        self.batches = []
        for _ in range(n_batches):
            lb8 = rng.integers(0, n_classes, (1, hw[0] // 8, hw[1] // 8))
            lb = np.repeat(np.repeat(lb8, 8, 1), 8, 2).astype(np.uint8)
            if flaw:
                lb[:, :8, :8] = 255
            im = (lb.astype(np.float32) * 20.0)[..., None].repeat(3, axis=-1)
            self.batches.append({"im": im.astype(np.uint8), "lb": lb})

    def __iter__(self):
        return iter(self.batches)


class SmoothLoader:
    """Images of random 8×8 colour blocks plus noise, random block labels
    with 5% ignored."""

    def __init__(self, n_classes, n_batches=2, hw=(64, 96), batch=2, seed=1):
        rng = np.random.default_rng(seed)
        self.batches = []
        for _ in range(n_batches):
            im = rng.integers(0, 256, (batch, hw[0] // 8, hw[1] // 8, 3))
            im = np.repeat(np.repeat(im, 8, 1), 8, 2) + rng.normal(0, 6, (batch, *hw, 3))
            lb = np.repeat(np.repeat(rng.integers(0, n_classes, (batch, hw[0] // 8,
                                                                  hw[1] // 8)), 8, 1), 8, 2)
            lb[rng.random(lb.shape) < 0.05] = 255
            self.batches.append({"im": np.clip(im, 0, 255).astype(np.uint8),
                                 "lb": lb.astype(np.uint8)})

    def __iter__(self):
        return iter(self.batches)


def jax_oracle(n):
    def fn(im, dataset):
        cls = jnp.clip(jnp.round(im[..., 0] / 20.0), 0, n - 1).astype(jnp.int32)
        return jax.nn.one_hot(cls, n) * 10.0

    return fn


def port_oracle(n):
    def fn(im, dataset):
        cls = torch.clamp(torch.round(im[:, 0] / 20.0), 0, n - 1).long()
        return torch.nn.functional.one_hot(cls, n).permute(0, 3, 1, 2).float() * 10.0

    return fn


def smooth_map(n, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (3, n)).astype(np.float32),
            rng.normal(0, 0.3, n).astype(np.float32))


def jax_smooth(n):
    k, b = smooth_map(n)

    def fn(im, dataset):
        x = (im / 255.0 - 0.5) / 0.25
        return jnp.einsum("nhwc,ck->nhwk", x, k) + b

    return fn


def port_smooth(n):
    k, b = map(torch.from_numpy, smooth_map(n))

    def fn(im, dataset):
        x = (im / 255.0 - 0.5) / 0.25
        return torch.einsum("nchw,ck->nkhw", x, k) + b.reshape(1, -1, 1, 1)

    return fn


def jax_preds(ev, logits_fn, loader, n, monkeypatch):
    """JAX's per-batch (preds, labels) and its hist, from its own jitted
    batch function: a host callback on its confusion_hist records them."""
    seen = []
    real = jev.confusion_hist

    def recording(label, pred, *a, **k):
        jax.debug.callback(lambda p, lb: seen.append((np.asarray(p), np.asarray(lb))),
                           pred, label)
        return real(label, pred, *a, **k)

    monkeypatch.setattr(jev, "confusion_hist", recording)
    hist = np.zeros((n, n), np.int64)
    for batch in loader:
        im = jnp.asarray(np.asarray(batch["im"]), jnp.float32)
        lb = jnp.asarray(np.asarray(batch["lb"]), jnp.int32)
        hist += np.asarray(ev._batch_fn(logits_fn, n, 0, im.shape)(im, lb), np.int64)
    monkeypatch.setattr(jev, "confusion_hist", real)
    return seen, hist


def jax_crop_preds(ev, logits_fn, loader, n):
    """JAX's MscEvalCrop.__call__ per batch, to its argmax
    (mds_tpu/evaluation/evaluator.py:253-273), over its own `_crop_eval`."""
    seen = []
    for batch in loader:
        im = np.asarray(batch["im"], np.float32)
        lb = np.asarray(batch["lb"]).astype(np.int64)
        N, H, W = lb.shape
        probs = np.zeros((N, H, W, n), np.float32)
        for sc in ev.scales:
            im_sc = np.asarray(jev.resize_bilinear_ac(jnp.asarray(im),
                                                      (int(H * sc), int(W * sc))))
            prob = ev._crop_eval(logits_fn, im_sc, n, 0)
            probs += np.asarray(jev.resize_bilinear_ac(jnp.asarray(prob), (H, W)))
        seen.append((probs.argmax(-1), lb))
    hist = sum(np.asarray(jev.confusion_hist(jnp.asarray(lb), jnp.asarray(p), n), np.int64)
               for p, lb in seen)
    return seen, hist


def port_preds(ev, logits_fn, loader, n):
    seen = []
    with torch.inference_mode():
        for batch in loader:
            im, lb = tev._to_device(batch, "cpu")
            p, lb = ev.predict(logits_fn, im, lb, n, 0)
            seen.append((p.numpy(), lb.numpy()))
    hist = sum(tev.confusion_hist(torch.from_numpy(lb), torch.from_numpy(p), n).numpy()
               for p, lb in seen)
    return seen, hist


def agreement(a, b):
    return min(float((pa == pb).mean()) for (pa, _), (pb, _) in zip(a, b))


# ------------------------------------------------------------------ pieces

def test_get_round_size():
    for size in [(500, 1000), (512, 1024), (1, 33), (1792, 3584), (7, 0)]:
        assert tev.get_round_size(size) == jev.get_round_size(size)
        assert tev.get_round_size(size, 8) == jev.get_round_size(size, 8)


@pytest.mark.parametrize("n,n_pred", [(5, None), (4, 9)])
def test_confusion_hist_equals_jax(n, n_pred):
    rng = np.random.default_rng(1)
    lb = rng.integers(0, n, (2, 8, 8)).astype(np.int64)
    lb[rng.random(lb.shape) < 0.2] = 255
    pred = rng.integers(0, n if n_pred is None else n_pred, (2, 8, 8)).astype(np.int64)
    want = np.asarray(jev.confusion_hist(jnp.asarray(lb), jnp.asarray(pred), n, n_pred=n_pred))
    got = tev.confusion_hist(torch.from_numpy(lb), torch.from_numpy(pred), n, n_pred=n_pred)
    assert got.dtype == torch.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # another ignore value
    lb[lb == 255] = 0
    lb[0, 0] = 7
    want = np.asarray(jev.confusion_hist(jnp.asarray(lb), jnp.asarray(pred), n, 7, n_pred))
    got = tev.confusion_hist(torch.from_numpy(lb), torch.from_numpy(pred), n, 7, n_pred)
    np.testing.assert_array_equal(got.numpy(), want)


def test_compute_ious_equals_jax():
    rng = np.random.default_rng(2)
    for hist in (np.array([[10, 0], [0, 30]]), np.array([[10, 0, 0], [5, 5, 0], [0, 0, 0]]),
                 rng.integers(0, 1000, (19, 19))):
        ti, tm = tev.compute_ious(hist)
        ji, jm = jev.compute_ious(hist)
        np.testing.assert_array_equal(ti, ji)
        assert tm == jm


def test_resize_bilinear_ac_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 13, 17, 4)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for size in [(26, 34), (7, 9), (32, 32), (1, 9), (52, 68)]:
        want = np.asarray(jev.resize_bilinear_ac(jnp.asarray(x), size))
        got = tev.resize_bilinear_ac(xt, size)
        assert got.dtype == torch.float32 and got.shape == (2, 4, *size)
        err = np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-6, (size, err)
    # the size it has: the input itself, in its own dtype (JAX returns x)
    xb = xt.to(torch.bfloat16)
    assert tev.resize_bilinear_ac(xb, (13, 17)) is xb


CFGS = {
    "nested": {"train": {"cropsize": [64, 64]},
               "eval": {"eval_scales": [0.5, 1.0], "eval_crop": [96, 128]}},
    "top-level": {"train": {"cropsize": [64, 64]},
                  "eval_scales": [0.75, 1.25], "eval_crop": [48, 80]},
    "train cropsize": {"train": {"cropsize": [40, 72]}},
    "defaults": {},
}


def protocol(ev):
    return {k: getattr(ev, k, None) for k in (
        "scales", "flip", "cropsize", "cropstride", "ignore_label", "ori_scales",
        "truncate_classes")} | {"type": type(ev).__name__}


@pytest.mark.parametrize("mode", jev.EVAL_MODES)
def test_make_evaluator_matches_jax(mode):
    assert tev.EVAL_MODES == jev.EVAL_MODES
    for name, cfg in CFGS.items():
        got = protocol(tev._make_evaluator(Configer(configs=cfg), mode))
        want = protocol(jev._make_evaluator(JConfiger(configs=cfg), mode))
        assert got == want, (name, got, want)
    with pytest.raises(ValueError):
        tev._make_evaluator(Configer(configs={}), "nope")


# -------------------------------------------------------------- evaluators

ORACLE_CASES = {
    "V0 ss": lambda: (jev.MscEvalV0(scales=(1.0,)), tev.MscEvalV0(scales=(1.0,))),
    "V0 ms flip": lambda: (jev.MscEvalV0(scales=(0.5, 1.0, 1.5), flip=True),
                           tev.MscEvalV0(scales=(0.5, 1.0, 1.5), flip=True)),
    "contrast": lambda: (jev.MscEvalV0Contrast(), tev.MscEvalV0Contrast()),
    "contrast truncate": lambda: (jev.MscEvalV0Contrast(truncate_classes=True),
                                  tev.MscEvalV0Contrast(truncate_classes=True)),
    "crop flip": lambda: (
        jev.MscEvalCrop(cropsize=(32, 32), flip=True, scales=(0.75, 1.0)),
        tev.MscEvalCrop(cropsize=(32, 32), flip=True, scales=(0.75, 1.0))),
}


def run_both(case, jfn, tfn, loader, n, monkeypatch):
    je, te = ORACLE_CASES[case]()
    if isinstance(je, jev.MscEvalCrop):
        jseen, jhist = jax_crop_preds(je, jfn, loader, n)
        jmiou = je(jfn, loader, n, 0)
    else:
        jseen, jhist = jax_preds(je, jfn, loader, n, monkeypatch)
        jmiou = jev.compute_ious(jhist)[1]
    tseen, thist = port_preds(te, tfn, loader, n)
    tmiou = te(tfn, loader, n, 0)
    assert len(te.timings) == len(loader.batches)
    return jseen, jhist, jmiou, tseen, thist, tmiou


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_evaluators_oracle_hist_equals_jax(case, monkeypatch):
    """JAX's oracle (one-hot ×10 of the class channel 0 encodes): the
    confusion hists exactly equal, over ignored pixels too. The truncating
    contrast case feeds 6 logit channels and scores 4."""
    n = 4
    wide = case == "contrast truncate"
    jfn, tfn = (jax_oracle(6), port_oracle(6)) if wide else (jax_oracle(n), port_oracle(n))
    loader = OracleLoader(n, flaw=True)
    jseen, jhist, jmiou, tseen, thist, tmiou = run_both(case, jfn, tfn, loader, n,
                                                         monkeypatch)
    np.testing.assert_array_equal(thist, jhist)
    assert tmiou == jmiou and tmiou > 0.85  # the 0.5 scale blurs block borders
    for (tp, tl), (jp, jl) in zip(tseen, jseen):
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_evaluators_smooth_preds_match_jax(case, monkeypatch):
    """A smooth random logits map: per-batch predictions agree on >= 99.9%
    of pixels, over more than one class, and the mIoU follows."""
    n = 5
    wide = case == "contrast truncate"
    jfn, tfn = (jax_smooth(7), port_smooth(7)) if wide else (jax_smooth(n), port_smooth(n))
    loader = SmoothLoader(n)
    jseen, jhist, jmiou, tseen, thist, tmiou = run_both(case, jfn, tfn, loader, n,
                                                         monkeypatch)
    assert agreement(tseen, jseen) >= PRED_GATE, agreement(tseen, jseen)
    assert min(len(np.unique(p)) for p, _ in tseen) >= 3
    assert abs(tmiou - jmiou) <= 2e-3, (tmiou, jmiou)


def test_evaluator_call_is_predict_then_hist():
    """__call__ = per batch predict → confusion_hist, summed, then the
    mIoU of the sum; one timing per batch."""
    n = 5
    ev = tev.MscEvalV0(scales=(0.5, 1.0), flip=True)
    loader = SmoothLoader(n, n_batches=3)
    _, hist = port_preds(ev, port_smooth(n), loader, n)
    assert ev(port_smooth(n), loader, n, 0) == tev.compute_ious(hist)[1]
    assert [t["dataset"] for t in ev.timings] == [0, 0, 0]
    assert all(t["ms"] > 0 for t in ev.timings)


def test_crop_windows_match_jax():
    for crop, H, W in [((32, 32), 64, 96), ((512, 1024), 1792, 3584),
                       ((512, 1024), 1024, 2048), ((32, 32), 32, 32), ((48, 80), 70, 81)]:
        t = tev.MscEvalCrop(cropsize=crop)._windows(H, W)
        assert t == jev.MscEvalCrop(cropsize=crop)._windows(H, W)
    assert len(tev.MscEvalCrop(cropsize=(512, 1024))._windows(1792, 3584)) == 25


# ---------------------------------------------------------------- profiling

def test_step_timer_counts_and_trace_writes(tmp_path):
    from mds_tpu_torch.utils.profiling import StepTimer, trace

    t = StepTimer()
    for _ in range(3):
        t.start()
        dt = t.stop([torch.ones(4) * 2, {"x": torch.zeros(2)}])
        assert dt >= 0
    assert t._n == 3 and t.total >= 0 and t.mean == t.total / 3
    with trace(str(tmp_path / "tr")):
        torch.nn.functional.conv2d(torch.ones(1, 3, 16, 16), torch.ones(4, 3, 3, 3))
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "conv" in open(tmp_path / "tr" / files[0]).read()
