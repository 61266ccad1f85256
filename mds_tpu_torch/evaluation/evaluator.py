"""mIoU evaluation: single-scale, multi-scale + flip, and sliding crops.

Counterpart of mds_tpu/evaluation/evaluator.py (`get_round_size` :33,
`confusion_hist` :38, `compute_ious` :54, `MscEvalV0` :63,
`MscEvalV0Contrast` :116, `MscEvalCrop` :167, `_psum_hist` :280,
`make_logits_fn` :299, `EVAL_MODES` :334, `_make_evaluator` :340,
`eval_model` :380).

- Images are logically NCHW, stored channels_last: the loader's uint8 NHWC
  batch, moved to the device and permuted. The evaluators see raw pixels
  (0-255) in f32; `make_logits_fn` normalizes in front of the model.
- Each evaluator's per-batch work is `predict` (resizes, forwards, the f32
  prob sum, argmax) followed by `confusion_hist`, as JAX's jitted `run`
  composes them. The hist accumulates on the device and is read back once
  per dataset.
- The dtype flow is JAX's: a scale whose rounded size is the input's leaves
  the logits unresized in the compute dtype, and their softmax is taken in
  that dtype; resized logits are f32.
- `timings` holds the ms of each batch: CUDA events on the card, the host
  clock on the CPU, from the batch's copy to the device to its hist.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from mds_tpu_torch.models.layers import resize_bilinear_ac
from mds_tpu_torch.parallel import mesh


def get_round_size(size: Sequence[int], divisor: int = 32) -> Tuple[int, int]:
    """Round sizes up to the divisor."""
    return tuple(math.ceil(el / divisor) * divisor for el in size)


def confusion_hist(label: torch.Tensor, pred: torch.Tensor, n_classes: int,
                   ignore: int = 255, n_pred: Optional[int] = None) -> torch.Tensor:
    """(n_classes, n_pred) int64 confusion counts on the tensors' device,
    rows = label, cols = pred; ignored pixels go to one extra bin, dropped."""
    n_pred = n_classes if n_pred is None else n_pred
    label = label.reshape(-1).long()
    pred = pred.reshape(-1).long()
    idx = torch.where(label != ignore, label * n_pred + pred, n_classes * n_pred)
    flat = torch.bincount(idx, minlength=n_classes * n_pred + 1)
    return flat[: n_classes * n_pred].reshape(n_classes, n_pred)


def compute_ious(hist):
    """Per-class IoU and their nanmean (mIoU), in numpy f64."""
    hist = np.asarray(hist, np.float64)
    denom = hist.sum(0) + hist.sum(1) - np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        ious = np.diag(hist) / denom
    return ious, float(np.nanmean(ious))


def _zeros(n, c, h, w, device) -> torch.Tensor:
    """An f32 (n, c, h, w) zero volume stored channels_last."""
    return torch.zeros((n, h, w, c), dtype=torch.float32, device=device).permute(0, 3, 1, 2)


def _flip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=[3])


def _to_device(batch, device):
    """A loader batch → (raw f32 NCHW images, int64 labels) on `device`,
    copied as the loader's uint8 and widened there."""
    im = torch.from_numpy(np.ascontiguousarray(batch["im"])).to(device)
    im = im.float().permute(0, 3, 1, 2)
    lb = torch.from_numpy(np.ascontiguousarray(batch["lb"])).to(device).long()
    return im, lb


class _BatchClock:
    """Per-batch ms: CUDA events on the card (read after the hist is read
    back), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append([ev, None])
        else:
            self.marks.append([time.perf_counter(), None])

    def stop(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1][1] = ev
        else:
            self.marks[-1][1] = time.perf_counter()

    def read(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


class _Evaluator:
    """The loop every evaluator shares: per batch, `predict` then the hist."""

    def predict(self, logits_fn, im, lb, n_classes: int, dataset_id: int):
        """(preds, labels they are scored against) of one batch."""
        raise NotImplementedError

    @torch.inference_mode()
    def __call__(self, logits_fn, loader, n_classes: int, dataset_id: int = 0,
                 device="cpu") -> float:
        hist = torch.zeros((n_classes, n_classes), dtype=torch.int64, device=device)
        clock = _BatchClock(device)
        for batch in loader:
            clock.start()
            im, lb = _to_device(batch, device)
            preds, labels = self.predict(logits_fn, im, lb, n_classes, dataset_id)
            hist += confusion_hist(labels, preds, n_classes, self.ignore_label)
            clock.stop()
        hist = _psum_hist(hist.cpu().numpy())
        self.timings.extend({"dataset": dataset_id, "ms": ms} for ms in clock.read())
        _, miou = compute_ious(hist)
        return miou


class MscEvalV0(_Evaluator):
    """Multi-scale (+ flip) whole-image evaluation.

    `logits_fn(im_f32_nchw, dataset) -> (N, n_classes, h, w)`: raw images
    at any size; typically `make_logits_fn` over the model's eval_logits.
    """

    def __init__(self, scales=(0.5,), flip: bool = False, ignore_label: int = 255):
        self.scales = tuple(scales)
        self.flip = flip
        self.ignore_label = ignore_label
        self.timings: List[dict] = []

    def predict(self, logits_fn, im, lb, n_classes, dataset_id):
        N, _, H, W = im.shape
        probs = _zeros(N, n_classes, H, W, im.device)
        for scale in self.scales:
            im_sc = resize_bilinear_ac(im, get_round_size((int(scale * H), int(scale * W))))
            logits = resize_bilinear_ac(logits_fn(im_sc, dataset_id), (H, W))
            probs += torch.softmax(logits, dim=1)
            if self.flip:
                logits = _flip(logits_fn(_flip(im_sc), dataset_id))
                probs += torch.softmax(resize_bilinear_ac(logits, (H, W)), dim=1)
        return probs.argmax(dim=1), lb


class MscEvalV0Contrast(MscEvalV0):
    """The GNN-era protocol: with ori_scales=False the logits stay at their
    own resolution and the LABEL is nearest-downsampled to it
    (arange(lh)·H // lh); with ori_scales=True it is MscEvalV0.
    truncate_classes keeps the first n_classes logit channels."""

    def __init__(self, scales=(0.5,), flip=False, ignore_label=255,
                 ori_scales=False, truncate_classes=False):
        super().__init__(scales, flip, ignore_label)
        self.ori_scales = ori_scales
        self.truncate_classes = truncate_classes

    def predict(self, logits_fn, im, lb, n_classes, dataset_id):
        if self.ori_scales:
            return super().predict(logits_fn, im, lb, n_classes, dataset_id)
        H, W = im.shape[2:]
        probs = lb_small = None
        for scale in self.scales:
            im_sc = resize_bilinear_ac(im, get_round_size((int(scale * H), int(scale * W))))
            logits = logits_fn(im_sc, dataset_id)
            if self.truncate_classes:
                logits = logits[:, :n_classes]
            lh, lw = logits.shape[2:]
            if lb_small is None:
                ys = torch.arange(lh, device=lb.device) * H // lh
                xs = torch.arange(lw, device=lb.device) * W // lw
                lb_small = lb[:, ys][:, :, xs]
            p = torch.softmax(logits.float(), dim=1)
            probs = p if probs is None else probs + p
            if self.flip:
                lg = _flip(logits_fn(_flip(im_sc), dataset_id))
                if self.truncate_classes:
                    lg = lg[:, :n_classes]
                probs = probs + torch.softmax(lg.float(), dim=1)
        return probs.argmax(dim=1), lb_small


class MscEvalCrop(_Evaluator):
    """Sliding-window crop evaluation: each scale's image (raw, zero-padded
    to the crop size and centred) cut into 2/3-stride windows that go
    through the model as one batch (+ its flip), their probs added back
    into the padded volume in window order, and each scale's probs resized
    to the input size and summed."""

    def __init__(self, cropsize=1024, cropstride=2.0 / 3, flip=True,
                 scales=(0.5, 0.75, 1.0, 1.25, 1.5, 1.75), lb_ignore=255):
        self.cropsize = (
            tuple(cropsize) if isinstance(cropsize, (tuple, list)) else (cropsize, cropsize)
        )
        self.cropstride = cropstride
        self.flip = flip
        self.scales = tuple(scales)
        self.ignore_label = lb_ignore
        self.timings: List[dict] = []

    def _windows(self, H: int, W: int) -> List[Tuple[int, int]]:
        """The windows' (top, left) offsets, row by row."""
        cropH, cropW = self.cropsize
        strdH = math.ceil(cropH * self.cropstride)
        strdW = math.ceil(cropW * self.cropstride)
        n_h = math.ceil((H - cropH) / strdH) + 1
        n_w = math.ceil((W - cropW) / strdW) + 1
        return [
            (min(strdH * i, H - cropH), min(strdW * j, W - cropW))
            for i in range(n_h)
            for j in range(n_w)
        ]

    def _crop_probs(self, logits_fn, padded, dataset_id):
        """Every window of the padded image in one batch (window-major)
        through logits_fn; their probs added into an f32 volume."""
        N, _, H, W = padded.shape
        cropH, cropW = self.cropsize
        windows = self._windows(H, W)
        chips = torch.cat([padded[:, :, sh:sh + cropH, sw:sw + cropW]
                           for sh, sw in windows], dim=0)
        # logits below the chip's size (1/4-res prototype heads) are lifted to it
        logits = resize_bilinear_ac(logits_fn(chips, dataset_id), (cropH, cropW))
        prob = torch.softmax(logits.float(), dim=1)
        if self.flip:
            lg = _flip(logits_fn(_flip(chips), dataset_id))
            lg = resize_bilinear_ac(lg, (cropH, cropW))
            # JAX's (and the reference's) exp of the flip-summed prob, which
            # leaves the argmax as it is
            prob = torch.exp(prob + torch.softmax(lg.float(), dim=1))
        out = _zeros(N, prob.shape[1], H, W, padded.device)
        for i, (sh, sw) in enumerate(windows):
            out[:, :, sh:sh + cropH, sw:sw + cropW] += prob[i * N:(i + 1) * N]
        return out

    def _crop_eval(self, logits_fn, im, dataset_id):
        cropH, cropW = self.cropsize
        N, C, H0, W0 = im.shape
        padH, padW = max(cropH, H0), max(cropW, W0)
        hst, wst = (padH - H0) // 2, (padW - W0) // 2
        padded = _zeros(N, C, padH, padW, im.device)
        padded[:, :, hst:hst + H0, wst:wst + W0] = im
        prob = self._crop_probs(logits_fn, padded, dataset_id)
        return prob[:, :, hst:hst + H0, wst:wst + W0]

    def predict(self, logits_fn, im, lb, n_classes, dataset_id):
        N, _, H, W = im.shape
        probs = _zeros(N, n_classes, H, W, im.device)
        for sc in self.scales:
            im_sc = resize_bilinear_ac(im, (int(H * sc), int(W * sc)))
            probs += resize_bilinear_ac(self._crop_eval(logits_fn, im_sc, dataset_id),
                                        (H, W))
        return probs.argmax(dim=1), lb


def _psum_hist(hist: np.ndarray) -> np.ndarray:
    """The hist summed over the processes of the group (an int64
    all_reduce, parallel/mesh.py), each having scored its rank's share of
    the loader; without a group, the hist."""
    if not mesh.initialized():
        return hist
    return mesh.all_reduce(torch.from_numpy(np.ascontiguousarray(hist, np.int64))).numpy()


def make_logits_fn(model, mean, std, method=None):
    """The model's eval method with the normalization in front:
    (im/255 − mean)/std in f32 on the model's device, then the method
    (`eval_logits` by default; a method name or a bound method)."""
    dev = next(model.parameters()).device
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=dev).reshape(1, 3, 1, 1)
    std = torch.as_tensor(np.asarray(std, np.float32), device=dev).reshape(1, 3, 1, 1)
    if method is None:
        method = model.eval_logits
    elif isinstance(method, str):
        method = getattr(model, method)

    def logits_fn(im, dataset):
        return method((im / 255.0 - mean) / std, dataset=dataset)

    return logits_fn


# eval mode → the protocol (mds_tpu/evaluation/evaluator.py:323-336): ss/ssc/
# msf/mscf the README columns; contrast the GNN-era label-downsample
# protocol; uni with n_cats + 1 hist bins; unlabel over the eval_cats; aux,
# label_link and uni on eval_logits; unseen/clip/emb on model methods of the
# flagship and the contrast family; dsg over the stage-2 train lists.
EVAL_MODES = (
    "ss", "ssc", "msf", "mscf", "contrast", "dsg", "label_link", "uni",
    "unseen", "clip", "emb", "aux", "unlabel",
)

# the modes that run a model method of their own, and which model has it
MODE_METHODS = {
    "unseen": ("unseen_pred_logits", "the flagship snp_rn18 has it (ROADMAP queue 1, item 6)"),
    "clip": ("clip_logits", "the flagship snp_rn18 has it (ROADMAP queue 1, item 6)"),
    "emb": ("emb_logits", "the contrast family bisenetv2_contrast has it (ROADMAP queue 1, "
                          "item 7)"),
}


def _make_evaluator(configer, mode: str):
    # the keys live in the `eval` block or, as in the reference's py
    # configs, at the top level
    eval_scales = tuple(
        configer.get(
            "eval", "eval_scales",
            default=configer.get(
                "eval_scales", default=[0.5, 0.75, 1.0, 1.25, 1.5, 1.75]
            ),
        )
    )
    eval_crop = configer.get(
        "eval", "eval_crop",
        default=configer.get(
            "eval_crop",
            default=configer.get("train", "cropsize", default=[1024, 1024]),
        ),
    )
    if mode in ("ss", "aux"):
        return MscEvalV0(scales=(1.0,), flip=False)
    if mode == "msf":
        return MscEvalV0(scales=eval_scales, flip=True)
    if mode == "ssc":
        return MscEvalCrop(
            cropsize=eval_crop, cropstride=2.0 / 3, flip=False, scales=(1.0,)
        )
    if mode == "mscf":
        return MscEvalCrop(
            cropsize=eval_crop, cropstride=2.0 / 3, flip=True, scales=eval_scales
        )
    if mode in ("contrast", "dsg"):
        return MscEvalV0Contrast(scales=(0.5,), flip=False)
    if mode == "unlabel":
        return MscEvalV0Contrast(scales=(0.5,), flip=False, truncate_classes=True)
    if mode in ("label_link", "uni", "unseen", "clip", "emb"):
        return MscEvalV0Contrast(scales=(1.0,), flip=False)
    raise ValueError(f"unknown eval mode {mode!r} (choose from {EVAL_MODES})")


def eval_model(configer, model, loaders, mode: str = "ss") -> List[float]:
    """Per-dataset mIoU of `model` (put in eval mode, on its own device)
    over the per-dataset `loaders`, under the mode's protocol. The modes
    unseen, clip and emb raise NotImplementedError when the model lacks
    their method (unseen and clip: every model but snp_rn18; emb: every
    model but the contrast family's, whose `prototypes` it reads)."""
    from mds_tpu_torch.engine.trainer import dataset_stats

    ev = _make_evaluator(configer, mode)
    method = None
    if mode in MODE_METHODS:
        method, item = MODE_METHODS[mode]
        if not hasattr(model, method):
            raise NotImplementedError(
                f"eval mode {mode!r} needs the model method {method}, which "
                f"{type(model).__name__} lacks: {item}")
    model.eval()
    device = next(model.parameters()).device
    means, stds = dataset_stats(configer)
    mious = []
    for i, loader in enumerate(loaders):
        logits_fn = make_logits_fn(model, means[i], stds[i], method=method)
        n_cats = configer.n_cats(i) + (1 if mode == "uni" else 0)
        if mode == "unlabel":
            # over the dataset's eval_cats: the label space without the
            # extra unlabeled channels
            n_cats = int(configer.dataset_cfg(i).get("eval_cats", configer.n_cats(i)))
        mious.append(ev(logits_fn, loader, n_cats, i, device=device))
    return mious
