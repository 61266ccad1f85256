"""The pixel-contrast trainer (train.mode contrast) — counterpart of
mds_tpu/engine/contrast_trainer.py (`ContrastTrainer` :45-413) and of the
contrast branch of tools/train.py (:39-76, `train_contrast` here).

One step, as JAX's:
- normalize the batch and run BiSeNetV2Contrast in train mode;
- remap each dataset's labels into the unified space (`ClassRemap`'s
  single-mapping LUTs), OHEM CE of the unified logits and of each aux
  head's at weight 1 (`seg_loss`);
- at the embeddings' stride f = H/h, the labels and the detached argmax of
  the logits `[:, ::f, ::f]` and the pixel-contrast loss against the frozen
  memory bank (`contrast_loss`), weighted by `contrast.loss_weight` from
  `lr.warmup_iters` on and by 0 before;
- the SGD step with the 4 param groups;
- with `use_ema`, the teacher's EMA update after the optimizer step and its
  eval forward over the same batch gives the bank's keys; without, the
  student's detached embeddings do;
- each dataset's keys pushed into the bank in turn.

- The device defaults to CUDA; without a card the trainer refuses to start
  unless the caller asks for the CPU. The compute dtype is bf16 unless
  given, as JAX's.
- Each step's generator is `step_generator(seed, step)`, as JAX folds the
  step into PRNGKey(0): it seeds the 15 dropout masks (5 heads × 3
  datasets) and then draws each dataset's anchor noise (`losses/contrast.py
  anchor_noise`, on the CPU, copied to the device from page-locked
  memory). A caller may pass the noise itself (`step(..., noise=...)`).
- `timings` holds, per step, the step's ms, the teacher's (EMA update and
  forward) and the bank pushes' (CUDA events on the card, the host clock on
  the CPU), and the host ms waited on the loader.
- Checkpoints (`<work_dir>/ckpt_contrast/<step>.pt`) hold the train state
  and, as extras, the bank (feats, ptr, count) and the teacher's state.
- `contrast.num_prototype > 1` (the sinkhorn prototype path) raises
  NotImplementedError: ROADMAP queue 1, item 7b.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.class_remap import ClassRemap
from mds_tpu_torch.engine.checkpoints import CheckpointManager, load_train_state, train_state
from mds_tpu_torch.engine.ema import ema_update
from mds_tpu_torch.engine.lr_schedule import warmup_poly_lr
from mds_tpu_torch.engine.optim import build_optimizer
from mds_tpu_torch.engine.train_step import normalize_images
from mds_tpu_torch.engine.trainer import dataset_stats, step_generator
from mds_tpu_torch.losses.contrast import (
    MemoryBank,
    PixelContrastLoss,
    anchor_noise,
    memory_bank_push,
)
from mds_tpu_torch.losses.ohem_ce import OhemCELoss
from mds_tpu_torch.models.bisenetv2_contrast import BiSeNetV2Contrast

MULTI_PROTOTYPE_ITEM = ("contrast.num_prototype > 1 (sinkhorn prototype learning, "
                        "ClassRemapOneHotLabel) is not ported yet: ROADMAP queue 1, item 7b")


class _Clock:
    """Intervals of one step: CUDA events on the card, the host clock on the
    CPU; `read` gives the ms between consecutive marks."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def read(self) -> List[float]:
        m = self.marks
        if self.cuda:
            m[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


class ContrastTrainer:
    """train.mode 'contrast' with one prototype a class (the config sets no
    `contrast.num_prototype`)."""

    def __init__(self, configer: Configer, work_dir: str = "./res",
                 compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ContrastTrainer: no CUDA device; pass device='cpu' to "
                               "train on the CPU")

        def g(*k, d=None):
            return configer.get(*k, default=d)

        if int(g("contrast", "num_prototype", d=1)) > 1:
            raise NotImplementedError(MULTI_PROTOTYPE_ITEM)
        self.configer = configer
        self.work_dir = work_dir
        self.n = configer.n_datasets
        self.seed = int(g("seed", d=0) or 0)
        self.max_iter = int(g("lr", "max_iter", d=1000))
        self.warmup_iters = int(g("lr", "warmup_iters", d=10))
        self.loss_weight = float(g("contrast", "loss_weight", d=0.1))
        self.use_ema = bool(g("use_ema", d=False))
        self.ema_momentum = float(g("contrast", "ema_momentum", d=0.999))
        self.compute_dtype = compute_dtype

        self.model = BiSeNetV2Contrast.from_configer(configer, dtype=compute_dtype)
        self.model.init_weights(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        self.teacher = self._copy_teacher() if self.use_ema else None
        remap = ClassRemap(configer)
        self.luts = [remap.single_lut(i, self.device) for i in range(self.n)]
        U, D = self.model.num_unify_classes, self.model.proj_dim
        self.bank = MemoryBank.create(U, int(g("contrast", "memory_bank_size", d=64)), D,
                                      self.device)
        self.schedule = warmup_poly_lr(
            float(g("lr", "lr_start", d=5e-3)), float(g("lr", "lr_power", d=0.9)),
            self.max_iter, warmup_iter=self.warmup_iters,
            warmup_ratio=float(g("lr", "warmup_ratio", d=0.1)))
        self.optimizer = build_optimizer(configer, self.model, self.schedule)
        self.criteria = OhemCELoss(float(g("loss", "ohem_thresh", d=0.7)))
        self.contrast = PixelContrastLoss(configer)
        self.means, self.stds = dataset_stats(configer)
        self.ckpt = CheckpointManager(os.path.join(work_dir, "ckpt_contrast"),
                                      save_interval=int(g("train", "ckpt_interval", d=1000)))
        self.step_count = 0
        self.timings: List[Dict] = []

    def _copy_teacher(self) -> BiSeNetV2Contrast:
        """The teacher: a copy of the student in eval mode, no gradients."""
        teacher = copy.deepcopy(self.model).eval()
        for p in teacher.parameters():
            p.requires_grad_(False)
        return teacher

    # ------------------------------------------------------------------ step
    def _to_device(self, arrays) -> List[torch.Tensor]:
        out = []
        for a in arrays:
            t = a if torch.is_tensor(a) else torch.from_numpy(a)
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return out

    def step(self, batch, it: Optional[int] = None,
             generator: Optional[torch.Generator] = None,
             noise: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """One train step on batch {"ims", "lbs"} (uint8 NHWC images and
        labels per dataset, numpy or tensors). `it` gates the contrast term
        (default: the step count); `noise`: each dataset's (U, B·h·w) anchor
        noise in place of the generator's. Returns the metrics as tensors:
        loss, seg_loss, contrast_loss."""
        it = self.step_count if it is None else it
        gen = step_generator(self.seed, self.step_count) if generator is None else generator
        cw = self.loss_weight if it >= self.warmup_iters else 0.0
        ims, lbs = self._to_device(batch["ims"]), self._to_device(batch["lbs"])
        clock = _Clock(self.device.type == "cuda")
        clock.mark()
        model = self.model.train()
        xs = normalize_images(ims, self.means, self.stds, self.compute_dtype)
        out = model(xs, generator=gen)
        bank = self.bank  # the loss reads it frozen
        seg_total = c_total = 0.0
        lb_smalls = []
        for i in range(self.n):
            seg, embed = out["seg"][i], out["embed"][i]
            lb_uni = self.luts[i][lbs[i].long()]
            seg_total = seg_total + self.criteria(seg, lb_uni)
            for aux in out.get("aux", []):
                seg_total = seg_total + self.criteria(aux[i], lb_uni)
            f = seg.shape[2] // embed.shape[2]
            lb_small = lb_uni[:, ::f, ::f]
            pred_small = seg.detach()[:, :, ::f, ::f].argmax(dim=1)
            nz = noise[i] if noise is not None else anchor_noise(
                self.model.num_unify_classes, lb_small.numel(), gen, self.device)
            c_total = c_total + self.contrast(embed.float(), lb_small, pred_small, bank, nz)
            lb_smalls.append(lb_small)
        loss = seg_total + cw * c_total
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        clock.mark()
        with torch.no_grad():
            if self.teacher is not None:
                ema_update(self.teacher, model, self.ema_momentum)
                keys = self.teacher.embed(xs)
            else:
                keys = [e.detach() for e in out["embed"]]
            clock.mark()
            for key, lb_small in zip(keys, lb_smalls):
                flat = key.float().permute(0, 2, 3, 1).reshape(-1, key.shape[1])
                bank = memory_bank_push(bank, flat, lb_small.reshape(-1))
        clock.mark()
        self.bank = bank
        self.step_count += 1
        self.timings.append({"step": self.step_count, "_clock": clock})
        return {"loss": loss.detach(), "seg_loss": seg_total.detach(),
                "contrast_loss": torch.as_tensor(c_total).detach()}

    def read_timings(self) -> List[Dict]:
        """`timings` with each pending step's ms read back: `step_ms`
        (forward, backward, optimizer, teacher and push), `teacher_ms`,
        `push_ms`."""
        for rec in self.timings:
            clock = rec.pop("_clock", None)
            if clock is not None:
                fwd_bwd, teacher, push = clock.read()
                rec.update(step_ms=fwd_bwd + teacher + push, teacher_ms=teacher,
                           push_ms=push)
        return self.timings

    # ----------------------------------------------------------- weights
    def finetune_from(self, path: str) -> None:
        """Load weights only: a contrast-layout `.pth`/`.pt` state_dict of
        the reference (deploy/weights.py `load_contrast_reference`), or the
        latest checkpoint of a port's contrast checkpoint directory. The
        teacher restarts from the loaded weights; step, optimizer and bank
        stay."""
        from mds_tpu_torch.deploy.weights import detect_torch_layout, load_contrast_reference

        if path.endswith((".pth", ".pt")):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "model_state_dict" in sd:
                sd = sd["model_state_dict"]
            layout = detect_torch_layout(sd)
            if layout != "bisenetv2_contrast":
                raise ValueError("train.mode contrast finetunes from a contrast-layout "
                                 f"checkpoint, got {layout!r}")
            load_contrast_reference(self.model, sd)
        else:
            state, _ = CheckpointManager(path).restore()
            load_train_state(self.model, None, state)
        if self.teacher is not None:
            self.teacher = self._copy_teacher()

    # ------------------------------------------------------------ persistence
    def state(self) -> Dict:
        return train_state(self.model, self.optimizer, self.step_count)

    def extras(self) -> Dict:
        out = {"bank_feats": self.bank.feats.cpu(), "bank_ptr": self.bank.ptr.cpu(),
               "bank_count": self.bank.count.cpu()}
        if self.teacher is not None:
            out["teacher"] = {k: v.detach().cpu().clone()
                              for k, v in self.teacher.state_dict().items()}
        return out

    def load(self, state: Dict, extras: Dict) -> None:
        """Take a checkpoint's train state and extras (bank, teacher)."""
        self.step_count = load_train_state(self.model, self.optimizer, state)
        self.bank = MemoryBank(extras["bank_feats"], extras["bank_ptr"],
                               extras["bank_count"]).to(self.device)
        if self.teacher is not None:
            self.teacher.load_state_dict(extras["teacher"], strict=True)

    def maybe_save(self, force: bool = False) -> bool:
        """A checkpoint at every train.ckpt_interval steps, or `force`."""
        if not self.ckpt.should_save(self.step_count, force):
            return False
        return self.ckpt.maybe_save(self.state(), extras=self.extras(), force=force)

    def restore(self, directory: Optional[str] = None) -> None:
        """The latest checkpoint of `directory` (default: this trainer's)."""
        manager = self.ckpt if directory is None else CheckpointManager(directory)
        state, extras = manager.restore()
        self.load(state, extras)

    def train(self, loader=None, log_interval: Optional[int] = None) -> "ContrastTrainer":
        """Step to lr.max_iter (tools/train.py:39-76): the log line with the
        contrast loss every train.log_interval steps (default 100), a
        checkpoint every train.ckpt_interval and one at the end."""
        from mds_tpu_torch.data.loader import get_data_loader
        from mds_tpu_torch.utils.logger import setup_logger
        from mds_tpu_torch.utils.meters import AvgMeter, TimeMeter
        from mds_tpu_torch.utils.metrics_writer import MetricsWriter

        logger = setup_logger("mds_tpu_torch_contrast", self.work_dir)
        if log_interval is None:
            log_interval = int(self.configer.get("train", "log_interval", default=100))
        if loader is None:
            loader = get_data_loader(self.configer, "train")
        self.pipeline = getattr(loader, "pipeline", None)
        writer = MetricsWriter(os.path.join(self.work_dir, "runs"))
        tm, lm = TimeMeter(self.max_iter), AvgMeter()
        try:
            for it in range(self.step_count, self.max_iter):
                t0 = time.perf_counter()
                batch = next(loader)
                wait_ms = (time.perf_counter() - t0) * 1e3
                metrics = self.step(batch)
                self.timings[-1]["loader_ms"] = wait_ms
                tm.update()
                lm.update(metrics["loss"])
                if (it + 1) % log_interval == 0:
                    t, eta = tm.get()
                    contrast = float(metrics["contrast_loss"])
                    lr = float(self.schedule(it))
                    logger.info(f"iter {it + 1}/{self.max_iter} loss={lm.get()[0]:.4f} "
                                f"contrast={contrast:.4f} lr={lr:.6f} time={t:.2f} eta={eta}")
                    writer.write(it + 1, {"loss": float(metrics["loss"]),
                                          "seg": float(metrics["seg_loss"]),
                                          "contrast": contrast, "lr": lr}, group="loss")
                    self.read_timings()
                self.maybe_save()
        finally:
            writer.close()
            if hasattr(loader, "close"):
                loader.close()
        self.maybe_save(force=True)
        logger.info(f"saved contrast checkpoint at step {self.step_count}")
        self.read_timings()
        return self


def train_contrast(configer: Configer, work_dir: str = "./res", device="cuda",
                   finetune_from: Optional[str] = None,
                   compute_dtype: torch.dtype = torch.bfloat16) -> ContrastTrainer:
    """The contrast branch of the train CLI: load the `finetune_from`
    weights, resume from the latest checkpoint under
    `<work_dir>/ckpt_contrast`, train."""
    trainer = ContrastTrainer(configer, work_dir=work_dir, compute_dtype=compute_dtype,
                              device=device)
    if finetune_from:
        trainer.finetune_from(finetune_from)
    if trainer.ckpt.latest_step() is not None:
        trainer.restore()
    return trainer.train()
