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
  and, as extras, the bank (feats, ptr, count), the teacher's state and,
  with P > 1, the prototypes.

With `contrast.num_prototype` P > 1 (mds_tpu/engine/contrast_trainer.py:
67-85, 179-240) the contrast term is the multi-prototype one:
- (U, P, D) prototype slots, unit-norm at init, moved by momentum
  `contrast.coefficient` through `ops/prototype_learning.py` over the
  whole multi-dataset batch (its Gumbel noise drawn from the step's
  generator after the dropout seeds, or passed as `proto_noise`);
- each dataset's `ClassRemapOneHotLabel.ContrastRemapping` of its labels
  against the slot logits, whose multi-hot positives (with the pixel's
  assigned slot) feed `multi_label_cross_entropy` at logits / temperature;
- `seg_mul_loss`, the `weighted_nll_plus_loss` of each dataset's logits
  under its remap's seg mask, which takes over from the OHEM seg loss once
  the warmup gate opens.
JAX draws the initial slots from PRNGKey(42), which no torch generator
reproduces: these come from a generator seeded 42 by the same recipe
(truncated normal × 0.02, rows normalized), and `deploy/weights.py
contrast_state_from_jax` carries JAX's across.

Under a process group (parallel/mesh.py; tools/train_torch.py joins the
one torchrun or the JAX tool's MDS_* variables set up) each rank trains on
`local_device()` with its rank's share of the loader, `ims_per_gpu` images
a dataset, and each step is the one-process step on the global batch (each
dataset's rows rank-major, as JAX's ContrastTrainer shards them on its data
mesh, mds_tpu/engine/contrast_trainer.py:96-105,301-316):
- the step runs inside `mesh.data_parallel(sync_bn=True)`: the train norms
  and the OHEM pools reduce over every rank; each rank's dropout masks are
  its rows of the global masks (kernel 12 at offset rank·numel of each
  dataset's tensor); the anchor noise and the prototype Gumbel noise are
  this rank's columns and rows of the global draws; anchors, the bank's
  pushes, the remap's slot thresholds, the Sinkhorn and the prototypes'
  momentum update take every rank's pixels (losses/contrast.py,
  data/class_remap.py, ops/prototype_learning.py, losses/helpers.py); the
  gradients and the metrics are summed over the ranks. SyncBN always, as
  JAX's trainer has no local-BN path: `use_sync_bn: false` is ignored here,
  as JAX ignores it;
- the EMA teacher stays replicated (the same update from the same student
  on every rank); its forward is eval-mode and local;
- the model is broadcast from rank 0 after init and after a finetune; rank
  0 alone saves (a barrier after), and a restore broadcasts rank 0's
  checkpoint: the train state, the bank, the teacher and the prototypes;
- `train` logs on rank 0.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.class_remap import ClassRemap, ClassRemapOneHotLabel
from mds_tpu_torch.engine.checkpoints import (
    CheckpointManager,
    load_train_state,
    read_latest,
    train_state,
)
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
from mds_tpu_torch.losses.helpers import multi_label_cross_entropy, weighted_nll_plus_loss
from mds_tpu_torch.losses.ohem_ce import OhemCELoss
from mds_tpu_torch.models.bisenetv2_contrast import BiSeNetV2Contrast
from mds_tpu_torch.models.layers import wide
from mds_tpu_torch.ops.prototype_learning import gumbel_noise, prototype_learning
from mds_tpu_torch.parallel import mesh


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


def init_prototypes(U: int, P: int, D: int, device="cpu") -> torch.Tensor:
    """(U, P, D) slots: a normal truncated at ±2 times 0.02, each row
    normalized, from seed 42 (JAX's recipe; its PRNGKey(42) draw is not
    reproduced)."""
    g = torch.Generator().manual_seed(42)
    protos = torch.nn.init.trunc_normal_(torch.empty(U, P, D), 0.0, 1.0, -2.0, 2.0,
                                         generator=g) * 0.02
    return (protos / torch.linalg.norm(protos, dim=-1, keepdim=True).clamp_min(1e-12)
            ).to(device)


class ContrastTrainer:
    """train.mode 'contrast', with one prototype a class or P > 1
    (`contrast.num_prototype`)."""

    def __init__(self, configer: Configer, work_dir: str = "./res",
                 compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ContrastTrainer: no CUDA device; pass device='cpu' to "
                               "train on the CPU")
        self.device = mesh.local_device(device)
        self.rank = mesh.rank()

        def g(*k, d=None):
            return configer.get(*k, default=d)

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
        mesh.replicate(self.model)
        self.teacher = self._copy_teacher() if self.use_ema else None
        remap = ClassRemap(configer)
        self.luts = [remap.single_lut(i, self.device) for i in range(self.n)]
        U, D = self.model.num_unify_classes, self.model.proj_dim
        self.bank = MemoryBank.create(U, int(g("contrast", "memory_bank_size", d=64)), D,
                                      self.device)
        self.P = int(g("contrast", "num_prototype", d=1))
        self.coefficient = float(g("contrast", "coefficient", d=0.999))
        self.temperature = float(g("contrast", "temperature", d=0.07))
        self.prototypes = None
        if self.P > 1:
            self.remap_onehot = ClassRemapOneHotLabel(configer)
            self.prototypes = init_prototypes(U, self.P, D, device=self.device)
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
             noise: Optional[Sequence[torch.Tensor]] = None,
             proto_noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One train step on batch {"ims", "lbs"} (uint8 NHWC images and
        labels per dataset, numpy or tensors). `it` gates the contrast term
        and anneals the remap's keep share (default: the step count);
        `noise`: each dataset's (U, B·h·w) anchor noise in place of the
        generator's; `proto_noise`: with P > 1, the (Σ B·h·w, P) Gumbel
        noise of the slot assignment. Returns the metrics as tensors:
        loss, seg_loss, contrast_loss, and with P > 1 seg_mul_loss."""
        it = self.step_count if it is None else it
        gen = step_generator(self.seed, self.step_count) if generator is None else generator
        cw = self.loss_weight if it >= self.warmup_iters else 0.0
        ims, lbs = self._to_device(batch["ims"]), self._to_device(batch["lbs"])
        clock = _Clock(self.device.type == "cuda")
        clock.mark()
        with mesh.data_parallel(sync_bn=True):
            metrics = self._step(ims, lbs, it, gen, cw, clock, noise, proto_noise)
        self.step_count += 1
        self.timings.append({"step": self.step_count, "_clock": clock})
        return metrics

    def _step(self, ims, lbs, it, gen, cw, clock, noise, proto_noise):
        model = self.model.train()
        xs = normalize_images(ims, self.means, self.stds, self.compute_dtype)
        out = model(xs, generator=gen)
        bank = self.bank  # the loss reads it frozen
        seg_total = c_total = 0.0
        lb_smalls, preds = [], []
        for i in range(self.n):
            seg, embed = out["seg"][i], out["embed"][i]
            lb_uni = self.luts[i][lbs[i].long()]
            seg_total = seg_total + self.criteria(seg, lb_uni)
            for aux in out.get("aux", []):
                seg_total = seg_total + self.criteria(aux[i], lb_uni)
            f = seg.shape[2] // embed.shape[2]
            lb_small = lb_uni[:, ::f, ::f]
            pred_small = seg.detach()[:, :, ::f, ::f].argmax(dim=1)
            if self.P == 1:
                nz = noise[i] if noise is not None else anchor_noise(
                    self.model.num_unify_classes, lb_small.numel(), gen, self.device)
                c_total = c_total + self.contrast(embed.float(), lb_small, pred_small,
                                                  bank, nz)
            lb_smalls.append(lb_small)
            preds.append(pred_small)
        metrics = {}
        if self.P > 1:
            c_total, seg_mul = self._multi_prototype(out, lbs, lb_smalls, preds, it, gen,
                                                     proto_noise)
            metrics["seg_mul_loss"] = seg_mul.detach()
            if cw != 0.0:  # the warmup keeps the OHEM seg loss
                seg_total = seg_mul
        loss = seg_total + cw * c_total
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        metrics = {"loss": loss.detach(), "seg_loss": torch.as_tensor(seg_total).detach(),
                   "contrast_loss": torch.as_tensor(c_total, device=loss.device).detach(),
                   **metrics}
        metrics = mesh.sum_step(model.parameters(), metrics)
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
        return metrics

    def _multi_prototype(self, out, lbs, lb_smalls, preds, it, gen, proto_noise):
        """The P > 1 terms (mds_tpu/engine/contrast_trainer.py:179-240): the
        slot assignment and momentum update over the whole batch (the new
        slots kept in `self.prototypes`), then per dataset the remap's
        multi-hot contrast CE and its seg mask's weighted NLL. → (contrast
        loss, seg_mul_loss)."""
        U, P = self.model.num_unify_classes, self.P
        embeds = out["embed"]
        D = embeds[0].shape[1]
        emb_all = torch.cat([wide(e).permute(0, 2, 3, 1).reshape(-1, D) for e in embeds])
        gt_all = torch.cat([lb.reshape(-1) for lb in lb_smalls])
        correct = torch.cat([(p == lb).reshape(-1) for p, lb in zip(preds, lb_smalls)])
        if proto_noise is None:
            # this rank's rows of the global draw: dataset i's at Σ_{j<i} N_j
            # + rank·n_i (mesh.global_rows), the whole draw without a group
            rows, total = mesh.global_rows([e.shape[0] * e.shape[2] * e.shape[3]
                                            for e in embeds])
            proto_noise = gumbel_noise((total, P), gen)[rows].to(self.device)
        res = prototype_learning(self.prototypes, emb_all, gt_all, correct,
                                 coefficient=self.coefficient, noise=proto_noise)
        self.prototypes = res.prototypes
        slots = torch.arange(U * P, device=gt_all.device)
        target_1h = (res.proto_target[:, None] == slots[None, :]) & (gt_all < U)[:, None]
        c_total = seg_mul = 0.0
        off = 0
        for i, e in enumerate(embeds):
            b, _, h, w = e.shape
            n_i = b * h * w
            sim = res.proto_logits[off:off + n_i]
            cm, seg_mask = self.remap_onehot.ContrastRemapping(
                lbs[i], sim.detach().reshape(b, h, w, U * P), i, cur_iter=it)
            pos = cm.reshape(-1, U * P) | target_1h[off:off + n_i]
            off += n_i
            c_total = c_total + multi_label_cross_entropy(sim / self.temperature, pos)
            seg_mul = seg_mul + weighted_nll_plus_loss(out["seg"][i],
                                                       seg_mask.permute(0, 3, 1, 2))
        return c_total, seg_mul

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
            extras = load_contrast_reference(self.model, sd)
            protos = extras.get("prototypes")
            if self.prototypes is not None and protos is not None and (
                    tuple(protos.shape) == tuple(self.prototypes.shape)):
                self.prototypes = torch.as_tensor(protos, dtype=torch.float32,
                                                  device=self.device)
        else:
            got = read_latest(path)
            if got is None:
                raise FileNotFoundError(f"no checkpoint in {os.path.abspath(path)}")
            load_train_state(self.model, None, got[0])
        mesh.replicate(self.model)
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
        if self.prototypes is not None:
            out["prototypes"] = self.prototypes.detach().cpu().clone()
        return out

    def load(self, state: Dict, extras: Dict) -> None:
        """Take a checkpoint's train state and extras (bank, teacher,
        prototypes)."""
        self.step_count = load_train_state(self.model, self.optimizer, state)
        self.bank = MemoryBank(extras["bank_feats"], extras["bank_ptr"],
                               extras["bank_count"]).to(self.device)
        if self.teacher is not None:
            self.teacher.load_state_dict(extras["teacher"], strict=True)
        if self.prototypes is not None:
            self.prototypes = extras["prototypes"].to(self.device, self.prototypes.dtype)

    def maybe_save(self, force: bool = False) -> bool:
        """A checkpoint at every train.ckpt_interval steps, or `force`.
        Under a group rank 0 writes and every rank waits at a barrier after
        it; True where a checkpoint was written (on rank 0)."""
        if not self.ckpt.due(self.step_count, force):
            return False
        saved = False
        if self.rank == 0 and self.ckpt.should_save(self.step_count, force):
            saved = self.ckpt.maybe_save(self.state(), extras=self.extras(), force=force)
        mesh.barrier()
        return saved

    def restore_if_available(self, directory: Optional[str] = None) -> bool:
        """Load rank 0's latest checkpoint of `directory` (default: this
        trainer's) on every rank, if rank 0 has one; whether it did."""
        got = read_latest(self.ckpt.directory if directory is None else directory)
        if got is None:
            return False
        self.load(*got)
        return True

    def restore(self, directory: Optional[str] = None) -> None:
        """The latest checkpoint of `directory` (default: this trainer's);
        under a group rank 0's, broadcast. FileNotFoundError on every rank
        where rank 0 has none."""
        if not self.restore_if_available(directory):
            raise FileNotFoundError(
                f"no checkpoint in {self.ckpt.directory if directory is None else directory}")

    def train(self, loader=None, log_interval: Optional[int] = None) -> "ContrastTrainer":
        """Step to lr.max_iter (tools/train.py:39-76): the log line with the
        contrast loss every train.log_interval steps (default 100), a
        checkpoint every train.ckpt_interval and one at the end."""
        from mds_tpu_torch.data.loader import get_data_loader
        from mds_tpu_torch.utils.logger import setup_logger
        from mds_tpu_torch.utils.meters import AvgMeter, TimeMeter
        from mds_tpu_torch.utils.metrics_writer import MetricsWriter

        rank0 = self.rank == 0
        # rank 0 logs and writes the metrics; the others warn only
        logger = setup_logger("mds_tpu_torch_contrast", self.work_dir if rank0 else None,
                              level=logging.INFO if rank0 else logging.WARNING)
        if log_interval is None:
            log_interval = int(self.configer.get("train", "log_interval", default=100))
        if loader is None:
            loader = get_data_loader(self.configer, "train", rank=self.rank,
                                     world=mesh.world())
        self.pipeline = getattr(loader, "pipeline", None)
        writer = MetricsWriter(os.path.join(self.work_dir, "runs")) if rank0 else None
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
                    if writer is not None:
                        writer.write(it + 1, {"loss": float(metrics["loss"]),
                                              "seg": float(metrics["seg_loss"]),
                                              "contrast": contrast, "lr": lr}, group="loss")
                    self.read_timings()
                self.maybe_save()
        finally:
            if writer is not None:
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
    trainer.restore_if_available()
    return trainer.train()
