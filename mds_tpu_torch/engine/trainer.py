"""The config-driven supervised seg trainer — counterpart of
mds_tpu/engine/trainer.py (`build_model` :41, `dataset_stats` :54,
`Trainer` :69, `train_from_config` :338).

One run: config → data loader (host threads) → the device feed → the
BiSeNetV2 or BiSeNetV1 train step (plain, or `train.fused_up_loss`) → the
log line and metrics.jsonl → checkpoints every `train.ckpt_interval` steps
and at the end → restore and resume from the latest checkpoint.
`train_from_config` also dispatches to the alternating trainer
(engine/gnn_trainer.py) and the contrast trainer
(engine/contrast_trainer.py).

- The device is explicit and defaults to CUDA; without a card the trainer
  refuses to start unless the caller asks for the CPU.
- Each step's dropout generator is a CPU `torch.Generator` derived from
  (seed, step) (`step_generator`), as JAX folds the step into
  PRNGKey(seed): a resumed run draws the masks an unbroken one draws. On
  the card each BiSeNetV2 step launches the dropout kernel 10 times;
  BiSeNetV1 has no dropout.
- Under a process group (parallel/mesh.py; tools/train_torch.py joins the
  one a launcher sets up) each rank trains on `local_device()` with its
  rank's share of the loader (`ims_per_gpu` images a dataset, as the
  reference's per-GPU batch); the parameters and buffers are broadcast
  from rank 0 after init and after `finetune_from`; a restore reads rank
  0's latest checkpoint and broadcasts its whole train state; only rank 0
  logs, writes metrics.jsonl and saves, with a barrier after each save.
  `use_sync_bn` (default true, as JAX reads it,
  mds_tpu/engine/trainer.py:118) selects SyncBN, the step of one process
  on the global batch; false selects the reference's per-GPU BN, JAX's
  `local_bn` (engine/train_step.py). Without a group either value gives
  the one process's step.
- The device feed copies each dataset's uint8 NHWC arrays into page-locked
  memory and from there to the card with `non_blocking=True`. Each step
  pins fresh memory: PyTorch's pinned-memory allocator hands a block out
  again only after the copy that read it has completed.
- `timings` holds, per step, the host ms waited on the loader
  (`loader_ms`), the host ms of the pin and the copy's enqueue
  (`copy_ms`), the step's ms (`step_ms`: CUDA events on the card, the host
  clock on the CPU), the ms of a checkpoint save (`ckpt_ms`) and the host
  ms of the whole iteration (`loop_ms`: from `next(loader)` to after the
  log line and the save, which wait for the device at a log step).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.labels import get_spec
from mds_tpu_torch.data.loader import get_data_loader
from mds_tpu_torch.engine.checkpoints import (
    CheckpointManager,
    load_train_state,
    read_latest,
    train_state,
)
from mds_tpu_torch.engine.lr_schedule import warmup_poly_lr
from mds_tpu_torch.engine.optim import build_optimizer
from mds_tpu_torch.engine.train_step import make_seg_train_step
from mds_tpu_torch.parallel import mesh
from mds_tpu_torch.utils.logger import print_log_msg, setup_logger
from mds_tpu_torch.utils.meters import AvgMeter, TimeMeter
from mds_tpu_torch.utils.metrics_writer import MetricsWriter

TRAINABLE = ("bisenetv2", "bisenetv2_origin", "bisenetv1")
# the models built from n_classes; the rest from the config (`configer=`)
_BY_CLASSES = ("bisenetv2", "bisenetv2_origin", "bisenetv1")

# why no trainer of either package trains HRNet or BiSeNetV1-Swin
# (mds_tpu/engine/train_step.py:84, mds_tpu/engine/gnn_trainer.py:74)
_HRNET_WHY = ("HRNet trains in neither package: JAX's seg step reads out['logits'], "
              "which HRNetW48 does not return, and JAX's alternating trainer builds "
              "snp_rn18 whatever the model_name; tools/evaluate_torch.py and "
              "tools/serve_torch.py --weights take its weights")
_SWIN_WHY = ("bisenetv1_swin trains in neither package: JAX's build_model cannot build "
             "it from a config (BiSeNetV1Swin takes no configer); deploy/weights.py "
             "load_reference_weights grafts a Swin state_dict into BiSeNetV1Swin.swin")
# finetune_from: the layouts of models this trainer does not train
_LAYOUT_ITEMS = {
    "semseg": "the alternating trainer takes it (tools/train_torch.py --gnn)",
    "bisenetv2_contrast": "the contrast trainer takes it (train.mode contrast)",
    "hrnet_ref": _HRNET_WHY,
    "hrnet_imagenet": _HRNET_WHY,
    "swin": _SWIN_WHY,
}
# the layouts each trainable model loads: its own, and BiSeNetV1's
# torchvision ResNet18 trunk under cp.resnet (mds_tpu/engine/trainer.py:214-232)
_MODEL_LAYOUTS = {"bisenetv2": ("bisenetv2",), "bisenetv2_origin": ("bisenetv2",),
                  "bisenetv1": ("bisenetv1", "resnet18")}


def build_model(configer: Configer, dtype: torch.dtype = torch.bfloat16,
                aux: Optional[bool] = None) -> nn.Module:
    """The config's model (mds_tpu/engine/trainer.py:41-51): BiSeNetV2 and
    V1 from the class counts (`aux`, when given, for their aux heads),
    every other model from the config through its `configer=` factory
    (snp_rn18)."""
    import mds_tpu_torch.models  # noqa: F401 — fills MODELS
    from mds_tpu_torch.registry import MODELS

    name = configer.get("model_name", default="bisenetv2")
    n = configer.n_datasets
    kwargs = dict(configer.get("model_kwargs", default={}) or {})
    if name not in _BY_CLASSES:
        return MODELS[name](configer=configer, dtype=dtype, **kwargs)
    if aux is not None:
        kwargs["aux"] = aux
    return MODELS[name](n_classes=tuple(configer.n_cats(i) for i in range(n)),
                        n_bn=n, dtype=dtype, **kwargs)


def dataset_stats(configer: Configer):
    """Per-dataset (mean, std) for the normalization on the device."""
    means, stds = [], []
    for i in range(configer.n_datasets):
        spec_name = configer.dataset_cfg(i).get("spec")
        if spec_name:
            spec = get_spec(spec_name)
            means.append(spec.mean)
            stds.append(spec.std)
        else:
            means.append(np.zeros(3, np.float32))
            stds.append(np.ones(3, np.float32))
    return means, stds


def step_generator(seed: int, step: int) -> torch.Generator:
    """The dropout generator of step `step` of a run seeded `seed`."""
    word = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(word))


class Trainer:
    def __init__(self, configer: Configer, work_dir: str = "./res",
                 compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to "
                               "train on the CPU")
        self.device = mesh.local_device(device)
        self.rank = mesh.rank()
        self.configer = configer
        self.work_dir = work_dir
        self.logger = setup_logger("mds_tpu_torch", work_dir if self.rank == 0 else None)
        name = configer.get("model_name", default="bisenetv2")
        if name not in TRAINABLE:
            raise NotImplementedError(
                f"the supervised trainer trains {TRAINABLE}, not {name!r}: "
                "snp_rn18 trains through the alternating trainer (--gnn, "
                "train.mode alternate/seg/gnn), the contrast family through "
                "train.mode contrast; " + (_SWIN_WHY if name == "bisenetv1_swin"
                                           else _HRNET_WHY if name.startswith("hrnet")
                                           else "the port has no such model"))
        self.seed = int(configer.get("seed", default=0) or 0)
        self.max_iter = int(configer.get("lr", "max_iter", default=1000))
        self.schedule = warmup_poly_lr(
            float(configer.get("lr", "lr_start", default=5e-3)),
            float(configer.get("lr", "lr_power", default=0.9)),
            self.max_iter,
            warmup_iter=int(configer.get("lr", "warmup_iters", default=500)),
            warmup_ratio=float(configer.get("lr", "warmup_ratio", default=0.1)),
            warmup=configer.get("lr", "warmup", default="exp"))
        self.model = build_model(configer, compute_dtype)
        self.model.init_weights(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        mesh.replicate(self.model)
        self.optimizer = build_optimizer(configer, self.model, self.schedule)
        means, stds = dataset_stats(configer)
        self.fused_up_loss = bool(configer.get("train", "fused_up_loss", default=False))
        self.sync_bn = bool(configer.get("use_sync_bn", default=True))
        self.step_fn = make_seg_train_step(
            self.model, self.optimizer, means, stds,
            ohem_thresh=float(configer.get("loss", "ohem_thresh", default=0.7)),
            compute_dtype=compute_dtype, fused_up_loss=self.fused_up_loss,
            local_bn=not self.sync_bn)
        self.ckpt = CheckpointManager(
            f"{work_dir}/ckpt",
            save_interval=int(configer.get("train", "ckpt_interval", default=1000)))
        self.step = 0
        self.timings: List[Dict] = []
        self.pipeline: Optional[str] = None  # the train loader's augment pipeline

    def state(self) -> Dict:
        """The train state a checkpoint holds (engine/checkpoints.py)."""
        return train_state(self.model, self.optimizer, self.step)

    def restore_if_available(self) -> None:
        """Resume from the latest checkpoint under work_dir. Under a group,
        rank 0's checkpoint decides: its train state (parameters, buffers,
        optimizer state, step) is broadcast, so every rank resumes at the
        same step from the same state, whatever its own work_dir holds."""
        got = read_latest(self.ckpt.directory)
        if got is None:
            return
        self.step = load_train_state(self.model, self.optimizer, got[0])
        self.logger.info(f"restored checkpoint at step {self.step}")

    def finetune_from(self, path: str) -> None:
        """Load weights only: a `.pth`/`.pt` state_dict in the reference's
        torch layout (BiSeNetV2's, or BiSeNetV1's; for V1 also a
        torchvision ResNet18 into its ContextPath's trunk), or a checkpoint
        directory of the port's own (its latest step). A state_dict of a
        model another trainer takes, or the port lacks, raises
        NotImplementedError naming it; one that does not fit this model,
        ValueError."""
        from mds_tpu_torch.deploy.weights import detect_torch_layout, load_reference_weights

        if path.endswith((".pth", ".pt")):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "model_state_dict" in sd:
                sd = sd["model_state_dict"]
            layout = detect_torch_layout(sd)
            if layout in _LAYOUT_ITEMS:
                raise NotImplementedError(
                    f"finetune_from a {layout!r} state_dict: {_LAYOUT_ITEMS[layout]}")
            name = self.configer.get("model_name", default="bisenetv2")
            if layout not in _MODEL_LAYOUTS[name]:
                raise ValueError(f"a {layout!r} state_dict does not fit {name!r}")
            if layout == "resnet18":
                trunk = {f"cp.resnet.{k}": v for k, v in sd.items()
                         if not k.startswith("fc.")}
                unexpected = self.model.load_state_dict(trunk, strict=False).unexpected_keys
                if unexpected:
                    raise ValueError(f"not a ResNet18 trunk: {unexpected[:5]}")
            else:
                load_reference_weights(self.model, sd)
        else:
            state, _ = CheckpointManager(path).restore()
            load_train_state(self.model, None, state)
        mesh.replicate(self.model)
        self.logger.info(f"finetuning from {path}")

    def _to_device(self, arrays) -> List[torch.Tensor]:
        out = []
        for a in arrays:
            t = torch.from_numpy(a)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return out

    def _save(self, force: bool = False) -> None:
        """Rank 0 saves when the step is due (every rank decides alike, from
        the step alone); the others wait at the barrier after it."""
        if not self.ckpt.due(self.step, force):
            return
        if self.rank == 0 and self.ckpt.should_save(self.step, force):
            t0 = time.perf_counter()
            self.ckpt.maybe_save(self.state(), force=force)
            if self.timings:
                self.timings[-1]["ckpt_ms"] = (time.perf_counter() - t0) * 1e3
        mesh.barrier()

    def train(self, loader=None, log_interval: Optional[int] = None) -> "Trainer":
        configer = self.configer
        if log_interval is None:
            log_interval = int(configer.get("train", "log_interval", default=100))
        if loader is None:
            loader = get_data_loader(configer, "train", rank=self.rank, world=mesh.world())
        self.pipeline = getattr(loader, "pipeline", None)
        metrics_writer = MetricsWriter(f"{self.work_dir}/runs") if self.rank == 0 else None
        time_meter = TimeMeter(self.max_iter)
        loss_meters = {"loss": AvgMeter()}
        cuda = self.device.type == "cuda"
        events = []  # (record, start, end) of this call's steps on the card
        try:
            for it in range(self.step, self.max_iter):
                t0 = time.perf_counter()
                batch = next(loader)
                t1 = time.perf_counter()
                ims, lbs = self._to_device(batch["ims"]), self._to_device(batch["lbs"])
                t2 = time.perf_counter()
                rec = {"step": it + 1, "loader_ms": (t1 - t0) * 1e3,
                       "copy_ms": (t2 - t1) * 1e3}
                if cuda:
                    events.append((rec, torch.cuda.Event(enable_timing=True),
                                   torch.cuda.Event(enable_timing=True)))
                    events[-1][1].record()
                metrics = self.step_fn(ims, lbs, step_generator(self.seed, it))
                if cuda:
                    events[-1][2].record()
                else:
                    rec["step_ms"] = (time.perf_counter() - t2) * 1e3
                self.step = it + 1
                self.timings.append(rec)
                time_meter.update()
                loss_meters["loss"].update(metrics["loss"])
                if self.step % log_interval == 0 and self.rank == 0:
                    lr = float(self.schedule(it))
                    print_log_msg(self.logger, it, self.max_iter, lr, time_meter,
                                  loss_meters)
                    metrics_writer.write(self.step, {"seg": float(metrics["loss"]),
                                                     "lr": lr}, group="loss")
                self._save()
                rec["loop_ms"] = (time.perf_counter() - t0) * 1e3
        finally:
            if metrics_writer is not None:
                metrics_writer.close()
            if hasattr(loader, "close"):
                loader.close()
        self._save(force=True)
        self.ckpt.wait()
        if cuda:
            torch.cuda.synchronize(self.device)
            for rec, start, end in events:
                rec["step_ms"] = start.elapsed_time(end)
        return self


def train_from_config(config_path: str, overrides: Optional[List[str]] = None,
                      work_dir: str = "./res", max_iter: Optional[int] = None,
                      device="cuda", finetune_from: Optional[str] = None,
                      gnn: bool = False, compute_dtype: Optional[torch.dtype] = None):
    """Train as the config and its dotted overrides ask: load the
    `finetune_from` weights, then resume from the latest checkpoint under
    `work_dir` if there is one. `gnn` or `train.mode` alternate, seg, gnn or
    clip run the alternating SEG/GNN trainer (engine/gnn_trainer.py, f32
    unless `compute_dtype`; clip trains SEG against the frozen node-feature
    prototypes) and return it, as tools/train.py:81 routes them; train.mode
    contrast the contrast trainer (engine/contrast_trainer.py, bf16 unless
    `compute_dtype`); otherwise the supervised Trainer (bf16 unless
    `compute_dtype`)."""
    configer = Configer(config_file=config_path, args_parser=overrides or [])
    if max_iter is not None:
        configer.update(["lr", "max_iter"], max_iter)
    mode = configer.get("train", "mode", default=None)
    from mds_tpu_torch.engine.gnn_trainer import MODES, train_alternating

    if gnn or mode in MODES:
        return train_alternating(configer, work_dir=work_dir, device=device,
                                 finetune_from=finetune_from,
                                 compute_dtype=compute_dtype or torch.float32)
    if mode == "contrast":
        from mds_tpu_torch.engine.contrast_trainer import train_contrast

        return train_contrast(configer, work_dir=work_dir, device=device,
                              finetune_from=finetune_from,
                              compute_dtype=compute_dtype or torch.bfloat16)
    t = Trainer(configer, work_dir=work_dir, device=device,
                compute_dtype=compute_dtype or torch.bfloat16)
    if finetune_from:
        t.finetune_from(finetune_from)
    t.restore_if_available()
    return t.train()
