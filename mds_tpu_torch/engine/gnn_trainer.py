"""The flagship's alternating SEG/GNN trainer — counterpart of
mds_tpu/engine/gnn_trainer.py (`AlternatingTrainer` :58) and of the
alternating branch of tools/train.py (:81-167, `train_alternating` here).

The stage machine:
- GNN stage (alter_iter < gnn_iters): the seg net runs in eval mode under
  no_grad and its features feed the loss; the graph net trains (AdamW,
  warmup-poly power 1.2 over gnn_iters) on the annealed max/softmax remap
  CE, `max_rate = alter_iter/gnn_iters`, its updates scaled by
  `gnn_lr_scale`. The max graphs are the block's column maxima, or with
  GNN.GumbelSoftmax Gumbel-softmax samples at τ = max(0.01,
  gumbel_tau0·e^(−2e-5·alter_iter)) (differentiable; the noise drawn on
  the CPU from the step's generator). With GNN.mse_or_adv "adv" the loss
  and the discriminators' loss go through one backward, and the
  discriminators (`netD.*`) take their own AdamW group: weight decay 0,
  the same power-1.2 schedule at lr.optimD_lr (mds_tpu/engine/
  gnn_trainer.py:438-457);
- GNN→SEG switch: the GNN's prototypes and the UOT graphs of its block
  (host numpy f32, ops/uot_match.py; KM graphs with GNN.use_km) go into
  the seg model, the seg optimizer starts afresh;
- SEG stage (alter_iter < seg_iters): the seg net trains against the fixed
  graphs (AdamW, warmup-poly power 0.9 over max_iter; every seg parameter
  moves, the prototypes too; the graphs are buffers), its BN stats move;
- SEG→GNN re-entry: gnn_lr_scale = max(0.1, 1 − gnn steps/max_iter) and
  fresh GNN moments.
`train.mode` seg or gnn pins the stage; `lr.init_iter` > 0 first distils
the GNN toward the identity graphs and the seg prototypes. `train.mode`
clip pins SEG with the prototypes set from the node features' text half
(`set_clip_prototypes`) and frozen as JAX freezes them: their gradient is
zero, and AdamW's decoupled weight decay still shrinks them by
(1 − lr·wd) a step. The graph net is built as JAX's trainer builds it,
`LearnableTopologyBGNN.from_configer` (a name outside its table is the
cosine BGNN); the unlabel fork raises ValueError, as JAX's step fails on
it.

- Compute dtype f32 by default, as JAX's; bf16 through `compute_dtype`
  (params stay f32); f64 (params too) for the tests' reference runs.
- The device defaults to CUDA; without a card the trainer refuses to start
  unless the caller asks for the CPU.
- Each GNN step's dropout masks come from `step_generator(seed, gnn
  steps)` unless the caller passes a generator.
- `timings` holds, per step, the stage, the loss, the step's ms (CUDA
  events on the card, the host clock on the CPU) and, at a GNN→SEG switch,
  its host ms (`switch_ms`, synchronized before and after). The steps since
  the last `read_timings` keep their loss and events on the device until it
  reads them back; `train_alternating` calls it at every log line.
- Checkpoints (`save`, `restore`) hold the seg train state and, as extras,
  the GNN's, the βs, the UOT graphs and the stage machine, under the global
  iteration.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mds_tpu_torch.engine.checkpoints import CheckpointManager, load_train_state, train_state
from mds_tpu_torch.engine.lr_schedule import warmup_poly_lr
from mds_tpu_torch.engine.optim import AdamW, load_optimizer_state
from mds_tpu_torch.engine.train_step import normalize_images
from mds_tpu_torch.engine.trainer import dataset_stats, step_generator
from mds_tpu_torch.losses.cross_datasets import CrossDatasetsCELossAdvGNN
from mds_tpu_torch.models.gnn import (
    LearnableTopologyBGNN,
    gumbel_max_graphs,
    gumbel_noise,
    gumbel_softmax_decay,
    max_mask_graphs,
)
from mds_tpu_torch.models.semseg import SemsegModel, proto_logits
from mds_tpu_torch.ops.uot_match import (
    pretrain_bipartite_graphs,
    sep_bipartite_graphs_by_km,
    sep_bipartite_graphs_by_uot,
)

SEG, GNN = "SEG", "GNN"
# the train.mode values this trainer runs (train_from_config and the eval
# drivers route them here)
MODES = ("alternate", "seg", "gnn", "clip")
# JAX's alternating trainer fails on this fork at its first GNN step
# (mds_tpu/engine/gnn_trainer.py:220-226,400-405)
UNLABEL = ("the unlabel BGNN fork (GNN.model_name learnable_topology_BGNN_unlabel) "
           "does not train in JAX's alternating trainer either: its graph block has "
           "n_cats + 1 rows a dataset, which the GNN step's max graphs and the UOT "
           "switch split by n_cats; the model itself is "
           "LearnableTopologyBGNN(with_unlabel=True)")


class AlternatingTrainer:
    def __init__(self, configer, compute_dtype: torch.dtype = torch.float32,
                 node_features: Optional[np.ndarray] = None, device="cuda"):
        from mds_tpu_torch.data.node_features import gen_graph_node_features

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AlternatingTrainer: no CUDA device; pass device='cpu' "
                               "to train on the CPU")
        g = lambda *k, d=None: configer.get(*k, default=d)
        self.mode = g("train", "mode", d="alternate") or "alternate"
        if self.mode not in MODES:
            raise ValueError(f"train.mode {self.mode!r} is not one of {MODES}")
        # the graph net as JAX's trainer builds it (gnn_trainer.py:75)
        self.gnn_model = LearnableTopologyBGNN.from_configer(configer)
        if self.gnn_model.with_unlabel:
            raise ValueError(UNLABEL)
        self.gumbel = bool(g("GNN", "GumbelSoftmax", d=False))
        self.gumbel_tau0 = float(g("GNN", "gumbel_tau0", d=10.0))
        self.use_km = bool(g("GNN", "use_km", d=False))
        self.configer = configer
        self.n = configer.n_datasets
        self.dataset_cats = tuple(configer.n_cats(i) for i in range(self.n))
        self.total_cats = sum(self.dataset_cats)
        self.compute_dtype = compute_dtype
        self.seed = int(g("seed", d=0) or 0)
        if node_features is None:
            node_features = gen_graph_node_features(configer, nfeat=self.gnn_model.nfeat)
        if len(node_features) != self.total_cats:
            raise ValueError(
                f"{len(node_features)} node-feature rows for {self.total_cats} dataset "
                "classes: a dataset's spec names fewer classes than its n_cats (CamVid's "
                "names 11 where configs/clip_5_datasets.json gives 12); give "
                "GNN.node_features_path a (Σ n_cats, nfeat) file")

        # f32 params, or f64 for an f64 reference run
        wide = torch.float64 if compute_dtype == torch.float64 else torch.float32
        # snp_rn18 whatever the config's model_name, as JAX's trainer
        self.seg_model = SemsegModel.from_configer(configer, dtype=compute_dtype)
        self.seg_model.init_weights(torch.Generator().manual_seed(self.seed)).to(
            self.device, wide)
        self.gnn_model.init_weights(torch.Generator().manual_seed(self.seed + 1)).to(
            self.device, wide)
        self.criterion = CrossDatasetsCELossAdvGNN(configer)
        self.M = self.seg_model.max_num_unify_class
        self.node_features = torch.tensor(np.asarray(node_features, np.float32),
                                          device=self.device, dtype=wide)

        self.seg_iters = int(g("train", "seg_iters", d=200))
        self.gnn_iters = int(g("train", "gnn_iters", d=60))
        self.max_iter = int(g("lr", "max_iter", d=1000))
        self.weight_decay = float(g("lr", "weight_decay", d=1e-5))
        warmup = int(g("lr", "warmup_iters", d=10))
        self.seg_schedule = warmup_poly_lr(float(g("lr", "seg_lr_start", d=1e-3)), 0.9,
                                           self.max_iter, warmup_iter=warmup)
        self._gnn_schedule = lambda lr: warmup_poly_lr(
            lr, 1.2, self.gnn_iters, warmup_iter=min(warmup, self.gnn_iters // 2))
        self.gnn_lr = float(g("lr", "gnn_lr_start", d=1e-3))
        self.optimD_lr = float(g("lr", "optimD_lr", d=self.gnn_lr))
        self.seg_opt = self._adamw(self.seg_model, self.seg_schedule)
        self.gnn_opt = self._gnn_adamw()
        self.gnn_lr_scale = 1.0
        self.means, self.stds = dataset_stats(configer)
        self.uot_ratio = float(g("GNN", "uot_ratio", d=1.0))

        self.seg_steps = self.gnn_steps = 0
        self.betas: List[np.ndarray] = [np.full(c, 1.0 / c) for c in self.dataset_cats]
        self.uot_bi: Optional[List[np.ndarray]] = None
        self.stage, self.alter_iter, self.total_iter = GNN, 0, 0
        self.init_iters = int(g("lr", "init_iter", d=0))
        self._pretrain_graphs = [torch.from_numpy(a).to(self.device, wide) for a in
                                 pretrain_bipartite_graphs(self.dataset_cats, self.M)]
        self.seg_model.set_bipartite_graphs(self._pretrain_graphs)
        if self.mode == "clip":
            self.set_clip_prototypes()
        self.timings: List[Dict] = []
        self._pending: List = []  # (record, loss, start, end) not yet read back

    def _adamw(self, model, schedule) -> AdamW:
        return AdamW(list(model.parameters()), schedule, weight_decay=self.weight_decay)

    def _gnn_adamw(self) -> AdamW:
        """The graph net's AdamW; in adv mode the discriminators' group
        takes weight decay 0 and the schedule at lr.optimD_lr (JAX's
        optax.multi_transform, gnn_trainer.py:438-457)."""
        schedule = self._gnn_schedule(self.gnn_lr)
        if self.gnn_model.mse_or_adv != "adv":
            return self._adamw(self.gnn_model, schedule)
        d_ratio = self.optimD_lr / max(self.gnn_lr, 1e-12)
        named = list(self.gnn_model.named_parameters())
        return AdamW([{"params": [p for n, p in named if not n.startswith("netD.")]},
                      {"params": [p for n, p in named if n.startswith("netD.")],
                       "weight_decay": 0.0,
                       "schedule": self._gnn_schedule(self.gnn_lr * d_ratio)}],
                     schedule, weight_decay=self.weight_decay)

    @torch.no_grad()
    def set_clip_prototypes(self) -> None:
        """Each unified slot j takes class j's text embedding, the first
        output_feat_dim entries of its node features (gnn_trainer.py:368-389);
        with aux prototypes every class's text rows come first."""
        D = self.seg_model.output_feat_dim
        text = self.node_features[:, :D].float()
        uni = text.new_zeros(self.M, D)
        n_copy = min(self.M, text.shape[0])
        uni[:n_copy] = text[:n_copy]
        self.seg_model.set_unify_prototype(
            torch.cat([text, uni]) if self.seg_model.with_datasets_aux else uni)

    # ------------------------------------------------------------------ steps
    def _features(self, ims) -> List:
        """The seg model's features of a uint8 batch (its current mode)."""
        return self.seg_model.features(
            normalize_images(ims, self.means, self.stds, self.compute_dtype))

    def gnn_step(self, ims, lbs, generator: Optional[torch.Generator] = None,
                 max_rate: float = 0.0, tau: Optional[float] = None) -> Dict:
        """One GNN-stage step (gnn_trainer.py:198-273): the frozen seg net's
        eval features, then `gnn_update`."""
        self.seg_model.eval()
        with torch.no_grad():
            feats = self._features(ims)
        return self.gnn_update(feats, lbs, generator, max_rate, tau)

    def gnn_update(self, feats, lbs, generator: Optional[torch.Generator] = None,
                   max_rate: float = 0.0, tau: Optional[float] = None,
                   noise: Optional[List[torch.Tensor]] = None) -> Dict:
        """The GNN forward with dropout on the seg features `feats`, the loss
        over the 2n graphs [max0, soft0, ...] (max graphs detached, or
        Gumbel-softmax samples at `tau` of `noise`, drawn from `generator`
        after the dropout masks when not given), plus in adv mode the
        discriminators' loss, one backward, AdamW with the update scaled by
        gnn_lr_scale. `tau` defaults to the schedule's at alter_iter."""
        self.gnn_model.train()
        out = self.gnn_model(self.node_features, generator)
        if self.gumbel:
            if tau is None:
                tau = gumbel_softmax_decay(self.alter_iter, 2e-5, self.gumbel_tau0, 0.01)
            if noise is None:
                noise = gumbel_noise(self.dataset_cats, self.M, generator)
            maxg = gumbel_max_graphs(out["adj_block"], self.dataset_cats, tau, noise)
        else:
            maxg = [m.detach() for m in max_mask_graphs(out["adj_block"], self.dataset_cats)]
        graphs = [g for pair in zip(maxg, out["bi_graphs"]) for g in pair]
        preds = {"seg": feats, "unify_prototype": out["unify_prototype"],
                 "bi_graphs": graphs, "adv_pairs": out["adv_pairs"],
                 "adj_block": out["adj_block"]}
        if "adv_out" in out:
            preds["adv_out"] = out["adv_out"]
        loss, metrics = self.criterion(preds, lbs, is_adv=True, max_rate=max_rate)
        if "adv_out" in out:  # one backward steps both groups (gnn_trainer.py:240-250)
            loss = loss + metrics["adv_loss"]
        self.gnn_opt.zero_grad(set_to_none=True)
        loss.backward()
        self.gnn_opt.update_scale = self.gnn_lr_scale
        self.gnn_opt.step()
        self.gnn_steps += 1
        return metrics

    def seg_step(self, ims, lbs) -> Dict:
        """One SEG-stage step (gnn_trainer.py:277-318): train-mode features
        (BN stats move), the aux logits, the loss with the model's own (M, D)
        prototype folded into its graphs, AdamW; in clip mode the
        prototypes' gradients are zeroed first (JAX's stop_gradient)."""
        model = self.seg_model
        model.train()
        feats = self._features(ims)
        aux = ([None if f is None else proto_logits(f, model.aux_prototype[i])
                for i, f in enumerate(feats)] if model.with_datasets_aux else None)
        preds = {"seg": feats, "aux": aux, "unify_prototype": model.unify_prototype,
                 "bi_graphs": [model.bipartite_graphs[i] for i in range(self.n)]}
        loss, metrics = self.criterion(preds, lbs, is_adv=False)
        self.seg_opt.zero_grad(set_to_none=True)
        loss.backward()
        if self.mode == "clip":
            for name, p in model.named_parameters():
                if "prototype" in name and p.grad is not None:
                    p.grad.zero_()
        self.seg_opt.step()
        self.seg_steps += 1
        return metrics

    def init_step(self, generator: Optional[torch.Generator] = None) -> Dict:
        """The init phase (gnn_trainer.py:320-358): graph MSE to the identity
        graphs and prototype MSE to the seg model's prototype."""
        self.gnn_model.train()
        out = self.gnn_model(self.node_features, generator)
        proto = out["unify_prototype"]
        if self.gnn_model.with_datasets_aux:
            proto = proto[self.total_cats:]
        preds = {"seg": [None] * self.n, "unify_prototype": proto,
                 "bi_graphs": out["bi_graphs"], "adj_block": out["adj_block"],
                 "pretrain_bipart_graph": self._pretrain_graphs,
                 "seg_prototype": self.seg_model.unify_prototype.detach()}
        loss, metrics = self.criterion(preds, [None] * self.n, is_adv=False,
                                       init_gnn_stage=True)
        self.gnn_opt.zero_grad(set_to_none=True)
        loss.backward()
        self.gnn_opt.update_scale = 1.0
        self.gnn_opt.step()
        self.gnn_steps += 1
        return metrics

    # ------------------------------------------------------------ transitions
    def optimal_matching(self):
        """→ (the GNN's prototypes, the UOT graphs of its block, or its KM
        graphs with GNN.use_km); UOT moves the βs (gnn_trainer.py:392-409)."""
        with torch.no_grad():
            proto, block = self.gnn_model.infer_prototypes(self.node_features)
        block = block.float().cpu().numpy()
        if self.use_km:
            graphs = sep_bipartite_graphs_by_km(block, self.dataset_cats)
        else:
            graphs, self.betas = sep_bipartite_graphs_by_uot(
                block, self.dataset_cats, self.betas, uot_ratio=self.uot_ratio)
        self.uot_bi = graphs
        return proto.detach(), graphs

    def switch_to_seg(self) -> None:
        proto, graphs = self.optimal_matching()
        self.seg_model.set_unify_prototype(proto)
        self.seg_model.set_bipartite_graphs(graphs)
        self.seg_opt = self._adamw(self.seg_model, self.seg_schedule)
        self.stage, self.alter_iter = SEG, 0

    def switch_to_gnn(self) -> None:
        self.gnn_lr_scale = max(0.1, 1.0 - self.gnn_steps / max(self.max_iter, 1))
        self.gnn_opt = self._gnn_adamw()
        self.stage, self.alter_iter = GNN, 0

    def finetune_from(self, path: str) -> None:
        """Seg weights from a reference snp_rn18 `.pth`/`.pt` (its graphs
        too), or this trainer's checkpoint directory (then the seg
        schedule and the stage machine start again)."""
        if path.endswith((".pth", ".pt")):
            from mds_tpu_torch.deploy.weights import detect_torch_layout, load_reference_weights

            sd = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "model_state_dict" in sd:
                sd = sd["model_state_dict"]
            if detect_torch_layout(sd) != "semseg":
                raise ValueError(f"{path}: not a snp_rn18 (semseg) state_dict")
            load_reference_weights(self.seg_model, sd)
        else:
            self.restore(path)
            self.seg_opt = self._adamw(self.seg_model, self.seg_schedule)
            self.seg_steps = self.total_iter = self.alter_iter = 0

    # ------------------------------------------------------------ persistence
    def save(self, directory: str, step: Optional[int] = None) -> None:
        """Both train states and the stage machine under `step` (the global
        iteration by default)."""
        extras = {
            "gnn_state": train_state(self.gnn_model, self.gnn_opt, self.gnn_steps),
            "betas": {str(i): torch.from_numpy(np.asarray(b)) for i, b in enumerate(self.betas)},
            "uot_bi": (None if self.uot_bi is None else
                       {str(i): torch.from_numpy(np.asarray(g)) for i, g in enumerate(self.uot_bi)}),
            "meta": {"stage": 0 if self.stage == SEG else 1, "alter_iter": self.alter_iter,
                     "init_iters": self.init_iters, "total_iter": self.total_iter,
                     "gnn_lr_scale": self.gnn_lr_scale}}
        CheckpointManager(directory, save_interval=1).maybe_save(
            train_state(self.seg_model, self.seg_opt, self.seg_steps), extras=extras,
            force=True, step=self.total_iter if step is None else step)

    def restore(self, directory: str) -> None:
        state, extras = CheckpointManager(directory).restore()
        self.seg_steps = load_train_state(self.seg_model, self.seg_opt, state)
        self.gnn_steps = load_train_state(self.gnn_model, self.gnn_opt, extras["gnn_state"])
        self.betas = [extras["betas"][str(i)].numpy() for i in range(self.n)]
        if extras.get("uot_bi") is not None:
            self.uot_bi = [extras["uot_bi"][str(i)].numpy() for i in range(self.n)]
        meta = extras["meta"]
        self.stage = SEG if int(meta["stage"]) == 0 else GNN
        self.alter_iter, self.init_iters = int(meta["alter_iter"]), int(meta["init_iters"])
        self.total_iter = int(meta.get("total_iter", 0))
        self.gnn_lr_scale = float(meta.get("gnn_lr_scale", 1.0))

    def load_states(self, states: Dict) -> None:
        """Both nets and both optimizers from `deploy/weights.py
        alternating_state_from_jax`: a port step that starts from JAX's
        state."""
        self.seg_model.load_state_dict(states["seg"], strict=True)
        self.gnn_model.load_state_dict(states["gnn"], strict=True)
        load_optimizer_state(self.seg_model, self.seg_opt, states["seg_optimizer"])
        load_optimizer_state(self.gnn_model, self.gnn_opt, states["gnn_optimizer"])

    def latest_step(self, directory: str) -> Optional[int]:
        if not os.path.isdir(directory):
            return None
        return CheckpointManager(directory).latest_step()

    # -------------------------------------------------------------------- loop
    def _to_device(self, arrays) -> List[torch.Tensor]:
        out = []
        for a in arrays:
            t = torch.from_numpy(np.asarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out.append(t)
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, batch, generator: Optional[torch.Generator] = None) -> Dict:
        """One alternating step on a per-dataset batch {ims: [...], lbs:
        [...]} of uint8 numpy arrays or tensors: the init phase, the stage
        switches, then the stage's step (gnn_trainer.py:579-640). Returns
        the metrics as device scalars."""
        self.total_iter += 1
        rec = {"step": self.total_iter}
        if self.init_iters > 0:
            self.init_iters -= 1
            metrics = self.init_step(generator or step_generator(self.seed, self.gnn_steps))
            if self.init_iters == 0:
                self.stage, self.alter_iter = GNN, 0
            rec["stage"] = "init"
            self.timings.append(rec)
            return metrics
        if self.mode in ("seg", "clip"):
            self.stage = SEG
        elif self.mode == "gnn":
            self.stage = GNN
        elif self.stage == SEG and self.alter_iter >= self.seg_iters:
            self.switch_to_gnn()
        elif self.stage == GNN and self.alter_iter >= self.gnn_iters:
            self._sync()
            t0 = time.perf_counter()
            self.switch_to_seg()
            self._sync()
            rec["switch_ms"] = (time.perf_counter() - t0) * 1e3
        ims, lbs = self._to_device(batch["ims"]), self._to_device(batch["lbs"])
        rec["stage"] = self.stage
        cuda = self.device.type == "cuda"
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        if self.stage == GNN:
            # the Gumbel τ of this step (gnn_trainer.py:621-627)
            rec["tau"] = gumbel_softmax_decay(self.alter_iter, 2e-5, self.gumbel_tau0, 0.01)
            metrics = self.gnn_step(
                ims, lbs, generator or step_generator(self.seed, self.gnn_steps),
                max_rate=self.alter_iter / max(self.gnn_iters, 1), tau=rec["tau"])
        else:
            metrics = self.seg_step(ims, lbs)
        if cuda:
            end.record()
            self._pending.append((rec, metrics["loss"].detach(), start, end))
        else:
            rec["step_ms"] = (time.perf_counter() - t0) * 1e3
            rec["loss"] = float(metrics["loss"].detach())
        self.alter_iter += 1
        self.timings.append(rec)
        return metrics

    def read_timings(self) -> List[Dict]:
        """`timings` with the pending steps' ms and loss read back, in one
        copy to the host."""
        if self._pending:
            self._sync()
            losses = torch.stack([p[1].float() for p in self._pending]).cpu().tolist()
            for (rec, _, start, end), loss in zip(self._pending, losses):
                rec["step_ms"], rec["loss"] = start.elapsed_time(end), loss
            self._pending = []
        return self.timings


def train_alternating(configer, work_dir: str = "./res", device="cuda",
                      finetune_from: Optional[str] = None,
                      compute_dtype: torch.dtype = torch.float32) -> AlternatingTrainer:
    """The alternating branch of the train CLI (tools/train.py:81-167):
    finetune, resume from `<work_dir>/ckpt_gnn`, step to lr.max_iter with
    the log line every train.log_interval steps, a checkpoint every
    train.ckpt_interval and at the end, and with train.eval_at_switch the
    `contrast` eval of the live model after each stage switch (its failure
    logged, not raised, as JAX's)."""
    from mds_tpu_torch.data.loader import get_data_loader
    from mds_tpu_torch.utils.logger import setup_logger
    from mds_tpu_torch.utils.meters import AvgMeter, TimeMeter

    logger = setup_logger("mds_tpu_torch_gnn", work_dir)
    trainer = AlternatingTrainer(configer, compute_dtype=compute_dtype, device=device)
    ckpt_dir = os.path.join(work_dir, "ckpt_gnn")
    g = lambda *k, d=None: configer.get(*k, default=d)
    ckpt_interval = int(g("train", "ckpt_interval", d=10000))
    log_interval = int(g("train", "log_interval", d=100))
    eval_at_switch = bool(g("train", "eval_at_switch", d=False))
    if finetune_from:
        trainer.finetune_from(finetune_from)
        logger.info(f"finetuning from {finetune_from}")
    if trainer.latest_step(ckpt_dir) is not None:
        trainer.restore(ckpt_dir)
        logger.info(f"restored alternating ckpt at iter {trainer.total_iter} "
                    f"(stage={trainer.stage}, alter_iter={trainer.alter_iter})")
    loader = get_data_loader(configer, "train")
    tm, lm = TimeMeter(trainer.max_iter), AvgMeter()

    def eval_now(tag):
        try:
            from mds_tpu_torch.evaluation.evaluator import eval_model

            mious = eval_model(configer, trainer.seg_model,
                               get_data_loader(configer, "eval"), mode="contrast")
            logger.info(f"[eval @{tag}] mIoUs: " + " ".join(f"{m:.4f}" for m in mious))
        except Exception as e:  # missing datasets etc.: the run goes on
            logger.warning(f"stage-switch eval failed: {e}")

    try:
        for it in range(trainer.total_iter, trainer.max_iter):
            prev = trainer.stage
            metrics = trainer.step(next(loader))
            tm.update()
            lm.update(metrics["loss"])
            if (it + 1) % log_interval == 0:
                trainer.read_timings()
                t, eta = tm.get()
                logger.info(f"iter {it + 1}/{trainer.max_iter} stage={trainer.stage} "
                            f"loss={lm.get()[0]:.4f} time={t:.2f} eta={eta}")
            if (it + 1) % ckpt_interval == 0:
                trainer.save(ckpt_dir)
            if eval_at_switch and trainer.stage != prev:
                eval_now(f"iter{it + 1}:{prev}->{trainer.stage}")
    finally:
        if hasattr(loader, "close"):
            loader.close()
        trainer.save(ckpt_dir)
        logger.info(f"saved alternating ckpt at iter {trainer.total_iter}")
    trainer.read_timings()
    return trainer
