"""The two multi-dataset trainers and their global pieces at world size N
for tests/test_torch_parallel_gnn.py and test_torch_parallel_contrast.py,
jax-free.

A rank runs `main` as tests/torch_parallel_worker.py's `launch` starts it
(gloo on 127.0.0.1, the MDS_* variables): it reads the parent's
`inputs.npz` (configs as JSON, global batches), runs its tasks on its rows
of each dataset's batch, and writes `rank{r}.pt` (torch.save of a dict).
The parent runs the same functions without a group for the world-1 side.
Global batches hold each dataset's rows rank-major: rank r's rows of a
dataset of B are [r·B/world, (r + 1)·B/world), JAX's shard_batch layout.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

import torch_parallel_worker as w

WORKER = f"""
import sys
sys.path[:0] = [{w.REPO!r}, {w.TESTS!r}]
import torch_parallel_trainers as t
t.main(int(sys.argv[1]), sys.argv[2], sys.argv[3:])
"""
# seconds a rank waits for a file the parent writes during the launch
WAIT = 240


def configer(inp, name):
    from mds_tpu_torch.config import Configer

    return Configer(configs=json.loads(str(inp[f"cfg_{name}"])))


def rows_of(inp, prefix, n, rank, world):
    """This rank's rows of the per-dataset batch `{prefix}im{i}`,
    `{prefix}lb{i}` as {"ims", "lbs"} of numpy arrays."""
    from mds_tpu_torch.parallel import mesh

    return {"ims": mesh.shard_batch([inp[f"{prefix}im{i}"] for i in range(n)], rank, world),
            "lbs": mesh.shard_batch([inp[f"{prefix}lb{i}"] for i in range(n)], rank, world)}


def wait_for(path: str):
    """torch.load of `path` once the parent has written it."""
    deadline = time.time() + WAIT
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.1)
    return torch.load(path, weights_only=False)


def write_atomic(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _kind(name: str) -> str:
    for k in ("running_mean", "running_var", "/mu", "/nu", "momentum"):
        if k in name:
            return k
    return "param"


def scaled_rels(pairs: Dict, floor: float = 1e-3) -> Dict[str, float]:
    """{name: (got, want)} → each max-diff over the larger of `want`'s own
    largest magnitude and `floor` times the largest among the tensors of
    its kind (parameters, running means, running variances, first or
    second moments, momenta) under the same prefix ("seg:", "model:", ...):
    a tensor whose exact value is zero (the bias of a layer whose output
    only a train-mode BN reads, a running mean of an exactly centred
    input) holds rounding noise alone, which no relative measure of its
    own can hold."""
    diffs, mags, scale = {}, {}, {}
    for k, (g, v) in pairs.items():
        g, v = torch.as_tensor(g).double(), torch.as_tensor(v).double()
        diffs[k] = (g - v).abs().max().item() if v.numel() else 0.0
        mag = v.abs().max().item() if v.numel() else 0.0
        group = (k.split(":")[0], _kind(k))
        scale[k] = mag
        mags[group] = max(mags.get(group, 0.0), mag)
    out = {}
    for k, d in diffs.items():
        m = max(scale[k], floor * mags[(k.split(":")[0], _kind(k))])
        out[k] = d / m if m else d
    return out


# ------------------------------------------------------ the alternating trainer

def trainer_states(tt) -> Dict:
    """Both nets' state_dicts and AdamW states (tests/torch_flagship_parity.py
    `port_states`), the stage machine, the UOT graphs and the βs."""
    from mds_tpu_torch.engine.optim import optimizer_state

    return {"states": {"seg": {k: v.clone() for k, v in tt.seg_model.state_dict().items()},
                       "gnn": {k: v.clone() for k, v in tt.gnn_model.state_dict().items()},
                       "seg_optimizer": optimizer_state(tt.seg_model, tt.seg_opt),
                       "gnn_optimizer": optimizer_state(tt.gnn_model, tt.gnn_opt)},
            "machine": (tt.stage, tt.alter_iter, tt.total_iter, tt.seg_steps, tt.gnn_steps),
            "uot_bi": None if tt.uot_bi is None else [np.array(g) for g in tt.uot_bi],
            "betas": [np.array(b) for b in tt.betas]}


def trainer_from(cfg, snap, dtype):
    """An AlternatingTrainer of `cfg` on the CPU holding `snap` (a JAX
    snapshot in the port's terms, tests/torch_flagship_parity.py
    `snapshot`)."""
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    tt = AlternatingTrainer(cfg, compute_dtype=dtype, device="cpu")
    tt.load_states(snap["states"])
    for k in ("stage", "alter_iter", "total_iter", "seg_steps", "gnn_steps",
              "gnn_lr_scale", "uot_bi"):
        setattr(tt, k, snap[k])
    tt.betas = [np.array(b) for b in snap["betas"]]
    return tt


def alternating_run(inp, name, rank=0, world=1) -> Dict:
    """The config `cfg_{name}` from its seeded init, f64: `steps_{name}`
    steps on this rank's rows of the `gnn_` batch; each step's metrics and
    the collectives it made, then `trainer_states`."""
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
    from mds_tpu_torch.parallel import mesh

    cfg = configer(inp, name)
    tt = AlternatingTrainer(cfg, compute_dtype=torch.float64, device="cpu")
    b = rows_of(inp, "gnn_", cfg.n_datasets, rank, world)
    out = {"steps": []}
    for _ in range(int(inp[f"steps_{name}"])):
        before = mesh.all_reduce.collectives
        m = tt.step(b)
        out["steps"].append({"stage": tt.timings[-1]["stage"],
                             "collectives": mesh.all_reduce.collectives - before,
                             **{k: float(v.detach()) for k, v in m.items()}})
    out.update(trainer_states(tt))
    return out


def alternating_from_jax(inp, outdir, rank=0, world=1) -> Dict:
    """f32 steps from JAX's states (tests/test_torch_parallel_gnn.py): the
    GNN step from `jax_s0.pt`, then the SEG step from `jax_s1.pt`, JAX's
    state after its switch, which the parent writes once JAX has run."""
    cfg = configer(inp, "snp")
    b = rows_of(inp, "gnn_", cfg.n_datasets, rank, world)
    out = {}
    for tag, f in (("gnn", "jax_s0.pt"), ("seg", "jax_s1.pt")):
        tt = trainer_from(cfg, wait_for(os.path.join(outdir, f)), torch.float32)
        m = tt.step(b)
        out[tag] = {"metrics": {k: float(v.detach()) for k, v in m.items()},
                    **trainer_states(tt)}
    return out


def switch_eval_case(rank=0, world=1) -> Dict:
    """`gnn_trainer.switch_eval` where the last rank's eval loader fails,
    where the last rank's eval itself fails (the others' eval returns
    without a collective), and where neither fails: what each call
    returned, or "raised"; then the sum of the ranks over one all_reduce,
    which the ranks reach in step only if every call made the same
    collectives."""
    import logging

    from mds_tpu_torch.data import loader
    from mds_tpu_torch.engine.gnn_trainer import switch_eval
    from mds_tpu_torch.evaluation import evaluator
    from mds_tpu_torch.parallel import mesh

    def fails(what):
        def fn(*a, **kw):
            if rank == world - 1:
                raise OSError(f"rank {rank}: no {what}")
            return [] if what == "loaders" else [0.5]
        return fn

    real = loader.get_data_loader, evaluator.eval_model
    out = {}
    try:
        for case, patch in (("loader", (fails("loaders"), lambda *a, **kw: [0.5])),
                            ("eval", (lambda *a, **kw: [], fails("eval"))),
                            ("ok", (lambda *a, **kw: [], lambda *a, **kw: [0.5]))):
            loader.get_data_loader, evaluator.eval_model = patch
            try:
                out[case] = switch_eval(None, None, logging.getLogger("switch_eval"), case)
            except OSError:
                out[case] = "raised"
    finally:
        loader.get_data_loader, evaluator.eval_model = real
    out["after"] = int(mesh.all_reduce(torch.tensor([rank])))
    return out


# ---------------------------------------------------------- the contrast trainer

def contrast_run(inp, P, dtype, work, rank=0, world=1) -> Dict:
    """ContrastTrainer of `cfg_contrast` at `contrast.num_prototype` P from
    its seeded init (f64: model, teacher, bank and prototypes, the f32
    islands too), dropout on, 2 steps on this rank's rows of `ct0_`, then
    `ct1_` (the contrast term off, then on). Each step's metrics; then
    the model, the teacher, the SGD momenta, the bank and the prototypes."""
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
    from mds_tpu_torch.engine.optim import optimizer_state

    cfg = configer(inp, "contrast")
    cfg.update(["contrast", "num_prototype"], P)
    tt = ContrastTrainer(cfg, work_dir=work, compute_dtype=dtype, device="cpu")
    if dtype == torch.float64:
        tt.model.double()
        tt.teacher.double()
        tt.bank.feats = tt.bank.feats.double()
        if tt.prototypes is not None:
            tt.prototypes = tt.prototypes.double()
    sd = lambda mod: {k: v.double().clone() for k, v in mod.state_dict().items()  # noqa: E731
                      if not k.endswith("num_batches_tracked")}
    by_id = {id(p): g["name"] for g in tt.optimizer.param_groups for p in g["params"]}
    out = {"steps": [], "init": sd(tt.model),
           "groups": {n: by_id[id(p)] for n, p in tt.model.named_parameters()}}
    with w.f64_islands() if dtype == torch.float64 else contextlib.nullcontext():
        for k in range(2):
            m = tt.step(rows_of(inp, f"ct{k}_", cfg.n_datasets, rank, world))
            out["steps"].append({k2: float(v) for k2, v in m.items()})
    out.update(model=sd(tt.model), teacher=sd(tt.teacher),
               momenta={k: s["momentum_buffer"].double() for k, s in
                        optimizer_state(tt.model, tt.optimizer)["state"].items()},
               bank=tt.bank.feats.double().clone(), ptr=tt.bank.ptr.clone(),
               count=tt.bank.count.clone(),
               prototypes=None if tt.prototypes is None else tt.prototypes.double().clone())
    return out


def contrast_from_jax(inp, outdir, rank=0, world=1, dtype=torch.float32) -> Dict:
    """f32 steps from JAX's states (tests/test_torch_parallel_contrast.py):
    at P = 1 and 2, each of the two steps from `jax_c{P}_{k}.pt`, which the
    parent writes as JAX's trainer runs on its 2-device mesh: JAX's state
    before its step k in the port's terms, and JAX's noise of that step
    (each dataset's (U, N_i) anchor noise at P = 1, the (Σ N_i, P) Gumbel
    noise at P = 2, N_i dataset i's global pixel count, `sizes`), of which
    this rank takes its columns and rows. Dropout off, as JAX's is stubbed.
    In f64 (the exact steps, at world 1) the model, teacher, bank,
    prototypes, noise and the f32 islands are f64. Each step's metrics,
    the state after it (numpy, f64) and the param groups."""
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
    from mds_tpu_torch.models.layers import FastDropout
    from mds_tpu_torch.parallel import mesh

    def sd(mod):
        return {k: v.double().numpy() for k, v in mod.state_dict().items()
                if not k.endswith("num_batches_tracked")}

    out = {}
    for P in (1, 2):
        cfg = configer(inp, "contrast")
        cfg.update(["contrast", "num_prototype"], P)
        for k in range(2):
            got = wait_for(os.path.join(outdir, f"jax_c{P}_{k}.pt"))
            tt = ContrastTrainer(cfg, work_dir=os.path.join(outdir, f"from_jax{rank}"),
                                 compute_dtype=dtype, device="cpu")
            if dtype == torch.float64:
                tt.model.double()
                tt.teacher.double()
            tt.load(got["state"], got["extras"])
            tt.bank.feats = tt.bank.feats.to(dtype)
            if tt.prototypes is not None:
                tt.prototypes = tt.prototypes.to(dtype)
            for m in tt.model.modules():
                if isinstance(m, FastDropout):
                    m.rate = 0.0
            n = [c // world for c in got["sizes"]]
            if P == 1:
                kw = {"noise": [torch.from_numpy(z[:, rank * c:(rank + 1) * c]).to(dtype)
                                for z, c in zip(got["anchor_noise"], n)]}
            else:
                kw = {"proto_noise": torch.from_numpy(got["proto_noise"])[
                    mesh.global_rows(n)[0]].to(dtype)}
            with w.f64_islands() if dtype == torch.float64 else contextlib.nullcontext():
                m = tt.step(rows_of(inp, f"ct{k}_", cfg.n_datasets, rank, world), **kw)
            by_id = {id(p): g["name"] for g in tt.optimizer.param_groups for p in g["params"]}
            out[f"{P}_{k}"] = {
                "metrics": {key: float(v) for key, v in m.items()},
                "model": sd(tt.model), "teacher": sd(tt.teacher),
                "bank": tt.bank.feats.double().numpy(), "ptr": tt.bank.ptr.numpy(),
                "count": tt.bank.count.numpy(), "step": tt.step_count,
                "prototypes": None if tt.prototypes is None else tt.prototypes.double().numpy(),
                "groups": {name: by_id[id(p)] for name, p in tt.model.named_parameters()}}
    return out


# --------------------------------------------------------------- the unit cases

def gather_case(inp, rank=0, world=1) -> Dict:
    """`mesh.gather_rows` of this rank's rows of `g_x` and the gradient of
    Σ (gathered · g_w) / world on every rank: the gathered rows and this
    rank's input gradient."""
    from mds_tpu_torch.parallel import mesh

    (x,) = mesh.shard_batch([inp["g_x"]], rank, world)
    x = torch.from_numpy(x).requires_grad_(True)
    with mesh.data_parallel(sync_bn=True):
        got = mesh.gather_rows(x)
        (got * torch.from_numpy(inp["g_w"])).sum().div(world).backward()
    return {"gathered": got.detach().clone(), "grad": x.grad.clone()}


def anchor_cases(inp, rank=0, world=1) -> Dict:
    """Each `anc_{c}` case: `hard_anchor_sample` and `anchor_picks` inside
    a data-parallel step on this rank's columns of the case's pixels and
    noise, n_view 4; the anchors, valid, this rank's candidates as global
    pixel indices, the picks' positions among every rank's candidates and
    the gradient of Σ anchors · weight / world into the features."""
    from mds_tpu_torch.losses.contrast import anchor_picks, hard_anchor_sample
    from mds_tpu_torch.parallel import mesh

    out = {}
    for c in sorted({k.split("_")[1] for k in inp if k.startswith("anc_")}):
        f, lb, pr = mesh.shard_batch([inp[f"anc_{c}_{k}"] for k in ("feats", "labels",
                                                                    "preds")], rank, world)
        (nz,) = mesh.shard_batch([inp[f"anc_{c}_noise"].T], rank, world)
        feats = torch.from_numpy(f).requires_grad_(True)
        args = (torch.from_numpy(lb), torch.from_numpy(pr), torch.from_numpy(nz.T.copy()))
        with mesh.data_parallel(sync_bn=True):
            anchors, valid = hard_anchor_sample(feats, *args, n_view=4)
            (anchors * torch.from_numpy(inp[f"anc_{c}_weight"])).sum().div(world).backward()
            cand, pos, _ = anchor_picks(*args, n_view=4)
        out[c] = {"anchors": anchors.detach().clone(), "valid": valid,
                  "cand": cand + rank * len(lb), "pos": pos, "grad": feats.grad.clone()}
    return out


def remap_case(inp, rank=0, world=1) -> Dict:
    """`ContrastRemapping` of dataset 1 inside a data-parallel step on this
    rank's rows of `rm_labels` and `rm_sim` (ratio from cur_iter 3 of
    lr.max_iter 8)."""
    from mds_tpu_torch.data.class_remap import ClassRemapOneHotLabel
    from mds_tpu_torch.parallel import mesh

    cfg = configer(inp, "remap")
    lb, sim = mesh.shard_batch([inp["rm_labels"], inp["rm_sim"]], rank, world)
    with mesh.data_parallel(sync_bn=True):
        cm, seg = ClassRemapOneHotLabel(cfg).ContrastRemapping(
            torch.from_numpy(lb), torch.from_numpy(sim), 1, cur_iter=3)
    return {"contrast_mask": cm, "seg_mask": seg}


def proto_case(inp, rank=0, world=1) -> Dict:
    """`grouped_sinkhorn` and `prototype_learning` inside a data-parallel
    step on this rank's rows of the two datasets' `pl{i}_*` pixels, laid
    out as the trainer lays them (each dataset's rows, then the next's),
    the Gumbel noise this rank's rows of the global draw; Σ logits · weight
    over this rank's rows backward into the embeddings."""
    from mds_tpu_torch.ops.prototype_learning import grouped_sinkhorn, prototype_learning
    from mds_tpu_torch.parallel import mesh

    parts = [mesh.shard_batch([inp[f"pl{i}_{k}"] for k in ("emb", "gt", "correct")],
                              rank, world) for i in range(2)]
    emb, gt, correct = (torch.from_numpy(np.concatenate([p[j] for p in parts]))
                        for j in range(3))
    rows, total = mesh.global_rows([len(p[0]) for p in parts])
    assert total == len(inp["pl_noise"])
    noise = torch.from_numpy(inp["pl_noise"])[rows]
    emb.requires_grad_(True)
    protos = torch.from_numpy(inp["pl_protos"])
    K, P, _ = protos.shape
    with mesh.data_parallel(sync_bn=True):
        plan, idx = grouped_sinkhorn(torch.from_numpy(inp["pl_scores"])[rows], gt, K, gt < K)
        res = prototype_learning(protos, emb, gt, correct, coefficient=0.9, noise=noise)
        (res.proto_logits * torch.from_numpy(inp["pl_weight"])[rows]).sum().backward()
    return {"plan": plan, "slot": idx, "target": res.proto_target,
            "prototypes": res.prototypes, "prototypes_in": protos, "grad": emb.grad.clone()}


def bank_case(inp, rank=0, world=1) -> Dict:
    """Two `memory_bank_push`es inside a data-parallel step of this rank's
    rows of `bk_feats`, `bk_labels` into a bank of 5 classes × 3 slots."""
    from mds_tpu_torch.losses.contrast import MemoryBank, memory_bank_push
    from mds_tpu_torch.parallel import mesh

    bank = MemoryBank.create(5, 3, inp["bk_feats"].shape[-1]).to("cpu")
    bank.feats = bank.feats.double()
    for k in range(2):
        f, lb = mesh.shard_batch([inp["bk_feats"][k], inp["bk_labels"][k]], rank, world)
        with mesh.data_parallel(sync_bn=True):
            bank = memory_bank_push(bank, torch.from_numpy(f), torch.from_numpy(lb))
    return {"feats": bank.feats, "ptr": bank.ptr, "count": bank.count}


def units(inp, rank=0, world=1) -> Dict:
    return {"gather": gather_case(inp, rank, world), "anchors": anchor_cases(inp, rank, world),
            "remap": remap_case(inp, rank, world), "proto": proto_case(inp, rank, world),
            "bank": bank_case(inp, rank, world)}


def main(rank: int, outdir: str, tasks: List[str]) -> None:
    from mds_tpu_torch.parallel import mesh

    torch.set_num_threads(1)  # beside the tier-1 run's other workers
    assert mesh.maybe_initialize_distributed(device="cpu")
    world = mesh.world()
    inp = np.load(os.path.join(outdir, "inputs.npz"))
    res: Dict = {}
    for task in tasks:
        if task.startswith("alternating:"):
            name = task.split(":")[1]
            res[name] = alternating_run(inp, name, rank, world)
        elif task == "from_jax":
            res["from_jax"] = alternating_from_jax(inp, outdir, rank, world)
        elif task == "switch_eval":
            res["switch_eval"] = switch_eval_case(rank, world)
        elif task.startswith("contrast:"):
            _, P, dt = task.split(":")
            dtype = torch.float64 if dt == "f64" else torch.float32
            res[f"contrast{P}_{dt}"] = contrast_run(
                inp, int(P), dtype, os.path.join(outdir, f"work{rank}_{P}_{dt}"), rank, world)
        elif task == "contrast_from_jax":
            res["contrast_from_jax"] = contrast_from_jax(inp, outdir, rank, world)
        elif task == "units":
            res["units"] = units(inp, rank, world)
        else:
            raise ValueError(task)
    res["collectives"] = mesh.all_reduce.collectives
    assert "jax" not in sys.modules and not any(
        m == "mds_tpu" or m.startswith("mds_tpu.") for m in sys.modules), "a rank imported jax"
    torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
