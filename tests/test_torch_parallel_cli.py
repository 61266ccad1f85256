"""The CLIs under a process group, on the CPU: `tools/train_torch.py
--device cpu` and `tools/evaluate_torch.py --device cpu` in two gloo
processes joined through the JAX package's variables (MDS_COORDINATOR,
MDS_NUM_PROCESSES, MDS_PROCESS_ID), as `torchrun` or a JAX launcher would
start them; and the two trainers that run in one process only.

Each rank trains configs/test_synthetic.json 2 steps in SyncBN (the
default) and in local BN (`use_sync_bn False`), each rank with its own
work dir: the parameters and buffers are equal on both ranks, only rank
0's work dir holds a checkpoint and metrics.jsonl, and no rank imports jax.
Then both resume the SyncBN run to step 3 from rank 0's checkpoint alone
(rank 1's work dir holds none), and end alike.
Then both evaluate rank 0's checkpoint (`ss`) on their halves of the eval
lists: rank 0 prints the mIoU of the world-1 evaluation of that checkpoint.
Then the two multi-dataset trainers, 2 steps each: `--gnn` on
configs/test_synthetic_gnn.json shrunk as tests/test_torch_gnn_trainer_cli.py
shrinks it, one GNN step a stage (a GNN step, the UOT switch with its
eval, a SEG step), and `train.mode contrast` on
tests/torch_contrast_parity.py's tiny contrast config: both ranks end with
equal parameters, buffers, graphs, bank and teacher, and only rank 0's
work dir holds a checkpoint; then each resumes to step 3 from rank 0's
checkpoint alone and ends alike on both ranks. (Their world-2 steps
against world 1: tests/test_torch_parallel_gnn.py and
test_torch_parallel_contrast.py.)
"""

import os
import re
import sys

import numpy as np
import pytest

import torch_parallel_worker as w
from torch_eval_parity import one_torch_thread  # noqa: F401 (autouse)

CFG = os.path.join(w.REPO, "configs", "test_synthetic.json")
GNN_CFG = os.path.join(w.REPO, "configs", "test_synthetic_gnn.json")
GNN_SMALL = ["--gnn", "backbone.layers", "[1, 1, 1, 1]", "backbone.planes", "[64, 16, 24, 32]",
             "backbone.num_features", "16", "train.num_workers", "1", "train.gnn_iters", "1"]
# the two trainers' runs: (name, config, extra arguments, checkpoint dir)
MULTI = (("gnn", GNN_CFG, GNN_SMALL, "ckpt_gnn"), ("contrast", "contrast.json", [],
                                                   "ckpt_contrast"))

WORKER = f"""
import os, shutil, sys
sys.path[:0] = [{w.REPO!r}, {w.TESTS!r}, {os.path.join(w.REPO, "tools")!r}]
import numpy as np, torch
import torch_parallel_worker as w
import train_torch, evaluate_torch
from mds_tpu_torch.config import Configer
from mds_tpu_torch.engine.optim import optimizer_state
from mds_tpu_torch.parallel import mesh

rank, out = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
res = {{}}
for mode, extra in (("sync", []), ("local", ["use_sync_bn", "False"])):
    work = os.path.join(out, mode, f"rank{{rank}}")
    t = train_torch.main(["--config", {CFG!r}, "--work-dir", work, "--device", "cpu",
                          "--max-iter", "2"] + extra)
    assert mesh.world() == 2 and t.sync_bn == (mode == "sync") and t.step == 2
    res.update({{f"{{mode}}/{{k}}": v.double().numpy() for k, v in t.model.state_dict().items()
                 if not k.endswith("num_batches_tracked")}})
mesh.barrier()
# resume to step 3 from rank 0's step-2 checkpoint; rank 1's work dir has none
if rank == 0:
    shutil.copytree(os.path.join(out, "sync", "rank0", "ckpt"),
                    os.path.join(out, "resume", "rank0", "ckpt"))
mesh.barrier()
t = train_torch.main(["--config", {CFG!r}, "--work-dir", os.path.join(out, "resume", f"rank{{rank}}"),
                      "--device", "cpu", "--max-iter", "3"])
assert t.step == 3 and len(t.timings) == 1, (t.step, len(t.timings))
res.update({{f"resume/{{k}}": v.double().numpy() for k, v in t.model.state_dict().items()
             if not k.endswith("num_batches_tracked")}})
opt = optimizer_state(t.model, t.optimizer)
assert opt["count"] == 3 and opt["state"], opt["count"]
res.update({{f"resume_opt/{{k}}/{{j}}": v.double().numpy()
             for k, s in opt["state"].items() for j, v in s.items()}})
mesh.barrier()
res["mious"] = np.asarray(evaluate_torch.main([
    "--config", {CFG!r}, "--ckpt", os.path.join(out, "sync", "rank0", "ckpt"),
    "--device", "cpu"]))


def multi_state(tag, t):
    # the trainer's tensors: both nets, the UOT graphs and βs; or the
    # model, teacher and bank
    if tag.startswith("gnn"):
        mods = {{"seg": t.seg_model, "gnn": t.gnn_model}}
        res.update({{f"{{tag}}/uot{{i}}": g for i, g in enumerate(t.uot_bi)}})
        res.update({{f"{{tag}}/beta{{i}}": b for i, b in enumerate(t.betas)}})
    else:
        mods = {{"model": t.model, "teacher": t.teacher}}
        res.update({{f"{{tag}}/bank_{{k}}": getattr(t.bank, k).double().numpy()
                    for k in ("feats", "ptr", "count")}})
    for m, mod in mods.items():
        res.update({{f"{{tag}}/{{m}}/{{k}}": v.double().numpy() for k, v in mod.state_dict().items()}})


for name, cfg, extra, ck in {MULTI!r}:
    cfg = os.path.join(out, cfg) if not os.path.isabs(cfg) else cfg
    args = ["--config", cfg, "--device", "cpu"] + extra
    t = train_torch.main(args + ["--work-dir", os.path.join(out, name, f"rank{{rank}}"),
                                 "--max-iter", "2"])
    steps = t.total_iter if name == "gnn" else t.step_count
    assert steps == 2 and len(t.timings) == 2, (name, steps)
    if name == "gnn":
        assert [r["stage"] for r in t.timings] == ["GNN", "SEG"], t.timings
    multi_state(name, t)
    mesh.barrier()
    if rank == 0:
        shutil.copytree(os.path.join(out, name, "rank0", ck),
                        os.path.join(out, name + "_resume", "rank0", ck))
    mesh.barrier()
    t = train_torch.main(args + ["--work-dir", os.path.join(out, name + "_resume", f"rank{{rank}}"),
                                 "--max-iter", "3"])
    steps = t.total_iter if name == "gnn" else t.step_count
    assert steps == 3 and len(t.timings) == 1, (name, steps, len(t.timings))
    multi_state(name + "_resume", t)
w.finish(rank, out, res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from torch_contrast_parity import tiny_contrast_config, write_config

    d = tmp_path_factory.mktemp("cli")
    write_config(tiny_contrast_config(log_interval=1), d / "contrast.json")
    outs = w.launch(2, str(d), [], timeout=240, code=WORKER)
    r0, r1 = (dict(np.load(d / f"rank{r}.npz")) for r in range(2))
    return d, outs, r0, r1


@pytest.mark.parametrize("mode", ["sync", "local"])
def test_train_cli_two_ranks(runs, mode):
    d, _, r0, r1 = runs
    keys = [k for k in r0 if k.startswith(mode + "/")]
    assert len(keys) > 100
    for k in keys:
        assert np.array_equal(r0[k], r1[k]), k
        assert np.isfinite(r0[k]).all(), k
    assert os.listdir(d / mode / "rank0" / "ckpt") == ["2.pt"]
    assert os.path.isfile(d / mode / "rank0" / "runs" / "metrics.jsonl")
    assert os.listdir(d / mode / "rank1" / "ckpt") == []
    assert not os.path.exists(d / mode / "rank1" / "runs")


def test_train_cli_two_ranks_resume(runs):
    """Rank 0 resumes from its step-2 checkpoint and rank 1, whose work dir
    has none, from the state rank 0 broadcasts: both take step 3 alone (the
    worker asserts it) and end with the same parameters, buffers and
    optimizer state; only rank 0 saves."""
    d, _, r0, r1 = runs
    keys = [k for k in r0 if k.startswith(("resume/", "resume_opt/"))]
    assert sum(k.startswith("resume_opt/") for k in keys) > 50
    for k in keys:
        assert np.array_equal(r0[k], r1[k]), k
        assert np.isfinite(r0[k]).all(), k
    moved = [k for k in keys if k.startswith("resume/")
             and not np.array_equal(r0[k], r0["sync/" + k[len("resume/"):]])]
    assert len(moved) > 100
    assert sorted(os.listdir(d / "resume" / "rank0" / "ckpt")) == ["2.pt", "3.pt"]
    assert os.listdir(d / "resume" / "rank1" / "ckpt") == []


def test_evaluate_cli_two_ranks_equals_one(runs, capsys):
    """Rank 0 prints the summed hists' mIoU; rank 1 prints none; both
    equal the world-1 evaluation of the checkpoint."""
    d, outs, r0, r1 = runs
    sys.path.insert(0, os.path.join(w.REPO, "tools"))
    import evaluate_torch

    one = evaluate_torch.main(["--config", CFG, "--ckpt", str(d / "sync" / "rank0" / "ckpt"),
                               "--device", "cpu"])
    np.testing.assert_array_equal(r0["mious"], np.asarray(one))
    np.testing.assert_array_equal(r1["mious"], np.asarray(one))
    printed = [re.findall(r"dataset\d mIoU \(ss\): [\d.]+", o) for o in outs]
    assert len(printed[0]) == 2 and printed[1] == []


def _checkpoints(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".pt")) if os.path.isdir(path) else []


@pytest.mark.parametrize("name", ["gnn", "contrast"])
def test_multi_dataset_trainers_two_ranks(runs, name):
    """`--gnn` and `train.mode contrast` at world 2: both ranks end with
    the same tensors (nets, graphs and βs; model, teacher and bank); only
    rank 0 saves."""
    d, _, r0, r1 = runs
    keys = [k for k in r0 if k.startswith(name + "/")]
    assert len(keys) > 100
    for k in keys:
        assert np.array_equal(r0[k], r1[k]), k
        assert np.isfinite(r0[k]).all(), k
    ck = dict((n, c) for n, _, _, c in MULTI)[name]
    assert _checkpoints(d / name / "rank0" / ck) == ["2.pt"]
    assert _checkpoints(d / name / "rank1" / ck) == []
    if name == "contrast":
        assert os.path.isfile(d / name / "rank0" / "runs" / "metrics.jsonl")
        assert not os.path.exists(d / name / "rank1" / "runs")
        assert r0["contrast/bank_count"].sum() > 0


@pytest.mark.parametrize("name", ["gnn", "contrast"])
def test_multi_dataset_trainers_two_ranks_resume(runs, name):
    """Each resumes to step 3 from rank 0's step-2 checkpoint, rank 1's work
    dir empty: one step on both ranks (the worker asserts it), the same
    tensors on both, moved from step 2's; only rank 0 saves."""
    d, _, r0, r1 = runs
    keys = [k for k in r0 if k.startswith(name + "_resume/")]
    assert len(keys) > 100
    for k in keys:
        assert np.array_equal(r0[k], r1[k]), k
        assert np.isfinite(r0[k]).all(), k
    moved = [k for k in keys if not np.array_equal(r0[k], r0[name + k[len(name) + 7:]])]
    assert len(moved) > 20
    ck = dict((n, c) for n, _, _, c in MULTI)[name]
    assert _checkpoints(d / (name + "_resume") / "rank0" / ck) == ["2.pt", "3.pt"]
    assert _checkpoints(d / (name + "_resume") / "rank1" / ck) == []
