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
The alternating and contrast trainers refuse world 2, naming ROADMAP
queue 1, item 9b.
"""

import os
import re
import sys

import numpy as np
import pytest

import torch_parallel_worker as w
from torch_eval_parity import one_torch_thread  # noqa: F401 (autouse)

CFG = os.path.join(w.REPO, "configs", "test_synthetic.json")

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
from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
for cls in (AlternatingTrainer, ContrastTrainer):
    try:
        cls(Configer(config_file={CFG!r}), device="cpu")
    except NotImplementedError as e:
        assert "item 9b" in str(e), str(e)
        print(f"REFUSED {{cls.__name__}}: {{e}}", flush=True)
    else:
        raise AssertionError(f"{{cls.__name__}} ran at world 2")
w.finish(rank, out, res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
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


def test_alternating_and_contrast_trainers_refuse_world2(runs):
    _, outs, _, _ = runs
    for o in outs:
        assert "REFUSED AlternatingTrainer" in o and "REFUSED ContrastTrainer" in o
