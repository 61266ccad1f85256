"""The port's data-parallel runs for the parallel tests, jax-free.

`launch` starts `world` processes of `python -c CODE rank outdir`, each
joining a gloo group on 127.0.0.1 through the JAX package's variables
(MDS_COORDINATOR, MDS_NUM_PROCESSES, MDS_PROCESS_ID), and raises with
their output if one fails or outlasts its time. A worker imports this
module and `mds_tpu_torch`, never jax (`finish` asserts it), runs its tasks
on its rank's share of the inputs the parent wrote to `outdir/inputs.npz`,
and writes `outdir/rank{r}.npz`. The parent runs the same functions without
a group for the world-1 side. Not `torch.multiprocessing.spawn`: its child
would import the test module, and with it jax.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
# configs/bisenetv2_city.json's, as tests/torch_parity.py's
MEAN = np.asarray([0.3257, 0.3690, 0.3223], np.float32)
STD = np.asarray([0.2112, 0.2148, 0.2115], np.float32)
LR, WD, MOM = 5e-3, 5e-4, 0.9

# a worker's program: python -c WORKER rank outdir task ...
WORKER = f"""
import sys
sys.path[:0] = [{REPO!r}, {TESTS!r}]
import torch_parallel_worker as w
w.main(int(sys.argv[1]), sys.argv[2], sys.argv[3:])
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(world: int, outdir: str, tasks: List[str], timeout: float = 120,
           code: str = WORKER) -> List[str]:
    """Run `code` as `world` ranks of one gloo group; their outputs."""
    port = str(free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, MDS_COORDINATOR=f"127.0.0.1:{port}",
                   MDS_NUM_PROCESSES=str(world), MDS_PROCESS_ID=str(r),
                   OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, str(r), outdir, *tasks], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, failed = [], False
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0] + "\n[timed out]")
        failed |= p.returncode != 0
    if failed:
        raise AssertionError("a rank failed:\n" + "\n-----\n".join(o[-6000:] for o in outs))
    return outs


def finish(rank: int, outdir: str, res: Dict[str, np.ndarray]) -> None:
    assert "jax" not in sys.modules and not any(m.startswith("mds_tpu.") or m == "mds_tpu"
                                                 for m in sys.modules), "a worker imported jax"
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)


@contextlib.contextmanager
def f64_islands():
    """`Tensor.float()` keeps an f64 tensor f64 (tests/torch_parity.py's),
    so an f64 model's f32 islands run in f64."""
    f = torch.Tensor.float
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else f(self, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = f


def bisenetv2(inp, dtype=torch.float32, dropout=True):
    """The port's BiSeNetV2 with the state dict under `sd_` in `inp`."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.models.layers import FastDropout

    n_classes = tuple(int(n) for n in inp["n_classes"])
    m = MODELS["bisenetv2"](n_classes=n_classes, n_bn=len(n_classes), aux=True, dtype=dtype)
    sd = {k[3:]: torch.from_numpy(inp[k]) for k in inp if k.startswith("sd_")}
    missing = set(m.load_state_dict(sd, strict=False).missing_keys)
    assert all(k.endswith("num_batches_tracked") for k in missing), sorted(missing)[:5]
    if not dropout:
        for mod in m.modules():
            if isinstance(mod, FastDropout):
                mod.rate = 0.0
    return m.double() if dtype == torch.float64 else m


def seg_step(inp, dtype, fused_up_loss=False, local_bn=False, dropout=True,
             rank=0, world=1, prefix=""):
    """One SGD step of BiSeNetV2 on this rank's rows of the batch `im{i}`,
    `lb{i}` of `inp` (every row without a group): {prefix + "loss": ...,
    prefix + name: every parameter and running stat after it}."""
    from mds_tpu_torch.engine.optim import sgd_param_groups
    from mds_tpu_torch.engine.train_step import make_seg_train_step
    from mds_tpu_torch.parallel import mesh

    m = bisenetv2(inp, dtype, dropout=dropout)
    n = len(inp["n_classes"])
    opt = sgd_param_groups(m, lambda _: LR, momentum=MOM, weight_decay=WD)
    step = make_seg_train_step(m, opt, [MEAN] * n, [STD] * n, compute_dtype=dtype,
                               fused_up_loss=fused_up_loss, local_bn=local_bn)
    ims = mesh.shard_batch([inp[f"im{i}"] for i in range(n)], rank, world)
    lbs = mesh.shard_batch([inp[f"lb{i}"] for i in range(n)], rank, world)
    with f64_islands() if dtype == torch.float64 else contextlib.nullcontext():
        met = step([torch.from_numpy(x) for x in ims], [torch.from_numpy(x) for x in lbs],
                   torch.Generator().manual_seed(3))
    out = {prefix + "loss": met["loss"].double().numpy()}
    out.update({prefix + k: v.double().numpy() for k, v in m.state_dict().items()
                if not k.endswith("num_batches_tracked")})
    return out


# the steps of the SyncBN test: (prefix, dtype, fused_up_loss, local_bn)
STEPS = (("f32_", torch.float32, False, False), ("fused_", torch.float32, True, False),
         ("f64_", torch.float64, False, False), ("local_", torch.float32, False, True))


def norms(inp, rank=0, world=1):
    """The two train norms in a SyncBN step, f64 throughout
    (`f64_islands`), on this rank's rows of
    `norm_x` (upstream gradient `norm_g`): DatasetNorm's two-pass moments
    (dataset 1 of 2, its own affine) and bn_eval's flax moments (BiSeNetV1,
    ResNet18): outputs, input gradients and the running stats after."""
    from mds_tpu_torch.models.layers import DatasetNorm, bn_eval
    from mds_tpu_torch.parallel import mesh

    x, g = mesh.shard_batch([inp["norm_x"], inp["norm_g"]], rank, world)
    c = x.shape[1]
    out = {}
    dn = DatasetNorm(c, n_bn=2, affine=True, dtype=torch.float64).double().train()
    bn = torch.nn.BatchNorm2d(c).double().train()
    with torch.no_grad():
        for m in (dn[1], bn):
            m.weight.copy_(torch.linspace(0.5, 1.5, c))
            m.bias.copy_(torch.linspace(-0.2, 0.2, c))
    for name, fn, mod in (("dataset_norm", lambda t: dn([None, t])[1], dn[1]),
                          ("bn_eval", lambda t: bn_eval(bn, t, torch.float64), bn)):
        t = torch.from_numpy(x).requires_grad_(True)
        with mesh.data_parallel(sync_bn=True), f64_islands():
            y = fn(t)
            (y * torch.from_numpy(g)).sum().backward()
        out.update({f"{name}_y": y.detach().numpy(), f"{name}_dx": t.grad.numpy(),
                    f"{name}_mean": mod.running_mean.numpy().copy(),
                    f"{name}_var": mod.running_var.numpy().copy()})
    return out


def dropout_masks(shape, rank=0, world=1):
    """FastDropout's masks in a data-parallel step on this rank's rows of a
    `shape` batch of ones, in bf16 and f32, and the input gradient's."""
    from mds_tpu_torch.models.layers import FastDropout
    from mds_tpu_torch.parallel import mesh

    out = {}
    drop = FastDropout(0.1).train()
    rows = (shape[0] // world,) + tuple(shape[1:])
    for dt in (torch.bfloat16, torch.float32):
        x = torch.ones(rows, dtype=dt, requires_grad=True)
        with mesh.data_parallel(sync_bn=True):
            y = drop(x, torch.Generator().manual_seed(11))
            y.float().sum().backward()
        key = str(dt).split(".")[-1]
        out[f"mask_{key}"] = (y.detach().float() != 0).numpy()
        out[f"grad_{key}"] = (x.grad.float() != 0).numpy()
    return out


def ohem_cases(inp, rank=0, world=1):
    """ohem_mean in a SyncBN step on this rank's rows of each case's
    `losses_{c}`, `valid_{c}`: the value (this rank's share) and the
    gradient of the losses."""
    from mds_tpu_torch.losses.ohem_ce import ohem_mean
    from mds_tpu_torch.parallel import mesh

    out = {}
    for c in [k[7:] for k in inp if k.startswith("losses_")]:
        losses, valid = mesh.shard_batch([inp[f"losses_{c}"], inp[f"valid_{c}"]], rank, world)
        x = torch.from_numpy(losses).requires_grad_(True)
        with mesh.data_parallel(sync_bn=True):
            v = ohem_mean(x, torch.from_numpy(valid), float(inp["thresh"]))
        v.backward()
        out[f"ohem_{c}"], out[f"ohem_grad_{c}"] = v.detach().numpy(), x.grad.numpy()
    return out


def eval_hists(config="configs/test_synthetic.json"):
    """ss eval of BiSeNetV2 (the config's seeded init) on this rank's share
    of each dataset's eval list: the hists after the reduction and the
    mIoUs."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.evaluation import evaluator
    from mds_tpu_torch.evaluation.drivers import run_evaluation

    hists = []
    real = evaluator._psum_hist
    evaluator._psum_hist = lambda h: hists.append(real(h)) or hists[-1]
    try:
        mious = run_evaluation(Configer(config_file=os.path.join(REPO, config)), "ss",
                               work_dir="/nonexistent", device="cpu")
    finally:
        evaluator._psum_hist = real
    return {**{f"hist{i}": h for i, h in enumerate(hists)}, "mious": np.asarray(mious)}


def oracle_fns(n):
    """tests/test_spatial.py's two logits_fns, NCHW: each pixel's class
    one-hot (receptive field 1), and the same at half resolution."""
    import torch.nn.functional as F

    def local(x, ds):
        cls = torch.clamp(torch.round(x[:, 0] / 20.0), 0, n - 1).long()
        return F.one_hot(cls, n).permute(0, 3, 1, 2).float()

    return {"local": local, "down": lambda x, ds: local(x[:, :, ::2, ::2], ds)}


def tiles(inp, world=1, n_tiles=None):
    """tiled_inference of each oracle on `tile_im_{name}` and of BiSeNetV2
    (eval logits, f32) on `tile_im_model`."""
    from mds_tpu_torch.evaluation.evaluator import make_logits_fn
    from mds_tpu_torch.parallel.spatial import tiled_inference

    out = {}
    n = int(inp["tile_n"])
    for name, fn in oracle_fns(n).items():
        im = torch.from_numpy(inp[f"tile_im_{name}"])
        out[f"tile_{name}"] = tiled_inference(fn, im, n, n_tiles=n_tiles,
                                              margin=int(inp[f"tile_margin_{name}"])).numpy()
    model = bisenetv2(inp).eval()
    fn = make_logits_fn(model, MEAN, STD)
    with torch.no_grad():
        out["tile_model"] = tiled_inference(fn, torch.from_numpy(inp["tile_im_model"]),
                                            int(inp["n_classes"][0]), n_tiles=n_tiles,
                                            margin=int(inp["tile_margin_model"])).numpy()
    return out


def halo(inp, rank=0, world=1):
    """halo_conv3x3 of this rank's W-shard of `halo_x`."""
    from mds_tpu_torch.parallel.spatial import halo_conv3x3

    x = torch.from_numpy(inp["halo_x"])
    w = x.shape[-1] // world
    return {"halo": halo_conv3x3(x[..., rank * w:(rank + 1) * w],
                                 torch.from_numpy(inp["halo_k"])).numpy()}


def main(rank: int, outdir: str, tasks: List[str]) -> None:
    from mds_tpu_torch.parallel import mesh

    torch.set_num_threads(1)  # beside the tier-1 run's other workers
    assert mesh.maybe_initialize_distributed(device="cpu")
    world = mesh.world()
    inp = np.load(os.path.join(outdir, "inputs.npz"))
    res: Dict[str, np.ndarray] = {}
    for task in tasks:
        if task == "steps":
            for prefix, dt, fused, local in STEPS:
                res.update(seg_step(inp, dt, fused, local, rank=rank, world=world,
                                    prefix=prefix))
        elif task == "local_bn":  # the local-BN step against JAX's, dropout off
            for prefix, dt in (("f32_", torch.float32), ("f64_", torch.float64)):
                res.update(seg_step(inp, dt, local_bn=True, dropout=False, rank=rank,
                                    world=world, prefix=prefix))
        elif task == "norms":
            res.update(norms(inp, rank, world))
        elif task == "dropout":
            res.update(dropout_masks(tuple(inp["drop_shape"]), rank, world))
        elif task == "ohem":
            res.update(ohem_cases(inp, rank, world))
        elif task == "eval":
            res.update(eval_hists())
        elif task == "tiles":
            res.update(tiles(inp, world))
        elif task == "halo":
            res.update(halo(inp, rank, world))
        else:
            raise ValueError(task)
    res["collectives"] = np.asarray(mesh.all_reduce.collectives)
    finish(rank, outdir, res)
