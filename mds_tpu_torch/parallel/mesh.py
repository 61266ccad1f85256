"""The process group and data parallelism — counterpart of
mds_tpu/parallel/mesh.py (`maybe_initialize_distributed` :25, `replicate`
:73, `shard_batch` :87, `pad_batch_to` :100).

JAX runs one program over a 1-D `data` mesh: parameters are replicated,
batches sharded on their leading axis, and every reduction of the step
(BN moments, the OHEM pool, the loss mean) is taken over the global batch,
so SyncBN comes for free; `local_bn` shard_maps the gradient so that each
shard normalizes with its own moments (mds_tpu/engine/train_step.py:159).
Here each rank is a process with its rows of the batch, and the step says
what is global:

- `data_parallel(sync_bn)` marks a train step's forward and backward. Under
  `sync_bn=True` the train norms (models/layers.py) and the OHEM pool
  (losses/ohem_ce.py) reduce over every rank with `global_sum`, whose
  backward is the same all_reduce, so the gradient flows through the other
  ranks' contributions; each rank's loss is its share of the global loss,
  and `all_reduce_grads` sums. Under `sync_bn=False` nothing inside the
  model reduces; `all_reduce_grads` averages (JAX's pmean). Under either,
  the dropout draws this rank's rows of the global mask (`shard_index`).
- Outside it, nothing reduces: evaluation and precise BN are per rank.
- The two multi-dataset trainers (engine/gnn_trainer.py,
  engine/contrast_trainer.py) take SyncBN's step alone and end it with
  `sum_step`; their global pieces gather rows (`gather_rows`, whose
  backward returns this rank's block of the summed gradient), locate a
  rank's rows in a multi-dataset layout (`global_rows`), reduce per class
  by sum or max (`step_sum`) and weight a term every rank computes whole
  by `replicated_share`.

The collectives are `all_reduce` (sum or max) and `broadcast` alone, in
f32, f64 or int64: NCCL runs them, and so does gloo on CUDA tensors (two ranks sharing
one card, which NCCL refuses) and on CPU tensors. Without a process group
every function here is the identity or a no-op, and the step is the one
process's step. `collectives` counts the reductions and broadcasts made.
"""

from __future__ import annotations

import contextlib
import io
import os
from datetime import timedelta
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# a collective that waits longer fails the run instead of stalling it
TIMEOUT = timedelta(seconds=300)

_STEP: Optional[bool] = None  # None outside a data-parallel step, else sync_bn


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def local_rank() -> int:
    """This process's card index: torchrun's LOCAL_RANK, else the rank over
    the visible cards (two ranks share one card when there is one)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank() % max(n, 1)


def local_device(device="cuda") -> torch.device:
    """`device` for this rank of a group: cuda:LOCAL_RANK for a CUDA
    device; `device` itself otherwise and without a group."""
    device = torch.device(device)
    if device.type == "cuda" and initialized():
        return torch.device("cuda", local_rank())
    return device


def maybe_initialize_distributed(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group a launcher set up in the environment:
    torchrun's RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (LOCAL_RANK
    picks the card), or the JAX package's MDS_COORDINATOR (host:port),
    MDS_NUM_PROCESSES and MDS_PROCESS_ID. The backend is NCCL for a CUDA
    `device`, gloo for the CPU, or `backend`. Returns True if this call
    joined a group; False without such variables or with a group already
    up."""
    if initialized():
        return False
    env = os.environ
    if env.get("MDS_COORDINATOR"):
        init = f"tcp://{env['MDS_COORDINATOR']}"
        n, r = int(env["MDS_NUM_PROCESSES"]), int(env["MDS_PROCESS_ID"])
    elif env.get("WORLD_SIZE") and env.get("MASTER_ADDR"):
        init = "env://"
        n, r = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return False
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        lr = int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env else r % torch.cuda.device_count()
        torch.cuda.set_device(lr)
    dist.init_process_group(backend, init_method=init, world_size=n, rank=r,
                            timeout=TIMEOUT)
    return True


def _comm(t: torch.Tensor):
    """(tensor to hand the backend, device to bring the result back to):
    NCCL takes CUDA tensors only."""
    if t.device.type == "cpu" and dist.get_backend() == "nccl":
        return t.to(local_device("cuda")), t.device
    return t, t.device


def all_reduce(t: torch.Tensor, mean: bool = False, op: str = "sum") -> torch.Tensor:
    """The sum (or, floating, the mean), or with op "max" the elementwise
    max, of `t` over the ranks, as a new tensor; `t` itself without a
    group."""
    if not initialized():
        return t
    out, home = _comm(t.clone())
    dist.all_reduce(out, dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
    all_reduce.collectives += 1
    if mean:
        out = out / dist.get_world_size()
    return out.to(home)


all_reduce.collectives = 0


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank `src`'s `t` into every rank's `t`, in place."""
    if initialized():
        out, _ = _comm(t)
        dist.broadcast(out, src)
        all_reduce.collectives += 1
        if out is not t:
            t.copy_(out)
    return t


def broadcast_state(state, src: int = 0):
    """Rank `src`'s `state` on every rank: a checkpoint's train state
    (tensors, numbers, strings and containers) or None, whatever the other
    ranks pass. It travels as `torch.save`'s bytes in an int64 tensor (two
    broadcasts: the length, then the bytes) and is read back with
    `weights_only=True`, on the CPU. `state` itself at world size 1."""
    if world() == 1:
        return state
    data = b""
    if rank() == src and state is not None:
        buf = io.BytesIO()
        torch.save(state, buf)
        data = buf.getvalue()
    n = int(broadcast_(torch.tensor([len(data)], dtype=torch.int64), src))
    if n == 0:
        return None
    words = torch.zeros(-(-n // 8), dtype=torch.int64)
    if rank() == src:
        words.view(torch.uint8)[:n] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    broadcast_(words, src)
    if rank() == src:
        return state
    return torch.load(io.BytesIO(words.view(torch.uint8)[:n].numpy().tobytes()),
                      map_location="cpu", weights_only=True)


def barrier() -> None:
    if initialized():
        dist.barrier()


class GlobalSum(torch.autograd.Function):
    """y = Σ_ranks x, whose backward is the same sum of the output
    gradients: with every rank's loss a share of one global loss, the
    gradient each rank's x takes is that of the global loss."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous())


def global_sum(x: torch.Tensor) -> torch.Tensor:
    return GlobalSum.apply(x)


class GatherRows(torch.autograd.Function):
    """Every rank's x (one shape on all) stacked rank-major on dim 0: the
    all_reduce of a zero buffer in which this rank fills its own block. Its
    backward is this rank's block of the output gradients' sum over the
    ranks: a term every rank computes whole from the gathered rows, weighted
    1/world, gives each rank's rows the gradient of the term."""

    @staticmethod
    def forward(ctx, x):
        n, r = x.shape[0], rank()
        ctx.n = n
        buf = x.new_zeros((world() * n,) + tuple(x.shape[1:]))
        buf[r * n:(r + 1) * n] = x
        return all_reduce(buf)

    @staticmethod
    def backward(ctx, g):
        r, n = rank(), ctx.n
        return all_reduce(g.contiguous())[r * n:(r + 1) * n]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """(world·n, ...) of every rank's (n, ...) `x`, rank r's at rows
    [r·n, (r + 1)·n); `x` itself without a group."""
    return x if world() == 1 else GatherRows.apply(x)


def global_rows(sizes: Sequence[int]) -> Tuple[torch.Tensor, int]:
    """Where this rank's rows sit in a tensor that concatenates datasets'
    global rows, each dataset's rank-major (JAX's shard_batch layout):
    `sizes` are this rank's row counts a dataset (every rank holds as
    many); dataset i's block starts at Σ_{j<i} world·sizes[j] and rank r's
    rows of it at r·sizes[i] within. → (this rank's row indices in that
    order, int64; the global row count)."""
    n, r = world(), rank()
    idx, start = [], 0
    for k in sizes:
        idx.append(torch.arange(start + r * k, start + (r + 1) * k))
        start += n * k
    return (torch.cat(idx) if idx else torch.zeros(0, dtype=torch.long)), start


@contextlib.contextmanager
def data_parallel(sync_bn: bool = True) -> Iterator[None]:
    """Mark a train step (module docstring); with no group it marks nothing."""
    global _STEP
    prev, _STEP = _STEP, (bool(sync_bn) if initialized() else None)
    try:
        yield
    finally:
        _STEP = prev


def sync_active() -> bool:
    """Whether the train norms and the OHEM pool reduce over the ranks."""
    return _STEP is True


def step_sum(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Inside a SyncBN step, `t` summed over the ranks (`global_sum`: the
    gradient flows through the other ranks' shares) or, with op "max", its
    elementwise max; `t` itself elsewhere."""
    if not sync_active():
        return t
    return global_sum(t) if op == "sum" else all_reduce(t, op=op)


def replicated_share() -> float:
    """The weight of a term that every rank computes whole from replicated
    tensors: 1/world inside a SyncBN step, so that the summed gradients
    count it once; 1 elsewhere."""
    return 1.0 / world() if sync_active() else 1.0


def shard_index() -> int:
    """This rank's shard of the global batch inside a data-parallel step;
    0 outside one (every rank then draws from element 0)."""
    return rank() if _STEP is not None else 0


def shard_batch(batch, rank: int, world: int):
    """This rank's rows of a host batch, as JAX's shard_batch places them:
    rows [rank·n/world, (rank + 1)·n/world) of every array's leading axis
    (n divisible by world); nested lists, tuples and dicts are walked,
    None kept."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, rank, world) for v in batch)
    n = batch.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks")
    k = n // world
    return batch[rank * k:(rank + 1) * k]


def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers into every rank's module, in place."""
    if initialized() and dist.get_world_size() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                broadcast_(t.data)
    return module


def pad_batch_to(batch_size: int, world_size: Optional[int] = None) -> int:
    """Round a global batch size up to a multiple of the world size."""
    n = world() if world_size is None else world_size
    return -(-batch_size // n) * n


def _all_reduce_flat(tensors: Sequence[torch.Tensor], mean: bool) -> list:
    """Each tensor's sum or mean over the ranks, through one flat buffer a
    dtype."""
    out: list = [None] * len(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = all_reduce(torch.cat([tensors[i].reshape(-1) for i in idx]), mean=mean)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view_as(tensors[i])
    return out


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mean: bool) -> None:
    """Sum (SyncBN: each rank's loss is its share of the global loss) or
    average (local BN: JAX's pmean) the gradients over the ranks. A
    parameter without a gradient enters as zeros and keeps none: every rank
    has the same ones without."""
    if not initialized():
        return
    params = [p for p in params if p.requires_grad]
    reduced = _all_reduce_flat([torch.zeros_like(p) if p.grad is None else p.grad
                                for p in params], mean)
    for p, g in zip(params, reduced):
        if p.grad is not None:
            p.grad.copy_(g)


def average_buffers(tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced by its mean over the ranks (local BN's running
    stats after the step)."""
    if not initialized():
        return
    with torch.no_grad():
        for t, m in zip(tensors, _all_reduce_flat(tensors, mean=True)):
            t.copy_(m)


def sum_step(params: Iterable[torch.nn.Parameter], metrics: dict) -> dict:
    """The end of a SyncBN step under a group, each rank's loss its share of
    the global one: the gradients summed over the ranks, and the metrics
    (tensors or numbers) summed as detached tensors of the loss's dtype.
    `metrics` as they are without a group."""
    if not initialized():
        return metrics
    all_reduce_grads(params, mean=False)
    ref = metrics["loss"]
    return reduce_metrics({k: torch.as_tensor(v, device=ref.device).detach().to(ref.dtype)
                           for k, v in metrics.items()}, mean=False)


def reduce_metrics(metrics: dict, mean: bool) -> dict:
    """Each scalar metric summed or averaged over the ranks, in one
    all_reduce."""
    if not initialized() or not metrics:
        return metrics
    keys = list(metrics)
    flat = all_reduce(torch.stack([metrics[k].reshape(()) for k in keys]), mean=mean)
    return dict(zip(keys, flat))
