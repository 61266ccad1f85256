"""Data parallelism over processes and spatially tiled inference — the
counterpart of mds_tpu/parallel/."""

from mds_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_grads,
    data_parallel,
    global_sum,
    local_device,
    maybe_initialize_distributed,
    pad_batch_to,
    rank,
    replicate,
    shard_batch,
    world,
)
