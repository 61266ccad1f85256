"""Multi-dataset batch loader with threaded prefetch — the port's own copy of
mds_tpu/data/loader.py (`TrainBatch` :26, `MultiDatasetTrainLoader` :41,
`EvalLoader` :157, `get_data_loader` :207). For the same config and seed
it yields the JAX package's batches bit for bit.

One producer thread assembles batches into a bounded queue; a thread pool
decodes and augments the samples. Each sample's augmentation generator is
seeded by a number the producer draws, and the sample index comes from the
dataset's `InfiniteStream` inside the pool task, as in the JAX package: with
one worker thread (`train.num_workers` 1) the batches are a function of the
seed alone; with more, two tasks may swap their indices.

A train batch holds per-dataset uint8 NHWC arrays: `ims` [(b_i, H, W, 3)]
and `lbs` [(b_i, H, W)], plus their concatenations `im`, `lb` and the
dataset id of each image.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from mds_tpu_torch.data.sampler import InfiniteStream

LOGGER = "mds_tpu_torch"


class TrainBatch(dict):
    """A dict with attribute access."""

    __getattr__ = dict.__getitem__


class MultiDatasetTrainLoader:
    """Yields multi-dataset batches forever.

    datasets: readers with `.read(idx, rng) -> dict(im, lb)`, all giving
    crops of one H×W; batch_sizes: each dataset's images per batch.
    """

    def __init__(self, datasets: Sequence, batch_sizes: Sequence[int],
                 rank: int = 0, world: int = 1, seed: int = 0,
                 num_threads: int = 8, prefetch: int = 4,
                 drop_all_ignore: bool = True, max_resample: int = 4):
        if len(datasets) != len(batch_sizes):
            raise ValueError(f"{len(datasets)} datasets, {len(batch_sizes)} batch sizes")
        self.datasets = list(datasets)
        self.batch_sizes = list(batch_sizes)
        self.n_datasets = len(datasets)
        self.streams = [
            InfiniteStream(len(ds), num_replicas=world, rank=rank, seed=seed + 97 * i)
            for i, ds in enumerate(self.datasets)]
        self.rng = np.random.default_rng(seed * 7919 + rank)
        self.pool = ThreadPoolExecutor(max_workers=num_threads)
        self.drop_all_ignore = drop_all_ignore
        self.max_resample = max_resample
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._producer = threading.Thread(target=self._produce, daemon=True)
        self._producer.start()

    def _one(self, ds_idx: int, seed: int) -> dict:
        """Decode and augment one sample in a pool thread, with a generator
        of its own (np.random.Generator is not thread-safe). A sample whose
        labels are all ignored is drawn again, up to `max_resample` times."""
        ds = self.datasets[ds_idx]
        child = np.random.default_rng(seed)
        for _ in range(self.max_resample):
            s = ds.read(next(self.streams[ds_idx]), child)
            if not self.drop_all_ignore or (s["lb"] != 255).any():
                return s
        return s

    def _assemble(self) -> TrainBatch:
        futs = []
        for i, bs in enumerate(self.batch_sizes):
            # drawn on the producer thread alone
            seeds = self.rng.integers(2 ** 63, size=bs)
            futs.append([self.pool.submit(self._one, i, int(s)) for s in seeds])
        samples = [[f.result() for f in fs] for fs in futs]
        ims = [np.stack([s["im"] for s in ss]) for ss in samples]
        lbs = [np.stack([s["lb"] for s in ss]) for ss in samples]
        ids = np.concatenate([np.full(bs, i, np.int32)
                              for i, bs in enumerate(self.batch_sizes)])
        return TrainBatch(ims=ims, lbs=lbs, im=np.concatenate(ims, axis=0),
                          lb=np.concatenate(lbs, axis=0), dataset_ids=ids)

    def _produce(self):
        try:
            while not self._stop.is_set():
                batch = self._assemble()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # handed to the consumer by __next__
            if not self._stop.is_set():
                self._error = e
                self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> TrainBatch:
        batch = self._q.get()
        if batch is None:
            raise RuntimeError("the train loader's producer failed") from self._error
        return batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # the producer finishes its batch in flight before the pool goes
        self._producer.join(timeout=10.0)
        self.pool.shutdown(wait=False, cancel_futures=True)


class EvalLoader:
    """Samples of this rank's shard (indices rank, rank + world, ...),
    stacked `batch_size` at a time, decoded a few batches ahead on a
    background thread."""

    def __init__(self, dataset, rank: int = 0, world: int = 1,
                 batch_size: int = 1, prefetch: int = 2):
        self.dataset = dataset
        self.indices = list(range(rank, len(dataset), world))
        self.batch_size = batch_size
        self.prefetch = max(int(prefetch), 1)

    def __len__(self):
        return len(self.indices)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        failed: List[BaseException] = []

        def produce():
            try:
                rng = np.random.default_rng(0)
                batch: List[dict] = []
                for idx in self.indices:
                    batch.append(self.dataset.read(idx, rng))
                    if len(batch) == self.batch_size:
                        q.put(self._stack(batch))
                        batch = []
                if batch:
                    q.put(self._stack(batch))
            except BaseException as e:  # re-raised by the consumer below
                failed.append(e)
            q.put(None)

        # daemon: an abandoned iterator leaves the producer parked on the
        # bounded put with at most `prefetch` batches in memory
        threading.Thread(target=produce, daemon=True).start()
        while True:
            b = q.get()
            if b is None:
                if failed:
                    raise RuntimeError("the eval loader's reader failed") from failed[0]
                return
            yield b

    @staticmethod
    def _stack(batch: List[dict]) -> TrainBatch:
        return TrainBatch(im=np.stack([s["im"] for s in batch]),
                          lb=np.stack([s["lb"] for s in batch]),
                          dataset_ids=np.zeros(len(batch), np.int32))


def get_data_loader(configer, mode: str = "train", rank: int = 0, world: int = 1,
                    stage=None, batch_multiplier: int = 1):
    """From the config: one MultiDatasetTrainLoader over every dataset for
    mode 'train', a list of per-dataset EvalLoaders otherwise. The train
    loader's `pipeline` says whether the native augment or numpy runs, and
    the choice is logged. JAX's `stage` (the curriculum ann lists) and
    `batch_multiplier` (a batch per local device) wait: ROADMAP queue 1,
    item 6b."""
    if stage is not None or batch_multiplier != 1:
        raise NotImplementedError(
            "the loader's stage and batch_multiplier: ROADMAP queue 1, item 6b "
            "(the flagship's waiting features)")
    import mds_tpu_torch.data.base  # noqa: F401 — fills DATASETS
    from mds_tpu_torch.data import native
    from mds_tpu_torch.data.fast_transforms import NativeTransformationTrain
    from mds_tpu_torch.data.transforms import TransformationTrain, TransformationVal
    from mds_tpu_torch.registry import DATASETS

    scales = configer.get("train", "scales", default=[0.5, 1.0])
    cropsize = configer.get("train", "cropsize", default=[512, 512])
    min_side = configer.get("train", "min_side", default=1080)
    use_native = mode == "train" and bool(
        configer.get("train", "native_pipeline", default=True))
    datasets, batch_sizes = [], []
    for i in range(configer.n_datasets):
        dcfg = configer.dataset_cfg(i)
        reader_cls = DATASETS[dcfg["data_reader"]]
        ann = dcfg.get("train_im_anns" if mode == "train" else "val_im_anns")
        if mode != "train":
            trans = TransformationVal()
        elif use_native:
            trans = NativeTransformationTrain(scales, cropsize, min_side=min_side)
        else:
            trans = TransformationTrain(scales, cropsize, min_side=min_side)
        ds = reader_cls(dcfg.get("im_root"), ann, trans_func=trans, mode=mode,
                        **dict(dcfg.get("reader_kwargs", {})))
        if use_native and hasattr(ds, "lb_map"):
            trans.set_label_lut(ds.lb_map)
        datasets.append(ds)
        batch_sizes.append(int(dcfg.get("ims_per_gpu", 1)))
    if mode != "train":
        return [EvalLoader(ds, rank=rank, world=world) for ds in datasets]
    num_threads = int(configer.get("train", "num_workers", default=8))
    loader = MultiDatasetTrainLoader(
        datasets, batch_sizes, rank=rank, world=world,
        seed=int(configer.get("seed", default=0) or 0), num_threads=num_threads)
    loader.pipeline = "native" if use_native and native.available() else "numpy"
    why = f" (native library: {native.build_error})" if use_native and native.build_error else ""
    logging.getLogger(LOGGER).info(
        "train loader: %s augment pipeline%s, %d worker threads, batch sizes %s",
        loader.pipeline, why, num_threads, batch_sizes)
    return loader
