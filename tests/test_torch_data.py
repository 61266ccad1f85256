"""The port's data layer against the JAX package's, bit for bit (both run the
same numpy, PIL and native code on the same seeds, so nothing but equality
is acceptable):

- `get_data_loader` on configs/test_synthetic.json: the first 4 train
  batches (per-dataset images and labels, the concatenations, the dataset
  ids) on the numpy pipeline and on the native one (skipped only where
  g++ or make is missing: both packages build cpp/mdspre.cpp);
- the same on a Cityscapes-layout ann-file dataset of JPEG frames and
  label-id PNGs written here (decode, the id→trainId table, fused in the
  native pass or applied by the reader);
- `EvalLoader` shards and batches; the sampler streams
  (`RepeatedDistSampler`, with and without `ba`, and `InfiniteStream`).

One worker thread (`train.num_workers 1`): with more, two pool tasks may
swap their stream indices in either package.
"""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from mds_tpu.config import Configer as JConfiger
from mds_tpu.data import sampler as jsampler
from mds_tpu.data.base import SyntheticDataset as JSynthetic
from mds_tpu.data.loader import EvalLoader as JEvalLoader
from mds_tpu.data.loader import get_data_loader as j_get_data_loader
from mds_tpu_torch.config import Configer
from mds_tpu_torch.data import sampler
from mds_tpu_torch.data.base import SyntheticDataset
from mds_tpu_torch.data.loader import EvalLoader, MultiDatasetTrainLoader, get_data_loader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "test_synthetic.json")
PIPELINES = ["numpy", "native"]


def _need(pipeline):
    if pipeline == "native" and not (shutil.which("g++") and shutil.which("make")):
        pytest.skip("the native pipeline needs g++ and make")
    return ["train.native_pipeline", str(pipeline == "native"), "train.num_workers", "1"]


def _batches(get, configer, n=4):
    loader = get(configer, "train")
    try:
        return loader, [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _assert_equal_batches(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in ("ims", "lbs"):
            assert len(g[key]) == len(w[key])
            for a, b in zip(g[key], w[key]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
        for key in ("im", "lb", "dataset_ids"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_train_batches_match_jax(pipeline):
    ov = _need(pipeline)
    loader, got = _batches(get_data_loader, Configer(config_file=CFG, args_parser=ov))
    _, want = _batches(j_get_data_loader, JConfiger(config_file=CFG, args_parser=ov))
    assert loader.pipeline == pipeline
    assert [a.shape for a in got[0]["ims"]] == [(2, 32, 32, 3), (1, 32, 32, 3)]
    _assert_equal_batches(got, want)
    # the batches move: four draws are not one sample repeated
    assert not np.array_equal(got[0]["im"], got[1]["im"])


def _ann_dataset(tmp_path, n=3):
    """Cityscapes-layout files: JPEG frames, label-id PNGs (ids 0-33)."""
    rng = np.random.default_rng(0)
    lines = []
    for i in range(n):
        im = rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
        lb = np.repeat(np.repeat(rng.integers(0, 34, (5, 7)), 8, 0), 8, 1).astype(np.uint8)
        Image.fromarray(im).save(tmp_path / f"im{i}.jpg", quality=90)
        Image.fromarray(lb).save(tmp_path / f"lb{i}.png")
        lines.append(f"im{i}.jpg,lb{i}.png")
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    return {"model_name": "bisenetv2", "n_datasets": 1, "seed": 3,
            "dataset1": {"n_cats": 19, "data_reader": "CityScapes", "spec": "cityscapes",
                         "im_root": str(tmp_path), "ims_per_gpu": 2,
                         "train_im_anns": str(tmp_path / "train.txt"),
                         "val_im_anns": str(tmp_path / "train.txt")},
            "train": {"scales": [0.75, 1.5], "cropsize": [32, 48], "min_side": None}}


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_ann_file_reader_matches_jax(pipeline, tmp_path):
    cfg = _ann_dataset(tmp_path)
    ov = _need(pipeline)
    _, got = _batches(get_data_loader, Configer(configs=cfg, args_parser=ov), n=3)
    _, want = _batches(j_get_data_loader, JConfiger(configs=cfg, args_parser=ov), n=3)
    _assert_equal_batches(got, want)
    labels = np.unique(np.concatenate([b["lb"].ravel() for b in got]))
    assert ((labels < 19) | (labels == 255)).all() and (labels < 19).any()
    # eval mode reads the val list whole, through the identity transform
    (ev,), (jev,) = get_data_loader(Configer(configs=cfg), "eval"), \
        j_get_data_loader(JConfiger(configs=cfg), "eval")
    for a, b in zip(ev, jev):
        assert a["im"].shape == (1, 40, 56, 3)
        np.testing.assert_array_equal(a["im"], b["im"])
        np.testing.assert_array_equal(a["lb"], b["lb"])


@pytest.mark.parametrize("world, batch_size", [(1, 1), (2, 2), (3, 2)])
def test_eval_loader_shards_match_jax(world, batch_size):
    kw = dict(n_cats=8, size=(16, 24), length=10)
    for rank in range(world):
        got = list(EvalLoader(SyntheticDataset(**kw), rank, world, batch_size))
        want = list(JEvalLoader(JSynthetic(**kw), rank, world, batch_size))
        assert len(got) == len(want) == -(-len(range(rank, 10, world)) // batch_size)
        for a, b in zip(got, want):
            for key in ("im", "lb", "dataset_ids"):
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("args", [
    dict(dataset_len=10, num_imgs=25), dict(dataset_len=7, num_imgs=30, num_replicas=3, rank=2),
    dict(dataset_len=5, num_imgs=12, num_replicas=2, rank=1, ba=True),
    dict(dataset_len=6, num_imgs=6, shuffle=False)])
def test_sampler_streams_match_jax(args):
    got = sampler.RepeatedDistSampler(**args)
    want = jsampler.RepeatedDistSampler(**args)
    assert list(got) == list(want) and len(got) == len(want)
    kw = {k: args[k] for k in ("num_replicas", "rank", "shuffle") if k in args}
    for seed in (0, 97):
        a = sampler.InfiniteStream(args["dataset_len"], seed=seed, **kw)
        b = jsampler.InfiniteStream(args["dataset_len"], seed=seed, **kw)
        assert [next(a) for _ in range(40)] == [next(b) for _ in range(40)]


def test_train_loader_raises_a_reader_failure():
    """A reader that fails surfaces in the consumer's next() instead of
    leaving it waiting on an empty queue."""
    class Broken(SyntheticDataset):
        def read(self, idx, rng=None):
            raise OSError("unreadable sample")

    loader = MultiDatasetTrainLoader([Broken(length=4)], [2], num_threads=1)
    try:
        with pytest.raises(RuntimeError, match="producer failed") as err:
            next(loader)
        assert isinstance(err.value.__cause__, OSError)
    finally:
        loader.close()
