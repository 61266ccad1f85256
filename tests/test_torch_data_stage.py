"""The loader's `stage` and `batch_multiplier`, the eval mode dsg, the
concatenated readers (data/multiset.py) and the target graphs
(ops/target_graph.py) of the port, against JAX's on the CPU.

- `stage=2` reads each dataset's `train_im_anns` with `_2.txt` in either
  mode; in eval mode with the eval transform: on tiny PNG frames and label
  maps this file writes from numpy (a train list, its stage-2 list and a
  val list a dataset, read by `AllDatasetsReader`), the port's eval batches
  equal JAX's bit for bit and come from the stage-2 files.
- `batch_multiplier` scales each dataset's `ims_per_gpu`.
- `run_evaluation(mode="dsg")` asks the loader for stage 2 and returns
  JAX's mIoU (within 2e-3, each batch's predictions agreeing on ≥ 99.9% of
  its pixels) on the same BiSeNetV2 weights (tests/torch_eval_parity.py).
- `MultiSetReader` / `AllDatasetsReader` give JAX's samples for every
  index; the trainId translation tables are JAX's.
- `target_graphs_from_remap` / `_from_pairs` give JAX's arrays exactly.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import mds_tpu.data.loader as jloader
import mds_tpu.data.multiset as jms  # noqa: F401 — fills JAX's DATASETS
import mds_tpu_torch.data.loader as tloader
from mds_tpu.config import Configer as JConfiger
from mds_tpu_torch.config import Configer
from torch_eval_parity import (  # noqa: F401 — one_torch_thread: autouse
    MIOU_GATE, N_CLASSES, PRED_GATE, WEIGHT_SEED, agreement, make_variables,
    one_torch_thread, port_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LISTS = ("train", "train_2", "val")


def _write_frames(root, n_cats, tag, seed, n=3, hw=(64, 64)):
    """n RGB frames and label maps of blocks (5% ignored) as PNGs; their
    `im,lb` ann list at root/{tag}.txt."""
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(n):
        lb = rng.integers(0, n_cats, (hw[0] // 8, hw[1] // 8))
        lb = np.repeat(np.repeat(lb, 8, 0), 8, 1)
        lb[rng.random(hw) < 0.05] = 255
        im = (rng.integers(0, 256, (256, 3))[lb] + rng.normal(0, 8, (*hw, 3))).clip(0, 255)
        Image.fromarray(im.astype(np.uint8)).save(os.path.join(root, f"{tag}_{k}.png"))
        Image.fromarray(lb.astype(np.uint8)).save(os.path.join(root, f"{tag}_{k}_lb.png"))
        lines.append(f"{tag}_{k}.png,{tag}_{k}_lb.png")
    path = os.path.join(root, f"{tag}.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.fixture(scope="module")
def file_config(tmp_path_factory):
    """configs/test_synthetic.json with each dataset read from written
    files: d{i}_train.txt, d{i}_train_2.txt, d{i}_val.txt."""
    root = str(tmp_path_factory.mktemp("frames"))
    with open(os.path.join(ROOT, "configs", "test_synthetic.json")) as f:
        cfg = json.load(f)
    for i, c in enumerate(N_CLASSES):
        for j, lst in enumerate(LISTS):
            _write_frames(root, c, f"d{i + 1}_{lst}", seed=10 * i + j)
        cfg[f"dataset{i + 1}"] = {
            "n_cats": c, "data_reader": "AllDatasetsReader", "im_root": root,
            "train_im_anns": os.path.join(root, f"d{i + 1}_train.txt"),
            "val_im_anns": os.path.join(root, f"d{i + 1}_val.txt"),
            "ims_per_gpu": 1, "reader_kwargs": {"n_cats": c}}
    cfg.setdefault("eval", {}).update({"eval_scales": [0.5, 1.0], "eval_crop": [32, 32]})
    cfg["train"]["native_pipeline"] = False
    return cfg


def _batches(loaders):
    return [[(b["im"].copy(), b["lb"].copy()) for b in ld] for ld in loaders]


@pytest.mark.parametrize("stage", [None, 2])
def test_eval_loader_stage_reads_the_stage_lists(file_config, stage):
    jl = jloader.get_data_loader(JConfiger(configs=copy.deepcopy(file_config)), "eval",
                                 stage=stage)
    tl = tloader.get_data_loader(Configer(configs=copy.deepcopy(file_config)), "eval",
                                 stage=stage)
    tag = "train_2" if stage == 2 else "val"
    for i, ld in enumerate(tl):
        assert [os.path.basename(p) for p in ld.dataset.img_paths] == [
            f"d{i + 1}_{tag}_{k}.png" for k in range(3)]
    for tb, jb in zip(_batches(tl), _batches(jl)):
        assert len(tb) == len(jb) == 3
        for (tim, tlb), (jim, jlb) in zip(tb, jb):
            np.testing.assert_array_equal(tim, jim)
            np.testing.assert_array_equal(tlb, jlb)


def test_train_loader_stage_and_batch_multiplier(file_config):
    cfg = Configer(configs=copy.deepcopy(file_config))
    loader = tloader.get_data_loader(cfg, "train", stage=2, batch_multiplier=3)
    try:
        assert loader.batch_sizes == [3, 3]
        assert all(os.path.basename(ds.img_paths[0]).startswith(f"d{i + 1}_train_2_")
                   for i, ds in enumerate(loader.datasets))
        b = next(loader)
        crop = tuple(file_config["train"]["cropsize"])
        assert [x.shape for x in b["ims"]] == [(3, *crop, 3)] * 2
    finally:
        loader.close()
    plain = tloader.get_data_loader(Configer(config_file=os.path.join(
        ROOT, "configs", "test_synthetic.json")), "train", batch_multiplier=2)
    try:
        assert plain.batch_sizes == [4, 2]
        assert [x.shape[0] for x in next(plain)["ims"]] == [4, 2]
    finally:
        plain.close()


def test_dsg_asks_for_stage_2_and_matches_jax(file_config, monkeypatch):
    """Both packages' run_evaluation in mode dsg on the same weights
    (their bundles replaced by the weights' models); the loader call each
    makes is recorded."""
    import jax.numpy as jnp

    import mds_tpu.evaluation.drivers as jd
    import mds_tpu.evaluation.evaluator as jev
    import mds_tpu_torch.evaluation.drivers as td
    import mds_tpu_torch.evaluation.evaluator as tev
    from mds_tpu.models import bisenetv2 as jb

    weights = make_variables(N_CLASSES, 2, WEIGHT_SEED)
    stages, jseen, tseen = [], [], []
    jm = jb.BiSeNetV2(n_classes=N_CLASSES, n_bn=2, aux=True, dtype=jnp.float32)
    monkeypatch.setattr(jd, "build_eval_bundle", lambda *a, **k: (
        jm, {"params": weights[0], "batch_stats": weights[1]}, {}))
    monkeypatch.setattr(td, "build_eval_bundle", lambda *a, **k: port_model(weights))
    for mod in (jloader, tloader):
        real = mod.get_data_loader

        def spy(*a, _real=real, **k):
            stages.append(k.get("stage"))
            return _real(*a, **k)

        monkeypatch.setattr(mod, "get_data_loader", spy)
    import jax

    real_j, real_t = jev.confusion_hist, tev.confusion_hist

    def jrec(label, pred, *a, **k):
        jax.debug.callback(lambda p: jseen.append(np.asarray(p)), pred)
        return real_j(label, pred, *a, **k)

    def trec(label, pred, *a, **k):
        tseen.append(pred.cpu().numpy())
        return real_t(label, pred, *a, **k)

    monkeypatch.setattr(jev, "confusion_hist", jrec)
    monkeypatch.setattr(tev, "confusion_hist", trec)
    want = jd.run_evaluation(JConfiger(configs=copy.deepcopy(file_config)), mode="dsg")
    got = td.run_evaluation(Configer(configs=copy.deepcopy(file_config)), mode="dsg",
                            device="cpu")
    assert stages == [2, 2]
    assert len(tseen) == len(jseen) == 6
    assert agreement([(p, None) for p in tseen], [(p, None) for p in jseen]) >= PRED_GATE
    assert np.allclose(got, want, rtol=0, atol=MIOU_GATE), (got, want)


def test_multiset_readers_match_jax(file_config):
    from mds_tpu.data.base import SyntheticDataset as JSyn
    from mds_tpu_torch.data.base import SyntheticDataset
    from mds_tpu_torch.data.multiset import (
        CITY_TO_CAMVID, AllDatasetsReader, MultiSetReader, build_translation_lut,
        translate_labels)
    from mds_tpu_torch.registry import DATASETS

    assert DATASETS["MultiSetReader"] is MultiSetReader
    assert DATASETS["AllDatasetsReader"] is AllDatasetsReader
    kws = [dict(n_cats=3, size=(16, 24), length=3, seed=0),
           dict(n_cats=5, size=(16, 24), length=4, seed=1)]
    jr = jms.MultiSetReader([JSyn(**k) for k in kws])
    tr = MultiSetReader([SyntheticDataset(**k) for k in kws])
    assert len(tr) == len(jr) == 7
    for idx in range(7):
        assert tr.reader_index(idx) == jr.reader_index(idx)
        t, j = tr[idx], jr[idx]
        assert t["dataset_id"] == j["dataset_id"]
        np.testing.assert_array_equal(t["im"], j["im"])
        np.testing.assert_array_equal(t["lb"], j["lb"])
    d = file_config["dataset1"]
    ta = AllDatasetsReader(d["im_root"], d["val_im_anns"], mode="eval", n_cats=5)
    ja = jms.AllDatasetsReader(d["im_root"], d["val_im_anns"], mode="eval", n_cats=5)
    assert len(ta) == len(ja) == 3 and ta.n_cats == ja.n_cats == 5
    for idx in range(3):
        for key in ("im", "lb"):
            np.testing.assert_array_equal(ta[idx][key], ja[idx][key])
    np.testing.assert_array_equal(CITY_TO_CAMVID, jms.CITY_TO_CAMVID)
    pairs = [(0, 3), (4, 1), (7, 7)]
    np.testing.assert_array_equal(build_translation_lut(pairs, 9),
                                  jms.build_translation_lut(pairs, 9))
    lb = np.random.default_rng(0).integers(0, 256, (5, 6)).astype(np.uint8)
    np.testing.assert_array_equal(translate_labels(lb, CITY_TO_CAMVID),
                                  jms.translate_labels(lb, jms.CITY_TO_CAMVID))


@pytest.mark.parametrize("M,constrain", [(None, True), (None, False), (30, True)])
def test_target_graphs_from_remap_match_jax(M, constrain):
    """configs/bisenetv2_contrast_3ds.json's class_remap maps (46 unified
    classes; M = 30 cuts the ids at or above it)."""
    from mds_tpu.ops.target_graph import target_graphs_from_remap as jt
    from mds_tpu_torch.ops.target_graph import target_graphs_from_remap, with_target_graphs

    path = os.path.join(ROOT, "configs", "bisenetv2_contrast_3ds.json")
    got = target_graphs_from_remap(Configer(config_file=path), M, constrain)
    want = jt(JConfiger(config_file=path), M, constrain)
    assert [g.shape for g in got] == [(19, M or 46), (11, M or 46), (36, M or 46)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert set(np.unique(np.concatenate([g.ravel() for g in got]))) <= {
        0.0, 1.0, 255.0}
    preds = with_target_graphs({"seg": [torch.zeros(1)]}, got)
    assert preds["seg"] is not None and len(preds["target_bi_graph"]) == 3
    for t, g in zip(preds["target_bi_graph"], got):
        assert t.dtype == torch.float32 and torch.equal(t, torch.from_numpy(g))


def test_target_graphs_from_pairs_match_jax():
    from mds_tpu.ops.target_graph import target_graphs_from_pairs as jt
    from mds_tpu_torch.ops.target_graph import target_graphs_from_pairs

    pairs = [[(0, 1), (2, 0), (2, 4)], [(1, 3)]]
    for g, w in zip(target_graphs_from_pairs((3, 2), 5, pairs), jt((3, 2), 5, pairs)):
        np.testing.assert_array_equal(g, w)
