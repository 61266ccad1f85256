"""The label-usage audit (mds_tpu_torch/evaluation/drivers.py
`_unified_hist`, `_slot_buckets`, `find_unuse_label`,
`eval_find_use_and_unuse_label`, `find_label_relation`) against JAX's
(mds_tpu/evaluation/drivers.py:169-297) on the CPU, and its two tools,
tools/find_unuse_torch.py and tools/print_bigraph_torch.py.

The tiny flagship of tests/torch_flagship_parity.py in f32 with the same
weights in both packages (JAX's init, BN and graphs randomized from seed
1), two batches of two 64×64 frames a dataset from numpy seed 0. The
(n_cats, M) histograms must equal JAX's exactly: the two packages' f32
logits differ by about 1e-6 relative, so a pixel whose two best unified
logits lie that close could take either slot; at this seed no pixel does
(the test checks the top two logits' gap against the packages'
difference). The buckets, the used slots, the use/unuse targets and the
label-relation matrices must be equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.evaluation.drivers as jd
import mds_tpu_torch.evaluation.drivers as td
from torch_flagship_parity import (  # noqa: F401
    CATS, configers, jax_semseg, nchw, one_torch_thread, port_semseg, tiny)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["backbone.layers", "[1, 1, 1, 1]", "backbone.planes", "[64, 16, 24, 32]",
         "backbone.num_features", "16"]


@pytest.fixture(scope="module")
def setup():
    cfg = tiny()
    jm, v = jax_semseg(cfg, seed=1)
    tm = port_semseg(cfg, v).eval()
    rng = np.random.default_rng(0)
    loaders = []
    for c in CATS:
        batches = []
        for _ in range(2):
            lb = rng.integers(0, c, (2, 8, 8))
            lb = np.repeat(np.repeat(lb, 8, 1), 8, 2)
            lb[rng.random(lb.shape) < 0.05] = 255
            batches.append({"im": rng.integers(0, 256, (2, 64, 64, 3)).astype(np.uint8),
                            "lb": lb.astype(np.uint8)})
        loaders.append(batches)
    jcfg, tcfg = configers(cfg)
    stats = [(rng.uniform(0.3, 0.6, 3).astype(np.float32),
              rng.uniform(0.2, 0.3, 3).astype(np.float32)) for _ in CATS]
    return jcfg, tcfg, jm, jax.tree_util.tree_map(jnp.asarray, v), tm, loaders, stats


def test_no_near_ties_at_this_seed(setup):
    """The gap between each pixel's two best unified logits exceeds 100×
    the largest difference of the two packages' logits."""
    jcfg, tcfg, jm, v, tm, loaders, stats = setup
    for i, loader in enumerate(loaders):
        mean, std = stats[i]
        for b in loader:
            x = (b["im"].astype(np.float32) / 255.0 - mean) / std
            want = np.asarray(jax.jit(lambda v, x: jm.apply(
                v, x, dataset=i, method=jm.uni_eval_logits))(v, jnp.asarray(x)))
            with torch.no_grad():
                got = tm.uni_eval_logits(nchw(x), i).permute(0, 2, 3, 1).numpy()
            top2 = np.sort(want, axis=-1)[..., -2:]
            assert (top2[..., 1] - top2[..., 0]).min() > 100 * np.abs(got - want).max()


@pytest.mark.parametrize("ds", [0, 1])
def test_unified_hist_and_used_slots_match_jax(setup, ds):
    jcfg, tcfg, jm, v, tm, loaders, stats = setup
    M = tm.max_num_unify_class
    mean, std = stats[ds]
    want = jd._unified_hist(jm, v, loaders[ds], CATS[ds], M, ds, mean, std)
    got = td._unified_hist(tm, loaders[ds], CATS[ds], M, ds, mean, std)
    assert got.shape == (CATS[ds], M) and got.dtype == np.int64
    assert got.sum() == sum(int((b["lb"] != 255).sum()) for b in loaders[ds])
    np.testing.assert_array_equal(got, want)
    graph = np.asarray(v["buffers"][f"bi_graph_{ds}"])
    assert td._slot_buckets(graph) == jd._slot_buckets(graph)
    used = td.find_unuse_label(tcfg, tm, loaders[ds], CATS[ds], ds, mean=mean, std=std)
    assert used == jd.find_unuse_label(jcfg, jm, v, loaders[ds], CATS[ds], ds,
                                       mean=mean, std=std)
    assert any(used.values())


def test_use_and_unuse_targets_match_jax(setup):
    jcfg, tcfg, jm, v, tm, loaders, stats = setup
    means, stds = [s[0] for s in stats], [s[1] for s in stats]
    _, _, want = jd.eval_find_use_and_unuse_label(jcfg, jm, v, loaders, means, stds)
    heads, mious, got = td.eval_find_use_and_unuse_label(tcfg, tm, loaders, means, stds)
    assert heads == ["single_scale"] and mious == []
    for g, w, c in zip(got, want, CATS):
        assert g.shape == (c, tm.max_num_unify_class)
        np.testing.assert_array_equal(g, w)
    vals = set(np.unique(np.concatenate([g.ravel() for g in got])))
    assert vals <= {0.0, 1.0, 255.0} and 0.0 in vals


def test_find_label_relation_matches_jax():
    jcfg, tcfg = configers(tiny(n_datasets=3, dataset3={"n_cats": 2}))
    rng = np.random.default_rng(4)
    cats = (3, 4, 2)
    remaps = [[rng.integers(0, cats[j], cats[i]).tolist() for j in range(3)]
              for i in range(3)]
    got = td.find_label_relation(tcfg, remaps)
    want = jd.find_label_relation(jcfg, remaps)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == bool
        np.testing.assert_array_equal(g, w)


def test_audit_tools_run_on_the_cpu(tmp_path, capsys):
    """Both tools on configs/test_synthetic_gnn.json at small widths: a
    checkpoint the alternating trainer wrote, the audit's JSON and its
    .npz; the graphs printed after restore are the trainer's
    `optimal_matching` of the restored graph net."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import find_unuse_torch
    import print_bigraph_torch
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    cfg_path = os.path.join(ROOT, "configs", "test_synthetic_gnn.json")
    from mds_tpu_torch.config import Configer

    tr = AlternatingTrainer(Configer(config_file=cfg_path, args_parser=SMALL), device="cpu")
    ckpt = str(tmp_path / "ckpt_gnn")
    tr.save(ckpt)
    out = str(tmp_path / "bipart.npz")
    used, bipart, seconds = find_unuse_torch.main(
        ["--config", cfg_path, "--ckpt", ckpt, "--device", "cpu", "--out", out, *SMALL])
    text = capsys.readouterr().out
    assert "dataset1 used slots per class:" in text and "audit_seconds" in text
    assert [len(u) for u in used] == [3, 4] and seconds["find_unuse_s"] > 0
    saved = np.load(out)
    for i, c in enumerate((3, 4)):
        t = saved[f"target_bipart_{i}"]
        assert t.shape == (c, 7) and set(np.unique(t)) <= {0.0, 1.0, 255.0}
    graphs = print_bigraph_torch.main(["--config", cfg_path, "--ckpt", ckpt,
                                       "--device", "cpu", *SMALL])
    assert "== dataset 1 (4 classes → 7 unified) ==" in capsys.readouterr().out
    tr2 = AlternatingTrainer(Configer(config_file=cfg_path, args_parser=SMALL), device="cpu")
    tr2.restore(ckpt)
    for g, w in zip(graphs, tr2.optimal_matching()[1]):
        np.testing.assert_array_equal(g, w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            find_unuse_torch.main(["--config", cfg_path, *SMALL])
