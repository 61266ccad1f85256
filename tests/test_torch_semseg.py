"""The port's SemsegModel, snp_rn18 (mds_tpu_torch/models/semseg.py), against
JAX's (mds_tpu/models/semseg.py) on the CPU at f32, on the tiny flagship
config of tests/torch_flagship_parity.py (64×64 and 72×72 inputs).

Gate: rel ≤ 1e-4 (max-diff over the reference's largest magnitude) for
every method's logits; labels equal; the graph and prototype injection
exact. The weights round trip both ways: JAX's variables load into the
port strictly (deploy/weights.py `semseg_state_dict_from_jax`), and the
port's state_dict goes through JAX's own importer
(mds_tpu/deploy/torch_import.py `semseg_from_torch`) to the same JAX
forward: the port's names are the reference torch layout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    CATS, configers, jax_semseg, nchw, nhwc, one_torch_thread, port_semseg, rel, tiny)
from mds_tpu_torch.deploy.weights import (
    detect_torch_layout,
    load_reference_weights,
    semseg_state_dict_from_jax,
)

F32 = 1e-4
METHODS = ("eval_logits", "uni_eval_logits", "clip_logits", "unseen_pred_logits")


@pytest.fixture(scope="module")
def model():
    cfg = tiny()
    jm, v = jax_semseg(cfg, seed=1)
    return cfg, jm, v, port_semseg(cfg, v).eval()


@pytest.fixture(scope="module")
def jax_outputs(model):
    """Every method of JAX's model on one 72×72 batch for each dataset,
    its pred, and its train dict on both datasets, in one jit."""
    cfg, jm, v, _ = model
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 72, 72, 3)).astype(np.float32)
    xs = [rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32),
          rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)]

    def run(v, x, xs):
        out = {f"{m}/{ds}": jm.apply(v, x, ds, method=getattr(jm, m))
               for m in METHODS for ds in range(2)}
        out["pred"] = jm.apply(v, x, 1, method=jm.pred)
        train, mut = jm.apply(v, xs, train=True, mutable=["batch_stats"])
        return out, train, mut

    vj = jax.tree_util.tree_map(jnp.asarray, v)
    out, train, mut = jax.jit(run)(vj, jnp.asarray(x), [jnp.asarray(a) for a in xs])
    return x, xs, out, train, mut


@pytest.mark.parametrize("method", METHODS)
def test_eval_methods_match_jax(model, jax_outputs, method):
    _, _, _, tm = model
    x, _, want, _, _ = jax_outputs
    for ds in range(2):
        with torch.no_grad():
            got = nhwc(getattr(tm, method)(nchw(x), ds))
        w = np.asarray(want[f"{method}/{ds}"])
        assert got.shape == w.shape == (2, 18, 18, w.shape[-1])
        assert rel(got, w) <= F32, (method, ds)


def test_pred_matches_jax(model, jax_outputs):
    """remap → ×4 bilinear (align_corners=True) → argmax at the input size."""
    _, _, _, tm = model
    x, _, want, _, _ = jax_outputs
    with torch.no_grad():
        got = tm.pred(nchw(x), 1).numpy()
    w = np.asarray(want["pred"])
    assert got.shape == w.shape == (2, 72, 72)
    assert (got == w).mean() > 0.999


def test_train_dict_and_stats_match_jax(model, jax_outputs):
    """The train call on both datasets: seg (unified logits), aux and feat,
    and the BN running stats it moves."""
    from mds_tpu_torch.deploy.weights import semseg_to_torch

    cfg, _, v, tm0 = model
    _, xs, _, train, mut = jax_outputs
    tm = port_semseg(cfg, v).train()
    out = tm([nchw(a) for a in xs])
    for key in ("seg", "aux", "feat"):
        for g, w in zip(out[key], train[key]):
            assert rel(nhwc(g), np.asarray(w)) <= F32, key
    want = semseg_to_torch(v["params"], jax.tree_util.tree_map(np.asarray, mut["batch_stats"]),
                           v["buffers"])
    sd = tm.state_dict()
    for k, w in want.items():
        if "running" in k:
            assert rel(sd[k].numpy(), w) <= F32, k


def test_graph_and_prototype_injection_match_jax(model):
    """set_bipartite_graphs with 2n graphs takes the even ones;
    set_unify_prototype with aux prototypes splits Σ n_cats + M rows."""
    from mds_tpu.models.semseg import set_bipartite_graphs, set_unify_prototype

    cfg, jm, v, tm0 = model
    tm = port_semseg(cfg, v)
    rng = np.random.default_rng(3)
    M = tm.max_num_unify_class
    graphs = [rng.random((c, M)).astype(np.float32) for c in CATS for _ in range(2)]
    want = set_bipartite_graphs({"buffers": v["buffers"]}, graphs)["buffers"]
    tm.set_bipartite_graphs(graphs)
    for i in range(2):
        np.testing.assert_array_equal(tm.bipartite_graphs[i].numpy(),
                                      np.asarray(want[f"bi_graph_{i}"]))
        np.testing.assert_array_equal(tm.bipartite_graphs[i].numpy(), graphs[2 * i])
    proto = rng.normal(0, 1, (sum(CATS) + M, 16)).astype(np.float32)
    want = set_unify_prototype({"params": v["params"]}, proto, datasets_cats=CATS,
                               with_datasets_aux=True)["params"]
    tm.set_unify_prototype(torch.from_numpy(proto))
    np.testing.assert_array_equal(tm.unify_prototype.detach().numpy(),
                                  np.asarray(want["unify_prototype"]))
    for i in range(2):
        np.testing.assert_array_equal(tm.aux_prototype[i].detach().numpy(),
                                      np.asarray(want[f"aux_prototype_{i}"]))


def test_weights_round_trip_both_ways(model, jax_outputs):
    """JAX → port: strict, every key; port → JAX through JAX's own
    semseg_from_torch gives JAX's forward; detect_torch_layout says
    'semseg'; load_reference_weights takes the port's own state_dict and
    one with num_batches_tracked dropped."""
    from mds_tpu.deploy.torch_import import semseg_from_torch

    cfg, jm, v, tm = model
    x, _, want, _, _ = jax_outputs
    sd = semseg_state_dict_from_jax(v["params"], v["batch_stats"], v["buffers"])
    assert set(sd) == {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    assert "backbone.layer2.0.downsample.1.running_var" in sd
    assert "backbone.upsample_blends.4.blend_conv.norm.weight" in sd
    assert "bipartite_graphs.1" in sd and "aux_prototype.0" in sd
    port_sd = {k: t.clone() for k, t in tm.state_dict().items()}
    assert detect_torch_layout(port_sd) == "semseg"
    params, stats, buffers = semseg_from_torch(port_sd)
    back = {"params": params, "batch_stats": stats, "buffers": buffers}
    got = jax.jit(lambda v, x: jm.apply(v, x, 0, method=jm.eval_logits))(
        jax.tree_util.tree_map(jnp.asarray, back), jnp.asarray(x))
    assert rel(np.asarray(got), np.asarray(want["eval_logits/0"])) <= 1e-6
    fresh = port_semseg(cfg, v)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    load_reference_weights(fresh, sd)
    assert all(torch.equal(fresh.state_dict()[k], t) for k, t in sd.items())


def test_snp_rn18_builds_from_the_config():
    """MODELS' configer= factory through the trainer's build_model, at the
    flagship config's widths: M = int(0.8 · 66) = 52 unified classes,
    512-d prototypes, 3 pyramid levels, remat on (network.efficient's
    default)."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.trainer import build_model

    cfg = Configer(config_file=os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "ltbgnn_3_datasets_snp.json"))
    m = build_model(cfg, torch.bfloat16)
    assert type(m).__name__ == "SemsegModel" and m.dtype == torch.bfloat16
    assert tuple(m.unify_prototype.shape) == (52, 512)
    assert [tuple(p.shape) for p in m.aux_prototype] == [(11, 512), (19, 512), (36, 512)]
    assert len(m.backbone.bn1) == 3 and m.backbone.remat
    assert m.backbone.conv1.out_channels == 64
    with pytest.raises(NotImplementedError, match="item 6b"):
        build_model(Configer(configs={"model_name": "snp_rn18_mulbn", "n_datasets": 1,
                                      "dataset1": {"n_cats": 3}}))
