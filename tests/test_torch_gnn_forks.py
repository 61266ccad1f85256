"""The graph nets' forks in the port (mds_tpu_torch/models/gnn.py) against
JAX's (mds_tpu/models/gnn.py) on the CPU at test size (nfeat 32, nfeat_out
16, 2 datasets of 3 and 4 classes, M = 5, aux prototype rows in front),
weights carried by deploy/weights.py `bgnn_state_dict_from_jax`.

Gates, f32:
- every name of JAX's `_NAME_KW` table, and `graph_attention_network` (the
  cosine BGNN under `from_configer`): the eval forward's prototypes,
  block, graphs and layer features rel ≤ 1e-5, the parameter gradients
  of a loss over prototypes and graphs rel ≤ 1e-4 (a GAT layer's
  attention gradient over its weight's, tests/torch_flagship_parity.py
  `attn_scale`: its exact value is zero where the LeakyReLU is linear);
- the alternating trainer's GNN step on each trainable fork (cosine, adj,
  adj_tg, adj3, sfg, BGAT, graph_attention_network) against JAX's own
  jitted `_gnn_step` on the same fixed features (tests/
  torch_flagship_parity.py `feature_trainers`): the loss rel ≤ 1e-4, and
  every parameter and AdamW moment after the step rel ≤ 1e-4 (the first
  moment is a tenth of the gradient);
- the repo's configs that name these forks build the port's trainer with
  JAX's graph-net options; the unlabel fork's trainer raises ValueError.
The MODELS names that are no BGNN: tests/test_torch_gnn_options.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    CATS, attn_scale, configers, feature_trainers, gnn_batch, gnn_state_errors, gnn_step_pair,
    jax_bgnn, one_torch_thread, port_bgnn, rel, tiny)
from mds_tpu_torch.data.node_features import gen_graph_node_features

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD, GRAD, STEP = 1e-5, 1e-4, 1e-4
NAMES = ["learnable_topology_BGNN", "learnable_topology_BGNN_adj",
         "learnable_topology_BGNN_adj_tg", "learnable_topology_BGNN_adj3",
         "learnable_topology_BGNN_sfg", "learnable_topology_BGNN_unlabel",
         "learnable_topology_BGAT", "graph_attention_network"]
OPTIONS = ("adj_mode", "gnn_type", "with_unlabel", "mse_or_adv", "eff_cats", "total_nodes",
           "max_num_unify_class", "nfeat", "nfeat_out", "output_feat_dim", "dropout_rate",
           "with_datasets_aux", "init_stage", "temperature")


def options(m):
    out = {k: getattr(m, k) for k in OPTIONS}
    out["eff_cats"] = tuple(out["eff_cats"])
    out["n_gcn_layers"] = len(m.gcn_layers) if hasattr(m, "gcn_layers") else m.n_gcn_layers
    return out


@pytest.mark.parametrize("name", NAMES)
def test_fork_forward_and_gradient_match_jax(name):
    cfg = tiny(GNN={"model_name": name})
    jg, params, nf = jax_bgnn(cfg)
    tm = port_bgnn(cfg, params).eval()
    assert options(tm) == options(jg)
    rows = jg.total_nodes + jg.max_num_unify_class
    w = np.random.default_rng(0).normal(0, 1, (rows, 16)).astype(np.float32)

    def jloss(p):
        out = jg.apply({"params": p}, jnp.asarray(nf), train=False)
        return jnp.sum(out["unify_prototype"] * w) + sum(
            jnp.sum(g ** 2) for g in out["bi_graphs"]), out

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    out = tm(torch.from_numpy(nf))
    assert tuple(out["unify_prototype"].shape) == (rows, 16)
    for key in ("unify_prototype", "adj_block"):
        assert rel(out[key].detach().numpy(), want[key]) <= FWD, key
    for got, exp in zip(out["bi_graphs"] + out["ret_feats"],
                        list(want["bi_graphs"]) + list(want["ret_feats"])):
        assert got.shape == exp.shape and rel(got.detach().numpy(), exp) <= FWD
    loss = (out["unify_prototype"] * torch.from_numpy(w)).sum() + sum(
        g.square().sum() for g in out["bi_graphs"])
    loss.backward()
    from mds_tpu_torch.deploy.weights import bgnn_state_dict_from_jax

    want_g = {k: v.numpy() for k, v in bgnn_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrad)).items()}
    assert set(want_g) == {k for k, _ in tm.named_parameters()}
    for k, p in tm.named_parameters():
        err = np.abs(p.grad.numpy().astype(np.float64) - want_g[k]).max()
        assert err <= GRAD * attn_scale(k, want_g), k


@pytest.mark.parametrize("name", [n for n in NAMES if not n.endswith("_unlabel")])
def test_trainer_gnn_step_matches_jax(name):
    """One GNN step of each trainable fork, in both packages from JAX's
    init, at max_rate 0.5 (both graph sets in the loss)."""
    cfg = tiny(GNN={"model_name": name})
    nf = gen_graph_node_features(configers(cfg)[1], nfeat=32)
    jt, tt = feature_trainers(cfg, nf)
    assert options(tt.gnn_model) == options(jt.gnn_model)
    feats, lbs = gnn_batch(np.random.default_rng(1))
    jm, tm = gnn_step_pair(jt, tt, feats, lbs, max_rate=0.5)
    assert set(jm) == set(tm)
    assert abs(tm["loss"] - jm["loss"]) <= STEP * abs(jm["loss"])
    errors, counts = gnn_state_errors(jt, tt)
    assert counts and not {k: e for k, e in errors.items() if not e <= STEP}


@pytest.mark.parametrize("config", ["ltbgnn_7_datasets_snp_train_tg.json",
                                    "gnn_city_cam_a2d2.json", "ltbgnn_3_datasets_gat.json",
                                    "ltbgnn_7_datasets_mseg.json", "clip_5_datasets.json"])
def test_configs_build_the_trainers_graph_net(config):
    """The port's alternating trainer builds each config's graph net as
    JAX's trainer does (LearnableTopologyBGNN.from_configer,
    mds_tpu/engine/gnn_trainer.py:75): train_tg's direct BGNN (it once
    fell to cosine), gnn_city_cam_a2d2's graph_attention_network as the
    cosine BGNN, the BGAT, mseg's cosine BGNN and clip's direct one; clip
    seeds its prototypes."""
    from mds_tpu.models.gnn import LearnableTopologyBGNN as JB
    from mds_tpu_torch.config import Configer
    from mds_tpu.config import Configer as JConfiger
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    path = os.path.join(ROOT, "configs", config)
    tc = Configer(config_file=path)
    # node features of Σ n_cats rows at the config's nfeat (the spec names
    # too few classes for clip_5 and mseg: test_node_feature_rows_must_match)
    nf = np.zeros((sum(tc.n_cats(i) for i in range(tc.n_datasets)),
                   int(tc.get("GNN", "nfeat"))), np.float32)
    nf[:, :int(tc.get("GNN", "output_feat_dim"))] = 1.0
    tt = AlternatingTrainer(tc, node_features=nf, device="cpu")
    want = options(JB.from_configer(JConfiger(config_file=path)))
    assert options(tt.gnn_model) == want
    assert tt.gnn_model.adj_mode == {"ltbgnn_3_datasets_gat.json": "cosine",
                                     "gnn_city_cam_a2d2.json": "cosine",
                                     "ltbgnn_7_datasets_mseg.json": "cosine"}.get(config, "direct")
    if config == "clip_5_datasets.json":
        assert tt.mode == "clip" and torch.equal(tt.seg_model.unify_prototype,
                                                 torch.ones_like(tt.seg_model.unify_prototype))


def test_node_feature_rows_must_match_the_classes():
    """configs/clip_5_datasets.json gives CamVid 12 classes where its spec
    names 11 (so do ltbgnn_5_datasets_snp*.json, and ltbgnn_7_datasets_mseg
    .json three of its datasets): the hashed node features lack rows, and
    JAX's trainer fails at its graph net's init with a shape error; the
    port's says what is missing."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    tc = Configer(config_file=os.path.join(ROOT, "configs", "clip_5_datasets.json"))
    with pytest.raises(ValueError, match="112 node-feature rows for 113"):
        AlternatingTrainer(tc, device="cpu")


def test_unlabel_fork_trainer_raises():
    """JAX's alternating trainer fails on the unlabel fork at its first GNN
    step (its graph block has n_cats + 1 rows a dataset, split by n_cats);
    the port's refuses it at construction. The model itself is held to
    JAX's by test_fork_forward_and_gradient_match_jax."""
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    _, tc = configers(tiny(GNN={"model_name": "learnable_topology_BGNN_unlabel"}))
    with pytest.raises(ValueError, match="unlabel"):
        AlternatingTrainer(tc, node_features=np.zeros((7, 32), np.float32), device="cpu")
