"""The flagship's graph-layer options in the port against JAX's, on the CPU
at test size (tests/torch_flagship_parity.py's tiny config): the
adversarial GNN (mse_or_adv "adv"), the mse consistency term, Gumbel
graphs, KM matching, the balanced Sinkhorn solvers.

Each GNN step runs in both packages from the same state on the same fixed
seg features: JAX's own jitted `_gnn_step` (its seg net stood in for by
`FeatureSeg`) and the port's `gnn_update`. Gates, f32:
- the loss rel ≤ 1e-4; every parameter and AdamW moment after the step
  rel ≤ 1e-4 (after the first step from zero moments, mu is a tenth of the
  gradient: the discriminators' gradients are held there);
- adv: two steps at weight decay 1.0 and lr.optimD_lr 3 × the GNN's, the
  second from JAX's state after the first carried across by
  `gnn_optimizer_state_from_jax` (optax's multi_transform): the
  discriminators' group takes no weight decay and its own schedule, and a
  save/restore carries it;
- Gumbel: `gumbel_max_graphs` on JAX's noise rel ≤ 1e-5 at τ 10, 1 and
  0.05; the step at max_rate 0.5 (both graph sets in the loss) on JAX's
  noise; τ from GNN.gumbel_tau0;
- KM: the switch's graphs equal JAX's, the βs untouched;
- the balanced solvers: the log plans rel ≤ 1e-5, the matches equal;
- SelfAttentionGNN, LearnableTopologyGAT and the `graph_attention_network`
  MODELS name (which neither package's trainer calls): the eval forward
  rel ≤ 1e-5, the identity graphs of `pretrain` exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    CATS, configers, feature_trainers, gnn_batch, gnn_state_errors, gnn_step_pair,
    jax_gumbel_noise, one_torch_thread, rel, tiny)
from mds_tpu_torch.data.node_features import gen_graph_node_features

STEP = 1e-4


def pair(lr=None, **gnn):
    """JAX's feature trainer and the port's on the tiny config with GNN
    options `gnn` (and `lr` options)."""
    cfg = tiny(GNN=gnn, lr=lr or {})
    nf = gen_graph_node_features(configers(cfg)[1], nfeat=32)
    return feature_trainers(cfg, nf)


def check_step(jt, tt, jm, tm):
    assert set(jm) == set(tm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= STEP * max(abs(jm[k]), 1e-30), (k, tm[k], jm[k])
    errors, counts = gnn_state_errors(jt, tt)
    bad = {k: e for k, e in errors.items() if not e <= STEP}
    assert counts and not bad, bad


def test_adv_steps_match_jax(tmp_path):
    from mds_tpu_torch.deploy.weights import bgnn_state_dict_from_jax, gnn_optimizer_state_from_jax
    from mds_tpu_torch.engine.optim import load_optimizer_state, optimizer_state

    lr = {"gnn_lr_start": 1e-3, "optimD_lr": 3e-3, "weight_decay": 1.0, "seg_lr_start": 1e-3,
          "max_iter": 20, "warmup_iters": 2, "init_iter": 0}
    jt, tt = pair(mse_or_adv="adv", lr=lr)
    # the groups: the discriminators alone in the second, no decay, their schedule
    d_names = {n for n, _ in tt.gnn_model.named_parameters() if n.startswith("netD.")}
    assert len(d_names) == 4 * 4
    g, d = tt.gnn_opt.param_groups
    names = {id(p): n for n, p in tt.gnn_model.named_parameters()}
    assert {names[id(p)] for p in d["params"]} == d_names
    assert d["weight_decay"] == 0.0 and "weight_decay" not in g
    d_sched = jt._gnn_sched(jt.gnn_lr * jt.optimD_lr / jt.gnn_lr)
    assert [d["schedule"](t) for t in range(4)] == pytest.approx(
        [float(d_sched(t)) for t in range(4)], rel=1e-6)
    rng = np.random.default_rng(2)
    for step in range(2):
        jm, tm = gnn_step_pair(jt, tt, *gnn_batch(rng), max_rate=0.5)
        assert {"adv_loss", "loss"} <= set(tm) and tm["adv_loss"] > 0
        check_step(jt, tt, jm, tm)
        if step == 0:  # the second step starts from JAX's state, moments included
            p = jax.tree_util.tree_map(np.asarray, jt.gnn_state.params)
            tt.gnn_model.load_state_dict(bgnn_state_dict_from_jax(p), strict=True)
            st = gnn_optimizer_state_from_jax(jax.tree_util.tree_map(
                np.asarray, jt.gnn_state.opt_state))
            assert d_names <= set(st["state"]) and st["count"] == 1
            load_optimizer_state(tt.gnn_model, tt.gnn_opt, st)
    # the last discriminator scores no term: its moments stay zero
    st = optimizer_state(tt.gnn_model, tt.gnn_opt)["state"]
    assert not st["netD.3.hidden.weight"]["mu"].any() and st["netD.0.hidden.weight"]["mu"].any()
    # save and restore carry the discriminators and their moments
    tt.save(str(tmp_path / "ckpt"))
    fresh = type(tt)(tt.configer, node_features=tt.node_features.numpy(), device="cpu")
    fresh.restore(str(tmp_path / "ckpt"))
    a, b = optimizer_state(tt.gnn_model, tt.gnn_opt), optimizer_state(fresh.gnn_model,
                                                                       fresh.gnn_opt)
    assert a["count"] == b["count"] == 2
    for n in d_names:
        assert torch.equal(tt.gnn_model.state_dict()[n], fresh.gnn_model.state_dict()[n])
        assert all(torch.equal(a["state"][n][m], b["state"][n][m]) for m in ("mu", "nu"))


def test_mse_step_matches_jax():
    jt, tt = pair(mse_or_adv="mse")
    jm, tm = gnn_step_pair(jt, tt, *gnn_batch(np.random.default_rng(3)), max_rate=0.5)
    assert tm["adv_loss"] > 0
    check_step(jt, tt, jm, tm)


@pytest.mark.parametrize("tau", [10.0, 1.0, 0.05])
def test_gumbel_graphs_match_jax(tau):
    from mds_tpu.models.gnn import gumbel_max_graphs as jgumbel
    from mds_tpu_torch.models.gnn import gumbel_max_graphs, gumbel_noise

    block = np.random.default_rng(4).random((sum(CATS), 5)).astype(np.float32)
    step = 3
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), step), 7)
    want = jgumbel(jnp.asarray(block), CATS, tau, key)
    noise = [torch.from_numpy(z) for z in jax_gumbel_noise(step, CATS, 5)]
    got = gumbel_max_graphs(torch.from_numpy(block), CATS, tau, noise)
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel(g.numpy(), w) <= 1e-5
        np.testing.assert_allclose(g.sum(0).numpy(), 1.0, rtol=1e-5)
    # the port's own draws: from the generator, finite, reproducible
    a = gumbel_noise(CATS, 5, torch.Generator().manual_seed(0))
    b = gumbel_noise(CATS, 5, torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) and torch.isfinite(x).all() for x, y in zip(a, b))


def test_gumbel_step_matches_jax():
    jt, tt = pair(GumbelSoftmax=True, gumbel_tau0=5.0)
    assert tt.gumbel and tt.gumbel_tau0 == 5.0 == jt.gumbel_tau0
    jm, tm = gnn_step_pair(jt, tt, *gnn_batch(np.random.default_rng(5)), max_rate=0.5,
                           tau=2.0)
    check_step(jt, tt, jm, tm)


def test_km_switch_matches_jax():
    """A GNN step, then the GNN→SEG switch with KM graphs in both."""
    jt, tt = pair(use_km=True)
    gnn_step_pair(jt, tt, *gnn_batch(np.random.default_rng(6)))
    betas = [b.copy() for b in tt.betas]
    _, want = jt.optimal_matching()
    tt.switch_to_seg()
    for got, w, c in zip(tt.uot_bi, want, CATS):
        np.testing.assert_array_equal(got, np.asarray(w))
        assert got.shape == (c, 5) and (got.sum(0) == 1).all() and (got.sum(1) >= 1).all()
    for i, g in enumerate(tt.uot_bi):
        assert torch.equal(tt.seg_model.bipartite_graphs[i], torch.from_numpy(g))
    assert all(np.array_equal(a, b) for a, b in zip(tt.betas, betas))


def test_balanced_sinkhorn_matches_jax():
    from mds_tpu.ops import sinkhorn as js
    from mds_tpu_torch.ops import sinkhorn as ts

    rng = np.random.default_rng(7)
    scores = rng.normal(0, 2, (2, 5, 7)).astype(np.float32)
    mu = np.log(rng.dirichlet(np.ones(5), 2)).astype(np.float32)
    nu = np.log(rng.dirichlet(np.ones(7), 2)).astype(np.float32)
    want = js.log_sinkhorn_iterations(jnp.asarray(scores), jnp.asarray(mu), jnp.asarray(nu), 30)
    got = ts.log_sinkhorn_iterations(torch.from_numpy(scores), torch.from_numpy(mu),
                                     torch.from_numpy(nu), 30)
    assert rel(got.numpy(), want) <= 1e-5
    for iters in (1, 20):
        want = js.log_optimal_transport(jnp.asarray(scores), iters)
        got = ts.log_optimal_transport(torch.from_numpy(scores), iters)
        assert got.dtype == torch.float32 and rel(got.numpy(), want) <= 1e-5
    for thr in (0.0, 0.05, 0.2):
        want = js.solve_optimal_transport(jnp.asarray(scores), 20, thr)
        got = ts.solve_optimal_transport(torch.from_numpy(scores), 20, thr)
        for k in ("matches0", "matches1"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        for k in ("matching_scores0", "matching_scores1"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-7)


@pytest.mark.parametrize("name", ["self_attention_GNN", "learnable_topology_GAT",
                                  "graph_attention_network"])
def test_non_bgnn_forward_matches_jax(name):
    """The MODELS names that are not BGNNs: neither package's trainer calls
    them, so the eval forward is what is held."""
    import mds_tpu.models.gnn  # noqa: F401 — fills JAX's MODELS
    from mds_tpu.registry import MODELS as JMODELS
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.deploy.weights import bgnn_state_dict_from_jax

    # nheads 2 of nhid 8 (GAT: 16 wide, the residual taken); the
    # attention's masked-out logits at −1e9
    cfg = tiny(GNN={"model_name": name, "nheads": 2, "nhid": 8, "adj_feat_dim": 8,
                    "nfeat_adj": 8})
    jc, tc = configers(cfg)
    jm, tm = JMODELS[name](configer=jc), MODELS[name](configer=tc)
    nf = gen_graph_node_features(tc, nfeat=32)
    v = jax.jit(lambda k: jm.init(k, jnp.asarray(nf), train=False))(jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    tm.load_state_dict(bgnn_state_dict_from_jax(params), strict=True)
    tm.eval()
    modes = [False, True] if name != "learnable_topology_GAT" else [False]
    for pretrain in modes:
        kw = {"pretrain": True} if pretrain else {}
        want = jm.apply({"params": params}, jnp.asarray(nf), train=False, **kw)
        with torch.no_grad():
            got = tm(torch.from_numpy(nf), **kw)
        assert set(got) == set(want)
        assert rel(got["unify_prototype"].numpy(), want["unify_prototype"]) <= 1e-5
        for g, w in zip(got["bi_graphs"], want["bi_graphs"]):
            assert g.shape == w.shape
            if pretrain:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            else:
                assert rel(g.numpy(), w) <= 1e-5
        if "adj_block" in want:
            assert rel(got["adj_block"].numpy(), want["adj_block"]) <= 1e-5
