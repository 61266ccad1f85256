"""The port's BGNN and matching (mds_tpu_torch/models/gnn.py, ops/sinkhorn.py,
ops/uot_match.py, data/node_features.py) against JAX's on the CPU.

Gates: the BGNN's forward (eval, no dropout) and its parameter gradients
rel ≤ 1e-5 at f32; max_mask_graphs, normalize_adj, gumbel_softmax_decay
and the identity graphs exact; the unbalanced Sinkhorn plan rtol 1e-4
against JAX's f32 solve; the UOT and KM graphs equal and the βs rel 1e-5
on blocks with clear column maxima; the hashed node features bit for bit;
every MODELS name of the graph nets builds JAX's class and options and
holds JAX's parameters. The forks' forward and gradients against JAX's:
tests/test_torch_gnn_forks.py.
The dropout masks cannot equal flax's: its keep rate, 1/(1 − p) scale and
reproducibility from a seeded generator are checked on their own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    CATS, configers, jax_bgnn, one_torch_thread, port_bgnn, rel, tiny)
from mds_tpu_torch.models import gnn as tg
from mds_tpu_torch.ops import uot_match as tu
from mds_tpu_torch.ops.sinkhorn import sinkhorn_knopp_unbalanced

F32 = 1e-5


@pytest.mark.parametrize("gnn_type", ["GSAGE", "GCN"])
def test_bgnn_forward_and_gradient_match_jax(gnn_type):
    cfg = tiny(GNN={"GNN_type": gnn_type})
    jg, params, nf = jax_bgnn(cfg)
    tm = port_bgnn(cfg, params).eval()
    w = np.random.default_rng(0).normal(0, 1, (sum(CATS) + 5, 16)).astype(np.float32)

    def jloss(p):
        out = jg.apply({"params": p}, jnp.asarray(nf), train=False)
        return jnp.sum(out["unify_prototype"] * w) + sum(
            jnp.sum(g ** 2) for g in out["bi_graphs"]), out

    (_, want), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    out = tm(torch.from_numpy(nf))
    assert tuple(out["unify_prototype"].shape) == (sum(CATS) + 5, 16)  # aux rows in front
    assert rel(out["unify_prototype"].detach().numpy(), want["unify_prototype"]) <= F32
    assert rel(out["adj_block"].detach().numpy(), want["adj_block"]) <= F32
    for g, wg in zip(out["bi_graphs"], want["bi_graphs"]):
        assert g.shape == wg.shape and rel(g.detach().numpy(), wg) <= F32
    for f, wf in zip(out["ret_feats"], want["ret_feats"]):
        assert rel(f.detach().numpy(), wf) <= F32
    for (real, fake), (wr, wf) in zip(out["adv_pairs"], want["adv_pairs"]):
        assert not real.requires_grad
        assert rel(fake.detach().numpy(), wf) <= F32
    loss = (out["unify_prototype"] * torch.from_numpy(w)).sum() + sum(
        g.square().sum() for g in out["bi_graphs"])
    loss.backward()
    from mds_tpu_torch.deploy.weights import bgnn_state_dict_from_jax

    want_g = bgnn_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrad))
    for name, p in tm.named_parameters():
        assert rel(p.grad.numpy(), want_g[name].numpy()) <= 1e-4, name
    # infer_prototypes: the eval forward's prototype rows and block
    proto, block = tm.infer_prototypes(torch.from_numpy(nf))
    assert torch.equal(proto, out["unify_prototype"]) and torch.equal(block, out["adj_block"])


def test_graph_helpers_match_jax():
    from mds_tpu.models import gnn as jgnn

    rng = np.random.default_rng(1)
    block = rng.random((7, 5)).astype(np.float32)
    block[1, 2] = block[0, 2]  # a tie keeps both rows
    want = jgnn.max_mask_graphs(jnp.asarray(block), CATS)
    got = tg.max_mask_graphs(torch.from_numpy(block), CATS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    adj = rng.random((6, 6)).astype(np.float32)
    adj[3] = 0.0  # a zero row stays zero
    np.testing.assert_allclose(tg.normalize_adj(torch.from_numpy(adj)).numpy(),
                               np.asarray(jgnn.normalize_adj(jnp.asarray(adj))),
                               rtol=1e-6, atol=0)
    for it in (0, 1, 1000, 10 ** 6):
        assert tg.gumbel_softmax_decay(it) == jgnn.gumbel_softmax_decay(it)
    from mds_tpu.ops.uot_match import pretrain_bipartite_graphs as jpre

    for cats, M in ((CATS, 5), ((11, 19, 36), 52), ((2, 2), 4)):
        for g, w in zip(tu.pretrain_bipartite_graphs(cats, M), jpre(cats, M)):
            np.testing.assert_array_equal(g, w)


def test_sinkhorn_matches_jax_f32():
    """The plan of a softmax block's cost (at most ~0.5, so K ≥ e⁻⁵⁰ and
    the 1e-38 floor is never reached) and of a random cost."""
    from mds_tpu.ops.sinkhorn import sinkhorn_knopp_unbalanced as jsk

    rng = np.random.default_rng(2)
    for M, n in ((5, 3), (52, 36), (20, 11)):
        aff = np.exp(rng.normal(0, 2, (n, M)))
        aff = (aff / aff.sum(0)).astype(np.float64)
        cost = ((-aff + 1.0 + 1e-8) / 2.0).T
        alpha, beta = np.full(M, 1.0 / M), rng.dirichlet(np.ones(n))
        want = np.asarray(jsk(alpha, beta, cost, 0.01, 5.0))
        got = sinkhorn_knopp_unbalanced(alpha, beta, cost, 0.01, 5.0)
        assert got.dtype == np.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
        assert (np.exp(-cost.max() / 0.01)) > 1e-30


def test_uot_graphs_and_betas_match_jax():
    """Blocks whose columns have clear maxima (a softmax at τ = 0.07 of
    separated affinities): the same 0/1 graphs, each column one row and
    each row a column, and the βs within 1e-5, over two switches."""
    from mds_tpu.ops.uot_match import sep_bipartite_graphs_by_uot as juot

    rng = np.random.default_rng(3)
    cats, M = (3, 4, 6), 10
    logits = rng.normal(0, 1, (sum(cats), M))
    for c0, c in zip(np.cumsum((0,) + cats[:-1]), cats):  # every row a clear column
        for j in range(c):
            logits[c0 + j, (c0 + j) % M] += 4.0
    blocks = []
    cur = 0
    for c in cats:
        z = np.exp(logits[cur:cur + c] / 0.7)
        blocks.append(z / z.sum(0))
        cur += c
    adj = np.concatenate(blocks).astype(np.float32)
    betas_j = betas_t = [np.full(c, 1.0 / c) for c in cats]
    for _ in range(2):
        want, betas_j = juot(adj, cats, betas_j, uot_ratio=1.0)
        got, betas_t = tu.sep_bipartite_graphs_by_uot(adj, cats, betas_t, uot_ratio=1.0)
        for g, w, c in zip(got, want, cats):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert g.shape == (c, M) and (g.sum(0) == 1).all() and (g.sum(1) >= 1).all()
        for b, w in zip(betas_t, betas_j):
            np.testing.assert_allclose(b, w, rtol=1e-5, atol=0)
    # KM on the same block: JAX's graphs exactly, every class its column
    from mds_tpu.ops.uot_match import sep_bipartite_graphs_by_km as jkm

    for g, w, c in zip(tu.sep_bipartite_graphs_by_km(adj, cats), jkm(adj, cats), cats):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.shape == (c, M) and (g.sum(0) == 1).all() and (g.sum(1) >= 1).all()


def test_hashed_node_features_bit_equal(monkeypatch):
    """The sha256-seeded fallback, by the specs' class names and by
    dataset{i}_class{j}; a .npy cache file is read as it is."""
    from mds_tpu.data import node_features as jnf
    from mds_tpu_torch.data.node_features import gen_graph_node_features

    monkeypatch.setattr(jnf, "_clip_text_features", lambda *a, **kw: None)
    cfg = tiny()
    for spec in (None, ("camvid", "cityscapes")):
        if spec:
            cfg["dataset1"]["spec"], cfg["dataset2"]["spec"] = spec
            cfg["dataset1"]["n_cats"], cfg["dataset2"]["n_cats"] = 11, 19
        jc, tc = configers(cfg)
        want = jnf.gen_graph_node_features(jc, nfeat=48)
        got = gen_graph_node_features(tc, nfeat=48)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_node_features_cache_file(tmp_path):
    from mds_tpu_torch.data.node_features import gen_graph_node_features

    a = np.random.default_rng(4).normal(0, 1, (7, 32)).astype(np.float32)
    np.save(tmp_path / "nf.npy", a)
    torch.save(torch.from_numpy(a), tmp_path / "nf.pt")
    for name in ("nf.npy", "nf.pt"):
        _, tc = configers(tiny(GNN={"node_features_path": str(tmp_path / name)}))
        np.testing.assert_array_equal(gen_graph_node_features(tc, nfeat=32), a)


def test_dropout_rate_scale_and_seed():
    t = torch.ones(400, 500)
    a = tg.dropout(t, 0.5, torch.Generator().manual_seed(3))
    b = tg.dropout(t, 0.5, torch.Generator().manual_seed(3))
    c = tg.dropout(t, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs((a != 0).float().mean().item() - 0.5) < 0.005
    d = tg.dropout(t, 0.1, torch.Generator().manual_seed(3))
    assert abs((d != 0).float().mean().item() - 0.9) < 0.005
    assert torch.allclose(d[d != 0], torch.tensor(1 / 0.9))
    # the train-mode forward draws from the generator, eval never drops
    cfg = tiny(GNN={"dropout_rate": 0.5})
    m = tg.LearnableTopologyBGNN.from_configer(configers(cfg)[1]).init_weights(
        torch.Generator().manual_seed(0))
    x = torch.randn(7, 32)
    p1 = m.train()(x, torch.Generator().manual_seed(1))["unify_prototype"]
    p2 = m(x, torch.Generator().manual_seed(1))["unify_prototype"]
    p3 = m(x, torch.Generator().manual_seed(2))["unify_prototype"]
    e1, e2 = m.eval()(x)["unify_prototype"], m(x)["unify_prototype"]
    assert torch.equal(p1, p2) and not torch.equal(p1, p3) and torch.equal(e1, e2)


@pytest.mark.parametrize("name", ["learnable_topology_BGNN", "learnable_topology_BGNN_unlabel",
                                  "learnable_topology_BGNN_sfg", "learnable_topology_BGNN_adj3",
                                  "learnable_topology_BGAT", "self_attention_GNN",
                                  "learnable_topology_GAT"])
def test_waiting_forks_raise(name):
    """Once waiting, now ported: the MODELS name builds JAX's class with
    JAX's options, and holds the parameters of JAX's init (their shapes,
    from jax.eval_shape) under strict loading; so does the adversarial
    option."""
    import mds_tpu.models.gnn  # noqa: F401 — fills JAX's MODELS
    from mds_tpu.registry import MODELS as JMODELS
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.deploy.weights import bgnn_state_dict_from_jax

    for cfg in (tiny(GNN={"model_name": name}), tiny(GNN={"mse_or_adv": "adv"})):
        jc, tc = configers(cfg)
        jm = JMODELS[cfg["GNN"]["model_name"]](configer=jc)
        tm = MODELS[cfg["GNN"]["model_name"]](configer=tc)
        assert type(tm).__name__ == type(jm).__name__
        for k in ("adj_mode", "gnn_type", "with_unlabel", "mse_or_adv", "max_num_unify_class"):
            if hasattr(jm, k):  # the layer counts and widths: the strict load
                assert getattr(tm, k) == getattr(jm, k), k
        nf = jnp.zeros((sum(CATS), cfg["GNN"]["nfeat"]), jnp.float32)
        shapes = jax.eval_shape(lambda key: jm.init(key, nf, train=False),
                                jax.random.PRNGKey(0))["params"]
        zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
        tm.load_state_dict(bgnn_state_dict_from_jax(zeros), strict=True)
