"""The port's cross-dataset loss (mds_tpu_torch/losses/cross_datasets.py)
against JAX's (mds_tpu/losses/cross_datasets.py) on the CPU at f32.

Its three forms, as the alternating trainer calls them: the GNN stage (2n
graphs [max0, soft0, ...], the GNN's Σ n_cats + M prototype rows, max_rate
0, 0.3 and 1), the SEG stage (n 0/1 graphs, the model's M rows and its aux
logits) and the init stage (graph and prototype distillation); on the
flagship's terms (orth, aux, the max/softmax mix) and on the rest (spa,
max_enc, the adjacency target, the `mse` consistency). JAX's OHEM runs its
exact rule, as the port's always does.

Gates: the loss and each metric rel ≤ 1e-5; the gradients with respect to
the features, the prototypes and the graphs rel ≤ 1e-4 per tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import CATS, configers, one_torch_thread, rel, tiny  # noqa: F401

M, D = 5, 16
EXTRA = {"loss": {"with_spa": True, "with_max_enc": True, "spa_loss_weight": 0.1},
         "GNN": {"mse_or_adv": "mse"}}


def criteria(cfg):
    from mds_tpu.losses.cross_datasets import CrossDatasetsCELossAdvGNN as J
    from mds_tpu_torch.losses.cross_datasets import CrossDatasetsCELossAdvGNN as T

    jc, tc = configers(cfg)
    j = J(jc)
    j.ohem.exact = j.mds_ohem.exact = True
    return j, T(tc)


def inputs(seed):
    """Features (b, 8, 8, D), labels (b, 32, 32) with 5% ignored, the GNN's
    softmax blocks and max graphs, prototypes, adv pairs, a target graph."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1, (b, 8, 8, D)).astype(np.float32) for b in (2, 1)]
    labels = []
    for b, c in zip((2, 1), CATS):
        lb = rng.integers(0, c, (b, 32, 32))
        lb[rng.random(lb.shape) < 0.05] = 255
        labels.append(lb.astype(np.int64))
    soft = []
    for c in CATS:
        z = np.exp(rng.normal(0, 1, (c, M)) / 0.07 * 0.05)
        soft.append((z / z.sum(0)).astype(np.float32))
    maxg = [np.where(g == g.max(0, keepdims=True), g, 0).astype(np.float32) for g in soft]
    onehot = [(g > 0).astype(np.float32) for g in maxg]
    # prototypes near their init's scale (0.02): at 0.3 the orth softmax
    # saturates and its entropy (~1e-5) is all cancellation
    proto = rng.normal(0, 0.05, (sum(CATS) + M, D)).astype(np.float32)
    aux = [rng.normal(0, 0.3, (c, D)).astype(np.float32) for c in CATS]
    pairs = [(rng.normal(0, 1, (M + 7, D)).astype(np.float32),
              rng.normal(0, 1, (M + 7, D)).astype(np.float32)) for _ in range(4)]
    tbg = [np.where(rng.random((c, M)) < 0.2, 255, g).astype(np.float32)
           for c, g in zip(CATS, onehot)]
    return dict(feats=feats, labels=labels, soft=soft, maxg=maxg, onehot=onehot,
                proto=proto, aux=aux, pairs=pairs, tbg=tbg)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def compare(jcrit, tcrit, make_preds, targets, kw, diff_keys):
    """Loss, metrics and gradients of both packages. make_preds(xp, vals)
    builds preds from the differentiated values `vals` (dict of arrays, in
    the package's layout)."""
    def jfun(vals):
        preds = make_preds(jnp, vals)
        loss, metrics = jcrit(preds, [None if t is None else jnp.asarray(t) for t in targets],
                              **kw)
        return loss, metrics

    base = make_preds(None, None)
    jvals = {k: jnp.asarray(v) for k, v in base.items() if k in diff_keys}
    (jloss, jmetrics), jgrad = jax.jit(jax.value_and_grad(jfun, has_aux=True))(jvals)
    tvals = {k: (_nchw(v) if k.startswith("feat") else torch.from_numpy(v)).requires_grad_()
             for k, v in base.items() if k in diff_keys}
    preds = make_preds(torch, tvals)
    loss, metrics = tcrit(preds, [None if t is None else torch.from_numpy(t) for t in targets],
                          **kw)
    assert set(metrics) == set(jmetrics)
    for k, w in jmetrics.items():
        assert rel(float(metrics[k]), float(w)) <= 1e-5, k
    loss.backward()
    for k, t in tvals.items():
        g = t.grad.permute(0, 2, 3, 1).numpy() if k.startswith("feat") else t.grad.numpy()
        assert rel(g, np.asarray(jgrad[k])) <= 1e-4, k
    return float(loss)


@pytest.mark.parametrize("max_rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("extra", [False, True])
def test_gnn_stage_matches_jax(max_rate, extra):
    """preds as the GNN step gives them: features, the GNN's prototype rows
    (aux rows in front), the 2n graphs (soft graphs differentiated)."""
    cfg = tiny(**EXTRA) if extra else tiny()
    jcrit, tcrit = criteria(cfg)
    d = inputs(0)

    def make(xp, vals):
        if xp is None:
            return {"feat0": d["feats"][0], "feat1": d["feats"][1], "proto": d["proto"],
                    "soft0": d["soft"][0], "soft1": d["soft"][1]}
        cv = (lambda a: jnp.asarray(a)) if xp is jnp else torch.from_numpy
        feats = [vals["feat0"], vals["feat1"]]
        graphs = []
        for i in range(2):
            graphs += [cv(d["maxg"][i]), vals[f"soft{i}"]]
        pairs = [(cv(r), cv(f)) for r, f in d["pairs"]]
        return {"seg": feats, "unify_prototype": vals["proto"], "bi_graphs": graphs,
                "adv_pairs": pairs,
                "target_bi_graph": [cv(t) for t in d["tbg"]] if extra else None}

    compare(jcrit, tcrit, make, d["labels"], {"is_adv": True, "max_rate": max_rate},
            {"feat0", "feat1", "proto", "soft0", "soft1"})


def test_seg_stage_matches_jax():
    """preds as the SEG step gives them: features, the model's (M, D)
    prototype folded into its n 0/1 graphs, its aux logits."""
    jcrit, tcrit = criteria(tiny())
    d = inputs(1)

    def make(xp, vals):
        if xp is None:
            return {"feat0": d["feats"][0], "feat1": d["feats"][1],
                    "proto": d["proto"][sum(CATS):], "aux0": d["aux"][0], "aux1": d["aux"][1]}
        if xp is jnp:
            from mds_tpu.models.semseg import proto_logits
            aux = [proto_logits(vals[f"feat{i}"], vals[f"aux{i}"]) for i in range(2)]
            graphs = [jnp.asarray(g) for g in d["onehot"]]
        else:
            from mds_tpu_torch.models.semseg import proto_logits
            aux = [proto_logits(vals[f"feat{i}"], vals[f"aux{i}"]) for i in range(2)]
            graphs = [torch.from_numpy(g) for g in d["onehot"]]
        return {"seg": [vals["feat0"], vals["feat1"]], "aux": aux,
                "unify_prototype": vals["proto"], "bi_graphs": graphs}

    compare(jcrit, tcrit, make, d["labels"], {"is_adv": False},
            {"feat0", "feat1", "proto", "aux0", "aux1"})


def test_init_stage_matches_jax():
    """The init phase: the GNN's block against the identity graphs (×10)
    and its prototype against the seg model's (×10·n)."""
    from mds_tpu_torch.ops.uot_match import pretrain_bipartite_graphs

    jcrit, tcrit = criteria(tiny())
    d = inputs(2)
    pre = pretrain_bipartite_graphs(CATS, M)
    block = np.concatenate(d["soft"])

    def make(xp, vals):
        if xp is None:
            return {"proto": d["proto"][sum(CATS):], "block": block}
        cv = (lambda a: jnp.asarray(a)) if xp is jnp else torch.from_numpy
        return {"seg": [None, None], "unify_prototype": vals["proto"],
                "bi_graphs": [vals["block"][:3], vals["block"][3:]],
                "adj_block": vals["block"], "pretrain_bipart_graph": [cv(g) for g in pre],
                "seg_prototype": cv(d["proto"][:M] * 0.5)}

    compare(jcrit, tcrit, make, [None, None], {"is_adv": False, "init_gnn_stage": True},
            {"proto", "block"})


def test_similarity_dsb_matches_jax():
    """The orth entropy against JAX's, both reductions."""
    from mds_tpu.losses.cross_datasets import similarity_dsb as jsd
    from mds_tpu_torch.losses.cross_datasets import similarity_dsb

    p = np.random.default_rng(3).normal(0, 0.5, (M, D)).astype(np.float32)
    for red in ("mean", "sum"):
        assert rel(float(similarity_dsb(torch.from_numpy(p), 0.07, red)),
                   float(jsd(jnp.asarray(p), 0.07, red))) <= 1e-5
