"""The port's alternating SEG/GNN trainer (mds_tpu_torch/engine/gnn_trainer.py)
against JAX's (mds_tpu/engine/gnn_trainer.py) on the CPU, on the tiny
flagship config of tests/torch_flagship_parity.py at f32.

JAX's trainer runs the stage machine once (2 GNN steps → the UOT switch →
2 SEG steps → the re-entry → 2 GNN steps; the switches called out of the
step so that their results can be read). Each port step and switch starts
from JAX's state before it (both nets, both AdamW states, the BN stats,
graphs, βs and the stage machine, carried across by deploy/weights.py
`alternating_state_from_jax`) and is held to JAX's state after it:

- every parameter, BN running stat and graph, and every AdamW moment, rel
  ≤ 1e-4 per tensor (GNN steps measured ≤ 2.1e-5); the step counts equal;
- a SEG step's tensor may lie further from JAX's only where f32 rounding
  puts JAX's own step as far from the exact one (the port's step in f64
  from the same state, as tests/torch_parity.py measures the BiSeNetV2
  step): the port's tensor within twice JAX's distance on that tensor, or
  within JAX's worst tensor's, and the port's worst within twice JAX's
  worst. At this size the deepest pyramid level's BNs see 2-8 values a
  channel: their moments part by up to 1e-2 between the packages, and a
  variance taken as s2/N − m² over few values cancels to ~1e-4;
- the moments of the parameters whose exact gradient is zero (the bn2
  biases of layer4's last block and layer4's downsample BN bias add a
  per-channel constant to a skip that goes only into a train-mode BN, the
  decoder's blend, which removes it) are rounding noise in every run: they
  are measured over the seg net's largest moment of each kind;
- the switch: the same UOT graphs (exactly) and βs (1e-5) from the same GNN
  parameters, the prototypes and aux prototypes set from the GNN's (1e-5);
- the re-entry: gnn_lr_scale equal to JAX's max(0.1, 1 − step/max_iter).
JAX's OHEM runs its exact rule, as the port's always does, and the GNN's
dropout is off (its masks cannot equal flax's; tests/test_torch_gnn.py
checks the port's own).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import batch, configers, one_torch_thread, randomize, tiny  # noqa: F401
from mds_tpu_torch.data.node_features import gen_graph_node_features
from mds_tpu_torch.deploy.weights import alternating_state_from_jax
from mds_tpu_torch.engine.gnn_trainer import GNN, SEG, AlternatingTrainer

TOL = 1e-4
# parameters whose exact SEG-step gradient is zero (see the docstring)
ZERO_GRAD = ("backbone.layer4.0.bn2.", "backbone.layer4.0.downsample.1.bias")


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def snapshot(jt):
    """JAX's trainer state in the port's terms, and its stage machine."""
    return {"states": alternating_state_from_jax(
                _np(jt.seg_state.params), _np(jt.seg_state.batch_stats), _np(jt.seg_buffers),
                _np(jt.seg_state.opt_state), _np(jt.gnn_state.params),
                _np(jt.gnn_state.opt_state)),
            "stage": jt.stage, "alter_iter": jt.alter_iter, "total_iter": jt.total_iter,
            "seg_steps": int(jt.seg_state.step), "gnn_steps": int(jt.gnn_state.step),
            "betas": [np.array(b) for b in jt.betas], "gnn_lr_scale": float(jt.gnn_lr_scale),
            "uot_bi": None if jt.uot_bi is None else [np.array(g) for g in jt.uot_bi]}


@pytest.fixture(scope="module")
def jax_run():
    """JAX's trainer through the stage machine: (node features, config,
    [(kind, state before, batch or None, state after)])."""
    from mds_tpu.data import node_features as jnf
    from mds_tpu.engine.gnn_trainer import AlternatingTrainer as JT

    cfg = tiny()
    jcfg, tcfg = configers(cfg)
    nf = gen_graph_node_features(tcfg, nfeat=cfg["GNN"]["nfeat"])
    init = fnn.Module.init
    mp = pytest.MonkeyPatch()
    # JAX's trainer initializes its nets eagerly (tens of seconds at this
    # size); the same init under jit
    mp.setattr(fnn.Module, "init", lambda self, rngs, *a, **kw: jax.jit(
        lambda r: init(self, r, *a, **kw))(rngs))
    mp.setattr(jnf, "_clip_text_features", lambda *a, **kw: None)
    try:
        jt = JT(jcfg, node_features=nf)
    finally:
        mp.undo()
    jt.criterion.ohem.exact = jt.criterion.mds_ohem.exact = True
    v = randomize(_np({"params": jt.seg_state.params,
                       "batch_stats": jt.seg_state.batch_stats}), np.random.default_rng(0))
    jt.seg_state = jt.seg_state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]))
    rng = np.random.default_rng(0)
    runs = []
    for _ in range(6):
        if jt.stage == GNN and jt.alter_iter >= jt.gnn_iters:
            pre = snapshot(jt)
            jt.switch_to_seg()
            runs.append(("switch_to_seg", pre, None, snapshot(jt)))
        elif jt.stage == SEG and jt.alter_iter >= jt.seg_iters:
            pre = snapshot(jt)
            jt.switch_to_gnn()
            runs.append(("switch_to_gnn", pre, None, snapshot(jt)))
        pre, b = snapshot(jt), batch(rng)
        jt.step(b)
        runs.append((jt.stage, pre, b, snapshot(jt)))
    return nf, cfg, runs


def port_from(nf, cfg, snap, dtype=torch.float32):
    """A port trainer holding JAX's state `snap` (computing in `dtype`)."""
    _, tcfg = configers(cfg)
    tt = AlternatingTrainer(tcfg, compute_dtype=dtype, node_features=nf, device="cpu")
    tt.load_states(snap["states"])
    for k in ("stage", "alter_iter", "total_iter", "seg_steps", "gnn_steps",
              "gnn_lr_scale", "uot_bi"):
        setattr(tt, k, snap[k])
    tt.betas = [b.copy() for b in snap["betas"]]
    return tt


def port_states(tt):
    """A port trainer's state in the form of `snapshot(...)["states"]`."""
    from mds_tpu_torch.engine.optim import optimizer_state

    return {"seg": tt.seg_model.state_dict(), "gnn": tt.gnn_model.state_dict(),
            "seg_optimizer": optimizer_state(tt.seg_model, tt.seg_opt),
            "gnn_optimizer": optimizer_state(tt.gnn_model, tt.gnn_opt)}


def errors(got, want):
    """Per tensor of both nets (state_dict entries and AdamW moments, a
    fresh optimizer's absent moments as zeros): rel max-diff of `got`
    against `want`; the moments of ZERO_GRAD over the seg net's largest
    moment of their kind."""
    out, scale = {}, {}
    for net in ("seg", "gnn"):
        for k, w in want[net].items():
            if k.endswith("num_batches_tracked"):  # JAX has none
                continue
            out[f"{net}:{k}"] = ((got[net][k].double() - w.double()).abs().max().item(),
                                 w.abs().max().item())
        g_opt, w_opt = got[f"{net}_optimizer"], want[f"{net}_optimizer"]
        assert g_opt["count"] == w_opt["count"]
        for name, w_st in w_opt["state"].items():
            g_st = g_opt["state"].get(name, {})
            for m in ("mu", "nu"):
                w = w_st[m]
                g = g_st.get(m, torch.zeros_like(w))
                out[f"{net}:{name}/{m}"] = ((g.double() - w.double()).abs().max().item(),
                                            w.abs().max().item())
                if net == "seg":
                    scale[m] = max(scale.get(m, 0.0), w.abs().max().item())
    rels = {}
    for k, (diff, mag) in out.items():
        if k.startswith("seg:") and k[4:].startswith(ZERO_GRAD) and "/" in k:
            mag = scale[k.rsplit("/", 1)[1]]
        rels[k] = diff / mag if mag else diff
    return rels


def check_machine(tt, snap):
    assert (tt.stage, tt.alter_iter, tt.total_iter, tt.seg_steps, tt.gnn_steps) == (
        snap["stage"], snap["alter_iter"], snap["total_iter"], snap["seg_steps"],
        snap["gnn_steps"])


def check_state(tt, snap):
    """Every tensor within TOL of JAX's."""
    bad = {k: r for k, r in errors(port_states(tt), snap["states"]).items() if not r <= TOL}
    assert not bad, bad
    check_machine(tt, snap)


@pytest.mark.parametrize("which", [0, 1])
def test_gnn_step_matches_jax(jax_run, which):
    """The first stage's two GNN steps (max_rate 0 and 0.5)."""
    nf, cfg, runs = jax_run
    kind, pre, b, post = [r for r in runs if r[0] == GNN][which]
    tt = port_from(nf, cfg, pre)
    metrics = tt.step(b)
    assert np.isfinite(float(metrics["loss"]))
    assert {"orth_loss", "aux_loss", "ce_loss", "loss"} <= set(metrics)
    check_state(tt, post)


def test_switch_to_seg_matches_jax(jax_run):
    nf, cfg, runs = jax_run
    (_, pre, _, post), = [r for r in runs if r[0] == "switch_to_seg"]
    tt = port_from(nf, cfg, pre)
    tt.switch_to_seg()
    for got, want in zip(tt.uot_bi, post["uot_bi"]):
        np.testing.assert_array_equal(got, want)
        assert (got.sum(axis=0) == 1).all() and (got.sum(axis=1) >= 1).all()
    for got, want in zip(tt.betas, post["betas"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    check_state(tt, post)
    # the graphs are the model's buffers, the prototypes the GNN's rows
    for i, g in enumerate(post["uot_bi"]):
        assert torch.equal(tt.seg_model.bipartite_graphs[i], torch.from_numpy(g))


@pytest.mark.parametrize("which", [0, 1])
def test_seg_step_matches_jax(jax_run, which):
    """Both SEG steps: the tensors that move in JAX's step move in the
    port's (the prototypes and BN stats among them), the graphs do not."""
    nf, cfg, runs = jax_run
    kind, pre, b, post = [r for r in runs if r[0] == SEG][which]
    tt = port_from(nf, cfg, pre)
    before = {k: v.clone() for k, v in tt.seg_model.state_dict().items()}
    tt.step(b)
    exact = port_from(nf, cfg, pre, torch.float64)
    exact.step(b)
    ref = port_states(exact)
    e_port, e_jax = errors(port_states(tt), ref), errors(post["states"], ref)
    e_pj = errors(port_states(tt), post["states"])
    worst_jax = max(e_jax.values())
    bad = {k: (r, e_port[k], e_jax[k]) for k, r in e_pj.items()
           if not (r <= TOL or e_port[k] <= max(2 * e_jax[k], worst_jax))}
    assert not bad, bad
    assert max(e_port.values()) <= 2 * worst_jax
    check_machine(tt, post)
    after = tt.seg_model.state_dict()
    moved = {k for k, v in before.items() if not torch.equal(after[k], v)}
    jax_moved = {k for k, v in post["states"]["seg"].items()
                 if not torch.equal(v, pre["states"]["seg"][k])}
    assert moved == jax_moved
    assert "unify_prototype" in moved and "aux_prototype.0" in moved
    assert not any(k.startswith("bipartite_graphs.") for k in moved)


def test_reentry_matches_jax(jax_run):
    """SEG → GNN: the decayed update scale, fresh GNN moments; then the
    GNN step with that scale."""
    nf, cfg, runs = jax_run
    (_, pre, _, post), = [r for r in runs if r[0] == "switch_to_gnn"]
    tt = port_from(nf, cfg, pre)
    tt.switch_to_gnn()
    assert tt.gnn_lr_scale == post["gnn_lr_scale"] == max(0.1, 1 - 2 / 20)
    assert tt.gnn_opt.count == 0 and not tt.gnn_opt.state
    check_state(tt, post)
    kind, pre, b, post = [r for r in runs if r[0] == GNN][2]
    tt = port_from(nf, cfg, pre)
    tt.step(b)
    check_state(tt, post)
