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

import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    batch, check_machine, check_state, configers, jax_trainer, one_torch_thread, port_from,
    seg_step_check, snapshot, tiny)
from mds_tpu_torch.data.node_features import gen_graph_node_features
from mds_tpu_torch.engine.gnn_trainer import GNN, SEG


@pytest.fixture(scope="module")
def jax_run():
    """JAX's trainer through the stage machine: (node features, config,
    [(kind, state before, batch or None, state after)])."""
    cfg = tiny()
    nf = gen_graph_node_features(configers(cfg)[1], nfeat=cfg["GNN"]["nfeat"])
    jt = jax_trainer(cfg, nf)
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
    tt, before = seg_step_check(nf, cfg, pre, b, post)
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
