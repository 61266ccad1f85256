"""The alternating SEG/GNN trainer (mds_tpu_torch/engine/gnn_trainer.py) at
world size 2 on the CPU.

Two gloo ranks run as subprocesses that import only the port
(tests/torch_parallel_trainers.py), in one launch for the file, while the
parent runs the same trainers without a group (the world-1 side) and, in a
thread, JAX's `AlternatingTrainer(mesh=make_mesh(2))` (tests/conftest.py
gives JAX 8 CPU devices). The configs are tests/torch_flagship_parity.py's
tiny snp_rn18 + BGNN (2 datasets of 3 and 4 classes) with one GNN step a
stage, 4 crops of 64×64 a dataset: rows 0-1 on rank 0, 2-3 on rank 1, the
halves' pixel values apart (0-127 against 128-255), so that a rank's own
moments are not the global ones.

- f64, world 2 against world 1 on the concatenated batch, each from the
  port's seeded init: snp_rn18 (a GNN step, the UOT switch, a SEG step),
  snp_rn18_mulbn (the same, graph-net dropout 0.5) and one adv-mode GNN
  step (the discriminators' group, Gumbel graphs, dropout 0.5). Every
  metric, parameter, running stat of every level and dataset, GNN and
  netD parameter and AdamW moment rel ≤ 1e-10, over the larger of the
  tensor's own magnitude and 1e-3 of the largest of its net's tensors of
  its kind: the bn2 biases of layer4's block and layer4's downsample BN
  bias (their exact gradient is zero) and the first blend's BN running
  mean (its input's exact per-channel mean is zero) hold rounding noise
  alone (1e-21 and 1e-17 here). The UOT graphs exactly equal, the βs
  within 1e-10, both ranks bit-equal.
- the stage-switch eval (`switch_eval`) failing on rank 1 alone, in its
  loader and in the eval itself, against world 1's.
- f32 against JAX on `make_mesh(2)` at tests/test_torch_gnn_trainer.py's
  gates, each world-2 step from JAX's state before it (carried across by
  deploy/weights.py `alternating_state_from_jax`), graph-net dropout 0:
  the GNN step, every tensor ≤ 1e-4; the SEG step after JAX's switch, each
  tensor ≤ 1e-4 or within twice JAX's own distance from the exact step
  (the port's world-1 step in f64 from the same state) or within JAX's
  worst tensor's, and the port's worst within twice JAX's worst.
"""

import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_trainers as t
import torch_parallel_worker as w
from mds_tpu_torch.data.node_features import gen_graph_node_features
from torch_flagship_parity import (  # noqa: F401
    TOL, _np, configers, errors, one_torch_thread, randomize, snapshot, tiny)

CATS = (3, 4)
HW, B = 64, 4
F64_GATE = 1e-10
CONFIGS = {
    "snp": tiny(dataset1={"ims_per_gpu": 2}, dataset2={"ims_per_gpu": 2},
                train={"gnn_iters": 1}),
    "mulbn": tiny(model_name="snp_rn18_mulbn", dataset1={"ims_per_gpu": 2},
                  dataset2={"ims_per_gpu": 2}, train={"gnn_iters": 1},
                  GNN={"dropout_rate": 0.5}),
    "adv": tiny(dataset1={"ims_per_gpu": 2}, dataset2={"ims_per_gpu": 2},
                GNN={"mse_or_adv": "adv", "GumbelSoftmax": True, "gumbel_tau0": 5.0,
                     "dropout_rate": 0.5}),
}
STEPS = {"snp": 2, "mulbn": 2, "adv": 1}


def _batch(rng):
    """4 crops a dataset of 4×4 label blocks (5% ignored); rows 2-3 the
    bright half."""
    out = {}
    for i, c in enumerate(CATS):
        lb = np.repeat(np.repeat(rng.integers(0, c, (B, HW // 4, HW // 4)), 4, 1), 4, 2)
        lb[rng.random(lb.shape) < 0.05] = 255
        im = rng.integers(0, 128, (B, HW, HW, 3))
        im[B // 2:] += 128
        out[f"gnn_im{i}"], out[f"gnn_lb{i}"] = im.astype(np.uint8), lb.astype(np.uint8)
    return out


def _jax_run(cfg, d, inp):
    """JAX's trainer on make_mesh(2), its seg BN randomized (seed 0): the
    state before its GNN step (written to jax_s0.pt), after it, after the
    switch (jax_s1.pt) and after the SEG step."""
    import flax.linen as fnn

    from mds_tpu.data import node_features as jnf
    from mds_tpu.engine.gnn_trainer import AlternatingTrainer as JT
    from mds_tpu.parallel.mesh import make_mesh

    jcfg, tcfg = configers(cfg)
    nf = gen_graph_node_features(tcfg, nfeat=cfg["GNN"]["nfeat"])
    init = fnn.Module.init
    mp = pytest.MonkeyPatch()
    # JAX's trainer initializes its nets eagerly; the same init under jit
    mp.setattr(fnn.Module, "init", lambda self, rngs, *a, **kw: jax.jit(
        lambda r: init(self, r, *a, **kw))(rngs))
    mp.setattr(jnf, "_clip_text_features", lambda *a, **kw: None)
    try:
        jt = JT(jcfg, node_features=nf, mesh=make_mesh(2))
    finally:
        mp.undo()
    jt.criterion.ohem.exact = jt.criterion.mds_ohem.exact = True
    v = randomize(_np({"params": jt.seg_state.params,
                       "batch_stats": jt.seg_state.batch_stats}), np.random.default_rng(0))
    jt.seg_state = jt.seg_state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]))
    jt._replicate_all()
    batch = {"ims": [inp[f"gnn_im{i}"] for i in range(2)],
             "lbs": [inp[f"gnn_lb{i}"] for i in range(2)]}
    s0 = snapshot(jt)
    t.write_atomic(s0, os.path.join(d, "jax_s0.pt"))
    jt.step(batch)
    after_gnn = snapshot(jt)
    jt.switch_to_seg()
    s1 = snapshot(jt)
    t.write_atomic(s1, os.path.join(d, "jax_s1.pt"))
    jt.step(batch)
    return {"s0": s0, "gnn": after_gnn, "s1": s1, "seg": snapshot(jt)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, rank 1's, world 1's, JAX's snapshots, the exact
    SEG step from JAX's switch)."""
    d = tmp_path_factory.mktemp("parallel_gnn")
    inp = _batch(np.random.default_rng(20))
    for name, cfg in CONFIGS.items():
        inp[f"cfg_{name}"], inp[f"steps_{name}"] = json.dumps(cfg), STEPS[name]
    np.savez(d / "inputs.npz", **inp)
    inp = np.load(d / "inputs.npz")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        job = pool.submit(w.launch, 2, str(d), [f"alternating:{n}" for n in CONFIGS]
                          + ["from_jax", "switch_eval"], 240, t.WORKER)
        jax_job = pool.submit(_jax_run, CONFIGS["snp"], str(d), inp)
        one = {n: t.alternating_run(inp, n) for n in CONFIGS}
        one["switch_eval"] = t.switch_eval_case()
        jx = jax_job.result()
        exact = t.trainer_from(t.configer(inp, "snp"), jx["s1"], torch.float64)
        exact.step(t.rows_of(inp, "gnn_", 2, 0, 1))
        job.result()
    r0, r1 = (torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2))
    return r0, r1, one, jx, t.trainer_states(exact)["states"]


def rels(got, want):
    """Per tensor of both nets (state_dicts and AdamW moments): the max-diff
    over the larger of the tensor's own largest magnitude and 1e-3 of the
    largest of its net's tensors of its kind (`t.scaled_rels`)."""
    pairs = {}
    for net in ("seg", "gnn"):
        pairs.update({f"{net}:{k}": (got[net][k], v) for k, v in want[net].items()
                      if not k.endswith("num_batches_tracked")})
        g_opt, w_opt = got[f"{net}_optimizer"], want[f"{net}_optimizer"]
        assert g_opt["count"] == w_opt["count"]
        assert set(g_opt["state"]) == set(w_opt["state"])
        for name, st in w_opt["state"].items():
            for m in ("mu", "nu"):
                pairs[f"{net}:{name}/{m}"] = (g_opt["state"][name][m], st[m])
    return t.scaled_rels(pairs)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world2_equals_world1_f64(runs, name):
    """The same steps at world 2 as at world 1 on the concatenated batch
    (module docstring); the ranks bit-equal."""
    r0, r1, one, _, _ = runs
    a, b = r0[name], one[name]
    assert [s["stage"] for s in a["steps"]] == [s["stage"] for s in b["steps"]] == (
        ["GNN", "SEG"] if STEPS[name] == 2 else ["GNN"])
    for got, want in zip(a["steps"], b["steps"]):
        assert got["collectives"] > 0 and want["collectives"] == 0
        assert set(got) == set(want)
        for k in set(want) - {"stage", "collectives"}:
            assert abs(got[k] - want[k]) <= F64_GATE * abs(want[k]), (k, got[k], want[k])
    bad = {k: r for k, r in rels(a["states"], b["states"]).items() if not r <= F64_GATE}
    assert not bad, bad
    assert a["machine"] == b["machine"]
    if name == "adv":
        assert any(k.startswith("netD.") for k in a["states"]["gnn"])
    else:  # the switch ran: the UOT graphs and βs
        assert len(a["uot_bi"]) == 2
        for g, h in zip(a["uot_bi"], b["uot_bi"]):
            np.testing.assert_array_equal(g, h)
        for g, h in zip(a["betas"], b["betas"]):
            np.testing.assert_allclose(g, h, rtol=F64_GATE, atol=0)
    for net in ("seg", "gnn"):
        for k, v in r0[name]["states"][net].items():
            assert torch.equal(v, r1[name]["states"][net][k]), (net, k)
    assert r0[name]["steps"] == r1[name]["steps"]


def test_world2_gnn_step_matches_jax(runs):
    """The world-2 GNN step from JAX's init against JAX's on its 2-device
    mesh: every tensor ≤ 1e-4; the two ranks bit-equal."""
    r0, r1, _, jx, _ = runs
    got = r0["from_jax"]["gnn"]
    e = errors(got["states"], jx["gnn"]["states"])
    bad = {k: r for k, r in e.items() if not r <= TOL}
    assert not bad, bad
    assert got["machine"] == (jx["gnn"]["stage"], jx["gnn"]["alter_iter"],
                              jx["gnn"]["total_iter"], jx["gnn"]["seg_steps"],
                              jx["gnn"]["gnn_steps"])
    for net in ("seg", "gnn"):
        for k, v in got["states"][net].items():
            assert torch.equal(v, r1["from_jax"]["gnn"]["states"][net][k]), k


def test_world2_seg_step_matches_jax(runs):
    """The world-2 SEG step from JAX's state after its switch against
    JAX's, at tests/test_torch_gnn_trainer.py's SEG-step rule (module
    docstring)."""
    r0, r1, _, jx, exact = runs
    got = r0["from_jax"]["seg"]
    assert got["machine"][0] == "SEG" and got["machine"][3] == jx["seg"]["seg_steps"]
    e_port, e_jax = errors(got["states"], exact), errors(jx["seg"]["states"], exact)
    e_pj = errors(got["states"], jx["seg"]["states"])
    worst_jax = max(e_jax.values())
    bad = {k: (r, e_port[k], e_jax[k]) for k, r in e_pj.items()
           if not (r <= TOL or e_port[k] <= max(2 * e_jax[k], worst_jax))}
    assert not bad, bad
    assert max(e_port.values()) <= 2 * worst_jax
    for k, v in got["states"]["seg"].items():
        assert torch.equal(v, r1["from_jax"]["seg"]["states"]["seg"][k]), k


def test_switch_eval_failure_world2(runs):
    """A stage-switch eval that fails on one rank: where that rank's eval
    loader fails, every rank skips the eval; where the eval itself fails,
    that rank raises (its collectives would leave the others waiting). The
    ranks stay in step. At world 1 either failure is logged and the run
    goes on, as JAX's."""
    r0, r1, one, _, _ = runs
    assert r0["switch_eval"] == {"loader": False, "eval": True, "ok": True, "after": 1}
    assert r1["switch_eval"] == {"loader": False, "eval": "raised", "ok": True, "after": 1}
    assert one["switch_eval"] == {"loader": False, "eval": False, "ok": True, "after": 0}
