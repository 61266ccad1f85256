"""snp_rn18_mulbn, the flagship with a BN set for each dataset
(mds_tpu_torch/models/swiftnet.py `DatasetListBN`), against JAX's
(`SharedListBN(per_dataset=True)`, mds_tpu/models/swiftnet.py:128-176) on
the CPU at f32, on the tiny flagship config of tests/torch_flagship_parity.py
with `model_name snp_rn18_mulbn`.

Gates:
- the eval logits of every dataset, and the train call's seg, aux and
  feat, rel ≤ 1e-4 (max-diff over the reference's largest magnitude);
- the running stats of every (slot, dataset) after the train call rel ≤
  1e-4 (JAX's two-pass moments, the unbiased variance per dataset);
- the weights carried across by deploy/weights.py (JAX's (n_slots,
  n_datasets, C) scale/bias/mean/var → `{set}.{dataset}` BatchNorm2d keys),
  strict, every key;
- kernel 6's route: each dataset's input takes its own level set's fold
  (the plain version of the kernel on the CPU), cached under
  "fold/{level}/{dataset}";
- JAX's AlternatingTrainer with its seg net built as snp_rn18_mulbn (JAX's
  trainer builds snp_rn18 whatever the model_name, so the test swaps in
  JAX's own mulbn factory): one GNN step, the UOT switch and one SEG step,
  each port step from JAX's state before it, at the gates of
  tests/test_torch_gnn_trainer.py (rel ≤ 1e-4 a tensor; a SEG-step tensor
  within twice JAX's own distance from the f64 step, or within JAX's worst).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import (  # noqa: F401
    CATS, batch, check_state, configers, jax_trainer, nchw, nhwc, one_torch_thread,
    port_from, randomize, rel, seg_step_check, snapshot, tiny)
from mds_tpu_torch.deploy.weights import semseg_state_dict_from_jax, semseg_to_torch
from mds_tpu_torch.engine.gnn_trainer import GNN, SEG

F32 = 1e-4
CFG = tiny(model_name="snp_rn18_mulbn", train={"seg_iters": 2, "gnn_iters": 1,
                                               "cropsize": [64, 64]})


@pytest.fixture(scope="module")
def model():
    """JAX's mulbn SemsegModel, its variables (init, BN randomized per
    (slot, dataset)), the port's holding them."""
    from mds_tpu.models.semseg import SemsegModel as JS
    from mds_tpu_torch.models.semseg import SemsegModel

    jcfg, tcfg = configers(CFG)
    jm = JS.from_configer(jcfg, mulbn=True)
    xs = [jnp.zeros((1, 64, 64, 3))] * 2
    v = jax.jit(lambda k: jm.init(k, xs, train=True))(jax.random.PRNGKey(0))
    v = randomize(jax.tree_util.tree_map(np.asarray, dict(v)), np.random.default_rng(1))
    tm = SemsegModel.from_configer(tcfg, mulbn=True)
    tm.load_state_dict(semseg_state_dict_from_jax(v["params"], v["batch_stats"],
                                                  v["buffers"]), strict=True)
    return jm, v, tm


@pytest.fixture(scope="module")
def jax_outputs(model):
    jm, v, _ = model
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 72, 72, 3)).astype(np.float32)
    xs = [rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32),
          rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)]

    def run(v, x, xs):
        out = {ds: jm.apply(v, x, ds, method=jm.uni_eval_logits) for ds in range(2)}
        train, mut = jm.apply(v, xs, train=True, mutable=["batch_stats"])
        return out, train, mut

    out, train, mut = jax.jit(run)(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x),
                                   [jnp.asarray(a) for a in xs])
    return x, xs, out, train, mut


def test_weights_carry_every_dataset_set(model):
    jm, v, tm = model
    sd = semseg_state_dict_from_jax(v["params"], v["batch_stats"], v["buffers"])
    assert set(sd) == {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    for key in ("backbone.bn1.2.1.running_var", "backbone.layer2.0.bn1.0.1.weight",
                "backbone.layer2.0.downsample.1.1.running_mean",
                "backbone.upsample_blends.4.blend_conv.norm.0.bias", "logits.norm.1.weight"):
        assert key in sd, key
    np.testing.assert_array_equal(
        sd["backbone.bn1.2.1.running_var"].numpy(),
        v["batch_stats"]["backbone"]["bn1"]["var"][2, 1])


def test_eval_logits_match_jax(model, jax_outputs):
    _, _, tm = model
    x, _, want, _, _ = jax_outputs
    tm.eval()
    for ds in range(2):
        with torch.no_grad():
            got = nhwc(tm.uni_eval_logits(nchw(x), ds))
        assert rel(got, np.asarray(want[ds])) <= F32, ds
    # each dataset's own sets: dataset 1's input through dataset 0's
    # statistics is another function
    with torch.no_grad():
        other = nhwc(tm.features([None, nchw(x)])[1])
        swapped = nhwc(tm.features([nchw(x), None])[0])
    assert rel(other, swapped) > 1e-2


def test_train_call_and_running_stats_match_jax(model, jax_outputs):
    jm, v, _ = model
    _, xs, _, train, mut = jax_outputs
    from mds_tpu_torch.models.semseg import SemsegModel

    tm = SemsegModel.from_configer(configers(CFG)[1], mulbn=True)
    tm.load_state_dict(semseg_state_dict_from_jax(v["params"], v["batch_stats"],
                                                  v["buffers"]), strict=True)
    out = tm.train()([nchw(a) for a in xs])
    for key in ("seg", "aux", "feat"):
        for g, w in zip(out[key], train[key]):
            assert rel(nhwc(g), np.asarray(w)) <= F32, key
    want = semseg_to_torch(v["params"], jax.tree_util.tree_map(np.asarray, mut["batch_stats"]),
                           v["buffers"])
    sd = tm.state_dict()
    stats = [k for k in want if "running" in k]
    assert len(stats) > 100
    for k in stats:
        assert rel(sd[k].numpy(), want[k]) <= F32, k
    with pytest.raises(ValueError, match="2 datasets got 1"):
        tm([nchw(xs[0])])


def test_stem7_route_folds_each_datasets_set(model):
    """set_stem_impl("kernel") at bf16: dataset i's level-l stem is kernel
    6 (its plain version on the CPU) with bn1[l][i] folded in, cached per
    (level, dataset)."""
    from mds_tpu_torch.models import layers
    from mds_tpu_torch.models.layers import bn_fold
    from mds_tpu_torch.models.semseg import SemsegModel
    from mds_tpu_torch.ops.stem import stem7_conv_bn_relu_s2_plain

    _, v, _ = model
    tm = SemsegModel.from_configer(configers(CFG)[1], dtype=torch.bfloat16, mulbn=True)
    tm.load_state_dict(semseg_state_dict_from_jax(v["params"], v["batch_stats"],
                                                  v["buffers"]), strict=True)
    tm.eval()
    bb = tm.backbone
    x = torch.randn(1, 3, 32, 32, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    layers.set_stem_impl("kernel")
    try:
        for ds in range(2):
            xs = [None, None]
            xs[ds] = x
            with torch.no_grad():
                got = bb._stem(xs, 1)[ds]
                want = stem7_conv_bn_relu_s2_plain(
                    x, bb.conv1.weight, *bn_fold(bb.bn1[1][ds]))
                wrong = stem7_conv_bn_relu_s2_plain(
                    x, bb.conv1.weight, *bn_fold(bb.bn1[1][1 - ds]))
            assert torch.equal(got, want)
            assert not torch.equal(got, wrong)
    finally:
        layers.set_stem_impl("plain")
    assert sorted(k for k in bb._packs._entries if k.startswith("fold/")) == [
        "fold/1/0", "fold/1/1"]


@pytest.fixture(scope="module")
def jax_run():
    """JAX's trainer, its seg net snp_rn18_mulbn: GNN step, switch, SEG
    step."""
    from mds_tpu.engine import gnn_trainer as jgt
    from mds_tpu.models.semseg import SemsegModel as JS
    from mds_tpu_torch.data.node_features import gen_graph_node_features

    class MulBN:
        @staticmethod
        def from_configer(configer, dtype=jnp.float32, **kw):
            return JS.from_configer(configer, dtype=dtype, mulbn=True, **kw)

    nf = gen_graph_node_features(configers(CFG)[1], nfeat=CFG["GNN"]["nfeat"])
    mp = pytest.MonkeyPatch()
    mp.setattr(jgt, "SemsegModel", MulBN)
    try:
        jt = jax_trainer(CFG, nf)
    finally:
        mp.undo()
    assert jt.seg_model.mulbn
    rng = np.random.default_rng(0)
    runs = []
    pre, b = snapshot(jt), batch(rng)
    jt.step(b)
    runs.append((GNN, pre, b, snapshot(jt)))
    pre = snapshot(jt)
    jt.switch_to_seg()
    runs.append(("switch", pre, None, snapshot(jt)))
    pre, b = snapshot(jt), batch(rng)
    jt.step(b)
    assert jt.stage == SEG
    runs.append((SEG, pre, b, snapshot(jt)))
    return nf, runs


@pytest.mark.parametrize("kind", [GNN, "switch", SEG])
def test_alternating_steps_match_jax(jax_run, kind):
    nf, runs = jax_run
    (_, pre, b, post), = [r for r in runs if r[0] == kind]
    if kind == SEG:
        tt, before = seg_step_check(nf, CFG, pre, b, post)
        moved = {k for k, t in before.items() if not torch.equal(tt.seg_model.state_dict()[k], t)}
        assert "backbone.bn1.0.1.running_mean" in moved and "logits.norm.0.weight" in moved
        return
    tt = port_from(nf, CFG, pre)
    assert tt.mulbn and tt.seg_model.mulbn
    if kind == GNN:
        assert np.isfinite(float(tt.step(b)["loss"].detach()))
    else:
        tt.switch_to_seg()
        for got, want in zip(tt.uot_bi, post["uot_bi"]):
            np.testing.assert_array_equal(got, want)
    check_state(tt, post)
