"""Shared helpers of the flagship's parity tests (tests/test_torch_swiftnet.py,
test_torch_semseg.py, test_torch_gnn.py, test_torch_cross_datasets.py,
test_torch_gnn_trainer.py, test_torch_gnn_forks.py,
test_torch_gnn_options.py, test_torch_clip_trainer.py): a tiny snp_rn18 +
BGNN config for both packages, JAX variables made non-trivial from a numpy
seed, their port counterparts, batches; JAX's own GNN step on fixed
features (`feature_trainers`, `gnn_step_pair`).

The tiny config keeps the flagship's structure (3 pyramid levels, the
direct-adjacency BGNN with 4 GSAGE layers, aux prototypes, unify_ratio 0.8
so that M < Σ n_cats) at small widths: ResNet layers [1, 1, 1, 1], planes
[64, 16, 24, 32] (kernel 6 takes planes[0] = 64), 16 features, nfeat 32.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu_torch.deploy.weights import (
    alternating_state_from_jax,
    bgnn_state_dict_from_jax,
    semseg_state_dict_from_jax,
)

HW = 64
CATS = (3, 4)

TINY = {
    "model_name": "snp_rn18",
    "n_datasets": 2,
    "seed": 0,
    "network": {"efficient": False},
    "backbone": {"layers": [1, 1, 1, 1], "planes": [64, 16, 24, 32], "num_features": 16},
    "dataset1": {"n_cats": 3, "ims_per_gpu": 1},
    "dataset2": {"n_cats": 4, "ims_per_gpu": 1},
    "GNN": {"model_name": "learnable_topology_BGNN_adj", "nfeat": 32, "nfeat_out": 16,
            "output_feat_dim": 16, "unify_ratio": 0.8, "dropout_rate": 0.0,
            "GNN_type": "GSAGE", "mse_or_adv": "None", "output_max_adj": True,
            "output_softmax_and_max_adj": True, "with_orth": True, "orth_weight": 1.0,
            "uot_ratio": 1.0},
    "loss": {"with_datasets_aux": True, "aux_weight": 0.2, "ignore_index": 255},
    "contrast": {"temperature": 0.07},
    "lr": {"seg_lr_start": 1e-3, "gnn_lr_start": 1e-3, "weight_decay": 1e-5,
           "max_iter": 20, "warmup_iters": 2, "init_iter": 0},
    "train": {"seg_iters": 2, "gnn_iters": 2, "cropsize": [HW, HW]},
}


def tiny(**sections):
    """TINY with sections updated ({"GNN": {...}} merges into GNN)."""
    cfg = copy.deepcopy(TINY)
    for k, v in sections.items():
        if isinstance(v, dict):
            cfg.setdefault(k, {}).update(v)
        else:
            cfg[k] = v
    return cfg


def configers(cfg):
    """(JAX's Configer, the port's) of one config dict."""
    from mds_tpu.config import Configer as JConfiger
    from mds_tpu_torch.config import Configer

    return JConfiger(configs=copy.deepcopy(cfg)), Configer(configs=copy.deepcopy(cfg))


def randomize(v, rng):
    """JAX variables as numpy with non-trivial BN: running mean ~N(0, 0.1),
    var ~U(0.5, 1.5), BN scale ~N(1, 0.1), bias ~N(0, 0.1) (each pyramid
    level's own); bipartite graphs ~U(0, 1)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(x, path + (k,)) for k, x in node.items()}
        a = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf == "mean":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1, 0.1, a.shape).astype(np.float32)
        if leaf == "bias":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if leaf.startswith("bi_graph_"):
            return rng.uniform(0, 1, a.shape).astype(np.float32)
        return a
    return walk(v, ())


def jax_semseg(cfg, seed=0, hw=(HW, HW), dtype=jnp.float32):
    """JAX's SemsegModel of `cfg` and its variables (JAX's init at hw,
    randomized BN and graphs from `seed`), as numpy."""
    from mds_tpu.models.semseg import SemsegModel

    jcfg, _ = configers(cfg)
    jm = SemsegModel.from_configer(jcfg, dtype=dtype)
    xs = [jnp.zeros((1, *hw, 3), jnp.float32)] * jcfg.n_datasets
    v = jax.jit(lambda k: jm.init(k, xs, train=True))(jax.random.PRNGKey(0))
    v = randomize(jax.tree_util.tree_map(np.asarray, dict(v)), np.random.default_rng(seed))
    return jm, v


KW = dict(layers=(1, 1, 1, 1), planes=(64, 16, 24, 32), num_features=16)


def jax_pyramid():
    """JAX's SwiftNetPyramid at the tiny config's widths (KW), its variables
    (JAX's init, randomized BN), and the port's holding them."""
    from mds_tpu.models.swiftnet import SwiftNetPyramid as JS
    from mds_tpu_torch.deploy.weights import swiftnet_to_torch
    from mds_tpu_torch.models.swiftnet import SwiftNetPyramid

    assert tuple(TINY["backbone"]["planes"]) == KW["planes"]
    jm = JS(**KW)
    xs = [jnp.zeros((1, 64, 64, 3))] * 2
    v = jax.jit(lambda k: jm.init(k, xs, train=True))(jax.random.PRNGKey(0))
    v = randomize(jax.tree_util.tree_map(np.asarray, dict(v)), np.random.default_rng(0))
    tm = SwiftNetPyramid(**KW)
    tm.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in swiftnet_to_torch(
        v["params"], v["batch_stats"], prefix="").items()}, strict=True)
    return jm, v, tm


def port_semseg(cfg, v, dtype=torch.float32):
    """The port's snp_rn18 of `cfg` holding the JAX variables (strict)."""
    from mds_tpu_torch.models.semseg import SemsegModel

    _, tcfg = configers(cfg)
    tm = SemsegModel.from_configer(tcfg, dtype=dtype)
    tm.load_state_dict(semseg_state_dict_from_jax(v["params"], v["batch_stats"],
                                                  v["buffers"]), strict=True)
    return tm


def jax_bgnn(cfg, seed=1):
    """JAX's BGNN of `cfg`, its params (JAX's init) and the hashed node
    features (the port's, bit-equal to JAX's: tests/test_torch_gnn.py;
    JAX's own first tries to import CLIP, seconds of the test's time)."""
    from mds_tpu.models.gnn import LearnableTopologyBGNN
    from mds_tpu_torch.data.node_features import gen_graph_node_features

    jcfg, tcfg = configers(cfg)
    jg = LearnableTopologyBGNN.from_configer(jcfg)
    nf = gen_graph_node_features(tcfg, nfeat=jg.nfeat)
    params = jax.jit(lambda k: jg.init({"params": k}, jnp.asarray(nf), train=False))(
        jax.random.PRNGKey(seed))["params"]
    return jg, jax.tree_util.tree_map(np.asarray, dict(params)), nf


def port_bgnn(cfg, params):
    from mds_tpu_torch.models.gnn import LearnableTopologyBGNN

    _, tcfg = configers(cfg)
    tg = LearnableTopologyBGNN.from_configer(tcfg)
    tg.load_state_dict(bgnn_state_dict_from_jax(params), strict=True)
    return tg


def batch(rng, cats=CATS, hw=(HW, HW), b=1, ignore=0.05):
    """Per-dataset uint8 (b, H, W, 3) images and label maps of 4×4 blocks
    with a share `ignore` of 255."""
    ims, lbs = [], []
    for c in cats:
        lb = rng.integers(0, c, (b, hw[0] // 4, hw[1] // 4))
        lb = np.repeat(np.repeat(lb, 4, 1), 4, 2)
        lb[rng.random(lb.shape) < ignore] = 255
        ims.append(rng.integers(0, 256, (b, *hw, 3)).astype(np.uint8))
        lbs.append(lb.astype(np.uint8))
    return {"ims": ims, "lbs": lbs}


def nchw(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).permute(0, 3, 1, 2).to(dtype)


def nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU work in one thread (tier-1's xdist workers share the
    cores; see tests/torch_eval_parity.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FeatureSeg:
    """Stands in for JAX's SemsegModel inside JAX's AlternatingTrainer, so
    that JAX's own GNN step (its `_gnn_step`, with its Gumbel draws, its
    single adversarial backward and its optimizers) runs on fixed features
    without compiling the seg net: `apply(..., method=features)` returns
    `buffers["feats"]`."""

    def __init__(self, configer):
        g = lambda *k, d=None: configer.get(*k, default=d)
        self.cats = [configer.n_cats(i) for i in range(configer.n_datasets)]
        self.with_datasets_aux = bool(g("loss", "with_datasets_aux", d=False))
        self.output_feat_dim = int(g("GNN", "output_feat_dim", d=512))
        self.max_num_unify_class = int(float(g("GNN", "unify_ratio", d=1.0)) * sum(self.cats))

    @classmethod
    def from_configer(cls, configer, dtype=None):
        return cls(configer)

    def features(self, *a, **kw):  # the method handle JAX's step passes
        raise AssertionError("FeatureSeg.features runs only through apply")

    def init(self, rngs, xs, train=True):
        M, D = self.max_num_unify_class, self.output_feat_dim
        params = {"unify_prototype": jnp.zeros((M, D))}
        if self.with_datasets_aux:
            params.update({f"aux_prototype_{i}": jnp.zeros((c, D))
                           for i, c in enumerate(self.cats)})
        return {"params": params, "batch_stats": {},
                "buffers": {f"bi_graph_{i}": jnp.zeros((c, M)) for i, c in enumerate(self.cats)}}

    def apply(self, variables, xs, train=False, method=None, mutable=None):
        return variables["buffers"]["feats"]


def feature_trainers(cfg, nf):
    """(JAX's AlternatingTrainer of `cfg` with FeatureSeg for its seg net,
    its flax inits under jit and its OHEM on the exact rule; the port's
    AlternatingTrainer of `cfg` on the CPU holding JAX's GNN parameters
    and GNN AdamW state), both on node features `nf`."""
    from mds_tpu.engine import gnn_trainer as jgt
    from mds_tpu_torch.deploy.weights import gnn_optimizer_state_from_jax
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
    from mds_tpu_torch.engine.optim import load_optimizer_state

    jcfg, tcfg = configers(cfg)
    init = fnn.Module.init
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Module, "init", lambda self, rngs, *a, **kw: jax.jit(
        lambda r: init(self, r, *a, **kw))(rngs))
    mp.setattr(jgt, "SemsegModel", FeatureSeg)
    try:
        jt = jgt.AlternatingTrainer(jcfg, node_features=nf)
    finally:
        mp.undo()
    jt.criterion.ohem.exact = jt.criterion.mds_ohem.exact = True
    tt = AlternatingTrainer(tcfg, node_features=nf, device="cpu")
    tt.gnn_model.load_state_dict(bgnn_state_dict_from_jax(_np(jt.gnn_state.params)),
                                 strict=True)
    load_optimizer_state(tt.gnn_model, tt.gnn_opt,
                         gnn_optimizer_state_from_jax(_np(jt.gnn_state.opt_state)))
    return jt, tt


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def gnn_batch(rng, cats=CATS, b=1, hw=(8, 8), d=16, ignore=0.05):
    """Fixed seg features (b, h, w, d) of each dataset and labels at ×4."""
    feats, lbs = [], []
    for c in cats:
        feats.append(rng.normal(0, 1, (b, *hw, d)).astype(np.float32))
        lb = rng.integers(0, c, (b, 4 * hw[0], 4 * hw[1]))
        lb[rng.random(lb.shape) < ignore] = 255
        lbs.append(lb.astype(np.uint8))
    return feats, lbs


def jax_gumbel_noise(step, cats, M):
    """The Gumbel noise of JAX's GNN step `step` at its default rng
    (PRNGKey(0), folded with the step, then with 7; one key a dataset)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), step), 7), len(cats))
    tiny = jnp.finfo(jnp.float32).tiny
    return [np.array(-jnp.log(-jnp.log(jax.random.uniform(
        k, (c, M), minval=tiny, maxval=1.0)))) for k, c in zip(keys, cats)]


def gnn_step_pair(jt, tt, feats, lbs, max_rate=0.0, tau=10.0, lr_scale=1.0):
    """One GNN step in both packages from the same state: JAX's jitted
    `_gnn_step` and the port's `gnn_update` on the same features, labels,
    τ and (with GNN.GumbelSoftmax) JAX's Gumbel noise. → (JAX's metrics as
    floats, the port's)."""
    step = int(jt.gnn_state.step)
    ims = [np.zeros((f.shape[0], 4, 4, 3), np.uint8) for f in feats]
    jt.gnn_state, jm = jt._gnn_step(
        jt.gnn_state, jt.seg_state, {"feats": [jnp.asarray(f) for f in feats]},
        jt.node_features, [jnp.asarray(x) for x in ims], [jnp.asarray(x) for x in lbs],
        jax.random.PRNGKey(0), jnp.float32(max_rate), jnp.float32(tau), jnp.float32(lr_scale))
    noise = None
    if tt.gumbel:
        noise = [torch.from_numpy(z) for z in jax_gumbel_noise(step, tt.dataset_cats, tt.M)]
    tt.gnn_lr_scale = lr_scale
    tm = tt.gnn_update([nchw(f) for f in feats], [torch.from_numpy(x) for x in lbs],
                       None, max_rate, tau, noise)
    return ({k: float(v) for k, v in jm.items()},
            {k: float(v.detach()) for k, v in tm.items()})


def attn_scale(name, tensors):
    """The magnitude a tensor's error is measured over: its own largest, and
    for a GAT layer's attention vector (or its gradient's moments) the
    larger of that and its layer weight's. The attention's exact gradient
    is zero wherever the LeakyReLU is linear: a₁·h_i shifts a whole softmax
    row, and so does a₂·h_j on a row of positive logits. At test size the
    f64 gradients of layers 1-3 are 5e-8, 1e-17 and 1e-18 against about 1
    for their weights, and both packages' f32 values are rounding noise
    there (off the f64 one by 2.6e-3 to 4.7e8 in JAX, 3.5e-2 to 7.1e8 in
    the port); layer 0's, 5e-2, is held alone."""
    mag = float(np.abs(np.asarray(tensors[name])).max())
    if ".attn" in name:  # gcn_layers.i.attn, its moments "…/mu", "…/nu"
        mag = max(mag, float(np.abs(np.asarray(tensors[name.replace(".attn", ".weight")])).max()))
    return mag


def gnn_state_errors(jt, tt):
    """Per tensor of the graph net (parameters, AdamW moments; a moment the
    port lacks counts as zero): the max-diff of the port's against JAX's
    after a step over `attn_scale`; and whether the step counts agree."""
    from mds_tpu_torch.deploy.weights import gnn_optimizer_state_from_jax
    from mds_tpu_torch.engine.optim import optimizer_state

    want_p = bgnn_state_dict_from_jax(_np(jt.gnn_state.params))
    want_o = gnn_optimizer_state_from_jax(_np(jt.gnn_state.opt_state))
    got_p = tt.gnn_model.state_dict()
    got_o = optimizer_state(tt.gnn_model, tt.gnn_opt)
    want = {k: w.numpy() for k, w in want_p.items()}
    got = {k: got_p[k].numpy() for k in want}
    for name, st in want_o["state"].items():
        for m in ("mu", "nu"):
            want[f"{name}/{m}"] = st[m].numpy()
            got[f"{name}/{m}"] = got_o["state"].get(name, {}).get(
                m, torch.zeros_like(st[m])).numpy()
    out = {}
    for k, w in want.items():
        diff = float(np.abs(got[k].astype(np.float64) - w).max())
        mag = attn_scale(k, want)
        out[k] = diff / mag if mag else diff
    return out, got_o["count"] == want_o["count"]


# ------------------------------------ the whole trainer, step by step
# (tests/test_torch_gnn_trainer.py's docstring sets out the gates)
TOL = 1e-4
# parameters whose exact SEG-step gradient is zero
ZERO_GRAD = ("backbone.layer4.0.bn2.", "backbone.layer4.0.downsample.1.bias")


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


def port_from(nf, cfg, snap, dtype=torch.float32):
    """A port trainer holding JAX's state `snap` (computing in `dtype`)."""
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

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


def jax_trainer(cfg, nf):
    """JAX's AlternatingTrainer of `cfg` on node features `nf`: its eager
    flax inits put under jit, its CLIP import stubbed, its OHEM on the
    exact rule, the seg net's BN made non-trivial (`randomize`, seed 0)."""
    from mds_tpu.data import node_features as jnf
    from mds_tpu.engine.gnn_trainer import AlternatingTrainer as JT

    jcfg, _ = configers(cfg)
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
    return jt


def seg_step_check(nf, cfg, pre, b, post):
    """One port SEG step on batch `b` from JAX's state `pre`, held to JAX's
    `post`: each tensor within TOL of JAX's, or within twice JAX's own
    distance from the exact step (the port's in f64 from the same state),
    or within JAX's worst tensor's; the port's worst within twice JAX's
    worst; the stage machine equal. → (the port trainer, its seg
    state_dict before the step)."""
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
    return tt, before
