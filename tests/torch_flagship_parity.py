"""Shared helpers of the flagship's parity tests (tests/test_torch_swiftnet.py,
test_torch_semseg.py, test_torch_gnn.py, test_torch_cross_datasets.py,
test_torch_gnn_trainer.py): a tiny snp_rn18 + BGNN config for both
packages, JAX variables made non-trivial from a numpy seed, their port
counterparts, batches.

The tiny config keeps the flagship's structure (3 pyramid levels, the
direct-adjacency BGNN with 4 GSAGE layers, aux prototypes, unify_ratio 0.8
so that M < Σ n_cats) at small widths: ResNet layers [1, 1, 1, 1], planes
[64, 16, 24, 32] (kernel 6 takes planes[0] = 64), 16 features, nfeat 32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu_torch.deploy.weights import bgnn_state_dict_from_jax, semseg_state_dict_from_jax

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
