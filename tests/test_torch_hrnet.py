"""The port's HRNet-W48 (mds_tpu_torch/models/hrnet.py) against JAX's
(mds_tpu/models/hrnet.py) on the CPU at f32, at tests/test_hrnet.py's
TINY_STAGES (every transition, branch, module and fusion of the real
stage dicts at widths 4-32) on 64×64 inputs, 2 datasets.

JAX's variables (its init, BN statistics, affines and graphs drawn from a
numpy seed) load into the port strictly through
deploy/weights.py `hrnet_state_dict_from_jax`. Gate: rel ≤ 1e-4 (max-diff
over the reference's largest magnitude) for the backbone's branches with
both datasets and with one absent, the train call's seg, feat and aux,
every running stat after it and eval_logits of each dataset; pred's labels
agree on ≥ 0.999 of the pixels (an f32 near-tie may flip one); the gradient
of a scalar of the train outputs with respect to every parameter at 1e-4
against JAX's f32 gradient, or within twice JAX's own f32 distance from
JAX's f64 gradient (the test's docstring says why); the port's f64
gradient equals JAX's f64 gradient at 1e-9.
`from_configer` on configs/hrnet_w48_city.json and
configs/gnn_city_cam_a2d2.json gives JAX's M, D and n_bn.
"""

import concurrent.futures
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_hrnet import TINY_STAGES
from torch_flagship_parity import nchw, nhwc, one_torch_thread, randomize, rel  # noqa: F401
from mds_tpu_torch.deploy.weights import hrnet_state_dict_from_jax
from mds_tpu_torch.models.hrnet import HRNetBackbone, HRNetW48

F32 = 1e-4
F64 = 1e-9
CATS = (3, 4)
D = 16


def jax_model(dtype=jnp.float32):
    from mds_tpu.models.hrnet import HRNetW48 as J

    return J(datasets_cats=CATS, output_feat_dim=D, unify_ratio=0.8, with_datasets_aux=True,
             n_bn=2, stages=TINY_STAGES, dtype=dtype)


def train_grads(jm, v, xs, w):
    """(outputs, new batch_stats, gradient of Σ w·out over every output
    with respect to the params) of JAX's train call."""
    def loss(params):
        out, mut = jm.apply({**v, "params": params}, xs, train=True, mutable=["batch_stats"])
        s = sum(jnp.sum(o * wo) for k in out for o, wo in zip(out[k], w[k]))
        return s, (out, mut)

    (_, (out, mut)), grads = jax.value_and_grad(loss, has_aux=True)(v["params"])
    return out, mut, grads


def _weights(shapes, rng):
    """Fixed random weights for each train output (the scalar's)."""
    return {k: [rng.normal(0, 1, s).astype(np.float32) for s in ss] for k, ss in shapes.items()}


@contextlib.contextmanager
def at_f64():
    """JAX in f64 end to end: x64, and the f32 of layers.py's BN moments
    and resize and of semseg.py's prototype products read as f64 (as
    tests/test_torch_eval_precise_bn.py's `at_f64` does)."""
    import mds_tpu.models.hrnet as jh
    import mds_tpu.models.layers as jl
    import mds_tpu.models.semseg as js

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.float32 = jnp.float64
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        for mod in (jl, js, jh):
            mp.setattr(mod, "jnp", proxy)
        yield


def _as(dtype, tree):
    return jax.tree_util.tree_map(lambda a: None if a is None else
                                  jax.ShapeDtypeStruct(a.shape, dtype), tree,
                                  is_leaf=lambda a: a is None)


@pytest.fixture(scope="module")
def jax_all():
    """JAX's variables (its init, randomized from seed 1, as numpy), and
    JAX's backbone branches (eval, both datasets and the first alone), the
    train call on both datasets with its new stats and the gradient of
    Σ w·out over every output, eval_logits and pred of each dataset; and
    the same gradient in f64 (JAX's exact one). XLA's compile of the train
    graph takes 20-30 s on the CPU, so each jit compiles in a thread while
    the next one traces."""
    from mds_tpu.models.hrnet import HRNetBackbone as JB

    jm, jb = jax_model(), JB(stages=TINY_STAGES, n_bn=2)
    xs0 = [jnp.zeros((1, 64, 64, 3))] * 2
    init = jax.jit(lambda k: jm.init(k, xs0, train=True))
    key = jax.random.PRNGKey(0)
    vs = jax.eval_shape(init, key)
    rng = np.random.default_rng(2)
    xs = [rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32) for _ in CATS]
    x = rng.normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    m = vs["params"]["unify_prototype"].shape[0]
    w = _weights({"seg": [(2, 16, 16, m)] * 2, "feat": [(2, 16, 16, D)] * 2,
                  "aux": [(2, 16, 16, c) for c in CATS]}, rng)

    def branches(v, xs):
        bb = {"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]}
        return {"both": jb.apply(bb, xs, train=False),
                "first": jb.apply(bb, [xs[0], None], train=False)}

    def ev(v, x):
        return {ds: (jm.apply(v, x, ds, method=jm.eval_logits), jm.apply(v, x, ds, method=jm.pred))
                for ds in range(2)}

    # XLA compiles in a pool while the next jit traces: the two gradients
    # first, the f64 one with XLA's cheaper passes (its rounding is f64's)
    pool = concurrent.futures.ThreadPoolExecutor(5)
    submit = lambda lo, **o: pool.submit(lo.compile, compiler_options=o)  # noqa: E731
    train = submit(jax.jit(lambda v, xs, w: train_grads(jm, v, xs, w)).lower(
        *_as(jnp.float32, (vs, xs, w))))
    with at_f64():
        jm64 = jax_model(jnp.float64)
        grads64 = submit(jax.jit(lambda v, xs, w: train_grads(jm64, v, xs, w)[2]).lower(
            *_as(jnp.float64, (vs, xs, w))), xla_backend_optimization_level=0,
            xla_llvm_disable_expensive_passes=True)
    branches = submit(jax.jit(branches).lower(*_as(jnp.float32, (vs, xs))))
    ev = submit(jax.jit(ev).lower(*_as(jnp.float32, (vs, x))))
    init = submit(init.lower(key))
    with pool:
        init, branches, train, ev, grads64 = (f.result() for f in
                                              (init, branches, train, ev, grads64))
    v = randomize(jax.tree_util.tree_map(np.asarray, dict(init(key))), np.random.default_rng(1))
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: None if a is None else np.asarray(a), t, is_leaf=lambda a: a is None)
    got = to_np((branches(v, xs), *train(v, xs, w), ev(v, x)))
    with jax.enable_x64(True):
        to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: None if a is None else np.asarray(a, np.float64), t,
            is_leaf=lambda a: a is None)
        g64 = to_np(grads64(to64(v), to64(xs), to64(w)))
    assert all(g.dtype == np.float64 for g in jax.tree_util.tree_leaves(g64))
    return jm, v, (xs, x, w, got), g64


@pytest.fixture(scope="module")
def pair(jax_all):
    """JAX's model and variables, the port's holding them."""
    jm, v, _, _ = jax_all
    tm = HRNetW48(CATS, D, 0.8, True, n_bn=2, stages=TINY_STAGES)
    tm.load_state_dict(hrnet_state_dict_from_jax(v["params"], v["batch_stats"], v["buffers"]),
                       strict=True)
    return jm, v, tm


@pytest.fixture(scope="module")
def jax_run(jax_all):
    return jax_all[2]


@pytest.fixture(scope="module")
def jax_grads_f64(jax_all):
    return jax_all[3]


def as_port_f64(grads, v):
    """JAX's f64 gradient under the port's keys, in f64: the loader casts
    to f32, so its high and low f32 parts go through it apart."""
    hi = jax.tree_util.tree_map(lambda a: a.astype(np.float32), grads)
    lo = jax.tree_util.tree_map(lambda a, h: (a - h).astype(np.float32), grads, hi)
    hi, lo = (hrnet_state_dict_from_jax(t, v["batch_stats"], v["buffers"]) for t in (hi, lo))
    return {k: hi[k].double() + lo[k].double() for k in hi}


@pytest.mark.parametrize("which", ["both", "first"])
def test_backbone_matches_jax(pair, jax_run, which):
    _, v, tm = pair
    xs, _, _, (branches, *_) = jax_run
    bb = HRNetBackbone(TINY_STAGES, n_bn=2)
    bb.load_state_dict({k[len("backbone."):]: t for k, t in tm.state_dict().items()
                        if k.startswith("backbone.")}, strict=True)
    ins = [nchw(a) for a in xs] if which == "both" else [nchw(xs[0]), None]
    with torch.no_grad():
        got = bb.eval()(ins)
    assert len(got) == 4
    for i, (g, want) in enumerate(zip(got, branches[which])):
        for ds in range(2):
            if which == "first" and ds == 1:
                assert g[ds] is None and want[ds] is None
                continue
            c = TINY_STAGES["stage4"]["num_channels"][i]
            assert tuple(g[ds].shape) == (2, c, 16 >> i, 16 >> i)
            assert rel(nhwc(g[ds]), want[ds]) <= F32, (i, ds)


def test_train_outputs_stats_and_gradients_match_jax(pair, jax_run, jax_grads_f64):
    """The train call's outputs and running stats at rel ≤ 1e-4. Each
    parameter's f32 gradient at rel ≤ 1e-4 from JAX's f32 gradient, or
    else within twice JAX's own f32 distance from JAX's exact (f64)
    gradient: the deepest branch's BNs see 8 values a channel here, and
    the stem's affine gradient, summed through every BN's backward, parts
    by up to 3e-3 between the two f32 runs. The port's f64 gradient equals
    JAX's f64 gradient at rel ≤ 1e-9, so every parameter is held against
    JAX, and none only against the port."""
    _, v, tm = pair
    xs, _, w, (_, out, mut, grads, _) = jax_run
    runs = []
    for dtype in (torch.float32, torch.float64):
        m = HRNetW48(CATS, D, 0.8, True, n_bn=2, stages=TINY_STAGES, dtype=dtype)
        m.load_state_dict(tm.state_dict(), strict=True)
        m.to(dtype).train()
        got = m([nchw(a).to(dtype) for a in xs])
        s = sum((got[k][ds] * nchw(w[k][ds]).to(dtype)).sum() for k in got for ds in range(2))
        s.backward()
        runs.append((m, got))
    (m, got), (exact, _) = runs
    assert set(got) == set(out) == {"seg", "feat", "aux"}
    for k in got:
        for ds in range(2):
            assert rel(nhwc(got[k][ds]), out[k][ds]) <= F32, (k, ds)
    # the running stats after the step
    want_sd = hrnet_state_dict_from_jax(v["params"], mut["batch_stats"], v["buffers"])
    stats = [k for k in want_sd if "running" in k]
    assert len(stats) > 100
    for k in stats:
        assert rel(m.state_dict()[k].numpy(), want_sd[k].numpy()) <= F32, k
    # every parameter's gradient
    want_g = hrnet_state_dict_from_jax(grads, v["batch_stats"], v["buffers"])
    exact_g = as_port_f64(jax_grads_f64, v)
    named, f64 = dict(m.named_parameters()), dict(exact.named_parameters())
    assert set(named) == {k for k in want_g if "running" not in k
                          and not k.startswith("bipartite_graphs")}
    bad, bad64 = {}, {}
    for k, p in named.items():
        g, j, e = p.grad.double().numpy(), want_g[k].double().numpy(), exact_g[k].numpy()
        r_pj, r_p, r_j = rel(g, j), rel(g, e), rel(j, e)
        if not (r_pj <= F32 or r_p <= 2 * r_j):
            bad[k] = (r_pj, r_p, r_j)
        if rel(f64[k].grad.numpy(), e) > F64:
            bad64[k] = rel(f64[k].grad.numpy(), e)
    assert not bad, bad
    assert not bad64, bad64


@pytest.mark.parametrize("ds", [0, 1])
def test_eval_logits_and_pred_match_jax(pair, jax_run, ds):
    _, _, tm = pair
    _, x, _, (*_, ev) = jax_run
    logits, pred = ev[ds]
    with torch.no_grad():
        got = tm.eval().eval_logits(nchw(x), ds)
        got_pred = tm.pred(nchw(x), ds).numpy()
    assert tuple(got.shape) == (2, CATS[ds], 16, 16)
    assert rel(nhwc(got), logits) <= F32
    assert got_pred.shape == pred.shape == (2, 64, 64)
    assert (got_pred == pred).mean() >= 0.999


@pytest.mark.parametrize("config", ["configs/hrnet_w48_city.json",
                                    "configs/gnn_city_cam_a2d2.json"])
def test_from_configer_matches_jax(config):
    """M, D, n_bn, aux prototypes and the graphs' shapes from the config,
    at the model's full width (no forward)."""
    from mds_tpu.config import Configer as JConfiger
    from mds_tpu.models.hrnet import HRNetW48 as J
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer

    jcfg, tcfg = JConfiger(config_file=config), Configer(config_file=config)
    jm = J.from_configer(jcfg)
    tm = MODELS[tcfg.get("model_name")](configer=tcfg)
    assert isinstance(tm, HRNetW48)
    assert tm.max_num_unify_class == jm.max_num_unify_class
    assert tm.output_feat_dim == jm.output_feat_dim and tm.n_bn == jm.n_bn
    assert tm.datasets_cats == tuple(jm.datasets_cats)
    assert len(tm.backbone.conv1.bn) == jm.n_bn
    assert tm.with_datasets_aux == jm.with_datasets_aux
    assert tm.proj_head.conv1.conv.in_channels == 720
    assert [tuple(tm.bipartite_graphs[i].shape) for i in range(len(tm.datasets_cats))] == [
        (c, jm.max_num_unify_class) for c in jm.datasets_cats]
