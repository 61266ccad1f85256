"""BiSeNetV2Contrast, port against JAX on the CPU.

The model at n_bn = 2, 6 unified classes, datasets of 3 and 4 classes,
proj_dim 16, per-dataset aux heads on, f32, at (4, 64, 64) a dataset; the
port's seeded init carried into JAX by its own importer, BN randomized,
and back by deploy/weights.py, loaded strictly; dropout off on both sides (JAX's FastDropout stubbed, the port's
rate 0). One jit computes JAX's train forward, eval_logits and emb_logits.

- train mode: `seg` (unified logits at full size), `embed` (L2-normalized
  at 1/8), the 4 `aux` heads, `dataset_aux`, and the updated BN stats, rel
  <= 1e-4;
- eval: `eval_logits` (align_corners=True upsample inside the head) and
  `emb_logits` with (U, 2, D) prototypes, rel <= 1e-4;
- `_wn`: JAX's `wn_cls` holds no parameters (set up, never called), so its
  `_wn` model has the base model's variables; every registered name of
  the port builds the base model's state dict from the 3-dataset config,
  and `WNClassifier` alone matches JAX's, rel <= 1e-5;
- the reference-layout importer (`load_contrast_reference`) round-trips a
  state_dict in the port's own names (the reference's layout), with the
  reference's `proj.weight` form, a `prototypes` buffer, a dead `head.conv1`
  and extra keys; it refuses a state_dict without the trunk.
The bf16 deploy routes: tests/test_torch_contrast_routes.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.models import bisenetv2_contrast as jbc
from mds_tpu_torch import MODELS
from mds_tpu_torch.config import Configer
from mds_tpu_torch.deploy.weights import (
    bisenetv2_contrast_state_dict_from_jax,
    detect_torch_layout,
    load_contrast_reference,
)
from mds_tpu_torch.models.bisenetv2_contrast import BiSeNetV2Contrast, WNClassifier
from torch_contrast_parity import CONTRAST_3DS, contrast_variables, no_jax_contrast_dropout
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import nchw, nhwc, no_port_dropout, rel_err

U, CATS, N_BN, PROJ, B, HW = 6, (3, 4), 2, 16, 4, (64, 64)
KW = dict(num_unify_classes=U, datasets_cats=CATS, n_bn=N_BN, proj_dim=PROJ,
          with_dataset_aux_heads=True)


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    no_jax_contrast_dropout(mp)
    try:
        jm = jbc.BiSeNetV2Contrast(**KW)
        v = contrast_variables(3, **KW)
        rng = np.random.default_rng(4)
        # 4 images a dataset, each of its own brightness and contrast: the
        # CEBlock's pooled BN over few images of like statistics divides by
        # a near-zero spread (at 2 images, on JAX's own init, both
        # packages' f32 lay 4-7e-4 off the f64 result)
        gain = np.asarray([0.4, 0.8, 1.2, 1.6]).reshape(B, 1, 1, 1)
        offset = np.asarray([-0.9, -0.3, 0.3, 0.9]).reshape(B, 1, 1, 1)
        xs = [(rng.normal(0, 1, (B, *HW, 3)) * gain + offset).astype(np.float32)
              for _ in range(N_BN)]
        protos = rng.normal(0, 1, (U, 2, PROJ)).astype(np.float32)
        protos /= np.linalg.norm(protos, axis=-1, keepdims=True)

        def run(v, xs, protos):
            out, mut = jm.apply(v, xs, train=True, mutable=["batch_stats"])
            return (out, mut["batch_stats"],
                    jm.apply(v, xs[1], dataset=1, method=jm.eval_logits),
                    jm.apply(v, xs[0], dataset=0, prototypes=protos, method=jm.emb_logits))

        want = jax.tree_util.tree_map(np.asarray, jax.jit(run)(v, xs, protos))
    finally:
        mp.undo()
    return v, xs, protos, want


def port_model(v, **kw):
    """The port's model with JAX's variables, loaded strictly, dropout off."""
    tm = BiSeNetV2Contrast(**{**KW, **kw})
    tm.load_state_dict(bisenetv2_contrast_state_dict_from_jax(v["params"], v["batch_stats"]))
    return no_port_dropout(tm)


def test_train_outputs_match_jax(runs):
    v, xs, _, (out, stats, _, _) = runs
    tm = port_model(v).train()
    with torch.no_grad():
        got = tm([nchw(x) for x in xs])
    assert set(got) == set(out) == {"seg", "embed", "aux", "dataset_aux"}
    for i in range(N_BN):
        assert tuple(got["seg"][i].shape) == (B, U, *HW)
        assert tuple(got["embed"][i].shape) == (B, PROJ, HW[0] // 8, HW[1] // 8)
        assert rel_err(nhwc(got["seg"][i]), out["seg"][i]) <= 1e-4
        assert rel_err(nhwc(got["embed"][i]), out["embed"][i]) <= 1e-4
        norms = got["embed"][i].norm(dim=1)
        assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
        for a, b in zip(got["aux"], out["aux"]):
            assert a[i].shape[2:] == HW
            assert rel_err(nhwc(a[i]), b[i]) <= 1e-4
        assert tuple(got["dataset_aux"][i].shape) == (B, CATS[i], *HW)
        assert rel_err(nhwc(got["dataset_aux"][i]), out["dataset_aux"][i]) <= 1e-4
    want = bisenetv2_contrast_state_dict_from_jax(v["params"], stats)
    for k, b in tm.state_dict().items():
        if "running" in k:
            assert rel_err(b.numpy(), want[k].numpy()) <= 1e-4, k


def test_eval_and_emb_logits_match_jax(runs):
    v, xs, protos, (_, _, eval_want, emb_want) = runs
    tm = port_model(v).eval()
    with torch.no_grad():
        got = tm.eval_logits(nchw(xs[1]), dataset=1)
        emb = tm.emb_logits(nchw(xs[0]), dataset=0, prototypes=torch.from_numpy(protos))
        tm.prototypes = torch.from_numpy(protos)  # the eval bundle's form
        emb_own = tm.emb_logits(nchw(xs[0]), dataset=0)
    assert tuple(got.shape) == (B, U, *HW)
    assert rel_err(nhwc(got), eval_want) <= 1e-4
    assert tuple(emb.shape) == (B, U, HW[0] // 8, HW[1] // 8) and emb.dtype == torch.float32
    assert rel_err(nhwc(emb), emb_want) <= 1e-4
    assert torch.equal(emb, emb_own)
    assert torch.equal(tm.pred(nchw(xs[1]), 1), got.argmax(1))


def test_wn_variant_and_classifier():
    wn = jbc.bisenetv2_contrast_wn(configer=_configer())
    base = jbc.bisenetv2_contrast(configer=_configer())
    x = [jnp.zeros((1, 32, 32, 3))] * 3
    shapes = [jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
        lambda k, m=m: m.init(k, x, train=True), jax.random.PRNGKey(0))) for m in (wn, base)]
    assert shapes[0] == shapes[1]  # JAX's wn_cls is never called: no parameters
    cfg = Configer(config_file=CONTRAST_3DS)
    base_shapes = None
    for name in ("bisenetv2_contrast", "bisenetv2_contrast_wn", "bisenetv2_contrast_bn",
                 "bisenetv2_contrast_ema"):
        m = MODELS[name](configer=cfg)
        assert (m.num_unify_classes, m.n_bn, m.proj_dim) == (46, 3, 256)
        shapes = {k: tuple(t.shape) for k, t in m.state_dict().items()}
        base_shapes = base_shapes or shapes
        assert shapes == base_shapes

    rng = np.random.default_rng(5)
    feat = rng.normal(0, 1, (2, 5, 6, 12)).astype(np.float32)
    jw = jbc.WNClassifier(7)
    wv = jw.init(jax.random.PRNGKey(0), jnp.asarray(feat))
    want = np.asarray(jw.apply(wv, jnp.asarray(feat)))
    tw = WNClassifier(12, 7)
    with torch.no_grad():
        tw.weight.copy_(torch.from_numpy(np.array(wv["params"]["kernel"])))
        got = tw(nchw(feat))
    assert rel_err(nhwc(got), want) <= 1e-5


def _configer():
    from mds_tpu.config import Configer as JConfiger

    return JConfiger(configs={"n_datasets": 3, "num_unify_classes": 46,
                              "dataset1": {"n_cats": 19}, "dataset2": {"n_cats": 11},
                              "dataset3": {"n_cats": 36}})


def test_reference_importer_round_trip(runs):
    v = runs[0]
    src = port_model(v)
    sd = {k: t.clone() for k, t in src.state_dict().items()}
    assert detect_torch_layout(sd) == "bisenetv2_contrast"
    # the reference's other forms: a plain proj weight, the prototypes
    # buffer, an aux=False head's dead conv1 and a key the port lacks
    sd["aux3.proj.weight"] = sd.pop("aux3.proj.conv.weight")
    sd["prototypes"] = torch.ones(U, 3, PROJ)
    sd["head.conv1.conv.weight"] = torch.zeros(1)
    sd["domain_cls.weight"] = torch.zeros(1)
    dst = BiSeNetV2Contrast(**KW)
    extras = load_contrast_reference(dst, sd)
    assert extras["prototypes"].shape == (U, 3, PROJ)
    for k, t in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], t), k
    # without the aux heads: still loads; without the trunk: refused
    no_aux = {k: t for k, t in src.state_dict().items() if not k.startswith("aux")}
    load_contrast_reference(BiSeNetV2Contrast(**KW), no_aux)
    with pytest.raises(KeyError, match="lacks"):
        load_contrast_reference(BiSeNetV2Contrast(**KW), {
            k: t for k, t in no_aux.items() if not k.startswith("detail.")})


def test_param_groups_match_jax(runs):
    """Each parameter's SGD group: lr×10 by JAX's _path_has_head (the unified
    head, the 4 aux heads and the projection head: `proj_head`, the port's
    `projHead`), weight decay by its _is_wd_kernel, through the weights'
    own mapping of JAX's tree to the port's names."""
    from mds_tpu.engine.optim import _is_wd_kernel, _path_has_head
    from mds_tpu_torch.engine.optim import sgd_param_groups
    from torch_parity import group_names

    v = runs[0]
    tm = port_model(v)
    groups = group_names(tm, sgd_param_groups(tm, lambda _: 0.0))
    codes = {"wd": 0.0, "nowd": 1.0, "head_wd": 2.0, "head_nowd": 3.0}
    coded = jax.tree_util.tree_map_with_path(
        lambda path, x: np.full(np.shape(x), codes[
            ("head_" if _path_has_head(path) else "")
            + ("wd" if _is_wd_kernel(path, x) else "nowd")], np.float32), v["params"])
    mapped = bisenetv2_contrast_state_dict_from_jax(coded, v["batch_stats"])
    names = {c: n for n, c in codes.items()}
    assert {k: names[float(t.flatten()[0])] for k, t in mapped.items() if k in groups} == groups
    assert groups["projHead.conv_last.weight"] == "head_wd"
    assert groups["dataset_aux_head.0.proj.conv.weight"] == "wd"
