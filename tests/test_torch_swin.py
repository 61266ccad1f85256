"""The port's Swin-T and BiSeNetV1-Swin (mds_tpu_torch/models/swin.py)
against JAX's (mds_tpu/models/swin.py) on the CPU at f32.

- window_partition / window_reverse, relative_position_index and
  shift_attn_mask equal to JAX's;
- WindowAttention with and without the shift mask, SwinBlock at shift 0
  and 1, PatchMerging (its quadrant order read at the LayerNorm's input:
  (even row, even col), (odd, even), (even, odd), (odd, odd)), a small
  SwinTransformer (embed 16, window 2, depths 2-2-2-2, 64×64), each on
  JAX's weights (its init, LayerNorm affines and biases drawn from a numpy
  seed);
- BiSeNetV1Swin at (1, 3, 224, 224): the train call with its aux heads,
  the BN running stats after it, and eval_logits;
- swin_from_torch: a reference-layout state dict (norm0 and the
  relative_position_index / attn_mask buffers included) through JAX's
  importer and JAX's forward, and through the port's loader and forward; at
  Swin-T's size, grafted into BiSeNetV1Swin.swin, the tensors JAX's
  importer gives.

Gate: rel ≤ 1e-4 (max-diff over the reference's largest magnitude).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import nchw, nhwc, one_torch_thread, randomize, rel  # noqa: F401
from mds_tpu_torch.deploy.weights import (
    bisenetv1_swin_state_dict_from_jax,
    detect_torch_layout,
    load_reference_weights,
    swin_from_torch,
    swin_to_torch,
)
from mds_tpu_torch.models import swin as ts

F32 = 1e-4
SMALL = dict(embed_dim=16, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=2)


def _init(jm, seed, *args, **kw):
    v = jax.jit(lambda k, *a: jm.init(k, *a, **kw))(jax.random.PRNGKey(0), *args)
    return randomize(jax.tree_util.tree_map(np.asarray, dict(v)), np.random.default_rng(seed))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_window_functions_match_jax():
    from mds_tpu.models import swin as js

    x = np.random.default_rng(0).normal(0, 1, (2, 14, 28, 8)).astype(np.float32)
    w = ts.window_partition(torch.from_numpy(x), 7)
    assert np.array_equal(w.numpy(), np.asarray(js.window_partition(jnp.asarray(x), 7)))
    assert np.array_equal(ts.window_reverse(w, 7, 14, 28).numpy(), x)
    for ws in (2, 7):
        assert np.array_equal(ts.relative_position_index(ws).numpy(),
                              js.relative_position_index(ws))
    for h, w_, ws, s in ((14, 14, 7, 3), (8, 16, 2, 1), (56, 56, 7, 3)):
        assert np.array_equal(ts.shift_attn_mask(h, w_, ws, s).numpy(),
                              js.shift_attn_mask(h, w_, ws, s))


def _attn_state(p, prefix=""):
    return {f"{prefix}qkv.weight": _t(p["qkv"]["kernel"].T), f"{prefix}qkv.bias": _t(p["qkv"]["bias"]),
            f"{prefix}proj.weight": _t(p["proj"]["kernel"].T),
            f"{prefix}proj.bias": _t(p["proj"]["bias"]),
            f"{prefix}relative_position_bias_table": _t(p["relative_position_bias_table"])}


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_matches_jax(masked):
    from mds_tpu.models import swin as js

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (8, 4, 16)).astype(np.float32)  # 2 images × 4 windows of 2×2
    mask = js.shift_attn_mask(4, 4, 2, 1) if masked else None
    jm = js.WindowAttention(16, 2, 2)
    v = _init(jm, 2, x, mask)
    want = jm.apply(v, x, mask)
    tm = ts.WindowAttention(16, 2, 2)
    tm.load_state_dict(_attn_state(v["params"]), strict=True)
    got = tm(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert rel(got.detach().numpy(), np.asarray(want)) <= F32


def _ln(p):
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"])}


def _block_state(p):
    sd = _attn_state(p["attn"], "attn.")
    for n in ("norm1", "norm2"):
        sd.update({f"{n}.{k}": t for k, t in _ln(p[n]).items()})
    for n in ("fc1", "fc2"):
        sd[f"mlp.{n}.weight"] = _t(p[n]["kernel"].T)
        sd[f"mlp.{n}.bias"] = _t(p[n]["bias"])
    return sd


@pytest.mark.parametrize("shift", [0, 1])
def test_swin_block_matches_jax(shift):
    from mds_tpu.models import swin as js

    x = np.random.default_rng(3).normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    jm = js.SwinBlock(16, 2, window_size=2, shift=shift)
    v = _init(jm, 4, x)
    tm = ts.SwinBlock(16, 2, window_size=2, shift=shift)
    tm.load_state_dict(_block_state(v["params"]), strict=True)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert rel(got, np.asarray(jm.apply(v, x))) <= F32


def test_patch_merging_matches_jax_and_its_quadrant_order(monkeypatch):
    from mds_tpu.models import swin as js

    x = np.random.default_rng(5).normal(0, 1, (2, 8, 12, 6)).astype(np.float32)
    jm = js.PatchMerging(6)
    v = _init(jm, 6, x)
    tm = ts.PatchMerging(6)
    tm.load_state_dict({**{f"norm.{k}": t for k, t in _ln(v["params"]["norm"]).items()},
                        "reduction.weight": _t(v["params"]["reduction"]["kernel"].T)},
                       strict=True)
    seen = []
    real = ts.layer_norm
    monkeypatch.setattr(ts, "layer_norm", lambda n, t, d: seen.append(t) or real(n, t, d))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert rel(got, np.asarray(jm.apply(v, x))) <= F32
    (cat,) = seen
    assert cat.shape == (2, 4, 6, 24)
    for q, (dy, dx) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        assert np.array_equal(cat[..., q * 6:(q + 1) * 6].numpy(), x[:, dy::2, dx::2, :])


def test_small_swin_transformer_matches_jax():
    from mds_tpu.models import swin as js

    x = np.random.default_rng(7).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = js.SwinTransformer(**SMALL)
    v = _init(jm, 8, x)
    want = jax.jit(jm.apply)(v, x)
    tm = ts.SwinTransformer(**SMALL)
    tm.load_state_dict({k: _t(a) for k, a in swin_to_torch(v["params"]).items()}, strict=True)
    got = tm(nchw(x))
    for g, w, c, s in zip(got, want, (32, 64, 128), (8, 4, 2)):
        assert tuple(g.shape) == (2, c, s, s)
        assert rel(nhwc(g), np.asarray(w)) <= F32


@pytest.fixture(scope="module")
def v1_swin():
    """JAX's BiSeNetV1Swin at 224×224 and its variables; in one jit its
    train call (aux heads on) with the new BN stats and its eval logits."""
    from mds_tpu.models.swin import BiSeNetV1Swin as J

    x = np.random.default_rng(9).normal(0, 1, (1, 224, 224, 3)).astype(np.float32)
    jm = J(n_classes=(5,), aux=True, dtype=jnp.float32)
    v = _init(jm, 10, [x], train=True)

    def run(v, x):
        out, mut = jm.apply(v, [x], train=True, mutable=["batch_stats"])
        return out, mut, jm.apply(v, x, method=jm.eval_logits)

    return x, v, jax.tree_util.tree_map(np.asarray, jax.jit(run)(
        jax.tree_util.tree_map(jnp.asarray, v), x))


def test_bisenetv1_swin_matches_jax(v1_swin):
    x, v, (out, mut, logits) = v1_swin
    tm = ts.BiSeNetV1Swin(n_classes=(5,), aux=True)
    tm.load_state_dict(bisenetv1_swin_state_dict_from_jax(v["params"], v["batch_stats"]),
                       strict=True)
    with torch.no_grad():
        got = tm.train()([nchw(x)])
        assert rel(nhwc(got["logits"][0]), out["logits"][0]) <= F32
        assert len(got["aux"]) == 2
        for g, w in zip(got["aux"], out["aux"]):
            assert tuple(g[0].shape) == (1, 5, 224, 224)
            assert rel(nhwc(g[0]), w[0]) <= F32
        want = bisenetv1_swin_state_dict_from_jax(v["params"], mut["batch_stats"])
        stats = [k for k in want if "running" in k]
        assert len(stats) == 2 * 16  # every BN of the model
        for k in stats:
            assert rel(tm.state_dict()[k].numpy(), want[k].numpy()) <= F32, k
        tm.load_state_dict(bisenetv1_swin_state_dict_from_jax(v["params"], v["batch_stats"]))
        ev = tm.eval().eval_logits(nchw(x))
    assert tuple(ev.shape) == (1, 5, 224, 224)
    assert rel(nhwc(ev), logits) <= F32


def reference_swin_state(tm, rng):
    """A reference-layout Swin state dict for the port's trunk `tm`: its
    keys with `out_norm{s}` as `norm{s}`, plus norm0 and the buffers the
    port does not read."""
    sd = {}
    for k, t in tm.state_dict().items():
        k = k.replace("out_norm", "norm")
        sd[k] = rng.normal(1.0 if k.endswith("norm.weight") or ".norm" in k and k.endswith(
            ".weight") else 0.0, 0.2, tuple(t.shape)).astype(np.float32)
    sd["norm0.weight"] = np.ones(tm.patch_embed.norm.weight.shape, np.float32)
    sd["norm0.bias"] = np.zeros(tm.patch_embed.norm.weight.shape, np.float32)
    sd["layers.0.blocks.0.attn.relative_position_index"] = np.zeros((4, 4), np.int64)
    sd["layers.0.blocks.1.attn_mask"] = np.zeros((16, 4, 4), np.float32)
    return sd


def test_swin_from_torch_matches_jax_importer():
    from mds_tpu.deploy.torch_import import swin_from_torch as j_swin_from_torch
    from mds_tpu.models.swin import SwinTransformer as JS

    rng = np.random.default_rng(11)
    tm = ts.SwinTransformer(**SMALL)
    sd = reference_swin_state(tm, rng)
    assert detect_torch_layout(sd) == "swin"
    params = j_swin_from_torch(sd)
    assert {k: _t(a) for k, a in swin_to_torch(params).items()}.keys() == swin_from_torch(sd).keys()
    load_reference_weights(tm, {k: torch.from_numpy(np.asarray(a)) for k, a in sd.items()})
    x = rng.normal(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = jax.jit(JS(**SMALL).apply)({"params": jax.tree_util.tree_map(jnp.asarray, params)}, x)
    for g, w in zip(tm(nchw(x)), want):
        assert rel(nhwc(g), np.asarray(w)) <= F32

    # Swin-T's size, grafted into BiSeNetV1Swin.swin: the tensors JAX's
    # importer gives, the rest of the model left as it was
    model = ts.BiSeNetV1Swin(n_classes=(5,), aux=False)
    rest = {k: t.clone() for k, t in model.state_dict().items() if not k.startswith("swin.")}
    sd = reference_swin_state(model.swin, rng)
    load_reference_weights(model, sd)
    want = swin_to_torch(j_swin_from_torch(sd), "swin.")
    got = {k: t for k, t in model.state_dict().items() if k.startswith("swin.")}
    assert got.keys() == want.keys()
    for k, a in want.items():
        assert np.array_equal(got[k].numpy(), a), k
    assert all(torch.equal(model.state_dict()[k], t) for k, t in rest.items())
