"""The contrast family's loss pieces, port against JAX on the CPU.

- `ClassRemap` on configs/bisenetv2_contrast_3ds.json: every dataset's
  parsed remap, its single-mapping LUT and a label map remapped through
  it against JAX's `SingleSegRemapping`, exact.
- `hard_anchor_sample` with the noise JAX draws for the same key: the
  anchors and the valid flags exact, classes of 0, 2, 3, 9 and many pixels
  (a class with fewer pixels than n_view fills up as XLA's top_k does).
- `contrastive_loss`: value and gradient wrt the anchors, rel <= 1e-5.
- `memory_bank_push` over 7 pushes of a bank of M = 3 (every queue wraps),
  exact: feats, ptr, count. The features are multiples of 1/8 below 4 and
  each class has 0, 1, 2, 4 or 8 pixels, so that every sum, mean and sum
  of squares is exact in f32 whatever its order, and both sides' norms
  and quotients are the same correctly rounded numbers.
- `PixelContrastLoss` on (B, D, h, w) features with JAX's key: value and
  gradient wrt the features, rel <= 1e-5.
- `ema_update` on a BiSeNetV2Contrast's state (parameters and BN stats)
  against JAX's on its variables: rel <= 1e-6; num_batches_tracked stays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mds_tpu.config import Configer as JConfiger
from mds_tpu.data.class_remap import ClassRemap as JClassRemap
from mds_tpu.engine.ema import ema_update as j_ema_update
from mds_tpu.losses import contrast as jc
from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.class_remap import ClassRemap
from mds_tpu_torch.deploy.weights import bisenetv2_contrast_state_dict_from_jax
from mds_tpu_torch.engine.ema import ema_update
from mds_tpu_torch.losses import contrast as tc
from mds_tpu_torch.models.bisenetv2_contrast import BiSeNetV2Contrast
from torch_contrast_parity import CONTRAST_3DS, contrast_variables, jax_noise
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import rel_err


def test_class_remap_matches_jax():
    jr, tr = JClassRemap(JConfiger(config_file=CONTRAST_3DS)), ClassRemap(
        Configer(config_file=CONTRAST_3DS))
    assert tr.remapList == jr.remapList
    rng = np.random.default_rng(0)
    for i, n in enumerate((19, 11, 36)):
        lut = tr.single_lut(i)
        assert lut.dtype == torch.int64
        np.testing.assert_array_equal(lut.numpy(), jr._single_luts[i])
        lb = rng.integers(0, n + 1, (2, 8, 12)).astype(np.uint8)
        lb[0, 0, :3] = 255
        np.testing.assert_array_equal(lut[torch.from_numpy(lb).long()].numpy(),
                                      jr.SingleSegRemapping(lb, i))


def _pixels(rng, C, counts, P, D):
    """Labels with `counts[c]` pixels of class c (the rest ignore 255),
    predictions right on about half, L2-normalized features."""
    labels = np.full(P, 255, np.int32)
    pos = rng.permutation(P)
    start = 0
    for c, n in enumerate(counts):
        labels[pos[start:start + n]] = c
        start += n
    preds = np.where(rng.random(P) < 0.5, labels, rng.integers(0, C, P)).astype(np.int32)
    f = rng.normal(0, 1, (P, D)).astype(np.float32)
    return labels, preds, f / np.linalg.norm(f, axis=1, keepdims=True)


def test_hard_anchor_sample_matches_jax():
    rng = np.random.default_rng(1)
    C, P, D, V = 6, 200, 8, 16
    labels, preds, feats = _pixels(rng, C, (0, 2, 3, 9, 60, 100), P, D)
    key = jax.random.PRNGKey(5)
    want_a, want_v = jc.hard_anchor_sample(jnp.asarray(feats), jnp.asarray(labels),
                                           jnp.asarray(preds), C, V, key)
    got_a, got_v = tc.hard_anchor_sample(
        torch.from_numpy(feats), torch.from_numpy(labels), torch.from_numpy(preds),
        torch.from_numpy(jax_noise(key, C, P)), V)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.tolist() == [False, False, True, True, True, True]
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_contrastive_loss_value_and_grad():
    rng = np.random.default_rng(2)
    C, V, M, D = 5, 4, 3, 8
    anchors = rng.normal(0, 1, (C, V, D)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=-1, keepdims=True)
    memory = rng.normal(0, 1, (C, M, D)).astype(np.float32)
    memory /= np.linalg.norm(memory, axis=-1, keepdims=True)
    valid = np.array([True, False, True, True, False])
    want, want_g = jax.value_and_grad(
        lambda a: jc.contrastive_loss(a, jnp.asarray(valid), jnp.asarray(memory)))(
        jnp.asarray(anchors))
    a = torch.from_numpy(anchors).requires_grad_(True)
    got = tc.contrastive_loss(a, torch.from_numpy(valid), torch.from_numpy(memory))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert rel_err(a.grad.numpy(), want_g) <= 1e-5


def test_memory_bank_push_wraps_exactly():
    rng = np.random.default_rng(3)
    C, M, D = 5, 3, 6
    jbank = jc.MemoryBank.create(C, M, D)
    tbank = tc.MemoryBank.create(C, M, D)
    np.testing.assert_array_equal(tbank.feats.numpy(), np.asarray(jbank.feats))
    for k in range(7):
        # 0, 1, 2, 4 or 8 pixels a class (0: the class keeps its queue), 3
        # ignored and one of an id outside the classes, shuffled
        counts = rng.choice([0, 1, 2, 4, 8], C, p=[0.1, 0.2, 0.2, 0.25, 0.25])
        counts[k % C] = 0
        labels = np.concatenate([np.repeat(np.arange(C), counts), [255] * 3, [200]])
        labels = labels[rng.permutation(len(labels))]
        feats = (rng.integers(-31, 32, (len(labels), D)) / 8.0).astype(np.float32)
        jbank = jc.memory_bank_push(jbank, jnp.asarray(feats), jnp.asarray(labels), None)
        tbank = tc.memory_bank_push(tbank, torch.from_numpy(feats), torch.from_numpy(labels))
        np.testing.assert_array_equal(tbank.feats.numpy(), np.asarray(jbank.feats))
        np.testing.assert_array_equal(tbank.ptr.numpy(), np.asarray(jbank.ptr))
        np.testing.assert_array_equal(tbank.count.numpy(), np.asarray(jbank.count))
    assert (tbank.count.numpy() == M).all()  # every queue has wrapped


def test_pixel_contrast_loss_value_and_grad():
    rng = np.random.default_rng(4)
    B, h, w, D, C = 2, 6, 8, 16, 6
    labels = rng.integers(0, C, (B, h, w))
    labels[0, :2] = 255
    preds = np.where(rng.random((B, h, w)) < 0.6, labels % C, rng.integers(0, C, (B, h, w)))
    feats = rng.normal(0, 1, (B, h, w, D)).astype(np.float32)
    bank = jc.MemoryBank.create(C, 4, D)
    for _ in range(3):
        f = rng.normal(0, 1, (B * h * w, D)).astype(np.float32)
        bank = jc.memory_bank_push(bank, jnp.asarray(f), jnp.asarray(labels.reshape(-1)), None)
    key = jax.random.PRNGKey(11)
    loss = jc.PixelContrastLoss()
    want, want_g = jax.value_and_grad(lambda f: loss(f, jnp.asarray(labels), jnp.asarray(preds),
                                                     bank, key))(jnp.asarray(feats))
    tbank = tc.MemoryBank(*(torch.from_numpy(np.array(t)) for t in bank))
    x = torch.from_numpy(feats).permute(0, 3, 1, 2).requires_grad_(True)
    got = tc.PixelContrastLoss()(x, torch.from_numpy(labels), torch.from_numpy(preds), tbank,
                                 torch.from_numpy(jax_noise(key, C, B * h * w)))
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    assert rel_err(x.grad.permute(0, 2, 3, 1).numpy(), want_g) <= 1e-5


def test_ema_update_matches_jax():
    kw = dict(num_unify_classes=6, datasets_cats=(3, 4), n_bn=2, proj_dim=16)
    t, s = contrast_variables(0, **kw), contrast_variables(1, **kw)
    want = jax.tree_util.tree_map(np.asarray, j_ema_update(t, s, 0.9))
    teacher = BiSeNetV2Contrast(6, (3, 4), n_bn=2, proj_dim=16)
    student = BiSeNetV2Contrast(6, (3, 4), n_bn=2, proj_dim=16)
    teacher.load_state_dict(bisenetv2_contrast_state_dict_from_jax(t["params"],
                                                                   t["batch_stats"]))
    student.load_state_dict(bisenetv2_contrast_state_dict_from_jax(s["params"],
                                                                   s["batch_stats"]))
    ema_update(teacher, student, 0.9)
    ref = bisenetv2_contrast_state_dict_from_jax(want["params"], want["batch_stats"])
    for k, v in teacher.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 0
        else:
            assert rel_err(v.numpy(), ref[k].numpy()) <= 1e-6, k
