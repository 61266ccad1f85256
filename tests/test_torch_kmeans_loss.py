"""The port's ClassRemap tables and the k-means-era cross-dataset loss
(mds_tpu_torch/data/class_remap.py, mds_tpu_torch/losses/
cross_datasets_kmeans.py) against JAX's (mds_tpu/data/class_remap.py,
mds_tpu/losses/cross_datasets_kmeans.py) on the CPU.

- The three tables the k-means loss reads, of every dataset of
  configs/bisenetv2_contrast_3ds.json, read at all 256 label bytes:
  SingleSegRemapping, SingleSegRemappingOneHot and SegRemappingOneHot,
  equal to JAX's.
- CrossDatasetsCELossKMeans on tests/test_losses.py:282's setup (2
  datasets, 6 unified classes, one class mapped to two), in warmup and in
  the main phase, with and without the aux heads and at P = 2 (with a
  bank of U·P rows, the shape JAX's prototype refresh takes): the loss
  and its metrics (rel ≤ 1e-4), the bank (feats rel ≤ 1e-4, ptr and count
  equal), the prototypes (rel ≤ 1e-4), and the gradient to the seg logits,
  the aux logits and the embeddings (rel ≤ 1e-4).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import one_torch_thread, rel  # noqa: F401

F32 = 1e-4
CONTRAST_CONFIG = "configs/bisenetv2_contrast_3ds.json"


def _configers(cfg=None, overrides=()):
    from mds_tpu.config import Configer as JC
    from mds_tpu_torch.config import Configer as TC

    if cfg is not None:
        return JC(configs=copy.deepcopy(cfg)), TC(configs=copy.deepcopy(cfg))
    return (JC(config_file=CONTRAST_CONFIG, args_parser=list(overrides)),
            TC(config_file=CONTRAST_CONFIG, args_parser=list(overrides)))


def test_class_remap_tables_match_jax():
    from mds_tpu.data.class_remap import ClassRemapOneHotLabel as J
    from mds_tpu_torch.data.class_remap import ClassRemapOneHotLabel as T

    jc, tc = _configers()
    jr, tr = J(jc), T(tc)
    labels = np.arange(256).reshape(1, 16, 16)
    jl, tl = jnp.asarray(labels), torch.from_numpy(labels)
    assert tr.remapList == jr.remapList and tr.num_unify_classes == jr.num_unify_classes == 46
    for i in range(3):
        pairs = [(tr.SingleSegRemapping(tl, i), jr.SingleSegRemapping(jl, i)),
                 (tr.SingleSegRemappingOneHot(tl, i), jr.SingleSegRemappingOneHot(jl, i)),
                 (tr.SegRemappingOneHot(tl, i), jr.SegRemappingOneHot(jl, i))]
        for k, (a, b) in enumerate(pairs):
            b = np.asarray(b)
            assert a.shape == b.shape and np.array_equal(a.numpy(), b), (i, k)


CFG = {
    "n_datasets": 2,
    "num_unify_classes": 6,
    "dataset1": {"n_cats": 3}, "dataset2": {"n_cats": 4},
    "loss": {"ignore_index": 255, "reweight": False, "aux_weight": 0.4},
    "contrast": {"num_prototype": 1, "coefficient": 0.9, "loss_weight": 0.5,
                 "use_contrast": True, "update_sim_thresh": 0.3, "temperature": 0.07},
    "network": {"stride": 2},
    "lr": {"max_iter": 10},
    "class_remap1": {"0": [0], "1": [1, 2], "2": [3]},
    "class_remap2": {"0": [0], "1": [4], "2": [5], "3": [1]},
}


def _inputs(P, aux):
    """tests/test_losses.py:305-320's inputs (its seed and shapes), with
    5% of the labels ignored, aux heads at half the seg logits' size."""
    rng = np.random.default_rng(0)
    Bt, H, W, D, U = 1, 8, 8, 4, 6
    lbs = [rng.integers(0, 3, (Bt, H, W)), rng.integers(0, 4, (Bt, H, W))]
    for lb in lbs:
        lb[rng.random(lb.shape) < 0.05] = 255
    seg = [rng.normal(0, 1, (Bt, H, W, U)).astype(np.float32) for _ in range(2)]
    emb = [rng.normal(0, 1, (Bt, H // 2, W // 2, D)).astype(np.float32) for _ in range(2)]
    emb = [e / np.linalg.norm(e, axis=-1, keepdims=True) for e in emb]
    protos = rng.normal(0, 1, (U * P, D)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
    auxs = [[rng.normal(0, 1, (Bt, H // 2, W // 2, U)).astype(np.float32) for _ in range(2)]
            ] if aux else []
    return lbs, seg, emb, auxs, protos


def _t(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2).contiguous().requires_grad_(True)


@pytest.mark.parametrize("P,aux", [(1, False), (1, True), (2, True)])
def test_kmeans_loss_matches_jax_in_warmup_and_main_phase(P, aux):
    from mds_tpu.losses.contrast import MemoryBank as JBank
    from mds_tpu.losses.cross_datasets_kmeans import CrossDatasetsCELossKMeans as J
    from mds_tpu_torch.losses.contrast import MemoryBank as TBank
    from mds_tpu_torch.losses.cross_datasets_kmeans import CrossDatasetsCELossKMeans as T

    cfg = copy.deepcopy(CFG)
    cfg["contrast"]["num_prototype"] = P
    jc, tc = _configers(cfg)
    jcrit, tcrit = J(jc), T(tc)
    lbs, seg, emb, auxs, protos = _inputs(P, aux)
    # the refresh mixes each bank row into the prototype of the same row:
    # JAX's needs a bank of U·P rows (the pushes fill the first U)
    jbank, tbank = JBank.create(6 * P, 4, 4), TBank.create(6 * P, 4, 4)
    jp, tp = jnp.asarray(protos), torch.from_numpy(protos)
    for warm, it in ((True, 0), (True, 1), (False, 5), (False, 9)):
        def jloss(seg, emb, auxs):
            loss, m, bank, p = jcrit({"seg": seg, "embed": emb, "aux": auxs},
                                     [jnp.asarray(lb) for lb in lbs], jbank, jp,
                                     is_warmup=warm, cur_iter=it)
            return loss, (m, bank, p)

        (jv, (jm, jbank, jp)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
            [jnp.asarray(s) for s in seg], [jnp.asarray(e) for e in emb],
            [[jnp.asarray(a) for a in s] for s in auxs])
        ts, te = [_t(s) for s in seg], [_t(e) for e in emb]
        ta = [[_t(a) for a in s] for s in auxs]
        tv, tm, tbank, tp = tcrit({"seg": ts, "embed": te, "aux": ta},
                                  [torch.from_numpy(lb) for lb in lbs], tbank, tp,
                                  is_warmup=warm, cur_iter=it)
        tv.backward()
        step = (warm, it)
        for k in ("loss", "seg_loss", "contrast_loss"):
            assert abs(tm[k].item() - float(jm[k])) <= F32 * max(abs(float(jm[k])), 1e-30), step
        assert (tm["contrast_loss"].item() == 0.0) == warm
        assert np.array_equal(tbank.ptr.numpy(), np.asarray(jbank.ptr)), step
        assert np.array_equal(tbank.count.numpy(), np.asarray(jbank.count)), step
        assert rel(tbank.feats.numpy(), np.asarray(jbank.feats)) <= F32, step
        assert rel(tp.numpy(), np.asarray(jp)) <= F32, step
        grads = [(t, j) for ts_, js_ in ((ts, jg[0]), (te, jg[1])) for t, j in zip(ts_, js_)]
        grads += [(t, j) for s, js_ in zip(ta, jg[2]) for t, j in zip(s, js_)]
        for t, j in grads:
            want = np.asarray(j)
            if t.grad is None:  # the embeddings in warmup: pushed detached only
                assert warm and not want.any(), step
                continue
            assert rel(t.grad.permute(0, 2, 3, 1).numpy(), want) <= F32, step
    assert int(np.asarray(jbank.count).sum()) > 0
