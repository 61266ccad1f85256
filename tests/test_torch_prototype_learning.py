"""The multi-prototype pieces of the contrast family against JAX's on the
CPU: ops/prototype_learning.py (`grouped_sinkhorn`, `hard_assignment`,
`prototype_learning`; mds_tpu/ops/prototype_learning.py) and
data/class_remap.py's `ClassRemapOneHotLabel` (mds_tpu/data/
class_remap.py:136-291) with the rest of `ClassRemap`.

Inputs from numpy seeds: unit-norm prototypes (K classes × P slots × D),
unit-norm embeddings, ground truth with ignored pixels, a correct mask.
`prototype_learning` runs with `noise=None` (JAX's rng=None) and with
JAX's own Gumbel draw of a key handed to the port as noise: the logits,
the targets (exactly) and the prototypes rel ≤ 1e-5. The masks of
`ContrastRemapping` (the contrast mask and the seg mask) are equal to
JAX's on the tiny contrast config's remaps, at P = 1 and 3, early and late
in the keep-share anneal, on similarities JAX's einsum gives.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.data.class_remap as jcr
import mds_tpu.ops.prototype_learning as jpl
import mds_tpu_torch.ops.prototype_learning as tpl
from mds_tpu.config import Configer as JConfiger
from mds_tpu_torch.config import Configer
from mds_tpu_torch.data.class_remap import ClassRemap, ClassRemapOneHotLabel
from torch_contrast_parity import tiny_contrast_config

TOL = 1e-5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(seed, K=6, P=4, D=16, N=300):
    rng = np.random.default_rng(seed)
    protos = _unit(rng.normal(0, 1, (K, P, D)))
    emb = _unit(rng.normal(0, 1, (N, D)))
    gt = rng.integers(0, K, N)
    gt[rng.random(N) < 0.1] = 255
    gt[:5] = 2  # one class certain to be there, the last one absent
    gt[gt == K - 1] = 0
    correct = rng.random(N) < 0.7
    return protos, emb, gt.astype(np.int32), correct


def _jax_gumbel(key, shape):
    u = jax.random.uniform(key, shape, jnp.float32, 1e-20, 1.0)
    return np.array(-jnp.log(-jnp.log(u) + 1e-20))


@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_prototype_learning_matches_jax(seed, noisy):
    protos, emb, gt, correct = _inputs(seed)
    key = jax.random.PRNGKey(seed + 5) if noisy else None
    want = jpl.prototype_learning(jnp.asarray(protos), jnp.asarray(emb), jnp.asarray(gt),
                                  jnp.asarray(correct), coefficient=0.9, rng=key)
    noise = torch.from_numpy(_jax_gumbel(key, (len(gt), protos.shape[1]))) if noisy else None
    got = tpl.prototype_learning(torch.from_numpy(protos), torch.from_numpy(emb),
                                 torch.from_numpy(gt).long(), torch.from_numpy(correct),
                                 coefficient=0.9, noise=noise)
    assert rel(got.proto_logits.numpy(), want.proto_logits) <= TOL
    np.testing.assert_array_equal(got.proto_target.numpy(), np.asarray(want.proto_target))
    assert rel(got.prototypes.numpy(), want.prototypes) <= TOL
    moved = np.abs(got.prototypes.numpy() - protos).max(axis=-1) > 0
    assert moved[:-1].any() and not moved[-1].any()


def test_grouped_sinkhorn_and_hard_assignment_match_jax():
    protos, emb, gt, _ = _inputs(3, N=200)
    rng = np.random.default_rng(3)
    scores = rng.normal(0, 0.3, (len(gt), 4)).astype(np.float32)
    valid = gt < 6
    seg = np.where(valid, gt, 0)
    jq, jidx = jpl.grouped_sinkhorn(jnp.asarray(scores), jnp.asarray(seg), 6,
                                    jnp.asarray(valid))
    tq, tidx = tpl.grouped_sinkhorn(torch.from_numpy(scores), torch.from_numpy(seg).long(), 6,
                                    torch.from_numpy(valid))
    assert rel(tq.numpy(), jq) <= TOL
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    # the plan ends on the pixels: each valid row sums to 1, the rest 0
    np.testing.assert_allclose(tq.numpy().sum(1), valid.astype(np.float32), rtol=1e-5)
    key = jax.random.PRNGKey(9)
    want = jpl.hard_assignment(jq, rng=key)
    got = tpl.hard_assignment(tq, torch.from_numpy(_jax_gumbel(key, tq.shape)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpl.hard_assignment(tq).numpy(),
                                  np.asarray(jpl.hard_assignment(jq)))
    g = tpl.gumbel_noise((1000, 4), torch.Generator().manual_seed(0))
    assert torch.isfinite(g).all() and abs(float(g.mean()) - 0.5772) < 0.1


def _remaps(P, thresh=0.0, max_iter=6):
    cfg = tiny_contrast_config()
    cfg["contrast"].update({"num_prototype": P, "update_sim_thresh": thresh})
    cfg["lr"]["max_iter"] = max_iter
    return (jcr.ClassRemapOneHotLabel(JConfiger(configs=copy.deepcopy(cfg))),
            ClassRemapOneHotLabel(Configer(configs=copy.deepcopy(cfg))))


@pytest.mark.parametrize("P,cur_iter", [(1, 0), (3, 1), (3, 5)])
@pytest.mark.parametrize("ds", [0, 1])
def test_contrast_remapping_masks_match_jax(P, cur_iter, ds):
    jr, tr = _remaps(P)
    rng = np.random.default_rng(10 * P + cur_iter + ds)
    n_cats = (5, 7)[ds]
    lb = rng.integers(0, n_cats, (2, 6, 5))
    lb = np.repeat(np.repeat(lb, 8, 1), 8, 2)[:, :45, :38]  # ragged, ÷8 rounds up
    lb[rng.random(lb.shape) < 0.05] = 255
    sim = rng.uniform(-1, 1, (2, 6, 5, 8 * P)).astype(np.float32)
    jcm, jseg = jr.ContrastRemapping(jnp.asarray(lb), None, None, ds, cur_iter=cur_iter,
                                     sim=jnp.asarray(sim))
    tcm, tseg = tr.ContrastRemapping(torch.from_numpy(lb), torch.from_numpy(sim), ds,
                                     cur_iter=cur_iter)
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(tseg.numpy(), np.asarray(jseg))
    assert tseg.shape == (2, 45, 38, 8)
    # the anneal: at iteration 0 each slot keeps its single most similar
    # confident pixel, so at most one sharpened multi-mapped pixel a slot
    multi = tr._is_multi[ds][lb[:, ::8, ::8]]
    sharpened = int((tcm.numpy()[multi].sum(-1) == 1).sum())
    if cur_iter == 0:
        assert sharpened <= 8 * P


def test_remap_tables_match_jax():
    jr, tr = _remaps(2)
    assert tr.remapList == jr.remapList and tr.num_unify_classes == 8
    for ds in range(2):
        for name in ("_single_onehot", "_multi_only_hot", "_is_multi"):
            np.testing.assert_array_equal(getattr(tr, name)[ds], getattr(jr, name)[ds], name)
        np.testing.assert_array_equal(tr.single_lut(ds).numpy(), jr._single_luts[ds])
    assert isinstance(tr, ClassRemap)
