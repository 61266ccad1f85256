"""The port's loss library and k-means (mds_tpu_torch/losses/{rmi,lovasz,aaf,
fs}.py, mds_tpu_torch/ops/kmeans.py) against JAX's (mds_tpu/losses/*.py,
mds_tpu/ops/kmeans.py) on the CPU at f32: each function's value and its
gradient with respect to the logits (AAF's also to its per-class,
per-size weights; soft-DTW's to the costs and the sequences), on
continuous logits (Lovász's sort has no ties to break) with 5% of the
labels ignored. k-means runs from JAX's own initial indices (its
jax.random.choice of the same key): centers and assignment.

Gate: rel ≤ 1e-4 (max-diff over the reference's largest magnitude) for
values, gradients and centers; the assignments and the label helpers'
maps equal. FSOhemCELoss is held against JAX's with its OHEM in the exact
mode (`exact=True`), the port's only mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_flagship_parity import one_torch_thread, rel  # noqa: F401

F32 = 1e-4
B, C, H, W = 2, 5, 24, 24


def _data(seed=0, c=C, h=H, w=W, scale=2.0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(0, scale, (B, h, w, c))).astype(np.float32)
    lb = rng.integers(0, c, (B, h, w))
    lb[rng.random(lb.shape) < 0.05] = 255
    return logits, lb.astype(np.int64), rng


def _pair(jloss, tloss, logits_nhwc, *extra_j, extra_t=()):
    """(JAX value, grad NHWC), (port value, grad NHWC) of a loss of the
    logits."""
    jv, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(logits_nhwc), *extra_j)
    t = torch.from_numpy(logits_nhwc).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    tv = tloss(t, *extra_t)
    tv.backward()
    return (float(jv), np.asarray(jg)), (tv.item(), t.grad.permute(0, 2, 3, 1).numpy())


def _close(j, t):
    (jv, jg), (tv, tg) = j, t
    assert abs(tv - jv) <= F32 * max(abs(jv), 1e-30), (tv, jv)
    assert rel(tg, jg) <= F32


@pytest.mark.parametrize("pool_way", [0, 1, 2])
def test_rmi_loss_matches_jax(pool_way):
    from mds_tpu.losses.rmi import rmi_loss as j
    from mds_tpu_torch.losses.rmi import rmi_loss as t

    logits, lb, _ = _data(1)
    _close(*_pair(lambda x: j(x, jnp.asarray(lb), C, pool_way=pool_way),
                  lambda x: t(x, torch.from_numpy(lb), C, pool_way=pool_way), logits))


def test_rmi_pairs_and_log_det_match_jax():
    from mds_tpu.losses import rmi as j
    from mds_tpu_torch.losses import rmi as t

    rng = np.random.default_rng(2)
    la, pr = rng.random((2, 9, 10, 3)).astype(np.float32), rng.random((2, 9, 10, 3)).astype(np.float32)
    jl, jp = j.map_get_pairs(jnp.asarray(la), jnp.asarray(pr), 3)
    tl, tp = t.map_get_pairs(torch.from_numpy(la).permute(0, 3, 1, 2),
                             torch.from_numpy(pr).permute(0, 3, 1, 2), 3)
    assert np.array_equal(tl.numpy(), np.asarray(jl)) and np.array_equal(tp.numpy(), np.asarray(jp))
    a = rng.normal(0, 1, (4, 9, 9)).astype(np.float32)
    spd = a @ a.transpose(0, 2, 1) + 0.1 * np.eye(9, dtype=np.float32)
    assert rel(t.log_det_by_cholesky(torch.from_numpy(spd)).numpy(),
               np.asarray(j.log_det_by_cholesky(jnp.asarray(spd)))) <= F32


@pytest.mark.parametrize("classes", ["present", "all"])
def test_lovasz_softmax_matches_jax(classes):
    from mds_tpu.losses.lovasz import lovasz_softmax as j
    from mds_tpu_torch.losses.lovasz import lovasz_softmax as t

    logits, lb, _ = _data(3)
    lb[lb == 4] = 0  # one class absent: "present" leaves it out
    _close(*_pair(lambda x: j(x, jnp.asarray(lb), classes=classes),
                  lambda x: t(x, torch.from_numpy(lb), classes=classes), logits))


def test_boundary_aware_focal_loss_matches_jax():
    from mds_tpu.losses.lovasz import boundary_aware_focal_loss as j
    from mds_tpu_torch.losses.lovasz import boundary_aware_focal_loss as t

    logits, lb, rng = _data(4)
    alphas = np.where(lb == 255, 0.0, rng.uniform(0, 2, lb.shape)).astype(np.float32)
    alphas[rng.random(lb.shape) < 0.3] = 0.0
    _close(*_pair(lambda x: j(x, jnp.asarray(lb), jnp.asarray(alphas)),
                  lambda x: t(x, torch.from_numpy(lb), torch.from_numpy(alphas)), logits))


def test_eight_corner_matches_jax():
    from mds_tpu.losses.aaf import eight_corner as j
    from mds_tpu_torch.losses.aaf import eight_corner as t

    x = np.random.default_rng(5).normal(0, 1, (2, 7, 9, 3)).astype(np.float32)
    for size in (1, 2, 3):
        assert np.array_equal(t(torch.from_numpy(x), size, 255.0).numpy(),
                              np.asarray(j(jnp.asarray(x), size, 255.0)))


@pytest.mark.parametrize("weights", [False, True])
def test_aaf_loss_matches_jax(weights):
    """The value and the gradients to the logits and, with the weights
    passed in, to the (C, 3) edge and not-edge weights."""
    from mds_tpu.losses.aaf import AAFLoss as J
    from mds_tpu_torch.losses.aaf import AAFLoss as T

    logits, lb, rng = _data(6, h=16, w=16)
    lb = np.repeat(np.repeat(lb[:, ::4, ::4], 4, 1), 4, 2)  # blocks: edges and not-edges
    jl, tl = J(C), T(C)
    if not weights:
        _close(*_pair(lambda x: jl(x, jnp.asarray(lb)),
                      lambda x: tl(x, torch.from_numpy(lb)), logits))
        return
    we, wn = (rng.normal(0, 1, (C, 3)).astype(np.float32) for _ in range(2))
    jv, jg = jax.jit(jax.value_and_grad(lambda x, a, b: jl(x, jnp.asarray(lb), a, b),
                                        argnums=(0, 1, 2)))(jnp.asarray(logits), we, wn)
    with torch.no_grad():
        tl.w_edge.copy_(torch.from_numpy(we))
        tl.w_not_edge.copy_(torch.from_numpy(wn))
    x = torch.from_numpy(logits).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    tv = tl(x, torch.from_numpy(lb))
    tv.backward()
    assert abs(tv.item() - float(jv)) <= F32 * abs(float(jv))
    assert rel(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg[0])) <= F32
    assert rel(tl.w_edge.grad.numpy(), np.asarray(jg[1])) <= F32
    assert rel(tl.w_not_edge.grad.numpy(), np.asarray(jg[2])) <= F32


def test_fs_ce_and_fs_wrappers_match_jax():
    """fs_ce with and without class weights on labels at twice the logits'
    size (the nearest rescale), FSCELoss on a weighted list, FSAuxCELoss,
    FSOhemCELoss (exact), FSRMILoss, FSAuxRMILoss and FSCELOVASZLoss."""
    from mds_tpu.losses import fs as j
    from mds_tpu_torch.losses import fs as t

    logits, _, rng = _data(7)
    aux = rng.normal(0, 2, logits.shape).astype(np.float32)
    lb = rng.integers(0, C, (B, 2 * H, 2 * W))
    lb[rng.random(lb.shape) < 0.05] = 255
    cw = rng.uniform(0.5, 2.0, C).astype(np.float32).tolist()
    jlb, tlb = jnp.asarray(lb), torch.from_numpy(lb)
    joh = j.FSOhemCELoss(thresh=0.7)
    joh._ohem.exact = True
    cases = {
        "fs_ce": (lambda x: j.fs_ce(x, jlb), lambda x: t.fs_ce(x, tlb)),
        "fs_ce_weighted": (lambda x: j.fs_ce(x, jlb, cw), lambda x: t.fs_ce(x, tlb, cw)),
        "FSCELoss_list": (lambda x: j.FSCELoss()([x, x * 0.5], jlb, [1.0, 0.4]),
                          lambda x: t.FSCELoss()([x, x * 0.5], tlb, [1.0, 0.4])),
        "FSAuxCELoss": (lambda x: j.FSAuxCELoss()((jnp.asarray(aux) + x, x), jlb),
                        lambda x: t.FSAuxCELoss()((_nchw(aux) + x, x), tlb)),
        "FSOhemCELoss": (lambda x: joh(x, jlb), lambda x: t.FSOhemCELoss(thresh=0.7)(x, tlb)),
        "FSRMILoss": (lambda x: j.FSRMILoss()(x, jlb), lambda x: t.FSRMILoss()(x, tlb)),
        "FSAuxRMILoss": (lambda x: j.FSAuxRMILoss()((jnp.asarray(aux) * x, x), jlb),
                         lambda x: t.FSAuxRMILoss()((_nchw(aux) * x, x), tlb)),
        "FSCELOVASZLoss": (lambda x: j.FSCELOVASZLoss()(x, jlb),
                           lambda x: t.FSCELOVASZLoss()(x, tlb)),
    }
    for name, (jf, tf) in cases.items():
        try:
            _close(*_pair(jf, tf, logits))
        except AssertionError as e:
            raise AssertionError(name) from e


def _nchw(a):
    return torch.from_numpy(np.asarray(a)).permute(0, 3, 1, 2)


def test_segfix_loss_and_label_helpers_match_jax():
    from mds_tpu.losses import fs as j
    from mds_tpu_torch.losses import fs as t

    rng = np.random.default_rng(8)
    seg = rng.integers(0, 4, (B, H, W))
    seg[rng.random(seg.shape) < 0.05] = 255
    dist = rng.uniform(0, 10, (B, H, W)).astype(np.float32)
    ang = rng.uniform(-180, 180, (B, H, W)).astype(np.float32)
    extra = rng.random((B, H, W)) < 0.2
    ts_ = [torch.from_numpy(a) for a in (seg, dist, ang)]
    assert np.array_equal(t.distance_to_mask_label(ts_[1], ts_[0]).numpy(),
                          np.asarray(j.distance_to_mask_label(dist, jnp.asarray(seg))))
    assert np.array_equal(
        t.angle_to_direction_label(ts_[2], ts_[0], 8, torch.from_numpy(extra)).numpy(),
        np.asarray(j.angle_to_direction_label(ang, jnp.asarray(seg), 8, jnp.asarray(extra))))
    mask = rng.normal(0, 2, (B, H, W, 2)).astype(np.float32)
    dirs = rng.normal(0, 2, (B, H, W, 8)).astype(np.float32)
    jv, (jgm, jgd) = jax.jit(jax.value_and_grad(
        lambda m, d: j.SegFixLoss()((m, d), (jnp.asarray(seg), dist, ang)), argnums=(0, 1)))(
        jnp.asarray(mask), jnp.asarray(dirs))
    tm, td = (_nchw(a).contiguous().requires_grad_(True) for a in (mask, dirs))
    tv = t.SegFixLoss()((tm, td), ts_)
    tv.backward()
    assert abs(tv.item() - float(jv)) <= F32 * abs(float(jv))
    assert rel(tm.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgm)) <= F32
    assert rel(td.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jgd)) <= F32


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_kmeans_matches_jax_from_its_initial_indices(distance):
    from mds_tpu.ops.kmeans import kmeans as j
    from mds_tpu_torch.ops.kmeans import kmeans as t

    rng = np.random.default_rng(9)
    centers = rng.normal(0, 3, (6, 8))
    x = (centers[rng.integers(0, 6, 600)] + rng.normal(0, 1, (600, 8))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    idx = np.asarray(jax.random.choice(key, 600, (6,), replace=False))
    jc, ja = j(jnp.asarray(x), 6, key, n_iter=10, distance=distance)
    tc, ta = t(torch.from_numpy(x), torch.from_numpy(idx), n_iter=10, distance=distance)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert rel(tc.numpy(), np.asarray(jc)) <= F32


def test_soft_dtw_matches_jax():
    """The value and the gradient to the costs, for square and oblong
    matrices and γ of 1 and 0.1, and pairwise_soft_dtw's to the sequences."""
    from mds_tpu.ops.kmeans import pairwise_soft_dtw as jp
    from mds_tpu.ops.kmeans import soft_dtw as j
    from mds_tpu_torch.ops.kmeans import pairwise_soft_dtw as tp
    from mds_tpu_torch.ops.kmeans import soft_dtw as t

    rng = np.random.default_rng(10)
    for shape, gamma in (((6, 6), 1.0), ((5, 9), 0.1), ((1, 4), 1.0), ((7, 3), 0.5)):
        d = rng.uniform(0, 2, shape).astype(np.float32)
        jv, jg = jax.value_and_grad(lambda a: j(a, gamma))(jnp.asarray(d))
        td = torch.from_numpy(d).requires_grad_(True)
        tv = t(td, gamma)
        tv.backward()
        assert abs(tv.item() - float(jv)) <= F32 * abs(float(jv)), shape
        assert rel(td.grad.numpy(), np.asarray(jg)) <= F32, shape
    x = rng.normal(0, 1, (3, 5, 4)).astype(np.float32)
    c = rng.normal(0, 1, (2, 5, 4)).astype(np.float32)
    jv, jg = jax.jit(jax.value_and_grad(lambda a: jp(a, jnp.asarray(c), 0.5).sum()))(
        jnp.asarray(x))
    jm = jax.jit(lambda a: jp(a, jnp.asarray(c), 0.5))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    tm = tp(tx, torch.from_numpy(c), 0.5)
    tm.sum().backward()
    assert tm.shape == (3, 2) and rel(tm.detach().numpy(), np.asarray(jm)) <= F32
    assert rel(tx.grad.numpy(), np.asarray(jg)) <= F32
