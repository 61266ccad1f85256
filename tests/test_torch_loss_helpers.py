"""The port's loss-helper family (mds_tpu_torch/losses/helpers.py) and
`MdsOhemNLLPlusLoss` (losses/ohem_ce.py) against JAX's
(mds_tpu/losses/helpers.py, mds_tpu/losses/ohem_ce.py:182) on the CPU.

The same numpy-seeded logits (NHWC for JAX, NCHW for the port) and labels
go through both; the gate is f32 rel ≤ 1e-5 (max-diff over the reference's
largest magnitude) on the value and on the gradient with respect to every
float input. JAX's `MdsOhemNLLPlusLoss` runs with `exact=True`: the port's
OHEM is always the exact rule (JAX's default is its histogram top-k).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mds_tpu.losses.helpers as jh
import mds_tpu_torch.losses.helpers as th
from mds_tpu.losses.ohem_ce import MdsOhemNLLPlusLoss as JNLLPlus
from mds_tpu_torch.losses.ohem_ce import MdsOhemNLLPlusLoss

TOL = 1e-5
B, H, W, C = 2, 12, 16, 5


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _labels(rng, c=C, shape=(B, H, W), ignore=0.1):
    lb = rng.integers(0, c, shape)
    lb[rng.random(shape) < ignore] = 255
    return lb.astype(np.int32)


def _logits(rng, shape=(B, H, W, C), scale=2.0):
    return (scale * rng.normal(0, 1, shape)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))).requires_grad_(True)


def _check(jfn, tfn, floats, ints, layouts):
    """Value and gradients of jfn(*floats, *ints) (JAX) against tfn on the
    port's layouts ('nchw' moves the last axis to 1, 'rows' keeps it)."""
    jv, jg = jax.value_and_grad(lambda *f: jfn(*f, *ints), argnums=tuple(range(len(floats))))(
        *[jnp.asarray(f) for f in floats])
    tf = [_nchw(f) if lay == "nchw" else torch.from_numpy(f.copy()).requires_grad_(True)
          for f, lay in zip(floats, layouts)]
    tv = tfn(*tf, *[torch.from_numpy(np.asarray(i)) for i in ints])
    tv.backward()
    assert rel(tv.detach().numpy(), np.asarray(jv)) <= TOL
    for t, g, lay in zip(tf, jg, layouts):
        got = t.grad.numpy()
        if lay == "nchw":
            got = np.moveaxis(got, 1, -1)
        assert rel(got, np.asarray(g)) <= TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_recall_cross_entropy(seed):
    rng = np.random.default_rng(seed)
    _check(lambda x, t: jh.recall_cross_entropy(x, t, C),
           lambda x, t: th.recall_cross_entropy(x, t, C),
           [_logits(rng)], [_labels(rng)], ["nchw"])


@pytest.mark.parametrize("alpha,reduction", [(False, "mean"), (True, "sum"), (True, "none")])
def test_focal_loss(alpha, reduction):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 1.5, C).astype(np.float32) if alpha else None

    def jfn(x, t):
        out = jh.focal_loss(x, t, gamma=2.0, alpha=None if a is None else jnp.asarray(a),
                            reduction=reduction)
        return out.sum() if reduction == "none" else out

    def tfn(x, t):
        out = th.focal_loss(x, t, gamma=2.0, alpha=None if a is None else torch.from_numpy(a),
                            reduction=reduction)
        return out.sum() if reduction == "none" else out

    _check(jfn, tfn, [_logits(rng)], [_labels(rng)], ["nchw"])


def test_nll_plus_loss():
    rng = np.random.default_rng(3)
    x = _logits(rng)
    lbs = [_labels(rng, ignore=0.3) for _ in range(3)]
    _check(lambda x, a, b, c: jh.nll_plus_loss(x, [a, b, c]),
           lambda x, a, b, c: th.nll_plus_loss(x, [a, b, c]), [x], lbs, ["nchw"])


def test_weighted_nll_plus_loss():
    rng = np.random.default_rng(4)
    x = _logits(rng)
    mask = (rng.random((B, H, W, C)) < 0.3).astype(np.float32)
    _check(jh.weighted_nll_plus_loss,
           lambda x, m: th.weighted_nll_plus_loss(x, m.permute(0, 3, 1, 2)),
           [x, mask], [], ["nchw", "rows"])


@pytest.mark.parametrize("up", [1, 4])
def test_adj_nll_plus_loss(up):
    """Per-pixel losses through a (n, C) graph, at the logits' size and
    ×4 (align-corners resize to the label)."""
    rng = np.random.default_rng(5 + up)
    x = _logits(rng)
    adj = rng.uniform(0, 1, (3, C)).astype(np.float32)
    lb = _labels(rng, c=3, shape=(B, H * up, W * up))
    _check(lambda x, a, t: jh.adj_nll_plus_loss(x, a, t)[0].sum(),
           lambda x, a, t: th.adj_nll_plus_loss(x, a, t)[0].sum(),
           [x, adj], [lb], ["nchw", "rows"])


def test_circle_loss():
    rng = np.random.default_rng(6)
    sp = rng.uniform(-1, 1, (7, 3)).astype(np.float32)
    sn = rng.uniform(-1, 1, (11, 3)).astype(np.float32)
    _check(lambda p, n: jh.circle_loss(p, n, 0.25, 8.0).sum(),
           lambda p, n: th.circle_loss(p, n, 0.25, 8.0).sum(), [sp, sn], [], ["rows", "rows"])


@pytest.mark.parametrize("m,gamma", [(0.0, 1.0), (0.2, 4.0)])
def test_multi_label_cross_entropy(m, gamma):
    rng = np.random.default_rng(7)
    x = _logits(rng, (64, 12))
    hot = rng.random((64, 12)) < 0.2
    hot[np.arange(64), rng.integers(0, 12, 64)] = True
    _check(lambda x, h: jh.multi_label_cross_entropy(x, h, m, gamma),
           lambda x, h: th.multi_label_cross_entropy(x, h, m, gamma),
           [x], [hot], ["rows"])


@pytest.mark.parametrize("thresh", [0.4, 0.9])
def test_mds_ohem_nll_plus_matches_exact_jax(thresh):
    """Two datasets' graph NLLs in one hard pool (one dataset absent in a
    third slot); thresh 0.9 keeps pixels by the threshold, 0.4 by n_min."""
    rng = np.random.default_rng(8)
    xs = [_logits(rng), _logits(rng, (1, H, W, C))]
    adjs = [rng.uniform(0, 1, (3, C)).astype(np.float32),
            rng.uniform(0, 1, (4, C)).astype(np.float32)]
    lbs = [_labels(rng, 3, (B, 4 * H, 4 * W)), _labels(rng, 4, (1, 4 * H, 4 * W))]
    jl = JNLLPlus(thresh=thresh, exact=True)
    tl = MdsOhemNLLPlusLoss(thresh=thresh)

    def jfn(x0, x1):
        return jl([x0, x1, None], [jnp.asarray(a) for a in adjs] + [None],
                  [jnp.asarray(l) for l in lbs] + [None])

    def tfn(x0, x1):
        return tl([x0, x1, None], [torch.from_numpy(a) for a in adjs] + [None],
                  [torch.from_numpy(l) for l in lbs] + [None])

    _check(jfn, tfn, xs, [], ["nchw", "nchw"])
