"""The whole serving slice, port against JAX, at (1, 64, 128, 3) on the CPU.

The JAX init (with randomized BN) converts into the port through
deploy/weights.py and loads with strict=True. f32 `eval_logits` agree to
rel ≤ 1e-4; the bf16 fused E2E path (normalize → BiSeNetV2 with the deploy
kernels' plain versions → argmax) agrees with JAX `make_e2e_fn` (Pallas
kernels in interpret mode) within the bench.py:296-297 gates: argmax
agreement > 0.995, logits rel < 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.deploy.export import make_e2e_fn
from mds_tpu.models import layers as jl
from mds_tpu_torch.deploy.e2e import E2EModel
from mds_tpu_torch.deploy.weights import bisenetv2_state_dict_from_jax
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.ops import stem as tstem
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import ARGMAX_GATE, LOGITS_GATE, bisenetv2_pair, nchw, rel_err

H, W = 64, 128
MEAN = np.asarray([0.3038, 0.3383, 0.3034], np.float32)
STD = np.asarray([0.2071, 0.2088, 0.209], np.float32)


def _pair(n_classes, n_bn, origin, jdtype, tdtype, seed):
    return bisenetv2_pair(n_classes, n_bn, origin, jdtype, tdtype, seed, (H, W))


@pytest.mark.parametrize("n_bn,origin,dataset", [(1, False, 0), (2, False, 1),
                                                 (2, True, 0)])
def test_eval_logits_f32(n_bn, origin, dataset):
    n_classes = (5, 7)[:n_bn]
    jm, v, tm = _pair(n_classes, n_bn, origin, jnp.float32, torch.float32, n_bn)
    x = np.random.default_rng(0).normal(0, 1, (1, H, W, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, dataset=dataset,
                                         method=jm.eval_logits))(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval_logits(nchw(x), dataset)
    assert got.shape == (1, n_classes[dataset], H, W)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= 1e-4


def test_state_dict_keys_follow_reference_layout():
    _, v, tm = _pair((5, 7), 2, True, jnp.float32, torch.float32, 0)
    sd = bisenetv2_state_dict_from_jax(v["params"], v["batch_stats"])
    assert "detail.S1_1.conv.weight" in sd and "head.1.conv2.bias" in sd
    assert "detail.S1_1.bn.1.weight" in sd  # per-dataset affine (origin)
    assert "segment.S5_5.bn.0.running_var" in sd
    model_keys = {k for k in tm.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(sd) == model_keys
    tm.load_state_dict(sd, strict=True)


@pytest.fixture(scope="module")
def fused_pair():
    """JAX make_e2e_fn labels and fused logits vs the port's E2EModel, bf16,
    with every deploy fusion switched on, on one uint8 frame."""
    jm, v, tm = _pair((19,), 1, False, jnp.bfloat16, torch.bfloat16, 7)
    frame = np.random.default_rng(3).integers(0, 256, (1, H, W, 3)).astype(np.uint8)
    x = (frame.astype(np.float32) / 255.0 - MEAN) / STD
    e2e = E2EModel(tm, MEAN, STD, device="cpu")
    counts = [k.launches for k in tstem.KERNELS]
    jl.set_stem_impl("pallas")
    jl.set_detail_fuse(True)
    tl.set_stem_impl("kernel")
    tl.set_detail_fuse(True)
    try:
        want_labels = np.asarray(jax.jit(make_e2e_fn(jm, v, MEAN, STD))(frame))
        want_logits = np.asarray(jax.jit(lambda v, x: jm.apply(
            v, x, method=jm.eval_logits))(v, jnp.asarray(x)), np.float32)
        got_labels = e2e.infer(frame)
        with torch.no_grad():
            got_logits = tm.eval_logits(nchw(x)).float().permute(0, 2, 3, 1).numpy()
    finally:
        jl.set_stem_impl("plain")
        jl.set_detail_fuse(False)
        tl.set_stem_impl("plain")
        tl.set_detail_fuse(False)
    assert [k.launches for k in tstem.KERNELS] == counts  # CPU: plain versions
    return want_labels, want_logits, got_labels, got_logits


def test_e2e_fused_labels_match_jax(fused_pair):
    want_labels, _, got_labels, _ = fused_pair
    assert got_labels.dtype == np.int32 and got_labels.shape == (1, H, W)
    assert want_labels.shape == (1, H, W)
    assert (got_labels == want_labels).mean() > ARGMAX_GATE


def test_e2e_fused_logits_match_jax(fused_pair):
    _, want_logits, _, got_logits = fused_pair
    assert got_logits.shape == want_logits.shape == (1, H, W, 19)
    assert rel_err(got_logits, want_logits) < LOGITS_GATE
