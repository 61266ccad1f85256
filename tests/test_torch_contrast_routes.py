"""BiSeNetV2Contrast on the served eval route, port against JAX, in bf16 at
(1, 64, 128) on the CPU.

The route chip_smoke.py's contrast eval takes: the stem kernel, the detail
fusion and tail, the depthwise kernel (kernels 4, 5, 7 and 9; their plain
versions on the CPU), against JAX's same switches with its Pallas kernels
in interpret mode. The model is the port's own `DetailBranch`,
`SegmentBranch` and `BGALayer`, so each route must reach it: one call of
each fused kernel and 16 depthwise calls a forward. Gates (bench.py:296-297):
the unified `eval_logits` rel < 2e-2, the labels agree > 0.995 with JAX's.
No kernel launches on the CPU. (`emb_logits` runs the same backbone; its
f32 parity: tests/test_torch_contrast_model.py.)
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mds_tpu.models import bisenetv2_contrast as jbc
from mds_tpu.models import layers as jl
from mds_tpu_torch.deploy.weights import bisenetv2_contrast_state_dict_from_jax
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.models.bisenetv2_contrast import BiSeNetV2Contrast
from mds_tpu_torch.ops import depthwise as tdw
from mds_tpu_torch.ops import stem as tstem
from torch_contrast_parity import contrast_variables
from torch_eval_parity import one_torch_thread  # noqa: F401 — autouse: one thread
from torch_parity import ARGMAX_GATE, LOGITS_GATE, interpret_pallas, nchw, rel_err

H, W = 64, 128
KW = dict(num_unify_classes=8, datasets_cats=(5, 7), n_bn=2, proj_dim=16)
ROUTED = ("detail_s1s2_fused", "stemblock_fused", "detail_tail_fused")


@contextlib.contextmanager
def eval_routes():
    """Both packages' stem kernel, detail fusion and tail and depthwise
    kernel on, every switch back to its default after."""
    jl.set_stem_impl("pallas")
    jl.set_detail_fuse(True)
    jl.set_detail_tail(True)
    jl.set_depthwise_impl("pallas")
    tl.set_stem_impl("kernel")
    tl.set_detail_fuse(True)
    tl.set_detail_tail(True)
    tl.set_depthwise_impl("kernel")
    try:
        yield
    finally:
        jl.set_stem_impl("plain")
        jl.set_detail_fuse(False)
        jl.set_detail_tail(False)
        jl.set_depthwise_impl("xla")
        tl.set_stem_impl("plain")
        tl.set_detail_fuse(False)
        tl.set_detail_tail(False)
        tl.set_depthwise_impl("plain")


def test_eval_route_bf16_matches_jax(monkeypatch):
    interpret_pallas(monkeypatch)
    calls = {n: 0 for n in ROUTED + ("depthwise3x3",)}
    for mod, names in ((tstem, ROUTED), (tdw, ("depthwise3x3",))):
        for name in names:
            def counted(*a, _real=getattr(mod, name), _name=name, **k):
                calls[_name] += 1
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, counted)
    jm = jbc.BiSeNetV2Contrast(dtype=jnp.bfloat16, **KW)
    v = contrast_variables(2, **KW)
    tm = BiSeNetV2Contrast(dtype=torch.bfloat16, **KW)
    tm.load_state_dict(bisenetv2_contrast_state_dict_from_jax(v["params"], v["batch_stats"]))
    tm.eval()
    x = np.random.default_rng(3).normal(0, 1, (1, H, W, 3)).astype(np.float32)
    counts = [k.launches for k in tstem.KERNELS + tdw.KERNELS]
    with eval_routes():
        want = jax.jit(lambda v, x: jm.apply(v, x, dataset=1, method=jm.eval_logits))(
            v, jnp.asarray(x))
        with torch.no_grad():
            got = tm.eval_logits(nchw(x), dataset=1)
    assert calls == {"detail_s1s2_fused": 1, "stemblock_fused": 1, "detail_tail_fused": 1,
                     "depthwise3x3": 16}, calls
    assert [k.launches for k in tstem.KERNELS + tdw.KERNELS] == counts
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape == (1, H, W, 8)
    assert rel_err(got, want) < LOGITS_GATE
    labels = got.argmax(-1)
    assert np.unique(labels).size > 1  # a constant map agrees with anything
    assert (labels == want.argmax(-1)).mean() > ARGMAX_GATE
